"""Scheduling policies: PD aggregation, PD disaggregation, and TaiChi's
hybrid mode — the three rows of the paper's Table 1.

                      batch handling     request handling
  PD aggregation      aggregated         aggregated (decode in place)
  PD disaggregation   disaggregated      disaggregated (prefill->decode move)
  TaiChi hybrid       aggregated         disaggregated

TaiChi's three sliders (§3.1): R_PD (ratio of P-heavy to D-heavy
instances), S_P, S_D (their chunk sizes).  Setting S_D == S_P recovers
aggregation; S_D = 0 with S_P = max context recovers disaggregation —
both expressible as TaiChiPolicy corner cases, which the tests assert.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

from repro_torch.cache.prefix_cache import PrefixCache
from repro_torch.core import flowing
from repro_torch.core.estimator import CostModel
from repro_torch.core.instance import D_HEAVY, Instance, P_HEAVY
from repro_torch.core.proxy import Proxy
from repro_torch.engine.request import Request


@dataclasses.dataclass
class Sliders:
    """TaiChi's configuration surface (paper §3.1)."""
    n_p: int                 # P-heavy instance count   (R_PD = n_p : n_d)
    n_d: int                 # D-heavy instance count
    s_p: int                 # chunk size on P-heavy
    s_d: int                 # chunk size on D-heavy (0 = no prefill)
    watermark: float = 0.95  # M: D-heavy HBM watermark for degradation
    alpha: float = 0.96      # TPOT-approach factor for backflow


class BasePolicy:
    """Common wiring; subclasses override the three decision hooks."""

    name = "base"

    def __init__(self, instances: Sequence[Instance], cost: CostModel,
                 ttft_slo: float, tpot_slo: float, seed: int = 0):
        self.instances = list(instances)
        self.cost = cost
        self.ttft_slo = ttft_slo
        self.tpot_slo = tpot_slo
        self.proxy = Proxy(self.instances, cost, ttft_slo, seed=seed)
        # adaptive decode-horizon selection reads the flowing-decode
        # budget: give every instance the TPOT SLO it is serving against
        for inst in self.instances:
            if inst.tpot_slo is None:
                inst.tpot_slo = tpot_slo

    @property
    def p_instances(self) -> List[Instance]:
        return [i for i in self.instances if i.itype == P_HEAVY]

    @property
    def d_instances(self) -> List[Instance]:
        return [i for i in self.instances if i.itype == D_HEAVY]

    # hooks ------------------------------------------------------------
    def on_arrival(self, req: Request, now: float) -> Instance:
        raise NotImplementedError

    def on_prefill_done(self, req: Request, inst: Instance,
                        now: float) -> Tuple[Instance, bool]:
        """Returns (decode instance, needs_transfer)."""
        raise NotImplementedError

    def select_migrations(self, now: float, inst: Instance
                          ) -> List[Tuple[Request, Instance, Instance, bool]]:
        """Algorithm 1 is invoked in the scheduling phase of each
        iteration of ``inst``; returns [(req, src, dst, is_backflow)]."""
        return []


class PDAggregationPolicy(BasePolicy):
    """Chunked prefill everywhere (Sarathi-Serve-style); requests decode
    where they prefilled."""

    name = "pd_aggregation"

    def on_arrival(self, req: Request, now: float) -> Instance:
        cands = [i for i in self.instances if i.schedulable]
        if not cands:
            return None
        inst = min(cands, key=lambda i: i.queued_prefill_tokens())
        inst.enqueue_prefill(req)
        return inst

    def on_prefill_done(self, req, inst, now):
        return inst, False


class PDDisaggregationPolicy(BasePolicy):
    """DistServe/Splitwise-style: prefill instances never decode, decode
    instances never prefill, KV moves across after the first token."""

    name = "pd_disaggregation"

    def on_arrival(self, req: Request, now: float) -> Instance:
        cands = [i for i in self.p_instances if i.schedulable]
        if not cands:
            return None
        inst = min(cands, key=lambda i: i.queued_prefill_tokens())
        inst.enqueue_prefill(req)
        return inst

    def on_prefill_done(self, req, inst, now):
        live = [i for i in self.d_instances if i.schedulable]
        cands = [i for i in live if not i.draining] or live
        if not cands:
            return inst, False             # every D peer down: decode here
        target = min(cands, key=lambda i: i.decode_load())
        return target, True


class TaiChiPolicy(BasePolicy):
    """Hybrid mode: Algorithm 2 for prefill, §3.3① for decode placement,
    Algorithm 1 for flowing decode (degradation + backflow)."""

    name = "taichi"

    def __init__(self, instances, cost, ttft_slo, tpot_slo,
                 sliders: Sliders, seed: int = 0,
                 enable_flowing: bool = True, length_aware: bool = True,
                 early_rejection: bool = False, cache_aware: bool = True):
        """enable_flowing / length_aware: ablation switches for the
        paper's Fig-18 breakdown (Arch -> +Flowing -> +LengthAware).
        early_rejection: drop TTFT-infeasible requests at the proxy
        (paper §3.4 discussion; off by default for fair comparison).
        cache_aware: route on effective (post-prefix-hit) prefill
        lengths when instances carry a prefix cache — disable to ablate
        routing awareness while keeping KV reuse itself on."""
        super().__init__(instances, cost, ttft_slo, tpot_slo, seed=seed)
        self.sliders = sliders
        for inst in self.instances:
            inst.tpot_alpha = sliders.alpha
        self.enable_flowing = enable_flowing
        self.length_aware = length_aware
        self.proxy.early_rejection = early_rejection
        self.proxy.cache_aware = cache_aware

    def on_arrival(self, req: Request, now: float) -> Instance:
        if not self.length_aware:
            # naive least-queued routing (no TTFT feasibility estimate)
            cands = [i for i in self.instances
                     if i.chunk_size > 0 and i.schedulable]
            if not cands:
                return None
            inst = min(cands, key=lambda i: i.queued_prefill_tokens())
            inst.enqueue_prefill(req)
            return inst
        return self.proxy.schedule_prefill(req, now)

    def on_prefill_done(self, req, inst, now):
        target = self.proxy.place_decode(req, inst, self.d_instances)
        return target, target is not inst

    def select_migrations(self, now: float, inst: Instance):
        if not self.enable_flowing:
            return []
        if inst.draining:
            return []                      # drain machinery owns its moves
        moves = []
        s = self.sliders
        d_avail = [i for i in self.d_instances
                   if not i.draining and i.schedulable]
        p_avail = [i for i in self.p_instances
                   if not i.draining and i.schedulable]
        if inst.itype == P_HEAVY:
            for req in flowing.select_backflow(inst, self.tpot_slo,
                                               s.alpha, now):
                dst = min(d_avail, key=lambda i: i.decode_load(),
                          default=None)
                if dst is not None and dst is not inst:
                    moves.append((req, inst, dst, True))
        else:
            for req in flowing.select_degrade(inst, s.watermark):
                dst = min(p_avail, key=lambda i: i.decode_load(),
                          default=None)
                if dst is not None and dst is not inst:
                    moves.append((req, inst, dst, False))
        return moves


def build_instances(cost: CostModel, sliders: Sliders,
                    executor_factory, hbm_blocks: int = 4096,
                    block_size: int = 16,
                    prefix_cache: bool = False,
                    spill_blocks: int = 0) -> List[Instance]:
    """Instantiate the differentiated-capability pool.  With
    ``prefix_cache`` each instance owns a shared-prefix KV cache over
    its own HBM block pool; ``spill_blocks`` adds a host-RAM tier per
    instance that catches LRU-evicted prefix blocks (prefixes stay
    per-instance — the controller's replication pass copies hot ones
    across)."""
    def make(iid, itype, chunk):
        pc = (PrefixCache(hbm_blocks, block_size,
                          spill_blocks=spill_blocks) if prefix_cache
              else None)
        return Instance(iid, itype, chunk, cost, executor_factory(),
                        hbm_blocks, block_size, prefix_cache=pc)
    out = []
    iid = 0
    for _ in range(sliders.n_p):
        out.append(make(iid, P_HEAVY, sliders.s_p))
        iid += 1
    for _ in range(sliders.n_d):
        out.append(make(iid, D_HEAVY, sliders.s_d))
        iid += 1
    return out
