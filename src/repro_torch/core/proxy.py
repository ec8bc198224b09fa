"""Length-aware prefill scheduling — Algorithm 2 of the paper (§3.4),
plus the decode-placement rule of §3.3 step ①.

Prefill routing: for each instance estimate
    TTFT_hat = Q (queued prefill exec time) + E (this request's exec time)
             + T (KV transfer, P-heavy only — its decode will move away;
                  charged against the best decode-placement candidate's
                  cached prefix, so destination hits shrink the estimate)
keep instances with TTFT_hat + elapsed-queue-age < tpft SLO (feasible set),
pick the feasible instance with the FEWEST queued prefill tokens (this
preferentially degrades short prefills onto D-heavy instances, while
falling back to P-heavy when D-heavy queues grow — load balancing).
If no instance is feasible the request is assigned randomly (the paper
does the same for fair comparison instead of early rejection [20]).

Cache-aware extension: when instances carry a shared-prefix KV cache, E
is computed on the EFFECTIVE prefill length (prompt minus that
instance's longest cached prefix) and queued-token ties break toward the
instance holding the longest prefix.  This interacts with latency
shifting: a big hit can make a D-heavy instance feasible for a long
prompt that would otherwise have to degrade a P-heavy one.  Q still uses
full queued lengths — queued requests' hits are only claimed at
admission, so the estimate stays conservative.

Decode placement (§3.3 ①): prefilled on D-heavy -> decode in place (zero
transfer); prefilled on P-heavy -> D-heavy instance with the lowest
decode load (HBM usage).
"""
from __future__ import annotations

import random
from typing import List, Optional, Sequence

from repro_torch.core.estimator import CostModel
from repro_torch.core.instance import D_HEAVY, Instance, P_HEAVY
from repro_torch.engine.request import Request


class Proxy:
    def __init__(self, instances: Sequence[Instance], cost: CostModel,
                 ttft_slo: float, seed: int = 0,
                 early_rejection: bool = False, cache_aware: bool = True):
        """early_rejection: when no instance can meet the TTFT SLO,
        proactively drop the request (Mooncake-style [20], paper §3.4)
        instead of randomly assigning it.  The paper disables this for
        fair comparison with PD aggregation; we expose both behaviors.
        cache_aware: use effective (post-prefix-hit) lengths in TTFT_hat
        and prefer the prefix-holding instance on ties (no-op unless
        instances have a prefix cache)."""
        self.instances = list(instances)
        self.cost = cost
        self.ttft_slo = ttft_slo
        self._rng = random.Random(seed)
        self.infeasible_count = 0
        self.early_rejection = early_rejection
        self.rejected_count = 0
        self.cache_aware = cache_aware

    # ------------------------------------------------------------------
    def _queue_time(self, inst: Instance) -> float:
        """Q: total estimated execution time of queued prefill work."""
        q = 0.0
        for r in inst.prefill_queue:
            q += self.cost.prefill_time(r.prefill_remaining,
                                        inst.chunk_size,
                                        decode_batch=len(inst.decoding))
        return q

    def _peek_hit(self, inst: Instance, req: Request) -> int:
        return inst.peek_prefix(req) if self.cache_aware else 0

    def _exec_time(self, inst: Instance, req: Request,
                   cached: int = 0) -> float:
        return self.cost.prefill_time(req.prompt_len - cached,
                                      inst.chunk_size,
                                      decode_batch=len(inst.decoding))

    def _transfer_time(self, inst: Instance, req: Request) -> float:
        """T: KV transfer charge for a P-heavy placement (its decode will
        move to a D-heavy instance after prefill).

        Destination-aware: the transfer is charged against the BEST
        decode-placement candidate — the least decode-loaded D-heavy
        instance, the same rule ``place_decode`` applies — and only the
        suffix that candidate does not already cache ships (prefix-aware
        migration).  A big prefix hit on the destination therefore
        shrinks TTFT_hat, which can make a P-heavy placement feasible
        for a prompt the full-transfer charge would have excluded."""
        if inst.itype != P_HEAVY:
            return 0.0
        return self.cost.transfer_time(self._transfer_moved(req))

    def _transfer_moved(self, req: Request) -> int:
        """Tokens a P-heavy placement would actually ship — independent
        of the prefill candidate, so ``schedule_prefill`` computes it
        once per arrival (the prefix match walks the whole prompt)."""
        dcands = [i for i in self.instances
                  if i.itype == D_HEAVY and not i.draining
                  and i.schedulable]
        if not dcands:
            return req.prompt_len
        dst = min(dcands, key=lambda i: i.decode_load())
        return max(req.prompt_len - dst.peek_migration_prefix(req), 0)

    # ------------------------------------------------------------------
    def schedule_prefill(self, req: Request, now: float) -> Instance:
        """Algorithm 2 (+ cache-aware effective lengths)."""
        feasible: List[tuple] = []             # (instance, prefix hit)
        t_place = None                         # lazy: P-heavy cands only
        for inst in self.instances:
            if inst.chunk_size <= 0:
                continue                       # pure-decode instance
            if not inst.schedulable:
                continue                       # dead/quarantined
            cached = self._peek_hit(inst, req)
            Q = self._queue_time(inst)
            E = self._exec_time(inst, req, cached)
            if inst.itype == P_HEAVY:
                # T is destination-derived — identical for every P-heavy
                # candidate, so the prefix match runs once per arrival
                if t_place is None:
                    t_place = self._transfer_time(inst, req)
                T = t_place
            else:
                T = 0.0
            if Q + E + T < self.ttft_slo:
                feasible.append((inst, cached))
        if feasible:
            # fewest queued prefill tokens; ties favor the instance with
            # the longest cached prefix, then D-heavy (the paper
            # "typically favors a D-heavy instance" — degradation first)
            chosen = min(feasible,
                         key=lambda ic: (ic[0].queued_prefill_tokens(),
                                         -ic[1],
                                         0 if ic[0].itype == D_HEAVY
                                         else 1))[0]
        else:
            self.infeasible_count += 1
            if self.early_rejection:
                self.rejected_count += 1
                return None
            cands = [i for i in self.instances
                     if i.chunk_size > 0 and i.schedulable]
            if not cands:
                return None        # no healthy prefill capacity at all
            chosen = self._rng.choice(cands)
        chosen.enqueue_prefill(req)
        return chosen

    # ------------------------------------------------------------------
    def place_decode(self, req: Request, prefill_inst: Instance,
                     d_instances: Sequence[Instance]) -> Instance:
        """§3.3 step ①: in-place on D-heavy, else least-loaded D-heavy.
        Draining instances (staged role flip) accept no new decodes."""
        cands = [i for i in d_instances
                 if not i.draining and i.schedulable]
        if (prefill_inst.itype == D_HEAVY and not prefill_inst.draining) \
                or not cands:
            return prefill_inst
        return min(cands, key=lambda i: i.decode_load())

    def least_loaded(self, itype: str) -> Optional[Instance]:
        cands = [i for i in self.instances
                 if i.itype == itype and not i.draining and i.schedulable]
        if not cands:
            return None
        return min(cands, key=lambda i: i.decode_load())
