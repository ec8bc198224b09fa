"""High-level simulation entry points: build a cluster for a policy name
and run a workload at a given QPS — the harness behind every goodput
experiment (paper Figs 15/16, Table 2)."""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence

from repro_torch.configs import get_config
from repro_torch.core.cluster import Cluster, FaultToleranceConfig
from repro_torch.core.estimator import CostModel
from repro_torch.core.hw import InstanceSpec
from repro_torch.core.latency import SLO, RunStats, max_goodput
from repro_torch.core.policies import (PDAggregationPolicy, PDDisaggregationPolicy,
                                 Sliders, TaiChiPolicy, build_instances)
from repro_torch.engine.engine import SimExecutor
from repro_torch.sim.workload import WORKLOADS, WorkloadSpec


@dataclasses.dataclass
class ServingConfig:
    model: str = "qwen2.5-14b"
    tp: int = 4
    policy: str = "taichi"            # taichi | aggregation | disaggregation
    sliders: Sliders = dataclasses.field(
        default_factory=lambda: Sliders(n_p=2, n_d=2, s_p=1024, s_d=512))
    hbm_blocks: int = 8192            # KV blocks per instance
    block_size: int = 16
    max_ctx: int = 16384
    prefix_cache: bool = False        # shared-prefix KV cache per instance
    spill_blocks: int = 0             # host-RAM spill tier per instance


def build_cluster(sc: ServingConfig, slo: SLO, seed: int = 0,
                  executor_factory: Optional[Callable] = None,
                  taichi_flags: Optional[dict] = None,
                  async_exec: bool = False,
                  ft: Optional[FaultToleranceConfig] = None,
                  recovery=None) -> Cluster:
    cfg = get_config(sc.model)
    cost = CostModel(cfg, InstanceSpec(tp=sc.tp))
    factory = executor_factory or (lambda: SimExecutor())
    s = sc.sliders
    if sc.policy == "aggregation":
        # all instances identical: chunk = s_p everywhere, no D-heavy split
        s = Sliders(n_p=s.n_p + s.n_d, n_d=0, s_p=s.s_p, s_d=s.s_p)
        instances = build_instances(cost, s, factory, sc.hbm_blocks,
                                    sc.block_size, sc.prefix_cache,
                                    sc.spill_blocks)
        policy = PDAggregationPolicy(instances, cost, slo.ttft, slo.tpot,
                                     seed=seed)
    elif sc.policy == "disaggregation":
        # P: full-prompt chunks (no chunking), never decodes;
        # D: chunk 0 (never prefills)
        s = Sliders(n_p=s.n_p, n_d=s.n_d, s_p=sc.max_ctx, s_d=0)
        instances = build_instances(cost, s, factory, sc.hbm_blocks,
                                    sc.block_size, sc.prefix_cache,
                                    sc.spill_blocks)
        policy = PDDisaggregationPolicy(instances, cost, slo.ttft, slo.tpot,
                                        seed=seed)
    elif sc.policy == "taichi":
        instances = build_instances(cost, s, factory, sc.hbm_blocks,
                                    sc.block_size, sc.prefix_cache,
                                    sc.spill_blocks)
        policy = TaiChiPolicy(instances, cost, slo.ttft, slo.tpot,
                              sliders=s, seed=seed, **(taichi_flags or {}))
    else:
        raise ValueError(sc.policy)
    return Cluster(policy, cost, async_exec=async_exec, ft=ft,
                   recovery=recovery)


def run_sim(sc: ServingConfig, slo: SLO, workload: WorkloadSpec,
            qps: float, n_requests: int = 200, seed: int = 0,
            taichi_flags: Optional[dict] = None) -> RunStats:
    cluster = build_cluster(sc, slo, seed=seed, taichi_flags=taichi_flags)
    reqs = workload.sample_requests(n_requests, qps, seed=seed)
    cluster.run(reqs)
    st = cluster.stats(reqs, slo, qps)
    st.cluster = cluster          # expose counters for breakdown benches
    return st


def goodput_sweep(sc: ServingConfig, slo: SLO, workload: WorkloadSpec,
                  qps_grid: Sequence[float], n_requests: int = 200,
                  seed: int = 0):
    return max_goodput(
        lambda q: run_sim(sc, slo, workload, q, n_requests, seed),
        qps_grid)
