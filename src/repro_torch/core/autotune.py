"""Offline slider search (paper §3.1): "The optimal configuration for a
given workload and SLO can be determined via offline search, following
approaches from prior work [3, 19, 36]."

Searches the (R_PD, S_P, S_D) grid with short simulator runs and returns
the slider setting with the highest goodput, mirroring DistServe's
on-demand search-and-reconfigure strategy (re-run on significant
workload change; completes in minutes of simulated serving, seconds of
wall time per candidate)."""
from __future__ import annotations

import dataclasses
import itertools
from typing import List, Optional, Sequence, Tuple

from repro_torch.core.latency import SLO
from repro_torch.core.policies import Sliders
from repro_torch.sim.workload import WorkloadSpec

DEFAULT_RATIOS = [(1, 3), (2, 2), (3, 1)]
DEFAULT_SP = [1024, 2048, 4096]
DEFAULT_SD = [0, 64, 128, 256, 512]


@dataclasses.dataclass
class SearchResult:
    sliders: Sliders
    goodput: float
    attainment_at_goodput: float
    trials: List[Tuple[Sliders, float]]


def search_sliders(model: str, slo: SLO, workload: WorkloadSpec,
                   qps_grid: Sequence[float], *, tp: int = 4,
                   n_instances: int = 4, n_requests: int = 150,
                   ratios=None, sp_grid=None, sd_grid=None,
                   seed: int = 0) -> SearchResult:
    from repro_torch.sim.simulator import ServingConfig, goodput_sweep
    ratios = ratios or DEFAULT_RATIOS
    sp_grid = sp_grid or DEFAULT_SP
    sd_grid = sd_grid or DEFAULT_SD

    trials: List[Tuple[Sliders, float]] = []
    best: Optional[Tuple[Sliders, float, float]] = None
    for (n_p, n_d), s_p, s_d in itertools.product(ratios, sp_grid, sd_grid):
        if n_p + n_d != n_instances or s_d > s_p:
            continue
        sliders = Sliders(n_p=n_p, n_d=n_d, s_p=s_p, s_d=s_d)
        sc = ServingConfig(model=model, tp=tp, policy="taichi",
                           sliders=sliders)
        g, stats = goodput_sweep(sc, slo, workload, qps_grid,
                                 n_requests=n_requests, seed=seed)
        att = max((s.slo_attainment for s in stats if s.qps <= g),
                  default=0.0)
        trials.append((sliders, g))
        if best is None or g > best[1]:
            best = (sliders, g, att)
    sliders, g, att = best
    return SearchResult(sliders=sliders, goodput=g,
                        attainment_at_goodput=att, trials=trials)
