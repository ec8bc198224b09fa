"""SLO definitions, attainment, and goodput metrics (paper §2.1, §4.1)."""
from __future__ import annotations

import dataclasses
from typing import Iterable, List, Optional, Sequence

import numpy as np

from repro_torch.engine.request import Request


@dataclasses.dataclass(frozen=True)
class SLO:
    ttft: float      # seconds
    tpot: float      # seconds per output token

    def satisfied(self, req: Request) -> bool:
        t1 = req.ttft()
        if t1 is None or t1 > self.ttft:
            return False
        tp = req.tpot()
        if tp is None:           # single-token outputs: only TTFT applies
            return True
        return tp <= self.tpot


def attainment(reqs: Sequence[Request], slo: SLO) -> float:
    from repro_torch.engine.request import State
    done = [r for r in reqs if r.first_token_time is not None
            or r.state in (State.REJECTED, State.FAILED)]
    if not done:
        return 0.0
    # early-rejected, fault-failed and client-aborted requests count as
    # SLO violations even when their emitted tokens met the deadlines —
    # work that never produced a complete answer is not goodput
    bad = (State.REJECTED, State.FAILED, State.CANCELLED)
    return sum(slo.satisfied(r) and r.state not in bad
               for r in done) / len(done)


def percentile(xs: Iterable[float], q: float) -> float:
    xs = [x for x in xs if x is not None]
    return float(np.percentile(xs, q)) if xs else float("nan")


def p90(xs: Iterable[float]) -> float:
    return percentile(xs, 90)


@dataclasses.dataclass
class RunStats:
    reqs: List[Request]
    slo: SLO
    qps: float
    wall: float
    # prefix-cache counters (aggregated over instances by Cluster.stats;
    # zero when caching is off)
    cache_lookups: int = 0
    cache_hits: int = 0
    saved_prefill_tokens: int = 0
    # online-serving counters: proxy early-rejection drops and adaptive
    # controller activity (slider moves = chunk retunes + role flips),
    # surfaced here so sweeps and benches report them without log
    # scraping
    early_rejections: int = 0
    slider_moves: int = 0
    role_flips: int = 0

    @property
    def slo_attainment(self) -> float:
        return attainment(self.reqs, self.slo)

    def ttft_percentile(self, q: float) -> float:
        return percentile([r.ttft() for r in self.reqs], q)

    @property
    def mean_ttft(self) -> float:
        xs = [r.ttft() for r in self.reqs if r.ttft() is not None]
        return float(np.mean(xs)) if xs else float("nan")

    @property
    def p90_ttft(self) -> float:
        return self.ttft_percentile(90)

    @property
    def p90_tpot(self) -> float:
        return p90([r.tpot() for r in self.reqs])

    @property
    def cache_hit_rate(self) -> float:
        """Fraction of prefill admissions that reused a cached prefix."""
        if self.cache_lookups == 0:
            return 0.0
        return self.cache_hits / self.cache_lookups

    def summary(self) -> dict:
        out = {
            "qps": self.qps,
            "n": len(self.reqs),
            "attainment": round(self.slo_attainment, 4),
            "p90_ttft_s": round(self.p90_ttft, 3),
            "p90_tpot_ms": round(self.p90_tpot * 1e3, 2),
        }
        if self.cache_lookups:
            out["cache_hit_rate"] = round(self.cache_hit_rate, 4)
            out["saved_prefill_tokens"] = self.saved_prefill_tokens
        if self.early_rejections:
            out["early_rejections"] = self.early_rejections
        if self.slider_moves or self.role_flips:
            out["slider_moves"] = self.slider_moves
            out["role_flips"] = self.role_flips
        return out


def max_goodput(run_at_qps, qps_grid: Sequence[float],
                target: float = 0.9) -> tuple:
    """Paper metric: max request rate sustaining >= 90% SLO attainment.

    run_at_qps: callable qps -> RunStats.  Returns (goodput_qps, [RunStats]).
    """
    stats = []
    best = 0.0
    for q in qps_grid:
        st = run_at_qps(q)
        stats.append(st)
        if st.slo_attainment >= target:
            best = q
    return best, stats
