"""The end-to-end metrics' arithmetic, on the wall clock of the benchmark's
own token sink.  A request is timed from the moment it was due, not from
when the program took it in; a latency that never ended is infinite, and
is written as ``NEVER`` seconds where a number has to be printed."""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence

#: how an infinite latency is written in the result (JSON has no inf)
NEVER = 1.0e6

INF = math.inf


@dataclasses.dataclass
class Timed:
    """What the sink saw of one request (wall seconds after the window
    opened)."""
    due: float
    prompt_len: int
    target: int                  # output tokens the request asks for
    first: Optional[float] = None
    last: Optional[float] = None
    tokens: int = 0              # tokens streamed
    finished: bool = False
    failed: bool = False         # rejected, cancelled or failed
    rid: Optional[int] = None    # the program's request, once taken in

    def ttft(self) -> float:
        return INF if self.first is None else self.first - self.due

    def tpot(self) -> float:
        """(last - first) / (tokens - 1); infinite until finished."""
        if not self.finished or self.failed:
            return INF
        if self.tokens < 2:
            return 0.0
        return (self.last - self.first) / (self.tokens - 1)

    def deadline(self, ttft_s: float, tpot_s: float) -> float:
        """The last wall moment at which the request can still meet both
        limits."""
        if self.first is None:
            return self.due + ttft_s
        return self.first + tpot_s * max(self.target - 1, 0)

    def settled(self, now: float, ttft_s: float, tpot_s: float) -> bool:
        """Finished, failed, or past its deadline."""
        return (self.finished or self.failed
                or now > self.deadline(ttft_s, tpot_s))


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile by linear interpolation between order
    statistics (numpy's default); an infinite value stays infinite."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of nothing")
    h = (len(xs) - 1) * q / 100.0
    lo = math.floor(h)
    hi = min(lo + 1, len(xs) - 1)
    if math.isinf(xs[hi]) or math.isinf(xs[lo]):
        return xs[hi] if h > lo else xs[lo]
    return xs[lo] + (h - lo) * (xs[hi] - xs[lo])


def meets(r: Timed, ttft_s: float, tpot_s: float) -> bool:
    return (r.finished and not r.failed and r.ttft() <= ttft_s
            and r.tpot() <= tpot_s)


def attainment(reqs: Sequence[Timed], ttft_s: float, tpot_s: float
               ) -> float:
    """Share of ``reqs`` that finished within both limits."""
    return sum(meets(r, ttft_s, tpot_s) for r in reqs) / len(reqs)


def tokens_per_s(reqs: Sequence[Timed], tokens_in_window: int,
                 seconds: float) -> float:
    """Prompt tokens of the requests whose first token came inside the
    window, plus the output tokens streamed inside it, over its length."""
    prompts = sum(r.prompt_len for r in reqs
                  if r.first is not None and 0.0 <= r.first < seconds)
    return (prompts + tokens_in_window) / seconds


def finite(x: float) -> float:
    return NEVER if math.isinf(x) else x


def end_to_end(window: Sequence[Timed], limits: Dict[str, float],
               tokens_in_window: int, seconds: float) -> Dict[str, float]:
    """Every end-to-end quantity the harness can take from a run; the
    cell reports the ones ``BENCHMARK.json`` gives it."""
    ttft_s, tpot_s = limits["ttft_s"], limits["tpot_s"]
    return {
        "ttft_p90_s": finite(percentile([r.ttft() for r in window], 90)),
        "tpot_p90_s": finite(percentile([r.tpot() for r in window], 90)),
        "slo_attainment": attainment(window, ttft_s, tpot_s),
        "tokens_per_s": tokens_per_s(window, tokens_in_window, seconds),
    }


def candidates(window: Sequence[Timed]) -> Dict[str, float]:
    """Other statistics of the same requests, for the record."""
    ttft = [r.ttft() for r in window]
    tpot = [r.tpot() for r in window]
    out = {f"{n}_p{q}": finite(percentile(xs, q))
           for n, xs in (("ttft", ttft), ("tpot", tpot))
           for q in (50, 75, 90)}
    out.update(ttft_mean=finite(sum(ttft) / len(ttft)),
               tpot_mean=finite(sum(tpot) / len(tpot)))
    return out
