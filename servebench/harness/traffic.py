"""The one traffic generator: it reads a mix's data file
(``servebench/traffic/<mix>.json``) and makes the requests of a run from
``--seed``.

The lengths follow ``repro_torch.sim.workload``'s ``LengthDist`` (a
lognormal token count, truncated to an integer and clipped), copied here
so that the yardstick stays put when the program changes.  Arrivals are
an open loop: a Poisson process, optionally with bursts of a higher rate.

Every seed gets the same work, in an order of its own.  The window is
cut into periods of the run's length; a period holds ``round(expected
arrivals)`` requests whose inter-arrival gaps are the stratified
quantiles of the exponential law (scaled to fill the period exactly)
and whose prompt and output lengths are the stratified quantiles of
their laws.  The run's ``--seed`` permutes the gaps and the two length
lists (so which sizes arrive together is the seed's), and draws the
token ids (and, in ``weights.py``, the weights).  The order is balanced
(``balanced``): each run of about ``BLOCK`` consecutive arrivals holds a
gap, a prompt and an output length from each of about ``BLOCK`` equal
strata of their laws, so no seed sends the longest requests, or the
shortest gaps, all together.

Mix file keys: ``arrivals`` {``rate_per_s``, optional ``bursts``
{``every_s``, ``length_s``, ``factor``, ``offset_s``}}, ``prompt_tokens``
and ``output_tokens`` {``mu``, ``sigma``, ``lo``, ``hi``}, optional
``shared_prefix`` {``groups``, ``tokens``}: the leading tokens of each
prompt taken from one of ``groups`` fixed prefixes), ``limits``
{``ttft_s``, ``tpot_s``}, ``after_window`` (``drain``: arrivals go on and
the requests due in the window are waited for until each has finished
or can no longer meet both limits; ``stop``: the run ends when the
window closes), ``warmup`` {``requests``, ``max_output``} and ``check``
{``served_tokens``, ``max_tokens``} (the sample the reference compares).

A request's inputs beyond its prompt ids (an image, say) are its
configuration's family's (``servebench/families/``), drawn from the
``inputs`` stream of its seed and its index.
"""
from __future__ import annotations

import dataclasses
import statistics
from typing import Iterator, List

import numpy as np

_NORMAL = statistics.NormalDist()

#: arrivals in a run of the balanced order (``balanced``)
BLOCK = 8

#: independent random streams of one seed
STREAMS = {"window": 0, "warmup": 1, "sample": 2, "weights": 3,
           "prefix": 4, "schedule": 5, "inputs": 6}


def rng_for(seed: int, stream: str, *more: int) -> np.random.Generator:
    """A generator for one stream of ``seed`` (any whole number)."""
    return np.random.default_rng([seed % (1 << 63), STREAMS[stream], *more])


def balanced(rng: np.random.Generator, values: np.ndarray,
             block: int = BLOCK) -> np.ndarray:
    """``values`` (sorted) in an order drawn from ``rng``, cut into
    ``ceil(n / block)`` runs of at most ``block`` entries (the longer runs
    first) in which each holds at most one value from each stratum: slices
    of as many consecutive values as there are runs."""
    n = len(values)
    runs = -(-n // block)
    grid = np.full((runs, block), -1)
    for j in range(-(-n // runs)):
        stratum = np.arange(j * runs, min(n, (j + 1) * runs))
        grid[rng.permutation(runs)[:len(stratum)], j] = stratum
    grid = grid[np.argsort(-(grid >= 0).sum(axis=1), kind="stable")]
    order = [i for row in grid for i in rng.permutation(row) if i >= 0]
    return values[np.array(order, dtype=int)]


@dataclasses.dataclass(frozen=True)
class LengthDist:
    """A lognormal token count: ``exp(N(mu, sigma))``, truncated to an
    integer and clipped to [lo, hi] (``sim.workload.LengthDist``)."""
    mu: float
    sigma: float
    lo: int
    hi: int

    @classmethod
    def from_json(cls, d: dict) -> "LengthDist":
        return cls(float(d["mu"]), float(d["sigma"]), int(d["lo"]),
                   int(d["hi"]))

    def quantiles(self, n: int) -> np.ndarray:
        """The law's (i + 1/2) / n quantiles, i < n: n lengths whose
        histogram is the law's, the same for every seed."""
        z = np.array([_NORMAL.inv_cdf((i + 0.5) / n) for i in range(n)])
        x = np.exp(self.mu + self.sigma * z)
        return np.clip(x.astype(int), self.lo, self.hi)


@dataclasses.dataclass
class Arrival:
    """One request as the generator makes it."""
    index: int            # order of arrival in the run
    due: float            # seconds after the window opens
    prompt: np.ndarray    # int32 token ids
    output_len: int
    # what it carries beyond its prompt ids (its family's ``inputs``)
    inputs: dict = dataclasses.field(default_factory=dict)


class Traffic:
    def __init__(self, mix: dict, vocab_size: int, period_s: float,
                 inputs=None):
        """``inputs``: the cell's family's ``inputs`` (None: a request
        carries its prompt ids alone)."""
        self.mix = mix
        self.inputs = inputs
        self.vocab_size = int(vocab_size)
        self.period_s = float(period_s)
        arr = mix["arrivals"]
        self.rate = float(arr["rate_per_s"])
        self.bursts = arr.get("bursts")
        self.prompt = LengthDist.from_json(mix["prompt_tokens"])
        self.output = LengthDist.from_json(mix["output_tokens"])
        self.limits = mix["limits"]
        self.drain = mix.get("after_window", "stop") == "drain"
        # the intensity's integral over one period, on a 1 ms grid
        self._grid = np.linspace(0.0, self.period_s,
                                 int(round(self.period_s * 1000)) + 1)
        self._cum = np.concatenate(
            [[0.0], np.cumsum(self._intensity(self._grid[:-1])
                              * np.diff(self._grid))])

    def _intensity(self, t: np.ndarray) -> np.ndarray:
        if not self.bursts:
            return np.full_like(t, self.rate)
        b = self.bursts
        inside = ((t - b.get("offset_s", 0.0)) % b["every_s"]) \
            < b["length_s"]
        return np.where(inside, self.rate * b["factor"], self.rate)

    @property
    def per_period(self) -> int:
        """Requests in one period (the same in every period)."""
        return max(1, int(round(self._cum[-1])))

    def _prefixes(self, seed: int) -> List[np.ndarray]:
        sp = self.mix.get("shared_prefix")
        if not sp:
            return []
        rng = rng_for(seed, "prefix")
        return [rng.integers(1, self.vocab_size, size=int(sp["tokens"]),
                             dtype=np.int32)
                for _ in range(int(sp["groups"]))]

    def period(self, seed: int, k: int, stream: str = "window"
               ) -> List[Arrival]:
        """The arrivals of period ``k``: due in [k P, (k + 1) P)."""
        n = self.per_period
        order = rng_for(seed, "schedule", STREAMS[stream], k)
        e = -np.log1p(-(np.arange(n) + 0.5) / n)
        gaps = balanced(order, np.sort(e / e.sum() * self._cum[-1]))
        u = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
        due = k * self.period_s + np.interp(u, self._cum, self._grid)
        plens = balanced(order, self.prompt.quantiles(n))
        olens = balanced(order, self.output.quantiles(n))
        rng = rng_for(seed, stream, k)
        prefixes = self._prefixes(seed)
        out = []
        for i in range(n):
            p = int(plens[i])
            prompt = rng.integers(1, self.vocab_size, size=p,
                                  dtype=np.int32)
            if prefixes:
                pre = prefixes[int(rng.integers(len(prefixes)))]
                m = min(len(pre), p - 1)
                prompt[:m] = pre[:m]
            out.append(Arrival(k * n + i, float(due[i]), prompt,
                               int(olens[i])))
        return self._with_inputs(seed, stream, out)

    def arrivals(self, seed: int) -> Iterator[Arrival]:
        """Period after period, without end: the window's, then the
        drain's (the same rate goes on after the window)."""
        k = 0
        while True:
            yield from self.period(seed, k)
            k += 1

    def warmup(self, seed: int) -> List[Arrival]:
        """A burst, all due at 0, from the warm-up stream: the mix's
        lengths at ``warmup.requests`` stratified quantiles (its longest
        prompt included), outputs capped at ``warmup.max_output``."""
        w = self.mix["warmup"]
        n = int(w["requests"])
        rng = rng_for(seed, "warmup")
        plens = self.prompt.quantiles(n)
        plens[-1] = self.prompt.hi
        olens = np.minimum(rng.permutation(self.output.quantiles(n)),
                           int(w["max_output"]))
        return self._with_inputs(seed, "warmup", [
            Arrival(i, 0.0, rng.integers(1, self.vocab_size, size=int(p),
                                         dtype=np.int32), int(o))
            for i, (p, o) in enumerate(zip(plens, olens))])

    def _with_inputs(self, seed: int, stream: str, arrivals: List[Arrival]
                     ) -> List[Arrival]:
        """Each arrival's inputs, drawn from a stream of its own (the
        stream of its arrivals and its index), so the other streams draw
        what they draw without inputs."""
        if self.inputs is not None:
            for a in arrivals:
                a.inputs = self.inputs(a, rng_for(seed, "inputs",
                                                  STREAMS[stream], a.index))
        return arrivals
