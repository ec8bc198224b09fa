"""Synthetic workloads matched to the paper's datasets (§4.1, Fig 14).

ShareGPT and ArXiv-Summarization are not redistributable offline, so we
sample from lognormal length mixtures fitted to the paper's Fig 14
histograms, with the paper's own filters (ShareGPT <= 2048 tokens,
ArXiv <= 16384 tokens).  Arrivals are Poisson, as in the paper and in
DistServe/Sarathi.

``MultiTurnSpec`` additionally models the traffic family the prefix
cache targets: sessions that re-send a shared system prompt plus the
growing conversation history every turn, emitting REAL token-id streams
(so block hashing sees actual content) with a controllable prefix-share
ratio.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Iterator, List, Optional, Tuple

import numpy as np

from repro_torch.engine.request import Request


def _iter_open_loop(spec, qps: float, seed: int, max_new_tokens: int,
                    limit: Optional[int], chunk: int) -> Iterator:
    """Open-loop arrival stream over any spec with ``sample_requests``:
    sample lazily in chunks, offsetting each chunk to continue where the
    previous one ended, so a long (or unbounded when ``limit`` is None)
    run never materializes its trace."""
    t0, k, emitted = 0.0, 0, 0
    while limit is None or emitted < limit:
        batch = spec.sample_requests(chunk, qps, seed=seed + k,
                                     max_new_tokens=max_new_tokens)
        for r in batch:
            r.arrival += t0
            yield r
            emitted += 1
            if limit is not None and emitted >= limit:
                return
        t0 = batch[-1].arrival
        k += 1


@dataclasses.dataclass(frozen=True)
class LengthDist:
    mu: float          # lognormal location (of token count)
    sigma: float
    lo: int
    hi: int

    def sample(self, rng, n) -> np.ndarray:
        x = rng.lognormal(self.mu, self.sigma, size=n)
        return np.clip(x.astype(int), self.lo, self.hi)

    def mean(self) -> float:
        return float(np.exp(self.mu + self.sigma ** 2 / 2))


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    name: str
    prompt: LengthDist
    output: LengthDist
    tokenized: bool = False    # emit random token ids (no shared content
    vocab_size: int = 32000    # — a prefix-share≈0 baseline for caching)

    def sample_requests(self, n: int, qps: float, seed: int = 0,
                        max_new_tokens: int = 4096) -> List[Request]:
        rng = np.random.default_rng(seed)
        gaps = rng.exponential(1.0 / qps, size=n)
        arrivals = np.cumsum(gaps)
        plens = self.prompt.sample(rng, n)
        olens = self.output.sample(rng, n)
        return [
            Request(prompt_len=int(p), max_new_tokens=max_new_tokens,
                    arrival=float(t), hidden_output_len=int(o),
                    prompt_tokens=(
                        [int(x) for x in
                         rng.integers(1, self.vocab_size, size=int(p))]
                        if self.tokenized else None),
                    shared_prefix_len=0 if self.tokenized else None)
            for p, o, t in zip(plens, olens, arrivals)
        ]

    def iter_requests(self, qps: float, seed: int = 0,
                      max_new_tokens: int = 4096,
                      limit: Optional[int] = None,
                      chunk: int = 64) -> Iterator[Request]:
        """Open-loop arrival stream for the online serving runtime."""
        return _iter_open_loop(self, qps, seed, max_new_tokens, limit,
                               chunk)


@dataclasses.dataclass(frozen=True)
class MultiTurnSpec:
    """Multi-turn chat / agentic sessions with shared system prompts.

    Each session draws one of ``n_system_prompts`` shared system
    prefixes, then alternates user turns and (synthetic) assistant
    replies; every turn re-sends system + full history + fresh user
    tokens, so consecutive turns share a growing token prefix and
    first turns share the system prompt across sessions.  Sessions
    arrive Poisson at ``qps / mean_turns`` (request rate ≈ qps); turns
    within a session are spaced by exponential think time.

    Prefix share is controlled by the system-prompt length vs. the
    fresh-user-turn length and the turn count; ``nominal share ≈
    (system + history) / prompt`` is recorded per request in
    ``Request.shared_prefix_len`` (generator ground truth — schedulers
    must not read it)."""
    name: str
    user: LengthDist
    output: LengthDist
    system_prompt_len: int = 512
    n_system_prompts: int = 4
    turns: Tuple[int, int] = (2, 6)     # inclusive turns-per-session range
    think_time: float = 2.0             # mean seconds between turns
    vocab_size: int = 32000
    max_prompt: int = 16384

    @property
    def mean_turns(self) -> float:
        return (self.turns[0] + self.turns[1]) / 2.0

    def sample_requests(self, n: int, qps: float, seed: int = 0,
                        max_new_tokens: int = 4096) -> List[Request]:
        rng = np.random.default_rng(seed)
        systems = [
            [int(x) for x in rng.integers(1, self.vocab_size,
                                          size=self.system_prompt_len)]
            for _ in range(self.n_system_prompts)]
        reqs: List[Request] = []
        t = 0.0
        while len(reqs) < n:
            t += rng.exponential(self.mean_turns / qps)
            arr = t
            n_turns = int(rng.integers(self.turns[0], self.turns[1] + 1))
            history = list(systems[int(rng.integers(self.n_system_prompts))])
            for turn in range(n_turns):
                if len(reqs) >= n:
                    break
                u = int(self.user.sample(rng, 1)[0])
                prompt = history + [
                    int(x) for x in rng.integers(1, self.vocab_size, size=u)]
                if len(prompt) > self.max_prompt:
                    break                      # context budget: end session
                o = int(self.output.sample(rng, 1)[0])
                reqs.append(Request(
                    prompt_len=len(prompt), max_new_tokens=max_new_tokens,
                    arrival=arr, hidden_output_len=o,
                    prompt_tokens=prompt,
                    shared_prefix_len=len(history)))
                # next turn re-sends this prompt + a synthetic stand-in
                # for the assistant reply (sim outputs have no token ids)
                history = prompt + [
                    int(x) for x in rng.integers(1, self.vocab_size, size=o)]
                arr += rng.exponential(self.think_time)
        reqs.sort(key=lambda r: r.arrival)
        return reqs

    def iter_requests(self, qps: float, seed: int = 0,
                      max_new_tokens: int = 4096,
                      limit: Optional[int] = None,
                      chunk: int = 64) -> Iterator[Request]:
        """Open-loop stream (sessions regenerate per chunk — session
        continuity holds within a chunk, which is what the prefix cache
        exploits anyway)."""
        return _iter_open_loop(self, qps, seed, max_new_tokens, limit,
                               chunk)


@dataclasses.dataclass(frozen=True)
class Phase:
    """One leg of a drifting workload: draw arrivals from ``spec`` for
    ``duration`` simulated seconds at ``qps_scale`` x the base rate."""
    spec: object                       # WorkloadSpec | MultiTurnSpec
    duration: float
    qps_scale: float = 1.0


@dataclasses.dataclass(frozen=True)
class PhaseDriftSpec:
    """Traffic whose character shifts mid-run — e.g. prompt-heavy
    (summarization burst) -> decode-heavy (generation burst) ->
    multiturn (chat with shared prefixes).  This is the workload the
    online slider controller exists for: a configuration frozen for any
    single phase leaves goodput on the table in the others.

    ``iter_requests`` yields requests in arrival order, one phase after
    another, so the serving loop can ingest them open-loop without
    materializing the full trace."""
    name: str
    phases: Tuple[Phase, ...]

    @property
    def total_duration(self) -> float:
        return sum(p.duration for p in self.phases)

    def iter_requests(self, qps: float, seed: int = 0,
                      max_new_tokens: int = 4096) -> Iterator[Request]:
        t0 = 0.0
        for k, ph in enumerate(self.phases):
            q = max(qps * ph.qps_scale, 1e-6)
            # oversample, keep arrivals inside the phase window
            n_est = max(8, int(q * ph.duration * 2) + 16)
            for r in ph.spec.sample_requests(n_est, q, seed=seed + k,
                                             max_new_tokens=max_new_tokens):
                if r.arrival >= ph.duration:
                    break
                r.arrival += t0
                yield r
            t0 += ph.duration

    def sample_requests(self, n: int, qps: float, seed: int = 0,
                        max_new_tokens: int = 4096) -> List[Request]:
        """Materialized view (capped at ``n``) for the batch harnesses;
        the drift itself is bounded by phase durations, not ``n``."""
        return list(itertools.islice(
            self.iter_requests(qps, seed, max_new_tokens), n))


def measured_prefix_share(reqs) -> float:
    """Mean fraction of prompt tokens previously emitted in the same
    session/system-prompt group (generator ground truth)."""
    shares = [r.shared_prefix_len / r.prompt_len for r in reqs
              if r.shared_prefix_len is not None and r.prompt_len > 0]
    return float(np.mean(shares)) if shares else 0.0


# ShareGPT-like (chatbot): median prompt ~ 250, long tail to 2048 (paper
# filter); outputs median ~ 200, tail to ~1024.
SHAREGPT = WorkloadSpec(
    name="sharegpt",
    prompt=LengthDist(mu=5.5, sigma=1.1, lo=8, hi=2048),
    output=LengthDist(mu=5.3, sigma=0.9, lo=4, hi=1024),
)

# ArXiv-Summarization-like: long prompts 2k–16k (paper §2.5 "prefill
# lengths mostly range from 2k to 16k"), short-ish summaries.
ARXIV = WorkloadSpec(
    name="arxiv",
    prompt=LengthDist(mu=8.6, sigma=0.55, lo=2048, hi=16384),
    output=LengthDist(mu=5.0, sigma=0.6, lo=32, hi=1024),
)

# Multi-turn chat: ~500-token shared system prompt, short fresh user
# turns, history re-sent every turn — prefix share rises from ~0.65 on
# first turns toward ~0.9 deep into a session.
MULTITURN = MultiTurnSpec(
    name="multiturn",
    user=LengthDist(mu=5.2, sigma=0.7, lo=16, hi=1024),
    output=LengthDist(mu=5.3, sigma=0.9, lo=4, hi=1024),
    system_prompt_len=512, n_system_prompts=4, turns=(2, 6),
    think_time=2.0)

# Agentic loops: one long shared tool/system preamble, tiny fresh
# deltas, many turns — the extreme prefix-share end.
AGENTIC = MultiTurnSpec(
    name="agentic",
    user=LengthDist(mu=4.2, sigma=0.5, lo=8, hi=256),
    output=LengthDist(mu=4.5, sigma=0.6, lo=8, hi=256),
    system_prompt_len=2048, n_system_prompts=2, turns=(4, 10),
    think_time=0.5)

# Prompt-heavy: long prompts, single-token outputs (scoring /
# classification / reranking traffic) — pure TTFT-bound load whose
# capacity scales with how many instances take real prefill chunks
# (aggregation-ward slider settings win).
PROMPT_HEAVY = WorkloadSpec(
    name="prompt_heavy",
    prompt=LengthDist(mu=7.5, sigma=0.4, lo=1024, hi=4096),
    output=LengthDist(mu=0.0, sigma=0.0, lo=1, hi=1),
)

# Decode-heavy: short prompts, long generations — a decode population
# large enough that TPOT is bound by batch size and chunk interference
# (disaggregation-ward settings win: small S_D, more D-heavy instances).
DECODE_HEAVY = WorkloadSpec(
    name="decode_heavy",
    prompt=LengthDist(mu=5.7, sigma=0.35, lo=128, hi=512),
    output=LengthDist(mu=6.1, sigma=0.3, lo=256, hi=768),
)

# The controller's canonical scenario: prompt-heavy -> decode-heavy ->
# multiturn.  No static slider setting is right for all three phases:
# the burst wants every instance prefilling, the decode tsunami wants
# small chunks and a D-rich ratio, and the multiturn tail re-sends
# growing histories (prefill pressure back up, interference still
# fatal).  The decode-heavy leg runs at 2.5x the base rate — token
# demand, not request rate, is what's comparable across phases.
DRIFT = PhaseDriftSpec(
    name="drift",
    phases=(Phase(PROMPT_HEAVY, 24.0, qps_scale=1.4),
            Phase(DECODE_HEAVY, 24.0, qps_scale=1.35),
            Phase(MULTITURN, 32.0, qps_scale=1.1)))

WORKLOADS = {w.name: w for w in (SHAREGPT, ARXIV, MULTITURN, AGENTIC,
                                 PROMPT_HEAVY, DECODE_HEAVY, DRIFT)}
