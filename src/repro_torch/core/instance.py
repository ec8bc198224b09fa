"""Serving instance: a TP group running mixed chunked-prefill + decode
batches (aggregated batch handling).  P-heavy and D-heavy instances are
*the same class* with different chunk sizes — the paper's point is that
capability differentiation is purely a chunk-size configuration (§3.1).

The instance owns: a prefill queue (FIFO), the set of decoding requests,
HBM block accounting, and an executor that actually produces tokens
(real JAX engine, or the simulator's token oracle).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Dict, List, Optional, Protocol, Sequence, Tuple

from repro_torch.cache.prefix_cache import PrefixCache
from repro_torch.core.estimator import CostModel
from repro_torch.engine.kvcache import BlockAllocator
from repro_torch.engine.request import Request, State

P_HEAVY = "P"
D_HEAVY = "D"

# instance health (fault tolerance): OK serves; QUARANTINED is excluded
# from placement but keeps its KV (watchdog probation re-admits); DEAD
# lost its HBM entirely and needs an explicit recover
HEALTH_OK = "ok"
HEALTH_QUARANTINED = "quarantined"
HEALTH_DEAD = "dead"


@dataclasses.dataclass
class IterationPlan:
    prefill_items: List[Tuple[Request, int]]      # (request, chunk tokens)
    decode_reqs: List[Request]
    #: fused decode steps this iteration executes (1 = classic single
    #: step; > 1 only on decode-only plans — a co-scheduled chunked
    #: prefill always forces K back to 1)
    horizon: int = 1
    #: per-row token budgets for horizon > 1 (aligned with decode_reqs):
    #: min(horizon, remaining output, allocator-extendable growth)
    decode_budgets: Optional[List[int]] = None
    #: per-step modeled durations, filled by iteration_duration for
    #: horizon > 1 so token timestamps spread exactly like K=1 events
    step_durations: Optional[List[float]] = None

    @property
    def prefill_tokens(self) -> int:
        return sum(t for _, t in self.prefill_items)

    def prefill_rows(self) -> List[Tuple[Request, int, int, bool]]:
        """Batch-plan surface for executors: one row per prefill chunk as
        ``(request, start_position, take, completes_prefill)``."""
        return [(r, r.prefill_pos, t, t == r.prefill_remaining)
                for r, t in self.prefill_items]

    def empty(self) -> bool:
        return not self.prefill_items and not self.decode_reqs


@dataclasses.dataclass
class CommitResult:
    """Outcome of one committed iteration (second half of the
    dispatch/commit split).  ``token_events`` carries the deferred
    per-token sink calls ``(request, time)`` when the caller asked for
    deferred emission — so it can dispatch the next horizon before the
    host spends time streaming these."""
    duration: float
    prefill_done: List[Request]
    finished: List[Request]
    token_events: List[Tuple[Request, float]]


class Executor(Protocol):
    """Produces tokens for a planned iteration; returns per-request
    "finished decoding" flags (EOS) for decode requests."""

    def execute(self, plan: IterationPlan) -> Dict[int, bool]: ...

    def add_request(self, req: Request): ...

    def claim_prefix(self, req: Request, max_tokens: int) -> int: ...

    def extract_state(self, req: Request): ...

    def insert_state(self, req: Request, state): ...

    def release(self, req: Request): ...


#: HBM-utilization level above which the horizon collapses to 1 — near
#: the degradation watermark every iteration must be schedulable so
#: Algorithm 1 can start flowing requests without a K-step lag
HORIZON_HBM_GUARD = 0.90


class Instance:
    def __init__(self, iid: int, itype: str, chunk_size: int,
                 cost: CostModel, executor: Executor,
                 hbm_blocks: int = 4096, block_size: int = 16,
                 max_decode_batch: int = 256,
                 prefix_cache: Optional[PrefixCache] = None,
                 max_horizon: int = 1,
                 tpot_slo: Optional[float] = None,
                 tpot_alpha: float = 0.96):
        self.iid = iid
        self.itype = itype
        self.chunk_size = chunk_size
        self.cost = cost
        self.executor = executor
        if prefix_cache is None:
            # a paged executor with prefix caching enabled owns the
            # PrefixCache (its allocator's ids index the physical pool)
            prefix_cache = getattr(executor, "prefix_cache_obj", None)
        else:
            adopt = getattr(executor, "adopt_prefix_cache", None)
            if adopt is not None and not adopt(prefix_cache) \
                    and getattr(executor, "paged", False):
                # a paged executor that cannot bind the caller's
                # PrefixCache would run two divergent block-bookkeeping
                # systems (and a mismatched block size would round
                # prefill_pos into aliased shared blocks) — refuse
                raise ValueError(
                    "prefix_cache.block_size must match the paged "
                    "executor's cache_block_size")
        self.prefix_cache = prefix_cache
        if prefix_cache is not None:
            # watermark/degradation reads the SHARED allocator: cached
            # (refcount-0) blocks are evictable, so they don't pressure M
            self.allocator = prefix_cache.allocator
        elif getattr(executor, "allocator", None) is not None:
            # unified bookkeeping: admission draws from the allocator
            # whose block ids index the executor's physical pool, so HBM
            # capacity is bounded by actual context, not n_slots*max_seq
            self.allocator = executor.allocator
        else:
            self.allocator = BlockAllocator(hbm_blocks, block_size)
        if self.allocator is getattr(executor, "allocator", None):
            # this Instance now drives allocate/extend/free; the
            # executor must stop self-managing the same allocator
            executor.use_external_bookkeeping()
        self.max_decode_batch = max_decode_batch
        # multi-step decode horizon: upper bound on fused decode steps
        # per iteration (1 = classic).  tpot_slo/tpot_alpha describe the
        # flowing-decode budget the adaptive pick shrinks K against
        # (wired by the policy; optional for standalone instances).
        self.max_horizon = max_horizon
        self.tpot_slo = tpot_slo
        self.tpot_alpha = tpot_alpha
        self.last_horizon = 1
        self.horizon_peak = 1
        # horizon distribution: planned K -> iteration count (telemetry
        # gauge; shows where the adaptive pick actually operates)
        self.horizon_hist: Dict[int, int] = {}
        # in-flight iteration (dispatch/commit split): (plan, pending
        # executor step or None, start time, modeled duration)
        self._inflight: Optional[tuple] = None

        self.prefill_queue: deque[Request] = deque()
        self.decoding: Dict[int, Request] = {}
        self.pending_decode: deque[Request] = deque()
        # online-serving hooks: a per-token callback installed by the
        # serving loop (streaming), and drain-and-flip reconfiguration
        # state driven by the adaptive slider controller
        self.token_sink: Optional[Callable[[Request, float], None]] = None
        self.draining: bool = False
        self.pending_flip: Optional[Tuple[str, int]] = None
        self.role_flips: int = 0
        # fault tolerance: health gates placement exactly like draining;
        # stall_until models a transient slowdown (dispatch durations run
        # behind the cost model until then); last_progress/step_deadline
        # feed the serving loop's watchdog
        self.health: str = HEALTH_OK
        self.stall_until: float = 0.0
        self.last_progress: float = 0.0
        self.step_deadline: float = float("inf")
        #: worst dispatch-time stall overrun (actual - modeled duration)
        #: since the watchdog last looked — the sync executor's
        #: heartbeat signal (dispatch+commit are one atomic event there,
        #: so a stale step_deadline is never observable mid-step)
        self.overrun: float = 0.0
        self.fail_count: int = 0
        self.quarantine_count: int = 0
        #: request-lifecycle tracer (wired by ServingLoop; None = off)
        self.tracer = None
        # accounting
        self.busy_until: float = 0.0
        self.iterations: int = 0
        self.prefill_token_count: int = 0
        self.decode_token_count: int = 0
        self.interference_log: List[Tuple[int, int]] = []  # (ptk, dtk)
        self.stalled_decodes: int = 0
        self.preemptions: int = 0
        self.cache_lookups: int = 0
        self.cache_hits: int = 0
        self.cached_prefill_tokens: int = 0    # prefill tokens NOT recomputed
        # multi-tier KV accounting
        self.spill_promoted_tokens: int = 0    # host tier -> HBM prefetches
        self.replicas_in: int = 0              # blocks landed by replication
        # warm recovery: victims resumed from a checkpoint here, stream
        # tokens they did NOT re-prefill, and planned-warm restores that
        # had to fall back to cold recompute on this executor
        self.warm_restores: int = 0
        self.warm_restored_tokens: int = 0
        self.warm_fallbacks: int = 0

    # ------------------------------------------------------------------
    # admission / queues
    # ------------------------------------------------------------------
    def enqueue_prefill(self, req: Request):
        self.prefill_queue.append(req)

    def queued_prefill_tokens(self) -> int:
        return sum(r.prefill_remaining for r in self.prefill_queue)

    def admit_decode(self, req: Request):
        """Called by the proxy when this instance is chosen for decode."""
        self.pending_decode.append(req)

    def hbm_utilization(self) -> float:
        return self.allocator.utilization()

    def peek_prefix(self, req: Request) -> int:
        """Longest cached prefix (tokens) this instance could reuse for
        ``req`` — pure, so the proxy can probe every instance when
        routing (cache-aware TTFT_hat).  Counts BOTH tiers: host-spilled
        blocks are promoted back to HBM at admission (``prefetch``), so
        for routing purposes they are as reusable as resident ones."""
        if req.prefill_pos != 0:
            return 0
        if self.prefix_cache is None or not req.prompt_tokens:
            return 0
        return self.prefix_cache.match_tokens_tiered(req.prompt_tokens)

    def _match_prefix(self, req: Request) -> int:
        if self.prefix_cache is None or not req.prompt_tokens:
            return 0
        return self.prefix_cache.match_tokens(req.prompt_tokens)

    def peek_migration_prefix(self, req: Request) -> int:
        """Longest cached prefix (tokens) of a MIGRATING request's prompt
        this instance already holds — a flowing-decode move only ships
        the non-shared suffix, so its transfer cost is charged on
        ``context_len - peek_migration_prefix`` (pure, like
        ``peek_prefix``, but valid mid-decode).  Zero unless this
        instance's executor actually lands migrations by aliasing cached
        blocks (paged engine / simulator) — a dense engine ships the
        full row and must be charged in full."""
        if not getattr(self.executor, "prefix_aware_transfer", False):
            return 0
        return self._match_prefix(req)

    def decode_load(self) -> int:
        """HBM usage proxy for proxy-side load balancing (paper §3.3 ①)."""
        return self.allocator.used_blocks

    @property
    def schedulable(self) -> bool:
        """Health gate for every placement/migration-destination choice
        (draining is a separate, role-flip-scoped gate)."""
        return self.health == HEALTH_OK

    # ------------------------------------------------------------------
    # role reconfiguration (drain-and-flip)
    # ------------------------------------------------------------------
    def begin_flip(self, itype: str, chunk_size: int):
        """Stage a role flip: the instance stops accepting decode
        placements (``draining``) while the cluster migrates its decode
        population away; ``apply_flip`` lands once drained."""
        self.pending_flip = (itype, chunk_size)
        self.draining = True

    def drain_candidates(self) -> List[Request]:
        """Decode-side residents that must migrate before a staged flip
        applies.  Prefill work is NOT drained — it keeps running through
        the flip (the chunk size just changes underneath it)."""
        return list(self.decoding.values()) + list(self.pending_decode)

    def apply_flip(self) -> bool:
        """Land a staged flip if the decode side is empty."""
        if self.pending_flip is None:
            return False
        if self.decoding or self.pending_decode:
            return False
        self.itype, self.chunk_size = self.pending_flip
        self.pending_flip = None
        self.draining = False
        self.role_flips += 1
        return True

    # ------------------------------------------------------------------
    # iteration
    # ------------------------------------------------------------------
    def _try_admit_pending(self, now: Optional[float] = None):
        while self.pending_decode and len(self.decoding) < self.max_decode_batch:
            req = self.pending_decode[0]
            need = req.context_len + 64           # headroom for growth
            if not self.allocator.holds(req.rid):
                if not self.allocator.can_allocate(need):
                    break
                self.allocator.allocate(req.rid, need)
                self.executor.add_request(req)
            self.pending_decode.popleft()
            self.decoding[req.rid] = req
            req.state = State.DECODE
            req.decode_instance = self.iid
            if self.tracer is not None and now is not None:
                self.tracer.phase(req.rid, now, "decode", iid=self.iid)

    def _pick_horizon(self, now: Optional[float] = None) -> int:
        """How many decode steps the next iteration may fuse.

        The horizon must stay *schedulable*: it collapses to 1 whenever
        the instance has prefill work (a co-scheduled chunk must not
        wait K steps — TTFT), is draining toward a role flip (the
        barrier needs per-step progress), or sits near the HBM
        watermark (degradation must be able to flow requests without a
        K-step lag).  Otherwise K is the largest power of two within
        ``max_horizon``, shrunk by the flowing-decode budget: as the
        worst in-flight TPOT approaches the backflow threshold
        ``tpot_alpha * tpot_slo``, Algorithm 1 needs finer scheduling
        grain, so the horizon steps down before requests must flow."""
        if self.max_horizon <= 1 or not self.decoding:
            return 1
        if self.prefill_queue or self.draining or self.pending_flip:
            return 1
        if not getattr(self.executor, "horizon_capable", True):
            return 1
        if self.allocator.utilization() > HORIZON_HBM_GUARD:
            return 1
        k = 1
        while k * 2 <= self.max_horizon:
            k *= 2
        if now is not None and self.tpot_slo:
            worst = max((r.current_tpot(now) or 0.0
                         for r in self.decoding.values()), default=0.0)
            frac = worst / (self.tpot_alpha * self.tpot_slo)
            if frac >= 0.9:
                return 1
            if frac >= 0.75:
                k = min(k, 2)
            elif frac >= 0.5:
                k = min(k, max(2, k // 2))
        return k

    def build_plan(self, now: Optional[float] = None) -> IterationPlan:
        self._try_admit_pending(now)
        k = self._pick_horizon(now)
        decode_reqs: List[Request] = []
        budgets: List[int] = []
        for req in list(self.decoding.values()):
            # per-row horizon budget: never generate past the request's
            # remaining output, never reserve more growth than the
            # allocator can grant — but always try at least one step
            want = max(1, min(k, req.remaining_output))
            grant = 0
            for b in range(want, 0, -1):
                if self.allocator.can_extend(req.rid, req.context_len + b):
                    self.allocator.extend(req.rid, req.context_len + b)
                    grant = b
                    break
            if grant:
                decode_reqs.append(req)
                budgets.append(grant)
            else:
                self.stalled_decodes += 1
        budget = max(0, self.chunk_size - len(decode_reqs))
        if self.chunk_size <= 0 and self.prefill_queue \
                and self.allocator.holds(self.prefill_queue[0].rid):
            # a zeroed chunk slider (set_chunks(0) / drain-and-flip)
            # must never strand an ADMITTED mid-chunk prefill: it holds
            # HBM blocks and budget can never recover on its own, so
            # grant a minimal budget to keep it flowing to completion.
            # (A decode batch merely as wide as a positive chunk is NOT
            # stranding — budget frees as decodes finish.)
            budget = min(64, self.prefill_queue[0].prefill_remaining)
        items: List[Tuple[Request, int]] = []
        while budget > 0 and self.prefill_queue:
            head = self.prefill_queue[0]
            if not self.allocator.holds(head.rid):
                if not self._admit_prefill(head, now):
                    break                          # head-of-line blocking
            take = min(head.prefill_remaining, budget)
            items.append((head, take))
            budget -= take
            if take == head.prefill_remaining:
                self.prefill_queue.popleft()
                head.state = State.PREFILL
            else:
                break
        plan = IterationPlan(items, decode_reqs)
        if k > 1 and decode_reqs and not items:
            # collapse to the largest power of two any row can actually
            # use (bounds jit compile variants to the pow2 ladder); rows
            # with smaller grants freeze early via their budget
            h = 1
            mb = max(budgets)
            while h * 2 <= mb:
                h *= 2
            if h > 1:
                plan.horizon = h
                plan.decode_budgets = [min(b, h) for b in budgets]
        self.last_horizon = plan.horizon
        self.horizon_peak = max(self.horizon_peak, plan.horizon)
        if plan.empty() and self.decoding:
            # memory deadlock: every decode stalled on a block boundary
            # with zero free blocks.  vLLM-style preemption-by-recompute:
            # evict the longest-context decode; it re-prefills its whole
            # context (prompt + generated so far) later.
            victim = max(self.decoding.values(), key=lambda r: r.context_len)
            self._preempt(victim, now)
            self.preemptions += 1
            return self.build_plan(now)
        if not plan.empty():
            self.horizon_hist[plan.horizon] = \
                self.horizon_hist.get(plan.horizon, 0) + 1
        return plan

    def _admit_prefill(self, req: Request,
                       now: Optional[float] = None) -> bool:
        """Reserve HBM blocks for a queued prefill and hand the request
        to the executor.  With a prefix cache, the matched prefix is
        claimed (executor may shrink it to what its rows still hold) and
        the request's prefill starts at the matched position — the cost
        model then charges only the uncached tokens."""
        if req.restore_state is not None:
            return self._admit_restore(req, now)
        need = req.prefill_remaining + 64          # headroom for growth
        if self.prefix_cache is None:
            if not self.allocator.can_allocate(need):
                return False
            self.allocator.allocate(req.rid, need)
            self.executor.add_request(req)
            return True
        if self.prefix_cache.spill is not None and req.prompt_tokens \
                and req.prefill_pos == 0:
            # promote host-spilled continuation blocks back to HBM now,
            # so the match below (and the claim) sees them as resident —
            # a prefix the routing peek counted never silently recomputes
            self.spill_promoted_tokens += self.prefix_cache.prefetch(
                req.prompt_tokens)
        hit = 0 if req.prefill_pos != 0 else self._match_prefix(req)
        if not self.prefix_cache.can_acquire(req.prompt_tokens or (),
                                             hit, need):
            return False       # memory-blocked: no executor side effects
        if hit:
            claim = getattr(self.executor, "claim_prefix", None)
            if claim is not None:
                hit = claim(req, hit)
            hit -= hit % self.prefix_cache.block_size
        if not self.prefix_cache.acquire(req.rid, req.prompt_tokens or (),
                                         hit, need):
            # only reachable when the executor SHRANK the hit (more fresh
            # blocks needed than pre-checked): unwind the slot claim —
            # the executor re-registers the claimed row as a donor
            self.executor.release(req)
            return False
        self.cache_lookups += 1                    # one per admission
        if hit:
            self.cache_hits += 1
            self.cached_prefill_tokens += hit
            req.prefill_pos = hit
            req.cached_prefix_len = hit
        self.executor.add_request(req)
        return True

    def _admit_restore(self, req: Request,
                       now: Optional[float] = None) -> bool:
        """Land a warm-recovery restore: resume the victim from its
        checkpointed stream position instead of re-prefilling its whole
        context from token 0.  A bookkeeping-only executor (the sim's
        token oracle) restores from the progress record alone; a live
        executor adopts the materialized engine state via the ordinary
        migration landing (``insert_state``) — without one it MUST fall
        back to cold recompute, since resuming bookkeeping past KV that
        does not exist would decode garbage.  Returns False only on
        memory pressure (head-of-line retry, nothing consumed)."""
        rs = req.restore_state
        engine = rs.get("engine")
        bookkeeping = getattr(self.executor, "bookkeeping_only", False)
        if not bookkeeping and (
                engine is None or engine.get("block_size")
                != getattr(self.executor, "cache_block_size", None)):
            return self._restore_cold(req, now)
        ctx = rs["pos"] if bookkeeping else engine["pos"]
        req.recompute_offset = req.output_len
        req.prefill_pos = ctx - req.output_len
        # final footprint matches the cold path exactly: the full
        # recompute stream (prompt + emitted output) plus growth headroom
        total = req.context_len + req.prefill_remaining + 64
        if not self.allocator.can_allocate(total):
            return False
        if bookkeeping:
            self.allocator.allocate(req.rid, total)
        else:
            from repro_torch.engine.engine import MigrationFormatError
            try:
                # the can_allocate(total) pre-check above guarantees the
                # landing never defers (total >= the state's pos+headroom)
                self.executor.insert_state(req, engine)
            except MigrationFormatError:
                return self._restore_cold(req, now)
            self.allocator.extend(req.rid, total)
        self.executor.add_request(req)
        req.restore_state = None
        self.warm_restores += 1
        self.warm_restored_tokens += ctx
        if self.tracer is not None and now is not None:
            self.tracer.event(req.rid, now, "warm_restore", iid=self.iid,
                              pos=ctx, materialized=engine is not None)
        return True

    def _restore_cold(self, req: Request,
                      now: Optional[float] = None) -> bool:
        """This executor cannot host the restore plan: drop it and take
        the ordinary cold recompute-from-0 admission path."""
        req.restore_state = None
        req.recompute_offset = req.output_len
        req.prefill_pos = -req.output_len
        self.warm_fallbacks += 1
        if self.tracer is not None and now is not None:
            self.tracer.event(req.rid, now, "warm_fallback", iid=self.iid)
        return self._admit_prefill(req, now)

    def _preempt(self, req: Request, now: Optional[float] = None):
        self.decoding.pop(req.rid, None)
        if self.allocator.holds(req.rid):
            self.allocator.free(req.rid)
        self.executor.release(req)
        # recompute: remaining prefill = full context (prompt + generated);
        # the engine recovers true cache positions (and the regenerated
        # token stream) via recompute_offset
        req.recompute_offset = req.output_len
        req.prefill_pos = -req.output_len
        req.state = State.QUEUED
        if self.tracer is not None and now is not None:
            self.tracer.event(req.rid, now, "preempt", iid=self.iid,
                              ctx=req.context_len)
            self.tracer.phase(req.rid, now, "queue", reason="preempt")
        self.prefill_queue.appendleft(req)

    def iteration_duration(self, plan: IterationPlan) -> float:
        if plan.horizon <= 1:
            return self.cost.iteration_time(
                [(t, r.prefill_pos) for r, t in plan.prefill_items],
                [r.context_len for r in plan.decode_reqs])
        # a K-horizon models exactly the K single decode iterations it
        # fuses: contexts grow one token per step, so the per-step
        # durations (kept for token-timestamp spreading) sum to what a
        # K=1 schedule would have charged over the same tokens
        ctxs = [r.context_len for r in plan.decode_reqs]
        plan.step_durations = [
            self.cost.iteration_time([], [c + s for c in ctxs])
            for s in range(plan.horizon)]
        return sum(plan.step_durations)

    # ------------------------------------------------------------------
    # iteration execution: dispatch / commit (run_iteration = both)
    # ------------------------------------------------------------------
    def dispatch_iteration(self, now: float) -> Optional[float]:
        """Build a plan and hand it to the executor WITHOUT waiting for
        device results (``step_async`` when the executor has one).
        Returns the modeled duration, or None when nothing is
        schedulable; ``commit_iteration`` finishes the iteration."""
        plan = self.build_plan(now)
        if plan.empty():
            return None
        dur = self.iteration_duration(plan)
        # the watchdog's step deadline is the COST MODEL's expectation —
        # an injected/real stall extends the actual duration past it
        self.last_progress = now
        self.step_deadline = now + dur
        if now < self.stall_until:
            extra = self.stall_until - now
            dur += extra
            # the sync path commits in the same event, so the watchdog
            # can never catch step_deadline mid-flight — record the
            # overrun for its next sweep instead
            self.overrun = max(self.overrun, extra)
            if self.tracer is not None:
                self.tracer.global_event(now, "stall", iid=self.iid,
                                         extra_s=round(extra, 6))
        step_fn = getattr(self.executor, "step_async", None)
        # stage the plan BEFORE the executor call: if the step raises
        # (device fault), the fault handler's evacuation can still find
        # every request riding the plan (a fully-taken prefill is
        # already popped off the queue by build_plan)
        self._inflight = (plan, None, now, dur)
        pending = step_fn(plan) if step_fn is not None else None
        self._inflight = (plan, pending, now, dur)
        self.busy_until = now + dur
        return dur

    def has_inflight(self) -> bool:
        return self._inflight is not None

    def pending_step(self):
        """The in-flight iteration's unresolved executor step, if any —
        the serving loop polls this to prefetch device results during
        idle pacing gaps (keeps the inflight tuple's layout private)."""
        if self._inflight is None:
            return None
        pending = self._inflight[1]
        if pending is None or pending.resolved:
            return None
        return pending

    def commit_iteration(self, defer_emit: bool = False) -> CommitResult:
        """Resolve the in-flight step (the one blocking readback) and
        apply request/latency bookkeeping.  With ``defer_emit`` the
        per-token sink callbacks are returned instead of fired, so the
        caller can dispatch the next horizon first and stream these
        while the device computes (one-horizon-lagged consumption)."""
        plan, pending, t0, dur = self._inflight
        # resolve BEFORE discarding the in-flight record: if the
        # readback raises (device fault), the fault handler's
        # evacuation still sees the plan's requests
        if pending is not None:
            eos = pending.resolve()
            emitted = pending.emitted
        else:
            eos = self.executor.execute(plan)
            emitted = {}
        self._inflight = None
        end = t0 + dur
        events: List[Tuple[Request, float]] = []

        def emit(req, t):
            if self.token_sink is None:
                return
            if defer_emit:
                events.append((req, t))
            else:
                self.token_sink(req, t)

        prefill_done: List[Request] = []
        finished: List[Request] = []
        tr = self.tracer
        for req, take in plan.prefill_items:
            if tr is not None:
                # phase opens at the chunk's dispatch time (same-phase
                # transitions merge, so later chunks keep the start)
                tr.phase(req.rid, t0, "prefill", iid=self.iid)
                tr.event(req.rid, t0, "prefill_chunk", take=take,
                         pos=req.prefill_pos,
                         cached=req.cached_prefix_len)
            req.prefill_pos += take
            req.prefill_instance = (self.iid if req.prefill_instance is None
                                    else req.prefill_instance)
            self.prefill_token_count += take
            if req.prefill_remaining == 0:
                if self.prefix_cache is not None and req.prompt_tokens:
                    # publish the prompt's blocks for future prefix hits
                    self.prefix_cache.commit(req.rid, req.prompt_tokens)
                # prefill emits the first token — which may already be EOS
                # (or already exhaust the request's output budget:
                # single-token scoring/classification traffic never
                # reaches decode)
                req.record_token(end)
                emit(req, end)
                if eos.get(req.rid, False) or req.done():
                    req.state = State.FINISHED
                    req.finish_reason = self._finish_reason(req)
                    req.finish_time = end
                    self.remove_request(req)
                    finished.append(req)
                else:
                    prefill_done.append(req)

        K = plan.horizon
        budgets = plan.decode_budgets or [1] * len(plan.decode_reqs)
        counts = [emitted.get(r.rid, b)
                  for r, b in zip(plan.decode_reqs, budgets)]
        # spread horizon token timestamps over the modeled per-step
        # durations, exactly where a K=1 schedule would have put them
        # (in-flight TPOT telemetry reads per-step latency, not dur/1)
        last_t = [end] * len(plan.decode_reqs)
        t = t0
        for s in range(K):
            t = end if K == 1 else t + plan.step_durations[s]
            for i, (req, c) in enumerate(zip(plan.decode_reqs, counts)):
                if s >= c:
                    continue
                if s == 0:
                    req.interference_tokens += plan.prefill_tokens
                req.record_token(t)
                emit(req, t)
                self.decode_token_count += 1
                last_t[i] = t
        if tr is not None:
            for i, (req, c) in enumerate(zip(plan.decode_reqs, counts)):
                # per-commit decode record: fused horizon K, tokens this
                # commit actually produced, and the co-batched prefill
                # tokens that slowed every step (interference)
                tr.event(req.rid, last_t[i], "decode_commit", k=K,
                         tokens=c, interference=plan.prefill_tokens)
        for i, req in enumerate(plan.decode_reqs):
            if eos.get(req.rid, False) or req.done():
                req.state = State.FINISHED
                req.finish_reason = self._finish_reason(req)
                req.finish_time = last_t[i]
                self.remove_request(req)
                finished.append(req)
        self.interference_log.append(
            (plan.prefill_tokens, len(plan.decode_reqs)))
        self.iterations += 1
        self.busy_until = end
        self.last_progress = end
        self.step_deadline = float("inf")
        return CommitResult(dur, prefill_done, finished, events)

    @staticmethod
    def _finish_reason(req: Request) -> str:
        """OpenAI semantics: "length" when generation hit the token cap,
        "stop" when the model stopped itself (EOS / hidden output
        length) before the cap."""
        return "length" if req.output_len >= req.max_new_tokens else "stop"

    def run_iteration(self, now: float) -> Tuple[float, List[Request], List[Request]]:
        """Execute one iteration starting at ``now`` (synchronous:
        dispatch + commit back-to-back).

        Returns (duration, prefill_completed, decode_finished)."""
        dur = self.dispatch_iteration(now)
        if dur is None:
            return 0.0, [], []
        res = self.commit_iteration()
        return res.duration, res.prefill_done, res.finished

    # ------------------------------------------------------------------
    # migration support (flowing decode)
    # ------------------------------------------------------------------
    def remove_request(self, req: Request):
        self.decoding.pop(req.rid, None)
        if self.allocator.holds(req.rid):
            self.allocator.free(req.rid)
        self.executor.release(req)

    def eject(self, req: Request):
        """Remove for migration; returns opaque engine state."""
        state = self.executor.extract_state(req)
        self.decoding.pop(req.rid, None)
        if req in self.pending_decode:
            self.pending_decode.remove(req)
        if self.allocator.holds(req.rid):
            self.allocator.free(req.rid)
        self.executor.release(req)
        return state

    def inject(self, req: Request, state):
        """Receive a migrated decode request (allocation happens at
        admission time via pending queue)."""
        self.executor.insert_state(req, state)
        self.pending_decode.append(req)

    def has_work(self) -> bool:
        return bool(self.prefill_queue or self.decoding or
                    self.pending_decode)

    # ------------------------------------------------------------------
    # fault tolerance: abort / evacuation / crash wipe
    # ------------------------------------------------------------------
    def abort_request(self, req: Request) -> bool:
        """Remove ``req`` from this instance and free everything it
        holds (client abort).  The caller guarantees the request is not
        inside an in-flight iteration — those are collected at commit.
        Returns True when the request was resident here."""
        found = False
        if req in self.prefill_queue:
            self.prefill_queue.remove(req)
            found = True
        if req in self.pending_decode:
            self.pending_decode.remove(req)
            found = True
        if self.decoding.pop(req.rid, None) is not None:
            found = True
        if found:
            if self.allocator.holds(req.rid):
                self.allocator.free(req.rid)
            self.executor.release(req)
        return found

    def _abort_inflight(self) -> Optional[IterationPlan]:
        """Discard the in-flight iteration (the instance is being failed
        or quarantined): the device result is abandoned, no tokens are
        applied.  Returns the abandoned plan so the caller can evacuate
        requests that live only in it (a fully-taken prefill is popped
        off the queue at dispatch)."""
        if self._inflight is None:
            return None
        plan, pending, _, _ = self._inflight
        self._inflight = None
        if pending is not None and not pending.resolved:
            abort = getattr(self.executor, "abort_step", None)
            if abort is not None:
                abort(pending)
            else:
                pending.resolved = True
        self.step_deadline = float("inf")
        return plan

    def evacuate(self) -> List[Request]:
        """Pull every resident request off this instance — queued
        prefills, pending and active decodes, and anything riding the
        abandoned in-flight plan — freeing their blocks and executor
        rows.  Returns the victims for the cluster to re-route through
        preemption-by-recompute (or fail, under fail-stop)."""
        plan = self._abort_inflight()
        victims: List[Request] = []
        seen = set()

        def take(r: Request):
            if r.rid not in seen:
                seen.add(r.rid)
                victims.append(r)

        for r in self.prefill_queue:
            take(r)
        for r in self.pending_decode:
            take(r)
        for r in list(self.decoding.values()):
            take(r)
        if plan is not None:
            for r, _ in plan.prefill_items:
                take(r)
            for r in plan.decode_reqs:
                take(r)
        self.prefill_queue.clear()
        self.pending_decode.clear()
        self.decoding.clear()
        for r in victims:
            if self.allocator.holds(r.rid):
                self.allocator.free(r.rid)
            self.executor.release(r)
        return victims

    def wipe_cache(self):
        """Total HBM/KV loss (crash): drop the prefix cache — host spill
        tier included, the whole node is gone — and let the executor
        forget device-side residue that outlives requests (donor rows,
        deferred migration payloads)."""
        if self.prefix_cache is not None:
            self.prefix_cache.clear()
        hook = getattr(self.executor, "on_crash", None)
        if hook is not None:
            hook()

    # ------------------------------------------------------------------
    # hot-prefix replication (cross-instance, block-granular)
    # ------------------------------------------------------------------
    def hot_prefixes(self, max_paths: int = 2,
                     min_hits: int = 3) -> List[Tuple[tuple, int]]:
        """This instance's hottest matchable token prefixes (by touching
        match count) — the controller's replication candidates."""
        if self.prefix_cache is None:
            return []
        return self.prefix_cache.hot_prefixes(max_paths, min_hits)

    def export_prefix(self, tokens: Sequence[int]):
        """Opaque replication payload for the resident full-block prefix
        of ``tokens`` (None when nothing is cached).  Side-effect free.
        On a real engine the payload carries gathered pool tensors; the
        simulator ships bookkeeping only."""
        exp = getattr(self.executor, "export_prefix_blocks", None)
        if exp is not None:
            return exp(tokens)
        pc = self.prefix_cache
        if pc is None:
            return None
        n = len(tokens) // pc.block_size
        path = pc.tree.match(tokens, n, touch=False)
        if not path:
            return None
        return {"paged_blocks": None, "n_blocks": len(path),
                "tokens": list(tokens[:len(path) * pc.block_size]),
                "kv_format": "sim"}

    def replicate_in(self, state) -> int:
        """Land a replicated prefix payload into the local cache.
        Returns blocks newly admitted (0 when already resident or no
        free room — replicas never evict local content)."""
        imp = getattr(self.executor, "import_prefix_blocks", None)
        if imp is not None:
            landed = imp(state)
        else:
            pc = self.prefix_cache
            if pc is None:
                return 0
            res = pc.admit_replica(state["tokens"], state["n_blocks"])
            landed = 0 if res is None else len(res[1]) - res[0]
        self.replicas_in += landed
        return landed
