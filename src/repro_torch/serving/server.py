"""Online serving loop: continuous ingestion, streaming, adaptation.

``Cluster.run`` replays a pre-materialized request list and returns when
the heap drains — fine for goodput sweeps, useless for serving.
``ServingLoop`` drives the same event core *incrementally*:

* **open-loop ingestion** — arrivals come from an iterator (e.g.
  ``PhaseDriftSpec.iter_requests``) and are submitted one ahead of the
  event horizon, so the trace is never materialized and the workload can
  drift (or be generated live) while the loop runs;
* **streaming** — every emitted token fires per-request and global
  callbacks (``Instance.token_sink``), and each submitted request gets a
  ``RequestHandle`` future that resolves at finish/rejection;
* **telemetry** — token/finish/reject events feed a
  ``TelemetryWindow`` (windowed attainment, goodput, gauges), with
  periodic snapshots accumulated in a ``MetricsLog``;
* **adaptation** — an attached ``SliderController`` observes windowed
  headroom at epoch boundaries and retunes chunk sizes or stages
  drain-and-flip role changes through the cluster's migration machinery.

The loop is executor-agnostic: with ``SimExecutor`` it is a
deterministic virtual-clock simulation; with ``TorchExecutor`` the same
schedule computes real tokens (``--engine live``), optionally paced to
wall time by ``WallClock``.
"""
from __future__ import annotations

import dataclasses
import queue as _queue
import threading
from typing import Callable, Dict, Iterable, Iterator, List, Optional

from repro_torch.core.cluster import ARRIVAL, COMMIT, Cluster
from repro_torch.core.instance import (HEALTH_OK, HEALTH_QUARANTINED, Instance)
from repro_torch.core.latency import SLO, RunStats
from repro_torch.engine.request import Request, State
from repro_torch.frontend.admission import AdmissionConfig, AdmissionQueue
from repro_torch.serving.clock import VirtualClock, WallClock
from repro_torch.serving.faults import FaultInjector
from repro_torch.serving.metrics import MetricsLog, TelemetryWindow
from repro_torch.serving.tracing import (PH_ADMISSION, PH_QUEUE, TraceConfig,
                                   Tracer)

_DONE_STATES = (State.FINISHED, State.REJECTED, State.CANCELLED,
                State.FAILED)


@dataclasses.dataclass
class WatchdogConfig:
    """Stall/heartbeat detection and probation-based re-admission.

    ``heartbeat_timeout`` is EVENT time: an instance whose dispatched
    step runs this far past its cost-model deadline (``step_deadline``)
    is quarantined — injected stalls and real slowdowns both trip it.
    ``stall_timeout`` is WALL time (live executors only): a COMMIT whose
    ``PendingStep`` still isn't ready this long past the modeled end
    quarantines the instance instead of blocking the loop on
    ``resolve()``.  Quarantined instances re-admit after ``probation``
    seconds, doubling per repeat offense up to ``max_probation``."""
    heartbeat_timeout: float = 2.0
    stall_timeout: float = 2.0
    probation: float = 5.0
    probation_backoff: float = 2.0
    max_probation: float = 60.0
    check_every: float = 0.25


class RequestHandle:
    """Future for one submitted request: resolves when the request
    finishes (or is rejected/cancelled); streams tokens as they are
    emitted."""

    def __init__(self, req: Request,
                 on_token: Optional[Callable] = None):
        self.req = req
        self.tokens: List[tuple] = []        # (time, token_id | None)
        self._on_token = on_token
        #: resolve notification (network front-end: triggers the final
        #: response frames) — called exactly once, from the loop thread
        self.on_done: Optional[Callable[[Request], None]] = None
        self._resolved = False

    @property
    def done(self) -> bool:
        return self.req.state in _DONE_STATES

    @property
    def rejected(self) -> bool:
        return self.req.state == State.REJECTED

    @property
    def cancelled(self) -> bool:
        return self.req.state == State.CANCELLED

    @property
    def failed(self) -> bool:
        return self.req.state == State.FAILED

    def result(self) -> Request:
        if not self.done:
            raise RuntimeError(
                f"request {self.req.rid} still {self.req.state.value}; "
                "drive the loop further")
        return self.req

    def _emit(self, t: float, tok: Optional[int]):
        self.tokens.append((t, tok))
        if self._on_token is not None:
            self._on_token(self.req, t, tok)

    def _resolve(self):
        if not self._resolved:
            self._resolved = True
            if self.on_done is not None:
                self.on_done(self.req)


@dataclasses.dataclass
class SubmitMsg:
    """One externally-submitted request crossing the thread boundary
    into the loop (the HTTP gateway produces these).  ``receipt`` is
    the wall/clock time the connection actually delivered the request
    — arrival truth for TTFT and queue-wait accounting."""
    req: Request
    priority: Optional[str] = None
    receipt: Optional[float] = None
    on_token: Optional[Callable] = None
    reply: Optional[Callable[["RequestHandle"], None]] = None


@dataclasses.dataclass
class AbortMsg:
    """Client-disconnect propagation: the gateway enqueues one of these
    when an SSE connection drops; the loop aborts the request in the
    engine and frees its blocks.  A no-op if the request already
    resolved (normal completion also closes the connection)."""
    rid: int


class ServingLoop:
    def __init__(self, cluster: Cluster, slo: SLO,
                 arrivals: Optional[Iterable[Request]] = None,
                 clock: Optional[VirtualClock] = None,
                 controller=None, window: float = 10.0,
                 on_token: Optional[Callable] = None,
                 snapshot_every: Optional[float] = None,
                 pace: bool = False, steal: bool = True,
                 admission: Optional[AdmissionConfig] = None,
                 watchdog: Optional[WatchdogConfig] = None,
                 faults: Optional[FaultInjector] = None,
                 tracing: Optional[TraceConfig] = None):
        self.cluster = cluster
        self.slo = slo
        self.clock = clock or VirtualClock()
        self.telemetry = TelemetryWindow(slo, window=window)
        # rates divide by seconds OBSERVED: the loop's start time is the
        # window's origin (0.0 in simulation — unchanged spans there; a
        # wall clock that starts mid-epoch no longer inflates the
        # denominator of its first snapshots)
        self.telemetry.anchor(cluster.now)
        self.log = MetricsLog()
        self.controller = controller
        self._arrivals: Optional[Iterator[Request]] = (
            iter(arrivals) if arrivals is not None else None)
        self._handles: Dict[int, RequestHandle] = {}
        self._streamed: Dict[int, int] = {}   # rid -> tokens streamed
        self.requests: List[Request] = []     # every request ever seen
        self._global_on_token = on_token
        self._snapshot_every = snapshot_every
        self._next_snapshot = snapshot_every
        self._pace = pace
        self._steal = steal
        # router-side admission queue (None = legacy immediate routing)
        self.admission: Optional[AdmissionQueue] = (
            AdmissionQueue(admission) if admission is not None else None)
        self._released: set = set()     # rids admitted past the queue
        self._inflight = 0
        self.shed_rejections = 0
        self.cancelled_count = 0
        # serving-mode ingress: externally-submitted requests cross the
        # thread boundary here (created lazily by ``serve``/``ingress``)
        self._ingress: Optional[_queue.Queue] = None
        self._serving = False
        self._refusing = False       # graceful drain: cancel stragglers
        # fault tolerance: watchdog (stall/heartbeat detection +
        # probation re-admission) and optional fault injection
        self.watchdog = watchdog
        self._next_watchdog = 0.0
        self._probation_until: Dict[int, float] = {}
        self._strikes: Dict[int, int] = {}
        self.aborted_count = 0
        self.failed_count = 0
        # request-lifecycle tracing (off by default: every call site
        # guards on ``tracer is None``, so an untraced run takes the
        # exact pre-tracing path)
        if tracing is None:
            self.tracer: Optional[Tracer] = None
        else:
            self.tracer = (tracing if isinstance(tracing, Tracer)
                           else Tracer(tracing))
            cluster.tracer = self.tracer
            for inst in cluster.instances:
                inst.tracer = self.tracer
        for inst in cluster.instances:
            inst.token_sink = self._token_sink
        cluster.on_finish = self._on_finish
        cluster.on_reject = self._on_reject
        cluster.on_failed = self._on_failed
        cluster.on_abort = self._on_abort
        if faults is not None:
            cluster.attach_faults(faults)
        if controller is not None:
            controller.bind(self)

    # ------------------------------------------------------------------
    # ingestion
    # ------------------------------------------------------------------
    def submit(self, req: Request,
               on_token: Optional[Callable] = None,
               priority: Optional[str] = None,
               receipt: Optional[float] = None) -> RequestHandle:
        """Submit one request (external callers; the arrival iterator
        and the network ingress feed through here too).  Returns its
        streaming future.

        Arrival stamping: a ``receipt`` (actual connection-receipt
        time, or the workload generator's intended arrival) is
        PRESERVED as ``req.arrival`` even when the loop is running
        behind — the heap event is clamped to now so events never land
        behind the clock, but TTFT and queue-wait measure from when
        the request really arrived, not from when the loop got around
        to drawing it.  Without a receipt (bare external submission,
        arrival defaulting to 0.0) the request arrives NOW."""
        if receipt is not None:
            req.arrival = receipt
        else:
            req.arrival = max(req.arrival, self.cluster.now)
        if priority is not None:
            req.priority = priority
        handle = RequestHandle(req, on_token)
        self._handles[req.rid] = handle
        self.requests.append(req)
        if self.tracer is not None:
            self.tracer.begin(req, req.arrival,
                              PH_ADMISSION if self.admission is not None
                              else PH_QUEUE)
        if self.admission is not None:
            self._enqueue_admission(req, priority)
        else:
            self.cluster.submit(req, t=max(req.arrival, self.cluster.now))
        return handle

    def _pump_arrival(self) -> bool:
        """Keep exactly one not-yet-processed arrival in the event heap
        (arrivals are nondecreasing in time, so one look-ahead preserves
        event order while staying incremental)."""
        if self._arrivals is None:
            return False
        req = next(self._arrivals, None)
        if req is None:
            self._arrivals = None
            return False
        # the generator's timestamp is the arrival truth — the pump's
        # draw time must not rewrite it (wall-clock pacing: a loop
        # running behind draws bursts late, and clamping arrivals to
        # the draw would silently shrink measured queue wait and TTFT)
        self.submit(req, receipt=req.arrival)
        return True

    # ------------------------------------------------------------------
    # router-side admission queue
    # ------------------------------------------------------------------
    def _enqueue_admission(self, req: Request, priority: Optional[str]):
        q = self.admission
        ok, displaced = q.push(req, q.resolve_class(priority),
                               max(req.arrival, self.cluster.now))
        for entry in displaced:
            self._finish_unserved(entry.req, State.REJECTED)
        if not ok:
            self._finish_unserved(req, State.REJECTED)
        self._release_admission()

    def _release_admission(self):
        """Move queued work into the cluster while the released
        population is under the in-flight cap — the admission queue
        absorbs the burst, the instance queues stay near their
        sustainable depth."""
        q = self.admission
        if q is None:
            return
        now = self.cluster.now
        while len(q) and self._inflight < q.cfg.max_inflight:
            entry = q.pop(now)
            if entry is None:
                # every queued class is over its token budget for the
                # current window — nothing releasable this tick
                break
            self._inflight += 1
            self._released.add(entry.req.rid)
            self.telemetry.on_queue_wait(
                now, max(now - entry.enq_time, 0.0))
            if self.tracer is not None:
                self.tracer.phase(entry.req.rid, now, PH_QUEUE,
                                  cls=entry.cls)
            self.cluster.submit(entry.req,
                                t=max(entry.req.arrival, now))

    def _finish_unserved(self, req: Request, state: State):
        """Resolve a request that will never reach the cluster
        (displaced/shed -> REJECTED, drained at shutdown ->
        CANCELLED)."""
        now = self.cluster.now
        req.state = state
        req.finish_time = now
        if state == State.REJECTED:
            self.shed_rejections += 1
            self.telemetry.on_reject(req, now)
        else:
            self.cancelled_count += 1
            self.telemetry.on_cancel(req, now)
        if self.tracer is not None:
            self.tracer.finish(req, now)
        handle = self._handles.get(req.rid)
        if handle is not None:
            handle._resolve()

    def shed_admission(self, fraction: Optional[float] = None) -> int:
        """Admission control as an actuator (SliderController, both
        dimensions starved): early-reject queued work from the lowest
        priority classes up.  Returns how many were shed."""
        if self.admission is None:
            return 0
        entries = self.admission.shed(fraction)
        for e in entries:
            self._finish_unserved(e.req, State.REJECTED)
        if entries:
            self.log.record_event(self.cluster.now, "shed", {
                "count": len(entries),
                "classes": sorted({e.cls for e in entries})})
            if self.tracer is not None:
                self.tracer.global_event(self.cluster.now, "shed",
                                         count=len(entries))
        return len(entries)

    def cancel_queued(self) -> int:
        """Graceful drain: everything still in the admission queue
        resolves CANCELLED (in-flight work keeps running to
        completion)."""
        if self.admission is None:
            return 0
        entries = self.admission.drain()
        for e in entries:
            self._finish_unserved(e.req, State.CANCELLED)
        return len(entries)

    # ------------------------------------------------------------------
    # serving-mode ingress (thread boundary to the network front-end)
    # ------------------------------------------------------------------
    @property
    def ingress(self) -> _queue.Queue:
        """Thread-safe submission queue for ``SubmitMsg`` items; the
        loop drains it every cycle while ``serve`` runs."""
        if self._ingress is None:
            self._ingress = _queue.Queue()
        return self._ingress

    def receipt_now(self) -> float:
        """Arrival stamp for an externally-received request: wall time
        under a ``WallClock`` (the connection's actual receipt), the
        event clock otherwise."""
        if isinstance(self.clock, WallClock):
            return self.clock.now
        return self.cluster.now

    def _ingress_pending(self) -> bool:
        return self._ingress is not None and not self._ingress.empty()

    def _submit_msg(self, msg: SubmitMsg):
        if self._refusing:
            # graceful drain already began: never start new work
            handle = RequestHandle(msg.req, msg.on_token)
            self._handles[msg.req.rid] = handle
            self.requests.append(msg.req)
            self._finish_unserved(msg.req, State.CANCELLED)
            if msg.reply is not None:
                msg.reply(handle)
            return
        handle = self.submit(msg.req, on_token=msg.on_token,
                             priority=msg.priority, receipt=msg.receipt)
        if msg.reply is not None:
            msg.reply(handle)

    def _ingress_msg(self, msg):
        if isinstance(msg, AbortMsg):
            self.abort(msg.rid)
        else:
            self._submit_msg(msg)

    def _drain_ingress(self):
        if self._ingress is None:
            return
        while True:
            try:
                msg = self._ingress.get_nowait()
            except _queue.Empty:
                return
            self._ingress_msg(msg)

    # ------------------------------------------------------------------
    # event plumbing
    # ------------------------------------------------------------------
    def _token_sink(self, req: Request, t: float):
        self.telemetry.on_token(req, t)
        handle = self._handles.get(req.rid)
        # this event's token is the request's next one not yet streamed: a
        # K-step horizon appends its K tokens before its K events fire, so
        # the last token would stand for all of them (the reference reads
        # ``output_tokens[-1]`` here)
        i = self._streamed.get(req.rid, 0)
        self._streamed[req.rid] = i + 1
        tok = req.output_tokens[i] if i < len(req.output_tokens) else None
        if handle is not None:
            handle._emit(t, tok)
        if self._global_on_token is not None:
            self._global_on_token(req, t, tok)

    def _on_finish(self, req: Request, t: float):
        self.telemetry.on_finish(req, t)
        self._retire(req)

    def _on_reject(self, req: Request, t: float):
        self.telemetry.on_reject(req, t)
        self._retire(req)

    def _on_failed(self, req: Request, t: float):
        self.telemetry.on_failed(req, t)
        self.failed_count += 1
        self._retire(req)

    def _on_abort(self, req: Request, t: float):
        self.telemetry.on_abort(req, t)
        self.aborted_count += 1
        self._retire(req)

    # ------------------------------------------------------------------
    # client-initiated abort (disconnect propagation)
    # ------------------------------------------------------------------
    def abort(self, rid: int) -> bool:
        """Abort one submitted request: pulled straight out of the
        admission queue if unreleased, otherwise handed to the cluster's
        safe-boundary abort machinery (it frees KV blocks the moment the
        request is not mid-flight).  Idempotent; True once the request
        is terminally resolved or the abort is staged."""
        handle = self._handles.get(rid)
        if handle is None:
            return False
        req = handle.req
        if req.state in _DONE_STATES:
            return True
        if self.admission is not None and rid not in self._released:
            entry = self.admission.remove(rid)
            if entry is not None:
                now = self.cluster.now
                req.state = State.CANCELLED
                req.finish_reason = "abort"
                req.finish_time = now
                self.aborted_count += 1
                self.telemetry.on_abort(req, now)
                if self.tracer is not None:
                    self.tracer.finish(req, now)
                handle._resolve()
                return True
        return self.cluster.abort_request(req)

    def _retire(self, req: Request):
        """A released request left the system: free its admission slot
        (pulling the next queued request in) and resolve its handle."""
        if self.tracer is not None:
            self.tracer.finish(req, req.finish_time
                               if req.finish_time is not None
                               else self.cluster.now)
        if req.rid in self._released:
            self._released.discard(req.rid)
            self._inflight -= 1
            self._release_admission()
        handle = self._handles.get(req.rid)
        if handle is not None:
            handle._resolve()

    # ------------------------------------------------------------------
    # control surface (used by SliderController; callable directly)
    # ------------------------------------------------------------------
    def flip_role(self, inst: Instance, itype: str,
                  chunk_size: int) -> bool:
        staged = self.cluster.request_role_flip(inst, itype, chunk_size)
        if staged:
            self.log.record_event(self.cluster.now, "role_flip", {
                "iid": inst.iid, "to": itype, "chunk": chunk_size})
        return staged

    def set_chunks(self, itype: str, chunk_size: int) -> int:
        """Retune the chunk-size slider for every ``itype`` instance
        (instantaneous — chunk size is a per-iteration budget, so no
        drain is needed).  Returns how many instances changed."""
        n = 0
        for inst in self.cluster.instances:
            if inst.itype == itype and not inst.draining \
                    and inst.chunk_size != chunk_size:
                inst.chunk_size = chunk_size
                n += 1
                if chunk_size <= 0 and inst.prefill_queue:
                    # a pure-decode instance can never drain its prefill
                    # queue — hand the queued (not-yet-admitted) work
                    # back to the router with full ARRIVAL semantics
                    # (early rejection included)
                    requeue = [r for r in inst.prefill_queue
                               if not inst.allocator.holds(r.rid)]
                    for r in requeue:
                        inst.prefill_queue.remove(r)
                        self.cluster.reroute(r)
        if n:
            self.log.record_event(self.cluster.now, "set_chunk", {
                "itype": itype, "chunk": chunk_size, "instances": n})
        return n

    # ------------------------------------------------------------------
    # watchdog: stall/heartbeat detection + probation re-admission
    # ------------------------------------------------------------------
    def _start_probation(self, inst: Instance, now: float) -> float:
        """Schedule the quarantined instance's re-admission, doubling
        the probation per repeat offense up to the cap."""
        wd = self.watchdog
        strikes = self._strikes.get(inst.iid, 0)
        self._strikes[inst.iid] = strikes + 1
        probation = min(wd.probation * wd.probation_backoff ** strikes,
                        wd.max_probation)
        until = now + probation
        self._probation_until[inst.iid] = until
        return probation

    def _quarantine(self, inst: Instance, now: float, why: str):
        self.cluster.quarantine_instance(inst, now, reason=why)
        probation = self._start_probation(inst, now)
        self.log.record_event(now, "quarantine", {
            "iid": inst.iid, "why": why,
            "probation_s": round(probation, 3)})

    def _watchdog_check(self, now: float):
        """Periodic health sweep: quarantine instances whose dispatched
        step ran past its cost-model deadline by ``heartbeat_timeout``
        (missed heartbeat — stalls and slowdowns), and re-admit
        quarantined instances whose probation has elapsed.  Instances
        the CLUSTER quarantined on its own (executor exceptions) get a
        probation clock here too — the watchdog owns all re-admission."""
        wd = self.watchdog
        if wd is None or now < self._next_watchdog:
            return
        self._next_watchdog = now + wd.check_every
        for inst in self.cluster.instances:
            if inst.health == HEALTH_OK:
                if now > inst.step_deadline + wd.heartbeat_timeout:
                    self._quarantine(inst, now, "heartbeat")
                elif inst.overrun > wd.heartbeat_timeout:
                    # sync-executor heartbeat: dispatch+commit happen in
                    # one atomic event, so a stall never leaves a live
                    # step_deadline behind for the sweep above to catch.
                    # The instance records how far each dispatch ran
                    # past its cost-model duration; an overrun past the
                    # timeout is the same missed heartbeat, observed
                    # after the fact.
                    inst.overrun = 0.0
                    self._quarantine(inst, now, "overrun")
            elif inst.health == HEALTH_QUARANTINED:
                until = self._probation_until.get(inst.iid)
                if until is None:          # cluster-initiated quarantine
                    until = now + self._start_probation(inst, now)
                if now >= until and self.cluster.recover_instance(inst,
                                                                  now):
                    self._probation_until.pop(inst.iid, None)
                    self.log.record_event(now, "readmit",
                                          {"iid": inst.iid})
                    if self.tracer is not None:
                        self.tracer.global_event(now, "readmit",
                                                 iid=inst.iid)

    def _stall_check(self) -> bool:
        """Live-path stall guard: when the next event is a COMMIT whose
        async step STILL is not device-ready ``stall_timeout`` wall
        seconds past its modeled end, quarantine the instance instead of
        letting ``PendingStep.resolve`` block the loop forever.  Returns
        True when it intervened (the caller re-peeks: the COMMIT is now
        stale and the evacuated work has been rerouted)."""
        wd = self.watchdog
        if wd is None or not isinstance(self.clock, WallClock):
            return False
        ev = self.cluster.peek_event()
        if ev is None or ev[1] != COMMIT:
            return False
        inst = self.cluster._inst_by_id[ev[2]]
        pending = inst.pending_step()
        if pending is None or pending.ready():
            return False
        if self.clock.now < inst.step_deadline + wd.stall_timeout:
            return False
        self._quarantine(inst, self.cluster.now, "stall")
        return True

    def _steal_prefill(self):
        """Online-runtime load repair: an idle prefill-capable instance
        pulls queued-but-unadmitted prefill work from the deepest peer
        queue.  Routing decisions pile up behind a slow configuration
        (e.g. the queue an instance accumulated before a slider move);
        stealing lets spare capacity drain the backlog instead of
        leaving it pinned to the original placement."""
        insts = [i for i in self.cluster.instances if i.schedulable]
        if len(insts) < 2:
            return
        idle = [i for i in insts
                if i.chunk_size > 0 and not i.prefill_queue
                and not i.decoding and not i.pending_decode]
        if not idle:
            return
        # one queue-depth scan per call, not per thief — this runs after
        # every event, so it must be cheap when there is nothing to do
        depths = {i.iid: i.queued_prefill_tokens() for i in insts}
        for thief in idle:
            victim = max(insts, key=lambda i: depths[i.iid])
            if depths[victim.iid] == 0 or len(victim.prefill_queue) < 2:
                return                 # no queue anywhere worth raiding
            # steal from the tail: the head may be mid-chunk/admitted
            req = victim.prefill_queue[-1]
            if victim.allocator.holds(req.rid):
                continue
            victim.prefill_queue.pop()
            depths[victim.iid] -= req.prefill_remaining
            depths[thief.iid] = req.prefill_remaining
            thief.enqueue_prefill(req)
            self.cluster._schedule_iter(thief, self.cluster.now)

    # ------------------------------------------------------------------
    # pacing: wait on either the next event OR horizon completion
    # ------------------------------------------------------------------
    #: wall-clock slice between pipeline-readiness polls while pacing
    PACE_SLICE = 0.005

    def _pending_steps(self):
        """Unresolved async executor steps currently in flight."""
        return [p for inst in self.cluster.instances
                if (p := inst.pending_step()) is not None]

    def _prefetch_ready(self, pending) -> None:
        for p in pending:
            if not p.resolved and p.ready():
                p.prefetch()

    def _pace_until(self, t: float) -> bool:
        """Sleep to the next event time WITHOUT serializing ingestion
        behind compute: instead of one dead sleep, the gap is sliced and
        each slice polls the in-flight executor steps — the moment a
        horizon's device work completes, its results are prefetched to
        the host, so the commit event at ``t`` never blocks.  The wait
        ends on whichever comes first: the next scheduled event
        (arrival/commit/transfer), in-flight work becoming consumable,
        or a NEW network ingress submission (which may schedule an
        earlier arrival than ``t`` — the caller must re-peek).  Returns
        False when preempted by ingress, True when ``t`` was reached."""
        pending = self._pending_steps()
        slice_wait = isinstance(self.clock, WallClock) \
            and (pending or self._ingress is not None)
        if not slice_wait:
            # virtual time (or nothing that could preempt): plain jump —
            # but still harvest anything that already landed
            self._prefetch_ready(pending)
            self.clock.sleep_until(t)
            return True
        while True:
            self._prefetch_ready(pending)
            if self._ingress_pending():
                return False
            now = self.clock.now
            if now >= t:
                return True
            self.clock.sleep_until(min(t, now + self.PACE_SLICE))

    # ------------------------------------------------------------------
    # the loop
    # ------------------------------------------------------------------
    def run(self, until: Optional[float] = None,
            max_steps: Optional[int] = None) -> int:
        """Drive events until the system drains (arrivals exhausted and
        all work finished), ``until`` virtual seconds, or ``max_steps``
        events.  Returns the number of events processed; re-entrant —
        call again to continue."""
        steps = 0
        if self._arrivals is not None and not self.requests:
            self._pump_arrival()
        while max_steps is None or steps < max_steps:
            self._drain_ingress()
            self._watchdog_check(self.cluster.now)
            t = self.cluster.peek_time()
            if t is None:
                if not self._pump_arrival():
                    break
                continue
            if until is not None and t > until:
                break
            if self._pace and not self._pace_until(t):
                continue              # ingress preempted: re-peek
            if self._stall_check():
                continue              # quarantined a stalled step: re-peek
            stepped = self.cluster.step()
            if stepped is None:
                continue
            steps += 1
            _, kind, _ = stepped
            if kind == ARRIVAL:
                self._pump_arrival()
            elif self._steal:
                self._steal_prefill()
            now = self.cluster.now
            if self.controller is not None:
                self.controller.maybe_epoch(now)
            if self._snapshot_every is not None \
                    and now >= self._next_snapshot:
                self.log.record(self.snapshot(now))
                self._next_snapshot = (
                    now - now % self._snapshot_every + self._snapshot_every)
        return steps

    def snapshot(self, now: Optional[float] = None) -> dict:
        now = self.cluster.now if now is None else now
        snap = self.telemetry.snapshot(now, self.cluster.instances,
                                       admission=self.admission)
        # fault section only when something actually fired — a faults-off
        # run snapshots bit-identically to one without this layer at all
        fc = self.cluster.fault_counters()
        if any(fc.values()):
            snap["faults"] = fc
        if getattr(self.cluster, "recovery", None) is not None:
            snap["recovery"] = self.cluster.recovery_counters()
        return snap

    # ------------------------------------------------------------------
    # serving mode: run until told to stop, blocking on ingress when
    # idle (the network front-end drives this on a dedicated thread)
    # ------------------------------------------------------------------
    #: events per ``run`` slice in serving mode — small enough that a
    #: stop request is noticed promptly even mid-burst
    SERVE_SLICE = 256

    def serve(self, stop: threading.Event, idle_poll: float = 0.02):
        """Drive events indefinitely: drain the ingress every cycle,
        block briefly for new submissions when no work is pending, and
        on ``stop`` perform a graceful drain — stop ingesting (late
        stragglers resolve CANCELLED), resolve everything still queued
        in the admission queue as CANCELLED, and run the in-flight
        population to completion."""
        self._serving = True
        ingress = self.ingress          # materialize before clients race
        try:
            while not stop.is_set():
                self.run(max_steps=self.SERVE_SLICE)
                if self.cluster.peek_time() is None \
                        and not self._ingress_pending():
                    try:                # idle: wait for the next client
                        self._ingress_msg(ingress.get(timeout=idle_poll))
                    except _queue.Empty:
                        pass
            self._refusing = True
            self._drain_ingress()
            self.cancel_queued()
            self.run()                  # in-flight work finishes, SSE
        finally:                        # streams flush through on_token
            self._serving = False

    # ------------------------------------------------------------------
    def stats(self, qps: float) -> RunStats:
        moves = (self.controller.n_moves if self.controller is not None
                 else 0)
        st = self.cluster.stats(self.requests, self.slo, qps)
        st.slider_moves = moves
        st.early_rejections += self.shed_rejections
        return st
