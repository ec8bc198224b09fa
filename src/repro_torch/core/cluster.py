"""Cluster orchestration: a discrete-event loop shared by the simulator
(SimExecutor + estimator time) and the real engine (JaxExecutor + the
same estimator time base, so scheduling behaves identically while tokens
are computed for real).

Events: ARRIVAL (proxy routes prefill), ITER (an instance executes one
mixed batch), TRANSFER (a KV/state migration lands).  Migration latency
is charged via CostModel.transfer_time — asynchronous, off the critical
path, as in the paper's vLLM implementation (§3.5).

The loop is INCREMENTAL: ``submit`` enqueues an arrival, ``step``
processes exactly one event, and ``peek_time`` exposes the next event
time — the online serving runtime (``repro.serving``) drives these
directly, ingesting open-loop arrivals as they occur instead of a
pre-materialized list.  ``run`` is the batch convenience wrapper the
simulator and benchmarks use.

Role reconfiguration (drain-and-flip): ``request_role_flip`` stages a
P-heavy<->D-heavy flip on an instance; its decode population is migrated
away through the ordinary TRANSFER machinery (no in-flight request
dropped) and the flip lands once the decode side is empty.

Async execution (``async_exec=True``): each ITER splits into a DISPATCH
(the instance hands the plan to its executor's non-blocking
``step_async`` and the cluster schedules a COMMIT at the modeled end
time) and a COMMIT (the single host readback, bookkeeping, then —
before the host spends time streaming the tokens — the NEXT iteration
is dispatched inline, so the device computes horizon N+1 while the host
consumes horizon N).  Migrations, drains, and flips all run in an
instance's commit phase, i.e. with its pipeline flushed — an eject can
never observe a half-applied horizon.

Fault tolerance: ``fail_instance`` (crash, total HBM/KV loss) and
``quarantine_instance`` (suspected-bad, memory kept) evacuate every
resident request through the preemption-by-recompute path and re-route
it via the proxy; dead/quarantined instances are excluded from
placement and migration destinations exactly like draining ones.
TRANSFER landings verify a content hash and retry with capped
exponential backoff, falling back to recompute when retries exhaust.
An attached ``FaultInjector`` (``attach_faults``) fires scheduled
crash/stall/exec-error faults as first-class FAULT events.  With no
injector attached and no faults raised, every path below is inert —
behavior is bit-identical to the fault-free cluster.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import Callable, Dict, List, Optional, Sequence

from repro_torch.core.estimator import CostModel
from repro_torch.core.instance import (D_HEAVY, HEALTH_DEAD, HEALTH_OK,
                                 HEALTH_QUARANTINED, Instance)
from repro_torch.core.latency import SLO, RunStats
from repro_torch.core.policies import BasePolicy
from repro_torch.engine.request import Request, State, TERMINAL_STATES
from repro_torch.serving import faults as flt
from repro_torch.serving.recovery import RecoveryConfig, RecoveryManager
from repro_torch.serving.tracing import (PH_DECODE_WAIT, PH_QUEUE, PH_TRANSFER,
                                   Tracer)

ARRIVAL, ITER, TRANSFER, COMMIT, FAULT = 0, 1, 2, 3, 4


@dataclasses.dataclass
class FaultToleranceConfig:
    """Recovery behavior knobs.  The defaults recover; ``fail_stop()``
    is the ablation baseline where faults terminally fail their
    victims (what the chaos bench compares against)."""
    evacuate: bool = True            # crash/quarantine victims re-route
    transfer_max_retries: int = 3    # re-sends before giving up
    transfer_backoff: float = 0.05   # base delay, doubles per attempt
    transfer_backoff_cap: float = 0.8
    recompute_fallback: bool = True  # exhausted transfer -> re-prefill
    verify_transfers: bool = True    # content-hash check at landing
    max_recoveries: int = 5          # per-request bound -> FAILED

    @classmethod
    def fail_stop(cls) -> "FaultToleranceConfig":
        return cls(evacuate=False, transfer_max_retries=0,
                   recompute_fallback=False)


class Cluster:
    #: class-level fallback so partially-constructed clusters (tests
    #: stubbing via ``__new__``) still see default recovery knobs
    ft: FaultToleranceConfig = FaultToleranceConfig()
    faults: Optional[flt.FaultInjector] = None
    #: request-lifecycle tracer (wired by ``ServingLoop(tracing=...)``;
    #: None = every tracing site below is inert)
    tracer: Optional[Tracer] = None
    #: warm-recovery manager (checkpoints + post-crash re-replication);
    #: None = every recovery site below is inert
    recovery: Optional[RecoveryManager] = None

    def __init__(self, policy: BasePolicy, cost: CostModel,
                 async_exec: bool = False,
                 ft: Optional[FaultToleranceConfig] = None,
                 recovery=None):
        self.async_exec = async_exec
        self.policy = policy
        self.cost = cost
        self.instances = policy.instances
        self._heap: list = []
        self._seq = itertools.count()
        self._inst_by_id = {i.iid: i for i in self.instances}
        self._iter_scheduled: Dict[int, bool] = {
            i.iid: False for i in self.instances}
        self.now = 0.0
        self.transfer_count = 0
        self.transfer_bytes = 0
        self.replication_count = 0
        self.replication_bytes = 0
        self.backflow_count = 0
        self.degrade_count = 0
        self.drain_count = 0
        # observer hooks for the online serving loop (None in batch mode)
        self.on_finish: Optional[Callable[[Request, float], None]] = None
        self.on_reject: Optional[Callable[[Request, float], None]] = None
        self.on_failed: Optional[Callable[[Request, float], None]] = None
        self.on_abort: Optional[Callable[[Request, float], None]] = None
        # fault tolerance
        self.ft = ft or FaultToleranceConfig()
        self.faults: Optional[flt.FaultInjector] = None
        # warm recovery: accept a RecoveryConfig or a prebuilt manager;
        # a disabled config leaves the attribute None so every hook
        # below short-circuits (bit-identical to recovery-less runs)
        if isinstance(recovery, RecoveryConfig):
            recovery = RecoveryManager(recovery) if recovery.enable \
                else None
        self.recovery: Optional[RecoveryManager] = recovery
        self._aborting: Dict[int, Request] = {}
        self.instance_failures = 0
        self.instance_recoveries = 0
        self.quarantines = 0
        self.evacuated_requests = 0
        self.transfer_retries = 0
        self.transfer_corruptions = 0
        self.transfer_recomputes = 0
        self.exec_errors = 0
        self.failed_count = 0
        self.aborted_count = 0
        self.last_exec_error: Optional[str] = None

    # ------------------------------------------------------------------
    def _push(self, t: float, kind: int, data):
        heapq.heappush(self._heap, (t, next(self._seq), kind, data))

    def _schedule_iter(self, inst: Instance, t: float):
        if inst.health != HEALTH_OK:
            return
        if not self._iter_scheduled[inst.iid]:
            self._iter_scheduled[inst.iid] = True
            self._push(max(t, inst.busy_until), ITER, inst.iid)

    def _start_transfer(self, req: Request, src: Instance, dst: Instance,
                        now: float, kind: str):
        """kind: 'place' (prefill->decode), 'degrade', 'backflow', or
        'drain' (decode evacuation ahead of a role flip)."""
        # prefix-aware migration: when the destination already caches a
        # prefix of the request's prompt, only the non-shared suffix
        # ships (the landed state aliases the cached blocks)
        shared = dst.peek_migration_prefix(req)
        state = src.eject(req)
        req.state = State.MIGRATING
        req.n_migrations += 1
        moved = max(req.context_len - shared, 0)
        t = self.cost.transfer_time(moved)
        if self.tracer is not None:
            self.tracer.phase(req.rid, now, PH_TRANSFER, kind=kind,
                              src=src.iid, dst=dst.iid, tokens=moved)
        self.transfer_count += 1
        self.transfer_bytes += self.cost.state_bytes(moved)
        checksum = (flt.payload_checksum(state)
                    if self.ft.verify_transfers else None)
        self._push(now + t, TRANSFER,
                   (req, dst, state, kind,
                    {"attempt": 0, "checksum": checksum, "delay": t}))

    def replicate_prefix(self, src: Instance, dst: Instance,
                         tokens, now: Optional[float] = None) -> bool:
        """Ship a hot cached prefix from ``src`` to ``dst`` through the
        ordinary TRANSFER machinery — block-granular, no request
        attached, charged at migration bandwidth but entirely off the
        critical path (the destination keeps serving while it lands)."""
        state = src.export_prefix(tokens)
        if state is None:
            return False
        now = self.now if now is None else now
        moved = state["n_blocks"] * src.prefix_cache.block_size
        t = self.cost.transfer_time(moved)
        self.replication_count += 1
        self.replication_bytes += self.cost.state_bytes(moved)
        self._push(now + t, TRANSFER,
                   (None, dst, state, "replicate",
                    {"attempt": 0, "checksum": None, "delay": t,
                     "src": src.iid}))
        return True

    # ------------------------------------------------------------------
    # incremental interface (driven by repro.serving.server)
    # ------------------------------------------------------------------
    def submit(self, req: Request, t: Optional[float] = None):
        """Enqueue one arrival.  Online ingestion: the serving loop calls
        this as requests show up; the batch ``run`` calls it up front."""
        self._push(req.arrival if t is None else t, ARRIVAL, req)

    def reroute(self, req: Request):
        """Route a queued-but-unadmitted request again NOW, with full
        ARRIVAL semantics (including early rejection and its observer
        hook) — used when its original placement loses the ability to
        serve it (e.g. the controller zeroes an instance's chunk)."""
        self._handle(self.now, ARRIVAL, req)

    def peek_time(self) -> Optional[float]:
        return self._heap[0][0] if self._heap else None

    def peek_event(self) -> Optional[tuple]:
        """Next event as ``(time, kind, data)`` without popping — the
        serving loop's wall-clock watchdog inspects an imminent COMMIT
        to decide whether its ``PendingStep`` is overdue."""
        if not self._heap:
            return None
        t, _, kind, data = self._heap[0]
        return t, kind, data

    def step(self) -> Optional[tuple]:
        """Pop and process exactly one event.  Returns ``(time, kind,
        data)`` for observability, or None when the heap is empty."""
        if not self._heap:
            return None
        now, _, kind, data = heapq.heappop(self._heap)
        self.now = max(self.now, now)
        self._handle(now, kind, data)
        if self._aborting:
            self._sweep_aborts(self.now)
        return now, kind, data

    def _handle(self, now: float, kind: int, data):
        if kind == ARRIVAL:
            self._handle_arrival(data, now)
        elif kind == TRANSFER:
            self._handle_transfer(data, now)
        elif kind == COMMIT:
            inst = self._inst_by_id[data]
            if not inst.has_inflight():
                # the in-flight iteration was discarded by a failure or
                # quarantine between dispatch and commit: stale event
                self._iter_scheduled[inst.iid] = False
                if inst.has_work():
                    self._schedule_iter(inst, now)
                return
            try:
                self._commit(inst, now)
            except Exception as e:         # device/readback failure
                self._on_exec_error(inst, now, e)
        elif kind == FAULT:
            self._handle_fault(data, now)
        else:  # ITER
            inst = self._inst_by_id[data]
            self._iter_scheduled[inst.iid] = False
            if inst.health != HEALTH_OK:
                return                     # stale event for a downed peer
            try:
                self._run_iter(inst, now)
            except Exception as e:         # executor-step failure
                self._on_exec_error(inst, now, e)

    def _handle_arrival(self, req: Request, now: float):
        if req.rid in self._aborting:      # client hung up before routing
            self._finish_abort(req, now)
            return
        inst = self.policy.on_arrival(req, now)
        if inst is not None:
            if self.tracer is not None:
                self.tracer.event(req.rid, now, "route", iid=inst.iid)
            self._schedule_iter(inst, now)
            return
        recovered = req.n_recoveries > 0 or req.first_token_time is not None
        capacity = any(i.schedulable and i.chunk_size > 0
                       for i in self.instances)
        if recovered and capacity:
            # a recovered request must not be early-rejected — the
            # client may already have streamed its tokens.  Force-place
            # on the least prefill-queued healthy instance.
            inst = min((i for i in self.instances
                        if i.schedulable and i.chunk_size > 0),
                       key=lambda i: i.queued_prefill_tokens())
            inst.enqueue_prefill(req)
            if self.tracer is not None:
                self.tracer.event(req.rid, now, "route", iid=inst.iid,
                                  forced=True)
            self._schedule_iter(inst, now)
            return
        if not capacity:
            self._fail_request(req, now, "no_capacity")
            return
        req.state = State.REJECTED         # early rejection
        req.finish_time = now
        if self.on_reject is not None:
            self.on_reject(req, now)

    def _handle_transfer(self, data, now: float):
        req, dst, state, move_kind, meta = data
        if move_kind == "replicate":
            # no request rides along: the payload lands straight into
            # the destination's cache tiers (best effort — a full pool
            # admits nothing rather than evicting, and a dropped or
            # corrupted replica simply never lands)
            if self._transfer_outcome() == flt.DELIVER \
                    and dst.health == HEALTH_OK:
                dst.replicate_in(state)
                if self.recovery is not None:
                    # replica-placement registry: a crashed holder's
                    # paths re-replicate immediately instead of waiting
                    # for the controller's next epoch
                    self.recovery.on_replica_landed(
                        state["tokens"], meta.get("src"), dst.iid)
            return
        if req.rid in self._aborting:      # client hung up mid-flight
            self._finish_abort(req, now)
            return
        if dst.health != HEALTH_OK:
            # destination died while the payload was on the wire: the
            # KV exists nowhere anymore — recompute elsewhere
            self._recover_by_recompute(req, now, "transfer_dst_down")
            return
        outcome = self._transfer_outcome()
        if outcome == flt.CORRUPT:
            self.transfer_corruptions += 1
            if self.ft.verify_transfers:
                self._retry_transfer(data, now)
                return
            # unverified corruption would decode garbage — model it as
            # a delivery (tokens diverge on a real wire; the sim has no
            # payload bits to flip) and let the counter tell the story
        elif outcome == flt.DROP:
            self._retry_transfer(data, now)
            return
        elif meta.get("checksum") is not None and self.ft.verify_transfers \
                and flt.payload_checksum(state) != meta["checksum"]:
            # real corruption (bit-flip in the payload itself)
            self.transfer_corruptions += 1
            self._retry_transfer(data, now)
            return
        dst.inject(req, state)
        if self.tracer is not None:
            self.tracer.phase(req.rid, now, PH_DECODE_WAIT,
                              iid=dst.iid, via=move_kind)
        if move_kind == "backflow":
            req.reset_tpot_window()
            self.backflow_count += 1
        elif move_kind == "degrade":
            self.degrade_count += 1
        elif move_kind == "drain":
            self.drain_count += 1
        self._schedule_iter(dst, now)

    def _run_iter(self, inst: Instance, now: float):
        if self.async_exec \
                and getattr(inst.executor, "step_async", None):
            self._dispatch(inst, now)
            return
        dur, prefill_done, finished = inst.run_iteration(now)
        end = now + dur
        if self.recovery is not None:
            for req in finished:
                self.recovery.drop(req.rid)
        if self.on_finish is not None:
            for req in finished:
                # a request EOSing mid-horizon finished at its last
                # token's per-step time, not the horizon end — same
                # timestamping as the async commit path
                self.on_finish(req, req.finish_time
                               if req.finish_time is not None else end)
        self._post_iteration(inst, end, dur, prefill_done)

    # ------------------------------------------------------------------
    # fault tolerance: injection, failure, recovery, abort
    # ------------------------------------------------------------------
    def attach_faults(self, injector: flt.FaultInjector):
        """Bind a fault injector: every scheduled fault becomes a FAULT
        event at its exact time; transfer landings consult the
        injector's drop/corrupt probabilities."""
        self.faults = injector
        for f in injector.schedule:
            self._push(f.t, FAULT, f)

    def _transfer_outcome(self) -> str:
        if self.faults is None:
            return flt.DELIVER
        return self.faults.transfer_outcome()

    def _handle_fault(self, fault: flt.Fault, now: float):
        inst = self._inst_by_id.get(fault.iid)
        if inst is None:
            return
        if self.faults is not None:
            self.faults.record(fault)
        if fault.kind == flt.CRASH:
            self.fail_instance(inst, now, reason="injected_crash")
        elif fault.kind == flt.STALL:
            inst.stall_until = max(inst.stall_until, now + fault.duration)
        elif fault.kind == flt.EXEC_ERROR:
            injector = self.faults or flt.FaultInjector()
            injector.arm_exec_error(inst)
        elif fault.kind == flt.RECOVER:
            self.recover_instance(inst, now)

    def fail_instance(self, inst: Instance, now: Optional[float] = None,
                      reason: str = "crash") -> List[Request]:
        """Instance crash: total HBM/KV loss (prefix cache and host
        spill tier included).  Every resident request is evacuated and
        re-routed through preemption-by-recompute (``ft.evacuate``) or
        terminally FAILED (fail-stop).  Returns the victims."""
        now = self.now if now is None else now
        if inst.health == HEALTH_DEAD:
            return []
        inst.health = HEALTH_DEAD
        inst.fail_count += 1
        self.instance_failures += 1
        victims = inst.evacuate()
        inst.wipe_cache()
        self.evacuated_requests += len(victims)
        if self.tracer is not None:
            self.tracer.global_event(now, "instance_crash", iid=inst.iid,
                                     reason=reason, victims=len(victims))
        self._reroute_victims(victims, now, reason)
        if self.recovery is not None:
            self.recovery.on_instance_failed(self, inst, now)
        return victims

    def quarantine_instance(self, inst: Instance,
                            now: Optional[float] = None,
                            reason: str = "stall") -> List[Request]:
        """Suspected-bad instance (watchdog / exec error): excluded from
        placement like a dead one, but its memory survives — the
        watchdog's probation timer (or an explicit ``recover_instance``)
        re-admits it.  Residents are still evacuated: a quarantined
        instance runs no iterations, so keeping them would stall them
        for the whole probation."""
        now = self.now if now is None else now
        if inst.health != HEALTH_OK:
            return []
        inst.health = HEALTH_QUARANTINED
        inst.quarantine_count += 1
        self.quarantines += 1
        victims = inst.evacuate()
        self.evacuated_requests += len(victims)
        if self.tracer is not None:
            self.tracer.global_event(now, "instance_quarantined",
                                     iid=inst.iid, reason=reason,
                                     victims=len(victims))
        self._reroute_victims(victims, now, reason)
        return victims

    def recover_instance(self, inst: Instance,
                         now: Optional[float] = None) -> bool:
        """Bring a dead/quarantined instance back into rotation."""
        now = self.now if now is None else now
        if inst.health == HEALTH_OK:
            return False
        inst.health = HEALTH_OK
        inst.stall_until = 0.0
        inst.overrun = 0.0
        inst.last_progress = now
        inst.step_deadline = float("inf")
        self.instance_recoveries += 1
        if inst.has_work():
            self._schedule_iter(inst, now)
        return True

    def _reroute_victims(self, victims: Sequence[Request], now: float,
                         reason: str):
        for req in victims:
            if req.state in TERMINAL_STATES:
                continue
            if req.rid in self._aborting:
                self._finish_abort(req, now)
                continue
            if self.ft.evacuate:
                self._recover_by_recompute(req, now, reason)
            else:
                self._fail_request(req, now, f"instance_{reason}")

    def _recover_by_recompute(self, req: Request, now: float, reason: str):
        """Preemption-by-recompute over the ARRIVAL path: the request
        re-prefills its whole context (prompt + generated so far) on a
        healthy instance, token-exact via ``recompute_offset``."""
        req.n_recoveries += 1
        if req.n_recoveries > self.ft.max_recoveries:
            self._fail_request(req, now, "too_many_recoveries")
            return
        if not self.ft.recompute_fallback and reason.startswith("transfer"):
            self._fail_request(req, now, "transfer_failed")
            return
        req.recompute_offset = req.output_len
        # warm recovery: resume from the latest checkpoint instead of
        # recomputing from token 0 (the admitting instance consumes the
        # plan and may still fall back cold if it cannot host it)
        rs = (self.recovery.plan_restore(req)
              if self.recovery is not None else None)
        if rs is not None:
            req.restore_state = rs
            req.prefill_pos = rs["pos"] - req.output_len
        else:
            req.prefill_pos = -req.output_len
        req.state = State.QUEUED
        if self.tracer is not None:
            ekw = {"reason": reason, "n": req.n_recoveries}
            pkw = {"reason": reason}
            if rs is not None:           # keys only appear when warm, so
                ekw.update(warm=True,    # recovery-off traces stay
                           resumed_from=rs["pos"])  # bit-identical
                pkw.update(recovery="warm")
            self.tracer.event(req.rid, now, "recovery", **ekw)
            self.tracer.phase(req.rid, now, PH_QUEUE, **pkw)
        self._handle(now, ARRIVAL, req)

    def _retry_transfer(self, data, now: float):
        """Dropped or corrupted TRANSFER: re-send with capped
        exponential backoff; on exhaustion fall back to recompute (the
        source already ejected the state — only the payload in the
        event survives, so a re-send re-pushes the same payload)."""
        req, dst, state, move_kind, meta = data
        attempt = meta.get("attempt", 0)
        if attempt < self.ft.transfer_max_retries:
            self.transfer_retries += 1
            if self.faults is not None:
                # seeded decorrelated jitter: concurrent transfers that
                # failed together must not retry in lockstep (a capped
                # pure exponential re-synchronizes the storm).  Only
                # reachable with an injector attached — faults-off runs
                # never retry, so they stay bit-identical.
                delay = self.faults.retry_jitter(
                    self.ft.transfer_backoff,
                    meta.get("backoff", self.ft.transfer_backoff),
                    self.ft.transfer_backoff_cap)
            else:
                delay = min(self.ft.transfer_backoff * (2 ** attempt),
                            self.ft.transfer_backoff_cap)
            if self.tracer is not None and req is not None:
                self.tracer.event(req.rid, now, "transfer_retry",
                                  attempt=attempt + 1,
                                  delay_s=round(delay, 6))
            self._push(now + delay, TRANSFER,
                       (req, dst, state, move_kind,
                        {**meta, "attempt": attempt + 1,
                         "backoff": delay}))
            return
        if req is None:
            return                          # replicas are best-effort
        self.transfer_recomputes += 1
        self._recover_by_recompute(req, now, "transfer_exhausted")

    def _fail_request(self, req: Request, now: float, reason: str):
        req.state = State.FAILED
        req.finish_reason = reason
        req.finish_time = now
        self.failed_count += 1
        self._aborting.pop(req.rid, None)
        if self.recovery is not None:
            self.recovery.drop(req.rid)
        if self.on_failed is not None:
            self.on_failed(req, now)

    def _on_exec_error(self, inst: Instance, now: float, exc: Exception):
        """An executor step raised (injected or real device failure):
        quarantine the instance — its pipeline state is suspect — and
        evacuate.  The watchdog's probation re-admits it later."""
        self.exec_errors += 1
        self.last_exec_error = repr(exc)
        self.quarantine_instance(inst, now, reason="exec_error")

    # ---- request abort (client disconnect) ----------------------------
    def abort_request(self, req: Request, now: Optional[float] = None
                      ) -> bool:
        """Terminally cancel ``req`` wherever it lives, freeing its
        blocks and executor rows.  Only safe boundaries are touched
        directly — a request inside an in-flight iteration or riding a
        TRANSFER is marked and collected at the next commit/landing.
        Returns True when the abort resolved immediately."""
        now = self.now if now is None else now
        if req.state in TERMINAL_STATES:
            return True
        self._aborting[req.rid] = req
        return self._try_abort(req, now)

    def _try_abort(self, req: Request, now: float) -> bool:
        if req.state == State.MIGRATING:
            return False                   # collected at TRANSFER landing
        for inst in self.instances:
            if inst.has_inflight():
                plan = inst._inflight[0]
                if req in plan.decode_reqs \
                        or any(r is req for r, _ in plan.prefill_items):
                    return False           # collected after the commit
        holder = None
        for inst in self.instances:
            if (req.rid in inst.decoding or req in inst.pending_decode
                    or req in inst.prefill_queue):
                holder = inst
                break
        if holder is not None:
            holder.abort_request(req)
        elif req.state == State.QUEUED:
            return False                   # still an ARRIVAL in the heap
        self._finish_abort(req, now)
        return True

    def _finish_abort(self, req: Request, now: float):
        self._aborting.pop(req.rid, None)
        if req.state in TERMINAL_STATES:
            return
        req.state = State.CANCELLED
        req.finish_reason = "abort"
        req.finish_time = now
        self.aborted_count += 1
        if self.recovery is not None:
            self.recovery.drop(req.rid)
        if self.on_abort is not None:
            self.on_abort(req, now)

    def _sweep_aborts(self, now: float):
        for rid, req in list(self._aborting.items()):
            if req.state in TERMINAL_STATES:
                self._aborting.pop(rid, None)
                continue
            self._try_abort(req, now)

    def fault_counters(self) -> Dict[str, int]:
        return {
            "instance_failures": self.instance_failures,
            "instance_recoveries": self.instance_recoveries,
            "quarantines": self.quarantines,
            "evacuated_requests": self.evacuated_requests,
            "transfer_retries": self.transfer_retries,
            "transfer_corruptions": self.transfer_corruptions,
            "transfer_recomputes": self.transfer_recomputes,
            "exec_errors": self.exec_errors,
            "failed": self.failed_count,
            "aborted": self.aborted_count,
        }

    def recovery_counters(self) -> dict:
        """Warm-recovery observability: manager counters plus the warm
        restore/fallback tallies summed over instances."""
        out = (self.recovery.counters()
               if self.recovery is not None else {})
        out["warm_restores"] = sum(
            i.warm_restores for i in self.instances)
        out["warm_restored_tokens"] = sum(
            i.warm_restored_tokens for i in self.instances)
        out["warm_fallbacks"] = sum(
            i.warm_fallbacks for i in self.instances)
        return out

    def _post_iteration(self, inst: Instance, end: float, dur: float,
                        prefill_done, reschedule: bool = True):
        """Scheduling phase shared by the synchronous ITER and the async
        COMMIT: route finished prefills, run Algorithm 1's migration
        selection, advance a staged drain, and (optionally) reschedule
        the instance."""
        if self.recovery is not None:
            # capture here: both ITER and COMMIT reach this point with
            # the executor pipeline flushed, so exported KV is coherent
            self.recovery.on_commit(self, inst, end)
        for req in prefill_done:
            target, needs_transfer = self.policy.on_prefill_done(
                req, inst, end)
            if needs_transfer:
                self._start_transfer(req, inst, target, end, "place")
            else:
                target.admit_decode(req)
                if self.tracer is not None:
                    self.tracer.phase(req.rid, end, PH_DECODE_WAIT,
                                      iid=target.iid, via="local")
                self._schedule_iter(target, end)
        for (req, src, dst, is_backflow) in (
                self.policy.select_migrations(end, inst)):
            self._start_transfer(req, src, dst, end,
                                 "backflow" if is_backflow
                                 else "degrade")
            self._schedule_iter(dst, end)
        if inst.pending_flip is not None:
            self._drain_step(inst, end)
        if reschedule and inst.has_work():
            if dur == 0.0:
                # nothing schedulable this tick (e.g. oversized
                # head-of-line request): back off instead of
                # spinning at the same timestamp
                self._schedule_iter(inst, end + 0.01)
            else:
                self._schedule_iter(inst, end)

    # ------------------------------------------------------------------
    # async pipeline: dispatch / commit event halves
    # ------------------------------------------------------------------
    def _dispatch(self, inst: Instance, now: float):
        dur = inst.dispatch_iteration(now)
        if dur is None:
            if inst.has_work():
                # nothing schedulable (oversized head-of-line): back off
                self._schedule_iter(inst, now + 0.01)
            return
        # hold the scheduled flag through the flight so arrivals and
        # transfers cannot double-dispatch; the commit rearms it
        self._iter_scheduled[inst.iid] = True
        self._push(now + dur, COMMIT, inst.iid)

    def _commit(self, inst: Instance, now: float):
        res = inst.commit_iteration(defer_emit=True)
        self._iter_scheduled[inst.iid] = False
        # scheduling first (migrations/drains run against a flushed
        # pipeline), then dispatch the NEXT iteration inline so the
        # device starts horizon N+1 before the host streams horizon N
        self._post_iteration(inst, now, res.duration, res.prefill_done,
                             reschedule=False)
        if inst.has_work() and not self._iter_scheduled[inst.iid]:
            if res.duration == 0.0:
                self._schedule_iter(inst, now + 0.01)
            else:
                self._handle(now, ITER, inst.iid)
        for req, t in res.token_events:
            inst.token_sink(req, t)
        if self.recovery is not None:
            for req in res.finished:
                self.recovery.drop(req.rid)
        if self.on_finish is not None:
            for req in res.finished:
                self.on_finish(req, req.finish_time
                               if req.finish_time is not None else now)

    # ------------------------------------------------------------------
    def set_horizon(self, max_horizon: int):
        """Set every instance's decode-horizon cap (1 = classic
        single-step iterations).  Instances still shrink K adaptively —
        this is the ceiling, not the operating point."""
        for inst in self.instances:
            inst.max_horizon = max_horizon

    # ------------------------------------------------------------------
    # drain-and-flip role reconfiguration
    # ------------------------------------------------------------------
    def request_role_flip(self, inst: Instance, itype: str,
                          chunk_size: int) -> bool:
        """Stage a role flip; decode residents are evacuated through the
        migration machinery over the following iterations and the flip
        lands once the instance's decode side is empty.  Returns True if
        the flip was staged (or applied immediately)."""
        if inst.pending_flip is not None:
            return False
        if inst.health != HEALTH_OK:
            return False                   # no role changes on downed peers
        inst.begin_flip(itype, chunk_size)
        if not inst.apply_flip():          # something to drain
            self._schedule_iter(inst, self.now)
        return True

    def _drain_step(self, inst: Instance, now: float):
        """Migrate a draining instance's decode residents to the least
        decode-loaded non-draining instance, then land the flip."""
        for req in inst.drain_candidates():
            if req.state == State.MIGRATING:
                continue
            dst = self._drain_destination(inst)
            if dst is None:
                break                      # nowhere to go: retry next iter
            self._start_transfer(req, inst, dst, now, "drain")
            self._schedule_iter(dst, now)
        inst.apply_flip()

    def _drain_destination(self, inst: Instance) -> Optional[Instance]:
        cands = [i for i in self.instances
                 if i is not inst and not i.draining and i.schedulable]
        if not cands:
            return None
        # decodes prefer a D-heavy home; fall back to any peer
        d = [i for i in cands if i.itype == D_HEAVY]
        return min(d or cands, key=lambda i: i.decode_load())

    # ------------------------------------------------------------------
    def run(self, requests: Sequence[Request], until: Optional[float] = None
            ) -> List[Request]:
        for r in requests:
            self.submit(r)
        while self._heap:
            if until is not None and self.peek_time() > until:
                break
            self.step()
        return list(requests)

    # ------------------------------------------------------------------
    def stats(self, requests, slo: SLO, qps: float) -> RunStats:
        wall = max(((r.finish_time or 0.0) for r in requests), default=0.0)
        return RunStats(
            list(requests), slo, qps, wall,
            cache_lookups=sum(i.cache_lookups for i in self.instances),
            cache_hits=sum(i.cache_hits for i in self.instances),
            saved_prefill_tokens=sum(i.cached_prefill_tokens
                                     for i in self.instances),
            early_rejections=getattr(self.policy.proxy, "rejected_count", 0),
            role_flips=self.role_flip_count)

    @property
    def role_flip_count(self) -> int:
        """Landed flips, from the per-instance ground truth."""
        return sum(i.role_flips for i in self.instances)
