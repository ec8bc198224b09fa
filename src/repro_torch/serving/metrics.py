"""Sliding-window serving telemetry.

The adaptive controller (and any operator dashboard) needs *recent*
attainment, not lifetime averages: a run that starts prompt-heavy and
turns decode-heavy looks fine on cumulative TTFT long after its TPOT has
collapsed.  ``TelemetryWindow`` keeps the last ``window`` seconds of
first-token / per-token / finish / reject events in deques and computes
windowed TTFT/TPOT attainment, latency percentiles, goodput, and
throughput on demand; ``snapshot`` additionally samples instance gauges
(queue depths, decode population, HBM utilization, prefill-on-decode
interference, cache hit rate).

``MetricsLog`` accumulates snapshots for JSON export (the controller
bench and ``--engine live`` write these to disk).
"""
from __future__ import annotations

import dataclasses
import json
import threading
from collections import deque
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.latency import SLO
from repro_torch.engine.request import Request

#: how many trailing interference_log entries feed the per-instance gauge
INTERFERENCE_TAIL = 64


class TelemetryWindow:
    def __init__(self, slo: SLO, window: float = 10.0):
        self.slo = slo
        self.window = window
        self._first: deque = deque()     # (t, ttft)
        self._tokens: deque = deque()    # (t,)
        self._fin: deque = deque()       # (t, tpot | None, slo_ok)
        self._rej: deque = deque()       # (t,)
        # time origin for rate denominators: set explicitly (the serving
        # loop anchors at its start time) or lazily at the first event.
        # Without it, a window created at wall/virtual time T0 > 0 would
        # divide its first rates by min(window, now) — a span covering
        # time the window never observed
        self._anchor: Optional[float] = None
        # admission-queue wait spans (release time - arrival): the
        # router-side queue's first-class latency signal
        self._qwait: deque = deque()     # (t, wait)
        # wire-latency spans: wall seconds from the engine emitting a
        # token to its SSE frame hitting the socket.  Fed from the
        # asyncio thread (own lock; these carry wall timestamps, not
        # window time, so they are bounded by count, not trimmed)
        self._wire: deque = deque(maxlen=4096)   # (dt,)
        self._wire_lock = threading.Lock()
        # consistency lock for the window deques and lifetime counters:
        # mutators run on the engine thread, but ``/metrics`` snapshots
        # from the HTTP thread — without the lock a snapshot could read
        # ``total_finished`` and ``total_ok`` across a finish event, or
        # trip "deque mutated during iteration".  Reentrant because
        # ``snapshot`` calls the locked stat readers.
        self._lock = threading.RLock()
        # lifetime counters
        self.total_first = 0
        self.total_tokens = 0
        self.total_finished = 0
        self.total_ok = 0
        self.total_rejected = 0
        self.total_cancelled = 0
        self.total_queue_waits = 0
        self.total_wire_frames = 0
        # fault-tolerance outcomes: aborts (client hung up), failures
        # (unrecoverable fault), and finishes that survived >=1
        # crash/quarantine recovery (the "recovered goodput" the chaos
        # bench credits to the recovery path)
        self.total_aborted = 0
        self.total_failed = 0
        self.total_recovered = 0
        self.total_recovered_ok = 0

    # ------------------------------------------------------------------
    # event ingestion (wired to Instance.token_sink / Cluster callbacks)
    # ------------------------------------------------------------------
    def anchor(self, t: float):
        """Pin the window's time origin (idempotent: first call wins).
        Rates report per second OBSERVED, not per second since epoch."""
        if self._anchor is None:
            self._anchor = t

    def _span(self, now: float) -> float:
        """Seconds the window actually covers at ``now``: capped by the
        window length AND by how long the telemetry has existed."""
        if self._anchor is None:
            return 1e-9
        return max(min(self.window, now - self._anchor), 1e-9)

    def on_token(self, req: Request, t: float):
        with self._lock:
            self.anchor(t)
            self._tokens.append((t,))
            self.total_tokens += 1
            if req.output_len == 1:      # this token WAS the first token
                self._first.append((t, req.ttft()))
                self.total_first += 1

    def on_finish(self, req: Request, t: float):
        with self._lock:
            self.anchor(t)
            ok = self.slo.satisfied(req)
            self._fin.append((t, req.tpot(), ok))
            self.total_finished += 1
            self.total_ok += int(ok)
            if getattr(req, "n_recoveries", 0) > 0:
                self.total_recovered += 1
                self.total_recovered_ok += int(ok)

    def on_reject(self, req: Request, t: float):
        with self._lock:
            self.anchor(t)
            self._rej.append((t,))
            self.total_rejected += 1

    def on_cancel(self, req: Request, t: float):
        """Graceful-drain cancellation (still queued at shutdown) —
        counted separately from rejection: the server chose to stop,
        the request did not fail admission."""
        with self._lock:
            self.anchor(t)
            self.total_cancelled += 1

    def on_abort(self, req: Request, t: float):
        """Client-initiated abort (disconnect propagation): the request
        left the system by the client's choice — neither a finish nor a
        rejection."""
        with self._lock:
            self.anchor(t)
            self.total_aborted += 1

    def on_failed(self, req: Request, t: float):
        """Unrecoverable fault outcome (fail-stop crash loss, transfer
        retries exhausted, recovery loop bound)."""
        with self._lock:
            self.anchor(t)
            self.total_failed += 1

    def on_queue_wait(self, t: float, wait: float):
        """Admission-queue span: seconds between a request's arrival
        and its release into the cluster."""
        with self._lock:
            self.anchor(t)
            self._qwait.append((t, wait))
            self.total_queue_waits += 1

    def record_wire(self, dt: float):
        """Wire span: engine token event -> socket write (thread-safe;
        called from the HTTP writer)."""
        with self._wire_lock:
            self._wire.append(dt)
        self.total_wire_frames += 1

    def _trim(self, now: float):
        cut = now - self.window
        for dq in (self._first, self._tokens, self._fin, self._rej,
                   self._qwait):
            while dq and dq[0][0] < cut:
                dq.popleft()

    # ------------------------------------------------------------------
    # windowed statistics
    # ------------------------------------------------------------------
    def ttft_attainment(self, now: float) -> Optional[float]:
        """Share of windowed first tokens inside the TTFT SLO (None when
        the window saw no first tokens — the controller treats that as
        'no evidence', not 'perfect')."""
        with self._lock:
            self._trim(now)
            if not self._first:
                return None
            return sum(v <= self.slo.ttft for _, v in self._first) \
                / len(self._first)

    def tpot_attainment(self, now: float) -> Optional[float]:
        with self._lock:
            self._trim(now)
            if not self._fin:
                return None
            return sum(tp is None or tp <= self.slo.tpot
                       for _, tp, _ in self._fin) / len(self._fin)

    def goodput(self, now: float) -> float:
        """SLO-attained finishes per second over the window."""
        with self._lock:
            self._trim(now)
            return sum(ok for _, _, ok in self._fin) / self._span(now)

    @staticmethod
    def _decode_tpots(now: float, instances: Sequence) -> List[float]:
        """Current TPOTs of the in-flight decode population.  The
        ``decoding`` dicts belong to the engine thread and are NOT under
        this window's lock, so a concurrent snapshot can see them mutate
        mid-iteration — retry the (cheap) list() a bounded number of
        times and settle for the instance's last consistent view."""
        vals: List[float] = []
        for inst in instances:
            reqs: List = []
            for _ in range(8):
                try:
                    reqs = list(inst.decoding.values())
                    break
                except RuntimeError:
                    continue
            for r in reqs:
                tp = r.current_tpot(now)
                if tp is not None:
                    vals.append(tp)
        return vals

    def tpot_inflight_attainment(self, now: float,
                                 instances: Sequence) -> Optional[float]:
        """Share of currently-decoding requests whose TPOT *since their
        last reset* is inside the SLO.  Finished-request TPOT lags by a
        whole generation (several seconds); this is the controller's
        early-warning signal — it moves the moment a decode population
        starts slipping, not after it has already failed."""
        vals = self._decode_tpots(now, instances)
        if not vals:
            return None
        return sum(v <= self.slo.tpot for v in vals) / len(vals)

    def p90_tpot_inflight(self, now: float,
                          instances: Sequence) -> Optional[float]:
        vals = self._decode_tpots(now, instances)
        return float(np.percentile(vals, 90)) if vals else None

    def p90_ttft(self, now: float) -> Optional[float]:
        with self._lock:
            self._trim(now)
            if not self._first:
                return None
            return float(np.percentile([v for _, v in self._first], 90))

    def p90_tpot(self, now: float) -> Optional[float]:
        with self._lock:
            self._trim(now)
            xs = [tp for _, tp, _ in self._fin if tp is not None]
            return float(np.percentile(xs, 90)) if xs else None

    def queue_wait_stats(self, now: float) -> Optional[dict]:
        """Windowed admission-queue wait percentiles (None before any
        release went through the queue)."""
        with self._lock:
            self._trim(now)
            xs = [w for _, w in self._qwait]
        if not xs:
            return None
        return {"p50_s": round(float(np.percentile(xs, 50)), 5),
                "p95_s": round(float(np.percentile(xs, 95)), 5),
                "max_s": round(max(xs), 5),
                "releases": len(xs)}

    def wire_stats(self) -> Optional[dict]:
        """Per-token wire overhead percentiles over the retained tail
        (engine token event -> socket write, wall seconds)."""
        with self._wire_lock:
            xs = list(self._wire)
        if not xs:
            return None
        return {"p50_ms": round(float(np.percentile(xs, 50)) * 1e3, 3),
                "p95_ms": round(float(np.percentile(xs, 95)) * 1e3, 3),
                "mean_ms": round(float(np.mean(xs)) * 1e3, 3),
                "frames": self.total_wire_frames}

    # ------------------------------------------------------------------
    def snapshot(self, now: float,
                 instances: Sequence = (),
                 admission=None) -> dict:
        # one lock hold for the whole snapshot: every scalar inside is
        # mutually consistent (finished_total/slo_ok_total never tear)
        with self._lock:
            return self._snapshot_locked(now, instances, admission)

    def _snapshot_locked(self, now: float, instances: Sequence,
                         admission) -> dict:
        self._trim(now)
        span = self._span(now)
        snap = {
            "t": round(now, 3),
            "window_s": self.window,
            "ttft_attainment": self.ttft_attainment(now),
            "tpot_attainment": self.tpot_attainment(now),
            "p90_ttft_s": self.p90_ttft(now),
            "p90_tpot_s": self.p90_tpot(now),
            "goodput_rps": round(self.goodput(now), 4),
            "throughput_tok_s": round(len(self._tokens) / span, 2),
            "rejected_in_window": len(self._rej),
            "finished_total": self.total_finished,
            "slo_ok_total": self.total_ok,
            "rejected_total": self.total_rejected,
            "cancelled_total": self.total_cancelled,
        }
        # fault-outcome keys appear only once something fired: a
        # faults-off run snapshots identically to pre-fault builds
        if self.total_aborted:
            snap["aborted_total"] = self.total_aborted
        if self.total_failed:
            snap["failed_total"] = self.total_failed
        if self.total_recovered:
            snap["recovered_total"] = self.total_recovered
            snap["recovered_slo_ok_total"] = self.total_recovered_ok
        qw = self.queue_wait_stats(now)
        if qw is not None:
            snap["queue_wait"] = qw
        wire = self.wire_stats()
        if wire is not None:
            snap["wire"] = wire
        if admission is not None:
            snap["admission"] = admission.gauges(now)
        if instances:
            lookups = sum(i.cache_lookups for i in instances)
            hits = sum(i.cache_hits for i in instances)
            snap["cache_hit_rate"] = (hits / lookups) if lookups else 0.0
            snap["tpot_inflight_attainment"] = \
                self.tpot_inflight_attainment(now, instances)
            snap["instances"] = [self._instance_gauges(i)
                                 for i in instances]
        return snap

    @staticmethod
    def _instance_gauges(inst) -> dict:
        tail = inst.interference_log[-INTERFERENCE_TAIL:]
        mixed = [p for p, d in tail if d > 0]
        gauges = {
            "iid": inst.iid,
            "itype": inst.itype,
            "chunk": inst.chunk_size,
            "draining": inst.draining,
            "queued_prefills": len(inst.prefill_queue),
            "queued_prefill_tokens": inst.queued_prefill_tokens(),
            "decoding": len(inst.decoding),
            "pending_decode": len(inst.pending_decode),
            "hbm_util": round(inst.hbm_utilization(), 4),
            # decode-horizon pipeline state: K of the last planned
            # iteration and whether an async step is currently in
            # flight.  Token timestamps are spread across the horizon's
            # per-step durations at commit, so the in-flight TPOT
            # signals above read the lagged stream without distortion.
            "horizon": getattr(inst, "last_horizon", 1),
            "inflight": bool(getattr(inst, "has_inflight",
                                     lambda: False)()),
            # mean prefill tokens co-batched per decode-carrying
            # iteration — the interference the controller trades against
            # prefill capacity
            "interference": (float(np.mean(mixed)) if mixed else 0.0),
        }
        health = getattr(inst, "health", "ok")
        if health != "ok":             # healthy runs snapshot unchanged
            gauges["health"] = health
        # engine-executor hot-path counters (absent on SimExecutor, so
        # simulator snapshots keep their shape): host<->device readbacks
        # and blocking syncs per run, horizon batch stats, and the jit
        # cache size — a recompile storm shows up here long before it
        # shows up as latency
        ex = getattr(inst, "executor", None)
        if ex is not None and hasattr(ex, "host_readbacks"):
            ex_g = {"host_readbacks": ex.host_readbacks,
                    "host_syncs": ex.host_syncs,
                    "horizon_calls": ex.horizon_calls,
                    "horizon_tokens": ex.horizon_tokens}
            jc = getattr(ex, "jit_compiles", None)
            if jc is not None and (n := jc()) >= 0:
                ex_g["jit_compiles"] = n
            gauges["exec"] = ex_g
        hist = getattr(inst, "horizon_hist", None)
        if hist:
            gauges["horizon_hist"] = {str(k): v
                                      for k, v in sorted(hist.items())}
        pc = getattr(inst, "prefix_cache", None)
        if pc is not None and getattr(pc, "spill", None) is not None:
            gauges["spilled_blocks"] = len(pc.spill)
            gauges["spill_promoted_tokens"] = getattr(
                inst, "spill_promoted_tokens", 0)
        if getattr(inst, "replicas_in", 0):
            gauges["replicated_blocks_in"] = inst.replicas_in
        return gauges


@dataclasses.dataclass
class MetricsLog:
    """Snapshot accumulator with JSON export."""
    snapshots: List[dict] = dataclasses.field(default_factory=list)
    events: List[dict] = dataclasses.field(default_factory=list)

    def record(self, snap: dict):
        self.snapshots.append(snap)

    def record_event(self, t: float, kind: str, detail: Dict):
        self.events.append({"t": round(t, 3), "kind": kind, **detail})

    def to_json(self) -> str:
        return json.dumps({"snapshots": self.snapshots,
                           "events": self.events}, indent=2)

    def dump(self, path: str):
        with open(path, "w") as f:
            f.write(self.to_json())
