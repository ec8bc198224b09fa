"""Request-lifecycle tracing and SLO attribution.

``TelemetryWindow`` answers "how is the fleet doing *right now*";
nothing answers "where did THIS request's latency go" — which is the
question the paper's whole latency-shifting argument turns on (queueing
vs prefill vs transfer vs decode interference, DistServe Fig. 4 /
Tropical §5).  ``Tracer`` records a per-request timeline as a chain of
**phases** plus fine-grained **events**:

phases (contiguous, non-overlapping by construction — each ``phase()``
call closes the current span at the new span's start time):

* ``admission``   — router-side admission-queue wait
* ``queue``       — event-heap wait + placement + instance prefill queue
                    (re-entered after preemption / crash recovery)
* ``prefill``     — first chunk dispatched -> prefill complete
* ``transfer``    — KV/state migration on the wire (incl. retries)
* ``decode_wait`` — landed on the decode instance, awaiting batch slot
* ``decode``      — in the decode batch -> finish (or eject)

events ride on the timeline without breaking it: per-chunk prefill
commits (with cache-hit offset), per-commit decode horizons (with
co-batched prefill interference), transfer retries, preemptions,
recoveries, routing decisions.  Cluster-scoped happenings (stalls,
quarantines, controller actuations) land in a global event log.

The tracer is **clock-agnostic**: every hook passes the time it already
has (virtual event time in sim, wall time under ``WallClock``), so the
same instrumentation serves both.  It is **observational only** — no
RNG, no scheduling influence — so a traced run produces bit-identical
request outcomes to an untraced one (``tests/test_torch_host_spans.py``
holds a traced run's greedy tokens equal to an untraced run's), and
with ``tracing=None`` every call site short-circuits on ``tracer is
None``.  A ``prefill_chunk`` or ``decode_commit`` event names the
instance (``iid``) and the iteration (``it``) of its step, the keys of
that step's host spans.

Attribution:

* ``breakdown(rid)`` -> phase -> seconds, summing exactly to the
  request's end-to-end latency (spans share endpoints);
* ``violation_report(slo)`` aggregates the per-phase budget of every
  SLO-violating finished request — "where did violated requests lose
  their budget".

**Host spans** (``HostSpans``, the module's ``HOST_SPANS``) answer where
the serving path's *host* time goes: one span at every layer boundary of
the loop, the cluster, the scheduling core, the executor and the graphs,
stamped on the clock of ``torch.profiler``'s CPU events and mirrored
into a device trace while a profiler records.

Exporters: Chrome-trace/Perfetto JSON (``to_chrome_trace`` /
``dump_chrome`` — load in ui.perfetto.dev; the host spans on a track of
their own), JSONL event log (``dump_jsonl``), and a Prometheus text
renderer over telemetry snapshots (``prometheus_text``,
content-negotiated on the gateway's ``/metrics``).
"""
from __future__ import annotations

import dataclasses
import functools
import json
import re
import time
from collections import deque
from typing import Dict, Iterator, List, Optional

import torch

PH_ADMISSION = "admission"
PH_QUEUE = "queue"
PH_PREFILL = "prefill"
PH_TRANSFER = "transfer"
PH_DECODE_WAIT = "decode_wait"
PH_DECODE = "decode"

PHASES = (PH_ADMISSION, PH_QUEUE, PH_PREFILL, PH_TRANSFER,
          PH_DECODE_WAIT, PH_DECODE)


@dataclasses.dataclass
class TraceConfig:
    """Tracing knobs.  Constructing one and passing it to
    ``ServingLoop(tracing=...)`` is the ON switch; the default is off
    (no tracer object, every instrumentation site inert)."""
    #: completed traces retained (ring buffer; live requests always kept)
    max_requests: int = 4096
    #: record fine-grained sub-events (chunk/horizon/retry granularity).
    #: Phases are always recorded — they are the attribution substrate.
    events: bool = True
    #: per-request event cap (a 10k-token decode at K=1 would otherwise
    #: log 10k commit events; the counter keeps the truth)
    max_events_per_request: int = 512
    #: cluster-scoped event cap (stalls, quarantines, controller moves)
    max_global_events: int = 8192


class Span:
    __slots__ = ("phase", "t0", "t1", "attrs")

    def __init__(self, phase: str, t0: float,
                 attrs: Optional[dict] = None):
        self.phase = phase
        self.t0 = t0
        self.t1: Optional[float] = None   # open until the next phase
        self.attrs = attrs

    def dur(self) -> float:
        return (self.t1 - self.t0) if self.t1 is not None else 0.0


class RequestTrace:
    __slots__ = ("rid", "t_begin", "t_end", "spans", "events", "state",
                 "finish_reason", "arrival", "first_token_t",
                 "prompt_len", "output_len", "n_recoveries",
                 "events_dropped")

    def __init__(self, rid: int, t_begin: float):
        self.rid = rid
        self.t_begin = t_begin
        self.t_end: Optional[float] = None
        self.spans: List[Span] = []
        self.events: List[tuple] = []     # (t, name, attrs | None)
        self.state: Optional[str] = None
        self.finish_reason: Optional[str] = None
        self.arrival = t_begin
        self.first_token_t: Optional[float] = None
        self.prompt_len = 0
        self.output_len = 0
        self.n_recoveries = 0
        self.events_dropped = 0

    @property
    def done(self) -> bool:
        return self.t_end is not None

    def e2e(self) -> Optional[float]:
        return None if self.t_end is None else self.t_end - self.t_begin


class Tracer:
    """Low-overhead span recorder.  All mutators take the caller's
    timestamp — the tracer never reads a clock, so sim and live runs
    use it identically.  Single-writer by design: every hook runs on
    the engine/event thread (exports may run anywhere after the run)."""

    def __init__(self, cfg: Optional[TraceConfig] = None):
        self.cfg = cfg or TraceConfig()
        self._live: Dict[int, RequestTrace] = {}
        self._done: Dict[int, RequestTrace] = {}
        self._done_order: deque = deque()
        self.global_events: deque = deque(
            maxlen=self.cfg.max_global_events)
        self.dropped_traces = 0           # evicted past max_requests

    # ------------------------------------------------------------------
    # recording
    # ------------------------------------------------------------------
    def begin(self, req, t: float, phase: str = PH_QUEUE):
        """Open a request's trace at its (receipt-stamped) arrival."""
        rid = req.rid
        if rid in self._live or rid in self._done:
            return
        tr = RequestTrace(rid, t)
        tr.prompt_len = getattr(req, "prompt_len", 0)
        tr.spans.append(Span(phase, t))
        self._live[rid] = tr

    def phase(self, rid: int, t: float, name: str, **attrs):
        """Transition to ``name``: closes the current span at ``t`` and
        opens the new one there — contiguity by construction.  A
        same-phase transition is a no-op (the original start stands)."""
        tr = self._live.get(rid)
        if tr is None:
            return
        cur = tr.spans[-1]
        if cur.phase == name:
            return
        t = max(t, cur.t0)          # never a negative-duration span
        cur.t1 = t
        tr.spans.append(Span(name, t, attrs or None))

    def event(self, rid: int, t: float, name: str, **attrs):
        if not self.cfg.events:
            return
        tr = self._live.get(rid)
        if tr is None:
            return
        if len(tr.events) >= self.cfg.max_events_per_request:
            tr.events_dropped += 1
            return
        tr.events.append((t, name, attrs or None))

    def global_event(self, t: float, name: str, **attrs):
        if self.cfg.events:
            self.global_events.append((t, name, attrs or None))

    def finish(self, req, t: float):
        """Seal a request's trace at its terminal state.  A request the
        loop refused at the door (graceful drain) may never have begun —
        it still gets a (degenerate) trace, so "every terminal request
        has a trace" holds unconditionally."""
        rid = req.rid
        tr = self._live.pop(rid, None)
        if tr is None:
            if rid in self._done:
                return
            t0 = min(getattr(req, "arrival", t) or t, t)
            tr = RequestTrace(rid, t0)
            tr.prompt_len = getattr(req, "prompt_len", 0)
            tr.spans.append(Span(PH_QUEUE, t0))
        last = tr.spans[-1]
        last.t1 = max(t, last.t0)
        tr.t_end = last.t1
        state = getattr(req, "state", None)
        tr.state = getattr(state, "value", state)
        tr.finish_reason = getattr(req, "finish_reason", None)
        tr.arrival = getattr(req, "arrival", tr.t_begin)
        tr.first_token_t = getattr(req, "first_token_time", None)
        tr.output_len = getattr(req, "output_len", 0)
        tr.n_recoveries = getattr(req, "n_recoveries", 0)
        self._done[rid] = tr
        self._done_order.append(rid)
        while len(self._done_order) > self.cfg.max_requests:
            old = self._done_order.popleft()
            self._done.pop(old, None)
            self.dropped_traces += 1

    # ------------------------------------------------------------------
    # lookup / attribution
    # ------------------------------------------------------------------
    def get(self, rid: int) -> Optional[RequestTrace]:
        return self._done.get(rid) or self._live.get(rid)

    def traces(self) -> Iterator[RequestTrace]:
        yield from self._done.values()
        yield from self._live.values()

    def __len__(self) -> int:
        return len(self._done) + len(self._live)

    def breakdown(self, rid: int,
                  until: Optional[float] = None) -> Optional[Dict[str, float]]:
        """Phase -> seconds for one request.  For a finished request the
        values sum exactly to ``t_end - t_begin`` (spans share their
        endpoints); for a live one the open span is clipped at
        ``until`` (default: its start — i.e. excluded)."""
        tr = self.get(rid)
        if tr is None:
            return None
        out: Dict[str, float] = {}
        for sp in tr.spans:
            t1 = sp.t1 if sp.t1 is not None else max(until or sp.t0, sp.t0)
            out[sp.phase] = out.get(sp.phase, 0.0) + (t1 - sp.t0)
        return out

    @staticmethod
    def _clipped(tr: RequestTrace, lo: float,
                 hi: float) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for sp in tr.spans:
            t1 = sp.t1 if sp.t1 is not None else sp.t0
            a, b = max(sp.t0, lo), min(t1, hi)
            if b > a:
                out[sp.phase] = out.get(sp.phase, 0.0) + (b - a)
        return out

    def violation_report(self, slo) -> dict:
        """Aggregate SLO attribution over retained finished traces:
        for TTFT violators, mean per-phase seconds up to the first
        token; for TPOT violators, mean per-phase seconds after it —
        "where did violated requests lose their budget"."""
        ttft_acc: Dict[str, float] = {}
        tpot_acc: Dict[str, float] = {}
        n_fin = n_ttft = n_tpot = 0
        n_ttft_rec = n_tpot_rec = 0
        ttft_excess = 0.0
        for tr in self._done.values():
            if tr.state != "finished" or tr.first_token_t is None:
                continue
            n_fin += 1
            ttft = tr.first_token_t - tr.t_begin
            if ttft > slo.ttft:
                n_ttft += 1
                n_ttft_rec += tr.n_recoveries > 0
                ttft_excess += ttft - slo.ttft
                for ph, s in self._clipped(
                        tr, tr.t_begin, tr.first_token_t).items():
                    ttft_acc[ph] = ttft_acc.get(ph, 0.0) + s
            if tr.output_len > 1 and tr.t_end is not None:
                tpot = (tr.t_end - tr.first_token_t) / (tr.output_len - 1)
                if tpot > slo.tpot:
                    n_tpot += 1
                    n_tpot_rec += tr.n_recoveries > 0
                    for ph, s in self._clipped(
                            tr, tr.first_token_t, tr.t_end).items():
                        tpot_acc[ph] = tpot_acc.get(ph, 0.0) + s

        def mean(acc, n):
            return {ph: round(s / n, 6) for ph, s in sorted(acc.items())} \
                if n else {}

        return {
            "finished": n_fin,
            "ttft": {"violations": n_ttft,
                     "budget_s": slo.ttft,
                     "mean_excess_s": round(ttft_excess / n_ttft, 6)
                     if n_ttft else 0.0,
                     "mean_phase_s": mean(ttft_acc, n_ttft),
                     # violators that went through a crash recovery —
                     # separates recovery-dominated violations from
                     # ordinary congestion
                     "recovered_violators": n_ttft_rec},
            "tpot": {"violations": n_tpot,
                     "budget_s": slo.tpot,
                     "mean_phase_s": mean(tpot_acc, n_tpot),
                     "recovered_violators": n_tpot_rec},
        }

    # ------------------------------------------------------------------
    # exporters
    # ------------------------------------------------------------------
    def to_chrome_trace(self) -> dict:
        """Chrome-trace/Perfetto JSON: one row (tid) per request under
        pid 1, cluster-scoped events under pid 2 (one row per
        instance), and the host spans of the recorder's newest session
        under pid 3 (``HostSpans.chrome_events``).  Times in
        microseconds as the format requires."""
        evs: List[dict] = [
            {"ph": "M", "pid": 1, "tid": 0, "name": "process_name",
             "args": {"name": "requests"}},
            {"ph": "M", "pid": 2, "tid": 0, "name": "process_name",
             "args": {"name": "cluster"}},
        ]
        for tr in sorted(self.traces(), key=lambda r: r.rid):
            evs.append({"ph": "M", "pid": 1, "tid": tr.rid,
                        "name": "thread_name",
                        "args": {"name": f"req {tr.rid}"}})
            for sp in tr.spans:
                t1 = sp.t1 if sp.t1 is not None else sp.t0
                ev = {"ph": "X", "pid": 1, "tid": tr.rid, "cat": "request",
                      "name": sp.phase, "ts": round(sp.t0 * 1e6, 3),
                      "dur": round((t1 - sp.t0) * 1e6, 3)}
                if sp.attrs:
                    ev["args"] = sp.attrs
                evs.append(ev)
            for t, name, attrs in tr.events:
                ev = {"ph": "i", "pid": 1, "tid": tr.rid, "cat": "event",
                      "name": name, "ts": round(t * 1e6, 3), "s": "t"}
                if attrs:
                    ev["args"] = attrs
                evs.append(ev)
        for t, name, attrs in self.global_events:
            ev = {"ph": "i", "pid": 2,
                  "tid": (attrs or {}).get("iid", 0), "cat": "cluster",
                  "name": name, "ts": round(t * 1e6, 3), "s": "p"}
            if attrs:
                ev["args"] = attrs
            evs.append(ev)
        evs += HOST_SPANS.chrome_events(pid=3)
        return {"traceEvents": evs, "displayTimeUnit": "ms"}

    def dump_chrome(self, path: str):
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f)

    def dump_jsonl(self, path: str):
        """Flat JSONL event log: one ``meta`` line per request, then its
        spans and events; global events last.  Grep-able and streamable
        where the Chrome JSON is a single document."""
        with open(path, "w") as f:
            for tr in sorted(self.traces(), key=lambda r: r.rid):
                f.write(json.dumps({
                    "kind": "meta", "rid": tr.rid, "state": tr.state,
                    "finish_reason": tr.finish_reason,
                    "t_begin": tr.t_begin, "t_end": tr.t_end,
                    "prompt_len": tr.prompt_len,
                    "output_len": tr.output_len,
                    "first_token_t": tr.first_token_t,
                    "n_recoveries": tr.n_recoveries,
                    "events_dropped": tr.events_dropped}) + "\n")
                for sp in tr.spans:
                    rec = {"kind": "span", "rid": tr.rid,
                           "phase": sp.phase, "t0": sp.t0, "t1": sp.t1}
                    if sp.attrs:
                        rec["attrs"] = sp.attrs
                    f.write(json.dumps(rec) + "\n")
                for t, name, attrs in tr.events:
                    rec = {"kind": "event", "rid": tr.rid,
                           "name": name, "t": t}
                    if attrs:
                        rec["attrs"] = attrs
                    f.write(json.dumps(rec) + "\n")
            for t, name, attrs in self.global_events:
                rec = {"kind": "global", "name": name, "t": t}
                if attrs:
                    rec["attrs"] = attrs
                f.write(json.dumps(rec) + "\n")


# ----------------------------------------------------------------------
# host spans: where the serving path's host time goes
# ----------------------------------------------------------------------
_profiler_enabled = torch.autograd._profiler_enabled
#: the profiler mirror of a span: a ``RecordFunction`` of function scope.
#: ``torch.profiler.record_function`` opens one of user scope, which the
#: profiler also draws on the device as a ``gpu_user_annotation`` over
#: the kernels launched inside it; a trace reader that takes device
#: events for device work would then count a whole eager step as busy.
_Mirror = torch._C._profiler._RecordFunctionFast
#: spans a session keeps; past it ``HostSpans.dropped`` counts the rest
MAX_SPANS = 1_000_000


class HostSpan:
    """One host span: ``name``; ``t0`` and ``t1``, its start and end in
    nanoseconds of the Unix epoch (``time.time_ns``, the clock on which
    ``torch.profiler`` stamps its CPU events; ``t1`` None while open);
    ``parent``, its parent's ``index`` in the session (-1 for a root); the
    instance ``iid`` and its iteration number ``it``, where one applies
    (a span takes its parent's unless its site names them); ``attrs``,
    the counters its site noted; ``events``, CUDA events recorded around
    its device work, until ``HostSpans.device_ms`` reads them into
    ``device`` (ms) and lets them go."""
    __slots__ = ("name", "t0", "t1", "parent", "index", "iid", "it",
                 "attrs", "events", "device", "_rec", "_session",
                 "_mirror")

    def __init__(self, rec: "HostSpans", name: str, parent: int,
                 iid: Optional[int], it: Optional[int]):
        self._rec = rec
        self._session = rec.session
        self.name = name
        self.parent = parent
        self.index = -1
        self.iid = iid
        self.it = it
        self.t0 = 0
        self.t1: Optional[int] = None
        self.attrs: dict = {}
        self.events = None
        self.device: Optional[float] = None
        self._mirror = None

    def note(self, **attrs):
        self.attrs.update(attrs)

    def __enter__(self):
        rec = self._rec
        self.index = len(rec.spans)
        rec.spans.append(self)
        rec._stack.append(self)
        if _profiler_enabled():
            # stamped once the mirror has opened: what the profiler does
            # before it stamps its own start (a new block of its event
            # list now and then) falls before both
            self._mirror = _Mirror(self.name)
            self._mirror.__enter__()
        self.t0 = time.time_ns()
        return self

    def __exit__(self, t, v, tb):
        if self._mirror is not None:
            self._mirror.__exit__(None, None, None)
            self._mirror = None
        self.t1 = time.time_ns()
        self._rec._stack.pop()
        return False


class _Off:
    """The context of a span while the recorder is off."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, t, v, tb):
        return False


class _Skip:
    """The context of a root opened while off, or of a span dropped while
    recording: while one is open, the spans inside it record nothing
    either, so that no session holds a span without the root it ran
    under."""
    __slots__ = ("_rec",)

    def __init__(self, rec: "HostSpans"):
        self._rec = rec

    def __enter__(self):
        self._rec._outer += 1
        return None

    def __exit__(self, t, v, tb):
        self._rec._outer -= 1
        return False


_OFF = _Off()


class HostSpans:
    """The port's recorder of host spans, one a process (``HOST_SPANS``).

    It records while a ``torch.profiler`` session is enabled (so every
    device trace holds the program's spans, each mirrored by a
    ``RecordFunction`` of its name) or while ``forced`` (the operator's
    switch: a ``ServingLoop`` built with ``tracing`` holds it on while
    it runs).  Off, a site costs one check of the two and opens nothing.
    Turning it on begins a new session: the spans of the last one are
    dropped, and so is a span whose root opened before the session
    began.  The spans stay in memory (``spans``, in the order they
    opened; at most ``MAX_SPANS``) and are read after the run.

    Single-writer, as ``Tracer``: every site runs on the loop's thread.

    Sites (``span``, ``root``): ``loop.run`` (the root, one a call of
    ``ServingLoop.run``), ``loop.ingest``, ``loop.wait``, ``loop.emit``,
    ``loop.steal``, ``loop.watchdog``, ``loop.control``;
    ``cluster.<event kind>``; ``sched.plan``, ``sched.commit``,
    ``sched.route``, ``sched.transfer``; ``migrate.export``,
    ``migrate.checksum`` (a transfer's data movement);
    ``exec.enqueue.mixed``, ``exec.enqueue.decode``, ``exec.fetch``;
    ``graphs.capture``."""

    def __init__(self):
        self.forced = False
        self.session = 0
        self.spans: List[HostSpan] = []
        self.dropped = 0            # spans past ``MAX_SPANS``
        self._live = False          # the current session is recording
        self._stack: List[HostSpan] = []
        self._outer = 0             # unrecorded roots (and drops) open
        self._skip = _Skip(self)

    def recording(self) -> bool:
        return self.forced or _profiler_enabled()

    def set_forced(self, on: bool, resume: Optional[int] = None) -> int:
        """The operator's switch.  Turning it on begins a session, unless
        ``resume`` is the current one (a traced loop that runs again
        continues its own session where none began in between).
        Returns the session."""
        if on and not self.forced:
            if resume is not None and resume == self.session:
                self._live = True
            else:
                self._begin()
        self.forced = bool(on)
        return self.session

    def clear(self):
        self._begin()
        self._live = self.recording()

    def _begin(self):
        self.session += 1
        self.spans = []
        self.dropped = 0
        self._live = True

    def span(self, name: str, iid: Optional[int] = None,
             it: Optional[int] = None, **attrs):
        """The context of one span (``with``), noting ``attrs``: the
        ``HostSpan`` while recording, else None."""
        if self.forced or _profiler_enabled():
            return self._open(name, iid, it, attrs)
        self._live = False
        return _OFF

    def traced(self, name: str, key=None):
        """A decorator: each call of the function is one span ``name``;
        ``key(*args)`` gives its ``(iid, it)``, called only while
        recording."""
        def decorate(fn):
            @functools.wraps(fn)
            def call(*args, **kw):
                if not (self.forced or _profiler_enabled()):
                    self._live = False
                    return fn(*args, **kw)
                iid, it = key(*args) if key is not None else (None, None)
                with self._open(name, iid, it, None):
                    return fn(*args, **kw)
            return call
        return decorate

    def root(self, name: str):
        """As ``span``, for a root: opened while off, it keeps the spans
        inside it from recording if the recorder turns on meanwhile."""
        if self.forced or _profiler_enabled():
            return self._open(name, None, None, None)
        self._live = False
        return self._skip

    def top(self, name: str) -> Optional[HostSpan]:
        """The innermost open span if it records and is named ``name``
        (where a site notes its counters), else None."""
        if self._stack and self._stack[-1].name == name:
            return self._stack[-1]
        return None

    def _open(self, name, iid, it, attrs):
        if not self._live:
            self._begin()
        if self._outer:
            return self._skip
        stack = self._stack
        parent = stack[-1] if stack else None
        if parent is not None and parent._session != self.session:
            return self._skip       # its root opened in an older session
        if len(self.spans) >= MAX_SPANS:
            self.dropped += 1
            return self._skip
        if parent is None:
            sp = HostSpan(self, name, -1, iid, it)
        else:
            sp = HostSpan(self, name, parent.index,
                          parent.iid if iid is None else iid,
                          parent.it if it is None else it)
        if attrs:
            sp.attrs.update(attrs)
        return sp

    @staticmethod
    def device_ms(sp: HostSpan, wait: bool = True) -> Optional[float]:
        """Device milliseconds between the span's two CUDA events, kept
        in ``sp.device`` once read; the events then go.  With ``wait``
        False it reads them only if the device has passed the second
        (None otherwise), so it never blocks."""
        if sp.events is not None:
            ev0, ev1 = sp.events
            if not wait and not ev1.query():
                return None
            ev1.synchronize()
            sp.device = ev0.elapsed_time(ev1)
            sp.events = None
        return sp.device

    def chrome_events(self, pid: int = 3) -> List[dict]:
        """The session's closed spans as Chrome-trace complete events on
        one row of process ``pid``, in microseconds from the session's
        first span (the wall clock: the request rows run on the loop's)."""
        done = [sp for sp in self.spans if sp.t1 is not None]
        title = "host (wall clock from the first span)"
        if self.dropped:
            title += f"; {self.dropped} spans past the cap not kept"
        evs: List[dict] = [
            {"ph": "M", "pid": pid, "tid": 0, "name": "process_name",
             "args": {"name": title}}]
        if not done:
            return evs
        origin = min(sp.t0 for sp in done)
        for sp in done:
            args = dict(sp.attrs)
            if sp.iid is not None:
                args["iid"] = sp.iid
            if sp.it is not None:
                args["it"] = sp.it
            ms = self.device_ms(sp)
            if ms is not None:
                args["device_ms"] = round(ms, 4)
            ev = {"ph": "X", "pid": pid, "tid": 0, "cat": "host",
                  "name": sp.name, "ts": round((sp.t0 - origin) / 1e3, 3),
                  "dur": round((sp.t1 - sp.t0) / 1e3, 3)}
            if args:
                ev["args"] = args
            evs.append(ev)
        return evs


#: the process's recorder (the benchmark's readers find it here)
HOST_SPANS = HostSpans()


# ----------------------------------------------------------------------
# Prometheus text exposition over a telemetry snapshot
# ----------------------------------------------------------------------
_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _metric_name(*parts: str) -> str:
    return _NAME_RE.sub("_", "_".join(p.strip("_") for p in parts if p))


def _samples_from(prefix: str, obj, labels: dict, out: list):
    """Flatten a snapshot subtree into (name, labels, value) samples.
    Strings are skipped (Prometheus samples are numeric); bools become
    0/1; ``None`` (windowed stat with no evidence) is skipped."""
    if isinstance(obj, bool):
        out.append((prefix, labels, int(obj)))
    elif isinstance(obj, (int, float)):
        out.append((prefix, labels, obj))
    elif isinstance(obj, dict):
        for k, v in obj.items():
            _samples_from(_metric_name(prefix, str(k)), v, labels, out)


def prometheus_text(snap: dict, prefix: str = "taichi") -> str:
    """Render a ``ServingLoop.snapshot()`` dict in Prometheus text
    exposition format (one scrape = one snapshot).  Scalar keys become
    gauges (``*_total`` lifetime counters become counters); the
    per-instance gauge list becomes label-dimensioned series
    (``iid``/``itype``); per-class admission depths get a ``cls``
    label."""
    samples: List[tuple] = []
    for key, val in snap.items():
        if key == "instances":
            continue
        if key == "admission" and isinstance(val, dict):
            for k, v in val.items():
                if k == "depth_by_class" and isinstance(v, dict):
                    for cls, d in v.items():
                        samples.append((_metric_name(prefix,
                                                     "admission_depth"),
                                        {"cls": cls}, d))
                elif k == "released_by_class" and isinstance(v, dict):
                    for cls, d in v.items():
                        samples.append((
                            _metric_name(prefix,
                                         "admission_released_by_class_"
                                         "total"),
                            {"cls": cls}, d))
                else:
                    _samples_from(_metric_name(prefix, "admission", k),
                                  v, {}, samples)
            continue
        _samples_from(_metric_name(prefix, key), val, {}, samples)
    for g in snap.get("instances", ()):
        labels = {"iid": str(g.get("iid")), "itype": str(g.get("itype"))}
        for k, v in g.items():
            if k in ("iid", "itype"):
                continue
            if k == "horizon_hist" and isinstance(v, dict):
                for kk, n in v.items():
                    samples.append((
                        _metric_name(prefix, "instance_horizon_hist"),
                        {**labels, "k": str(kk)}, n))
                continue
            if isinstance(v, str):
                # state-style gauges (health) export as labeled 1
                samples.append((_metric_name(prefix, "instance", k),
                                {**labels, k: v}, 1))
                continue
            _samples_from(_metric_name(prefix, "instance", k), v,
                          labels, samples)
    by_name: Dict[str, list] = {}
    for name, labels, value in samples:
        by_name.setdefault(name, []).append((labels, value))
    lines: List[str] = []
    for name in sorted(by_name):
        kind = "counter" if name.endswith("_total") else "gauge"
        lines.append(f"# HELP {name} repro serving telemetry")
        lines.append(f"# TYPE {name} {kind}")
        for labels, value in by_name[name]:
            if isinstance(value, bool):
                value = int(value)
            lbl = ""
            if labels:
                lbl = "{" + ",".join(
                    f'{k}="{v}"' for k, v in sorted(labels.items())) + "}"
            lines.append(f"{name}{lbl} {value}")
    return "\n".join(lines) + "\n"
