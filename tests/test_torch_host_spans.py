"""The port's host spans (``repro_torch.serving.tracing.HOST_SPANS``) on
the CPU: off, a served run records nothing and opens no profiler range;
on (``--trace``), the spans of the same run nest and close, its tokens are
bit-equal to the run with everything off, and the mixed steps' counters
are the shapes ``pack_mixed`` returned; under ``torch.profiler`` every
span has its mirror in the trace; and the benchmark's span arithmetic
(``servebench/harness/program_spans.py``) on a hand-built session."""
import importlib.util
import os
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.core.latency import SLO
from repro_torch.engine import batching
from repro_torch.launch import serve
from repro_torch.serving import tracing
from repro_torch.serving.tracing import HOST_SPANS, HostSpans
from test_torch_helpers import cap_threads

cap_threads()

SLO_LOOSE = SLO(ttft=5.0, tpot=0.5)
CPU = ["--engine", "live", "--reduced", "--device", "cpu", "--qps", "4",
       "--arch", "smollm-135m"]

#: every span name a served run may open
NAMES = {"loop.run", "loop.ingest", "loop.wait", "loop.emit", "loop.steal",
         "loop.watchdog", "loop.control", "cluster.arrival", "cluster.iter",
         "cluster.commit", "cluster.transfer", "cluster.fault",
         "sched.plan", "sched.commit", "sched.route", "sched.transfer",
         "migrate.export", "migrate.checksum",
         "exec.enqueue.mixed", "exec.enqueue.decode", "exec.fetch",
         "graphs.capture"}


def _serve(*flags, n=8):
    """A served run of the launcher's live loop: (outputs, loop)."""
    args = serve.parse_args(CPU + ["--n", str(n), *flags])
    _, loop, _, _ = serve.live_loop(args, SLO_LOOSE)
    loop.run()
    return [r.output_tokens for r in loop.requests], loop


@pytest.fixture(autouse=True)
def recorder_off():
    """Each test starts and ends with the process's recorder off."""
    HOST_SPANS.set_forced(False)
    HOST_SPANS.clear()
    yield
    HOST_SPANS.set_forced(False)
    HOST_SPANS.clear()


@pytest.fixture(scope="module")
def runs():
    """The same requests served with everything off (profiler ranges
    counted) and then with ``--trace`` (the packed mixed shapes kept)."""
    mp = pytest.MonkeyPatch()
    opened = []

    class Counting:
        def __init__(self, name, *a, **kw):
            opened.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    HOST_SPANS.set_forced(False)
    HOST_SPANS.clear()
    mp.setattr(tracing, "_Mirror", Counting)
    mp.setattr(torch.profiler, "record_function", Counting)
    mp.setattr(torch.autograd.profiler, "record_function", Counting)
    session = HOST_SPANS.session
    off, _ = _serve()
    off_spans, off_session = list(HOST_SPANS.spans), HOST_SPANS.session
    mp.undo()

    packed = []
    pack = batching.pack_mixed

    def keep(*a, **kw):
        p = pack(*a, **kw)
        packed.append((p, len(a[0])))
        return p

    mp.setattr(batching, "pack_mixed", keep)
    on, loop = _serve("--trace")
    mp.undo()
    spans = list(HOST_SPANS.spans)
    chrome = loop.tracer.to_chrome_trace()
    HOST_SPANS.set_forced(False)
    HOST_SPANS.clear()
    return SimpleNamespace(off=off, on=on, opened=opened, session=session,
                           off_session=off_session, off_spans=off_spans,
                           spans=spans, packed=packed, chrome=chrome,
                           loop=loop)


def test_off_records_nothing_and_opens_no_range(runs):
    assert runs.off_spans == []
    assert runs.off_session == runs.session      # no session began
    assert runs.opened == []


def test_on_spans_nest_and_close(runs):
    spans = runs.spans
    assert spans, "a traced run recorded no span"
    names = {s.name for s in spans}
    assert names <= NAMES, names - NAMES
    assert {"loop.run", "cluster.iter", "cluster.commit", "sched.plan",
            "sched.commit", "exec.enqueue.mixed", "exec.enqueue.decode",
            "exec.fetch", "loop.emit"} <= names
    for i, s in enumerate(spans):
        assert s.index == i and s.t1 is not None and s.t1 >= s.t0
        if s.parent < 0:
            assert s.name == "loop.run"
            continue
        p = spans[s.parent]
        assert s.parent < i
        assert p.t0 <= s.t0 and s.t1 <= p.t1, (p.name, s.name)
    # the spans of one step name its instance and iteration
    for s in spans:
        if s.name.startswith(("exec.enqueue.", "sched.plan", "sched.commit")):
            assert s.iid is not None and s.it is not None, s.name
    steps = {(s.iid, s.it) for s in spans
             if s.name.startswith("exec.enqueue.")}
    assert len(steps) == sum(1 for s in spans
                             if s.name.startswith("exec.enqueue."))
    emitted = sum(s.attrs["tokens"] for s in spans if s.name == "loop.emit")
    assert emitted == sum(len(t) for t in runs.on)


def test_on_tokens_equal_off(runs):
    assert runs.on == runs.off
    assert sum(len(t) for t in runs.on) > 0


def test_mixed_counters_are_the_packed_shapes(runs):
    mixed = [s for s in runs.spans if s.name == "exec.enqueue.mixed"]
    assert len(mixed) == len(runs.packed) > 0
    for s, (p, n_rows) in zip(mixed, runs.packed):
        a = s.attrs
        assert (a["B"], a["T"]) == p.tokens.shape
        assert a["NB"] == p.tables.shape[1]
        assert a["valid"] == int(p.valid.sum())
        assert a["prefill_rows"] >= 1
        assert a["prefill_rows"] + a["decode_rows"] == n_rows
    decode = [s.attrs for s in runs.spans if s.name == "exec.enqueue.decode"]
    assert decode and all(a["rows"] <= a["B"] and a["K"] >= 1
                          and a["replay"] is False for a in decode)


def test_requests_link_to_their_steps(runs):
    """A request's prefill_chunk and decode_commit events name a step
    whose host spans the session holds."""
    steps = {(s.iid, s.it) for s in runs.spans
             if s.name.startswith("exec.enqueue.")}
    linked = 0
    for tr in runs.loop.tracer.traces():
        for _, name, attrs in tr.events:
            if name in ("prefill_chunk", "decode_commit"):
                assert (attrs["iid"], attrs["it"]) in steps
                linked += 1
    assert linked > 0


def test_chrome_trace_has_the_host_track(runs):
    host = [e for e in runs.chrome["traceEvents"]
            if e["pid"] == 3 and e["ph"] == "X"]
    assert len(host) == len(runs.spans)
    assert {e["name"] for e in host} == {s.name for s in runs.spans}
    assert min(e["ts"] for e in host) == 0.0


def test_profiler_turns_it_on_with_mirrors():
    """Under ``torch.profiler`` the recorder records, and each span opens
    a profiler range of its name that is no user annotation (which the
    profiler would draw over the device's kernels)."""
    args = serve.parse_args(CPU + ["--n", "4"])
    _, loop, _, _ = serve.live_loop(args, SLO_LOOSE)
    loop.run(max_steps=2)                   # off: nothing recorded
    assert HOST_SPANS.spans == []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        loop.run()
    spans = list(HOST_SPANS.spans)
    assert spans and spans[0].name == "loop.run" and spans[0].parent == -1
    mirrors = sorted((e for e in prof.profiler.kineto_results.events()
                      if e.name() in NAMES), key=lambda e: e.start_ns())
    assert [e.name() for e in mirrors] == [s.name for s in spans]
    assert not any(e.is_user_annotation() for e in mirrors)
    # the same clock (a loose bound: this CPU is shared; the card's test
    # holds each start within 50 us)
    for e, s in zip(mirrors, spans):
        assert abs(e.start_ns() - s.t0) < 1_000_000, s.name
    # after the profiler, the session stays as it was
    after = HOST_SPANS.session
    serve.live_loop(args, SLO_LOOSE)[1].run()
    assert HOST_SPANS.session == after and len(HOST_SPANS.spans) == len(spans)


def test_a_traced_loop_records_only_while_it_runs():
    """The switch is the traced loop's own: a loop built without tracing
    after it records nothing, a second traced loop begins a session of
    its own (its Chrome trace holds none of the first's spans), and a
    traced loop that runs again continues its session."""
    args = serve.parse_args(CPU + ["--n", "4", "--trace"])
    plain = serve.parse_args(CPU + ["--n", "4"])
    _, first, _, _ = serve.live_loop(args, SLO_LOOSE)
    first.run(max_steps=6)
    assert not HOST_SPANS.forced
    session, n = HOST_SPANS.session, len(HOST_SPANS.spans)
    assert n > 0
    first.run()                             # continues its session
    assert HOST_SPANS.session == session and len(HOST_SPANS.spans) > n
    assert sum(1 for s in HOST_SPANS.spans if s.name == "loop.run") == 2
    serve.live_loop(plain, SLO_LOOSE)[1].run()
    assert HOST_SPANS.session == session     # recorded nothing
    _, second, _, _ = serve.live_loop(args, SLO_LOOSE)
    second.run()
    assert HOST_SPANS.session == session + 1
    roots = [s for s in HOST_SPANS.spans if s.name == "loop.run"]
    assert len(roots) == 1 and HOST_SPANS.spans[0] is roots[0]
    host = [e for e in second.tracer.to_chrome_trace()["traceEvents"]
            if e["pid"] == 3 and e["ph"] == "X"]
    assert len(host) == len(HOST_SPANS.spans)
    assert not HOST_SPANS.forced


def test_device_ms_reads_once_and_lets_the_events_go():
    class Event:
        def __init__(self, done):
            self.done = done

        def query(self):
            return self.done

        def synchronize(self):
            self.done = True

        def elapsed_time(self, other):
            return 2.5

    rec = HostSpans()
    rec.set_forced(True)
    with rec.root("loop.run") as sp:
        sp.events = (Event(True), Event(False))
    assert rec.device_ms(sp, wait=False) is None and sp.events is not None
    assert rec.device_ms(sp) == 2.5 and sp.events is None
    assert rec.device_ms(sp) == 2.5 and sp.device == 2.5


def test_sessions_and_drops(monkeypatch):
    """A new session drops the last one's spans, and a span under a root
    opened before the session began records nothing."""
    rec = HostSpans()
    with rec.root("loop.run"):
        rec.set_forced(True)
        with rec.span("cluster.iter") as sp:
            assert sp is None
    assert rec.spans == []
    with rec.root("loop.run"):
        with rec.span("cluster.iter", iid=3, it=7):
            with rec.span("sched.plan") as sp:
                assert (sp.iid, sp.it) == (3, 7)
    assert [s.name for s in rec.spans] == ["loop.run", "cluster.iter",
                                          "sched.plan"]
    assert [s.parent for s in rec.spans] == [-1, 0, 1]
    rec.set_forced(False)
    with rec.span("loop.run") as sp:
        assert sp is None
    session = rec.set_forced(True)          # a new session
    assert rec.spans == []
    rec.set_forced(False)
    assert rec.set_forced(True, resume=session) == session
    monkeypatch.setattr(tracing, "MAX_SPANS", 1)
    with rec.root("loop.run"):
        with rec.span("cluster.iter") as sp:
            assert sp is None
    assert len(rec.spans) == 1 and rec.dropped == 1


def _program_spans():
    path = os.path.join(os.path.dirname(__file__), "..", "servebench",
                        "harness", "program_spans.py")
    spec = importlib.util.spec_from_file_location("program_spans_t", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _s(name, t0, t1, parent, **attrs):
    return SimpleNamespace(name=name, t0=t0, t1=t1, parent=parent,
                           attrs=attrs)


def test_readers_arithmetic_on_a_hand_built_session():
    ps = _program_spans()
    spans = [
        _s("loop.run", 0, 1000, -1),                         # 0
        _s("loop.ingest", 10, 60, 0),                        # 1
        _s("cluster.commit", 100, 600, 0),                   # 2
        _s("exec.fetch", 110, 200, 2),                       # 3
        _s("sched.commit", 200, 260, 2),                     # 4
        _s("cluster.iter", 270, 500, 2),                     # 5
        _s("sched.plan", 280, 300, 5),                       # 6
        _s("exec.enqueue.mixed", 300, 480, 5, B=4, T=32, NB=8, valid=40,
           prefill_rows=1, decode_rows=3),                   # 7
        _s("loop.emit", 510, 590, 2, tokens=4),              # 8
        _s("exec.enqueue.decode", 700, 800, 0, B=4, K=8),    # 9
        _s("loop.emit", 900, None, 0, tokens=2),             # 10, open
    ]
    assert ps.self_ns(spans) == [350, 50, 40, 90, 60, 30, 20, 180, 80,
                                 100, None]
    assert ps.host_unnamed_share(spans) == pytest.approx(35.0)
    # cluster.commit 40 + sched.commit 60 + cluster.iter 30 + sched.plan
    # 20 ns over two executor iterations
    assert ps.sched_ms(spans) == pytest.approx(75e-6)
    assert ps.prefill_enqueue_ms(spans) == pytest.approx(180e-6)
    assert ps.mixed_pad_share(spans) == pytest.approx(100 * (1 - 40 / 128))
    assert ps.emit_us(spans) == pytest.approx(0.02)
    for f in (ps.host_unnamed_share, ps.sched_ms, ps.prefill_enqueue_ms,
              ps.mixed_pad_share, ps.emit_us):
        assert f(None) is None and f([]) is None
    assert ps.sched_ms(spans[:7]) is None          # no executor iteration
    # a migration's data movement, under the routing that started it, is
    # no scheduling time
    assert ps.sched_ms([
        _s("loop.run", 0, 100, -1), _s("cluster.commit", 0, 100, 0),
        _s("sched.route", 10, 60, 1), _s("migrate.export", 20, 50, 2),
        _s("exec.enqueue.decode", 60, 90, 1)]) == pytest.approx(40e-6)
    assert ps.mixed_pad_share(spans[:7] + [spans[9]]) is None
