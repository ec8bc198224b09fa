"""The port's online serving runtime (``repro_torch.serving``) on the
simulator's token oracle: the reference's loop, clock, telemetry and
controller tests (``tests/test_serving.py``) run on the port's modules,
and the port's ``ServingLoop`` is held against the reference's on the
same seeded workload (identical per-request TTFT/TPOT and snapshots)."""
import json

import pytest

from repro_torch.core.estimator import CostModel
from repro_torch.core.hw import InstanceSpec
from repro_torch.configs import get_config
from repro_torch.core.instance import D_HEAVY, Instance, P_HEAVY
from repro_torch.core.latency import SLO
from repro_torch.core.policies import Sliders
from repro_torch.engine.engine import SimExecutor
from repro_torch.engine.request import Request, State
from repro_torch.serving import (ControllerConfig, ServingLoop,
                                 SliderController, TelemetryWindow,
                                 VirtualClock, WallClock)
from repro_torch.sim.simulator import ServingConfig, build_cluster
from repro_torch.sim.workload import (DECODE_HEAVY, DRIFT, PROMPT_HEAVY,
                                      Phase, PhaseDriftSpec, SHAREGPT)
from test_torch_helpers import cap_threads

cap_threads()

BAL = SLO(ttft=1.5, tpot=0.030)


def _mk_loop(policy="taichi", sliders=Sliders(2, 2, 1024, 256),
             blocks=8192, arrivals=None, **kw):
    sc = ServingConfig(policy=policy, sliders=sliders, hbm_blocks=blocks)
    cluster = build_cluster(sc, BAL)
    return ServingLoop(cluster, BAL, arrivals=arrivals, **kw)


# ---------------------------------------------------------------------------
# incremental loop == batch run
# ---------------------------------------------------------------------------

def test_incremental_loop_matches_batch_run():
    reqs_a = SHAREGPT.sample_requests(120, 40.0, seed=3)
    reqs_b = SHAREGPT.sample_requests(120, 40.0, seed=3)
    for a, b in zip(reqs_a, reqs_b):       # same lengths/arrivals
        assert (a.prompt_len, a.arrival) == (b.prompt_len, b.arrival)

    sc = ServingConfig(sliders=Sliders(2, 2, 1024, 256))
    batch = build_cluster(sc, BAL)
    batch.run(reqs_a)

    loop = _mk_loop(arrivals=iter(reqs_b), steal=False)
    loop.run()
    assert [r.finish_time for r in reqs_b] == \
        [r.finish_time for r in reqs_a]
    assert [r.output_len for r in reqs_b] == [r.output_len for r in reqs_a]


def test_run_until_is_reentrant():
    reqs = SHAREGPT.sample_requests(60, 40.0, seed=1)
    loop = _mk_loop(arrivals=iter(reqs), steal=False)
    loop.run(until=1.0)
    mid_done = sum(r.state == State.FINISHED for r in loop.requests)
    assert any(r.state != State.FINISHED for r in loop.requests)
    loop.run()
    assert all(r.state == State.FINISHED for r in reqs)
    assert sum(r.state == State.FINISHED for r in reqs) >= mid_done


# ---------------------------------------------------------------------------
# streaming + futures
# ---------------------------------------------------------------------------

def test_streaming_callbacks_and_futures():
    reqs = SHAREGPT.sample_requests(40, 30.0, seed=2)
    seen = []
    loop = _mk_loop(on_token=lambda r, t, tok: seen.append((r.rid, t)))
    handles = [loop.submit(r) for r in reqs]
    with pytest.raises(RuntimeError):
        handles[0].result()
    loop.run()
    assert all(h.done and not h.rejected for h in handles)
    for h in handles:
        assert h.result() is h.req
        # one stream event per emitted token, times nondecreasing
        assert len(h.tokens) == h.req.output_len
        times = [t for t, _ in h.tokens]
        assert times == sorted(times)
        assert h.tokens[0][0] == h.req.first_token_time
    assert len(seen) == sum(r.output_len for r in reqs)


def test_early_rejection_resolves_future_and_counts():
    # SLO nobody can meet -> every request early-rejected at the proxy
    sc = ServingConfig(sliders=Sliders(2, 2, 1024, 256))
    cluster = build_cluster(sc, SLO(ttft=1e-9, tpot=0.030),
                            taichi_flags={"early_rejection": True})
    loop = ServingLoop(cluster, SLO(ttft=1e-9, tpot=0.030))
    h = loop.submit(Request(prompt_len=500, max_new_tokens=8,
                            hidden_output_len=8))
    loop.run()
    assert h.done and h.rejected
    st = loop.stats(qps=1.0)
    assert st.early_rejections == 1
    assert st.summary()["early_rejections"] == 1
    assert loop.telemetry.total_rejected == 1


# ---------------------------------------------------------------------------
# telemetry
# ---------------------------------------------------------------------------

def test_telemetry_window_slides_and_scores():
    tw = TelemetryWindow(BAL, window=10.0)
    good = Request(prompt_len=10, max_new_tokens=4, arrival=0.0)
    good.record_token(1.0)                  # ttft 1.0 <= 1.5
    tw.on_token(good, 1.0)
    bad = Request(prompt_len=10, max_new_tokens=4, arrival=0.0)
    bad.record_token(5.0)                   # ttft 5.0 > 1.5
    tw.on_token(bad, 5.0)
    assert tw.ttft_attainment(6.0) == 0.5
    # the early event falls out of the window
    assert tw.ttft_attainment(12.0) == 0.0
    assert tw.ttft_attainment(30.0) is None

    fin = Request(prompt_len=10, max_new_tokens=3, arrival=0.0)
    fin.record_token(1.0)
    fin.record_token(1.01)
    fin.record_token(1.02)                  # tpot 10ms <= 30ms
    tw.on_finish(fin, 1.02)
    assert tw.tpot_attainment(2.0) == 1.0
    assert tw.goodput(10.0) > 0


def test_snapshot_gauges_and_json_export(tmp_path):
    reqs = SHAREGPT.sample_requests(50, 60.0, seed=5)
    loop = _mk_loop(arrivals=iter(reqs), snapshot_every=0.5)
    loop.run()
    assert loop.log.snapshots, "periodic snapshots must be recorded"
    snap = loop.log.snapshots[-1]
    for key in ("ttft_attainment", "goodput_rps", "throughput_tok_s",
                "instances", "tpot_inflight_attainment"):
        assert key in snap
    gauges = snap["instances"]
    assert {g["iid"] for g in gauges} == \
        {i.iid for i in loop.cluster.instances}
    assert all(0.0 <= g["hbm_util"] <= 1.0 for g in gauges)
    out = tmp_path / "metrics.json"
    loop.log.dump(str(out))
    data = json.loads(out.read_text())
    assert data["snapshots"][-1]["t"] == snap["t"]


def test_clocks():
    vc = VirtualClock()
    vc.sleep_until(5.0)
    assert vc.now == 5.0
    vc.sleep_until(1.0)                     # never goes backwards
    assert vc.now == 5.0
    wc = WallClock(start=3.0)
    assert 2.9 < wc.now < 3.5


# ---------------------------------------------------------------------------
# drain-and-flip
# ---------------------------------------------------------------------------

def test_drain_and_flip_preserves_in_flight_requests():
    reqs = SHAREGPT.sample_requests(80, 50.0, seed=7)
    loop = _mk_loop(arrivals=iter(reqs))
    cluster = loop.cluster
    loop.run(until=1.0)
    victim = max(cluster.instances,
                 key=lambda i: len(i.decoding) + len(i.pending_decode))
    n_inflight = len(victim.decoding) + len(victim.pending_decode)
    assert n_inflight > 0, "need in-flight decodes to drain"
    assert victim.itype == D_HEAVY
    assert loop.flip_role(victim, P_HEAVY, 1024)
    loop.run()
    assert victim.itype == P_HEAVY and victim.chunk_size == 1024
    assert victim.pending_flip is None and not victim.draining
    assert cluster.role_flip_count == 1
    assert cluster.drain_count > 0, "drained decodes travel as transfers"
    assert all(r.state == State.FINISHED for r in reqs)
    assert all(r.output_len == r.target_output_len for r in reqs)
    st = loop.stats(qps=50.0)
    assert st.role_flips == 1
    assert st.summary()["role_flips"] == 1


def test_flip_without_decodes_applies_immediately():
    loop = _mk_loop()
    inst = loop.cluster.instances[-1]
    assert inst.itype == D_HEAVY
    assert loop.cluster.request_role_flip(inst, P_HEAVY, 2048)
    assert inst.itype == P_HEAVY and inst.chunk_size == 2048
    assert loop.cluster.role_flip_count == 1
    # double-staging is refused while one is pending
    inst2 = loop.cluster.instances[0]
    inst2.begin_flip(D_HEAVY, 64)
    assert not loop.cluster.request_role_flip(inst2, D_HEAVY, 64)


def test_set_chunks_zero_requeues_stranded_prefills():
    loop = _mk_loop()
    d_inst = [i for i in loop.cluster.instances
              if i.itype == D_HEAVY][0]
    req = Request(prompt_len=300, max_new_tokens=8, hidden_output_len=8)
    d_inst.enqueue_prefill(req)
    loop.set_chunks(D_HEAVY, 0)
    assert not d_inst.prefill_queue, "queued prefill must be re-routed"
    assert any(req in i.prefill_queue for i in loop.cluster.instances
               if i.chunk_size > 0)


def test_steal_prefill_drains_imbalanced_queue():
    loop = _mk_loop()
    insts = loop.cluster.instances
    # pile a queue on one instance, leave the rest idle
    reqs = [Request(prompt_len=200, max_new_tokens=1,
                    hidden_output_len=1) for _ in range(12)]
    for r in reqs:
        insts[0].enqueue_prefill(r)
    loop.cluster._schedule_iter(insts[0], 0.0)
    loop.run()
    assert all(r.state == State.FINISHED for r in reqs)
    stolen = [i for i in insts[1:] if i.prefill_token_count > 0]
    assert stolen, "idle instances must steal queued prefill work"


# ---------------------------------------------------------------------------
# controller decision logic (stubbed loop)
# ---------------------------------------------------------------------------

class _FakeLoop:
    """Minimal ServingLoop facade for exercising controller decisions."""

    def __init__(self, instances, slo=BAL):
        class _C:
            pass
        self.cluster = _C()
        self.cluster.instances = instances
        self.slo = slo
        self.telemetry = TelemetryWindow(slo, window=10.0)
        self.chunk_calls = []
        self.flip_calls = []

    def set_chunks(self, itype, chunk):
        self.chunk_calls.append((itype, chunk))
        n = 0
        for i in self.cluster.instances:
            if i.itype == itype:
                i.chunk_size = chunk
                n += 1
        return n

    def flip_role(self, inst, itype, chunk):
        self.flip_calls.append((inst.iid, itype))
        inst.itype = itype
        inst.chunk_size = chunk
        return True


def _pool(cost, types=(P_HEAVY, P_HEAVY, D_HEAVY, D_HEAVY),
          chunks=(1024, 1024, 256, 256)):
    return [Instance(i, t, c, cost, SimExecutor(), hbm_blocks=512)
            for i, (t, c) in enumerate(zip(types, chunks))]


@pytest.fixture(scope="module")
def cost():
    return CostModel(get_config("qwen2.5-14b"), InstanceSpec(tp=4))


def _feed_ttft(tw, now, n_bad, n_good):
    for k in range(n_bad + n_good):
        r = Request(prompt_len=10, max_new_tokens=4, arrival=now - 0.5)
        r.record_token(now + (10.0 if k < n_bad else 0.1))
        tw.on_token(r, now)


def _feed_tpot(tw, now, n_bad, n_good, slo=BAL):
    for k in range(n_bad + n_good):
        r = Request(prompt_len=10, max_new_tokens=3, arrival=0.0)
        gap = slo.tpot * (3.0 if k < n_bad else 0.5)
        r.record_token(now - 2 * gap)
        r.record_token(now - gap)
        r.record_token(now)
        tw.on_finish(r, now)


def test_controller_raises_sd_when_ttft_starved(cost):
    loop = _FakeLoop(_pool(cost))
    ctl = SliderController(ControllerConfig(epoch=1.0, cooldown=0))
    ctl.bind(loop)
    _feed_ttft(loop.telemetry, 1.0, n_bad=3, n_good=7)   # att 0.7 < 0.87
    ctl.on_epoch(1.0)
    assert loop.chunk_calls == [(D_HEAVY, 512)]
    assert ctl.moves[-1]["kind"] == "chunk"


def test_controller_jumps_ladder_on_cratered_ttft(cost):
    loop = _FakeLoop(_pool(cost))
    ctl = SliderController(ControllerConfig(epoch=1.0, cooldown=0))
    ctl.bind(loop)
    _feed_ttft(loop.telemetry, 1.0, n_bad=9, n_good=1)   # att 0.1
    ctl.on_epoch(1.0)
    # jumps to the top of the ladder capped at S_P
    assert loop.chunk_calls == [(D_HEAVY, 1024)]


def test_controller_flips_dp_when_no_tpot_headroom(cost):
    insts = _pool(cost, chunks=(1024, 1024, 1024, 1024))  # S_D maxed
    loop = _FakeLoop(insts)
    ctl = SliderController(ControllerConfig(epoch=1.0, cooldown=0))
    ctl.bind(loop)
    _feed_ttft(loop.telemetry, 1.0, n_bad=5, n_good=5)
    ctl.on_epoch(1.0)
    assert loop.flip_calls and loop.flip_calls[0][1] == P_HEAVY
    assert sum(i.itype == D_HEAVY for i in insts) == 1   # min_d floor


def test_controller_lowers_sd_then_flips_pd_when_tpot_starved(cost):
    loop = _FakeLoop(_pool(cost, chunks=(1024, 1024, 64, 64)))
    ctl = SliderController(ControllerConfig(epoch=1.0, cooldown=0))
    ctl.bind(loop)
    _feed_tpot(loop.telemetry, 1.0, n_bad=5, n_good=5)
    ctl.on_epoch(1.0)                      # S_D already at floor -> flip
    assert loop.flip_calls and loop.flip_calls[0][1] == D_HEAVY


def test_controller_reverts_and_taboos_bad_raise(cost):
    loop = _FakeLoop(_pool(cost))
    ctl = SliderController(ControllerConfig(epoch=1.0, cooldown=0))
    ctl.bind(loop)
    _feed_ttft(loop.telemetry, 1.0, n_bad=3, n_good=7)
    ctl.on_epoch(1.0)                      # raise S_D 256 -> 512
    assert loop.chunk_calls == [(D_HEAVY, 512)]
    # next epoch: the raise broke TPOT -> revert + tabu, then escalate
    _feed_tpot(loop.telemetry, 2.0, n_bad=8, n_good=2)
    ctl.on_epoch(2.0)
    assert (D_HEAVY, 256) in loop.chunk_calls          # reverted
    assert any(m["kind"] == "revert" for m in ctl.moves)
    # a later ttft-starved epoch may not raise again while tabooed
    _feed_ttft(loop.telemetry, 3.0, n_bad=3, n_good=17)
    before = list(loop.chunk_calls)
    ctl.on_epoch(3.0)
    raised = [c for c in loop.chunk_calls[len(before):]
              if c[1] > 256]
    assert not raised, "sd-up must be tabooed after a revert"


def test_controller_pd_flip_floors_chunk_above_zero(cost):
    # all-P pool: _current_sd() is 0, but the flipped instance must get
    # a real chunk (chunk 0 would strand its queued prefills)
    insts = _pool(cost, types=(P_HEAVY, P_HEAVY, P_HEAVY, P_HEAVY),
                  chunks=(1024, 1024, 1024, 1024))
    loop = _FakeLoop(insts)
    ctl = SliderController(ControllerConfig(epoch=1.0, cooldown=0))
    ctl.bind(loop)
    _feed_tpot(loop.telemetry, 1.0, n_bad=6, n_good=4)
    ctl.on_epoch(1.0)
    assert loop.flip_calls and loop.flip_calls[0][1] == D_HEAVY
    flipped = [i for i in insts if i.itype == D_HEAVY]
    assert flipped and all(i.chunk_size > 0 for i in flipped)


def test_set_chunks_zero_reroute_resolves_rejections():
    slo = SLO(ttft=1e-9, tpot=0.030)       # nothing is feasible
    sc = ServingConfig(sliders=Sliders(2, 2, 1024, 256))
    cluster = build_cluster(sc, slo,
                            taichi_flags={"early_rejection": True})
    loop = ServingLoop(cluster, slo)
    d_inst = [i for i in cluster.instances if i.itype == D_HEAVY][0]
    req = Request(prompt_len=300, max_new_tokens=8, hidden_output_len=8)
    handle = loop._handles[req.rid] = __import__(
        "repro_torch.serving.server", fromlist=["RequestHandle"]
    ).RequestHandle(req)
    loop.requests.append(req)
    d_inst.enqueue_prefill(req)
    loop.set_chunks(D_HEAVY, 0)
    # the re-route was early-rejected: the future resolves, telemetry
    # and stats see the drop
    assert handle.done and handle.rejected
    assert req.state == State.REJECTED
    assert loop.telemetry.total_rejected == 1


def test_external_submit_arrival_clamped_to_now():
    reqs = SHAREGPT.sample_requests(30, 40.0, seed=9)
    loop = _mk_loop(arrivals=iter(reqs))
    loop.run(until=0.5)
    now = loop.cluster.now
    assert now > 0
    late = Request(prompt_len=64, max_new_tokens=4, hidden_output_len=4)
    h = loop.submit(late)                   # default arrival 0.0 -> now
    assert late.arrival >= now
    loop.run()
    assert h.done
    assert late.ttft() is not None and late.ttft() < now, \
        "TTFT must be measured from submission, not t=0"


def test_controller_holds_when_saturated_both_ways(cost):
    loop = _FakeLoop(_pool(cost))
    ctl = SliderController(ControllerConfig(epoch=1.0, cooldown=0))
    ctl.bind(loop)
    _feed_ttft(loop.telemetry, 1.0, n_bad=8, n_good=2)
    _feed_tpot(loop.telemetry, 1.0, n_bad=8, n_good=2)
    ctl.on_epoch(1.0)
    assert not loop.chunk_calls and not loop.flip_calls


# ---------------------------------------------------------------------------
# end-to-end: controller adapts on a small drift (structure, not goodput
# — the goodput comparison is benchmarks/controller_bench.py and its
# slow-tier test)
# ---------------------------------------------------------------------------

def test_controller_adapts_live_on_mini_drift():
    slo = SLO(ttft=1.2, tpot=0.024)
    drift = PhaseDriftSpec("mini", (
        Phase(PROMPT_HEAVY, 10.0, qps_scale=1.4),
        Phase(DECODE_HEAVY, 10.0, qps_scale=1.2)))
    sc = ServingConfig(sliders=Sliders(1, 3, 1024, 64), hbm_blocks=16384)
    cluster = build_cluster(sc, slo)
    ctl = SliderController(ControllerConfig(epoch=2.0, cooldown=1))
    loop = ServingLoop(cluster, slo,
                       arrivals=drift.iter_requests(18.0, seed=0,
                                                    max_new_tokens=512),
                       controller=ctl, window=4.0)
    loop.run()
    assert loop.requests, "drift must produce traffic"
    assert all(r.state == State.FINISHED for r in loop.requests), \
        "no request may be lost across controller moves"
    assert ctl.n_moves > 0, "the starved phases must trigger retunes"
    st = loop.stats(qps=18.0)
    assert st.slider_moves == ctl.n_moves
    assert st.summary()["slider_moves"] == ctl.n_moves


def test_phase_drift_iterator_contract():
    reqs = list(DRIFT.iter_requests(2.0, seed=0))
    arr = [r.arrival for r in reqs]
    assert arr == sorted(arr)
    assert arr[-1] < DRIFT.total_duration
    # phases actually differ: single-token burst then long generations
    first = [r for r in reqs if r.arrival < DRIFT.phases[0].duration]
    assert all(r.hidden_output_len == 1 for r in first)
    capped = DRIFT.sample_requests(5, 2.0, seed=0)
    assert len(capped) == 5
    assert [r.prompt_len for r in capped] == \
        [r.prompt_len for r in reqs[:5]]


# ---------------------------------------------------------------------------
# the port's loop against the reference's
# ---------------------------------------------------------------------------

def _loop_run(side, async_exec, horizon, controller):
    """One framework's ServingLoop over the seeded ShareGPT stream on the
    simulator's token oracle; returns (per-request times, snapshots,
    summary)."""
    if side == "reference":
        from repro.core.latency import SLO as S
        from repro.core.policies import Sliders as Sl
        from repro.serving import (ControllerConfig as CC, ServingLoop as SL,
                                   SliderController as SC)
        from repro.sim.simulator import ServingConfig as Cfg
        from repro.sim.simulator import build_cluster as build
        from repro.sim.workload import SHAREGPT as W
    else:
        S, Sl, CC, SL, SC = (SLO, Sliders, ControllerConfig, ServingLoop,
                             SliderController)
        Cfg, build, W = ServingConfig, build_cluster, SHAREGPT
    slo = S(ttft=1.5, tpot=0.030)
    cluster = build(Cfg(policy="taichi", sliders=Sl(2, 2, 1024, 256),
                        hbm_blocks=8192), slo, seed=2,
                    async_exec=async_exec)
    if horizon > 1:
        cluster.set_horizon(horizon)
    ctl = SC(CC(epoch=2.0, cooldown=1)) if controller else None
    loop = SL(cluster, slo, arrivals=W.iter_requests(35.0, seed=4, limit=90),
              controller=ctl, window=4.0, snapshot_every=1.0)
    loop.run()
    times = [(r.arrival, r.first_token_time, r.finish_time, r.output_len,
              r.state.value, r.ttft(), r.tpot()) for r in loop.requests]
    snaps = json.loads(json.dumps(loop.log.snapshots, default=str))
    return times, snaps, loop.stats(35.0).summary()


@pytest.mark.parametrize("async_exec,horizon,controller", [
    (False, 1, False), (True, 8, False), (True, 8, True)],
    ids=["sync-k1", "async-k8", "async-k8-controller"])
def test_port_loop_matches_the_reference_loop(monkeypatch, async_exec,
                                              horizon, controller):
    """Both loops schedule on the same hardware figures (the port's are
    the H100's, the reference's a TPU's): the port's clusters get the
    reference's."""
    import dataclasses

    from repro.core.hw import V5E
    from repro_torch.core.hw import HardwareSpec, InstanceSpec
    from repro_torch.sim import simulator
    hw = HardwareSpec(**dataclasses.asdict(V5E))
    monkeypatch.setattr(simulator, "InstanceSpec",
                        lambda tp: InstanceSpec(hw=hw, tp=tp))
    ref = _loop_run("reference", async_exec, horizon, controller)
    got = _loop_run("port", async_exec, horizon, controller)
    assert len(got[0]) == len(ref[0]) == 90
    assert got[0] == ref[0]
    assert got[1] == ref[1] and len(got[1]) > 3
    assert got[2] == ref[2]


def test_horizon_commit_streams_each_of_its_tokens():
    """A K-step horizon appends its K tokens before its K token events
    fire: each event streams its own token.  The reference streams the
    last one K times (its live tests emit one token id throughout, which
    hides it); the port deliberately differs."""
    from repro.engine.request import Request as JaxRequest
    from repro.serving import ServingLoop as JaxLoop
    from repro.sim.simulator import ServingConfig as JaxConfig
    from repro.sim.simulator import build_cluster as jax_build
    for Loop, Req, cluster, want in (
            (ServingLoop, Request, build_cluster(ServingConfig(), BAL),
             [5, 6, 7]),
            (JaxLoop, JaxRequest, jax_build(JaxConfig(), BAL), [7, 7, 7])):
        streamed = []
        loop = Loop(cluster, BAL,
                    on_token=lambda r, t, tok: streamed.append(tok))
        req = Req(prompt_len=4, max_new_tokens=8, hidden_output_len=8)
        handle = loop.submit(req)
        req.output_tokens.extend([5, 6, 7])
        for t in (1.0, 1.1, 1.2):
            loop._token_sink(req, t)
        assert streamed == want
        assert [tok for _, tok in handle.tokens] == want
