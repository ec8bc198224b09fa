"""The port's K-step decode horizon and non-blocking executor step.

Fast tier of the reference's ``tests/test_horizon.py`` on the port's
modules: decode-horizon packing, adaptive-K selection (prefill pressure,
drain barriers, TPOT headroom, HBM watermark, allocator grants), horizon
token-timestamp spreading, and the async dispatch/commit cluster on the
simulator's token oracle.

Then ``TorchExecutor(device="cpu")`` on numpy-made weights converted for
both frameworks: greedy K = 8 horizons token-exact against the
reference's ``JaxExecutor`` at K = 8 and against the port's K = 1 (paged
fp, paged int8, packed dense); EOS mid-horizon, single-token requests
with uneven budgets, preemption by recompute, a migration round trip
with the pipeline-flush guard, and readbacks per token <= 1/K.
Non-greedy horizons are held to distributional checks only: the two
frameworks draw different numbers."""
import numpy as np
import pytest

from repro_torch.core.cluster import Cluster
from repro_torch.core.instance import HORIZON_HBM_GUARD, Instance
from repro_torch.core.latency import SLO
from repro_torch.core.policies import Sliders
from repro_torch.engine import batching
from repro_torch.engine.engine import ImmediateStep, SimExecutor
from repro_torch.engine.request import Request, State
from repro_torch.sim.simulator import ServingConfig, build_cluster
from repro_torch.sim.workload import SHAREGPT

#: the reference's balanced SLO is sized to its TPU cost model (2 ms of
#: overhead an iteration); the port's H100 figures carry the card's
#: measured 4 ms of host enqueue a decode-only iteration and model
#: qwen2.5-3b's at ~11 ms, but its eager mixed iteration at less than
#: half the 54 ms it takes there.  Its clusters are held to the SLO
#: chip_smoke.py serves at.
BAL = SLO(ttft=5.0, tpot=0.2)


# ---------------------------------------------------------------------------
# fast tier: packing
# ---------------------------------------------------------------------------

def _table(bids, width=16):
    row = np.full(width, -1, np.int32)
    row[:len(bids)] = bids
    return row


def test_pack_decode_buckets_batch_and_tables():
    packed = batching.pack_decode(
        last_tokens=[7, 9, 3], positions=[4, 60, 17],
        budgets=[8, 8, 2],
        table_rows=[_table([2]), _table([7, 1, 3, 11, 4]),
                    _table([5, 6])],
        max_blocks=16, block_size=16)
    assert packed.tokens.shape == (4,)            # B pow2 padded
    # row 1's end-of-horizon frontier 60+8 needs 5 blocks -> NB pow2 = 8
    assert packed.tables.shape == (4, 8)
    np.testing.assert_array_equal(packed.tokens, [7, 9, 3, 0])
    np.testing.assert_array_equal(packed.start, [4, 60, 17, 0])
    np.testing.assert_array_equal(packed.budget, [8, 8, 2, 0])
    assert (packed.tables[3] == -1).all()         # pad row frozen+dropped


def test_pack_decode_nb_capped_at_max_blocks():
    packed = batching.pack_decode(
        last_tokens=[1], positions=[250], budgets=[8],
        table_rows=[_table(list(range(16)))], max_blocks=16,
        block_size=16)
    # frontier 258 would need 17 blocks; positions clamp on-device, so
    # the table caps at max_blocks instead of raising
    assert packed.tables.shape == (1, 16)


# ---------------------------------------------------------------------------
# fast tier: adaptive-K selection (flowing-decode budget)
# ---------------------------------------------------------------------------

def _sim_instance(max_horizon=8, hbm_blocks=4096, chunk=256, **kw):
    from repro_torch.configs import get_config
    from repro_torch.core.estimator import CostModel
    from repro_torch.core.hw import InstanceSpec
    cost = CostModel(get_config("qwen2.5-14b"), InstanceSpec(tp=4))
    return Instance(0, "D", chunk, cost, SimExecutor(),
                    hbm_blocks=hbm_blocks, max_horizon=max_horizon, **kw)


def _fake_decoding(inst, n=2, cur_tpot=None, out_len=8):
    """Install decoding requests with a controlled current_tpot."""
    for _ in range(n):
        r = Request(prompt_len=32, max_new_tokens=64)
        r.output_len = out_len
        r.tpot_reset_time = 0.0
        r.first_token_time = 0.0
        r.last_token_time = ((out_len - 1) * cur_tpot
                             if cur_tpot is not None else None)
        inst.decoding[r.rid] = r
        r.state = State.DECODE
    return list(inst.decoding.values())


def test_pick_horizon_pow2_ladder_and_idle():
    inst = _sim_instance(max_horizon=6)          # non-pow2 cap -> 4
    assert inst._pick_horizon() == 1             # no decodes
    _fake_decoding(inst)
    assert inst._pick_horizon() == 4
    inst.max_horizon = 8
    assert inst._pick_horizon() == 8
    inst.max_horizon = 1
    assert inst._pick_horizon() == 1


def test_pick_horizon_prefill_work_forces_one():
    inst = _sim_instance()
    _fake_decoding(inst)
    inst.prefill_queue.append(Request(prompt_len=64, max_new_tokens=8))
    assert inst._pick_horizon() == 1, \
        "a queued chunked prefill must not wait K steps"


def test_pick_horizon_drain_barrier_forces_one():
    inst = _sim_instance()
    _fake_decoding(inst)
    inst.begin_flip("P", 512)
    assert inst._pick_horizon() == 1, \
        "drain-and-flip needs per-step scheduling to evacuate"


def test_pick_horizon_hbm_guard():
    inst = _sim_instance(hbm_blocks=100)
    _fake_decoding(inst)
    inst.allocator.allocate(999, int(16 * 100 * HORIZON_HBM_GUARD) + 32)
    assert inst.allocator.utilization() > HORIZON_HBM_GUARD
    assert inst._pick_horizon() == 1, \
        "near the watermark, degradation must flow per-step"


def test_pick_horizon_tpot_headroom_bands():
    inst = _sim_instance(tpot_slo=0.030, tpot_alpha=1.0)
    _fake_decoding(inst, cur_tpot=0.010)         # 33% of threshold
    assert inst._pick_horizon(now=1.0) == 8
    inst.decoding.clear()
    _fake_decoding(inst, cur_tpot=0.020)         # ~67%
    assert inst._pick_horizon(now=1.0) == 4
    inst.decoding.clear()
    _fake_decoding(inst, cur_tpot=0.024)         # 80%
    assert inst._pick_horizon(now=1.0) == 2
    inst.decoding.clear()
    _fake_decoding(inst, cur_tpot=0.029)         # ~97%: about to flow
    assert inst._pick_horizon(now=1.0) == 1


def test_build_plan_budgets_capped_by_remaining_output():
    inst = _sim_instance()
    reqs = _fake_decoding(inst, n=2, out_len=8)
    reqs[0].max_new_tokens = 11                  # 3 tokens left
    reqs[0].hidden_output_len = None
    for r in reqs:
        inst.allocator.allocate(r.rid, r.context_len + 64)
    plan = inst.build_plan()
    assert plan.horizon == 8
    by_rid = dict(zip([r.rid for r in plan.decode_reqs],
                      plan.decode_budgets))
    assert by_rid[reqs[0].rid] == 3
    assert by_rid[reqs[1].rid] == 8


def test_build_plan_horizon_collapses_to_max_grant():
    inst = _sim_instance()
    reqs = _fake_decoding(inst, n=2, out_len=8)
    for r in reqs:
        r.max_new_tokens = 9                     # 1 token left each
        r.hidden_output_len = None
        inst.allocator.allocate(r.rid, r.context_len + 64)
    plan = inst.build_plan()
    assert plan.horizon == 1, \
        "no row can use K>1 — don't compile/waste an 8-step loop"


def test_horizon_timestamps_spread_like_k1(monkeypatch):
    """A K-horizon's tokens are stamped at the per-step modeled times,
    summing to the K=1 schedule's total — the in-flight TPOT signal
    then reads per-step latency, not duration/1."""
    inst = _sim_instance(max_horizon=4)
    req = Request(prompt_len=32, max_new_tokens=64, hidden_output_len=64,
                  prompt_tokens=list(range(1, 33)))
    inst.enqueue_prefill(req)
    inst.run_iteration(0.0)                      # prefill + first token
    inst.admit_decode(req)
    sink = []
    inst.token_sink = lambda r, t: sink.append(t)
    dur, _, _ = inst.run_iteration(1.0)
    assert inst.last_horizon == 4 and len(sink) == 4
    assert all(b > a for a, b in zip(sink, sink[1:]))
    assert sink[-1] == pytest.approx(1.0 + dur)
    # per-step gaps equal the cost model's single-iteration times
    ctx = req.context_len - 4
    exp = [inst.cost.iteration_time([], [ctx + s]) for s in range(4)]
    gaps = [b - a for a, b in zip([1.0] + sink, sink)]
    assert gaps == pytest.approx(exp)
    assert req.current_tpot(sink[-1]) == pytest.approx(
        (sink[-1] - req.first_token_time) / (req.output_len - 1))


def test_sim_executor_step_async_contract():
    step = SimExecutor().step_async(plan=None)
    assert isinstance(step, ImmediateStep)
    assert step.ready() and not step.resolved
    assert step.resolve() == {} and step.resolved


# ---------------------------------------------------------------------------
# fast tier: async dispatch/commit cluster pipeline (sim oracle)
# ---------------------------------------------------------------------------

def _run_cluster(async_exec, horizon, qps=60, n=150, seed=0):
    sc = ServingConfig(policy="taichi",
                       sliders=Sliders(2, 2, 1024, 256),
                       hbm_blocks=8192)
    cluster = build_cluster(sc, BAL, seed=seed, async_exec=async_exec)
    if horizon > 1:
        cluster.set_horizon(horizon)
    reqs = SHAREGPT.sample_requests(n, qps, seed=seed)
    cluster.run(reqs)
    return cluster, reqs


def test_async_cluster_completes_all_requests():
    cluster, reqs = _run_cluster(async_exec=True, horizon=8)
    assert all(r.state == State.FINISHED for r in reqs)
    assert all(r.output_len == r.target_output_len for r in reqs)
    assert all(r.first_token_time <= r.last_token_time for r in reqs)
    assert any(i.horizon_peak > 1 for i in cluster.instances), \
        "the horizon never engaged"


def test_async_cluster_token_totals_match_sync():
    _, sync_reqs = _run_cluster(async_exec=False, horizon=1)
    _, async_reqs = _run_cluster(async_exec=True, horizon=8)
    assert (sum(r.output_len for r in sync_reqs)
            == sum(r.output_len for r in async_reqs))


def test_async_cluster_survives_role_flip():
    sc = ServingConfig(policy="taichi", sliders=Sliders(1, 1, 1024, 256),
                       hbm_blocks=8192)
    cluster = build_cluster(sc, BAL, async_exec=True)
    cluster.set_horizon(8)
    reqs = SHAREGPT.sample_requests(80, 40, seed=3)
    for r in reqs:
        cluster.submit(r)
    d_inst = next(i for i in cluster.instances if i.itype == "D")
    flipped = False
    while cluster.peek_time() is not None:
        cluster.step()
        if not flipped and d_inst.decoding:
            assert cluster.request_role_flip(d_inst, "P", 1024)
            flipped = True
    assert flipped and d_inst.itype == "P"
    assert all(r.state == State.FINISHED for r in reqs)
    assert all(r.output_len == r.target_output_len for r in reqs)


def test_async_serving_loop_telemetry_consistent():
    from repro_torch.serving import ServingLoop
    sc = ServingConfig(policy="taichi", sliders=Sliders(2, 2, 1024, 256),
                       hbm_blocks=8192)
    cluster = build_cluster(sc, BAL, async_exec=True)
    cluster.set_horizon(8)
    arrivals = SHAREGPT.iter_requests(40, seed=1)
    loop = ServingLoop(cluster, BAL,
                       arrivals=(r for r, _ in zip(arrivals, range(60))))
    loop.run()
    assert all(r.state in (State.FINISHED, State.REJECTED)
               for r in loop.requests)
    done = [r for r in loop.requests if r.state == State.FINISHED]
    # every emitted token reached the telemetry sink, exactly once
    assert loop.telemetry.total_tokens == sum(r.output_len for r in done)
    assert loop.telemetry.total_finished == len(done)
    snap = loop.telemetry.snapshot(cluster.now, cluster.instances)
    assert {"horizon", "inflight"} <= set(snap["instances"][0])




# ---------------------------------------------------------------------------
# the real engine on the CPU, against the reference's JaxExecutor
# ---------------------------------------------------------------------------

import torch  # noqa: E402

from repro.configs import reduced_config as jax_reduced  # noqa: E402
from repro.core.estimator import CostModel as JaxCostModel  # noqa: E402
from repro.core.hw import InstanceSpec as JaxInstanceSpec  # noqa: E402
from repro.core.instance import D_HEAVY as J_D_HEAVY  # noqa: E402
from repro.core.instance import Instance as JaxInstance  # noqa: E402
from repro.engine.engine import JaxExecutor  # noqa: E402
from repro.engine.request import Request as JaxRequest  # noqa: E402
from repro.engine.request import State as JaxState  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.core.estimator import CostModel  # noqa: E402
from repro_torch.core.hw import InstanceSpec  # noqa: E402
from repro_torch.core.instance import D_HEAVY  # noqa: E402
from repro_torch.engine.engine import TorchExecutor  # noqa: E402

from test_torch_helpers import (both_params,  # noqa: E402,F401
                                copying_reference)


class Side:
    """One framework's executor, instance and request classes."""

    def __init__(self, torch_side, cfg, params):
        self.torch_side, self.cfg, self.params = torch_side, cfg, params
        if torch_side:
            self.Request, self.Instance, self.D = Request, Instance, D_HEAVY
            self.State = State
            self.cost = CostModel(cfg, InstanceSpec(tp=1))
        else:
            self.Request, self.Instance = JaxRequest, JaxInstance
            self.D, self.State = J_D_HEAVY, JaxState
            self.cost = JaxCostModel(cfg, JaxInstanceSpec(tp=1))

    def executor(self, n_slots, **kw):
        common = dict(n_slots=n_slots, max_seq=256, t_buckets=(8, 16, 32),
                      **kw)
        if self.torch_side:
            return TorchExecutor(self.cfg, self.params, device="cpu",
                                 **common)
        return JaxExecutor(self.cfg, self.params, **common)

    def instance(self, ex, chunk=32, max_horizon=8):
        return self.Instance(0, self.D, chunk, self.cost, ex,
                             hbm_blocks=512, max_horizon=max_horizon)


@pytest.fixture(scope="module")
def sides():
    cj, ct = jax_reduced("smollm-135m"), reduced_config("smollm-135m")
    pj, pt = both_params(cj, ct, seed=17)
    return Side(False, cj, pj), Side(True, ct, pt)


def _prompts(cfg, seed, lengths=(13, 29, 7, 40)):
    rng = np.random.default_rng(seed)
    return [[int(x) for x in rng.integers(1, cfg.vocab_size, size=n)]
            for n in lengths]


def _generate(side, prompts, n_out, *, max_horizon, paged=None,
              eos_id=None, chunk=32, preempt_after=None, n_tokens=None,
              kv_quant=None):
    ex = side.executor(len(prompts) + 1, paged=paged, eos_id=eos_id,
                       kv_quant=kv_quant)
    inst = side.instance(ex, chunk, max_horizon)
    reqs = [side.Request(prompt_len=len(p),
                         max_new_tokens=n_tokens[i] if n_tokens else n_out,
                         hidden_output_len=None if eos_id is not None
                         else (n_tokens[i] if n_tokens else n_out),
                         prompt_tokens=list(p))
            for i, p in enumerate(prompts)]
    for r in reqs:
        inst.enqueue_prefill(r)
    preempted = False
    now, guard = 0.0, 0
    finished = lambda: all(r.done() or r.state == side.State.FINISHED
                           for r in reqs)
    while not finished() and guard < 500:
        dur, done, _ = inst.run_iteration(now)
        now += dur
        guard += 1
        for r in done:
            inst.admit_decode(r)
        if preempt_after is not None and not preempted:
            victim = reqs[0]
            if victim.rid in inst.decoding \
                    and victim.output_len >= preempt_after:
                inst._preempt(victim)
                preempted = True
    assert finished()
    assert preempt_after is None or preempted
    return [r.output_tokens for r in reqs], ex, inst


PATHS = {"paged-fp": dict(paged=True),
         "paged-int8": dict(paged=True, kv_quant="int8"),
         "dense-packed": dict(paged=False)}


@pytest.mark.parametrize("path", sorted(PATHS))
def test_horizon_k8_matches_reference_k8_and_port_k1(sides, path,
                                                     copying_reference):
    """Greedy K = 8 streams of the port equal the reference's (its host
    inputs copied: ``test_torch_helpers.CopyingJnp``; without, its
    packed-dense K = 8 stream left its own K = 1 stream in two of three
    runs) and the port's K = 1 streams."""
    jax_side, torch_side = sides
    kw = PATHS[path]
    prompts = _prompts(torch_side.cfg, 0)
    ref, jex, _ = _generate(jax_side, prompts, 24, max_horizon=8, **kw)
    got, ex, inst = _generate(torch_side, prompts, 24, max_horizon=8, **kw)
    k1, ex1, _ = _generate(torch_side, prompts, 24, max_horizon=1, **kw)
    assert got == ref, "K-step horizon must be greedy token-exact"
    assert got == k1
    assert ex.paged == (path != "dense-packed") and ex.horizon_capable
    assert ex.horizon_calls == jex.horizon_calls > 0
    assert ex.horizon_tokens == jex.horizon_tokens > 0
    assert max(inst.horizon_hist) == 8
    assert ex1.horizon_calls == ex1.horizon_tokens == 0
    if ex.paged:
        ex.kv.check_invariants()


def test_horizon_eos_mid_horizon_freezes_row(sides, copying_reference):
    jax_side, torch_side = sides
    prompts = _prompts(torch_side.cfg, 2, lengths=(17, 23))
    base, _, _ = _generate(torch_side, prompts, 20, max_horizon=1)
    # a token the first request emits mid-stream becomes EOS: the K=8
    # loop must freeze that row at the step where K=1 stops
    eos = base[0][10]
    k1, _, _ = _generate(torch_side, prompts, 20, max_horizon=1,
                         eos_id=eos)
    k8, ex, _ = _generate(torch_side, prompts, 20, max_horizon=8,
                          eos_id=eos)
    ref, _, _ = _generate(jax_side, prompts, 20, max_horizon=8, eos_id=eos,
                          paged=True)
    assert k8 == k1 == ref
    assert len(k8[0]) <= 11 and k8[0][-1] == eos
    assert ex.horizon_calls > 0


def test_horizon_single_token_and_uneven_budgets(sides):
    """max_new_tokens=1 finishes at prefill (never decodes); a 2-token
    request gets a 1-step budget inside a K=8 schedule."""
    _, torch_side = sides
    prompts = _prompts(torch_side.cfg, 3, lengths=(9, 21, 33))
    n_tokens = [1, 2, 24]
    base, _, _ = _generate(torch_side, prompts, None, max_horizon=1,
                           n_tokens=n_tokens)
    hor, ex, _ = _generate(torch_side, prompts, None, max_horizon=8,
                           n_tokens=n_tokens)
    assert hor == base
    assert [len(t) for t in hor] == n_tokens
    assert ex.horizon_calls > 0


def test_horizon_preemption_recompute_parity(sides):
    _, torch_side = sides
    prompts = _prompts(torch_side.cfg, 4, lengths=(23, 41))
    base, _, _ = _generate(torch_side, prompts, 16, max_horizon=1)
    pre, ex, inst = _generate(torch_side, prompts, 16, max_horizon=8,
                              preempt_after=6)
    assert pre == base, (
        "preemption-by-recompute under a K-step horizon must recover "
        "the exact greedy stream (recompute_offset semantics)")
    assert inst.preemptions == 0 and ex.horizon_calls > 0


def test_horizon_migration_round_trip_and_flush_guard(sides):
    _, side = sides
    prompts = _prompts(side.cfg, 5, lengths=(19,))
    base, _, _ = _generate(side, prompts, 40, max_horizon=1)
    ex_a = side.executor(2, paged=True)
    ex_b = side.executor(2, paged=True)
    a, b = side.instance(ex_a), side.instance(ex_b)
    req = Request(prompt_len=19, max_new_tokens=40, hidden_output_len=40,
                  prompt_tokens=list(prompts[0]))
    a.enqueue_prefill(req)
    now, guard = 0.0, 0
    while req.output_len < 7 and guard < 100:
        dur, done, _ = a.run_iteration(now)
        now += dur
        guard += 1
        for r in done:
            a.admit_decode(r)
    # pipeline-flush guard: an eject mid-flight must fail loudly
    assert a.dispatch_iteration(now) is not None
    with pytest.raises(RuntimeError, match="in flight"):
        ex_a.extract_state(req)
    res = a.commit_iteration()          # flush: now ejecting is legal
    assert res.duration > 0
    state = a.eject(req)
    b.inject(req, state)
    guard = 0
    while not req.done() and guard < 100:
        dur, _, _ = b.run_iteration(now)
        now += dur
        guard += 1
    assert req.output_tokens == base[0], (
        "migration between horizon engines must preserve the stream")
    assert ex_a.horizon_calls > 0 and ex_b.horizon_calls > 0
    ex_b.kv.check_invariants()


def test_readbacks_per_token_bounded_by_horizon(sides):
    """In the decode phase, host readbacks per generated token <= 1/K."""
    _, side = sides
    prompts = _prompts(side.cfg, 6, lengths=(11, 17, 23, 29))
    ex = side.executor(5, paged=True)
    inst = side.instance(ex, chunk=64)
    reqs = [Request(prompt_len=len(p), max_new_tokens=33,
                    hidden_output_len=33, prompt_tokens=list(p))
            for p in prompts]
    for r in reqs:
        inst.enqueue_prefill(r)
    now, guard = 0.0, 0
    while any(r.prefill_remaining > 0 for r in reqs) and guard < 100:
        dur, done, _ = inst.run_iteration(now)
        now += dur
        guard += 1
        for r in done:
            inst.admit_decode(r)
    rb0, tok0 = ex.host_readbacks, inst.decode_token_count
    while not all(r.done() for r in reqs) and guard < 300:
        dur, _, _ = inst.run_iteration(now)
        now += dur
        guard += 1
    tokens = inst.decode_token_count - tok0
    readbacks = ex.host_readbacks - rb0
    assert tokens >= 100
    assert readbacks * 8 <= tokens, (
        f"{readbacks} readbacks for {tokens} tokens breaks the <=1/K "
        "bound")


# ---------------------------------------------------------------------------
# non-greedy: distributional only
# ---------------------------------------------------------------------------

def test_sampler_draws_from_the_softmax(sides):
    """The on-device sampler (argmax of p / E, E ~ Exp(1)) draws token i
    with probability softmax(logits / T)_i: 40000 draws over a 6-token
    vocabulary land within 5 standard deviations of it."""
    _, side = sides
    ex = side.executor(2, paged=True, greedy=False, temperature=0.7,
                       seed=3)
    logits = torch.tensor([1.0, 0.0, -1.0, 2.0, 0.5, -3.0])
    n = 40000
    draws = ex._sample_on_device(logits.expand(n, -1)).numpy()
    p = torch.softmax(logits / 0.7, dim=0).numpy()
    freq = np.bincount(draws, minlength=6) / n
    assert np.all(np.abs(freq - p) <= 5 * np.sqrt(p * (1 - p) / n))


def test_nongreedy_horizon_emits_budgeted_tokens(sides):
    """A non-greedy K = 8 horizon emits every budgeted token from the
    vocabulary; another seed draws another stream, the same seed the
    same stream."""
    _, side = sides
    prompts = _prompts(side.cfg, 7, lengths=(12, 30))

    def run(seed):
        ex = side.executor(3, paged=True, greedy=False, seed=seed)
        inst = side.instance(ex)
        reqs = [Request(prompt_len=len(p), max_new_tokens=20,
                        hidden_output_len=20, prompt_tokens=list(p))
                for p in prompts]
        for r in reqs:
            inst.enqueue_prefill(r)
        now, guard = 0.0, 0
        while not all(r.done() for r in reqs) and guard < 200:
            dur, done, _ = inst.run_iteration(now)
            now += dur
            guard += 1
            for r in done:
                inst.admit_decode(r)
        assert ex.horizon_calls > 0
        return [r.output_tokens for r in reqs]

    a, b, c = run(1), run(1), run(2)
    assert [len(t) for t in a] == [20, 20]
    assert all(0 <= t < side.cfg.vocab_size for row in a for t in row)
    assert a == b and a != c
