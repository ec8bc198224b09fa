"""The KV tiers' tensor legs of ``TorchExecutor(device="cpu")`` against
the reference's ``JaxExecutor`` on the same numpy-made weights (reduced
smollm-135m, float32): the host spill tier's eviction and promotion,
hot-prefix replication (``export_prefix_blocks`` /
``import_prefix_blocks``), checkpoint blocks for warm recovery
(``export_request_blocks``) and a warm recovery that lands them.

Tolerances: greedy tokens and int8 pool values exact; float32 pool values
within 1e-5 of the reference's (the two stacks differ by ~1e-6); the
port's own round trips (spill and promotion, export and import) bit for
bit."""
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jax_reduced
from repro.core.estimator import CostModel as JaxCostModel
from repro.core.hw import InstanceSpec as JaxInstanceSpec
from repro.core.instance import D_HEAVY as J_D_HEAVY
from repro.core.instance import Instance as JaxInstance
from repro.core.latency import SLO as JaxSLO
from repro.core.policies import Sliders as JaxSliders
from repro.engine.engine import JaxExecutor
from repro.engine.engine import MigrationFormatError as JaxFormatError
from repro.engine.request import Request as JaxRequest
from repro.serving import ServingLoop as JaxServingLoop
from repro.sim.simulator import ServingConfig as JaxServingConfig
from repro.sim.simulator import build_cluster as jax_build_cluster
from repro_torch.configs import reduced_config
from repro_torch.core.estimator import CostModel
from repro_torch.core.hw import InstanceSpec
from repro_torch.core.instance import D_HEAVY, Instance
from repro_torch.core.latency import SLO
from repro_torch.core.policies import Sliders
from repro_torch.engine.engine import MigrationFormatError, TorchExecutor
from repro_torch.engine.request import Request
from repro_torch.serving import ServingLoop
from repro_torch.serving.faults import CRASH, RECOVER, Fault, FaultInjector
from repro_torch.serving.recovery import RecoveryConfig
from repro_torch.sim.simulator import ServingConfig, build_cluster

from test_torch_helpers import both_params, copying_reference  # noqa: F401

# the reference's host arrays may alias its in-flight inputs on the CPU
pytestmark = pytest.mark.usefixtures("copying_reference")

FLOAT_ATOL = 1e-5
QUANTS = pytest.mark.parametrize("quant", [None, "int8"], ids=["fp", "int8"])


class Side:
    """One framework's classes behind the same names."""

    def __init__(self, torch_side: bool, params, cfg):
        self.torch_side = torch_side
        self.params, self.cfg = params, cfg
        if torch_side:
            self.Request, self.Instance = Request, Instance
            self.cost = CostModel(cfg, InstanceSpec(tp=1))
            self.FormatError = MigrationFormatError
        else:
            self.Request, self.Instance = JaxRequest, JaxInstance
            self.cost = JaxCostModel(cfg, JaxInstanceSpec(tp=1))
            self.FormatError = JaxFormatError

    def make(self, *, quant=None, spill=0, hbm_blocks=None, chunk=32,
             n_slots=4):
        """The reference's ``tests/test_kv_tiers_live.py::_make``."""
        kw = dict(n_slots=n_slots, max_seq=256, batched=True,
                  t_buckets=(8, 16, 32), paged=True, prefix_cache=True,
                  hbm_blocks=hbm_blocks, kv_quant=quant,
                  kv_spill_blocks=spill)
        ex = (TorchExecutor(self.cfg, self.params, device="cpu", **kw)
              if self.torch_side else JaxExecutor(self.cfg, self.params,
                                                  **kw))
        inst = self.Instance(0, D_HEAVY if self.torch_side else J_D_HEAVY,
                             chunk, self.cost, ex, hbm_blocks=512)
        return ex, inst

    def req(self, prompt, n_out=5):
        return self.Request(prompt_len=len(prompt), max_new_tokens=n_out,
                            hidden_output_len=n_out,
                            prompt_tokens=list(prompt))


@pytest.fixture(scope="module")
def sides():
    cj, ct = jax_reduced("smollm-135m"), reduced_config("smollm-135m")
    pj, pt = both_params(cj, ct, seed=31)
    return Side(False, pj, cj), Side(True, pt, ct)


def _drive(inst, reqs, guard=300):
    now, g = 0.0, 0
    while not all(r.done() for r in reqs) and g < guard:
        dur, done, _ = inst.run_iteration(now)
        now += dur
        g += 1
        for r in done:
            inst.admit_decode(r)
    assert all(r.done() for r in reqs)


def _prompts(cfg, seed, *lengths):
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(1, cfg.vocab_size, size=n)))
            for n in lengths]


def _ref_leaves(tree):
    """The reference's block payload (its pool's ``segments`` tree: one
    segment of one attention position on smollm) as {leaf name: numpy}."""
    return {name: np.asarray(a) for name, a in tree[0][0].items()}


def _assert_leaves_match(got, ref):
    """Port payload (host tensors) against the reference's, leaf for
    leaf: int8 values exact, float32 within FLOAT_ATOL."""
    assert set(got) == set(ref)
    for name, t in got.items():
        assert t.device.type == "cpu"
        a = t.numpy()
        assert a.shape == ref[name].shape and a.dtype == ref[name].dtype
        if a.dtype == np.int8:
            np.testing.assert_array_equal(a, ref[name], err_msg=name)
        else:
            np.testing.assert_allclose(a, ref[name], atol=FLOAT_ATOL,
                                       rtol=0, err_msg=name)


def _assert_bit_equal(a, b, blocks=None, bs=16):
    assert set(a) == set(b)
    n = None if blocks is None else blocks * bs
    for name in a:
        assert torch.equal(a[name][:, :n], b[name][:, :n]), name


# ---------------------------------------------------------------------------
# host spill tier
# ---------------------------------------------------------------------------

def _spill_round_trip(side, quant):
    """``tests/test_kv_tiers_live.py::test_spill_prefetch_decode_token_
    exact`` on one side: the hot prefix is evicted to the host by a cold
    prompt that needs the pool, then promoted for its next hit."""
    hot, cold = _prompts(side.cfg, 22, 64, 128)
    ex0, inst0 = side.make(quant=quant)
    ctl = side.req(hot)
    inst0.enqueue_prefill(ctl)
    _drive(inst0, [ctl])

    ex, inst = side.make(quant=quant, spill=16, hbm_blocks=12)
    pc = ex.prefix_cache_obj
    a = side.req(hot)
    inst.enqueue_prefill(a)
    _drive(inst, [a])
    assert pc.match_tokens(hot + [0]) == 64
    before = (ex.export_prefix_blocks(hot) if side.torch_side else None)
    b = side.req(cold)
    inst.enqueue_prefill(b)
    _drive(inst, [b])
    spilled = pc.spilled_blocks
    assert spilled >= 4 and pc.match_tokens(hot + [0]) == 0
    c = side.req(hot)
    inst.enqueue_prefill(c)
    _drive(inst, [c])
    out = dict(tokens=[ctl.output_tokens, a.output_tokens, c.output_tokens],
               spilled=spilled, promoted=pc.spill.promoted,
               promoted_tokens=inst.spill_promoted_tokens,
               cached=c.cached_prefix_len)
    al = pc.allocator
    assert al.free_blocks + al.cached_blocks + al.used_blocks == 12
    if side.torch_side:
        # the promoted blocks hold what the pool held before eviction
        after = ex.export_prefix_blocks(hot)
        _assert_bit_equal(after["paged_blocks"], before["paged_blocks"],
                          blocks=out["promoted_tokens"] // 16)
        ex.kv.check_invariants()
    return out


@QUANTS
def test_spill_then_promotion_token_exact(sides, quant):
    jax_side, torch_side = sides
    ref = _spill_round_trip(jax_side, quant)
    got = _spill_round_trip(torch_side, quant)
    assert got == ref
    assert got["promoted"] >= 3 and got["promoted_tokens"] >= 48
    assert got["cached"] >= 48
    assert got["tokens"][0] == got["tokens"][1] == got["tokens"][2]


def test_spill_payload_is_a_host_copy_of_every_leaf(sides):
    """``fetch_block`` copies a block's slice of every pool leaf (an int8
    pool's scales too) to the host; ``load_block`` lands it in place in
    another block, bit for bit."""
    _, side = sides
    ex, inst = side.make(quant="int8", spill=4)
    r = side.req(_prompts(side.cfg, 23, 40)[0])
    inst.enqueue_prefill(r)
    _drive(inst, [r])
    pool = ex.kv.pool
    leaves = {name: leaf for name, leaf in pool.items()}
    payload = ex.fetch_block(1)
    assert set(payload) == {"k", "v", "k_scale", "v_scale"}
    for name, t in payload.items():
        assert t.device.type == "cpu"
        assert t.data_ptr() != pool[name].data_ptr()
        assert torch.equal(t, pool[name][:, 16:32])
    ex.load_block(7, payload)
    for name, leaf in pool.items():
        assert leaf is leaves[name]                       # in place
        assert torch.equal(leaf[:, 112:128], pool[name][:, 16:32])
    with pytest.raises(ValueError, match="do not match"):
        ex.load_block(7, {k: v for k, v in payload.items()
                          if not k.endswith("scale")})


# ---------------------------------------------------------------------------
# hot-prefix replication
# ---------------------------------------------------------------------------

def _warm_source(side, quant):
    shared, tail = _prompts(side.cfg, 24, 48, 13)
    ex, inst = side.make(quant=quant)
    warm = side.req(shared + tail)
    inst.enqueue_prefill(warm)
    _drive(inst, [warm])
    return ex, shared, tail


@QUANTS
def test_export_prefix_payload_matches_reference(sides, quant):
    (jax_side, torch_side) = sides
    ex_j, shared, _ = _warm_source(jax_side, quant)
    ex_t, shared_t, _ = _warm_source(torch_side, quant)
    assert shared == shared_t
    ref = ex_j.export_prefix_blocks(shared)
    got = ex_t.export_prefix_blocks(shared)
    for key in ("n_blocks", "tokens", "kv_format"):
        assert got[key] == ref[key], key
    assert got["n_blocks"] == 3 and got["kv_format"] == (quant or "fp")
    _assert_leaves_match(got["paged_blocks"],
                         _ref_leaves(ref["paged_blocks"]))
    # side-effect free: a second export gives the same blocks, no touch
    again = ex_t.export_prefix_blocks(shared)
    _assert_bit_equal(again["paged_blocks"], got["paged_blocks"])
    assert ex_t.export_prefix_blocks(shared[:15]) is None


def _replicate_and_decode(side, quant):
    """``tests/test_kv_tiers_live.py::test_replicated_prefix_blocks_
    decode_token_exact`` on one side."""
    ex_src, shared, tail = _warm_source(side, quant)
    state = ex_src.export_prefix_blocks(shared)
    ex_dst, inst_dst = side.make(quant=quant)
    landed = ex_dst.import_prefix_blocks(state)
    assert ex_dst.prefix_cache_obj.match_tokens(shared + [0]) == 48
    assert ex_dst.import_prefix_blocks(state) == 0     # already resident
    if side.torch_side:
        _assert_bit_equal(ex_dst.export_prefix_blocks(shared)
                          ["paged_blocks"], state["paged_blocks"])
    ex0, inst0 = side.make(quant=quant)
    probe0 = side.req(shared + tail[:5])
    inst0.enqueue_prefill(probe0)
    _drive(inst0, [probe0])
    probe = side.req(shared + tail[:5])
    inst_dst.enqueue_prefill(probe)
    _drive(inst_dst, [probe])
    assert probe.cached_prefix_len == 48               # replica used
    return landed, probe.output_tokens, probe0.output_tokens


@QUANTS
def test_import_then_decode_token_exact(sides, quant):
    jax_side, torch_side = sides
    ref = _replicate_and_decode(jax_side, quant)
    got = _replicate_and_decode(torch_side, quant)
    assert got == ref
    landed, probe, local = got
    assert landed == 3 and probe == local


@pytest.mark.parametrize("src,dst", [(None, "int8"), ("int8", None)],
                         ids=["fp-into-int8", "int8-into-fp"])
def test_cross_format_import_raises(sides, src, dst):
    for side in sides:
        ex_src, shared, _ = _warm_source(side, src)
        state = ex_src.export_prefix_blocks(shared)
        ex_dst, _ = side.make(quant=dst)
        with pytest.raises(side.FormatError, match="cross-format"):
            ex_dst.import_prefix_blocks(state)
        assert ex_dst.prefix_cache_obj.match_tokens(shared + [0]) == 0
        # a bookkeeping-only payload of the right format lands nothing
        state = dict(state, paged_blocks=None,
                     kv_format=dst or "fp")
        assert ex_dst.import_prefix_blocks(state) == 0


# ---------------------------------------------------------------------------
# checkpoint blocks
# ---------------------------------------------------------------------------

def _request_blocks(side, quant):
    prompt = _prompts(side.cfg, 25, 41)[0]
    ex, inst = side.make(quant=quant)
    r = side.req(prompt, 6)
    inst.enqueue_prefill(r)
    now = 0.0
    while r.prefill_remaining > 0:
        dur, _, _ = inst.run_iteration(now)
        now += dur
    inst.admit_decode(r)
    inst.run_iteration(now)
    assert ex.export_request_blocks(side.req([1, 2]), [0]) is None
    out = ex.export_request_blocks(r, [0, 2, 1, 7, -1])
    if side.torch_side:
        # each entry equals the pool slice it names
        bids = ex.kv.allocator.owned(r.rid)
        for i, entry in out.items():
            at = bids[i] * 16
            for name, leaf in ex.kv.pool.items():
                assert torch.equal(entry["kv"][name], leaf[:, at:at + 16])
    # while a step is dispatched and unresolved, nothing is exported
    assert inst.dispatch_iteration(now + 1.0) is not None
    assert ex.export_request_blocks(r, [0]) is None
    inst.commit_iteration()
    assert ex.export_request_blocks(r, [0]) is not None
    return out


@QUANTS
def test_export_request_blocks_match_reference(sides, quant):
    jax_side, torch_side = sides
    ref = _request_blocks(jax_side, quant)
    got = _request_blocks(torch_side, quant)
    assert sorted(got) == sorted(ref) == [0, 1, 2]
    for i, entry in got.items():
        assert entry["fmt"] == ref[i]["fmt"] == (quant or "fp")
        _assert_leaves_match(entry["kv"], _ref_leaves(ref[i]["kv"]))


# ---------------------------------------------------------------------------
# warm recovery materializes checkpoint blocks on the torch engine
# ---------------------------------------------------------------------------

N_REQ = 8
LOOSE = dict(ttft=5.0, tpot=0.5)


def _requests(side):
    """Eight seeded requests arriving 0.25 s apart (virtual time)."""
    rng = np.random.default_rng(26)
    reqs = []
    for i in range(N_REQ):
        n = int(rng.integers(16, 64))
        prompt = list(map(int, rng.integers(1, side.cfg.vocab_size,
                                            size=n)))
        reqs.append(side.Request(prompt_len=n, max_new_tokens=24,
                                 arrival=0.25 * i, prompt_tokens=prompt))
    return reqs


#: the recovery's checkpoint interval, in generated tokens
CKPT_TOKENS = 4


def _recovery_loop(side, crash_at=None):
    """``tests/test_faults_live.py``'s warm-recovery stack on ``side``:
    TaiChi, one P-heavy and one D-heavy instance, eight requests.  On the
    port, recovery checkpoints every CKPT_TOKENS tokens with materialized
    KV, and ``crash_at`` (virtual seconds) crashes the decode instance
    (iid 1) then, recovering it half a second later.  Returns (cluster,
    requests, loop, injector)."""
    if side.torch_side:
        SC, SL, SLO_, build, Loop = (ServingConfig, Sliders, SLO,
                                     build_cluster, ServingLoop)
        factory = lambda: TorchExecutor(side.cfg, side.params, n_slots=16,
                                        max_seq=512, device="cpu")
        recovery = RecoveryConfig(enable=True, checkpoint_tokens=CKPT_TOKENS,
                                  materialize_kv=True)
    else:
        assert crash_at is None
        SC, SL, SLO_, build, Loop = (JaxServingConfig, JaxSliders, JaxSLO,
                                     jax_build_cluster, JaxServingLoop)
        factory = lambda: JaxExecutor(side.cfg, side.params, n_slots=16,
                                      max_seq=512)
        recovery = None
    slo = SLO_(**LOOSE)
    sc = SC(model="smollm-135m", tp=1, policy="taichi",
            sliders=SL(n_p=1, n_d=1, s_p=64, s_d=32), hbm_blocks=512)
    cluster = build(sc, slo, executor_factory=factory, recovery=recovery)
    inj = None
    if crash_at is not None:
        inj = FaultInjector([Fault(crash_at, CRASH, 1),
                             Fault(crash_at + 0.5, RECOVER, 1)])
        cluster.attach_faults(inj)
    reqs = _requests(side)
    return cluster, reqs, Loop(cluster, slo, arrivals=iter(reqs)), inj


def _mid_decode_time(side):
    """A virtual time at which the port's decode instance holds a request
    past its second checkpoint: the first such commit of an undisturbed
    run of the same stack, just after it.  The port's virtual timeline
    follows its estimator, whose derates (``core/hw.py``) are the card's,
    so no fixed time is mid-decode for every set of them; the crash run
    replays the same events up to this time."""
    cluster, _, loop, _ = _recovery_loop(side)
    dec = next(i for i in cluster.instances if i.iid == 1)
    while loop.run(max_steps=1):
        if any(len(r.output_tokens) >= 2 * CKPT_TOKENS
               for r in dec.decoding.values()):
            return cluster.now + 1e-6
    raise AssertionError("no request decoded on the decode instance")


def _recovery_run(side, crash: bool):
    """``tests/test_faults_live.py::test_live_warm_recovery_is_token_
    exact``: with ``crash`` (the port only) the decode instance crashes
    mid-decode (:func:`_mid_decode_time`) and its victims resume from
    materialized checkpoint blocks."""
    cluster, reqs, loop, inj = _recovery_loop(
        side, _mid_decode_time(side) if crash else None)
    loop.run()
    assert all(r.state.value == "finished" for r in reqs)
    for inst in cluster.instances:
        assert inst.allocator.used_blocks == 0
    if crash:
        assert inj.fired[CRASH] == 1, "the crash never fired"
        return [list(r.output_tokens) for r in reqs], \
            cluster.recovery_counters()
    return [list(r.output_tokens) for r in reqs]


def test_warm_recovery_materializes_kv_token_exact(sides):
    """The victims land their checkpointed blocks (``warm_restores``: on
    a tensor engine a restore without landed KV falls back cold) and
    every stream equals the reference's undisturbed run."""
    jax_side, torch_side = sides
    ref = _recovery_run(jax_side, crash=False)
    got, rc = _recovery_run(torch_side, crash=True)
    assert got == ref
    assert rc["checkpoints"] > 0 and rc["ckpt_blocks"] > 0
    assert rc["warm_restores"] > 0 and rc["warm_restored_tokens"] > 0
