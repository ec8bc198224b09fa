"""``TorchExecutor(device="cpu")`` against the reference's
``JaxExecutor`` on the same numpy-made weights: greedy generation must be
token-exact (float32 reduced config; the two stacks differ by ~1e-6 in
the logits, far below the gap between the best two tokens)."""
import numpy as np
import pytest

from repro.configs import reduced_config as jax_reduced
from repro.core.estimator import CostModel as JaxCostModel
from repro.core.hw import InstanceSpec as JaxInstanceSpec
from repro.core.instance import D_HEAVY as J_D_HEAVY
from repro.core.instance import P_HEAVY as J_P_HEAVY
from repro.core.instance import Instance as JaxInstance
from repro.engine.engine import JaxExecutor
from repro.engine.request import Request as JaxRequest
from repro_torch.configs import reduced_config
from repro_torch.core.estimator import CostModel
from repro_torch.core.hw import InstanceSpec
from repro_torch.core.instance import D_HEAVY, P_HEAVY, Instance
from repro_torch.engine.engine import (DenseRowAllocator,
                                       MigrationFormatError, TorchExecutor,
                                       packable)
from repro_torch.engine.request import Request

from test_torch_helpers import (both_params, cap_threads,  # noqa: F401
                                copying_reference)

cap_threads()

# the reference's host arrays may alias its in-flight inputs on the CPU
pytestmark = pytest.mark.usefixtures("copying_reference")


class Side:
    """One framework's classes behind the same names."""

    def __init__(self, torch_side: bool, params, cfg):
        self.torch_side = torch_side
        self.params, self.cfg = params, cfg
        if torch_side:
            self.Request, self.Instance = Request, Instance
            self.D, self.P = D_HEAVY, P_HEAVY
            self.cost = CostModel(cfg, InstanceSpec(tp=1))
        else:
            self.Request, self.Instance = JaxRequest, JaxInstance
            self.D, self.P = J_D_HEAVY, J_P_HEAVY
            self.cost = JaxCostModel(cfg, JaxInstanceSpec(tp=1))

    def make(self, *, n_slots=5, chunk=32, iid=0, **kw):
        common = dict(n_slots=n_slots, max_seq=256, t_buckets=(8, 16, 32),
                      **kw)
        if self.torch_side:
            ex = TorchExecutor(self.cfg, self.params, device="cpu", **common)
        else:
            ex = JaxExecutor(self.cfg, self.params, **common)
        inst = self.Instance(iid, self.D, chunk, self.cost, ex,
                             hbm_blocks=512)
        return ex, inst


@pytest.fixture(scope="module")
def sides():
    cj, ct = jax_reduced("smollm-135m"), reduced_config("smollm-135m")
    pj, pt = both_params(cj, ct, seed=21)
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
    return g


def _gen_uneven(side, kv_quant=None):
    rng = np.random.default_rng(5)
    prompts = [list(map(int, rng.integers(1, side.cfg.vocab_size, size=n)))
               for n in (9, 14, 33, 47)]
    ex, inst = side.make(kv_quant=kv_quant)
    assert inst.allocator is ex.kv.allocator      # unified bookkeeping
    reqs = [side.Request(prompt_len=len(p), max_new_tokens=6,
                         hidden_output_len=6, prompt_tokens=list(p))
            for p in prompts]
    for r in reqs:
        inst.enqueue_prefill(r)
    iters = _drive(inst, reqs)
    ex.kv.check_invariants()
    return [r.output_tokens for r in reqs], ex, iters


@pytest.mark.parametrize("kv_quant", [None, "int8"], ids=["fp", "int8"])
def test_paged_uneven_buckets_token_exact(sides, kv_quant):
    """Uneven prompt lengths spanning several T buckets, decode mixing
    into prefill iterations (the case of
    test_paged_matches_rowwise_uneven_buckets)."""
    jax_side, torch_side = sides
    ref, _, _ = _gen_uneven(jax_side, kv_quant)
    got, ex, iters = _gen_uneven(torch_side, kv_quant)
    assert got == ref
    assert all(len(o) == 6 for o in got)
    assert 0 < ex.host_readbacks <= iters
    assert ex.host_syncs <= ex.host_readbacks
    assert ex.horizon_capable
    assert ex.cache_bytes() == ex.kv.pool_bytes() > 0


def _run_migrated(side):
    rng = np.random.default_rng(6)
    prompt = list(map(int, rng.integers(1, side.cfg.vocab_size, size=26)))
    exA, iA = side.make(n_slots=4, chunk=16)
    exB, iB = side.make(n_slots=4, chunk=16, iid=1)
    iB.itype = side.P
    req = side.Request(prompt_len=len(prompt), max_new_tokens=8,
                       hidden_output_len=8, prompt_tokens=list(prompt))
    iA.enqueue_prefill(req)
    now = 0.0
    while req.prefill_remaining > 0:
        dur, _, _ = iA.run_iteration(now)
        now += dur
    iA.admit_decode(req)
    for _ in range(3):
        dur, _, _ = iA.run_iteration(now)
        now += dur
    nbytes = exA.migration_bytes(req)
    state = iA.eject(req)
    assert "paged_blocks" in state
    # only blocks covering the context ship, not headroom
    assert state["n_blocks"] == -(-state["pos"] // 16)
    assert nbytes == state["n_blocks"] * 16 * exA.kv.token_bytes()
    iB.inject(req, state)
    while not req.done():
        dur, _, _ = iB.run_iteration(now)
        now += dur
    exA.kv.check_invariants()
    exB.kv.check_invariants()
    return req.output_tokens, nbytes, state


def test_paged_migration_round_trip_token_exact(sides):
    """eject/inject between two paged engines mid-decode (the case of
    test_paged_migration_round_trip_token_exact)."""
    jax_side, torch_side = sides
    ref, ref_bytes, _ = _run_migrated(jax_side)
    got, got_bytes, state = _run_migrated(torch_side)
    assert got == ref
    assert got_bytes == ref_bytes
    leaf = state["paged_blocks"]["k"]
    assert leaf.shape[:2] == (torch_side.cfg.num_layers,
                              state["n_blocks"] * 16)


def test_prefix_claim_aliases_blocks_token_exact(sides):
    """Two waves sharing a 32-token prefix: the second claims the cached
    blocks (block-table aliasing) and still generates the reference's
    tokens."""
    outs = []
    for side in sides:
        rng = np.random.default_rng(11)
        shared = list(map(int, rng.integers(1, side.cfg.vocab_size,
                                            size=32)))
        tails = [list(map(int, rng.integers(1, side.cfg.vocab_size,
                                            size=n))) for n in (9, 17)]
        ex, inst = side.make(n_slots=6, prefix_cache=True)
        toks, now = [], 0.0
        for tail in tails:
            p = shared + tail
            r = side.Request(prompt_len=len(p), max_new_tokens=5,
                             hidden_output_len=5, prompt_tokens=p)
            inst.enqueue_prefill(r)
            _drive(inst, [r])
            toks.append(r.output_tokens)
        assert ex.prefix_adoptions == 1
        assert inst.cached_prefill_tokens == 32
        ex.kv.check_invariants()
        outs.append(toks)
    assert outs[1] == outs[0]


def test_unported_paths_raise_and_formats_are_checked(sides):
    """``paged=False`` and ``batched=False`` build the dense paths (a
    slot-contiguous cache, admission by rows); a migrated state of the
    other format is refused in both directions, as is a replicated
    prefix of the other KV format; the host spill tier binds its tensor
    legs."""
    _, side = sides
    dense = TorchExecutor(side.cfg, side.params, 2, 64, paged=False,
                          device="cpu")
    rowwise = TorchExecutor(side.cfg, side.params, 2, 64, batched=False,
                            device="cpu")
    for ex in (dense, rowwise):
        assert not ex.paged and ex.kv is None
        assert set(ex.cache) == {"k", "v"}
        assert ex.cache["k"].shape[1:3] == (2, 64)
        assert isinstance(ex.allocator, DenseRowAllocator)
        assert ex.cache_bytes() == sum(t.numel() * t.element_size()
                                       for t in ex.cache.values())
    assert dense.packed and not rowwise.packed
    spilling = TorchExecutor(side.cfg, side.params, 2, 64,
                             kv_spill_blocks=4, prefix_cache=True,
                             device="cpu")
    pc = spilling.prefix_cache_obj
    assert pc.spill is not None
    assert pc._fetch_block == spilling.fetch_block
    assert pc._load_block == spilling.load_block
    assert packable(side.cfg)
    ex = TorchExecutor(side.cfg, side.params, 2, 64, device="cpu")
    assert ex.paged
    assert ex.export_prefix_blocks([1] * 32) is None    # no prefix cache
    assert ex.import_prefix_blocks({"paged_blocks": {}}) == 0
    with pytest.raises(MigrationFormatError):      # fp -> int8 pool
        spilling.import_prefix_blocks({"paged_blocks": {}, "n_blocks": 1,
                                       "tokens": [1] * 16,
                                       "kv_format": "int8"})
    req = Request(prompt_len=4, max_new_tokens=2,
                  prompt_tokens=[1, 2, 3, 4])
    with pytest.raises(MigrationFormatError):      # dense -> paged
        ex.insert_state(req, {"row": None, "pos": 0, "last_token": 0})
    with pytest.raises(MigrationFormatError):
        ex.insert_state(req, {"paged_blocks": {}, "n_blocks": 1, "pos": 4,
                              "last_token": 0, "kv_format": "int8"})
    paged_state = {"paged_blocks": {}, "n_blocks": 1, "pos": 4,
                   "last_token": 0, "kv_format": "fp"}
    for ex in (dense, rowwise):                     # paged -> dense
        with pytest.raises(MigrationFormatError):
            ex.insert_state(req, paged_state)


def test_step_async_defers_the_readback_and_abort_releases(sides):
    _, side = sides
    ex, inst = side.make()
    req = Request(prompt_len=5, max_new_tokens=3, hidden_output_len=3,
                  prompt_tokens=[5, 6, 7, 8, 9])
    inst.enqueue_prefill(req)
    inst.run_iteration(0.0)             # prefill completes: 1 readback
    assert ex.host_readbacks == 1 and len(req.output_tokens) == 1
    inst.admit_decode(req)

    class Plan:
        prefill_items = ()
        decode_reqs = [req]
        horizon = 1
    step = ex.step_async(Plan)
    assert ex.host_readbacks == 1 and step.ready()   # CPU: nothing pending
    with pytest.raises(RuntimeError, match="not resolved"):
        ex.step_async(Plan)
    ex.abort_step()
    assert ex._pending is None and len(req.output_tokens) == 1
    # a 4-step horizon with a 2-token budget: one dispatch, one readback,
    # two tokens
    Plan.horizon = 4
    Plan.decode_budgets = [2]
    step = ex.step_async(Plan)
    assert step.horizon == 4 and ex.horizon_calls == 1
    step.resolve()
    assert ex.host_readbacks == 2 and step.emitted == {req.rid: 2}
    assert len(req.output_tokens) == 3 and ex.horizon_tokens == 2
    ex.on_crash()
    assert not ex.slots.has(req.rid)
    assert (ex.kv.tables == -1).all()
