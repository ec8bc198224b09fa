"""The port's dense path against the reference on the CPU, on the same
numpy-made inputs and weights:

* the plain versions of the dense decode and dense chunked-prefill
  kernels against the reference's Pallas kernels in interpret mode, at
  the shapes of ``tests/test_kernels.py`` plus zamba2-7b's head dim 112
  and gemma3-1b's 256 (float32 atol 1e-4 and bfloat16 atol 2e-2: the
  tolerances that test holds the reference's kernels to, bfloat16 being
  one rounding of the output on each side);
* ``TorchExecutor(device="cpu")`` on its batched dense and row-wise paths
  against ``JaxExecutor``, greedy and token-exact, on reduced zamba2,
  mamba2, granite-moe-3b-a800m and gemma3-1b (prompts past its 32-token
  window) — in plans where no recurrent row prefills while a decode runs
  (there the reference advances that row's state; see
  ``test_torch_ssm.py``; ``test_torch_moe.py`` holds the MoE family where
  rows prefill beside a decode) — including a dense migration between two
  executors.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jax_reduced
from repro.kernels.chunked_prefill_attention.ops import (
    chunked_prefill_attention as jax_prefill)
from repro.kernels.decode_attention.ops import decode_attention as jax_decode
from repro_torch.configs import reduced_config
from repro_torch.engine.engine import (DenseRowAllocator,
                                       MigrationFormatError, TorchExecutor,
                                       packable)
from repro_torch.engine.kvcache import OutOfBlocks
from repro_torch.engine.request import Request
from repro_torch.kernels.chunked_prefill_attention.ops import (
    chunked_prefill_attention, chunked_prefill_attention_ref)
from repro_torch.kernels.decode_attention.ops import (decode_attention,
                                                      decode_attention_ref)

from test_torch_engine import Side, _drive
from test_torch_helpers import both_params, copying_reference  # noqa: F401

# the reference's host arrays may alias its in-flight inputs on the CPU
pytestmark = pytest.mark.usefixtures("copying_reference")

TOL = {"float32": 1e-4, "bfloat16": 2e-2}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(rng, shapes, dtype):
    """float32 numpy draws, rounded to ``dtype`` once so both sides see
    the same values."""
    jd, td = DTYPES[dtype]
    out = []
    for s in shapes:
        a = rng.standard_normal(s).astype(np.float32)
        out.append(np.array(jnp.asarray(a, jd).astype(jnp.float32)))
    return out, jd, td


# -- kernel 3: dense decode ---------------------------------------------------

DECODE_SHAPES = [            # B, Hq, Hkv, D, S  (tests/test_kernels.py)
    (2, 4, 2, 64, 128),
    (3, 9, 3, 64, 200),      # padded group + padded S
    (1, 8, 1, 128, 512),     # MQA long
    (4, 4, 4, 64, 64),
    (2, 4, 4, 112, 96),      # zamba2-7b's head dim, MHA
    (3, 4, 1, 256, 160),     # gemma3-1b's global layers: MQA, head dim 256
    (2, 8, 2, 256, 64),      # head dim 256, GQA 4:1
]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("B,Hq,Hkv,D,S", DECODE_SHAPES)
def test_decode_plain_matches_pallas(B, Hq, Hkv, D, S, dtype):
    rng = np.random.default_rng(D + S)
    (q, k, v), jd, td = _inputs(
        rng, [(B, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D)], dtype)
    lengths = rng.integers(1, S + 1, size=B).astype(np.int32)
    ref = jax_decode(*(jnp.asarray(a, jd) for a in (q, k, v)),
                     jnp.asarray(lengths), bk=64, interpret=True)
    args = [torch.from_numpy(a).to(td) for a in (q, k, v)]
    out = decode_attention_ref(*args, torch.from_numpy(lengths))
    assert out.dtype == td and torch.isfinite(out.float()).all()
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), atol=TOL[dtype])
    # on a CPU tensor the wrapper takes the plain version, and counts no
    # kernel launch
    before = decode_attention.launches
    np.testing.assert_array_equal(
        decode_attention(*args, torch.from_numpy(lengths)).float().numpy(),
        out.float().numpy())
    assert decode_attention.launches == before


def test_decode_reads_a_strided_slot_and_caps_lengths():
    """A slot's view of a larger cache (row stride of the whole cache)
    reads the same as a contiguous copy; lengths past S read all S keys,
    and a length of 0 gives zeros."""
    rng = np.random.default_rng(3)
    cache = torch.from_numpy(rng.standard_normal((2, 4, 48, 2, 64))
                             .astype(np.float32))
    k, v = cache[0, 1:3], cache[1, 1:3]
    q = torch.from_numpy(rng.standard_normal((2, 4, 64)).astype(np.float32))
    ln = torch.tensor([48, 0], dtype=torch.int32)
    out = decode_attention(q, k, v, torch.tensor([60, 0]))
    np.testing.assert_array_equal(
        out.numpy(), decode_attention(q, k.contiguous(), v.contiguous(),
                                      ln).numpy())
    assert not out[1].any()


# -- kernel 4: dense chunked prefill -----------------------------------------

PREFILL_SHAPES = [           # B, Tq, Hq, Hkv, D, S, prefix
    (1, 16, 4, 4, 64, 64, 16),       # MHA
    (2, 16, 4, 2, 64, 64, 32),       # GQA 2:1
    (1, 128, 8, 8, 128, 256, 100),   # large tiles
    (2, 8, 9, 3, 64, 40, 17),        # non-divisible heads + padded S
    (1, 32, 16, 1, 64, 96, 50),      # MQA
    (1, 4, 4, 2, 128, 16, 0),        # zero prefix (fresh prompt)
    (1, 24, 4, 4, 112, 64, 9),       # zamba2-7b's head dim, MHA
    (1, 40, 4, 1, 256, 128, 70),     # gemma3-1b's global layers, MQA
    (2, 16, 8, 2, 256, 48, 0),       # head dim 256, fresh prompt
]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("B,Tq,Hq,Hkv,D,S,prefix", PREFILL_SHAPES)
def test_chunked_prefill_plain_matches_pallas(B, Tq, Hq, Hkv, D, S, prefix,
                                              dtype):
    rng = np.random.default_rng(Tq + S + prefix)
    (q, k, v), jd, td = _inputs(
        rng, [(B, Tq, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D)], dtype)
    ref = jax_prefill(*(jnp.asarray(a, jd) for a in (q, k, v)), prefix,
                      bq=16, bk=32, interpret=True)
    args = [torch.from_numpy(a).to(td) for a in (q, k, v)]
    out = chunked_prefill_attention_ref(*args, prefix)
    assert out.dtype == td and torch.isfinite(out.float()).all()
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), atol=TOL[dtype])
    # a device-scalar prefix (what the model passes) reads the same
    before = chunked_prefill_attention.launches
    got = chunked_prefill_attention(*args, torch.tensor(prefix))
    np.testing.assert_array_equal(got.float().numpy(), out.float().numpy())
    assert chunked_prefill_attention.launches == before


# -- executors ----------------------------------------------------------------

ARCHS = ["zamba2-7b", "mamba2-1.3b", "granite-moe-3b-a800m", "gemma3-1b"]


@pytest.fixture(scope="module", params=ARCHS)
def hybrid_sides(request):
    cj, ct = jax_reduced(request.param), reduced_config(request.param)
    pj, pt = both_params(cj, ct, seed=31)
    return Side(False, pj, cj), Side(True, pt, ct)


def _generate(side, prompts, n_out, *, batched, chunk):
    ex, inst = side.make(n_slots=len(prompts) + 1, chunk=chunk,
                         batched=batched)
    reqs = [side.Request(prompt_len=len(p), max_new_tokens=n_out,
                         hidden_output_len=n_out, prompt_tokens=list(p))
            for p in prompts]
    for r in reqs:
        inst.enqueue_prefill(r)
    _drive(inst, reqs)
    return [r.output_tokens for r in reqs], ex


@pytest.mark.parametrize("batched", [True, False], ids=["batched", "rowwise"])
def test_dense_executor_token_exact(hybrid_sides, batched):
    """Four prompts prefilled together in one chunk budget, then decoded
    together (uneven lengths: 9 / 14 / 33 / 47 tokens)."""
    jax_side, torch_side = hybrid_sides
    rng = np.random.default_rng(5)
    prompts = [list(map(int, rng.integers(1, 500, size=n)))
               for n in (9, 14, 33, 47)]
    ref, _ = _generate(jax_side, prompts, 6, batched=batched, chunk=128)
    got, ex = _generate(torch_side, prompts, 6, batched=batched, chunk=128)
    assert not packable(torch_side.cfg) and not ex.paged
    assert got == ref
    assert all(len(o) == 6 for o in got)


@pytest.mark.parametrize("batched", [True, False], ids=["batched", "rowwise"])
def test_dense_multi_chunk_prefill_token_exact(hybrid_sides, batched):
    """One 40-token prompt prefilled as chunks of 16, 16 and 8: the
    conv and SSM state carry across chunks, through the slot's views."""
    jax_side, torch_side = hybrid_sides
    rng = np.random.default_rng(7)
    prompt = [list(map(int, rng.integers(1, 500, size=40)))]
    ref, _ = _generate(jax_side, prompt, 5, batched=batched, chunk=16)
    got, _ = _generate(torch_side, prompt, 5, batched=batched, chunk=16)
    assert got == ref


def _run_migrated(side, batched):
    rng = np.random.default_rng(6)
    prompt = list(map(int, rng.integers(1, 500, size=26)))
    exA, iA = side.make(n_slots=3, chunk=32, batched=batched)
    exB, iB = side.make(n_slots=3, chunk=32, iid=1, batched=batched)
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
    assert "row" in state
    iB.inject(req, state)
    while not req.done():
        dur, _, _ = iB.run_iteration(now)
        now += dur
    return req.output_tokens, nbytes, state


@pytest.mark.parametrize("batched", [True, False], ids=["batched", "rowwise"])
def test_dense_migration_round_trip_token_exact(hybrid_sides, batched):
    """eject/inject of a dense row (KV and recurrent state) between two
    executors mid-decode."""
    jax_side, torch_side = hybrid_sides
    ref, ref_bytes, _ = _run_migrated(jax_side, batched)
    got, got_bytes, state = _run_migrated(torch_side, batched)
    assert got == ref
    assert got_bytes == ref_bytes
    if "ssm" in state["row"]:
        assert state["row"]["ssm"].dtype == torch.float32
    if "k_local" in state["row"]:      # the ring ships whole
        assert state["row"]["k_local"].shape[1] == 32


def test_dense_row_allocator_admits_one_request_a_row():
    alloc = DenseRowAllocator(2, 100, 16)
    assert alloc.num_blocks == 2 * 7
    alloc.allocate(1, 10)
    alloc.allocate(2, 10)
    assert not alloc.can_allocate(1)         # blocks are left, rows not
    with pytest.raises(OutOfBlocks):
        alloc.allocate(3, 1)
    alloc.extend(2, 40)                      # a holder still grows
    alloc.free(1)
    assert alloc.can_allocate(16)


def test_dense_executor_lands_migrations_at_admission():
    """A dense row lands only when the request is admitted (a row is
    taken with an admission), and a row of another model is refused."""
    cfg = reduced_config("mamba2-1.3b")
    ex = TorchExecutor(cfg, _tiny_params(cfg), 2, 64, device="cpu")
    req = Request(prompt_len=4, max_new_tokens=2, prompt_tokens=[1, 2, 3, 4])
    row = {name: torch.full_like(leaf[:, 0], 0.5)
           for name, leaf in ex.cache.items()}
    ex.insert_state(req, {"row": row, "pos": 4, "last_token": 9})
    assert not ex.slots.has(req.rid)
    ex.add_request(req)
    slot = ex.slots.slot(req.rid)
    assert int(ex.positions[slot]) == 4 and int(ex.last_token[slot]) == 9
    assert bool((ex.cache["ssm"][:, slot] == 0.5).all())
    other = dataclasses.replace(cfg, ssm_state=32)
    bad = {name: torch.zeros_like(leaf[:, 0]) for name, leaf in
           TorchExecutor(other, _tiny_params(other), 1, 64,
                         device="cpu").cache.items()}
    with pytest.raises(MigrationFormatError):
        ex.insert_state(Request(prompt_len=1, max_new_tokens=1),
                        {"row": bad, "pos": 1, "last_token": 0})


def _tiny_params(cfg):
    from repro_torch.models import transformer as tf
    return tf.init_params(0, cfg, device="cpu")
