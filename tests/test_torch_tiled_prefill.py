"""The tile walk of the port's tensor-core prefill body, on the CPU.

The kernels (``csrc/prefill_kernel.cuh``) fold the G query heads of a KV
head into token-major query rows, give a thread block 64 of them (four
warps of 16), walk 64-key tiles up to the query tile's causal frontier,
mask only the tiles that straddle a warp's first query or the frontier,
apply an int8 pool's scales to the score and to P, and round P into the
P V product.  They run only on the card, so ``tiled_prefill_ref`` repeats
that walk in plain PyTorch, and this file holds it, on numpy-made inputs,
to the unsplit plain versions (float32, atol 1e-5: the same sums in
another grouping), to the reference's Pallas kernels in interpret mode
(atol 1e-4, the bound ``tests/test_kernels.py`` holds them to), and, with
bf16 or int8 inputs and P rounded as the kernel rounds it, within the
bf16 tolerance of 2e-2 of the float32 plain version.  The cases: rows
with valid 0, 1, 17 and Tq, starts off page and tile boundaries, prefix
0, Tq not a multiple of a query tile's tokens, G of 1, 3 and 8, head dims
64, 112 and 128, an int8 pool.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.chunked_prefill_attention.ops import (
    chunked_prefill_attention as jax_dense)
from repro.kernels.chunked_prefill_attention.ops import (
    paged_chunked_prefill_attention as jax_paged)
from repro_torch.kernels.chunked_prefill_attention.ops import (
    chunked_prefill_attention_ref, paged_chunked_prefill_attention_ref,
    tiled_prefill_ref)
from repro_torch.kernels.paged_args import gather_pool
from repro_torch.models.attention import quantize_int8
from test_torch_helpers import cap_threads

cap_threads()

BS, NBLK, HKV = 16, 40, 2
TQ = 37                 # not a multiple of 64, 21 or 8 tokens
# (start, valid): a whole chunk at prefix 0, a decode row, 17 tokens off
# every boundary, a padding row, chunks at 100 and 77 (off page and tile
# boundaries) and one at 64 that ends inside the bucket
ROWS = [(0, TQ), (40, 1), (5, 17), (0, 0), (100, TQ), (77, 30), (64, 20)]
GROUPS = [1, 3, 8]
DIMS = [64, 112, 128]
BF16_TOL = 2e-2


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


@functools.lru_cache(maxsize=None)
def _paged_inputs(g, d, quant, seed=0):
    """q, pools (f32, or int8 with f32 scales), tables, start, valid as
    numpy arrays; each row's pages drawn without replacement, -1 past its
    end."""
    rng = np.random.default_rng(seed)
    k = rng.normal(size=(NBLK * BS, HKV, d)).astype(np.float32)
    v = rng.normal(size=(NBLK * BS, HKV, d)).astype(np.float32)
    ks = vs = None
    if quant:
        (k, ks), (v, vs) = (tuple(x.numpy() for x in quantize_int8(_t(a)))
                            for a in (k, v))
    width = -(-max(s + n for s, n in ROWS) // BS)
    perm = list(rng.permutation(NBLK))
    tables = np.full((len(ROWS), width), -1, np.int32)
    for b, (s, n) in enumerate(ROWS):
        nb = -(-(s + n) // BS)
        tables[b, :nb] = [perm.pop() for _ in range(nb)]
    q = rng.normal(size=(len(ROWS), TQ, HKV * g, d)).astype(np.float32)
    start = np.array([s for s, _ in ROWS], np.int32)
    valid = np.array([n for _, n in ROWS], np.int32)
    return q, k, v, ks, vs, tables, start, valid


def _walk_paged(q, k, v, ks, vs, tables, start, valid, p_round=None):
    """tiled_prefill_ref over the pool gathered through the tables."""
    kd, vd = (gather_pool(x, tables, BS) for x in (k, v))
    sc = ({} if ks is None else
          dict(k_scale=gather_pool(ks, tables, BS),
               v_scale=gather_pool(vs, tables, BS)))
    return tiled_prefill_ref(q, kd, vd, start, valid, p_round=p_round, **sc)


def _assert_rows(out, ref, valid, atol):
    """Tokens below each row's valid count agree; a query tile wholly past
    valid (every token of a padding row) is zero."""
    for b, n in enumerate(valid.tolist()):
        if n:
            np.testing.assert_allclose(out[b, :n].float().numpy(),
                                       ref[b, :n].float().numpy(),
                                       atol=atol)
        else:
            assert not out[b].any()


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("d", DIMS)
@pytest.mark.parametrize("g", GROUPS)
def test_paged_walk_matches_the_plain_version(g, d, quant):
    q, k, v, ks, vs, tables, start, valid = (
        _t(a) for a in _paged_inputs(g, d, quant))
    out = _walk_paged(q, k, v, ks, vs, tables, start, valid)
    assert out.shape == q.shape and torch.isfinite(out).all()
    ref = paged_chunked_prefill_attention_ref(
        q, k, v, tables, start, valid, block_size=BS, k_scale=ks,
        v_scale=vs)
    _assert_rows(out, ref, valid, 1e-5)


@pytest.mark.parametrize("prefix,tq", [(0, 64), (0, 37), (100, 37),
                                       (64, 70)])
@pytest.mark.parametrize("d", DIMS)
@pytest.mark.parametrize("g", GROUPS)
def test_dense_walk_matches_the_plain_version(g, d, prefix, tq):
    """One prefix for the batch, valid = Tq, over a cache of S 180 (not a
    multiple of the key tile)."""
    rng = np.random.default_rng(1)
    B, S = 2, 180
    q = _t(rng.normal(size=(B, tq, HKV * g, d)).astype(np.float32))
    k = _t(rng.normal(size=(B, S, HKV, d)).astype(np.float32))
    v = _t(rng.normal(size=(B, S, HKV, d)).astype(np.float32))
    st = torch.full((B,), prefix)
    out = tiled_prefill_ref(q, k, v, st, torch.full((B,), tq))
    ref = chunked_prefill_attention_ref(q, k, v, prefix)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-5)


@pytest.mark.parametrize("g,d,quant", [(1, 64, False), (3, 64, True),
                                       (8, 128, False), (8, 64, True)])
def test_paged_walk_matches_pallas(g, d, quant):
    inputs = _paged_inputs(g, d, quant)
    q, k, v, ks, vs, tables, start, valid = inputs
    j = lambda a: None if a is None else jnp.asarray(a)
    pallas = jax_paged(j(q), j(k), j(v), j(tables), j(start), j(valid),
                       block_size=BS, k_scale=j(ks), v_scale=j(vs),
                       interpret=True)
    out = _walk_paged(*(_t(a) for a in inputs))
    _assert_rows(out, _t(np.asarray(pallas)), valid, 1e-4)


@pytest.mark.parametrize("g,d,prefix,tq", [(1, 112, 0, 37), (3, 64, 100, 37),
                                           (8, 128, 64, 20)])
def test_dense_walk_matches_pallas(g, d, prefix, tq):
    rng = np.random.default_rng(2)
    B, S = 2, 160
    q = rng.normal(size=(B, tq, HKV * g, d)).astype(np.float32)
    k = rng.normal(size=(B, S, HKV, d)).astype(np.float32)
    v = rng.normal(size=(B, S, HKV, d)).astype(np.float32)
    pallas = jax_dense(*(jnp.asarray(a) for a in (q, k, v)), prefix,
                       bq=16, bk=32, interpret=True)
    out = tiled_prefill_ref(*(_t(a) for a in (q, k, v)),
                            torch.full((B,), prefix), torch.full((B,), tq))
    np.testing.assert_allclose(out.numpy(), np.asarray(pallas), atol=1e-4)


def _rounded_case(g, d, pool):
    """bf16 q and a bf16 or int8 pool; the float32 plain version on the
    same stored values is the yardstick."""
    q, k, v, ks, vs, tables, start, valid = (
        _t(a) for a in _paged_inputs(g, d, pool == "int8", seed=3))
    q = q.bfloat16()
    if pool == "bf16":
        k, v = k.bfloat16(), v.bfloat16()
    ref = paged_chunked_prefill_attention_ref(
        q.float(), k.float() if pool == "bf16" else k,
        v.float() if pool == "bf16" else v, tables, start, valid,
        block_size=BS, k_scale=ks, v_scale=vs)
    return (q, k, v, ks, vs, tables, start, valid), ref


def _max_err(out, ref, valid):
    return max((out[b, :n].float() - ref[b, :n].float()).abs().max().item()
               for b, n in enumerate(valid.tolist()) if n)


@pytest.mark.parametrize("p_round", ["bf16", "pair"])
@pytest.mark.parametrize("pool", ["bf16", "int8"])
@pytest.mark.parametrize("g,d", [(1, 128), (8, 128), (3, 64)])
def test_rounded_p_stays_within_the_bf16_tolerance(g, d, pool, p_round):
    """The kernel's bf16 output with P rounded as the kernel rounds it,
    against the float32 plain version: within 2e-2.  The margin is
    printed: with one rounding above half the tolerance the kernel takes
    the pair."""
    args, ref = _rounded_case(g, d, pool)
    out = _walk_paged(*args, p_round=p_round)
    assert out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all()
    err = _max_err(out, ref, args[-1])
    print(f"p_round={p_round} pool={pool} g={g} d={d}: max err {err:.3e} "
          f"({err / BF16_TOL:.1%} of the tolerance)")
    assert err <= BF16_TOL


@pytest.mark.parametrize("pool", ["bf16", "int8"])
@pytest.mark.parametrize("g,d", [(1, 128), (8, 128)])
def test_p_as_a_pair_is_closer_than_one_bf16(g, d, pool):
    """P's own share of the error, with the output kept in float32: one
    bf16 rounding of P against the pair hi + lo."""
    args, ref = _rounded_case(g, d, pool)
    args = (args[0].float(),) + args[1:]
    errs = {p: _max_err(_walk_paged(*args, p_round=p), ref, args[-1])
            for p in ("bf16", "pair")}
    print(f"pool={pool} g={g} d={d}: P error, float32 output: {errs}")
    assert errs["pair"] < errs["bf16"] / 10
