"""The split-KV algorithm of the port's decode kernels, on the CPU.

The kernels (``csrc/decode_kernel.cuh``) cut each row's keys into splits
of ``keys_per_split``, give each split its own (m, l, acc) and combine
the live ones in a second pass.  They run only on the card, so
``split_decode_ref`` repeats the two passes in plain PyTorch, and this
file holds it, on numpy-made float32 inputs, to the unsplit plain version
(atol 1e-5: the same sums in another grouping) and to the reference's
Pallas kernels in interpret mode (atol 1e-4, the bound
``tests/test_kernels.py`` holds them to).  The cases are the combine's
edges: empty rows, rows of one key, lengths on and off split boundaries,
splits wholly past the length (m = -1e30, l = 0), split sizes that are
not a multiple of the page.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.ops import decode_attention as jax_dense
from repro.kernels.decode_attention.ops import (
    paged_decode_attention as jax_paged)
from repro.models.attention import quantize_int8 as jax_quantize
from repro_torch.kernels.decode_attention.ops import (
    MAX_SPLIT_PAGES, TARGET_BLOCKS, TILE_KEYS, decode_attention_ref,
    keys_per_split, paged_decode_attention_ref, split_decode_ref)
from repro_torch.kernels.paged_args import gather_kv
from test_torch_helpers import cap_threads

cap_threads()

BS, NBLK, D, HQ, HKV = 16, 64, 64, 8, 2
WIDTH = 12                       # table entries a row: 192 keys
# empty, one key, on and off 16/48/64-key boundaries, the full table; the
# rows of one key and of 17 keys have every later split empty
LENGTHS = [0, 1, 17, 47, 48, 49, 64, 96, 191, 192]
SPLITS = [16, 48, 64]


def _paged_inputs(quant):
    rng = np.random.default_rng(5)
    k = rng.normal(size=(NBLK * BS, HKV, D)).astype(np.float32)
    v = rng.normal(size=(NBLK * BS, HKV, D)).astype(np.float32)
    ks = vs = None
    if quant:
        k, ks = (np.asarray(a) for a in jax_quantize(jnp.asarray(k)))
        v, vs = (np.asarray(a) for a in jax_quantize(jnp.asarray(v)))
    # each row's pages drawn without replacement; -1 past its length
    perm = list(rng.permutation(NBLK))
    tables = np.full((len(LENGTHS), WIDTH), -1, np.int32)
    for b, n in enumerate(LENGTHS):
        tables[b, :-(-n // BS)] = [perm.pop() for _ in range(-(-n // BS))]
    q = rng.normal(size=(len(LENGTHS), HQ, D)).astype(np.float32)
    return q, k, v, tables, np.array(LENGTHS, np.int32), ks, vs


@functools.lru_cache(maxsize=None)
def _pallas_paged(quant):
    q, k, v, tables, lengths, ks, vs = _paged_inputs(quant)
    j = lambda a: None if a is None else jnp.asarray(a)
    return np.asarray(jax_paged(j(q), j(k), j(v), j(tables), j(lengths),
                                block_size=BS, k_scale=j(ks),
                                v_scale=j(vs), interpret=True))


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("kps", SPLITS)
def test_paged_split_matches_unsplit_and_pallas(kps, quant):
    q, k, v, tables, lengths, ks, vs = (_t(a) for a in _paged_inputs(quant))
    kd = gather_kv(k, ks, tables, BS)
    vd = gather_kv(v, vs, tables, BS)
    out = split_decode_ref(q, kd, vd, lengths, kps)
    assert out.shape == q.shape and torch.isfinite(out).all()
    assert not out[0].any()                       # the empty row
    ref = paged_decode_attention_ref(q, k, v, tables, lengths,
                                     block_size=BS, k_scale=ks, v_scale=vs)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-5)
    np.testing.assert_allclose(out.numpy(), _pallas_paged(quant), atol=1e-4)


@pytest.mark.parametrize("kps", SPLITS)
def test_dense_split_matches_unsplit_and_pallas(kps):
    """The dense view: S 112 (not a multiple of any split), head dim 112,
    a length past S (capped), MHA."""
    rng = np.random.default_rng(6)
    B, S, H, Dd = 6, 112, 4, 112
    q = rng.normal(size=(B, H, Dd)).astype(np.float32)
    k = rng.normal(size=(B, S, H, Dd)).astype(np.float32)
    v = rng.normal(size=(B, S, H, Dd)).astype(np.float32)
    lengths = np.array([1, 16, 48, 64, 111, 112], np.int32)
    out = split_decode_ref(*(_t(a) for a in (q, k, v, lengths)), kps)
    ref = decode_attention_ref(*(_t(a) for a in (q, k, v, lengths)))
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-5)
    pallas = jax_dense(*(jnp.asarray(a) for a in (q, k, v, lengths)),
                       bk=64, interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(pallas), atol=1e-4)
    over = split_decode_ref(*(_t(a) for a in (q, k, v)),
                            torch.tensor([500] * B), kps)
    np.testing.assert_allclose(
        over.numpy(), split_decode_ref(*(_t(a) for a in (q, k, v)),
                                       torch.tensor([S] * B), kps).numpy())


def test_combine_ignores_dead_splits_and_zeroes_empty_rows():
    """A split past the length has m = -1e30 and l = 0: whether or not the
    combine counts it, it weighs nothing, and a row with no key at all
    comes out zero rather than 0 / 0."""
    rng = np.random.default_rng(7)
    q = _t(rng.normal(size=(3, 4, 64)).astype(np.float32))
    kv = _t(rng.normal(size=(3, 256, 1, 64)).astype(np.float32))
    lengths = torch.tensor([0, 1, 33])
    out = split_decode_ref(q, kv, kv, lengths, 32)
    assert not out[0].any() and torch.isfinite(out).all()
    # one key: softmax over it is 1, so the output is that key's value
    np.testing.assert_allclose(out[1].numpy(),
                               kv[1, 0, 0][None].expand(4, 64).numpy(),
                               atol=1e-6)
    np.testing.assert_allclose(
        out.numpy(), decode_attention_ref(q, kv, kv, lengths).numpy(),
        atol=1e-5)


@pytest.mark.parametrize("B,Hkv,width,block_size,want", [
    (16, 2, 4096, 16, 480),   # chip_smoke.py's qwen2.5-3b case: 9 splits
    (8, 32, 2048, 0, 1024),   # zamba2-7b's dense case: 2 splits
    (32, 2, 4096, 16, 832),   # serve's decode batch: 5 splits
    (1, 1, 65536, 16, 256),   # one long row: 256 splits
    (256, 8, 65536, 16, 4096),  # one split would span 4096 pages: 256
    (1, 1, 100, 1, 32),       # one-token pages: one tile
    (128, 8, 256, 16, 256),   # more pairs than the target: one split
])
def test_keys_per_split_is_a_whole_tile_from_shapes(B, Hkv, width,
                                                    block_size, want):
    kps = keys_per_split(B, Hkv, width, block_size)
    assert kps == want and kps % TILE_KEYS == 0
    if block_size:
        assert -(-kps // block_size) <= MAX_SPLIT_PAGES
