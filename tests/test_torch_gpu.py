"""Tests of the port that need the card (marker ``gpu``): they build the
CUDA kernels with nvcc and run on a CUDA device, and skip where there is
none.  They import nothing of the reference, so they run on a machine
without jax:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py
"""
import contextlib
import dataclasses
import gc
import json
import os
import socket
import threading

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.core.estimator import CostModel
from repro_torch.core.hw import InstanceSpec
from repro_torch.core.instance import D_HEAVY, Instance
from repro_torch.engine.engine import TorchExecutor
from repro_torch.engine.request import Request
from repro_torch.kernels.chunked_prefill_attention.ops import (
    P_ROUND, chunked_prefill_attention, chunked_prefill_attention_ref,
    paged_chunked_prefill_attention, paged_chunked_prefill_attention_ref,
    tiled_prefill_ref)
from repro_torch.kernels.decode_attention.ops import (
    decode_attention, decode_attention_ref, keys_per_split,
    paged_decode_attention, paged_decode_attention_ref)
from repro_torch.kernels.paged_args import gather_pool
from repro_torch.kernels.ssd_scan.ops import P_ROUND as P_ROUND_SSD
from repro_torch.kernels.ssd_scan.ops import (BWD_P_ROUND, _kernel_inputs,
                                              _launch_scan, ssd_scan,
                                              ssd_scan_bwd,
                                              ssd_scan_bwd_ref, ssd_scan_ref,
                                              ssd_scan_tiled_ref,
                                              ssd_tile_states_ref)
from repro_torch.models import attention as attn
from repro_torch.models import transformer as tf

pytestmark = pytest.mark.gpu
BS, NBLK = 16, 64
# float32: another summation order than the plain version's matmul;
# bfloat16: one rounding of an output of a few units on each side
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc to build the kernels)")
    return torch.device("cuda")


def _pools(dev, hkv, d, dtype, quant, seed=0):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    k = torch.randn((NBLK * BS + 1, hkv, d), device=dev, generator=g)
    v = torch.randn((NBLK * BS + 1, hkv, d), device=dev, generator=g)
    if quant:
        kq, ks = attn.quantize_int8(k)
        vq, vs = attn.quantize_int8(v)
        return kq, vq, dict(k_scale=ks, v_scale=vs)
    return k.to(dtype), v.to(dtype), {}


def _tables(dev, need, width, seed=1):
    rng = np.random.default_rng(seed)
    perm = list(rng.permutation(NBLK))
    t = np.full((len(need), width), -1, np.int32)
    for b, n in enumerate(need):
        nb = -(-int(n) // BS)
        t[b, :nb] = [perm.pop() for _ in range(nb)]
    return torch.from_numpy(t).to(dev)


# ... and llava-next-34b's 56 / 8 / 128: a group of 7, padded to 8 in the
# decode body, 9 tokens x 7 heads = 63 rows of a 64-row prefill tile
SHAPES = [(8, 2, 64), (9, 3, 64), (16, 2, 128), (5, 1, 128), (4, 4, 64),
          (56, 8, 128)]


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("hq,hkv,d", SHAPES)
def test_decode_kernel_matches_plain_version(cuda, hq, hkv, d, dtype, quant):
    lengths = [0, 1, 16, 17, 37, 160, 255, 64]
    k, v, scales = _pools(cuda, hkv, d, dtype, quant)
    tables = _tables(cuda, lengths, 16)
    q = torch.randn((len(lengths), hq, d), device=cuda).to(dtype)
    ln = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    before = paged_decode_attention.launches
    out = paged_decode_attention(q, k, v, tables, ln, block_size=BS,
                                 **scales)
    torch.cuda.synchronize()
    assert paged_decode_attention.launches == before + 1
    ref = paged_decode_attention_ref(q, k, v, tables, ln, block_size=BS,
                                     **scales)
    assert torch.isfinite(out.float()).all() and not out[0].any()
    assert (out.float() - ref.float()).abs().max().item() <= TOL[dtype]


# (Tq, starts, valids) of a mixed batch: whole and short chunks, decode
# rows (valid 1) and padding rows (valid 0, all zero out), starts off page
# and 64-key tile boundaries, chunks whose key tiles straddle the causal
# frontier, Tq of 1, 63, 64, 65 and 256
PREFILL_BATCHES = {
    "tq64": (64, [0, 40, 5, 0, 100, 15], [64, 1, 17, 0, 33, 50]),
    "tq1": (1, [0, 37, 200, 5], [1, 1, 0, 1]),
    "tq63": (63, [0, 70, 129, 3, 64], [63, 1, 40, 0, 63]),
    "tq65": (65, [64, 0, 17, 300, 9], [65, 65, 1, 0, 30]),
    "tq256": (256, [0, 100, 33, 7], [256, 1, 200, 0]),
}


def _prefill_batch(dev, name, hq, hkv, d, dtype, quant):
    tq, starts, valids = PREFILL_BATCHES[name]
    k, v, scales = _pools(dev, hkv, d, dtype, quant)
    ends = [s + n for s, n in zip(starts, valids)]
    tables = _tables(dev, ends, max(16, -(-max(ends) // BS)))
    q = torch.randn((len(starts), tq, hq, d), device=dev).to(dtype)
    st = torch.tensor(starts, dtype=torch.int32, device=dev)
    vl = torch.tensor(valids, dtype=torch.int32, device=dev)
    return q, k, v, tables, st, vl, scales


@pytest.mark.parametrize("batch", sorted(PREFILL_BATCHES))
@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("hq,hkv,d", SHAPES)
def test_prefill_kernel_matches_plain_version(cuda, hq, hkv, d, dtype,
                                              quant, batch):
    q, k, v, tables, st, vl, scales = _prefill_batch(cuda, batch, hq, hkv,
                                                     d, dtype, quant)
    before = paged_chunked_prefill_attention.launches
    out = paged_chunked_prefill_attention(q, k, v, tables, st, vl,
                                          block_size=BS, **scales)
    torch.cuda.synchronize()
    assert paged_chunked_prefill_attention.launches == before + 1
    ref = paged_chunked_prefill_attention_ref(q, k, v, tables, st, vl,
                                              block_size=BS, **scales)
    assert torch.isfinite(out.float()).all()
    for b, n in enumerate(vl.tolist()):
        if n:
            err = (out[b, :n].float() - ref[b, :n].float()).abs().max()
            assert err.item() <= TOL[dtype], (b, err.item())
        else:
            assert not out[b].any(), b


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("hq,hkv,d", [(16, 2, 128), (9, 3, 64), (4, 4, 64)])
def test_prefill_kernels_match_the_tile_walk(cuda, hq, hkv, d, kind):
    """Both prefill kernels against tiled_prefill_ref, the plain walk of
    the tensor-core body (P rounded as the kernel rounds it; f32 inputs
    take the FMA body, unrounded), within the tolerances."""
    dtype, quant = SPLIT_DTYPES[kind]
    q, k, v, tables, st, vl, scales = _prefill_batch(cuda, "tq65", hq, hkv,
                                                     d, dtype, quant)
    p_round = P_ROUND if dtype == torch.bfloat16 else None
    out = paged_chunked_prefill_attention(q, k, v, tables, st, vl,
                                          block_size=BS, **scales)
    kd, vd = (gather_pool(x, tables, BS) for x in (k, v))
    sc = ({} if not quant else
          {n: gather_pool(x, tables, BS) for n, x in scales.items()})
    walk = tiled_prefill_ref(q, kd, vd, st, vl, p_round=p_round, **sc)
    for b, n in enumerate(vl.tolist()):
        if not n:
            continue
        err = (out[b, :n].float() - walk[b, :n].float()).abs().max()
        assert err.item() <= TOL[dtype], (b, err.item())
    if quant:
        return
    kc, vc = _dense_kv(cuda, 2, 256, hkv, d, dtype)
    qd = torch.randn((2, 65, hq, d), device=cuda).to(dtype)
    pre = torch.tensor(70, dtype=torch.int32, device=cuda)
    out = chunked_prefill_attention(qd, kc, vc, pre)
    walk = tiled_prefill_ref(qd, kc, vc, torch.full((2,), 70),
                             torch.full((2,), 65), p_round=p_round)
    assert (out.float() - walk.float()).abs().max().item() <= TOL[dtype]


def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    k, v, _ = _pools(cuda, 2, 64, torch.float32, False)
    tables = _tables(cuda, [20], 4)
    ln = torch.tensor([20], dtype=torch.int32, device=cuda)
    q = torch.randn((1, 8, 64), device=cuda)
    with pytest.raises(TypeError):
        paged_decode_attention(q.half(), k, v, tables, ln, block_size=BS)
    with pytest.raises(ValueError):     # head_dim 32
        paged_decode_attention(q[..., :32], k[..., :32], v[..., :32],
                               tables, ln, block_size=BS)
    with pytest.raises(ValueError):     # scales without an int8 pool
        paged_decode_attention(q, k, v, tables, ln, block_size=BS,
                               k_scale=k[..., 0], v_scale=v[..., 0])
    with pytest.raises(ValueError):     # a table on another device
        paged_decode_attention(q, k, v, tables.cpu(), ln, block_size=BS)
    # misaligned KV views: cp.async moves 16 bytes, the wrapper raises
    # rather than falling back
    wide = torch.zeros((k.shape[0], 2, 68), device=cuda,
                       dtype=torch.bfloat16)
    kb = wide[..., :64]                 # head stride 136 bytes
    with pytest.raises(ValueError):
        paged_decode_attention(q.bfloat16(), kb, kb, tables, ln,
                               block_size=BS)
    flat = torch.zeros(k.numel() + 1, device=cuda)
    ko = flat[1:].view(k.shape)         # pointer 4 bytes past 16
    with pytest.raises(ValueError):
        paged_decode_attention(q, ko, ko, tables, ln, block_size=BS)


# -- split-KV boundaries -------------------------------------------------------
# The decode kernels cut a row's keys into splits of keys_per_split (from
# the shapes): lengths around one split, a wide table holding one key, the
# longest rows, and -1 table entries past every length.
SPLIT_DTYPES = {"f32": (torch.float32, False), "bf16": (torch.bfloat16, False),
                "int8": (torch.bfloat16, True)}


def _split_lengths(kps, top):
    return [0, 1, kps - 1, kps, kps + 1, top - 1, top, 1]


@pytest.mark.parametrize("width", [4096, 32], ids=["splits", "one_split"])
@pytest.mark.parametrize("kind", sorted(SPLIT_DTYPES))
@pytest.mark.parametrize("hq,hkv,d", [(16, 2, 128), (9, 3, 64)])
def test_decode_kernel_across_split_boundaries(cuda, hq, hkv, d, kind,
                                               width):
    dtype, quant = SPLIT_DTYPES[kind]
    kps = keys_per_split(8, hkv, width, BS)
    lengths = [min(n, width) for n in _split_lengths(kps, width)]
    n_blk = sum(-(-n // BS) for n in lengths)
    g = torch.Generator(device=cuda)
    g.manual_seed(4)
    k = torch.randn((n_blk * BS + 1, hkv, d), device=cuda, generator=g)
    v = torch.randn((n_blk * BS + 1, hkv, d), device=cuda, generator=g)
    scales = {}
    if quant:
        (k, ks), (v, vs) = attn.quantize_int8(k), attn.quantize_int8(v)
        scales = dict(k_scale=ks, v_scale=vs)
    else:
        k, v = k.to(dtype), v.to(dtype)
    perm = torch.randperm(n_blk, generator=torch.Generator().manual_seed(5))
    tables = torch.full((len(lengths), width // BS), -1, dtype=torch.int32)
    at = 0
    for b, n in enumerate(lengths):
        nb = -(-n // BS)
        tables[b, :nb] = perm[at:at + nb]
        at += nb
    tables = tables.to(cuda)
    q = torch.randn((len(lengths), hq, d), device=cuda,
                    generator=g).to(dtype)
    ln = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    before = paged_decode_attention.launches
    out = paged_decode_attention(q, k, v, tables, ln, block_size=BS,
                                 **scales)
    torch.cuda.synchronize()
    assert paged_decode_attention.launches == before + 1
    ref = paged_decode_attention_ref(q, k, v, tables, ln, block_size=BS,
                                     **scales)
    assert torch.isfinite(out.float()).all() and not out[0].any()
    assert (out.float() - ref.float()).abs().max().item() <= TOL[dtype]


@pytest.mark.parametrize("S", [4096, 32], ids=["splits", "one_split"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("hq,hkv,d", [(32, 32, 112), (8, 2, 64),
                                      (4, 1, 256)])
def test_dense_decode_kernel_across_split_boundaries(cuda, hq, hkv, d, dtype,
                                                     S):
    B = 8
    kps = keys_per_split(B, hkv, S)
    lengths = [min(n, S) for n in _split_lengths(kps, S)]
    k, v = _dense_kv(cuda, B, S, hkv, d, dtype, seed=6)
    q = torch.randn((B, hq, d), device=cuda).to(dtype)
    ln = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    before = decode_attention.launches
    out = decode_attention(q, k, v, ln)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 1
    ref = decode_attention_ref(q, k, v, ln)
    assert torch.isfinite(out.float()).all() and not out[0].any()
    assert (out.float() - ref.float()).abs().max().item() <= TOL[dtype]


# gemma3-1b's 4 / 1 / 256 (its global layers), granite-moe-3b-a800m's
# 24 / 8 / 64, whisper-base's 8 / 8 / 64 and llava-next-34b's 56 / 8 / 128
# (a group of 7: the tensor-core prefill's tile holds 9 tokens, 63 rows)
# among them
DENSE_SHAPES = [(8, 2, 64), (9, 3, 64), (16, 2, 128), (4, 4, 112),
                (32, 32, 112), (4, 1, 256), (24, 8, 64), (8, 2, 256),
                (8, 8, 64), (56, 8, 128)]


def _dense_kv(dev, B, S, hkv, d, dtype, seed=2):
    """k, v as two slots' views of a larger [2, B + 1, S, Hkv, D] cache:
    the kernels read strided slot views in place."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    cache = torch.randn((2, B + 1, S, hkv, d), device=dev,
                        generator=g).to(dtype)
    return cache[0, 1:], cache[1, 1:]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("hq,hkv,d", DENSE_SHAPES)
def test_dense_decode_kernel_matches_plain_version(cuda, hq, hkv, d, dtype):
    lengths = [1, 16, 17, 37, 160, 255, 300, 0]     # 300 > S: capped
    k, v = _dense_kv(cuda, len(lengths), 256, hkv, d, dtype)
    q = torch.randn((len(lengths), hq, d), device=cuda).to(dtype)
    ln = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    before = decode_attention.launches
    out = decode_attention(q, k, v, ln)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 1
    ref = decode_attention_ref(q, k, v, ln)
    assert torch.isfinite(out.float()).all() and not out[-1].any()
    assert (out.float() - ref.float()).abs().max().item() <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("hq,hkv,d", DENSE_SHAPES)
@pytest.mark.parametrize("tq,prefix", [(64, 0), (37, 100), (200, 56), (1, 255),
                                       (63, 70), (65, 129), (256, 0)])
def test_dense_prefill_kernel_matches_plain_version(cuda, hq, hkv, d, dtype,
                                                    tq, prefix):
    k, v = _dense_kv(cuda, 2, 256, hkv, d, dtype)
    q = torch.randn((2, tq, hq, d), device=cuda).to(dtype)
    pre = torch.tensor(prefix, dtype=torch.int32, device=cuda)
    before = chunked_prefill_attention.launches
    out = chunked_prefill_attention(q, k, v, pre)
    torch.cuda.synchronize()
    assert chunked_prefill_attention.launches == before + 1
    ref = chunked_prefill_attention_ref(q, k, v, prefix)
    assert torch.isfinite(out.float()).all()
    assert (out.float() - ref.float()).abs().max().item() <= TOL[dtype]


#: a log-sum-exp of a few units: float32 sums of up to 256 exponentials
#: in another order (exp2 of pre-scaled scores in the tensor-core bodies)
LSE_TOL = 1e-4


@pytest.mark.parametrize("S", [256, 32], ids=["splits", "one_split"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("hq,hkv,d", DENSE_SHAPES)
def test_dense_decode_lse_form_and_slot_halves(cuda, hq, hkv, d, dtype, S):
    """Kernel 3's log-sum-exp form: its output bit-equal to the serving
    form's, its lse the plain version's, and two slot halves (each with
    its local lengths) combined by ``combine_stacked`` the whole call;
    with several splits (pass 2 writes lse) and with one (pass 1 does)."""
    lengths = [1, 16, 17, 37, 160, 255, 300, 0]     # past S: capped
    half = S // 2
    k, v = _dense_kv(cuda, len(lengths), S, hkv, d, dtype)
    q = torch.randn((len(lengths), hq, d), device=cuda).to(dtype)
    ln = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    before = decode_attention.launches
    out, lse = decode_attention(q, k, v, ln, return_lse=True)
    serve = decode_attention(q, k, v, ln)
    parts = [decode_attention(
        q, k[:, off:off + half], v[:, off:off + half],
        (ln.long() - off).clamp(0, half).to(torch.int32), return_lse=True)
        for off in (0, half)]
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 4
    assert torch.equal(out, serve)
    ref, ref_lse = decode_attention_ref(q, k, v, ln, return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (len(lengths), hq)
    assert lse[-1].eq(-1e30).all()
    assert (lse - ref_lse).abs().max().item() <= LSE_TOL
    comb = attn.combine_stacked(torch.stack([p[0] for p in parts]),
                                torch.stack([p[1] for p in parts]))
    for want in (serve, ref):
        assert (comb.float() - want.float()).abs().max().item() \
            <= TOL[dtype]
    assert not comb[-1].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("hq,hkv,d", DENSE_SHAPES)
@pytest.mark.parametrize("tq,prefix", [(64, 0), (37, 100), (200, 56),
                                       (65, 129)])
def test_dense_prefill_lse_form_and_slot_halves(cuda, hq, hkv, d, dtype, tq,
                                                prefix):
    """Kernel 4's log-sum-exp form, as kernel 3's, its two slot halves at
    the chunk's offset less the half's first slot (negative for the
    second half, or past it for the first)."""
    S, half = 256, 128
    k, v = _dense_kv(cuda, 2, S, hkv, d, dtype)
    q = torch.randn((2, tq, hq, d), device=cuda).to(dtype)
    pre = torch.tensor(prefix, dtype=torch.int32, device=cuda)
    out, lse = chunked_prefill_attention(q, k, v, pre, return_lse=True)
    serve = chunked_prefill_attention(q, k, v, pre)
    parts = [chunked_prefill_attention(
        q, k[:, off:off + half], v[:, off:off + half], prefix - off,
        return_lse=True) for off in (0, half)]
    torch.cuda.synchronize()
    assert torch.equal(out, serve)
    ref, ref_lse = chunked_prefill_attention_ref(q, k, v, prefix,
                                                 return_lse=True)
    assert lse.shape == (2, tq, hq)
    assert (lse - ref_lse).abs().max().item() <= LSE_TOL
    comb = attn.combine_stacked(torch.stack([p[0] for p in parts]),
                                torch.stack([p[1] for p in parts]))
    for want in (serve, ref):
        assert (comb.float() - want.float()).abs().max().item() \
            <= TOL[dtype]


#: the scan: float32 sums over a chunk in another order (the reference's
#: kernel tests hold it to the same bound)
SSD_TOL = 2e-3
#: the kernel against its own walk (``ssd_scan_tiled_ref`` with the
#: kernel's rounding): the same operands, float32 sums in another order,
#: relative to the largest output
SSD_WALK_RTOL = 1e-5
#: half a bf16 step of a value v is at most 2^-8 |v|: a bf16 output is the
#: float32 result rounded once
BF16_HALF_STEP = 2.0 ** -8


def _ssd_case(dev, b, t, h, g, n, dtype):
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    x = torch.randn((b, t, h, 64), device=dev, generator=gen)
    dt = torch.nn.functional.softplus(
        torch.randn((b, t, h), device=dev, generator=gen))
    A = -torch.exp(torch.randn((h,), device=dev, generator=gen))
    B = torch.randn((b, t, g, n), device=dev, generator=gen)
    C = torch.randn((b, t, g, n), device=dev, generator=gen)
    s0 = 0.1 * torch.randn((b, h, 64, n), device=dev, generator=gen)
    x, dt, B, C = (a.to(dtype) for a in (x, dt, B, C))
    return x, dt, A, B, C, s0


def _excess(y, ref, dtype):
    """Largest |y - ref| beyond y's own rounding to ``dtype``."""
    slack = BF16_HALF_STEP if dtype == torch.bfloat16 else 0.0
    return ((y.float() - ref).abs() - slack * ref.abs()).max().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("b,t,h,g,n,chunk", [
    (2, 256, 4, 1, 16, 64), (1, 512, 6, 2, 64, 256), (1, 430, 3, 1, 128, 215),
    (2, 96, 4, 1, 32, 96), (1, 300, 2, 1, 64, 4), (1, 887, 4, 1, 64, 1),
    (2, 300, 4, 2, 32, 100), (1, 1100, 2, 1, 64, 100)])
def test_ssd_scan_kernel_matches_plain_version(cuda, b, t, h, g, n, chunk,
                                               dtype):
    """Against the float32 plain version on the same values (2e-3 beyond
    the output's rounding), against the kernel's own walk with its
    rounding (float32 summation order only), and bit-identical over two
    calls.  1100 tokens are 18 tiles: two slices, walked a launch each."""
    x, dt, A, B, C, s0 = _ssd_case(cuda, b, t, h, g, n, dtype)
    before = ssd_scan.launches
    y, s = ssd_scan(x, dt, A, B, C, chunk, s0)
    y0, s_0 = ssd_scan(x, dt, A, B, C, chunk)
    torch.cuda.synchronize()
    assert ssd_scan.launches == before + 2
    assert y.dtype == dtype and s.dtype == torch.float32
    f32 = [a.float() for a in (x, dt, A, B, C)]
    ry, rs = ssd_scan_ref(*f32, chunk, s0)
    ry0, rs0 = ssd_scan_ref(*f32, chunk)
    assert _excess(y, ry, dtype) <= SSD_TOL
    assert (s - rs).abs().max().item() <= SSD_TOL
    assert _excess(y0, ry0, dtype) <= SSD_TOL
    assert (s_0 - rs0).abs().max().item() <= SSD_TOL
    wy, ws = ssd_scan_tiled_ref(*f32, s0, p_round=P_ROUND_SSD[dtype])
    tight = SSD_WALK_RTOL * max(wy.abs().max().item(), 1.0)
    assert _excess(y, wy, dtype) <= tight
    assert (s - ws).abs().max().item() <= \
        SSD_WALK_RTOL * max(ws.abs().max().item(), 1.0)
    y2, s2 = ssd_scan(x, dt, A, B, C, chunk, s0)
    assert torch.equal(y, y2) and torch.equal(s, s2)


def test_ssd_scan_time_does_not_follow_the_chunk(cuda):
    """The kernel walks tiles of its own: chunk 1 and chunk 256 of one
    input launch the same work and give the same bits."""
    x, dt, A, B, C, s0 = _ssd_case(cuda, 1, 1024, 4, 1, 64, torch.bfloat16)
    y1, s1 = ssd_scan(x, dt, A, B, C, 1, s0)
    y256, s256 = ssd_scan(x, dt, A, B, C, 256, s0)
    assert torch.equal(y1, y256) and torch.equal(s1, s256)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("t", [1024, 1025, 2111])
def test_ssd_scan_walks_long_prefills_in_slices(cuda, t, dtype):
    """A launch walks at most 16 tiles (1024 tokens): 1025 tokens take a
    second launch for one token, 2111 three, the last ragged; each slice
    enters with the state the one before left, and the whole meets the
    kernel's walk as one."""
    x, dt, A, B, C, s0 = _ssd_case(cuda, 1, t, 2, 1, 64, dtype)
    f32 = [a.float() for a in (x, dt, A, B, C)]
    wy, ws = ssd_scan_tiled_ref(*f32, s0, p_round=P_ROUND_SSD[dtype])
    y, s = ssd_scan(x, dt, A, B, C, 1, s0)
    torch.cuda.synchronize()
    assert _excess(y, wy, dtype) <= \
        SSD_WALK_RTOL * max(wy.abs().max().item(), 1.0)
    assert (s - ws).abs().max().item() <= \
        SSD_WALK_RTOL * max(ws.abs().max().item(), 1.0)


def test_ssd_scan_reads_strided_inputs_in_place(cuda):
    """x, B and C as the model passes them: views into one [b, t, channels]
    buffer, with a token stride wider than a row."""
    b, t, h, g, n = 2, 150, 4, 1, 64
    x, dt, A, B, C, s0 = _ssd_case(cuda, b, t, h, g, n, torch.bfloat16)
    buf = torch.cat([x.reshape(b, t, h * 64), B.reshape(b, t, g * n),
                     C.reshape(b, t, g * n)], dim=-1)
    xs, Bs, Cs = torch.split(buf, [h * 64, g * n, g * n], dim=-1)
    xs, Bs, Cs = (xs.reshape(b, t, h, 64), Bs.reshape(b, t, g, n),
                  Cs.reshape(b, t, g, n))
    assert not xs.is_contiguous()
    y, s = ssd_scan(xs, dt, A, Bs, Cs, 10, s0)
    ry, rs = ssd_scan(x, dt, A, B, C, 10, s0)
    assert torch.equal(y, ry) and torch.equal(s, rs)


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16],
                         ids=["x_f32", "x_bf16"])
def test_ssd_scan_takes_inputs_in_mixed_types(cuda, x_dtype):
    """dt, B or C in another type than x: the kernel runs on float32 copies
    of all four, as the plain version computes, and y comes in x's type."""
    x, dt, A, B, C, s0 = _ssd_case(cuda, 1, 200, 4, 1, 64, torch.float32)
    x = x.to(x_dtype)
    other = torch.bfloat16 if x_dtype == torch.float32 else torch.float32
    for dt_m, B_m, C_m in [(dt.to(other), B, C),
                           (dt, B.to(other), C.to(other))]:
        y, s = ssd_scan(x, dt_m, A, B_m, C_m, 8, s0)
        ry, rs = ssd_scan(x.float(), dt_m.float(), A, B_m.float(),
                          C_m.float(), 8, s0)
        assert y.dtype == x_dtype
        assert torch.equal(y, ry.to(x_dtype)) and torch.equal(s, rs)


#: the backward against float64 autograd of the plain version, per input:
#: max |g - g_ref| <= tol max |g_ref| (float32 sums in another order and
#: the forward's tensor-core pieces; bf16: the inputs' gradients rounded
#: to bf16 once, 2^-9 of a value, and the forward's bf16 pairs)
SSD_GRAD_TOL = {torch.float32: 2e-3, torch.bfloat16: 2e-2}
#: the backward kernel against its plain walk on the same inputs and tile
#: states, the products' operands rounded as the kernel's tensor cores take
#: them (``BWD_P_ROUND``), per input, relative to its largest value:
#: float32 sums in another order (bf16 outputs: one rounding beyond)
SSD_BWD_WALK_RTOL = {torch.float32: 1e-4, torch.bfloat16: 8e-3}


def _ssd_grad_case(dev, b, t, h, g, n, dtype, with_s0, seed=8):
    x, dt, A, B, C, s0 = _ssd_case(dev, b, t, h, g, n, dtype)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    dy = torch.randn((b, t, h, 64), device=dev, generator=gen)
    ds = torch.randn((b, h, 64, n), device=dev, generator=gen)
    return x, dt, A, B, C, (s0 if with_s0 else None), dy.to(dtype), ds


def _rel_gaps(got, want):
    return [((a.float() - w.float()).abs().max()
             / w.float().abs().max().clamp_min(1e-30)).item()
            for a, w in zip(got, want) if w is not None]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("b,t,h,g,n,chunk,with_s0", [
    (2, 256, 4, 1, 16, 64, True), (1, 150, 4, 2, 32, 50, False),
    (1, 1100, 2, 1, 64, 100, True), (2, 96, 3, 1, 128, 96, True),
    (1, 1075, 112, 1, 64, 215, True), (1, 1024, 64, 1, 128, 256, False),
    (2, 37, 2, 1, 16, 37, True)],
    ids=["n16", "n32_g2", "n64_t1100", "n128", "zamba2_t1075",
         "mamba2_t1024", "t37_one_tile"])
def test_ssd_scan_backward_kernel_matches_plain_walk_and_float64(
        cuda, b, t, h, g, n, chunk, with_s0, dtype):
    """Kernel 5b through ``SSDScanFn``: every input's gradient against
    float64 autograd of ``ssd_scan_ref`` (2e-3 f32, 2e-2 bf16 of the
    largest) and, on the forward kernel's own tile states, against the
    plain reverse walk; bit-identical over two calls.  The forward's y
    and final state under grad are the bits of a ``no_grad`` call."""
    x, dt, A, B, C, s0, dy, ds = _ssd_grad_case(cuda, b, t, h, g, n, dtype,
                                                with_s0)
    ins = [a.detach().clone().requires_grad_(True) if a is not None
           else None for a in (x, dt, A, B, C, s0)]
    before = ssd_scan_bwd.launches
    y, s = ssd_scan(*ins[:5], chunk, ins[5])
    (y.float() * dy.float()).sum().add((s * ds).sum()).backward()
    with torch.no_grad():
        y0, s_0 = ssd_scan(x, dt, A, B, C, chunk, s0)
    torch.cuda.synchronize()
    assert torch.equal(y.detach(), y0) and torch.equal(s.detach(), s_0)
    assert ssd_scan_bwd.launches == before + 1
    got = [a.grad if a is not None else None for a in ins]
    for a, gr in zip(ins, got):
        if a is not None:
            assert gr.dtype == a.dtype and torch.isfinite(gr).all()
    r64 = [a.detach().double().requires_grad_(True) if a is not None
           else None for a in (x, dt, A, B, C, s0)]
    ry, rs = ssd_scan_ref(*r64[:5], chunk, r64[5])
    want = torch.autograd.grad(
        (ry * dy.double()).sum() + (rs * ds.double()).sum(),
        [a for a in r64 if a is not None])
    gaps = _rel_gaps([gr for gr in got if gr is not None], want)
    assert max(gaps) <= SSD_GRAD_TOL[dtype], gaps
    # the kernel against its plain walk on the same tile states
    xk, dtk, Ak, Bk, Ck, s0k = _kernel_inputs(x, dt, A, B, C, chunk, s0)
    _, _, states = _launch_scan(xk, dtk, Ak, Bk, Ck, s0k, True)
    k1 = ssd_scan_bwd(xk, dtk, Ak, Bk, Ck, states, dy, ds)
    k2 = ssd_scan_bwd(xk, dtk, Ak, Bk, Ck, states, dy, ds)
    assert all(torch.equal(p, q) for p, q in zip(k1, k2))
    walk = ssd_scan_bwd_ref(*(a.float() for a in (xk, dtk, Ak, Bk, Ck)),
                            s0k, dy.float(), ds, states=states,
                            p_round=BWD_P_ROUND[dtype])
    gaps = _rel_gaps(k1[:5], walk[:5])
    if s0 is not None:
        gaps += _rel_gaps(k1[5:], walk[5:])
    assert max(gaps) <= SSD_BWD_WALK_RTOL[dtype], gaps


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("t,n", [(150, 64), (1100, 128)])
def test_ssd_scan_states_pointer_leaves_the_outputs_bit_equal(cuda, t, n,
                                                              dtype):
    """The forward with the tile-states pointer writes the same y and
    final state as without (serving passes none), and states that are the
    plain walk's within the scan's tolerance."""
    x, dt, A, B, C, s0 = _ssd_case(cuda, 2, t, 3, 1, n, dtype)
    args = _kernel_inputs(x, dt, A, B, C, 10 if t == 150 else 100, s0)
    y0, s_0, none = _launch_scan(*args, False)
    y1, s_1, states = _launch_scan(*args, True)
    torch.cuda.synchronize()
    assert none is None and states.shape == (2, 3, -(-t // 64), 64, n)
    assert torch.equal(y0, y1) and torch.equal(s_0, s_1)
    want = ssd_tile_states_ref(*(a.float() for a in (x, dt, A, B, C)), s0)
    assert (states - want).abs().max().item() <= SSD_TOL
    assert torch.equal(states[:, :, 0], s0)


def test_ssd_scan_under_grad_launches_both_kernels_never_the_plain_ones(
        cuda, monkeypatch):
    """A CUDA input that requires grad, whichever it is, runs the forward
    kernel and, in backward, kernel 5b; the plain versions never run.
    Under no_grad, or with no input requiring grad, only the forward
    kernel launches and nothing is saved."""
    from repro_torch.kernels.ssd_scan import ops

    def plain(*a, **k):
        raise AssertionError("a plain version ran on the card")

    for name in ("ssd_scan_ref", "ssd_scan_bwd_ref", "ssd_tile_states_ref"):
        monkeypatch.setattr(ops, name, plain)
    x, dt, A, B, C, s0 = _ssd_case(cuda, 1, 200, 2, 1, 16, torch.float32)
    f0, b0 = ssd_scan.launches, ssd_scan_bwd.launches
    for i in range(6):
        args = [x, dt, A, B, C, s0]
        args[i] = args[i].clone().requires_grad_(True)
        y, s = ssd_scan(*args[:5], 8, args[5])
        (y.sum() + s.sum()).backward()
        assert args[i].grad is not None and torch.isfinite(args[i].grad).all()
        assert [a.grad for j, a in enumerate(args) if j != i] == [None] * 5
        with torch.no_grad():
            y, _ = ssd_scan(*args[:5], 8, args[5])
        assert y.grad_fn is None
    y, _ = ssd_scan(x, dt, A, B, C, 8, s0)
    assert y.grad_fn is None
    torch.cuda.synchronize()
    assert ssd_scan.launches == f0 + 13
    assert ssd_scan_bwd.launches == b0 + 6


def test_ssd_scan_bwd_records_its_events_only_when_asked(cuda):
    """Given a list in ``ssd_scan_bwd.events``, each launch appends the
    CUDA events recorded around its kernel; with None it appends none."""
    x, dt, A, B, C, s0, dy, ds = _ssd_grad_case(cuda, 1, 150, 2, 1, 16,
                                                torch.float32, True)
    args = _kernel_inputs(x, dt, A, B, C, 50, s0)
    _, _, states = _launch_scan(*args, True)
    events = []
    ssd_scan_bwd.events = events
    try:
        ssd_scan_bwd(*args[:5], states, dy, ds)
    finally:
        ssd_scan_bwd.events = None
    ssd_scan_bwd(*args[:5], states, dy, ds)
    torch.cuda.synchronize()
    assert len(events) == 1 and events[0][0].elapsed_time(events[0][1]) > 0


def test_mamba2_train_step_on_the_card_matches_the_cpu(cuda):
    """Reduced mamba2-1.3b (at the kernel's head dim of 64) in float32
    under remat: ``loss_and_grads`` on
    the card (both scan kernels) against the CPU (plain versions), every
    leaf within 1e-3 of its largest value; each layer's scan runs twice
    forward (the recompute) and once backward."""
    from repro_torch.training.optimizer import tree_leaves, tree_map
    from repro_torch.training.train import (loss_and_grads,
                                            synthetic_lm_batches)
    cfg = dataclasses.replace(reduced_config("mamba2-1.3b"),
                              dtype="float32", remat=True, ssm_headdim=64)
    params = tf.init_params(5, cfg, device="cpu")
    batch = next(synthetic_lm_batches(cfg, 2, 150, seed=3, device="cpu"))
    gpu = tree_map(lambda a: a.detach().to(cuda), params)
    f0, b0 = ssd_scan.launches, ssd_scan_bwd.launches
    lg, gg = loss_and_grads(gpu, cfg, {k: v.to(cuda)
                                       for k, v in batch.items()})
    torch.cuda.synchronize()
    assert ssd_scan.launches - f0 == 2 * cfg.num_layers
    assert ssd_scan_bwd.launches - b0 == cfg.num_layers
    lc, gc_ = loss_and_grads(params, cfg, batch)
    assert abs(lg.item() - lc.item()) <= 1e-4 * abs(lc.item())
    for a, b in zip(tree_leaves(gg), tree_leaves(gc_)):
        gap = (a.cpu() - b).abs().max().item()
        assert gap <= 1e-3 * b.abs().max().item() + 1e-6, gap


@pytest.mark.parametrize("arch", ["whisper-base", "llava-next-34b"])
def test_encdec_and_vlm_on_the_card_match_the_cpu(cuda, arch):
    """Reduced float32 whisper-base / llava-next-34b: a prefill carrying
    the audio / image embeddings (kernel 4), a second chunk and 3 decode
    steps (kernel 3) on the card against the same on the CPU."""
    cfg = reduced_config(arch)
    params = tf.init_params(0, cfg, device="cpu")
    g = torch.Generator().manual_seed(3)
    B = 2
    if cfg.family == "audio":
        kw = {"audio_embeds": torch.randn((B, 24, cfg.d_model),
                                          generator=g)}
        cross = 24
    else:
        kw = {"image_embeds": torch.randn(
            (B, cfg.num_image_tokens, cfg.vision_dim), generator=g)}
        cross = 0
    tokens = torch.randint(1, cfg.vocab_size, (B, 16), generator=g)
    outs = {}
    for dev in ("cpu", cuda):
        prm = _to(params, dev)
        cache = tf.init_cache(cfg, B, 128, device=dev, cross_len=cross)
        lg, _ = tf.full_prefill(prm, cfg, tokens.to(dev), cache, 8,
                                **{k: v.to(dev) for k, v in kw.items()})
        got = [lg.cpu()]
        pos = torch.full((B,), 16 + (cfg.num_image_tokens
                                     if cfg.family == "vlm" else 0),
                         device=dev)
        tok = lg.argmax(-1)
        for _ in range(3):
            lg, _ = tf.decode_step(prm, cfg, tok[:, None], cache, pos)
            got.append(lg.cpu())
            tok, pos = lg.argmax(-1), pos + 1
        outs[str(dev)] = got
    for a, b in zip(outs["cpu"], outs[str(cuda)]):
        assert (a - b).abs().max().item() <= 1e-4 * max(
            a.abs().max().item(), 1.0)
        assert torch.equal(a.argmax(-1), b.argmax(-1))


def _to(tree, dev):
    """A copy of ``tree`` on ``dev`` (a copy on the CPU too: a train step
    updates its parameters in place)."""
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.detach().to(dev, copy=True)


def test_train_step_on_the_card_matches_the_cpu(cuda):
    """Reduced float32 whisper-base (audio embeddings): loss and every
    gradient leaf on the card against the CPU, then one AdamW step each.
    The first step moves an element by about the learning rate whatever
    its gradient's size (m / sqrt(v) is its sign), so an element whose
    gradient is below the two devices' rounding may move either way: at
    most 2 lr apart, and on at most 0.1 % of the elements more than
    1e-6."""
    from repro_torch.training.optimizer import (AdamWConfig, init_opt_state,
                                                tree_leaves)
    from repro_torch.training.train import loss_and_grads, make_train_step
    cfg = reduced_config("whisper-base")
    params = tf.init_params(0, cfg, device="cpu")
    g = torch.Generator().manual_seed(4)
    tokens = torch.randint(1, cfg.vocab_size, (2, 32), generator=g)
    batch = {"tokens": tokens, "labels": tokens,
             "audio_embeds": torch.randn((2, 24, cfg.d_model), generator=g)}
    res = {}
    for dev in ("cpu", cuda):
        prm = _to(params, dev)
        b = {k: v.to(dev) for k, v in batch.items()}
        loss, grads = loss_and_grads(prm, cfg, b)
        step = make_train_step(cfg, AdamWConfig(lr=3e-4, warmup_steps=1))
        step(prm, init_opt_state(prm), b)
        res[str(dev)] = (loss.item(), [t.cpu() for t in tree_leaves(grads)],
                         [t.detach().cpu() for t in tree_leaves(prm)])
    (l0, g0, p0), (l1, g1, p1) = res["cpu"], res[str(cuda)]
    assert abs(l0 - l1) <= 1e-5 * abs(l0)
    for a, b in zip(g0, g1):
        assert (a - b).abs().max().item() <= 1e-3 * a.abs().max().item() \
            + 1e-6
    gaps = torch.cat([(a - b).abs().flatten() for a, b in zip(p0, p1)])
    assert gaps.max().item() <= 2 * 3e-4
    assert (gaps > 1e-6).float().mean().item() <= 1e-3


def test_dense_and_scan_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    k, v = _dense_kv(cuda, 1, 64, 2, 64, torch.float32)
    q = torch.randn((1, 8, 64), device=cuda)
    ln = torch.tensor([20], dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        decode_attention(q.half(), k, v, ln)
    with pytest.raises(ValueError):     # head_dim 32
        decode_attention(q[..., :32], k[..., :32], v[..., :32], ln)
    with pytest.raises(ValueError):     # a cache on another device
        decode_attention(q, k.cpu(), v.cpu(), ln)
    wide = torch.zeros((1, 64, 2, 68), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):     # head stride 136 bytes
        decode_attention(q.bfloat16(), wide[..., :64], wide[..., :64], ln)
    with pytest.raises(TypeError):
        chunked_prefill_attention(q[:, None].half(), k, v, 0)
    with pytest.raises(ValueError):     # head_dim 96
        chunked_prefill_attention(q[:, None, :, :48], k[..., :48],
                                  v[..., :48], 0)
    with pytest.raises(ValueError):     # k on another device
        chunked_prefill_attention(q[:, None], k.cpu(), v, 0)
    x = torch.randn((1, 32, 2, 64), device=cuda)
    dt = torch.ones((1, 32, 2), device=cuda)
    A = -torch.ones((2,), device=cuda)
    Bm = torch.randn((1, 32, 1, 16), device=cuda)
    with pytest.raises(TypeError):
        ssd_scan(x.half(), dt, A, Bm, Bm, 16)
    with pytest.raises(ValueError):     # head dim 32
        ssd_scan(x[..., :32], dt, A, Bm, Bm, 16)
    with pytest.raises(ValueError):     # state width 8
        ssd_scan(x, dt, A, Bm[..., :8], Bm[..., :8], 16)
    with pytest.raises(ValueError):     # chunk past 256 / not dividing t
        ssd_scan(x, dt, A, Bm, Bm, 24)
    with pytest.raises(ValueError):     # B on another device
        ssd_scan(x, dt, A, Bm.cpu(), Bm, 16)


@pytest.mark.parametrize("d", [256, 32, 96])
def test_dense_wrappers_take_head_dim_256_and_refuse_32_and_96(cuda, d):
    k, v = _dense_kv(cuda, 2, 64, 1, d, torch.bfloat16)
    q = torch.randn((2, 4, d), device=cuda).to(torch.bfloat16)
    ln = torch.tensor([20, 64], dtype=torch.int32, device=cuda)
    if d != 256:
        with pytest.raises(ValueError):
            decode_attention(q, k, v, ln)
        with pytest.raises(ValueError):
            chunked_prefill_attention(q[:, None], k, v, 3)
        return
    before = (decode_attention.launches, chunked_prefill_attention.launches)
    out = decode_attention(q, k, v, ln)
    pre = chunked_prefill_attention(q[:, None], k, v, 3)
    torch.cuda.synchronize()
    assert (decode_attention.launches,
            chunked_prefill_attention.launches) == (before[0] + 1,
                                                    before[1] + 1)
    assert (out.float() - decode_attention_ref(q, k, v, ln).float()
            ).abs().max().item() <= TOL[torch.bfloat16]
    assert (pre.float() - chunked_prefill_attention_ref(
        q[:, None], k, v, 3).float()).abs().max().item() \
        <= TOL[torch.bfloat16]


def test_hybrid_executor_on_the_card_matches_itself_on_the_cpu(cuda):
    """Reduced zamba2 at the kernels' head dims (P 64, attention head dim
    112), float32, greedy: batched dense through the three kernels gives
    the tokens of the plain versions on the CPU, with prompts prefilled
    in several chunks beside running decodes."""
    cfg = dataclasses.replace(reduced_config("zamba2-7b"), ssm_headdim=64,
                              ssm_state=64, head_dim=112, num_heads=2,
                              num_kv_heads=2)
    cpu_params = tf.init_params(6, cfg, device="cpu")
    rng = np.random.default_rng(6)
    prompts = [list(map(int, rng.integers(1, cfg.vocab_size, size=n)))
               for n in (9, 70, 33, 120)]

    def gen(dev):
        ex = TorchExecutor(cfg, _to_dev(cpu_params, dev), n_slots=5,
                           max_seq=256, device=dev)
        inst = Instance(0, D_HEAVY, 48, CostModel(cfg, InstanceSpec(tp=1)),
                        ex, hbm_blocks=512)
        reqs = [Request(prompt_len=len(p), max_new_tokens=8,
                        hidden_output_len=8, prompt_tokens=list(p))
                for p in prompts]
        for r in reqs:
            inst.enqueue_prefill(r)
        now = 0.0
        for _ in range(300):
            if all(r.done() for r in reqs):
                break
            dur, done, _ = inst.run_iteration(now)
            now += dur
            for r in done:
                inst.admit_decode(r)
        assert all(r.done() for r in reqs)
        return [r.output_tokens for r in reqs]

    counts = lambda: (decode_attention.launches,
                      chunked_prefill_attention.launches, ssd_scan.launches)
    before = counts()
    on_card = gen(cuda)
    assert all(a > b for a, b in zip(counts(), before))
    assert on_card == gen(torch.device("cpu"))


@pytest.mark.parametrize("arch", ["whisper-base", "llava-next-34b"])
def test_family_executor_on_the_card_matches_itself_on_the_cpu(cuda, arch):
    """Reduced float32 whisper-base (dense: kernels 3 and 4, a cross cache
    of 0 keys) and llava-next-34b (paged: kernels 1 and 2, K-step
    horizons) served through the executor: the tokens on the card are
    those of the plain versions on the CPU."""
    cfg = reduced_config(arch)
    cpu_params = tf.init_params(7, cfg, device="cpu")
    rng = np.random.default_rng(7)
    prompts = [list(map(int, rng.integers(1, cfg.vocab_size, size=n)))
               for n in (9, 70, 33)]

    def gen(dev):
        ex = TorchExecutor(cfg, _to_dev(cpu_params, dev), n_slots=4,
                           max_seq=256, device=dev)
        inst = Instance(0, D_HEAVY, 48, CostModel(cfg, InstanceSpec(tp=1)),
                        ex, hbm_blocks=512, max_horizon=8)
        reqs = [Request(prompt_len=len(p), max_new_tokens=12,
                        hidden_output_len=12, prompt_tokens=list(p))
                for p in prompts]
        for r in reqs:
            inst.enqueue_prefill(r)
        now = 0.0
        for _ in range(300):
            if all(r.done() for r in reqs):
                break
            dur, done, _ = inst.run_iteration(now)
            now += dur
            for r in done:
                inst.admit_decode(r)
        assert all(r.done() for r in reqs)
        return [r.output_tokens for r in reqs], ex

    kernels = ((paged_decode_attention, paged_chunked_prefill_attention)
               if arch == "llava-next-34b" else
               (decode_attention, chunked_prefill_attention))
    before = [k.launches for k in kernels]
    on_card, ex = gen(cuda)
    assert all(k.launches > b for k, b in zip(kernels, before))
    assert ex.paged == (arch == "llava-next-34b")
    assert (ex.horizon_calls > 0) == ex.paged
    assert on_card == gen(torch.device("cpu"))[0]


def _to_dev(tree, dev):
    if isinstance(tree, dict):
        return {k: _to_dev(x, dev) for k, x in tree.items()}
    if isinstance(tree, list):
        return [_to_dev(x, dev) for x in tree]
    return tree.to(dev)


@pytest.mark.parametrize("kv_quant", [None, "int8"], ids=["fp", "int8"])
def test_executor_on_the_card_matches_itself_on_the_cpu(cuda, kv_quant):
    """Reduced float32 config, greedy: the executor through the CUDA
    kernels generates the tokens it generates on the CPU through the
    plain versions (uneven prompts over several T buckets, decode mixing
    into prefill iterations)."""
    cfg = reduced_config("qwen2.5-3b")
    cpu_params = tf.init_params(5, cfg, device="cpu")

    rng = np.random.default_rng(5)
    prompts = [list(map(int, rng.integers(1, cfg.vocab_size, size=n)))
               for n in (9, 14, 33, 47, 120)]

    def gen(dev):
        ex = TorchExecutor(cfg, _to_dev(cpu_params, dev), n_slots=6,
                           max_seq=256, t_buckets=(8, 16, 32, 64),
                           kv_quant=kv_quant, device=dev)
        inst = Instance(0, D_HEAVY, 48, CostModel(cfg, InstanceSpec(tp=1)),
                        ex, hbm_blocks=512)
        reqs = [Request(prompt_len=len(p), max_new_tokens=8,
                        hidden_output_len=8, prompt_tokens=list(p))
                for p in prompts]
        for r in reqs:
            inst.enqueue_prefill(r)
        now = 0.0
        for _ in range(300):
            if all(r.done() for r in reqs):
                break
            dur, done, _ = inst.run_iteration(now)
            now += dur
            for r in done:
                inst.admit_decode(r)
        assert all(r.done() for r in reqs)
        ex.kv.check_invariants()
        return [r.output_tokens for r in reqs]

    d0 = paged_decode_attention.launches
    p0 = paged_chunked_prefill_attention.launches
    on_card = gen(cuda)
    assert paged_decode_attention.launches > d0
    assert paged_chunked_prefill_attention.launches > p0
    assert on_card == gen(torch.device("cpu"))


# ---------------------------------------------------------------------------
# decode-only steps replayed as CUDA graphs
# ---------------------------------------------------------------------------

#: reduced zamba2 at the kernels' head dims (as the hybrid test above)
def _zamba_cfg():
    return dataclasses.replace(reduced_config("zamba2-7b"), ssm_headdim=64,
                               ssm_state=64, head_dim=112, num_heads=2,
                               num_kv_heads=2)


def _decoding(cfg, dev, n=3, seed=7, **kw):
    """An executor on ``dev`` (weights from seed 7) whose ``n`` requests
    (prompts from ``seed``) have prefilled and entered decode, one token
    each."""
    ex = TorchExecutor(cfg, _to_dev(tf.init_params(7, cfg, "cpu"), dev),
                       n_slots=n + 1, max_seq=256, t_buckets=(8, 16, 32, 64),
                       device=dev, **kw)
    inst = Instance(0, D_HEAVY, 256, CostModel(cfg, InstanceSpec(tp=1)), ex,
                    hbm_blocks=512)
    rng = np.random.default_rng(seed)
    reqs = [Request(prompt_len=m, max_new_tokens=64, hidden_output_len=64,
                    prompt_tokens=list(map(int, rng.integers(
                        1, cfg.vocab_size, size=m))))
            for m in (11, 37, 20, 52)[:n]]
    for r in reqs:
        inst.enqueue_prefill(r)
    dur, done, _ = inst.run_iteration(0.0)
    for r in done:
        inst.admit_decode(r)
    assert all(r.output_len == 1 for r in reqs)
    return ex, inst, reqs


def _paged_step(ex, reqs, K):
    """(key, step function, host inputs) of a K-step paged horizon over
    ``reqs`` at a budget of K each."""
    slots = [ex.slots.slot(r.rid) for r in reqs]
    for r, s in zip(reqs, slots):
        ex.kv.grow_for(s, r.rid, int(ex.positions[s]) + K, False)
    from repro_torch.engine.batching import pack_decode
    p = pack_decode([int(ex.last_token[s]) for s in slots],
                    [int(ex.positions[s]) for s in slots], [K] * len(slots),
                    [ex.kv.tables[s] for s in slots], ex.kv.max_blocks,
                    ex.cache_block_size)
    return (("paged",) + p.tables.shape + (K,),
            lambda *a: (ex._horizon_paged(*a, K=K),),
            (p.tokens, p.start, p.budget, p.tables))


def test_capture_survives_garbage_holding_another_executors_graphs(cuda):
    """Another executor's captured graphs become garbage in a reference
    cycle while this executor captures, with the collector set to run at
    every allocation: a collection inside the capture would destroy those
    graphs and release their pool, which CUDA refuses mid-capture (the
    capture is invalidated and its next launch fails).  The capture keeps
    the collector off, so it completes, and its replay gives the
    uncaptured step's tokens."""
    cfg = reduced_config("qwen2.5-3b")
    old_ex, _, old_reqs = _decoding(cfg, cuda)
    key, fn, host = _paged_step(old_ex, old_reqs, 1)
    old_ex._dispatch(key, fn, *host)
    held = [old_ex.graphs]
    assert len(held[0]) == 1
    del old_ex, old_reqs, fn
    gc.collect()                 # only `held` keeps the old graphs now

    ex, _, reqs = _decoding(cfg, cuda)
    key, fn, host = _paged_step(ex, reqs, 4)
    pool = {n: t.clone() for n, t in ex.kv.pool.items()}
    calls = []
    threshold = gc.get_threshold()

    def collecting_step(*a):
        calls.append(len(calls))
        if len(calls) == 2:           # the capture (the first run is eager)
            cycle = [held.pop()]
            cycle.append(cycle)       # only the collector can free it now
            del cycle
            gc.set_threshold(1, 1, 1)
        try:
            return fn(*a)
        finally:
            gc.set_threshold(*threshold)

    eager = ex._dispatch(key, collecting_step, *host)[0].clone()
    assert len(calls) == 2 and len(ex.graphs) == 1 and not held
    for n, t in pool.items():
        ex.kv.pool[n].copy_(t)
    replayed = ex._dispatch(key, collecting_step, *host)[0]
    assert torch.equal(replayed, eager)
    gc.collect()


def _dense_step(ex, reqs, K):
    budget = np.zeros(ex.n_slots, np.int32)
    for r in reqs:
        budget[ex.slots.slot(r.rid)] = K
    if K == 1:
        return (("dense", 1), lambda *a: (ex._decode_fused(*a),),
                (ex.last_token[:, None], ex.positions, budget))
    return (("dense", K), lambda *a: (ex._horizon_dense(*a, K=K),),
            (ex.last_token, ex.positions, budget))


def _captured_vs_uncaptured(ex, step):
    """Run ``step`` as its graph's replay and as the plain step function,
    each from the same copy of the cache; returns (replayed outputs,
    uncaptured outputs, cache after the replay, cache after the plain
    run)."""
    key, fn, host = step
    cache = ex.kv.pool if ex.paged else ex.cache
    saved = {n: t.clone() for n, t in cache.items()}
    restore = lambda: [cache[n].copy_(t) for n, t in saved.items()]
    ex._dispatch(key, fn, *host)        # first use: eager run, capture
    assert key in ex.graphs.graphs
    restore()
    replayed = [t.clone() for t in ex._dispatch(key, fn, *host)]
    after_replay = {n: t.clone() for n, t in cache.items()}
    restore()
    plain = fn(*(torch.from_numpy(np.array(a)).to(ex.device) for a in host))
    torch.cuda.synchronize()
    return replayed, list(plain), after_replay, cache


@pytest.mark.parametrize("kind", ["paged", "paged-int8", "dense-packed",
                                  "dense-hybrid", "dense-moe",
                                  "dense-window"])
def test_captured_step_equals_uncaptured(cuda, kind):
    """A replay writes the KV (and recurrent state) and returns the tokens
    that the step function run without a graph gives from the same cache,
    bit for bit: the paged horizon, the packed-dense horizon and the
    full-slot-batch dense decode (zamba2, and reduced granite-moe-3b-a800m
    and gemma3-1b, whose 37-token prompt wraps its 32-slot ring)."""
    if kind == "dense-hybrid":
        ex, _, reqs = _decoding(_zamba_cfg(), cuda)
        step = _dense_step(ex, reqs, 1)
    elif kind in ("dense-moe", "dense-window"):
        arch = "granite-moe-3b-a800m" if kind == "dense-moe" else "gemma3-1b"
        ex, _, reqs = _decoding(reduced_config(arch), cuda)
        assert not ex.packed
        step = _dense_step(ex, reqs, 1)
    elif kind == "dense-packed":
        ex, _, reqs = _decoding(reduced_config("qwen2.5-3b"), cuda,
                                paged=False)
        step = _dense_step(ex, reqs, 4)
    else:
        ex, _, reqs = _decoding(reduced_config("qwen2.5-3b"), cuda,
                                kv_quant="int8" if "int8" in kind else None)
        step = _paged_step(ex, reqs, 4)
    replayed, plain, after_replay, after_plain = \
        _captured_vs_uncaptured(ex, step)
    for a, b in zip(replayed, plain):
        assert torch.equal(a, b)
    for n in after_plain:
        assert torch.equal(after_replay[n], after_plain[n]), n


@pytest.mark.parametrize("arch,layers", [("gemma3-1b", 6),
                                         ("granite-moe-3b-a800m", 2)])
def test_full_width_dense_decode_graph_equals_uncaptured(cuda, arch, layers):
    """The full-slot-batch decode at the registered width in bf16 (depth
    cut: gemma3-1b's first period, five ring layers of 1024 slots and one
    global layer at head dim 256; granite's first two layers, 40 experts
    top-8), three requests and an idle slot: the replay against the step
    without a graph, tokens and KV bit for bit."""
    cfg = dataclasses.replace(get_config(arch), num_layers=layers)
    ex = TorchExecutor(cfg, tf.init_params(7, cfg, cuda), n_slots=4,
                       max_seq=2048, device=cuda)
    inst = Instance(0, D_HEAVY, 512, CostModel(cfg, InstanceSpec(tp=1)), ex,
                    hbm_blocks=512)
    rng = np.random.default_rng(8)
    reqs = [Request(prompt_len=m, max_new_tokens=64, hidden_output_len=64,
                    prompt_tokens=list(map(int, rng.integers(
                        1, cfg.vocab_size, size=m))))
            for m in (1100, 300, 517)]
    for r in reqs:
        inst.enqueue_prefill(r)
    now = 0.0
    while any(r.output_len == 0 for r in reqs):
        dur, done, _ = inst.run_iteration(now)
        now += dur
        for r in done:
            inst.admit_decode(r)
    replayed, plain, after_replay, after_plain = \
        _captured_vs_uncaptured(ex, _dense_step(ex, reqs, 1))
    for a, b in zip(replayed, plain):
        assert torch.equal(a, b)
    for n in after_plain:
        assert torch.equal(after_replay[n], after_plain[n]), n


def test_replays_count_the_launches_their_graphs_hold(cuda):
    cfg = reduced_config("qwen2.5-3b")
    ex, _, reqs = _decoding(cfg, cuda)
    key, fn, host = _paged_step(ex, reqs, 4)
    n0 = paged_decode_attention.launches
    ex._dispatch(key, fn, *host)        # eager: 4 steps, 2 layers
    torch.cuda.synchronize()
    assert paged_decode_attention.launches - n0 == 4 * cfg.num_layers
    assert ex.graphs.graphs[key].launches == {
        paged_decode_attention: 4 * cfg.num_layers}
    n1 = paged_decode_attention.launches
    for _ in range(3):
        ex._dispatch(key, fn, *host)
    assert paged_decode_attention.launches - n1 == 3 * 4 * cfg.num_layers
    assert ex.graphs.replays == 3 and ex.graphs.captures == 1


def test_two_buckets_share_one_pool_and_replay_in_turn(cuda):
    """Two horizon buckets (K 2 and 4) captured into one memory pool
    replay in turn, each equal to its uncaptured run."""
    ex, _, reqs = _decoding(reduced_config("qwen2.5-3b"), cuda)
    steps = [_paged_step(ex, reqs, 2), _paged_step(ex, reqs, 4)]
    pool = ex.kv.pool
    saved = {n: t.clone() for n, t in pool.items()}
    restore = lambda: [pool[n].copy_(t) for n, t in saved.items()]
    for key, fn, host in steps:
        ex._dispatch(key, fn, *host)
        restore()
    assert len(ex.graphs) == 2 and ex.graphs.captures == 2
    for _ in range(2):
        for key, fn, host in steps:
            got = ex._dispatch(key, fn, *host)[0].clone()
            restore()
            want = fn(*(torch.from_numpy(np.array(a)).to(cuda)
                        for a in host))[0]
            restore()
            assert torch.equal(got, want)


def test_pool_rebuild_drops_the_graphs(cuda):
    """An instance that hands a paged executor a prefix cache of another
    block count rebuilds its pool: the graphs holding the old pool go,
    and the decode-only steps that follow capture anew and generate the
    CPU's tokens."""
    from repro_torch.cache.prefix_cache import PrefixCache
    cfg = reduced_config("qwen2.5-3b")
    params = tf.init_params(8, cfg, "cpu")

    def run(dev):
        ex = TorchExecutor(cfg, _to_dev(params, dev), n_slots=4,
                           max_seq=256, device=dev)
        if dev.type == "cuda":
            ex._dispatch(*_paged_step_empty(ex))
            assert len(ex.graphs) == 1
        inst = Instance(0, D_HEAVY, 256, CostModel(cfg, InstanceSpec(tp=1)),
                        ex, hbm_blocks=300,
                        prefix_cache=PrefixCache(300, 16))
        assert ex.kv.num_blocks == 300
        if dev.type == "cuda":
            assert len(ex.graphs) == 0
        out = _serve_fresh(cfg, inst)
        if dev.type == "cuda":
            assert len(ex.graphs) > 0
        return out

    assert run(cuda) == run(torch.device("cpu"))


def _paged_step_empty(ex):
    """A one-step horizon bucket over no live row (budget 0: nothing is
    written), to give a fresh executor a graph."""
    host = (np.zeros(1, np.int32), np.zeros(1, np.int32),
            np.zeros(1, np.int32), np.full((1, 1), -1, np.int32))
    return (("paged", 1, 1, 1), lambda *a: (ex._horizon_paged(*a, K=1),),
            *host)


def _serve_fresh(cfg, inst, seed=9):
    rng = np.random.default_rng(seed)
    reqs = [Request(prompt_len=m, max_new_tokens=10, hidden_output_len=10,
                    prompt_tokens=list(map(int, rng.integers(
                        1, cfg.vocab_size, size=m))))
            for m in (13, 29)]
    for r in reqs:
        inst.enqueue_prefill(r)
    now = 0.0
    for _ in range(100):
        if all(r.done() for r in reqs):
            break
        dur, done, _ = inst.run_iteration(now)
        now += dur
        for r in done:
            inst.admit_decode(r)
    assert all(r.done() for r in reqs)
    return [r.output_tokens for r in reqs]


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "hybrid"])
def test_graphs_stay_valid_across_a_migration_landing(cuda, paged):
    """The destination of a migration has captured its decode graphs
    before the state lands (into its pool or dense cache, in place): the
    migrated request and the destination's own go on with the tokens of
    the same run on the CPU."""
    cfg = reduced_config("qwen2.5-3b") if paged else _zamba_cfg()

    def run(dev):
        src, src_inst, moving = _decoding(cfg, dev, n=1, seed=3)
        dst, dst_inst, local = _decoding(cfg, dev, n=2, seed=4)
        for inst in (src_inst, dst_inst):
            for _ in range(3):
                inst.run_iteration(0.0)
        if dev.type == "cuda":
            assert len(dst.graphs) > 0
        dst_inst.inject(moving[0], src_inst.eject(moving[0]))
        reqs = moving + local
        for _ in range(200):
            if all(r.done() for r in reqs):
                break
            dst_inst.run_iteration(0.0)
        assert all(r.done() for r in reqs)
        return [r.output_tokens for r in reqs]

    assert run(cuda) == run(torch.device("cpu"))


def test_nongreedy_replays_draw_new_numbers(cuda):
    """The sampling generator is registered with the graph: two replays
    of one bucket from the same cache draw different tokens, and both
    stay in the vocabulary."""
    cfg = reduced_config("qwen2.5-3b")
    ex, _, reqs = _decoding(cfg, cuda, greedy=False, temperature=2.0)
    key, fn, host = _paged_step(ex, reqs, 8)
    pool = ex.kv.pool
    saved = {n: t.clone() for n, t in pool.items()}
    ex._dispatch(key, fn, *host)
    draws = []
    for _ in range(2):
        for n, t in saved.items():
            pool[n].copy_(t)
        draws.append(ex._dispatch(key, fn, *host)[0][:8, :len(reqs)].clone())
    assert not torch.equal(draws[0], draws[1])
    assert all(((d >= 0) & (d < cfg.vocab_size)).all() for d in draws)


# ---------------------------------------------------------------------------
# the KV tiers' tensor legs and the front end on the card
# ---------------------------------------------------------------------------

def _tier_instance(cfg, params, blocks, quant, spill=0):
    ex = TorchExecutor(cfg, params, n_slots=4, max_seq=256,
                       t_buckets=(8, 16, 32), hbm_blocks=blocks,
                       prefix_cache=True, kv_quant=quant,
                       kv_spill_blocks=spill, device="cuda")
    return ex, Instance(0, D_HEAVY, 32, CostModel(cfg, InstanceSpec(tp=1)),
                        ex, hbm_blocks=blocks)


def _serve_one(inst, prompt, n_out=6):
    r = Request(prompt_len=len(prompt), max_new_tokens=n_out,
                hidden_output_len=n_out, prompt_tokens=list(prompt))
    inst.enqueue_prefill(r)
    now = 0.0
    for _ in range(100):
        if r.done():
            break
        dur, done, _ = inst.run_iteration(now)
        now += dur
        for d in done:
            inst.admit_decode(d)
    assert r.done()
    return r


@pytest.mark.parametrize("kv_quant", [None, "int8"], ids=["fp", "int8"])
def test_spill_round_trip_under_captured_graphs(cuda, kv_quant):
    """The reference's spill case (a 64-token hot prefix, a 128-token cold
    prompt that needs the 12-block pool, the hot prompt again) on the
    card: the promoted blocks are bit-equal to what the pool held before
    the eviction, and the graph captured for the hot request's decode
    before the eviction replays after the promotion (no new capture)
    with the tokens of a run whose prefix never left the pool."""
    cfg = reduced_config("qwen2.5-3b")
    params = _to_dev(tf.init_params(11, cfg, "cpu"), cuda)
    rng = np.random.default_rng(22)
    hot, cold = ([int(x) for x in rng.integers(1, cfg.vocab_size, size=n)]
                 for n in (64, 128))
    _, ctl_inst = _tier_instance(cfg, params, 64, kv_quant)
    _serve_one(ctl_inst, hot)
    never_evicted = _serve_one(ctl_inst, hot)

    ex, inst = _tier_instance(cfg, params, 12, kv_quant, spill=16)
    _serve_one(inst, hot)
    keys = set(ex.graphs.graphs)
    assert keys, "the hot request's decode captured nothing"
    before = ex.export_prefix_blocks(hot)
    _serve_one(inst, cold)
    assert ex.prefix_cache_obj.spilled_blocks >= 4
    captures, replays = ex.graphs.captures, ex.graphs.replays
    c = _serve_one(inst, hot)
    promoted = inst.spill_promoted_tokens // BS
    assert promoted >= 3 and c.cached_prefix_len >= 48
    after = ex.export_prefix_blocks(hot)
    for name, t in before["paged_blocks"].items():
        assert t.device.type == "cpu"
        assert torch.equal(after["paged_blocks"][name][:, :promoted * BS],
                           t[:, :promoted * BS]), name
    assert ex.graphs.captures == captures
    assert ex.graphs.replays > replays
    assert set(ex.graphs.graphs) >= keys
    assert c.output_tokens == never_evicted.output_tokens
    ex.kv.check_invariants()


def _http(port, method, path, body=None, timeout=120):
    raw = b"" if body is None else json.dumps(body).encode()
    s = socket.create_connection(("127.0.0.1", port), timeout=timeout)
    try:
        s.sendall((f"{method} {path} HTTP/1.1\r\nHost: t\r\n"
                   f"Content-Length: {len(raw)}\r\n"
                   "Connection: close\r\n\r\n").encode() + raw)
        data = b""
        while chunk := s.recv(65536):
            data += chunk
    finally:
        s.close()
    head, _, payload = data.partition(b"\r\n\r\n")
    return int(head.split(b" ", 2)[1]), payload


def _sse_text(payload):
    body, rest = b"", payload
    while rest:
        size, _, rest = rest.partition(b"\r\n")
        n = int(size, 16)
        if n == 0:
            break
        body += rest[:n]
        rest = rest[n + 2:]
    text, done = "", False
    for ev in body.split(b"\n\n"):
        if ev == b"data: [DONE]":
            done = True
        elif ev.startswith(b"data: "):
            text += json.loads(ev[len(b"data: "):])["choices"][0]["text"]
    return text, done


def test_capture_while_the_http_thread_serves_metrics(cuda):
    """The front end over a live loop on the card with no graph captured
    yet: its decode buckets are captured on the engine thread while
    clients stream and another thread scrapes ``/metrics`` without
    pause, and every stream carries its request's detokenised tokens."""
    from repro_torch.core.latency import SLO
    from repro_torch.core.policies import Sliders
    from repro_torch.frontend import (ByteTokenizer, FrontendConfig,
                                      FrontendServer)
    from repro_torch.serving import ServingLoop, WallClock
    from repro_torch.sim.simulator import ServingConfig, build_cluster
    cfg = reduced_config("qwen2.5-3b")
    params = _to_dev(tf.init_params(12, cfg, "cpu"), cuda)
    slo = SLO(ttft=5.0, tpot=0.5)
    sc = ServingConfig(model="qwen2.5-3b", tp=1, policy="taichi",
                       sliders=Sliders(n_p=1, n_d=1, s_p=64, s_d=32),
                       hbm_blocks=512)
    cluster = build_cluster(
        sc, slo, async_exec=True,
        executor_factory=lambda: TorchExecutor(cfg, params, n_slots=8,
                                               max_seq=512, device="cuda"))
    cluster.set_horizon(4)
    loop = ServingLoop(cluster, slo, clock=WallClock(), pace=True)
    srv = FrontendServer(loop, FrontendConfig(port=0, tok_workers=1))
    server = threading.Thread(target=srv.run, daemon=True)
    server.start()
    stop, scrapes, out = threading.Event(), [], {}

    def scrape():
        while not stop.is_set():
            scrapes.append(_http(srv.port, "GET", "/metrics")[0])

    def client(i):
        out[i] = _http(srv.port, "POST", "/v1/completions",
                       {"prompt": f"card client {i}", "max_tokens": 12,
                        "stream": True})

    try:
        assert srv.started.wait(timeout=120)
        scraper = threading.Thread(target=scrape, daemon=True)
        scraper.start()
        clients = [threading.Thread(target=client, args=(i,), daemon=True)
                   for i in range(4)]
        for t in clients:
            t.start()
        for t in clients:
            t.join(timeout=120)
        stop.set()
        scraper.join(timeout=120)
    finally:
        stop.set()
        srv.shutdown()
        server.join(timeout=120)
    assert not server.is_alive()
    assert scrapes and set(scrapes) == {200}
    assert cluster.exec_errors == 0, cluster.last_exec_error
    assert sum(i.executor.graphs.captures for i in cluster.instances) > 0
    by_prompt = {tuple(r.prompt_tokens): r for r in loop.requests}
    for i in range(4):
        status, payload = out[i]
        text, done = _sse_text(payload)
        assert status == 200 and done
        r = by_prompt[tuple(ByteTokenizer.encode(f"card client {i}"))]
        assert len(r.output_tokens) == 12
        assert text == ByteTokenizer.decode(r.output_tokens)


def test_serve_refuses_without_a_card_unless_given_the_cpu(cuda):
    """``--serve`` with the card hidden exits saying there is no CUDA
    device; with ``--device cpu`` it serves on the CPU."""
    import pathlib
    import signal
    import subprocess
    import sys
    src = str(pathlib.Path(__file__).resolve().parents[1] / "src")
    env = {**os.environ, "PYTHONPATH": src, "CUDA_VISIBLE_DEVICES": ""}
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--engine",
           "live", "--serve", "127.0.0.1:0", "--arch", "smollm-135m",
           "--reduced", "--tok-workers", "0"]
    refused = subprocess.run(cmd, capture_output=True, text=True, env=env,
                             timeout=120)
    assert refused.returncode != 0
    assert "no CUDA device" in refused.stderr
    proc = subprocess.Popen(cmd + ["--device", "cpu"], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)
    try:
        line = ""
        for line in proc.stdout:
            if line.startswith("serving "):
                break
        assert line.startswith("serving ") and " on cpu " in line, line
        port = int(line.split("http://127.0.0.1:")[1].split()[0])
        status, payload = _http(port, "POST", "/v1/completions",
                                {"prompt": "hi", "max_tokens": 4,
                                 "stream": True})
        assert status == 200 and _sse_text(payload)[1]
        proc.send_signal(signal.SIGINT)
        proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=120)
    assert proc.returncode == 0


@pytest.fixture
def nccl_mesh(cuda, tmp_path):
    """A one-rank NCCL process group (a FileStore in ``tmp_path``) and the
    (1, 1) local mesh over it, torn down after the test."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_local_mesh
    store = dist.FileStore(str(tmp_path / "store"), 1)
    dist.init_process_group("nccl", store=store, rank=0, world_size=1,
                            device_id=torch.device("cuda:0"))
    try:
        yield make_local_mesh(model=1)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("kv_mode", ["auto", "seq"])
def test_tp_local_sharded_forward_matches_plain(nccl_mesh, kv_mode):
    """qwen2.5-3b at reduced width, float32: DTensor parameters and a
    dense cache sharded by ``param_specs`` / ``cache_specs`` on the
    one-rank mesh give the plain tensors' greedy tokens and logits (to the
    kernels' float32 tolerance), and the sharded run reaches kernels 3
    and 4 on local shards.  ``seq`` splits the cache along its slot axis:
    the read of the rank's slot shard (the kernels' log-sum-exp form and
    the all-reduce combine over the one-rank group)."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.distributed import hints
    from repro_torch.distributed import sharding as shd
    cfg = reduced_config("qwen2.5-3b")
    dev = torch.device("cuda")
    B, T, steps, S = 2, 64, 4, 80
    params = tf.init_params(0, cfg, device=dev)
    prompt = torch.from_numpy(np.random.default_rng(4).integers(
        1, cfg.vocab_size, size=(B, T))).to(dev)

    def run(prm, cache, mesh=None):
        whole = (lambda t: t.full_tensor()) if mesh is not None else \
            (lambda t: t)
        out = []
        ctx = (hints.hints(("data",), "model", mesh=mesh)
               if mesh is not None else contextlib.nullcontext())
        with torch.no_grad(), implicit_replication(), ctx:
            last, cache = tf.prefill(prm, cfg, prompt, cache,
                                     torch.zeros(B, dtype=torch.long,
                                                 device=dev))
            out.append(whole(last))
            for i in range(steps):
                last, cache = tf.decode_step(
                    prm, cfg, out[-1].argmax(-1)[:, None], cache,
                    torch.full((B,), T + i, dtype=torch.long, device=dev))
                out.append(whole(last))
        return torch.stack(out)

    plain = run(params, tf.init_cache(cfg, B, S, device=dev))
    mesh = nccl_mesh
    n0 = decode_attention.launches, chunked_prefill_attention.launches
    sharded = run(shd.shard(mesh, shd.param_specs(cfg, 1), params),
                  shd.shard(mesh, shd.cache_specs(cfg, mesh, B, S,
                                                  kv_mode=kv_mode),
                            tf.init_cache(cfg, B, S, device=dev)), mesh)
    assert decode_attention.launches - n0[0] == steps * cfg.num_layers
    assert chunked_prefill_attention.launches - n0[1] == cfg.num_layers
    assert torch.equal(plain.argmax(-1), sharded.argmax(-1))
    torch.testing.assert_close(sharded, plain, atol=TOL[torch.float32],
                               rtol=0)


def test_host_spans_start_at_their_profiler_mirrors(cuda):
    """A served run on the card under ``torch.profiler``: each of the
    program's host spans starts within 50 us of the profiler range that
    mirrors it (one clock), and no span is drawn on the device."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.latency import SLO
    from repro_torch.launch import serve
    from repro_torch.serving.tracing import HOST_SPANS

    args = serve.parse_args(["--engine", "live", "--reduced", "--arch",
                             "smollm-135m", "--qps", "4", "--n", "16"])
    _, loop, _, _ = serve.live_loop(args, SLO(ttft=5.0, tpot=0.5))
    loop.run(max_steps=24)                  # builds, captures, warms up
    with profile(activities=[ProfilerActivity.CPU]):
        loop.run(max_steps=8)               # the profiler's first ranges
    HOST_SPANS.clear()                      # the next session: the trace's
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        loop.run()
        torch.cuda.synchronize()
    spans = list(HOST_SPANS.spans)
    names = {s.name for s in spans}
    assert {"loop.run", "exec.enqueue.mixed", "exec.fetch"} <= names
    events = list(prof.profiler.kineto_results.events())
    mirrors = sorted((e for e in events if e.name() in names
                      and e.device_type() == DeviceType.CPU),
                     key=lambda e: e.start_ns())
    assert [e.name() for e in mirrors] == [s.name for s in spans]
    gaps = [e.start_ns() - s.t0 for e, s in zip(mirrors, spans)]
    assert max(abs(g) for g in gaps) <= 50_000, (min(gaps), max(gaps))
    assert not [e.name() for e in events if e.name() in names
                and e.device_type() == DeviceType.CUDA]
    ms = [HOST_SPANS.device_ms(s) for s in spans
          if s.name.startswith("exec.enqueue.")]
    assert ms and all(m is not None and m >= 0 for m in ms)
