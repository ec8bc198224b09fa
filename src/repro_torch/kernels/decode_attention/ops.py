"""GQA flash-decode: the wrappers of the CUDA kernels
``csrc/paged_decode.cu`` (a paged pool) and ``csrc/decode.cu`` (a dense
per-row cache), and their plain PyTorch versions.

``paged_decode_attention`` replaces the Pallas kernel
``paged_decode_attention_kernel`` of
``repro/kernels/decode_attention/paged_decode.py``; ``decode_attention``
replaces ``decode_attention_kernel`` of ``decode_attention/decode_attn.py``
(both wrapped in the reference's ``decode_attention/ops.py``).  On the
card both are bound by the KV bytes they read: one query token a row does
about 2 G FLOPs for every byte of the row's keys and values.  The design
reads the cache in place (the flat ``[P, Hkv, D]`` pool through the block
table, the dense ``[B, S, Hkv, D]`` cache through its strides: no
transposed copy as the reference's wrappers make) and splits the KV axis
(flash-decoding): pass 1 gives each (row, KV head, ``keys_per_split``
keys) a thread block whose warps stream 32-key tiles in by ``cp.async``
(bf16 tensor-core products for a bf16 query, f32 FMA otherwise) and
writes an unnormalised partial (acc, m, l) to a workspace, pass 2
combines a row's live splits.  :func:`keys_per_split` sizes the splits from the
shapes alone so that the grid holds a few thread blocks an SM.  A wrapper
call counts one launch, whatever number of passes it runs.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.paged_args import (MIN_DENOMINATOR, NEG_INF,
                                            check_launch, dense_args,
                                            gather_kv, masked_softmax,
                                            pool_args, ptr)


def _attend(q, kd, vd, mask):
    """q [B, Hq, D] over float32 keys/values [B, S, Hkv, D] with a key
    mask [B, S]: masked softmax in float32, result in q's type."""
    B, Hq, D = q.shape
    Hkv = kd.shape[2]
    qg = q.float().reshape(B, Hkv, Hq // Hkv, D)
    s = torch.einsum("bkgd,bskd->bkgs", qg, kd) * (D ** -0.5)
    p = masked_softmax(s, mask[:, None, None, :])
    o = torch.einsum("bkgs,bskd->bkgd", p, vd)
    return o.reshape(B, Hq, D).to(q.dtype)


def split_decode_ref(q, kd, vd, lengths, keys_per_split: int):
    """Plain PyTorch version of the kernels' two passes, over gathered
    float32 keys/values ``[B, S, Hkv, D]``: pass 1 gives every split of
    ``keys_per_split`` keys its running max ``m`` (-1e30 where the split
    has no key), its sum ``l`` and its unnormalised ``acc``; pass 2 takes
    the ``ceil(length / keys_per_split)`` live splits of each row, rescales
    them by ``exp(m_s - m_max)`` and divides by ``max(l, 1e-30)``.  Same
    result as :func:`_attend` up to summation order; only tests use it."""
    B, Hq, D = q.shape
    S, Hkv = kd.shape[1], kd.shape[2]
    n = -(-S // keys_per_split)
    pad = n * keys_per_split - S
    kd = torch.nn.functional.pad(kd, (0, 0, 0, 0, 0, pad))
    vd = torch.nn.functional.pad(vd, (0, 0, 0, 0, 0, pad))
    ln = lengths.to(torch.int64).clamp(0, S)
    pos = torch.arange(n * keys_per_split, device=q.device)
    mask = (pos[None, :] < ln[:, None]).reshape(B, 1, 1, n, keys_per_split)
    qg = q.float().reshape(B, Hkv, Hq // Hkv, D)
    s = torch.einsum("bkgd,bskd->bkgs", qg, kd) * (D ** -0.5)
    s = torch.where(mask, s.reshape(s.shape[:3] + (n, keys_per_split)),
                    torch.full((), NEG_INF))                 # [B,k,g,n,j]
    m = s.max(dim=-1).values                                 # [B,k,g,n]
    p = torch.where(mask, torch.exp(s - m[..., None]), torch.zeros(()))
    l = p.sum(dim=-1)
    acc = torch.einsum("bkgnj,bnjkd->bkgnd", p,
                       vd.reshape(B, n, keys_per_split, Hkv, D))
    # pass 2
    live = (torch.arange(n, device=q.device)[None, :] * keys_per_split
            < ln[:, None])[:, None, None, :]                 # [B,1,1,n]
    m_max = torch.where(live, m, torch.full((), NEG_INF)).max(dim=-1).values
    w = torch.where(live, torch.exp(m - m_max[..., None]), torch.zeros(()))
    den = (w * l).sum(dim=-1).clamp_min(MIN_DENOMINATOR)
    o = (w[..., None] * acc).sum(dim=-2) / den[..., None]
    return o.reshape(B, Hq, D).to(q.dtype)


#: keys a tile of the kernels (one a lane of a warp); a split is a multiple
TILE_KEYS = 32
#: thread blocks pass 1 aims for: two for each of the H100's 132 SMs.  A
#: thread block of the bf16 kernel at D 128 holds 141 KB of tile ring, so
#: one stays resident an SM; two a SM gives the longest rows enough splits
#: to spread over the card while each split still amortises its set-up
#: (lengths, table entries, Q) over several tiles.  Measured at
#: chip_smoke.py's shapes: 264 blocks beat 132 and 528 for the bf16 pool and
#: the dense cache; the int8 pool (two resident an SM) gains from 528.
TARGET_BLOCKS = 2 * 132
#: table entries one split may span (the kernel stages them in shared
#: memory): keys_per_split stays at or under 256 pages
MAX_SPLIT_PAGES = 256


def keys_per_split(B: int, Hkv: int, width: int,
                   block_size: int = 0) -> int:
    """Keys a thread block of pass 1 takes, from the shapes alone: the
    table width ``width`` (``NB * block_size``, or the dense cache's S)
    cut into ``ceil(TARGET_BLOCKS / (B * Hkv))`` splits, rounded up to a
    whole tile, and for a paged pool no more than ``MAX_SPLIT_PAGES``
    pages.  It reads no device value, so a launch needs no host sync.
    The lengths are not known here: with contexts far below the width
    fewer splits are live (pass 1 skips the rest at once), which is why
    the engine's table width follows the batch's contexts."""
    splits = -(-TARGET_BLOCKS // max(1, B * Hkv))
    kps = -(-max(1, width) // splits)
    kps = -(-kps // TILE_KEYS) * TILE_KEYS
    if block_size:
        cap = MAX_SPLIT_PAGES * block_size // TILE_KEYS * TILE_KEYS
        kps = min(kps, max(TILE_KEYS, cap))
    return kps


def _workspace(q, width: int, kps: int):
    """(splits, acc, m, l) of pass 1; no workspace for a single split,
    whose pass 1 writes the output itself."""
    splits = -(-width // kps)
    if splits == 1:
        return splits, None, None, None
    B, Hq, D = q.shape
    f32 = dict(dtype=torch.float32, device=q.device)
    return (splits, torch.empty((B, Hq, splits, D), **f32),
            torch.empty((B, Hq, splits), **f32),
            torch.empty((B, Hq, splits), **f32))


def _key_mask(S: int, lengths, device):
    return (torch.arange(S, device=device)[None, :]
            < lengths.to(torch.int64)[:, None])            # [B, S]


def paged_decode_attention_ref(q, k_pool, v_pool, tables, lengths, *,
                               block_size: int, k_scale=None, v_scale=None):
    """Plain PyTorch version: gather each row's KV through its table,
    dequantise, masked softmax in float32.  Same arguments and result as
    :func:`paged_decode_attention`."""
    kd = gather_kv(k_pool, k_scale, tables, block_size)    # [B,S,Hkv,D]
    vd = gather_kv(v_pool, v_scale, tables, block_size)
    return _attend(q, kd, vd, _key_mask(kd.shape[1], lengths, q.device))


def paged_decode_attention(q, k_pool, v_pool, tables, lengths, *,
                           block_size: int, k_scale=None, v_scale=None):
    """Paged flash-decode: q [B, Hq, D] attends over KV held in a
    physical block pool through per-sequence block tables.

    k_pool/v_pool: [P, Hkv, D] (flat token axis, block-major; rows past
    ``(P // block_size) * block_size`` are never read); tables: int32
    [B, NB] (entries < 0 are unallocated); lengths: int32 [B] context
    lengths; k_scale/v_scale: [P, Hkv] f32 per-token scales for int8
    pools.  Returns [B, Hq, D] in q's type.

    A CUDA tensor launches the kernel (or raises); only a CPU tensor goes
    to the plain version."""
    if q.device.type == "cpu":
        return paged_decode_attention_ref(
            q, k_pool, v_pool, tables, lengths, block_size=block_size,
            k_scale=k_scale, v_scale=v_scale)
    if q.device.type != "cuda":
        raise RuntimeError(f"unsupported device {q.device}")
    q = q.contiguous()
    tables = tables.to(torch.int32).contiguous()
    lengths = lengths.to(torch.int32).contiguous()
    B, Hq, D = q.shape
    n_blk, s_tok, s_head, sc_tok, q_code, kv_code = pool_args(
        q, k_pool, v_pool, tables, block_size, k_scale, v_scale)
    if lengths.shape != (B,) or tables.shape[0] != B \
            or lengths.device != q.device:
        raise ValueError("tables/lengths do not match q's batch")
    Hkv, NB = k_pool.shape[1], tables.shape[1]
    kps = keys_per_split(B, Hkv, NB * block_size, block_size)
    splits, ws_acc, ws_m, ws_l = _workspace(q, NB * block_size, kps)
    out = torch.empty_like(q)
    lib = build.load_library()
    with torch.cuda.device(q.device):
        err = lib.paged_decode_attention(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            tables.data_ptr(), lengths.data_ptr(), ptr(k_scale),
            ptr(v_scale), out.data_ptr(), ptr(ws_acc), ptr(ws_m),
            ptr(ws_l), B, Hq, Hkv, D, NB, block_size, n_blk, kps, splits,
            s_tok, s_head, sc_tok, q_code, kv_code,
            torch.cuda.current_stream().cuda_stream)
    check_launch(err, "paged_decode_attention")
    paged_decode_attention.launches += 1
    return out


#: kernel launches made by this wrapper (the plain version never counts)
paged_decode_attention.launches = 0


def decode_attention_ref(q, k, v, lengths):
    """Plain PyTorch version: masked softmax in float32 over the first
    ``lengths[b]`` keys of each row.  Same arguments and result as
    :func:`decode_attention`."""
    return _attend(q, k.float(), v.float(),
                   _key_mask(k.shape[1], lengths, q.device))


def decode_attention(q, k, v, lengths):
    """Dense flash-decode: q [B, Hq, D] attends over the first
    ``lengths[b]`` keys of its row of k, v [B, S, Hkv, D] (any layout
    whose last axis is contiguous; read in place).  lengths: int [B],
    capped at S.  Head dims 64, 112, 128 and 256, up to 16 query heads a KV
    head, float32 or bfloat16.  Returns [B, Hq, D] in q's type; a row with
    no key comes out zero.

    A CUDA tensor launches the kernel (or raises); only a CPU tensor goes
    to the plain version."""
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, lengths)
    if q.device.type != "cuda":
        raise RuntimeError(f"unsupported device {q.device}")
    q = q.contiguous()
    lengths = lengths.to(torch.int32).contiguous()
    B, Hq, D = q.shape
    S, s_b, s_tok, s_head, q_code, kv_code = dense_args(q, k, v)
    if lengths.shape != (B,) or lengths.device != q.device:
        raise ValueError("lengths do not match q's batch")
    Hkv = k.shape[2]
    kps = keys_per_split(B, Hkv, S)
    splits, ws_acc, ws_m, ws_l = _workspace(q, S, kps)
    out = torch.empty_like(q)
    lib = build.load_library()
    with torch.cuda.device(q.device):
        err = lib.dense_decode_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), ptr(ws_acc), ptr(ws_m), ptr(ws_l), B, Hq, Hkv,
            D, S, kps, splits, s_b, s_tok, s_head, q_code, kv_code,
            torch.cuda.current_stream().cuda_stream)
    check_launch(err, "decode_attention")
    decode_attention.launches += 1
    return out


#: kernel launches made by this wrapper (the plain version never counts)
decode_attention.launches = 0
