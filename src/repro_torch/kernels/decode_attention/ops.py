"""GQA flash-decode: the wrappers of the CUDA kernels
``csrc/paged_decode.cu`` (a paged pool) and ``csrc/decode.cu`` (a dense
per-row cache), and their plain PyTorch versions.

``paged_decode_attention`` replaces the Pallas kernel
``paged_decode_attention_kernel`` of
``repro/kernels/decode_attention/paged_decode.py``; ``decode_attention``
replaces ``decode_attention_kernel`` of ``decode_attention/decode_attn.py``
(both wrapped in the reference's ``decode_attention/ops.py``).  On the
card both are bound by the KV bytes they read: one query token a row does
a few FLOPs for every byte of the row's keys and values.  The design reads
the cache in place (the flat ``[P, Hkv, D]`` pool through the block table,
the dense ``[B, S, Hkv, D]`` cache through its strides: no transposed copy
as the reference's wrappers make), walks the KV axis in a loop inside one
thread block per (row, KV head) and keeps the online softmax state on
chip.  It does not yet split the KV axis over thread blocks
(flash-decoding's second combine pass), so at a few dozen (row, KV head)
pairs most SMs idle: that is the first thing to change when these kernels
are made fast.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.paged_args import (check_launch, dense_args,
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
    out = torch.empty_like(q)
    lib = build.load_library()
    with torch.cuda.device(q.device):
        err = lib.paged_decode_attention(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            tables.data_ptr(), lengths.data_ptr(), ptr(k_scale),
            ptr(v_scale), out.data_ptr(), B, Hq, k_pool.shape[1], D,
            tables.shape[1], block_size, n_blk, s_tok, s_head, sc_tok,
            q_code, kv_code, torch.cuda.current_stream().cuda_stream)
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
    capped at S.  Head dims 64, 112 and 128, up to 16 query heads a KV
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
    out = torch.empty_like(q)
    lib = build.load_library()
    with torch.cuda.device(q.device):
        err = lib.dense_decode_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), B, Hq, k.shape[2], D, S, s_b, s_tok, s_head,
            q_code, kv_code, torch.cuda.current_stream().cuda_stream)
    check_launch(err, "decode_attention")
    decode_attention.launches += 1
    return out


#: kernel launches made by this wrapper (the plain version never counts)
decode_attention.launches = 0
