"""Paged GQA flash-decode: the wrapper of the CUDA kernel
``csrc/paged_decode.cu`` and its plain PyTorch version.

Replaces the Pallas kernel ``paged_decode_attention_kernel`` of
``repro/kernels/decode_attention/paged_decode.py`` (wrapper
``decode_attention/ops.py::paged_decode_attention``).  On the card the
kernel is bound by the KV bytes it reads: one query token a row does a few
FLOPs for every byte of the row's keys and values.  The design reads the
flat ``[P, Hkv, D]`` pool in place through the block table (no transposed
copy of the pool, as the reference's wrapper makes), walks the KV axis in
a loop inside one thread block per (row, KV head) and keeps the online
softmax state on chip.  It does not yet split the KV axis over thread
blocks (flash-decoding's second combine pass), so at a few dozen
(row, KV head) pairs most SMs idle: that is the first thing to change
when this kernel is made fast.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.paged_args import (check_launch, gather_kv,
                                            masked_softmax, pool_args, ptr)


def paged_decode_attention_ref(q, k_pool, v_pool, tables, lengths, *,
                               block_size: int, k_scale=None, v_scale=None):
    """Plain PyTorch version: gather each row's KV through its table,
    dequantise, masked softmax in float32.  Same arguments and result as
    :func:`paged_decode_attention`."""
    B, Hq, D = q.shape
    Hkv = k_pool.shape[1]
    G = Hq // Hkv
    kd = gather_kv(k_pool, k_scale, tables, block_size)    # [B,S,Hkv,D]
    vd = gather_kv(v_pool, v_scale, tables, block_size)
    S = kd.shape[1]
    mask = (torch.arange(S, device=q.device)[None, :]
            < lengths.to(torch.int64)[:, None])            # [B,S]
    qg = q.float().reshape(B, Hkv, G, D)
    s = torch.einsum("bkgd,bskd->bkgs", qg, kd) * (D ** -0.5)
    p = masked_softmax(s, mask[:, None, None, :])
    o = torch.einsum("bkgs,bskd->bkgd", p, vd)
    return o.reshape(B, Hq, D).to(q.dtype)


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
