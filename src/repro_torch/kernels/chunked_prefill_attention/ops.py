"""Paged chunked-prefill attention with per-row chunk geometry: the
wrapper of the CUDA kernel ``csrc/paged_prefill.cu`` and its plain
PyTorch version.

Replaces the Pallas kernel ``paged_prefill_attention_kernel`` of
``repro/kernels/chunked_prefill_attention/paged_prefill.py`` (wrapper
``chunked_prefill_attention/ops.py::paged_chunked_prefill_attention``).
On the card a long chunk is bound by operations (``4 * Hq * D`` FLOPs for
every query-key pair under the causal frontier) and a short one by the KV
bytes it reads.  The design gives one thread block the G query heads of a
KV head for a tile of tokens, so the group shares each K/V tile; stops the
KV walk at the tile's causal frontier; lets tiles past ``valid`` leave at
once (a decode row in a mixed batch costs one KV pass); and reads q as
``[B, Tq, Hq, D]`` and the pool as the flat ``[P, Hkv, D]`` in place.
Its two products are f32 FMA loops, far from the tensor-core rate:
``mma``/``wgmma`` on bf16 tiles is the first thing to change when this
kernel is made fast.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.paged_args import (check_launch, gather_kv,
                                            masked_softmax, pool_args, ptr)


def paged_chunked_prefill_attention_ref(q, k_pool, v_pool, tables, start,
                                        valid, *, block_size: int,
                                        k_scale=None, v_scale=None):
    """Plain PyTorch version: gather each row's KV through its table,
    dequantise, masked softmax in float32 with the kernel's mask
    (``kpos <= start + t`` and ``kpos < start + valid``).  Same arguments
    and result as :func:`paged_chunked_prefill_attention`; tokens past
    ``valid`` hold values the caller drops."""
    B, Tq, Hq, D = q.shape
    Hkv = k_pool.shape[1]
    G = Hq // Hkv
    kd = gather_kv(k_pool, k_scale, tables, block_size)    # [B,S,Hkv,D]
    vd = gather_kv(v_pool, v_scale, tables, block_size)
    S = kd.shape[1]
    start = start.to(torch.int64)
    kpos = torch.arange(S, device=q.device)[None, None, :]
    qpos = (start[:, None]
            + torch.arange(Tq, device=q.device)[None, :])[:, :, None]
    end = (start + valid.to(torch.int64))[:, None, None]
    mask = (kpos <= qpos) & (kpos < end)                   # [B,Tq,S]
    qg = q.float().reshape(B, Tq, Hkv, G, D)
    s = torch.einsum("btkgd,bskd->bkgts", qg, kd) * (D ** -0.5)
    p = masked_softmax(s, mask[:, None, None, :, :])
    o = torch.einsum("bkgts,bskd->btkgd", p, vd)
    return o.reshape(B, Tq, Hq, D).to(q.dtype)


def paged_chunked_prefill_attention(q, k_pool, v_pool, tables, start, valid,
                                    *, block_size: int, k_scale=None,
                                    v_scale=None):
    """Paged chunked-prefill attention with PER-ROW chunk geometry.

    q: [B, Tq, Hq, D] (rows padded to a common Tq bucket);
    k_pool/v_pool: [P, Hkv, D]; tables: int32 [B, NB]; start/valid: int32
    [B] per-row absolute chunk offset and valid token count (valid == 1
    rows are decode steps, valid == 0 rows padding); k_scale/v_scale:
    [P, Hkv] f32 per-token scales for int8 pools.
    Returns [B, Tq, Hq, D] in q's type; tokens beyond ``valid`` are to be
    discarded by the caller (finite, but not those of the plain version).

    A CUDA tensor launches the kernel (or raises); only a CPU tensor goes
    to the plain version."""
    if q.device.type == "cpu":
        return paged_chunked_prefill_attention_ref(
            q, k_pool, v_pool, tables, start, valid, block_size=block_size,
            k_scale=k_scale, v_scale=v_scale)
    if q.device.type != "cuda":
        raise RuntimeError(f"unsupported device {q.device}")
    q = q.contiguous()
    tables = tables.to(torch.int32).contiguous()
    start = start.to(torch.int32).contiguous()
    valid = valid.to(torch.int32).contiguous()
    B, Tq, Hq, D = q.shape
    n_blk, s_tok, s_head, sc_tok, q_code, kv_code = pool_args(
        q, k_pool, v_pool, tables, block_size, k_scale, v_scale)
    if start.shape != (B,) or valid.shape != (B,) or tables.shape[0] != B \
            or start.device != q.device or valid.device != q.device:
        raise ValueError("tables/start/valid do not match q's batch")
    out = torch.empty_like(q)
    lib = build.load_library()
    with torch.cuda.device(q.device):
        err = lib.paged_chunked_prefill_attention(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            tables.data_ptr(), start.data_ptr(), valid.data_ptr(),
            ptr(k_scale), ptr(v_scale), out.data_ptr(), B, Tq, Hq,
            k_pool.shape[1], D, tables.shape[1], block_size, n_blk, s_tok,
            s_head, sc_tok, q_code, kv_code,
            torch.cuda.current_stream().cuda_stream)
    check_launch(err, "paged_chunked_prefill_attention")
    paged_chunked_prefill_attention.launches += 1
    return out


#: kernel launches made by this wrapper (the plain version never counts)
paged_chunked_prefill_attention.launches = 0
