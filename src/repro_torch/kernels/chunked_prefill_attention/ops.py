"""Chunked-prefill attention: the wrappers of the CUDA kernels
``csrc/paged_prefill.cu`` (per-row chunk geometry over a paged pool) and
``csrc/chunked_prefill.cu`` (one chunk offset over a dense per-row
cache), and their plain PyTorch versions.

``paged_chunked_prefill_attention`` replaces the Pallas kernel
``paged_prefill_attention_kernel`` of
``repro/kernels/chunked_prefill_attention/paged_prefill.py``;
``chunked_prefill_attention`` replaces ``chunked_prefill_attention_kernel``
of ``chunked_prefill_attention/chunked_attn.py`` (both wrapped in the
reference's ``chunked_prefill_attention/ops.py``).  On the card a long
chunk is bound by operations (``4 * Hq * D`` FLOPs for every query-key
pair under the causal frontier) and a short one by the KV bytes it reads.
The design gives one thread block the G query heads of a KV head for a
tile of tokens, so the group shares each K/V tile; stops the KV walk at
the tile's causal frontier; lets tiles past ``valid`` leave at once (a
decode row in a mixed batch costs one KV pass); and reads q as
``[B, Tq, Hq, D]`` and the cache in place (the flat ``[P, Hkv, D]`` pool,
or the dense ``[B, S, Hkv, D]`` cache through its strides).  A bf16 query
over a bf16 or int8 cache runs both products on the tensor cores
(``mma.sync``, 64-key tiles brought in by ``cp.async``, P into P V as a
bf16 pair); a float32 query or cache keeps f32 FMA products.
:func:`tiled_prefill_ref` repeats the tensor-core body's tile walk in
plain PyTorch for the tests.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.paged_args import (MIN_DENOMINATOR, NEG_INF,
                                            check_launch, dense_args,
                                            gather_kv, masked_softmax,
                                            pool_args, ptr)

#: the tensor-core body's tiling: query rows a warp owns (the MMA's M) and
#: a thread block (four warps), keys of a K/V tile
WARP_ROWS = 16
BLOCK_ROWS = 64
TILE_KEYS = 64
#: how the tensor-core body rounds P into P V (``PrefillMmaTile::accumulate``
#: in ``csrc/prefill_kernel.cuh``): one bf16 put cases above half the bf16
#: tolerance, the pair hi + lo does not (PERF.md)
P_ROUND = "pair"


def _attend(q, kd, vd, mask):
    """q [B, Tq, Hq, D] over float32 keys/values [B, S, Hkv, D] with a
    mask [B, Tq, S]: masked softmax in float32, result in q's type."""
    B, Tq, Hq, D = q.shape
    Hkv = kd.shape[2]
    qg = q.float().reshape(B, Tq, Hkv, Hq // Hkv, D)
    s = torch.einsum("btkgd,bskd->bkgts", qg, kd) * (D ** -0.5)
    p = masked_softmax(s, mask[:, None, None, :, :])
    o = torch.einsum("bkgts,bskd->btkgd", p, vd)
    return o.reshape(B, Tq, Hq, D).to(q.dtype)


def _chunk_mask(S: int, Tq: int, start, end, device):
    """``kpos <= start + t`` and ``kpos < end``; start/end [B] -> [B,Tq,S]."""
    kpos = torch.arange(S, device=device)[None, None, :]
    qpos = (start[:, None]
            + torch.arange(Tq, device=device)[None, :])[:, :, None]
    return (kpos <= qpos) & (kpos < end[:, None, None])


def _round_p(p, p_round):
    """P as it enters P V: unrounded (``None``), rounded to one bf16
    (``"bf16"``), or as the bf16 pair hi + lo (``"pair"``)."""
    if p_round is None:
        return p
    hi = p.to(torch.bfloat16).float()
    if p_round == "bf16":
        return hi
    if p_round == "pair":
        return hi + (p - hi).to(torch.bfloat16).float()
    raise ValueError(f"unknown p_round {p_round!r}")


def tiled_prefill_ref(q, kd, vd, start, valid, *, k_scale=None,
                      v_scale=None, p_round=None):
    """Plain PyTorch walk of the tensor-core body of the prefill kernels,
    tile by tile; only tests use it.

    q [B, Tq, Hq, D]; kd, vd [B, S, Hkv, D] in their stored values (int8
    values as floats), k_scale / v_scale [B, S, Hkv] per-key scales or
    None; start, valid [B].  The query rows ``token * G + head`` of one
    KV head are cut into tiles of ``BLOCK_ROWS`` rows (whole tokens); a
    tile wholly past ``valid`` is zeros.  Its keys up to
    ``min(start + valid, start + t0 + tokens, S)`` are walked in tiles of
    ``TILE_KEYS``: the score times the K scale and ``D ** -0.5``, masked
    (``kpos <= start + t`` and below the walk's end) only where the tile
    straddles the first query of a warp's 16 rows or the end, an online
    softmax with -1e30 for a masked score, P times the V scale and then
    rounded as ``p_round`` says, the denominator floored at 1e-30."""
    B, Tq, Hq, D = q.shape
    S, Hkv = kd.shape[1], kd.shape[2]
    G = Hq // Hkv
    TQ = BLOCK_ROWS // G
    TK = TILE_KEYS
    out = torch.zeros((B, Tq, Hq, D), dtype=torch.float32)
    qf, kd, vd = q.float().cpu(), kd.float().cpu(), vd.float().cpu()
    pad = (0, 0, 0, 0, 0, TK)
    kd, vd = (torch.nn.functional.pad(x, pad) for x in (kd, vd))
    if k_scale is not None:
        k_scale, v_scale = (torch.nn.functional.pad(x.float().cpu(),
                                                    (0, 0, 0, TK))
                            for x in (k_scale, v_scale))
    for b in range(B):
        st, vl = int(start[b]), int(valid[b])
        for t0 in range(0, min(vl, Tq), TQ):
            n_tok = min(TQ, Tq - t0)
            r = torch.arange(n_tok * G)
            qpos = st + t0 + r // G
            warp_q0 = st + t0 + (r // WARP_ROWS * WARP_ROWS) // G
            hi = min(st + vl, st + t0 + n_tok, S)
            for h in range(Hkv):
                rows = qf[b, t0:t0 + n_tok, h * G:(h + 1) * G].reshape(-1, D)
                m = torch.full((len(r),), NEG_INF)
                l = torch.zeros(len(r))
                acc = torch.zeros(len(r), D)
                for kv0 in range(0, hi, TK):
                    kpos = torch.arange(kv0, kv0 + TK)
                    s = rows @ kd[b, kv0:kv0 + TK, h].T * (D ** -0.5)
                    if k_scale is not None:
                        s = s * k_scale[b, kv0:kv0 + TK, h]
                    full = (kv0 + TK <= hi) & (kv0 + TK - 1 <= warp_q0)
                    live = ((kpos[None] <= qpos[:, None])
                            & (kpos[None] < hi)) | full[:, None]
                    s = torch.where(live, s, torch.full((), NEG_INF))
                    m_new = torch.maximum(m, s.max(dim=-1).values)
                    alpha = torch.exp(m - m_new)
                    p = torch.where(live, torch.exp(s - m_new[:, None]),
                                    torch.zeros(()))
                    l = l * alpha + p.sum(dim=-1)
                    if v_scale is not None:
                        p = p * v_scale[b, kv0:kv0 + TK, h]
                    acc = (acc * alpha[:, None]
                           + _round_p(p, p_round) @ vd[b, kv0:kv0 + TK, h])
                    m = m_new
                o = acc / l.clamp_min(MIN_DENOMINATOR)[:, None]
                out[b, t0:t0 + n_tok, h * G:(h + 1) * G] = o.reshape(
                    n_tok, G, D)
    return out.to(device=q.device, dtype=q.dtype)


def paged_chunked_prefill_attention_ref(q, k_pool, v_pool, tables, start,
                                        valid, *, block_size: int,
                                        k_scale=None, v_scale=None):
    """Plain PyTorch version: gather each row's KV through its table,
    dequantise, masked softmax in float32 with the kernel's mask
    (``kpos <= start + t`` and ``kpos < start + valid``).  Same arguments
    and result as :func:`paged_chunked_prefill_attention`; tokens past
    ``valid`` hold values the caller drops."""
    kd = gather_kv(k_pool, k_scale, tables, block_size)    # [B,S,Hkv,D]
    vd = gather_kv(v_pool, v_scale, tables, block_size)
    start = start.to(torch.int64)
    mask = _chunk_mask(kd.shape[1], q.shape[1], start,
                       start + valid.to(torch.int64), q.device)
    return _attend(q, kd, vd, mask)


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


def _prefix_tensor(prefix, device):
    """The chunk offset as a [1] int32 tensor on ``device`` (a device
    scalar stays on the device: nobody waits to learn its value)."""
    if isinstance(prefix, torch.Tensor):
        return prefix.reshape(1).to(device=device, dtype=torch.int32)
    return torch.tensor([int(prefix)], dtype=torch.int32, device=device)


def chunked_prefill_attention_ref(q, k, v, prefix):
    """Plain PyTorch version: masked softmax in float32 with the mask of
    ``chunked_attn.py`` (``kpos <= prefix + t`` and ``kpos < prefix +
    Tq``).  Same arguments and result as :func:`chunked_prefill_attention`."""
    B, Tq = q.shape[:2]
    start = _prefix_tensor(prefix, q.device).to(torch.int64).expand(B)
    mask = _chunk_mask(k.shape[1], Tq, start, start + Tq, q.device)
    return _attend(q, k.float(), v.float(), mask)


def chunked_prefill_attention(q, k, v, prefix):
    """Dense chunked-prefill attention: every row of q [B, Tq, Hq, D] is a
    chunk of Tq tokens at absolute offset ``prefix`` (an int, or a
    one-element int tensor on q's device), attending over its row of k, v
    [B, S, Hkv, D] (read in place; slots < prefix + Tq valid, causal
    within the chunk).  Head dims 64, 112, 128 and 256, up to 16 query
    heads a KV head, float32 or bfloat16.  Returns [B, Tq, Hq, D] in q's type.

    A CUDA tensor launches the kernel (or raises); only a CPU tensor goes
    to the plain version."""
    if q.device.type == "cpu":
        return chunked_prefill_attention_ref(q, k, v, prefix)
    if q.device.type != "cuda":
        raise RuntimeError(f"unsupported device {q.device}")
    q = q.contiguous()
    B, Tq, Hq, D = q.shape
    S, s_b, s_tok, s_head, q_code, kv_code = dense_args(q, k, v)
    pre = _prefix_tensor(prefix, q.device)
    out = torch.empty_like(q)
    lib = build.load_library()
    with torch.cuda.device(q.device):
        err = lib.dense_chunked_prefill_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), pre.data_ptr(),
            out.data_ptr(), B, Tq, Hq, k.shape[2], D, S, s_b, s_tok, s_head,
            q_code, kv_code, torch.cuda.current_stream().cuda_stream)
    check_launch(err, "chunked_prefill_attention")
    chunked_prefill_attention.launches += 1
    return out


#: kernel launches made by this wrapper (the plain version never counts)
chunked_prefill_attention.launches = 0
