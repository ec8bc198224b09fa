"""GQA attention with KV-cache support for chunked-prefill / decode — the
reference's ``models/attention.py`` without cross-attention.

Cache layout per attention layer: ``{"k": [B, S, Hkv, Dh], "v": ...}``
(dense) or ``{"k": [P + 1, Hkv, Dh], "v": ...}`` (paged block pool, see
``paged_write``).  ``S`` is the cache capacity: the full max sequence for
global layers or the sliding window for gemma3-style local layers (a ring
buffer: position p lives in slot ``p % S``).  Keys are stored with RoPE
already applied at their absolute position, so reads are position-free.
Masks are computed analytically from the per-row write position.

Where the reference returns an updated copy of a donated cache buffer,
the port UPDATES THE CACHE IN PLACE and returns the same tensors.

The cache read goes through the hand-written kernels' wrappers — paged
decode / chunked prefill over a block pool, dense decode / chunked
prefill over a per-row cache: on a CUDA tensor they launch the kernel,
on a CPU tensor they take the plain version.  A dense chunk padded to a
common length (``valid_len`` with T > 1) is the one read left to a
masked softmax, as in the reference, and so is the sliding-window read
(no Pallas kernel of the reference computes it).  Cross-attention belongs
to the slice that ports the encoder-decoder and VLM families.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.chunked_prefill_attention.ops import (
    chunked_prefill_attention, paged_chunked_prefill_attention)
from repro_torch.kernels.decode_attention.ops import (decode_attention,
                                                      paged_decode_attention)
# rows with no valid key (all-masked) come out zero, as the kernels' do
from repro_torch.kernels.paged_args import masked_softmax as _masked_softmax
from repro_torch.models.common import apply_rope, dense_init, rms_norm


def init_attention(gen: torch.Generator, cfg, *, rope: bool = True):
    d, dh = cfg.d_model, cfg.head_dim
    hq, hkv = cfg.num_heads, cfg.num_kv_heads
    dt, dev = cfg.param_dtype, gen.device
    p = {
        "wq": dense_init(gen, (d, hq * dh), dt),
        "wk": dense_init(gen, (d, hkv * dh), dt),
        "wv": dense_init(gen, (d, hkv * dh), dt),
        "wo": dense_init(gen, (hq * dh, d), dt),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((hq * dh,), dtype=dt, device=dev)
        p["bk"] = torch.zeros((hkv * dh,), dtype=dt, device=dev)
        p["bv"] = torch.zeros((hkv * dh,), dtype=dt, device=dev)
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros((dh,), dtype=dt, device=dev)
        p["k_norm"] = torch.zeros((dh,), dtype=dt, device=dev)
    return p


def _project_qkv(p, cfg, x):
    B, T, _ = x.shape
    hq, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, T, hq, dh)
    k = k.reshape(B, T, hkv, dh)
    v = v.reshape(B, T, hkv, dh)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return q, k, v


def _gqa_scores(q, k):
    """q [B,T,Hq,D], k [B,S,Hkv,D] -> scores [B,Hkv,G,T,S]."""
    B, T, hq, dh = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    qg = q.reshape(B, T, hkv, g, dh)
    return torch.einsum("btkgd,bskd->bkgts", qg, k) * (dh ** -0.5)


def _gqa_out(probs, v, wo):
    """probs [B,Hkv,G,T,S], v [B,S,Hkv,D] -> [B,T,d_model]."""
    B, hkv, g, T, S = probs.shape
    out = torch.einsum("bkgts,bskd->btkgd", probs, v)
    out = out.reshape(B, T, hkv * g * v.shape[-1])
    return out @ wo


def causal_mask(q_pos, kv_pos, window: int = 0):
    """q_pos [B,T], kv_pos [B,S] absolute positions -> mask [B,1,1,T,S]."""
    m = kv_pos[:, None, :] <= q_pos[:, :, None]
    m = m & (kv_pos[:, None, :] >= 0)
    if window:
        m = m & ((q_pos[:, :, None] - kv_pos[:, None, :]) < window)
    return m[:, None, None, :, :]


def ring_slot_positions(write_end, capacity: int):
    """Absolute position held by each ring-buffer slot after sequential
    writes ending at ``write_end`` (exclusive), -1 for a slot not yet
    written.  write_end: [B] -> [B, capacity]."""
    j = torch.arange(capacity, device=write_end.device)[None, :]
    last = write_end[:, None].long() - 1
    a = last - torch.remainder(last - j, capacity)
    return torch.where((a >= 0) & (write_end[:, None] > 0), a,
                       torch.full_like(a, -1))


def quantize_int8(x):
    """Symmetric per-token int8 KV quantization: x [..., D] ->
    (q int8 [..., D], scale f32 [...]) with ``x ~= q * scale``.  The
    scale is amax/127 per (token, kv head); all-zero tokens (fresh pool
    slots, padding) get scale 1 so dequantization is exact zero.
    ``torch.round`` rounds half to even, as the reference does."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def paged_destinations(positions, tables, block_size: int, P: int,
                       valid_len=None):
    """Flat pool slot [B*T] of every new token: ``tables[b, pos // bs] *
    bs + pos % bs``, or the dump slot ``P`` for tokens that must not land
    (padding beyond ``valid_len``, unallocated blocks)."""
    T = positions.shape[1]
    NB = tables.shape[1]
    bi = torch.div(positions, block_size, rounding_mode="floor")
    blk = torch.gather(tables, 1, bi.clamp(0, NB - 1).long())
    ok = (blk >= 0) & (bi < NB)
    if valid_len is not None:
        ok = ok & (torch.arange(T, device=positions.device)[None, :]
                   < valid_len[:, None])
    dest = torch.where(ok, blk * block_size + positions % block_size,
                       torch.full_like(blk, P))
    return dest.reshape(-1).long()


def paged_write(cache_k, cache_v, k_new, v_new, positions, tables,
                block_size: int, valid_len=None, dest=None):
    """Scatter [B,T] new KV into a physical block pool, IN PLACE.

    cache_k/cache_v: [P + 1, Hkv, D] flat-token pools (P = num_blocks *
    bs, block-major) whose last row is a dump slot that nothing reads.
    The reference routes invalid tokens to the out-of-range slot P and
    lets the scatter drop them; a scatter here has no drop mode, and a
    boolean-mask select would force a device sync in every layer, so the
    same slot P exists and swallows them — a fixed-shape ``index_copy_``.
    positions: [B,T] absolute positions; tables: [B,NB] int32 block
    tables (entry < 0 = unallocated).  ``dest`` may carry the result of
    :func:`paged_destinations` computed once for all layers.
    Returns the same two tensors.
    """
    B, T = k_new.shape[:2]
    if dest is None:
        dest = paged_destinations(positions, tables, block_size,
                                  cache_k.shape[0] - 1, valid_len)
    cache_k.index_copy_(0, dest, k_new.reshape((B * T,) + k_new.shape[2:])
                        .to(cache_k.dtype))
    cache_v.index_copy_(0, dest, v_new.reshape((B * T,) + v_new.shape[2:])
                        .to(cache_v.dtype))
    return cache_k, cache_v


def paged_gather(pool, tables, block_size: int):
    """Gather a per-row dense KV view [B, NB*bs, Hkv, D] from the block
    pool, plus logical kv positions [B, NB*bs] (-1 for unallocated
    blocks).  The kernels dereference the table themselves instead of
    materializing this view; it serves tests and tools."""
    B, NB = tables.shape
    idx = (tables.clamp(min=0).long()[:, :, None] * block_size
           + torch.arange(block_size, device=tables.device)[None, None, :])
    dense = pool[idx.reshape(B, NB * block_size)]
    kv_pos = torch.where(
        torch.repeat_interleave(tables >= 0, block_size, dim=1),
        torch.arange(NB * block_size, device=tables.device)[None, :],
        torch.full((1, 1), -1, device=tables.device, dtype=torch.long))
    return dense, kv_pos


def write_cache(cache_k, cache_v, k_new, v_new, start, valid_len=None):
    """Write [B,T] new KV at absolute positions start..start+T (per row)
    into dense caches [B, S, Hkv, D], IN PLACE.  start: [B] int.  The
    slot of position p is ``p % S`` (a ring buffer when S is a window).
    Assumes T <= S.

    valid_len: optional [B] — rows padded to a common T bucket only
    write their first ``valid_len`` tokens.  A padding token keeps its
    own (distinct) slot and writes back what the slot already holds, so
    the scatter keeps a fixed shape and needs no spare slot.
    """
    B, T = k_new.shape[:2]
    S = cache_k.shape[1]
    dev = k_new.device
    pos = start[:, None] + torch.arange(T, device=dev)[None, :]
    slots = (pos % S).long()
    bidx = torch.arange(B, device=dev)[:, None].expand(B, T)
    k_new = k_new.to(cache_k.dtype)
    v_new = v_new.to(cache_v.dtype)
    if valid_len is not None:
        keep = (torch.arange(T, device=dev)[None, :]
                < valid_len[:, None])[:, :, None, None]
        k_new = torch.where(keep, k_new, cache_k[bidx, slots])
        v_new = torch.where(keep, v_new, cache_v[bidx, slots])
    cache_k[bidx, slots] = k_new
    cache_v[bidx, slots] = v_new
    return cache_k, cache_v


def self_attention(p, cfg, x, positions, cache=None, *, window: int = 0,
                   rope: bool = True, valid_len=None, block_tables=None,
                   rope_cs=None, write_dest=None):
    """positions: [B,T] absolute positions of x's tokens.

    cache=None  -> pure in-chunk causal attention.
    cache={k,v} -> write chunk into cache, attend over full cache (chunked
                   prefill when T>1, decode when T==1).
    window      -> a sliding window (gemma3 local layers): the cache is a
                   ring buffer of S = min(window, max_seq) slots.
    valid_len   -> optional [B] per-row valid token counts for T-padded
                   batched prefill: padding KV writes are dropped, padded
                   queries are masked off by causality (their outputs are
                   discarded by the caller).  With T == 1 a row mask:
                   rows with 0 write no KV and read as if they had.
    block_tables -> optional ``(tables [B,NB] int32, block_size)``: the
                   cache is a PAGED pool ({k,v}: [P + 1, Hkv, D]) and each
                   row's KV is addressed through its block table.
    rope_cs / write_dest -> optional per-forward precomputations
                   (``common.rope_tables``, ``paged_destinations``) shared
                   by all layers.
    Returns (out [B,T,d], cache); the cache is updated in place.
    """
    B, T, _ = x.shape
    if valid_len is not None and cache is None:
        raise NotImplementedError("valid_len packing requires a KV cache")
    if block_tables is not None and (cache is None or window):
        raise NotImplementedError(
            "paged KV requires a full (non-windowed) cache")
    q, k, v = _project_qkv(p, cfg, x)
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta, rope_cs)
        k = apply_rope(k, positions, cfg.rope_theta, rope_cs)
    if block_tables is not None:
        return _paged_attention(p, cfg, x, q, k, v, positions, cache,
                                block_tables, valid_len, write_dest)
    if cache is None:
        mask = causal_mask(positions, positions, window)
        probs = _masked_softmax(_gqa_scores(q, k), mask)
        return _gqa_out(probs.to(x.dtype), v, p["wo"]), None
    if window:
        return _ring_attention(p, x, q, k, v, positions, cache, window,
                               valid_len)
    held = None
    if T == 1 and valid_len is not None:
        # decode of a full slot batch: a row the step does not schedule
        # writes no KV, yet reads as the reference's unmasked decode does,
        # its own key at its frontier included, so that what it hands the
        # next layers (an MoE's routing among them) is the reference's.
        # Its frontier slot is written, read, then given back.
        rows = torch.arange(B, device=x.device)
        slots = positions[:, 0].long() % cache["k"].shape[1]
        held = cache["k"][rows, slots], cache["v"][rows, slots]
    ck, cv = write_cache(cache["k"], cache["v"], k, v, positions[:, 0],
                         None if held is not None else valid_len)
    if T == 1:
        # decode: the dense decode kernel over each row's first
        # position + 1 keys
        o = decode_attention(q[:, 0], ck, cv,
                             (positions[:, -1] + 1).to(torch.int32))[:, None]
        if held is not None:
            write_cache(ck, cv, held[0][:, None], held[1][:, None],
                        positions[:, 0], 1 - valid_len)
    elif valid_len is None:
        # exact-shape chunk: the dense chunked-prefill kernel takes one
        # offset for the batch (the engine prefills dense rows one slot
        # at a time)
        o = chunked_prefill_attention(q, ck, cv, positions[0, 0])
    else:
        # T-padded rows of unequal offsets: masked softmax over the cache
        S = ck.shape[1]
        # full cache written sequentially: slot j holds position j once
        # the row's frontier has passed it
        write_end = positions[:, -1] + 1
        j = torch.arange(S, device=x.device)[None, :]
        kv_pos = torch.where(j < write_end[:, None], j,
                             torch.full_like(j, -1))
        mask = causal_mask(positions, kv_pos)
        probs = _masked_softmax(_gqa_scores(q, ck), mask)
        return _gqa_out(probs.to(x.dtype), cv, p["wo"]), cache
    out = o.reshape(B, T, -1).to(x.dtype) @ p["wo"]
    return out, cache


def _ring_attention(p, x, q, k, v, positions, cache, window: int,
                    valid_len=None):
    """Sliding-window attention over a ring-buffer cache [B, S, Hkv, D]
    (S = min(window, max_seq)).  Writing first would overwrite keys still
    needed by the chunk's early queries, so the chunk attends over the
    prior cache plus its own fresh keys, then writes itself (its last S
    tokens when T >= S).  ``valid_len`` drops the writes it excludes (a
    row mask at T == 1: the rows a full-slot-batch decode does not
    schedule); it changes no read.  Returns (out, cache), the cache
    updated in place."""
    T = x.shape[1]
    S = cache["k"].shape[1]
    start = positions[:, 0]
    kv_pos = torch.cat([ring_slot_positions(start, S), positions.long()],
                       dim=1)
    mask = causal_mask(positions, kv_pos, window)
    k_all = torch.cat([cache["k"], k], dim=1)
    v_all = torch.cat([cache["v"], v], dim=1)
    probs = _masked_softmax(_gqa_scores(q, k_all), mask)
    out = _gqa_out(probs.to(x.dtype), v_all, p["wo"])
    if T >= S:
        k, v = k[:, -S:], v[:, -S:]
        start = positions[:, -1] + 1 - S
        if valid_len is not None:
            valid_len = torch.clamp(valid_len - (T - S), min=0)
    write_cache(cache["k"], cache["v"], k, v, start, valid_len)
    return out, cache


def _paged_attention(p, cfg, x, q, k, v, positions, cache, block_tables,
                     valid_len, write_dest=None):
    """Write the chunk into the block pool, attend over the row's
    table-resident KV.  T == 1 goes to the paged decode kernel, T > 1
    (chunked prefill, and the decode rows with ``valid == 1`` of a mixed
    batch) to the paged chunked-prefill kernel."""
    B, T, _ = x.shape
    tables, bs = block_tables
    quant = "k_scale" in cache
    scales = {}
    if quant:
        # int8 tier: quantize the chunk once at write time; scales live
        # in sibling [P + 1, Hkv] pools addressed by the same destinations
        k, ks = quantize_int8(k)
        v, vs = quantize_int8(v)
        if write_dest is None:
            write_dest = paged_destinations(
                positions, tables, bs, cache["k"].shape[0] - 1, valid_len)
        paged_write(cache["k_scale"], cache["v_scale"], ks, vs, positions,
                    tables, bs, valid_len, write_dest)
        scales = dict(k_scale=cache["k_scale"], v_scale=cache["v_scale"])
    ck, cv = paged_write(cache["k"], cache["v"], k, v, positions, tables,
                         bs, valid_len, write_dest)
    if T == 1:
        o = paged_decode_attention(
            q[:, 0], ck, cv, tables, (positions[:, -1] + 1).to(torch.int32),
            block_size=bs, **scales)
        o = o[:, None]
    else:
        valid = (valid_len if valid_len is not None
                 else torch.full((B,), T, dtype=torch.int32, device=x.device))
        o = paged_chunked_prefill_attention(
            q, ck, cv, tables, positions[:, 0].to(torch.int32),
            valid.to(torch.int32), block_size=bs, **scales)
    out = o.reshape(B, T, -1).to(x.dtype) @ p["wo"]
    return out, cache


def cross_attention(p, cfg, x, kv, kv_valid=None):
    raise NotImplementedError(
        "cross-attention is not in the port yet: it comes with the next "
        "slice, which ports the encoder-decoder (whisper) and VLM (llava) "
        "families")
