"""Decoder stack of the port — the decoder-only block types (ATTN,
ATTN_LOCAL, MOE, MAMBA2, ZAMBA_ATTN) of the reference's
``models/transformer.py``.

Entry points (plain functions on dicts of tensors):

  init_params(seed, cfg, device)              -> params
  init_cache(cfg, batch, max_seq, ...)        -> dense cache
  init_paged_cache(cfg, num_blocks, bs, ...)  -> block-pool cache
  forward(params, cfg, tokens, positions, cache, ...) -> (out, cache, aux)

Parameters are ``{"embed", "lm_head", "final_norm", "layers": [block,
...]}`` with one block dict a layer, in execution order, plus
``"shared_attn"`` for the hybrid family (zamba2: one attention block whose
weights every ZAMBA_ATTN layer shares).  The reference stacks each pattern
position over its scan periods, and ``repro_torch.convert.params_from_jax``
un-stacks that layout into this one.  A Python loop over the layers stands
where the reference scans.

A cache is a dict of tensors stacked over the layers that hold them:
``"k"``/``"v"`` over the full-cache attention layers (ATTN, MOE,
ZAMBA_ATTN), ``"k_local"``/``"v_local"`` over the sliding-window ones
(ATTN_LOCAL: ring buffers of ``min(window, max_seq)`` slots),
``"conv"``/``"ssm"`` over the recurrent ones (MAMBA2, ZAMBA_ATTN; ``ssm``
is float32).  Layer ``l`` works on views of its entries and UPDATES THEM
IN PLACE, where the reference threads a donated buffer through its scan.
``forward`` returns the same cache object.

Encoder-decoder blocks and the VLM projector (image inputs) raise and name
the slice that brings them.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models import attention as attn_lib
from repro_torch.models import mamba2 as m2
from repro_torch.models import moe as moe_lib
from repro_torch.models.common import (dense_init, init_mlp, mlp, rms_norm,
                                       rope_tables)
from repro_torch.models.config import (ATTN, ATTN_LOCAL, MAMBA2, MOE,
                                       ZAMBA_ATTN, ModelConfig)

#: block types whose layers hold full-cache attention KV, a ring buffer,
#: recurrent state
KV_BLOCKS = (ATTN, MOE, ZAMBA_ATTN)
RING_BLOCKS = (ATTN_LOCAL,)
STATE_BLOCKS = (MAMBA2, ZAMBA_ATTN)
PORTED = (ATTN, ATTN_LOCAL, MOE, MAMBA2, ZAMBA_ATTN)
_NEXT_SLICE = ("the next slice, which ports the encoder-decoder (whisper) "
               "and VLM (llava) families")


def _unported(btype: str):
    return NotImplementedError(
        f"block type {btype!r} is not in the port yet: decoder-only "
        "stacks (full and sliding-window attention, MoE, Mamba2, zamba2) "
        f"are; encoder-decoder blocks come with {_NEXT_SLICE}")


def layer_types(cfg: ModelConfig):
    """Block type of every layer, in execution order."""
    return [b for seg in cfg.segments() for _ in range(seg.n_periods)
            for b in seg.pattern]


def _check_ported(cfg: ModelConfig):
    for b in layer_types(cfg):
        if b not in PORTED:
            raise _unported(b)


def kv_leaves(btype: str):
    """The cache entries that hold a layer of type ``btype``'s KV."""
    return ("k_local", "v_local") if btype in RING_BLOCKS else ("k", "v")


def cache_slots(cfg: ModelConfig):
    """For every layer, ``(kv index, state index)``: its position in the
    cache's ``k``/``v`` stack (``k_local``/``v_local`` for a ring layer,
    see :func:`kv_leaves`) and ``conv``/``ssm`` stack, or None."""
    out, n_kv, n_ring, n_state = [], 0, 0, 0
    for b in layer_types(cfg):
        kv = st = None
        if b in KV_BLOCKS:
            kv, n_kv = n_kv, n_kv + 1
        elif b in RING_BLOCKS:
            kv, n_ring = n_ring, n_ring + 1
        if b in STATE_BLOCKS:
            st, n_state = n_state, n_state + 1
        out.append((kv, st))
    return out


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _init_block(gen: torch.Generator, cfg: ModelConfig, btype: str):
    d = cfg.d_model
    zeros = lambda: torch.zeros((d,), dtype=cfg.param_dtype,
                                device=gen.device)
    if btype in (ATTN, ATTN_LOCAL):
        return {"ln1": zeros(), "attn": attn_lib.init_attention(gen, cfg),
                "ln2": zeros(), "mlp": init_mlp(gen, d, cfg.d_ff,
                                                cfg.param_dtype)}
    if btype == MOE:
        p = {"ln1": zeros(), "attn": attn_lib.init_attention(gen, cfg),
             "ln2": zeros(), "moe": moe_lib.init_moe(gen, cfg)}
        if cfg.dense_residual:
            p["dense_mlp"] = init_mlp(gen, d, cfg.d_ff, cfg.param_dtype)
        return p
    if btype in (MAMBA2, ZAMBA_ATTN):
        p = {"ln1": zeros(), "mixer": m2.init_mamba2(gen, cfg)}
        if cfg.d_ff > 0:
            p["ln2"] = zeros()
            p["mlp"] = init_mlp(gen, d, cfg.d_ff, cfg.param_dtype)
        if btype == ZAMBA_ATTN:
            p["ln_attn"] = zeros()
        return p
    raise _unported(btype)


def init_params(seed: int, cfg: ModelConfig, device="cuda"):
    """Random parameters drawn from a ``torch.Generator`` seeded with
    ``seed`` on ``device`` (the draws differ from the reference's, which
    come from ``jax.random``; parity tests convert the reference's
    parameters instead of re-drawing)."""
    _check_ported(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    d, V = cfg.d_model, cfg.vocab_size
    params = {
        "embed": dense_init(gen, (V, d), cfg.param_dtype, scale=1.0),
        "lm_head": dense_init(gen, (d, V), cfg.param_dtype),
        "final_norm": torch.zeros((d,), dtype=cfg.param_dtype,
                                  device=gen.device),
    }
    if cfg.family == "hybrid":
        params["shared_attn"] = attn_lib.init_attention(gen, cfg)
    params["layers"] = [_init_block(gen, cfg, b) for b in layer_types(cfg)]
    return params


# ---------------------------------------------------------------------------
# Cache
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=None,
               device="cuda"):
    """Dense per-row cache.  ``{"k", "v"}`` each [L_kv, batch, max_seq,
    Hkv, Dh] over the full-cache attention layers, ``{"k_local",
    "v_local"}`` each [L_ring, batch, min(window, max_seq), Hkv, Dh] over
    the sliding-window ones, and ``{"conv": [L_state, batch, k-1, C_in],
    "ssm": [L_state, batch, H, P, N] float32}`` over the recurrent layers;
    a family holds only the entries it uses."""
    _check_ported(cfg)
    dtype = dtype or cfg.param_dtype
    types = layer_types(cfg)
    n_kv = sum(b in KV_BLOCKS for b in types)
    n_ring = sum(b in RING_BLOCKS for b in types)
    n_state = sum(b in STATE_BLOCKS for b in types)
    cache = {}
    for n, names, seq in (
            (n_kv, kv_leaves(ATTN), max_seq),
            (n_ring, kv_leaves(ATTN_LOCAL),
             min(cfg.sliding_window or max_seq, max_seq))):
        if n:
            shape = (n, batch, seq, cfg.num_kv_heads, cfg.head_dim)
            for name in names:
                cache[name] = torch.zeros(shape, dtype=dtype, device=device)
    if n_state:
        cache["conv"] = torch.zeros(
            (n_state, batch, cfg.ssm_conv - 1, m2.conv_channels(cfg)),
            dtype=dtype, device=device)
        cache["ssm"] = torch.zeros(
            (n_state, batch, cfg.ssm_nheads, cfg.ssm_headdim,
             cfg.ssm_state), dtype=torch.float32, device=device)
    return cache


def init_paged_cache(cfg: ModelConfig, num_blocks: int, block_size: int,
                     dtype=None, quant: Optional[str] = None,
                     device="cuda"):
    """Physical block-pool KV cache: every attention layer's KV lives in
    one shared pool of ``num_blocks`` fixed-size token blocks instead of
    per-slot [B, max_seq] rows.  Leaves are [L, P + 1, Hkv, Dh] with
    P = num_blocks * block_size (flat token axis, block-major) and one
    spare dump row P that swallows the writes the reference's scatter
    drops (see ``attention.paged_write``); rows address the pool through
    int32 block tables passed to ``forward``.

    ``quant="int8"`` stores KV as symmetric per-token int8 with float32
    scales in sibling ``k_scale``/``v_scale`` pools [L, P + 1, Hkv]; the
    paged kernels fold the scale in after the load.

    Only full-cache global attention pages cleanly, so every block type
    must be ATTN.
    """
    if quant not in (None, "int8"):
        raise ValueError(f"unsupported KV quantization {quant!r}")
    for b in layer_types(cfg):
        if b != ATTN:
            raise ValueError(
                f"paged KV cache requires all-ATTN segments, got {b}")
    dtype = torch.int8 if quant == "int8" else (dtype or cfg.param_dtype)
    L, hkv, dh = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    rows = num_blocks * block_size + 1
    pool = {"k": torch.zeros((L, rows, hkv, dh), dtype=dtype, device=device),
            "v": torch.zeros((L, rows, hkv, dh), dtype=dtype, device=device)}
    if quant == "int8":
        pool["k_scale"] = torch.zeros((L, rows, hkv), dtype=torch.float32,
                                      device=device)
        pool["v_scale"] = torch.zeros((L, rows, hkv), dtype=torch.float32,
                                      device=device)
    return pool


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _apply_block(btype, bp, cfg, x, positions, cache, shared_attn,
                 valid_len=None, block_tables=None, rope_cs=None,
                 write_dest=None):
    """Returns (x, aux loss or None); ``cache`` (this layer's views) is
    updated in place."""
    if btype in (ATTN, ATTN_LOCAL):
        h = rms_norm(x, bp["ln1"], cfg.norm_eps)
        a, _ = attn_lib.self_attention(
            bp["attn"], cfg, h, positions, cache,
            window=cfg.sliding_window if btype == ATTN_LOCAL else 0,
            valid_len=valid_len, block_tables=block_tables, rope_cs=rope_cs,
            write_dest=write_dest)
        x = x + a
        h = rms_norm(x, bp["ln2"], cfg.norm_eps)
        return x + mlp(bp["mlp"], h), None
    if btype == MOE:
        # every row goes through the experts, a row the step masks out
        # too: it takes its place in the experts' capacity, as in the
        # reference (valid_len masks KV writes only)
        h = rms_norm(x, bp["ln1"], cfg.norm_eps)
        a, _ = attn_lib.self_attention(bp["attn"], cfg, h, positions, cache,
                                       valid_len=valid_len, rope_cs=rope_cs)
        x = x + a
        h = rms_norm(x, bp["ln2"], cfg.norm_eps)
        mo, aux = moe_lib.moe_ffn(bp["moe"], cfg, h)
        if cfg.dense_residual:
            mo = mo + mlp(bp["dense_mlp"], h)
        return x + mo, aux
    if btype in (MAMBA2, ZAMBA_ATTN):
        if btype == ZAMBA_ATTN:
            h = rms_norm(x, bp["ln_attn"], cfg.norm_eps)
            kvc = ({"k": cache["k"], "v": cache["v"]}
                   if cache is not None else None)
            a, _ = attn_lib.self_attention(shared_attn, cfg, h, positions,
                                           kvc, valid_len=valid_len,
                                           rope_cs=rope_cs)
            x = x + a
        h = rms_norm(x, bp["ln1"], cfg.norm_eps)
        mcache = ({"conv": cache["conv"], "ssm": cache["ssm"]}
                  if cache is not None else None)
        mo, _ = m2.mamba2_block(bp["mixer"], cfg, h, mcache,
                                valid_len=valid_len)
        x = x + mo
        if cfg.d_ff > 0 and "mlp" in bp:
            h = rms_norm(x, bp["ln2"], cfg.norm_eps)
            x = x + mlp(bp["mlp"], h)
        return x, None
    raise _unported(btype)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def forward(params, cfg: ModelConfig, tokens, positions=None, cache=None, *,
            image_embeds=None, audio_embeds=None, compute_logits=True,
            valid_len=None, block_tables=None):
    """tokens: [B, T] integer.  positions: [B, T] absolute positions
    (defaults to arange).  cache: from ``init_cache`` /
    ``init_paged_cache``, or None for full-context.

    valid_len: [B] per-row valid token counts for T-padded batched
    prefill; padding KV writes are dropped so the cache stays exactly
    sequential.  With T == 1 it is a row mask: rows with 0 write no KV and
    keep their recurrent state (a full-slot-batch decode passes the rows
    it schedules).
    block_tables: optional ``(tables [B, NB] int32, block_size)`` — the
    cache is a paged block pool and every row addresses its KV through
    its block table.

    Returns (logits [B, T, V] or hidden, cache, aux_loss); the cache is
    updated in place and returned as the same object; aux_loss is the sum
    of the MoE layers' load-balance losses (float32, 0 without MoE).
    """
    if image_embeds is not None or audio_embeds is not None:
        raise NotImplementedError(
            f"image/audio inputs are not in the port yet: they come with "
            f"{_NEXT_SLICE}")
    B, T = tokens.shape
    x = params["embed"][tokens]
    if positions is None:
        positions = torch.arange(T, device=tokens.device)[None].expand(B, T)
    # shared by every layer: RoPE tables and, for a paged pool, the pool
    # slot of every new token
    rope_cs = (rope_tables(positions, cfg.head_dim, cfg.rope_theta)
               if cfg.num_heads else None)
    write_dest = None
    if block_tables is not None:
        tables, bs = block_tables
        write_dest = attn_lib.paged_destinations(
            positions, tables, bs, cache["k"].shape[1] - 1, valid_len)
    shared_attn = params.get("shared_attn")
    paged = block_tables is not None
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for btype, bp, (kv_i, st_i) in zip(layer_types(cfg), params["layers"],
                                       cache_slots(cfg)):
        if cache is None:
            lc = None
        elif paged:
            lc = {name: leaf[kv_i] for name, leaf in cache.items()}
        else:
            lc = {}
            if kv_i is not None:
                kn, vn = kv_leaves(btype)
                lc["k"], lc["v"] = cache[kn][kv_i], cache[vn][kv_i]
            if st_i is not None:
                lc["conv"], lc["ssm"] = cache["conv"][st_i], cache["ssm"][st_i]
        x, block_aux = _apply_block(btype, bp, cfg, x, positions, lc,
                                    shared_attn, valid_len, block_tables,
                                    rope_cs, write_dest)
        if block_aux is not None:
            aux = aux + block_aux
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    out = x
    if compute_logits:
        out = x @ params["lm_head"]
    return out, cache, aux


# ---------------------------------------------------------------------------
# Convenience entry points used by engine / launchers
# ---------------------------------------------------------------------------

def prefill(params, cfg, tokens, cache, start_pos, **kw):
    """Chunked prefill: write tokens at start_pos.., return last logits."""
    B, T = tokens.shape
    positions = start_pos[:, None] + torch.arange(
        T, device=tokens.device)[None]
    logits, cache, _ = forward(params, cfg, tokens, positions, cache, **kw)
    return logits[:, -1], cache


def decode_step(params, cfg, tokens, cache, pos, **kw):
    """tokens [B,1]; pos [B] absolute position of the new token."""
    logits, cache, _ = forward(params, cfg, tokens, pos[:, None], cache, **kw)
    return logits[:, -1], cache
