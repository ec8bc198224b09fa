"""Decoder stack of the port — the ATTN subset of the reference's
``models/transformer.py``.

Entry points (plain functions on dicts of tensors):

  init_params(seed, cfg, device)              -> params
  init_cache(cfg, batch, max_seq, ...)        -> dense cache
  init_paged_cache(cfg, num_blocks, bs, ...)  -> block-pool cache
  forward(params, cfg, tokens, positions, cache, ...) -> (out, cache, aux)

Parameters are ``{"embed", "lm_head", "final_norm", "layers": [block,
...]}`` with one block dict a layer, in execution order; the reference
stacks each pattern position over its scan periods, and
``repro_torch.convert.params_from_jax`` un-stacks that layout into this
one.  A Python loop over the layers stands where the reference scans.

A cache is a dict of tensors stacked over layers (``{"k": [L, ...],
"v": [L, ...]}``); layer ``l`` works on the views ``cache[name][l]`` and
UPDATES THEM IN PLACE, where the reference threads a donated buffer
through its scan.  ``forward`` returns the same cache object.

Only full-attention (``ATTN``) blocks are ported; the other block types
raise and name the slice that brings them.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models import attention as attn_lib
from repro_torch.models.common import (dense_init, init_mlp, mlp, rms_norm,
                                       rope_tables)
from repro_torch.models.config import ATTN, ModelConfig


def _unported(btype: str):
    return NotImplementedError(
        f"block type {btype!r} is not in the port yet: only full-attention "
        "(ATTN) stacks are; MoE, Mamba2/hybrid, sliding-window, "
        "encoder-decoder and VLM blocks come with the slice that ports "
        "the remaining model families")


def layer_types(cfg: ModelConfig):
    """Block type of every layer, in execution order."""
    return [b for seg in cfg.segments() for _ in range(seg.n_periods)
            for b in seg.pattern]


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _init_block(gen: torch.Generator, cfg: ModelConfig, btype: str):
    if btype != ATTN:
        raise _unported(btype)
    d = cfg.d_model
    zeros = lambda: torch.zeros((d,), dtype=cfg.param_dtype,
                                device=gen.device)
    return {"ln1": zeros(), "attn": attn_lib.init_attention(gen, cfg),
            "ln2": zeros(), "mlp": init_mlp(gen, d, cfg.d_ff,
                                            cfg.param_dtype)}


def init_params(seed: int, cfg: ModelConfig, device="cuda"):
    """Random parameters drawn from a ``torch.Generator`` seeded with
    ``seed`` on ``device`` (the draws differ from the reference's, which
    come from ``jax.random``; parity tests convert the reference's
    parameters instead of re-drawing)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    d, V = cfg.d_model, cfg.vocab_size
    return {
        "embed": dense_init(gen, (V, d), cfg.param_dtype, scale=1.0),
        "lm_head": dense_init(gen, (d, V), cfg.param_dtype),
        "final_norm": torch.zeros((d,), dtype=cfg.param_dtype,
                                  device=gen.device),
        "layers": [_init_block(gen, cfg, b) for b in layer_types(cfg)],
    }


# ---------------------------------------------------------------------------
# Cache
# ---------------------------------------------------------------------------

def _require_all_attn(cfg: ModelConfig, what: str):
    for b in layer_types(cfg):
        if b != ATTN:
            raise ValueError(f"{what} requires all-ATTN segments, got {b}")


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=None,
               device="cuda"):
    """Dense per-row KV cache: ``{"k", "v"}``, each
    [L, batch, max_seq, Hkv, Dh]."""
    _require_all_attn(cfg, "the port's dense KV cache")
    dtype = dtype or cfg.param_dtype
    shape = (cfg.num_layers, batch, max_seq, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


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
    _require_all_attn(cfg, "paged KV cache")
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

def _apply_block(btype, bp, cfg, x, positions, cache, valid_len=None,
                 block_tables=None, rope_cs=None, write_dest=None):
    """Returns (x, cache).  ``cache`` is this layer's views."""
    if btype != ATTN:
        raise _unported(btype)
    h = rms_norm(x, bp["ln1"], cfg.norm_eps)
    a, nc = attn_lib.self_attention(bp["attn"], cfg, h, positions, cache,
                                    valid_len=valid_len,
                                    block_tables=block_tables,
                                    rope_cs=rope_cs, write_dest=write_dest)
    x = x + a
    h = rms_norm(x, bp["ln2"], cfg.norm_eps)
    x = x + mlp(bp["mlp"], h)
    return x, nc


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
    sequential.
    block_tables: optional ``(tables [B, NB] int32, block_size)`` — the
    cache is a paged block pool and every row addresses its KV through
    its block table.

    Returns (logits [B, T, V] or hidden, cache, aux_loss); the cache is
    updated in place and returned as the same object.
    """
    if image_embeds is not None or audio_embeds is not None:
        raise NotImplementedError(
            "image/audio inputs are not in the port yet: they come with "
            "the slice that ports the VLM and encoder-decoder families")
    B, T = tokens.shape
    x = params["embed"][tokens]
    if positions is None:
        positions = torch.arange(T, device=tokens.device)[None].expand(B, T)
    # shared by every layer: RoPE tables and, for a paged pool, the pool
    # slot of every new token
    rope_cs = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    write_dest = None
    if block_tables is not None:
        tables, bs = block_tables
        write_dest = attn_lib.paged_destinations(
            positions, tables, bs, cache["k"].shape[1] - 1, valid_len)
    for li, (btype, bp) in enumerate(zip(layer_types(cfg),
                                         params["layers"])):
        lc = (None if cache is None
              else {name: leaf[li] for name, leaf in cache.items()})
        x, _ = _apply_block(btype, bp, cfg, x, positions, lc, valid_len,
                            block_tables, rope_cs, write_dest)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    out = x
    if compute_logits:
        out = x @ params["lm_head"]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
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
