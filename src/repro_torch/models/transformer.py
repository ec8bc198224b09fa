"""The model stack of the port — every block type (ATTN, ATTN_LOCAL,
MOE, MAMBA2, ZAMBA_ATTN, and the encoder-decoder's ENC and DEC) of the
reference's ``models/transformer.py``.

Entry points (plain functions on dicts of tensors):

  init_params(seed, cfg, device)              -> params
  init_cache(cfg, batch, max_seq, ...)        -> dense cache
  init_paged_cache(cfg, num_blocks, bs, ...)  -> block-pool cache
  forward(params, cfg, tokens, positions, cache, ...) -> (out, cache, aux)
  prefill / decode_step / full_prefill        -> (last logits, cache)
  train_loss(params, cfg, batch)              -> scalar loss

Parameters are ``{"embed", "lm_head", "final_norm", "layers": [block,
...]}`` with one block dict a layer, in execution order, plus
``"shared_attn"`` for the hybrid family (zamba2: one attention block whose
weights every ZAMBA_ATTN layer shares) and ``"projector"`` [vision_dim,
d_model] for the VLM family (llava: image embeddings are projected and
prepended to the text).  The audio family's ENC layers sit at the head of
``"layers"``, before its DEC layers, as the reference's segments order
them; they run over ``audio_embeds``, not over the text stream.  The
reference stacks each pattern position over its scan periods, and
``repro_torch.convert.params_from_jax`` un-stacks that layout into this
one.  A Python loop over the layers stands where the reference scans.

A cache is a dict of tensors stacked over the layers that hold them:
``"k"``/``"v"`` over the full-cache attention layers (ATTN, MOE,
ZAMBA_ATTN), ``"k_local"``/``"v_local"`` over the sliding-window ones
(ATTN_LOCAL: ring buffers of ``min(window, max_seq)`` slots),
``"conv"``/``"ssm"`` over the recurrent ones (MAMBA2, ZAMBA_ATTN; ``ssm``
is float32), ``"ck"``/``"cv"`` (the cross-attention KV of the encoder's
output) over the DEC layers.  Layer ``l`` works on views of its entries
and UPDATES THEM IN PLACE, where the reference threads a donated buffer
through its scan.  ``forward`` returns the same cache object.

Every entry point runs on DTensor parameters and caches too (the sharded
path: ``distributed/sharding.py`` gives their placements,
``distributed/hints.py`` the layouts pinned between blocks and the
regions run on local shards).

Training runs ``forward`` without a cache; where ``cfg.remat`` holds and
grad is on, each layer runs under ``torch.utils.checkpoint`` (the
reference's ``jax.checkpoint`` of each scan period).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed import hints
from repro_torch.models import attention as attn_lib
from repro_torch.models import mamba2 as m2
from repro_torch.models import moe as moe_lib
from repro_torch.models.common import (dense_init, init_mlp, mlp, rms_norm,
                                       rope_tables, softmax_xent)
from repro_torch.models.config import (ATTN, ATTN_LOCAL, DEC, ENC, MAMBA2,
                                       MOE, ZAMBA_ATTN, ModelConfig)

#: block types whose layers hold full-cache attention KV, a ring buffer,
#: recurrent state, cross-attention KV
KV_BLOCKS = (ATTN, MOE, ZAMBA_ATTN, DEC)
RING_BLOCKS = (ATTN_LOCAL,)
STATE_BLOCKS = (MAMBA2, ZAMBA_ATTN)
CROSS_BLOCKS = (DEC,)


def layer_types(cfg: ModelConfig):
    """Block type of every layer, in execution order."""
    return [b for seg in cfg.segments() for _ in range(seg.n_periods)
            for b in seg.pattern]


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
    if btype in (ATTN, ATTN_LOCAL, ENC):
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
    if btype == DEC:
        return {"ln1": zeros(), "attn": attn_lib.init_attention(gen, cfg),
                "ln_x": zeros(),
                "xattn": attn_lib.init_cross_attention(gen, cfg),
                "ln2": zeros(), "mlp": init_mlp(gen, d, cfg.d_ff,
                                                cfg.param_dtype)}
    raise ValueError(btype)


class _MetaGenerator:
    """Stands in for a ``torch.Generator`` on the ``meta`` device, which
    torch has no generator for: the init helpers read its ``device`` and
    draw nothing."""
    device = torch.device("meta")


def init_params(seed: int, cfg: ModelConfig, device="cuda"):
    """Random parameters drawn from a ``torch.Generator`` seeded with
    ``seed`` on ``device`` (the draws differ from the reference's, which
    come from ``jax.random``; parity tests convert the reference's
    parameters instead of re-drawing).  On ``device="meta"`` the leaves
    have their shapes and types and no data."""
    if torch.device(device).type == "meta":
        gen = _MetaGenerator()
    else:
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
    if cfg.family == "vlm":
        params["projector"] = dense_init(gen, (cfg.vision_dim, d),
                                         cfg.param_dtype)
    params["layers"] = [_init_block(gen, cfg, b) for b in layer_types(cfg)]
    return params


def abstract_params(cfg: ModelConfig):
    """Parameter shapes without data or allocation (for the sharding
    rules and the dry-run): the tree of :func:`init_params` on the
    ``meta`` device, at any size (arctic-480b's 480 B parameters
    included).  ``launch.specs`` turns the leaves into fake tensors."""
    return init_params(0, cfg, device="meta")


# ---------------------------------------------------------------------------
# Cache
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=None,
               device="cuda", cross_len: int = 0):
    """Dense per-row cache.  ``{"k", "v"}`` each [L_kv, batch, max_seq,
    Hkv, Dh] over the full-cache attention layers, ``{"k_local",
    "v_local"}`` each [L_ring, batch, min(window, max_seq), Hkv, Dh] over
    the sliding-window ones, ``{"conv": [L_state, batch, k-1, C_in],
    "ssm": [L_state, batch, H, P, N] float32}`` over the recurrent layers
    and ``{"ck", "cv"}`` each [L_dec, batch, cross_len, Hkv, Dh] over the
    DEC layers (``cross_len``: the encoder's frames); a family holds only
    the entries it uses."""
    dtype = dtype or cfg.param_dtype
    types = layer_types(cfg)
    n_kv = sum(b in KV_BLOCKS for b in types)
    n_ring = sum(b in RING_BLOCKS for b in types)
    n_state = sum(b in STATE_BLOCKS for b in types)
    n_cross = sum(b in CROSS_BLOCKS for b in types)
    cache = {}
    for n, names, seq in (
            (n_kv, kv_leaves(ATTN), max_seq),
            (n_ring, kv_leaves(ATTN_LOCAL),
             min(cfg.sliding_window or max_seq, max_seq)),
            (n_cross, ("ck", "cv"), cross_len)):
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


def abstract_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=None,
                   cross_len: int = 0):
    """The tree of :func:`init_cache` on the ``meta`` device: shapes and
    types, no data."""
    return init_cache(cfg, batch, max_seq, dtype, device="meta",
                      cross_len=cross_len)


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

#: a branch's output joins the residual stream laid out as the stream is
#: (on a DTensor its partial sums are reduced; a plain tensor passes)
_branch = hints.constrain_tokens


def _apply_block(btype, bp, cfg, x, positions, cache, shared_attn,
                 enc_out=None, valid_len=None, block_tables=None,
                 rope_cs=None, write_dest=None, flat=None):
    """Returns (x, aux loss or None); ``cache`` (this layer's views) is
    updated in place."""
    x = hints.constrain_tokens(x)
    if btype == ENC:
        # bidirectional over the encoder's frames; no cache
        h = rms_norm(x, bp["ln1"], cfg.norm_eps)
        x = x + _branch(attn_lib.encoder_attention(bp["attn"], cfg, h,
                                                   positions, rope_cs))
        h = rms_norm(x, bp["ln2"], cfg.norm_eps)
        return x + _branch(mlp(bp["mlp"], h)), None
    if btype in (ATTN, ATTN_LOCAL):
        h = rms_norm(x, bp["ln1"], cfg.norm_eps)
        a, _ = attn_lib.self_attention(
            bp["attn"], cfg, h, positions, cache,
            window=cfg.sliding_window if btype == ATTN_LOCAL else 0,
            valid_len=valid_len, block_tables=block_tables, rope_cs=rope_cs,
            write_dest=write_dest, flat=flat)
        x = x + _branch(a)
        h = rms_norm(x, bp["ln2"], cfg.norm_eps)
        return x + _branch(mlp(bp["mlp"], h)), None
    if btype == MOE:
        # every row goes through the experts, a row the step masks out
        # too: it takes its place in the experts' capacity, as in the
        # reference (valid_len masks KV writes only)
        h = rms_norm(x, bp["ln1"], cfg.norm_eps)
        a, _ = attn_lib.self_attention(bp["attn"], cfg, h, positions, cache,
                                       valid_len=valid_len, rope_cs=rope_cs)
        x = x + _branch(a)
        h = rms_norm(x, bp["ln2"], cfg.norm_eps)
        mo, aux = moe_lib.moe_ffn(bp["moe"], cfg, h)
        if cfg.dense_residual:
            mo = mo + mlp(bp["dense_mlp"], h)
        return x + _branch(mo), aux
    if btype in (MAMBA2, ZAMBA_ATTN):
        if btype == ZAMBA_ATTN:
            h = rms_norm(x, bp["ln_attn"], cfg.norm_eps)
            kvc = ({"k": cache["k"], "v": cache["v"]}
                   if cache is not None else None)
            a, _ = attn_lib.self_attention(shared_attn, cfg, h, positions,
                                           kvc, valid_len=valid_len,
                                           rope_cs=rope_cs)
            x = x + _branch(a)
        h = rms_norm(x, bp["ln1"], cfg.norm_eps)
        mcache = ({"conv": cache["conv"], "ssm": cache["ssm"]}
                  if cache is not None else None)
        mo, _ = m2.mamba2_block(bp["mixer"], cfg, h, mcache,
                                valid_len=valid_len)
        x = x + _branch(mo)
        if cfg.d_ff > 0 and "mlp" in bp:
            h = rms_norm(x, bp["ln2"], cfg.norm_eps)
            x = x + _branch(mlp(bp["mlp"], h))
        return x, None
    if btype == DEC:
        # causal self-attention over the text (through the kernels where
        # there is a cache), then cross-attention over the encoder's KV:
        # projected from ``enc_out`` where the audio came with this call
        # (and written into the cache), else read from the cache
        h = rms_norm(x, bp["ln1"], cfg.norm_eps)
        kvc = ({"k": cache["k"], "v": cache["v"]}
               if cache is not None else None)
        a, _ = attn_lib.self_attention(bp["attn"], cfg, h, positions, kvc,
                                       valid_len=valid_len, rope_cs=rope_cs)
        x = x + _branch(a)
        h = rms_norm(x, bp["ln_x"], cfg.norm_eps)
        if enc_out is not None:
            ckv = attn_lib.project_cross_kv(bp["xattn"], cfg, enc_out)
            if cache is not None:
                cache["ck"].copy_(hints.split_like(ckv["k"], cache["ck"]))
                cache["cv"].copy_(hints.split_like(ckv["v"], cache["cv"]))
        elif cache is not None:
            ckv = {"k": cache["ck"], "v": cache["cv"]}
        else:
            raise ValueError("a DEC layer needs audio_embeds or a cache "
                             "holding the cross-attention KV")
        x = x + _branch(attn_lib.cross_attention(bp["xattn"], cfg, h, ckv))
        h = rms_norm(x, bp["ln2"], cfg.norm_eps)
        return x + _branch(mlp(bp["mlp"], h)), None
    raise ValueError(btype)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def forward(params, cfg: ModelConfig, tokens, positions=None, cache=None, *,
            image_embeds=None, audio_embeds=None, compute_logits=True,
            valid_len=None, block_tables=None, flat=None):
    """tokens: [B, T] integer.  positions: [B, T'] absolute positions
    (defaults to arange).  cache: from ``init_cache`` /
    ``init_paged_cache``, or None for full-context (training).

    image_embeds: [B, S_img, vision_dim] (VLM prefill): projected and
    prepended to the text, so T' = S_img + T.
    audio_embeds: [B, S_frames, d_model] (audio prefill): the ENC layers
    run over them once and every DEC layer attends over their projection
    (written into the cache's ``ck``/``cv``); without them the ENC layers
    are skipped and the DEC layers read the cache's cross KV.
    valid_len: [B] per-row valid token counts for T-padded batched
    prefill; padding KV writes are dropped so the cache stays exactly
    sequential.  With T == 1 it is a row mask: rows with 0 write no KV and
    keep their recurrent state (a full-slot-batch decode passes the rows
    it schedules).
    block_tables: optional ``(tables [B, NB] int32, block_size)`` — the
    cache is a paged block pool and every row addresses its KV through
    its block table.
    flat: optional ``attention.FlatRows`` with ``block_tables``: tokens
    and positions are [1, N], a mixed step laid out token-major; every
    layer runs over its N tokens, the paged kernel's read over the grid
    of ``tables``' rows that ``flat`` maps them into.

    Returns (logits [B, T', V] or hidden, cache, aux_loss); the cache is
    updated in place and returned as the same object; aux_loss is the sum
    of the MoE layers' load-balance losses (float32, 0 without MoE).
    """
    B = tokens.shape[0]
    x = hints.embed(params["embed"], tokens)
    if image_embeds is not None:
        img = image_embeds.to(x.dtype) @ params["projector"]
        x = torch.cat([img, x], dim=1)
    T = x.shape[1]
    if positions is None:
        positions = torch.arange(T, device=x.device)[None].expand(B, T)
    positions = hints.rows_like(positions, x)
    # shared by every layer: RoPE tables and, for a paged pool, the pool
    # slot of every new token
    rope_cs = (rope_tables(positions, cfg.head_dim, cfg.rope_theta)
               if cfg.num_heads else None)
    enc = enc_pos = enc_rope = None
    if audio_embeds is not None:
        enc = audio_embeds.to(x.dtype)
        S = enc.shape[1]
        enc_pos = hints.rows_like(
            torch.arange(S, device=x.device)[None].expand(B, S), enc)
        enc_rope = rope_tables(enc_pos, cfg.head_dim, cfg.rope_theta)
    write_dest = None
    if block_tables is not None:
        tables, bs = block_tables
        P = cache["k"].shape[1] - 1
        write_dest = (attn_lib.paged_destinations(positions, tables, bs, P,
                                                  valid_len)
                      if flat is None else
                      flat.destinations(positions, tables, bs, P))
    shared_attn = params.get("shared_attn")
    paged = block_tables is not None
    remat = cfg.remat and cache is None and torch.is_grad_enabled()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    n_cross = 0
    for btype, bp, (kv_i, st_i) in zip(layer_types(cfg), params["layers"],
                                       cache_slots(cfg)):
        if btype == ENC:
            if enc is not None:
                run = lambda h, bp=bp: _apply_block(
                    ENC, bp, cfg, h, enc_pos, None, None,
                    rope_cs=enc_rope)[0]
                enc = (checkpoint(run, enc, use_reentrant=False) if remat
                       else run(enc))
            continue
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
            if btype in CROSS_BLOCKS:
                lc["ck"], lc["cv"] = cache["ck"][n_cross], cache["cv"][n_cross]
                n_cross += 1
        run = lambda h, btype=btype, bp=bp, lc=lc: _apply_block(
            btype, bp, cfg, h, positions, lc, shared_attn, enc, valid_len,
            block_tables, rope_cs, write_dest, flat)
        x, block_aux = (checkpoint(run, x, use_reentrant=False) if remat
                        else run(x))
        if block_aux is not None:
            aux = aux + block_aux
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    out = x
    if compute_logits:
        out = x @ params["lm_head"]
    return out, cache, aux


# ---------------------------------------------------------------------------
# Convenience entry points used by engine / launchers / trainer
# ---------------------------------------------------------------------------

def train_loss(params, cfg: ModelConfig, batch):
    """batch: {tokens [B,T], labels [B,T], (optional) image_embeds,
    audio_embeds, loss_mask}.  Next-token cross-entropy in float32 (the
    VLM's logits cover [image; text]: only the text tail is scored) plus
    0.01 times the MoE layers' aux loss."""
    logits, _, aux = forward(
        params, cfg, batch["tokens"],
        image_embeds=batch.get("image_embeds"),
        audio_embeds=batch.get("audio_embeds"))
    labels = batch["labels"]
    n = labels.shape[1]
    # on a DTensor, cut on local shards: DTensor's slice backward builds a
    # zero gradient of the whole vocabulary on every rank
    logits = hints.on_shards(lambda t: t[:, -n:][:, :-1], logits,
                             whole=(1,))
    loss = softmax_xent(logits, labels[:, 1:], batch.get("loss_mask"))
    return loss + 0.01 * aux


def prefill(params, cfg, tokens, cache, start_pos, **kw):
    """Chunked prefill: write tokens at start_pos.. (image tokens, which
    come first, included), return last logits."""
    B, T = tokens.shape
    if kw.get("image_embeds") is not None:
        T += kw["image_embeds"].shape[1]
    positions = start_pos[:, None] + torch.arange(
        T, device=tokens.device)[None]
    logits, cache, _ = forward(params, cfg, tokens, positions, cache, **kw)
    return logits[:, -1], cache


def decode_step(params, cfg, tokens, cache, pos, **kw):
    """tokens [B,1]; pos [B] absolute position of the new token."""
    logits, cache, _ = forward(params, cfg, tokens, pos[:, None], cache, **kw)
    return logits[:, -1], cache


def full_prefill(params, cfg, tokens, cache, chunk_size: int, *,
                 image_embeds=None, audio_embeds=None):
    """Prefill a whole prompt as a loop over chunked-prefill steps of
    ``chunk_size`` text tokens, as a production instance runs it.  The
    first chunk carries the modality embeddings (the image tokens are
    prefilled with it; the encoder runs once and fills the cross KV).
    Requires (text) S % chunk_size == 0.  Returns (last logits [B, V],
    cache)."""
    B, S = tokens.shape
    if S % chunk_size:
        raise ValueError(f"chunk {chunk_size} does not divide {S} tokens")
    start = torch.zeros((B,), dtype=torch.long, device=tokens.device)
    last, cache = prefill(params, cfg, tokens[:, :chunk_size], cache, start,
                          image_embeds=image_embeds,
                          audio_embeds=audio_embeds)
    offset = chunk_size + (image_embeds.shape[1]
                           if image_embeds is not None else 0)
    for c in range(chunk_size, S, chunk_size):
        last, cache = prefill(params, cfg, tokens[:, c:c + chunk_size],
                              cache, start + offset + (c - chunk_size))
    return last, cache
