"""Dry-run case construction: (architecture x input shape) -> a step
function + fake inputs (``FakeTensorMode``: shapes and types, no
allocation) + spec trees for the production mesh — the reference's
``launch/specs.py`` on the port's trees.

Input shapes (assigned):
  train_4k     seq=4096    global_batch=256   train_step
  prefill_32k  seq=32768   global_batch=32    full chunked prefill (4k chunks)
  decode_32k   seq=32768   global_batch=128   serve_step (1 token, 32k KV)
  long_500k    seq=524288  global_batch=1     serve_step (1 token, 512k KV)

Applicability: long_500k runs only for archs with bounded attention
state (zamba2 hybrid, mamba2 SSM, gemma3 sliding-window); pure
full-attention archs skip it.  Modality notes: VLM prompts are
[patch-embeds ; text] with the assigned seq as the combined length;
audio backbones prefill/decode the text decoder against a fixed
1500-frame encoder context (frontends stubbed).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from repro_torch.configs import get_config
from repro_torch.distributed import hints
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.sharding import P
from repro_torch.models import transformer as tf
from repro_torch.models.config import ModelConfig

SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32, chunk=4096),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}

LONG_CTX_ARCHS = {"zamba2-7b", "mamba2-1.3b", "gemma3-1b"}
AUDIO_FRAMES = 1500


def applicable(arch: str, shape: str) -> Tuple[bool, str]:
    if shape == "long_500k" and arch not in LONG_CTX_ARCHS:
        return False, ("pure full-attention architecture: 512k dense KV has "
                       "no sub-quadratic variant in the source model")
    return True, ""


def _vlm_split(cfg: ModelConfig, seq: int) -> Tuple[int, int]:
    """(image_tokens, text_tokens) with text a multiple of 512."""
    img = min(4096, max(512, seq // 8))
    return img, seq - img


def _fsdp_needed(cfg: ModelConfig) -> bool:
    """Weights-per-model-shard > 8 GiB -> shard weights over data too."""
    per_shard = cfg.param_count() * 2 / 16
    return per_shard > 8 * 1024 ** 3


@dataclasses.dataclass
class DryRunCase:
    arch: str
    shape: str
    kind: str
    fn: Callable
    args: tuple                 # fake tensors (trees of them)
    in_specs: tuple             # P trees, congruent with args
    out_specs: object           # None: DTensor propagates
    donate: tuple = ()          # args the step updates in place
    note: str = ""
    fake_mode: object = None    # the FakeTensorMode that made ``args``


def _mesh_sizes(mesh) -> Tuple[int, int]:
    sizes = shd.axis_sizes(mesh)
    model = sizes["model"]
    total = 1
    for s in sizes.values():
        total *= s
    return model, total // model


def _layer_periods(cfg: ModelConfig):
    """The periods of the reference's stack each port layer sits in."""
    return [seg.n_periods for seg in cfg.segments()
            for _ in range(seg.n_periods) for _ in seg.pattern]


def _fsdp_param_specs(cfg: ModelConfig, mesh):
    """Augment TP specs with data-axis sharding on the largest divisible
    free axis of every big weight (>= 32 MiB per model shard).  A big
    weight is sized as the reference's leaf stacked over its segment's
    periods, so that the port shards the weights the reference does."""
    model_size, dp_size = _mesh_sizes(mesh)
    base = shd.param_specs(cfg, model_size)
    shapes = tf.abstract_params(cfg)
    dp = shd.data_axes(mesh)
    periods = _layer_periods(cfg)

    def aug(path, spec: P, leaf):
        stack = periods[path[1]] if path[0] == "layers" else 1
        entries = list(spec) + [None] * (leaf.ndim - len(spec))
        div = model_size if "model" in entries else 1
        if leaf.numel() * stack * 2 / div < 32 * 1024 ** 2:
            return P(*entries)
        free = [i for i, e in enumerate(entries)
                if e is None and leaf.shape[i] % dp_size == 0
                and leaf.shape[i] > 1]
        if not free:
            return P(*entries)
        ax = max(free, key=lambda i: leaf.shape[i])
        entries[ax] = dp
        return P(*entries)

    return shd.map_with_path(aug, base, shapes)


def period_len(cfg: ModelConfig) -> int:
    return len(cfg.segments()[0].pattern)


def true_periods(cfg: ModelConfig) -> float:
    """Number of scan periods in the full config (fractional when a
    trailing partial segment exists — gemma3 26/6, zamba2 81/6)."""
    return cfg.num_layers / period_len(cfg)


def probe_cfg(cfg: ModelConfig, d: int) -> ModelConfig:
    """Shallow variant with exactly ``d`` periods (the reference's cost
    probes; the port's dry-run traces every layer and needs none, but
    ``hillclimb`` and the tests build shallow cases with it)."""
    kw = dict(num_layers=period_len(cfg) * d, scan_unroll=True)
    if cfg.family == "audio":
        kw["num_encoder_layers"] = d
    return dataclasses.replace(cfg, **kw)


def _device(mesh) -> str:
    return getattr(mesh, "device_type", "cpu")


def fake_like(tree, mode, device, dtype=None):
    """A tree of fake tensors with ``tree``'s shapes (and types, or
    ``dtype``) on ``device``."""
    with mode:
        return shd.map_with_path(
            lambda _, t: torch.empty(t.shape, dtype=dtype or t.dtype,
                                     device=device), tree)


def _greedy(logits):
    """argmax over the vocabulary; a DTensor's split vocabulary is
    gathered first (an all-gather of [B / dp, V] logits: DTensor's own
    sharded argmax reads a value on the host, which a fake tensor has
    not)."""
    return torch.argmax(hints.whole_axis(logits, 1), -1)


def build_case(arch: str, shape: str, mesh,
               fsdp: Optional[bool] = None,
               cfg: Optional[ModelConfig] = None,
               prefill_chunks: Optional[int] = None,
               kv_mode: str = "auto",
               chunk_override: Optional[int] = None,
               accum_steps: int = 1) -> DryRunCase:
    from torch._subclasses.fake_tensor import FakeTensorMode
    cfg = cfg or get_config(arch)
    info = SHAPES[shape]
    seq, batch, kind = info["seq"], info["batch"], info["kind"]
    dp = shd.data_axes(mesh)
    bdim = dp if batch > 1 else None
    dt = cfg.param_dtype
    mode = FakeTensorMode()
    dev = _device(mesh)

    def fake(*shape_, dtype=torch.int64):
        with mode:
            return torch.empty(shape_, dtype=dtype, device=dev)

    model_size, dp_size = _mesh_sizes(mesh)
    params_abs = fake_like(tf.abstract_params(cfg), mode, dev)
    use_fsdp = _fsdp_needed(cfg) if fsdp is None else fsdp
    pspecs = (_fsdp_param_specs(cfg, mesh) if use_fsdp
              else shd.param_specs(cfg, model_size))
    note = "fsdp" if use_fsdp else ""

    if kind == "train":
        from repro_torch.training.optimizer import AdamWConfig, OptState
        from repro_torch.training.train import make_train_step
        moments = lambda: fake_like(tf.abstract_params(cfg), mode, dev,
                                    torch.float32)
        opt_abs = OptState(step=fake(dtype=torch.int32), m=moments(),
                           v=moments())
        ospecs = OptState(step=P(), m=pspecs, v=pspecs)
        batch_abs = {"tokens": fake(batch, seq), "labels": fake(batch, seq)}
        bspecs = {"tokens": P(bdim, None), "labels": P(bdim, None)}
        if cfg.family == "vlm":
            img, txt = _vlm_split(cfg, seq)
            batch_abs = {"tokens": fake(batch, txt),
                         "labels": fake(batch, txt),
                         "image_embeds": fake(batch, img, cfg.vision_dim,
                                              dtype=dt)}
            bspecs = dict(bspecs, image_embeds=P(bdim, None, None))
        if cfg.family == "audio":
            batch_abs["audio_embeds"] = fake(batch, AUDIO_FRAMES,
                                             cfg.d_model, dtype=dt)
            bspecs = dict(bspecs, audio_embeds=P(bdim, None, None))
        fn = make_train_step(cfg, AdamWConfig(), accum_steps=accum_steps)
        return DryRunCase(arch, shape, kind, fn,
                          (params_abs, opt_abs, batch_abs),
                          (pspecs, ospecs, bspecs), None,
                          donate=(0, 1), note=note, fake_mode=mode)

    cross = AUDIO_FRAMES if cfg.family == "audio" else 0
    cspecs = shd.cache_specs(cfg, mesh, batch, seq, cross_len=cross,
                             kv_mode=kv_mode)
    cache_abs = fake_like(tf.abstract_cache(cfg, batch, seq, dt,
                                            cross_len=cross), mode, dev)
    if kind == "prefill":
        chunk = chunk_override or info["chunk"]
        kw = {}
        if cfg.family == "vlm":
            img, txt = _vlm_split(cfg, seq)
            txt = (txt // chunk) * chunk
            kw["image_embeds"] = fake(batch, img, cfg.vision_dim, dtype=dt)
        else:
            txt = seq
        if prefill_chunks is not None:
            txt = chunk * prefill_chunks
        if cfg.family == "audio":
            kw["audio_embeds"] = fake(batch, AUDIO_FRAMES, cfg.d_model,
                                      dtype=dt)
        kw_names = tuple(kw)

        def fn(params, cache, tokens, *extras):
            kwargs = dict(zip(kw_names, extras))
            logits, cache = tf.full_prefill(params, cfg, tokens, cache,
                                            chunk, **kwargs)
            return _greedy(logits), cache

        kwspecs = tuple(P(bdim, None, None) for _ in kw_names)
        return DryRunCase(
            arch, shape, kind, fn,
            (params_abs, cache_abs, fake(batch, txt)) + tuple(kw.values()),
            (pspecs, cspecs, P(bdim, None)) + kwspecs,
            None, donate=(1,), note=note, fake_mode=mode)

    # decode
    def dfn(params, cache, tokens, pos):
        logits, cache = tf.decode_step(params, cfg, tokens, cache, pos)
        return _greedy(logits), cache

    return DryRunCase(
        arch, shape, kind, dfn,
        (params_abs, cache_abs, fake(batch, 1), fake(batch)),
        (pspecs, cspecs, P(bdim, None), P(bdim)),
        None, donate=(1,), note=note, fake_mode=mode)
