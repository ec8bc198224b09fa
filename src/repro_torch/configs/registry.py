"""Architecture registry: the 10 assigned architectures (+ the paper's own
Qwen2.5-14B/32B used in TaiChi's evaluation), exact numbers as assigned.

Each entry also defines a REDUCED variant (<=2 layers, d_model<=512,
<=4 experts) for CPU smoke tests, and ``input_specs`` /
``shape_applicability`` logic lives in repro.launch.specs.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.models.config import ModelConfig

_REGISTRY: Dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs():
    return sorted(_REGISTRY)


def reduced_config(name: str) -> ModelConfig:
    """Reduced same-family variant for CPU smoke tests: 2 layers,
    d_model<=512, <=4 experts."""
    cfg = get_config(name)
    kw = dict(
        name=cfg.name + "-smoke",
        num_layers=2,
        d_model=256,
        d_ff=512 if cfg.d_ff else 0,
        vocab_size=512,
        head_dim=64,
        dtype="float32",
        remat=False,
    )
    if cfg.family in ("dense", "vlm"):
        kw.update(num_heads=4, num_kv_heads=max(1, cfg.num_kv_heads
                                                and min(2, cfg.num_kv_heads)))
    elif cfg.family == "moe":
        kw.update(num_heads=4, num_kv_heads=2, num_experts=4,
                  top_k=min(2, cfg.top_k), moe_d_ff=128)
    elif cfg.family in ("ssm", "hybrid"):
        kw.update(num_heads=4 if cfg.family == "hybrid" else 0,
                  num_kv_heads=4 if cfg.family == "hybrid" else 0,
                  ssm_state=16, ssm_headdim=32)
        if cfg.family == "hybrid":
            kw.update(attn_period=2, num_layers=4)
    elif cfg.family == "audio":
        kw.update(num_heads=4, num_kv_heads=4, num_encoder_layers=2)
    if cfg.family == "vlm":
        kw.update(num_image_tokens=16, vision_dim=64)
    if cfg.local_global_ratio:
        kw.update(local_global_ratio=cfg.local_global_ratio,
                  sliding_window=32, num_layers=8)
    return dataclasses.replace(cfg, **kw)


# ---------------------------------------------------------------------------
# Assigned architectures (public-literature pool; citations in brackets)
# ---------------------------------------------------------------------------

# [hybrid] Mamba2 backbone + shared attention blocks [arXiv:2411.15242]
ZAMBA2_7B = register(ModelConfig(
    name="zamba2-7b", family="hybrid",
    num_layers=81, d_model=3584, num_heads=32, num_kv_heads=32,
    d_ff=14336, vocab_size=32000,
    ssm_state=64, ssm_headdim=64, attn_period=6,
    source="arXiv:2411.15242",
))

# [moe] 128 experts top-2 + dense residual [hf:Snowflake/snowflake-arctic-base]
ARCTIC_480B = register(ModelConfig(
    name="arctic-480b", family="moe",
    num_layers=35, d_model=7168, num_heads=56, num_kv_heads=8,
    d_ff=4864, vocab_size=32000,
    num_experts=128, top_k=2, moe_d_ff=4864, dense_residual=True,
    source="hf:Snowflake/snowflake-arctic-base",
))

# [dense] GQA, QKV bias [hf:Qwen/Qwen2.5-0.5B]
QWEN25_3B = register(ModelConfig(
    name="qwen2.5-3b", family="dense",
    num_layers=36, d_model=2048, num_heads=16, num_kv_heads=2,
    d_ff=11008, vocab_size=151936, qkv_bias=True,
    source="hf:Qwen/Qwen2.5-0.5B",
))

# [dense] qk_norm, GQA [hf:Qwen/Qwen3-8B]
QWEN3_14B = register(ModelConfig(
    name="qwen3-14b", family="dense",
    num_layers=40, d_model=5120, num_heads=40, num_kv_heads=8,
    d_ff=17408, vocab_size=151936, qk_norm=True, head_dim=128,
    source="hf:Qwen/Qwen3-8B",
))

# [audio] enc-dec, conv frontend (stub) [arXiv:2212.04356]
WHISPER_BASE = register(ModelConfig(
    name="whisper-base", family="audio",
    num_layers=6, num_encoder_layers=6,
    d_model=512, num_heads=8, num_kv_heads=8,
    d_ff=2048, vocab_size=51865,
    source="arXiv:2212.04356",
))

# [vlm] anyres tiling [hf:llava-hf/llava-v1.6-mistral-7b-hf]
LLAVA_NEXT_34B = register(ModelConfig(
    name="llava-next-34b", family="vlm",
    num_layers=60, d_model=7168, num_heads=56, num_kv_heads=8,
    d_ff=20480, vocab_size=64000,
    num_image_tokens=2880, vision_dim=1152,
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
))

# [dense] 5:1 local:global, 128k context [hf:google/gemma-3-1b-pt]
GEMMA3_1B = register(ModelConfig(
    name="gemma3-1b", family="dense",
    num_layers=26, d_model=1152, num_heads=4, num_kv_heads=1,
    d_ff=6912, vocab_size=262144, head_dim=256,
    sliding_window=1024, local_global_ratio=5,
    source="hf:google/gemma-3-1b-pt",
))

# [ssm] SSD (state-space duality), attn-free [arXiv:2405.21060]
MAMBA2_13B = register(ModelConfig(
    name="mamba2-1.3b", family="ssm",
    num_layers=48, d_model=2048, num_heads=0, num_kv_heads=0,
    d_ff=0, vocab_size=50280,
    ssm_state=128, ssm_headdim=64,
    source="arXiv:2405.21060",
))

# [dense] llama-arch small [hf:HuggingFaceTB/SmolLM-135M]
SMOLLM_135M = register(ModelConfig(
    name="smollm-135m", family="dense",
    num_layers=30, d_model=576, num_heads=9, num_kv_heads=3,
    d_ff=1536, vocab_size=49152,
    source="hf:HuggingFaceTB/SmolLM-135M",
))

# [moe] 40 experts top-8 [hf:ibm-granite/granite-3.0-1b-a400m-base]
GRANITE_MOE_3B = register(ModelConfig(
    name="granite-moe-3b-a800m", family="moe",
    num_layers=32, d_model=1536, num_heads=24, num_kv_heads=8,
    d_ff=512, vocab_size=49155,
    num_experts=40, top_k=8, moe_d_ff=512,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
))

# --- the paper's own evaluation models (TaiChi §4.1) ---
QWEN25_14B = register(ModelConfig(
    name="qwen2.5-14b", family="dense",
    num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8,
    d_ff=13824, vocab_size=152064, qkv_bias=True, head_dim=128,
    source="hf:Qwen/Qwen2.5-14B (paper §4.1)",
))
QWEN25_32B = register(ModelConfig(
    name="qwen2.5-32b", family="dense",
    num_layers=64, d_model=5120, num_heads=40, num_kv_heads=8,
    d_ff=27648, vocab_size=152064, qkv_bias=True, head_dim=128,
    source="hf:Qwen/Qwen2.5-32B (paper §4.1)",
))

ASSIGNED = [
    "zamba2-7b", "arctic-480b", "qwen2.5-3b", "qwen3-14b", "whisper-base",
    "llava-next-34b", "gemma3-1b", "mamba2-1.3b", "smollm-135m",
    "granite-moe-3b-a800m",
]
