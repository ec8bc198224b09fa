"""Model configuration covering every assigned architecture family.

A single ``ModelConfig`` drives the unified decoder stack in
``repro_torch.models.transformer``.  Families:

  dense   — GQA transformer (qwen2.5, qwen3, smollm, gemma3, llava/whisper backbones)
  moe     — dense attention + mixture-of-experts FFN (arctic, granite)
  ssm     — Mamba2/SSD mixer-only stack (mamba2-1.3b)
  hybrid  — Mamba2 backbone with shared attention blocks (zamba2)
  audio   — encoder-decoder transformer, stub conv/mel frontend (whisper)
  vlm     — dense decoder consuming stub patch embeddings (llava-next)

The per-layer *block pattern* is expressed as repeated *segments* so the
reference's parameter layout (one stacked leaf per pattern position) maps
onto the port's per-layer list through ``repro_torch.convert``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

# dtype name -> (torch dtype, bytes per element): the one place the port
# turns a config's ``dtype`` string into a framework type
DTYPES = {
    "float32": (torch.float32, 4),
    "bfloat16": (torch.bfloat16, 2),
    "float16": (torch.float16, 2),
    "int8": (torch.int8, 1),
}


def dtype_itemsize(name: str) -> int:
    return DTYPES[name][1]

# Block type identifiers (strings keep the pattern pytree-static).
ATTN = "attn"            # full-attention transformer layer (attn + ffn)
ATTN_LOCAL = "attn_local"  # sliding-window attention layer (gemma3 local)
MOE = "moe"              # attention + MoE ffn (+ optional dense residual)
MAMBA2 = "mamba2"        # Mamba2/SSD mixer layer (no ffn when d_ff == 0)
ZAMBA_ATTN = "zamba_attn"  # shared-params attention block + own mamba2 layer
ENC = "enc"              # bidirectional encoder layer (whisper encoder)
DEC = "dec"              # decoder layer with self + cross attention (whisper)


@dataclasses.dataclass(frozen=True)
class Segment:
    """A run of ``n_periods`` repetitions of ``pattern`` (a tuple of block
    types).  Parameters for a segment are stacked with leading axis
    ``n_periods`` per pattern position, so the forward pass scans."""

    pattern: Tuple[str, ...]
    n_periods: int

    @property
    def n_layers(self) -> int:
        return len(self.pattern) * self.n_periods


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // num_heads

    # --- attention options ---
    qkv_bias: bool = False           # qwen2.5
    qk_norm: bool = False            # qwen3
    rope_theta: float = 1e6
    sliding_window: int = 0          # gemma3 local layers
    local_global_ratio: int = 0      # gemma3: N local layers per global

    # --- MoE ---
    num_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0                # expert hidden size (d_ff used if 0)
    dense_residual: bool = False     # arctic: dense FFN parallel to MoE
    capacity_factor: float = 1.25

    # --- SSM / Mamba2 ---
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 256             # SSD chunk length

    # --- hybrid (zamba2) ---
    attn_period: int = 0             # shared attention every N layers

    # --- enc-dec (whisper) ---
    num_encoder_layers: int = 0

    # --- vlm (llava) ---
    num_image_tokens: int = 0        # max anyres patch embeddings per request
    vision_dim: int = 0              # stub vision encoder output width

    # --- numerics ---
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    remat: bool = True               # activation checkpointing per scan period
    scan_unroll: bool = False        # unroll layer/chunk scans (cost probes)

    # provenance
    source: str = ""

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    # ------------------------------------------------------------------
    @property
    def param_dtype(self):
        return DTYPES[self.dtype][0]

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.ssm_d_inner // self.ssm_headdim

    @property
    def ssm_ngroups(self) -> int:
        return 1

    @property
    def expert_d_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

    # ------------------------------------------------------------------
    def segments(self) -> Tuple[Segment, ...]:
        """Decompose the layer stack into scannable segments."""
        L = self.num_layers
        if self.family in ("dense", "vlm"):
            if self.local_global_ratio > 0:
                # gemma3: (ratio local, 1 global) repeating; trailing locals.
                period = (ATTN_LOCAL,) * self.local_global_ratio + (ATTN,)
                n_full, rem = divmod(L, len(period))
                segs = []
                if n_full:
                    segs.append(Segment(period, n_full))
                if rem:
                    segs.append(Segment((ATTN_LOCAL,) * rem, 1))
                return tuple(segs)
            return (Segment((ATTN,), L),)
        if self.family == "moe":
            return (Segment((MOE,), L),)
        if self.family == "ssm":
            return (Segment((MAMBA2,), L),)
        if self.family == "hybrid":
            p = self.attn_period
            period = (MAMBA2,) * (p - 1) + (ZAMBA_ATTN,)
            n_full, rem = divmod(L, p)
            segs = []
            if n_full:
                segs.append(Segment(period, n_full))
            if rem:
                segs.append(Segment((MAMBA2,) * rem, 1))
            return tuple(segs)
        if self.family == "audio":
            return (
                Segment((ENC,), self.num_encoder_layers),
                Segment((DEC,), self.num_layers),
            )
        raise ValueError(f"unknown family {self.family}")

    def attn_layer_count(self) -> int:
        n = 0
        for seg in self.segments():
            for b in seg.pattern:
                if b in (ATTN, ATTN_LOCAL, ZAMBA_ATTN, DEC):
                    n += seg.n_periods
        return n

    # ------------------------------------------------------------------
    def kv_cache_bytes(self, batch: int, seq: int) -> int:
        """Approximate KV/state cache footprint (for HBM accounting in the
        scheduler/estimator; the dry-run uses real memory_analysis)."""
        itemsize = dtype_itemsize(self.dtype)
        total = 0
        for seg in self.segments():
            for b in seg.pattern:
                if b in (ATTN, MOE, ZAMBA_ATTN, DEC):
                    total += (seg.n_periods * 2 * batch * seq
                              * self.num_kv_heads * self.head_dim * itemsize)
                    if b == DEC:  # cross-attention KV (encoder length ~ seq)
                        total += (seg.n_periods * 2 * batch * seq
                                  * self.num_kv_heads * self.head_dim * itemsize)
                elif b == ATTN_LOCAL:
                    w = min(self.sliding_window or seq, seq)
                    total += (seg.n_periods * 2 * batch * w
                              * self.num_kv_heads * self.head_dim * itemsize)
                if b in (MAMBA2, ZAMBA_ATTN):
                    # ssm state + conv state, O(1) in seq
                    total += seg.n_periods * batch * (
                        self.ssm_nheads * self.ssm_headdim * self.ssm_state
                        + (self.ssm_conv - 1)
                        * (self.ssm_d_inner + 2 * self.ssm_ngroups * self.ssm_state)
                    ) * itemsize
        return total

    def param_count(self) -> int:
        """Analytic parameter count (embeddings included)."""
        d, ff, V = self.d_model, self.d_ff, self.vocab_size
        hq, hkv, dh = self.num_heads, self.num_kv_heads, self.head_dim
        attn = d * dh * (hq + 2 * hkv) + hq * dh * d
        mlp = 3 * d * ff
        per = {}
        per[ATTN] = attn + mlp
        per[ATTN_LOCAL] = attn + mlp
        per[DEC] = 2 * attn + mlp
        per[ENC] = attn + mlp
        eff = self.expert_d_ff
        per[MOE] = attn + self.num_experts * 3 * d * eff + d * self.num_experts
        if self.dense_residual:
            per[MOE] += mlp
        dimm = self.ssm_d_inner
        ssm_in = d * (2 * dimm + 2 * self.ssm_ngroups * self.ssm_state
                      + self.ssm_nheads)
        per[MAMBA2] = ssm_in + dimm * d + self.ssm_conv * (
            dimm + 2 * self.ssm_ngroups * self.ssm_state)
        per[ZAMBA_ATTN] = per[MAMBA2]  # shared attn counted once below
        total = 0
        for seg in self.segments():
            for b in seg.pattern:
                total += per[b] * seg.n_periods
        if self.family == "hybrid":
            total += attn + mlp  # the single shared attention block
        total += V * d  # embed
        total += V * d  # lm head (untied)
        if self.family == "vlm":
            total += self.vision_dim * d  # projector
        return total

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top_k experts only)."""
        if self.family != "moe":
            return self.param_count()
        d, eff = self.d_model, self.expert_d_ff
        inactive = (self.num_experts - self.top_k) * 3 * d * eff
        total = 0
        for seg in self.segments():
            total += seg.n_layers * inactive
        return self.param_count() - total
