"""Assigned architecture ``zamba2-7b``.

[hybrid] 81L d_model=3584 32H (GQA kv=32) d_ff=14336 vocab=32000, ssm_state=64 — Mamba2 + shared attn blocks [arXiv:2411.15242]
"""
from repro_torch.configs.registry import ZAMBA2_7B as CONFIG, reduced_config

SMOKE = reduced_config('zamba2-7b')
