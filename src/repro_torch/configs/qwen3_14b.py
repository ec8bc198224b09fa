"""Assigned architecture ``qwen3-14b``.

[dense] 40L d_model=5120 40H (GQA kv=8) d_ff=17408 vocab=151936 — qk_norm, GQA [hf:Qwen/Qwen3-8B]
"""
from repro_torch.configs.registry import QWEN3_14B as CONFIG, reduced_config

SMOKE = reduced_config('qwen3-14b')
