"""Assigned architecture ``qwen2.5-3b``.

[dense] 36L d_model=2048 16H (GQA kv=2) d_ff=11008 vocab=151936 — GQA, QKV bias [hf:Qwen/Qwen2.5-0.5B]
"""
from repro_torch.configs.registry import QWEN25_3B as CONFIG, reduced_config

SMOKE = reduced_config('qwen2.5-3b')
