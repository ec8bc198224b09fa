"""Assigned architecture ``llava-next-34b``.

[vlm] 60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000 — anyres tiling [hf:llava-hf/llava-v1.6-mistral-7b-hf]
"""
from repro_torch.configs.registry import LLAVA_NEXT_34B as CONFIG, reduced_config

SMOKE = reduced_config('llava-next-34b')
