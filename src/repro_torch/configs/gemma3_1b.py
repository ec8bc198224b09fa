"""Assigned architecture ``gemma3-1b``.

[dense] 26L d_model=1152 4H (GQA kv=1) d_ff=6912 vocab=262144 — 5:1 local:global, 128k [hf:google/gemma-3-1b-pt]
"""
from repro_torch.configs.registry import GEMMA3_1B as CONFIG, reduced_config

SMOKE = reduced_config('gemma3-1b')
