"""Assigned architecture ``arctic-480b``.

[moe] 35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000, MoE 128e top-2 — 128 experts top-2 + dense residual [hf:Snowflake/snowflake-arctic-base]
"""
from repro_torch.configs.registry import ARCTIC_480B as CONFIG, reduced_config

SMOKE = reduced_config('arctic-480b')
