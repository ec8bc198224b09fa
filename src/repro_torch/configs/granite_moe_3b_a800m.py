"""Assigned architecture ``granite-moe-3b-a800m``.

[moe] 32L d_model=1536 24H (GQA kv=8) d_ff=512 vocab=49155, MoE 40e top-8 [hf:ibm-granite/granite-3.0-1b-a400m-base]
"""
from repro_torch.configs.registry import GRANITE_MOE_3B as CONFIG, reduced_config

SMOKE = reduced_config('granite-moe-3b-a800m')
