"""Assigned architecture ``smollm-135m``.

[dense] 30L d_model=576 9H (GQA kv=3) d_ff=1536 vocab=49152 — llama-arch small [hf:HuggingFaceTB/SmolLM-135M]
"""
from repro_torch.configs.registry import SMOLLM_135M as CONFIG, reduced_config

SMOKE = reduced_config('smollm-135m')
