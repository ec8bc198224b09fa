"""Assigned architecture ``mamba2-1.3b``.

[ssm] 48L d_model=2048 (attn-free) d_ff=0 vocab=50280, ssm_state=128 — SSD (state-space duality) [arXiv:2405.21060]
"""
from repro_torch.configs.registry import MAMBA2_13B as CONFIG, reduced_config

SMOKE = reduced_config('mamba2-1.3b')
