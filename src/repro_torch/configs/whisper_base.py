"""Assigned architecture ``whisper-base``.

[audio] 6L d_model=512 8H (GQA kv=8) d_ff=2048 vocab=51865 — enc-dec, conv frontend (stub) [arXiv:2212.04356]
"""
from repro_torch.configs.registry import WHISPER_BASE as CONFIG, reduced_config

SMOKE = reduced_config('whisper-base')
