"""PyTorch/CUDA port of the TaiChi serving system.

Mirrors the sub-packages of the JAX reference package ``repro`` module
for module, imports ``torch`` and numpy only, and runs on the card unless
the caller passes ``device="cpu"``.
"""
import torch

# float32 matrix products stay full float32 on the card (no TF32): the
# parity tolerances against the reference are stated for that.
torch.backends.cuda.matmul.allow_tf32 = False
