"""The precision of the references' matrix products, shared by every
family's reference: exact float32 (TF32 off), and the comparison's
control, float8 e4m3 products."""
from __future__ import annotations

import torch


def exact():
    """Float32 products stay float32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def exact_mm(a, b):
    return a @ b


def _fp8(x, dim):
    s = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30) / 448.0
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


def fp8_mm(a, b):
    """``a @ b`` with ``a``'s rows and ``b``'s columns rounded to float8
    e4m3, each scaled to its largest magnitude; accumulated in float32."""
    return _fp8(a, -1) @ _fp8(b, -2)
