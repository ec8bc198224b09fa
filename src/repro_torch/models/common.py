"""Shared PyTorch building blocks: init helper, RMSNorm, RoPE, SwiGLU and
the cross-entropy loss."""
from __future__ import annotations

import torch

from repro_torch.distributed import hints

# float32 matrix products stay full float32 on the card (no TF32): the
# parity tolerances against the reference are stated for that.
torch.backends.cuda.matmul.allow_tf32 = False

# ---------------------------------------------------------------------------
# Parameter init
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, shape, dtype, scale: float | None = None):
    """Truncated-normal fan-in init (LLaMA-style), drawn from ``gen`` on
    the generator's device.  On the ``meta`` device nothing is drawn (see
    ``transformer.abstract_params``)."""
    if gen.device.type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    fan_in = shape[0] if len(shape) > 1 else shape[-1]
    if scale is None:
        scale = fan_in ** -0.5
    w = torch.empty(shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(w, mean=0.0, std=1.0, a=-3.0, b=3.0,
                                generator=gen)
    return (w * scale).to(dtype)


# ---------------------------------------------------------------------------
# Normalisation
# ---------------------------------------------------------------------------

def rms_norm(x, weight, eps: float = 1e-6):
    """RMSNorm in float32 with a ``1 + weight`` gain (zero-init weight)."""
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + weight.float())).to(dt)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def rope_tables(positions, head_dim: int, theta: float):
    """(cos, sin), each [..., T, 1, D/2] float32, for absolute
    ``positions`` [..., T] — computed once a forward pass and shared by
    every layer."""
    freqs = rope_freqs(head_dim, theta, positions.device)
    angles = positions[..., None].float() * freqs
    return torch.cos(angles)[..., None, :], torch.sin(angles)[..., None, :]


def apply_rope(x, positions, theta: float, tables=None):
    """x: [..., T, H, D]; positions: broadcastable to [..., T] (absolute).
    Half-split layout: the pair of element i is element i + D/2."""
    cos, sin = tables if tables is not None else rope_tables(
        positions, x.shape[-1], theta)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, dtype):
    return {
        "w_gate": dense_init(gen, (d_model, d_ff), dtype),
        "w_up": dense_init(gen, (d_model, d_ff), dtype),
        "w_down": dense_init(gen, (d_ff, d_model), dtype),
    }


def mlp(params, x):
    g = x @ params["w_gate"]
    u = x @ params["w_up"]
    h = torch.nn.functional.silu(g.float()).to(x.dtype) * u
    return h @ params["w_down"]


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------

def _xent_split_vocab(logits, labels):
    """The cross-entropy of DTensor logits whose vocabulary may be split
    across ranks, on local shards: each rank's max, then its sum of
    exponentials and its pick of the label's logit (where its slice of
    the vocabulary holds it) reduce across ranks as [B, T] floats.
    DTensor's own logsumexp and gather move whole-vocabulary logits (or
    their gradients) on every rank."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh, v = logits.device_mesh, logits.ndim - 1
    xpl = tuple(Replicate() if isinstance(p, Partial) else p
                for p in logits.placements)
    split = lambda p: isinstance(p, Shard) and p.dim == v
    red = lambda op: tuple(Partial(op) if split(p) else p for p in xpl)
    rows = tuple(Replicate() if split(p) else p for p in xpl)
    m = hints.local_call(lambda x: x.amax(-1), (logits,), (xpl,),
                         red("max"), mesh).redistribute(mesh, rows).detach()
    ids = hints.split_like(torch.arange(logits.shape[-1],
                                        device=logits.device), logits, (v,))

    def local(x, m, lab, ids):
        hit = lab[..., None].long() == ids
        return (torch.exp(x - m[..., None]).sum(-1),
                torch.where(hit, x, torch.zeros((), device=x.device)).sum(-1))

    sums, picked = hints.local_call(
        local, (logits, m, labels, ids),
        (xpl, rows, hints.placements_for(logits, tuple(range(v))),
         hints.placements_for(logits, (v,))),
        [red("sum"), red("sum")], mesh)
    return m + torch.log(sums) - picked


def softmax_xent(logits, labels, mask=None):
    """Mean cross-entropy over valid positions, in float32.  logits [...,
    V], labels [...] integer, mask [...] or None (every position valid);
    the divisor is the mask's sum floored at 1."""
    logits = logits.float()
    if hints.is_sharded(logits):
        nll = _xent_split_vocab(logits, labels)
    else:
        logz = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
        nll = logz - ll
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)
