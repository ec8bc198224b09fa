"""Mixture-of-experts FFN with capacity-based dispatch — the reference's
``models/moe.py``.

Two dispatch strategies, as in the reference:

* per-row dispatch (prefill, T > 1): each batch row's ``T * k`` slots are
  dispatched on their own, with capacity ``ceil(T * k * cf / E)`` an
  expert;
* global dispatch (decode, T == 1): the batch's ``B * k`` slots are
  flattened into one dispatch with capacity ``ceil(B * k * cf / E)``, so
  every row of the batch, scheduled or not, takes its place in the
  experts' capacity.

A slot past its expert's capacity is dropped (it falls through to the
residual).  Priority is token-major over the flattened slots: the
position of a slot in its expert is the count of earlier slots routed
there.

Every step is a fixed-shape tensor operation — no ``nonzero``, no boolean
indexing, no host read — so a decode step that runs it can be captured as
a CUDA graph.  Where the reference scatter-adds, the port writes in a way
whose result does not depend on the order of the writes:

* dispatch: a kept slot's ``(expert, position)`` is its own, so the kept
  slots are written with one indexed copy; the dropped ones land in one
  spare row that is cut off after;
* combine: a token's ``k`` contributions are added in its slot order, the
  sum rounded to the activation type after each add, which is what the
  reference's ``out.at[tok].add`` computes (an ``index_add_`` with
  atomics gives bf16 sums that vary from run to run).

The expert products are batched matmuls, as the reference's einsums: the
reference computes them outside any Pallas kernel.
"""
from __future__ import annotations

import torch

from repro_torch.models.common import dense_init


def init_moe(gen: torch.Generator, cfg):
    d, E, f = cfg.d_model, cfg.num_experts, cfg.expert_d_ff
    return {
        "router": dense_init(gen, (d, E), torch.float32),
        "w_gate": dense_init(gen, (E, d, f), cfg.param_dtype),
        "w_up": dense_init(gen, (E, d, f), cfg.param_dtype),
        "w_down": dense_init(gen, (E, f, d), cfg.param_dtype),
    }


def _route(p, cfg, x):
    """x [..., d] -> (weights [..., k] float32, idx [..., k], aux_loss).

    Top-k of the float32 router logits, highest first and, between equal
    logits, the lower expert first (``jax.lax.top_k``'s order, which
    ``torch.topk`` does not promise: a stable descending sort keeps it);
    the weights are the softmax over the k values; the aux loss is the
    Switch-style load-balance loss."""
    logits = x.float() @ p["router"]
    k, E = cfg.top_k, cfg.num_experts
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    vals, idx = vals[..., :k], idx[..., :k]
    weights = torch.softmax(vals, dim=-1)
    probs = torch.softmax(logits, dim=-1)
    me = probs.reshape(-1, E).mean(dim=0)
    ce = _one_hot(idx, E).float().sum(dim=-2).reshape(-1, E).mean(dim=0) / k
    aux = E * (me * ce).sum()
    return weights, idx, aux


def _one_hot(idx, E: int):
    """[..., E] int64 indicator of ``idx`` (no check of the values on the
    host, so a captured step may hold it)."""
    return (idx[..., None] == torch.arange(E, device=idx.device)).long()


def _expert_ffn(p, xg):
    """xg [..., E, C, d] -> [..., E, C, d], each expert's SwiGLU (the
    gate's SiLU in float32, cast before the product with ``u``)."""
    g = xg @ p["w_gate"]
    u = xg @ p["w_up"]
    h = torch.nn.functional.silu(g.float()).to(xg.dtype) * u
    return h @ p["w_down"]


def _dispatch_combine(p, cfg, xt, weights, idx, capacity: int):
    """Dispatch the tokens of each batch row of xt [R, N, d] with routing
    weights / idx [R, N, k] into grouped [R, E, C, d], run the experts,
    combine back to [R, N, d]."""
    R, N, d = xt.shape
    E, k = cfg.num_experts, cfg.top_k
    dev = xt.device
    fe = idx.reshape(R, N * k)                        # expert of each slot
    onehot = _one_hot(fe, E)                          # [R, N*k, E]
    # a slot's position in its expert: the earlier slots routed there
    pie = (torch.cumsum(onehot, dim=1) - onehot).gather(
        2, fe[..., None])[..., 0]                     # [R, N*k]
    keep = pie < capacity
    # a dropped slot lands in the spare row C, which is cut off
    dest = fe * (capacity + 1) + torch.where(keep, pie,
                                             torch.full_like(pie, capacity))
    rows = (torch.arange(R, device=dev)[:, None] * (E * (capacity + 1))
            + dest).reshape(-1)
    xg = torch.zeros((R * E * (capacity + 1), d), dtype=xt.dtype, device=dev)
    xg.index_copy_(0, rows, xt.repeat_interleave(k, dim=1).reshape(-1, d))
    xg = xg.reshape(R, E, capacity + 1, d)[:, :, :capacity]
    yg = _expert_ffn(p, xg)
    # each slot's expert output (a dropped slot reads row C - 1 and is
    # weighed 0), weighed, then added to its token in slot order
    src = (fe * capacity + torch.clamp(pie, max=capacity - 1))[..., None]
    yflat = torch.gather(yg.reshape(R, E * capacity, d), 1,
                         src.expand(R, N * k, d))
    wk = (weights.reshape(R, N * k) * keep).to(xt.dtype)
    yflat = (yflat * wk[..., None]).reshape(R, N, k, d)
    out = torch.zeros((R, N, d), dtype=xt.dtype, device=dev)
    for j in range(k):
        out = out + yflat[:, :, j]
    return out


def moe_ffn(p, cfg, x):
    """x [B, T, d] -> (out [B, T, d], aux_loss float32 scalar)."""
    B, T, d = x.shape
    weights, idx, aux = _route(p, cfg, x)
    weights = weights.to(x.dtype)
    E, k, cf = cfg.num_experts, cfg.top_k, cfg.capacity_factor
    if T == 1:
        capacity = max(1, int(-(-B * k * cf // E)))
        out = _dispatch_combine(p, cfg, x[:, 0][None], weights[:, 0][None],
                                idx[:, 0][None], capacity)
        return out[0][:, None], aux
    capacity = max(1, int(-(-T * k * cf // E)))
    return _dispatch_combine(p, cfg, x, weights, idx, capacity), aux
