"""AdamW with a cosine schedule and global-norm clipping — the reference's
``training/optimizer.py`` on the port's parameter tree.

The state holds one float32 ``m`` and ``v`` a parameter leaf, in a tree
of the parameters' shape; ``adamw_update`` updates parameters and state
IN PLACE (under ``torch.no_grad``), where the reference returns new
trees.  The update is taken in float32 and cast back to the parameter's
type; every scalar of it (the schedule's learning rate, the bias
corrections, the clip scale) is a float32 tensor on the parameters'
device, as the reference computes them, so bf16 parameters round as the
reference's do and no step waits on the host.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


class OptState(NamedTuple):
    step: torch.Tensor          # int32 scalar: updates taken
    m: dict
    v: dict


def tree_leaves(tree):
    """Leaves of a nested dict / list / tuple of tensors, dict keys in
    their insertion order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def init_opt_state(params) -> OptState:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    device = tree_leaves(params)[0].device
    return OptState(step=torch.zeros((), dtype=torch.int32, device=device),
                    m=tree_map(zeros, params), v=tree_map(zeros, params))


def schedule(cfg: AdamWConfig, step):
    """Learning rate at ``step`` (a float32 tensor): linear warm-up, then
    a cosine from ``lr`` down to ``min_lr_ratio * lr``; in float32."""
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def global_norm(tree):
    """sqrt of the sum of squares of every leaf, in float32."""
    return torch.sqrt(sum(x.float().square().sum()
                          for x in tree_leaves(tree)))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params, grads, state: OptState):
    """One AdamW step over the parameter tree, in place: gradients clipped
    to ``clip_norm`` by their global norm, bias-corrected moments, weight
    decay on matrices only (``ndim >= 2``).  ``grads`` is a tree of the
    parameters' shape (any float type).  Returns (params, state, the
    gradients' global norm before clipping)."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    state.step.add_(1)
    step = state.step.float()
    lr = schedule(cfg, step)
    b1c = 1 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32,
                                     device=step.device), step)
    b2c = 1 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32,
                                     device=step.device), step)
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(state.m), tree_leaves(state.v)):
        g = g.float() * scale
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g.square())
        delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        if p.dim() >= 2:                    # decay matrices only
            delta = delta + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
    return params, state, gnorm
