"""Training step and loop: the next-token LM objective on any registered
arch — the reference's ``training/train.py`` in PyTorch.

``make_train_step`` returns the (params, opt_state, batch) -> (params,
opt_state, metrics) function: the gradient by ``torch.autograd.grad``
over the parameter leaves, then the in-place AdamW update.  Training
runs the model without a cache, so no attention kernel runs in it (as in
the reference, whose kernels have no backward): its attention is plain
matrix products.  A Mamba2 layer's scan is the one kernel training
launches: on the card its forward kernel and the hand-written backward
kernel (``kernels/ssd_scan/ops.py::SSDScanFn``), so Mamba2 and zamba2
train on the card like every other family.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import torch

from repro_torch.models import transformer as tf
from repro_torch.models.config import ModelConfig
from repro_torch.training.optimizer import (AdamWConfig, OptState,
                                            adamw_update, init_opt_state,
                                            tree_leaves, tree_map)


def _like(params, leaves):
    """The tree of ``params``' shape holding ``leaves`` in leaf order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), params)


def loss_and_grads(params, cfg: ModelConfig, batch: Dict,
                   accum_steps: int = 1):
    """(loss, grads tree) of ``train_loss`` on ``batch``.  With
    ``accum_steps > 1`` the batch is cut into that many microbatches
    along its first axis and their gradients are summed in float32 and
    divided (peak activation memory falls by about that factor, at one
    forward and backward a microbatch); a leaf the loss does not reach
    gets a zero gradient."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)

    def one(mb):
        loss = tf.train_loss(params, cfg, mb)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        return loss.detach(), [torch.zeros_like(p) if g is None else g
                               for p, g in zip(leaves, grads)]

    if accum_steps == 1:
        loss, grads = one(batch)
    else:
        micro = {k: v.reshape((accum_steps, v.shape[0] // accum_steps)
                              + v.shape[1:]) for k, v in batch.items()}
        grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                 for p in leaves]
        loss = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
        for i in range(accum_steps):
            l_i, g_i = one({k: v[i] for k, v in micro.items()})
            for acc, g in zip(grads, g_i):
                acc.add_(g.float())
            loss = loss + l_i
        grads = [g / accum_steps for g in grads]
        loss = loss / accum_steps
    return loss, _like(params, grads)


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    accum_steps: int = 1) -> Callable:
    """A step updates ``params`` and ``opt_state`` in place and returns
    them with ``{"loss", "grad_norm", "step"}`` (device tensors: reading
    them waits for the step)."""

    def train_step(params, opt_state: OptState, batch: Dict):
        loss, grads = loss_and_grads(params, cfg, batch, accum_steps)
        params, opt_state, gnorm = adamw_update(opt_cfg, params, grads,
                                                opt_state)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm,
                                   "step": opt_state.step}

    return train_step


def make_eval_step(cfg: ModelConfig) -> Callable:
    @torch.no_grad()
    def eval_step(params, batch):
        return tf.train_loss(params, cfg, batch)
    return eval_step


def synthetic_lm_batches(cfg: ModelConfig, batch: int, seq: int,
                         seed: int = 0, structured: bool = True,
                         device="cuda"):
    """Infinite synthetic LM stream on ``device``, drawn on the host from
    a ``torch.Generator`` seeded with ``seed`` (so the CPU and the card
    see the same tokens; the draws differ from the reference's
    ``jax.random`` ones).  ``structured`` gives learnable bigrams (next =
    (7 t + 3) mod V, or (31 t + 17) mod V one time in ten), so the loss
    measurably falls; without it the tokens are uniform in ``[0, V)``."""
    gen = torch.Generator()
    gen.manual_seed(seed)
    V = cfg.vocab_size
    while True:
        if structured:
            tokens = torch.empty((batch, seq), dtype=torch.long)
            tokens[:, 0] = torch.randint(0, V, (batch,), generator=gen)
            noise = torch.rand((batch, seq), generator=gen) < 0.1
            for t in range(1, seq):
                tok = tokens[:, t - 1]
                tokens[:, t] = torch.where(noise[:, t - 1],
                                           (tok * 31 + 17) % V,
                                           (tok * 7 + 3) % V)
        else:
            tokens = torch.randint(0, V, (batch, seq), generator=gen)
        tokens = tokens.to(device)
        yield {"tokens": tokens, "labels": tokens}


def train_loop(cfg: ModelConfig, steps: int, batch: int, seq: int,
               opt_cfg: Optional[AdamWConfig] = None, seed: int = 0,
               log_every: int = 10, params=None, device="cuda"):
    """Train ``cfg`` for ``steps`` steps on ``device`` (the card unless
    the caller says ``"cpu"``); returns (params, history).  The host reads
    the loss only on logged steps."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("train_loop(device='cuda'): no CUDA device is "
                           "available (pass device='cpu' to train on the "
                           "CPU)")
    opt_cfg = opt_cfg or AdamWConfig(total_steps=steps,
                                     warmup_steps=max(steps // 20, 1))
    if params is None:
        params = tf.init_params(seed, cfg, device=device)
    opt_state = init_opt_state(params)
    step_fn = make_train_step(cfg, opt_cfg)
    data = synthetic_lm_batches(cfg, batch, seq, seed, device=device)
    history = []
    t0 = time.time()
    for i in range(steps):
        params, opt_state, metrics = step_fn(params, opt_state, next(data))
        if i % log_every == 0 or i == steps - 1:
            history.append({"step": i, "loss": float(metrics["loss"]),
                            "grad_norm": float(metrics["grad_norm"]),
                            "elapsed_s": round(time.time() - t0, 2)})
    return params, history
