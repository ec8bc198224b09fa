"""End-to-end training example: train a ~135M-class LM (smollm-135m
family) for a few hundred steps on synthetic LM data with AdamW + cosine
schedule, then checkpoint it in the reference's layout and restore the
file to check it.

By default the reduced config and 200 steps; ``--full`` trains the real
135M config.

  PYTHONPATH=src python -m repro_torch.examples.train_smollm \\
      [--steps 200] [--full] [--device cpu]
"""
import argparse

import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.examples._device import add_device_arg, check_device
from repro_torch.models import transformer as tf
from repro_torch.training.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.training.optimizer import tree_leaves
from repro_torch.training.train import train_loop


def main(argv=None):
    """Train, save, restore; returns (history, whether the restored
    parameters equal the trained ones bit for bit)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--ckpt", default="runs/smollm_ckpt.npz")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    check_device(args.device)

    cfg = (get_config("smollm-135m") if args.full
           else reduced_config("smollm-135m"))
    print(f"training {cfg.name}: {cfg.param_count()/1e6:.1f}M params, "
          f"{args.steps} steps, batch={args.batch}, seq={args.seq}")
    params, history = train_loop(cfg, args.steps, args.batch, args.seq,
                                 log_every=max(args.steps // 20, 1),
                                 device=args.device)
    for h in history:
        print(f"  step {h['step']:4d}  loss {h['loss']:.4f}  "
              f"gnorm {h['grad_norm']:.3f}  ({h['elapsed_s']}s)")
    first, last = history[0]["loss"], history[-1]["loss"]
    print(f"loss: {first:.3f} -> {last:.3f} "
          f"({(1 - last / first) * 100:.1f}% reduction)")
    save_checkpoint(args.ckpt, params, meta={"arch": cfg.name,
                                             "steps": args.steps}, cfg=cfg)
    restored, _ = load_checkpoint(
        args.ckpt, tf.init_params(1, cfg, device=args.device))
    equal = all(torch.equal(a.detach(), b) for a, b in
                zip(tree_leaves(params), tree_leaves(restored)))
    print("checkpoint:", args.ckpt, "(restores bit for bit)" if equal
          else "(RESTORES DIFFERENT VALUES)")
    return history, equal


if __name__ == "__main__":
    main()
