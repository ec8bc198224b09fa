"""Training launcher of the port: train a registered arch on synthetic
LM data with AdamW, on the card (``--device cuda``, the default) or on
the CPU.  By default the reduced smoke variant; ``--full-config`` trains
the registered width and depth.

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
      --steps 25 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \\
      --full-config --steps 10 --batch 8 --seq 512

Every registered family trains on the card, Mamba2 and zamba2 included:
their scan runs the forward kernel and its hand-written backward
(``kernels/ssd_scan/ops.py::SSDScanFn``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-1.3b \\
      --full-config --steps 10 --batch 8 --seq 512
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from repro_torch.configs import get_config, list_archs, reduced_config
from repro_torch.training.checkpoint import save_checkpoint
from repro_torch.training.train import train_loop


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m", choices=list_archs())
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--full-config", action="store_true",
                    help="use the full (assigned) config instead of the "
                         "reduced smoke variant")
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        sys.exit("--device cuda: no CUDA device is available "
                 "(--device cpu trains on the CPU)")
    cfg = (get_config(args.arch) if args.full_config
           else reduced_config(args.arch))
    params, history = train_loop(cfg, args.steps, args.batch, args.seq,
                                 device=args.device)
    print(json.dumps(history, indent=2))
    if args.ckpt:
        save_checkpoint(args.ckpt, params, meta={"arch": cfg.name,
                                                 "steps": args.steps},
                        cfg=cfg)
        print("checkpoint saved to", args.ckpt)


if __name__ == "__main__":
    main()
