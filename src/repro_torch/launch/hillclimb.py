"""Perf-iteration driver: trace one (arch x shape) case with sharding /
config overrides on the single-pod mesh and report the three roofline
terms — the reference's ``launch/hillclimb.py`` on the port's dry-run
(``dryrun.trace_case``: a fake process group of 256 ranks, fake tensors,
on the host).

  PYTHONPATH=src python -m repro_torch.launch.hillclimb --arch qwen3-14b \\
      --shape prefill_32k --kv-mode batch
"""
from __future__ import annotations

import argparse
import json

from repro_torch.analysis.roofline import roofline_report
from repro_torch.configs import get_config
from repro_torch.launch.dryrun import (FLOPS_NOTE, start_fake_world,
                                       stop_fake_world, trace_case)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import build_case


def measure(arch: str, shape: str, *, kv_mode: str = "auto",
            fsdp=None, cfg_override=None, use_hints: bool = False,
            chunk: int = None, seq_parallel: bool = False,
            accum_steps: int = 1, label: str = "") -> dict:
    start_fake_world(256)
    mesh = make_production_mesh(device="cpu")
    case = build_case(arch, shape, mesh, fsdp=fsdp,
                      cfg=cfg_override or get_config(arch), kv_mode=kv_mode,
                      chunk_override=chunk, accum_steps=accum_steps)
    counts = trace_case(case, mesh, use_hints=use_hints,
                        seq_parallel=seq_parallel)
    rec = {
        "arch": arch, "shape": shape, "mesh": "16x16", "n_devices": 256,
        "kind": case.kind, "note": f"{label or kv_mode}",
        "hints": use_hints, "seq_parallel": seq_parallel,
        **counts,
        "cost_method": "traced",
        "flops_note": FLOPS_NOTE,
    }
    rec["roofline"] = roofline_report(rec)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--kv-mode", default="auto")
    ap.add_argument("--hints", action="store_true")
    ap.add_argument("--chunk", type=int, default=None)
    ap.add_argument("--seq-parallel", action="store_true")
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)
    try:
        rec = measure(args.arch, args.shape, kv_mode=args.kv_mode,
                      use_hints=args.hints, chunk=args.chunk,
                      seq_parallel=args.seq_parallel,
                      accum_steps=args.accum, label=args.label)
    finally:
        stop_fake_world()
    print(json.dumps(rec, indent=2))


if __name__ == "__main__":
    main()
