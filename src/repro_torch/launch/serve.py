"""Serving launcher of the port: run a TaiChi (or baseline) cluster.

Modes:
  --engine sim    event-driven simulator with estimator timing (default;
                  any registered arch, production scale)
  --engine torch  real PyTorch engine with the hand-written CUDA kernels:
                  tokens are really computed, batch replay.  Runs on the
                  card (``--device cuda``, the default) at the registered
                  width; ``--reduced`` serves the small test variant and
                  ``--device cpu`` the kernels' plain versions.  All-ATTN
                  archs take the paged executor path, Mamba2 and hybrid
                  archs (mamba2-1.3b, zamba2-7b) the batched dense one, as
                  ``engine.packable`` decides.

``--engine live`` (the online serving loop) and ``--serve`` (the network
front end) are not in the port yet and exit saying so.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-14b \\
      --policy taichi --np 2 --nd 2 --sp 1024 --sd 256 --qps 80
  PYTHONPATH=src python -m repro_torch.launch.serve --engine torch \\
      --arch qwen2.5-3b --np 1 --nd 1 --qps 4 --n 32
  PYTHONPATH=src python -m repro_torch.launch.serve --engine torch \\
      --arch smollm-135m --reduced --device cpu --qps 2 --n 16
  PYTHONPATH=src python -m repro_torch.launch.serve --engine torch \\
      --arch zamba2-7b --reduced --device cpu --qps 2 --n 8 --np 1 --nd 1
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from repro_torch.configs import get_config, reduced_config
from repro_torch.core.latency import SLO
from repro_torch.core.policies import Sliders
from repro_torch.sim.simulator import ServingConfig, build_cluster, run_sim
from repro_torch.sim.workload import WORKLOADS, LengthDist, WorkloadSpec

_LATER = ("is not in the PyTorch port yet: the online ServingLoop "
          "(--engine live) and the HTTP front end (--serve) come with a "
          "later slice; use --engine sim or --engine torch")


def _torch_mode(args, slo: SLO):
    """Batch replay on the real engine: shared random weights from a
    seed, one TorchExecutor an instance."""
    import torch

    from repro_torch.engine.engine import TorchExecutor
    from repro_torch.models import transformer as tf
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        sys.exit("--device cuda: no CUDA device is available "
                 "(--device cpu runs the kernels' plain versions)")
    if args.reduced:
        cfg = reduced_config(args.arch)
        sp, sd, max_seq, blocks = min(args.sp, 64), min(args.sd, 32), 512, 512
        wl = WorkloadSpec("tiny",
                          LengthDist(mu=3.4, sigma=0.4, lo=16, hi=128),
                          LengthDist(mu=2.5, sigma=0.4, lo=4, hi=32),
                          tokenized=True, vocab_size=cfg.vocab_size)
    else:
        cfg = get_config(args.arch)
        sp, sd, max_seq, blocks = args.sp, args.sd, args.max_seq, \
            args.hbm_blocks
        wl = WorkloadSpec("replay",
                          LengthDist(mu=6.3, sigma=0.7, lo=64,
                                     hi=max_seq // 2),
                          LengthDist(mu=4.0, sigma=0.6, lo=8, hi=128),
                          tokenized=True, vocab_size=cfg.vocab_size)
    params = tf.init_params(0, cfg, device=args.device)
    sc = ServingConfig(model=args.arch, tp=1, policy=args.policy,
                       sliders=Sliders(n_p=args.np, n_d=args.nd,
                                       s_p=sp, s_d=sd),
                       hbm_blocks=blocks)
    factory = lambda: TorchExecutor(cfg, params, n_slots=args.slots,
                                    max_seq=max_seq, hbm_blocks=blocks,
                                    device=args.device)
    cluster = build_cluster(sc, slo, executor_factory=factory)
    reqs = wl.sample_requests(args.n, args.qps, seed=0)
    t0 = time.perf_counter()
    cluster.run(reqs)
    wall = time.perf_counter() - t0
    st = cluster.stats(reqs, slo, args.qps)
    tokens = sum(len(r.output_tokens) for r in reqs)
    print(json.dumps({**st.summary(),
                      "policy": args.policy,
                      "device": args.device,
                      "model": cfg.name,
                      "real_tokens": tokens,
                      "wall_s": round(wall, 3),
                      "transfers": cluster.transfer_count}, indent=2))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-14b")
    ap.add_argument("--engine", choices=["sim", "torch", "live"],
                    default="sim")
    ap.add_argument("--policy", default="taichi",
                    choices=["taichi", "aggregation", "disaggregation"])
    ap.add_argument("--np", type=int, default=2)
    ap.add_argument("--nd", type=int, default=2)
    ap.add_argument("--sp", type=int, default=1024)
    ap.add_argument("--sd", type=int, default=256)
    ap.add_argument("--tp", type=int, default=4)
    ap.add_argument("--qps", type=float, default=40.0)
    ap.add_argument("--n", type=int, default=300)
    ap.add_argument("--workload", default="sharegpt",
                    choices=sorted(WORKLOADS))
    ap.add_argument("--ttft-slo", type=float, default=1.5)
    ap.add_argument("--tpot-slo", type=float, default=0.030)
    # torch-engine knobs
    ap.add_argument("--device", default="cuda",
                    help="torch: device of the engine (default cuda)")
    ap.add_argument("--reduced", action="store_true",
                    help="torch: serve the reduced test variant of --arch "
                         "instead of the registered width")
    ap.add_argument("--slots", type=int, default=16,
                    help="torch: resident requests an instance")
    ap.add_argument("--max-seq", type=int, default=4096,
                    help="torch: longest context an instance holds")
    ap.add_argument("--hbm-blocks", type=int, default=8192,
                    help="torch: 16-token KV blocks an instance")
    ap.add_argument("--serve", metavar="HOST:PORT", default=None,
                    help="(not in the port yet)")
    args = ap.parse_args(argv)

    if args.serve:
        sys.exit("--serve " + _LATER)
    if args.engine == "live":
        sys.exit("--engine live " + _LATER)

    slo = SLO(ttft=args.ttft_slo, tpot=args.tpot_slo)
    if args.engine == "torch":
        return _torch_mode(args, slo)

    sc = ServingConfig(model=args.arch, tp=args.tp, policy=args.policy,
                       sliders=Sliders(n_p=args.np, n_d=args.nd,
                                       s_p=args.sp, s_d=args.sd))
    st = run_sim(sc, slo, WORKLOADS[args.workload], args.qps, args.n)
    c = st.cluster
    print(json.dumps({**st.summary(),
                      "policy": args.policy,
                      "transfers": c.transfer_count,
                      "backflows": c.backflow_count,
                      "degrades": c.degrade_count}, indent=2))


if __name__ == "__main__":
    main()
