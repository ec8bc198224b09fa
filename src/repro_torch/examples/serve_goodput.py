"""Goodput comparison (the paper's headline experiment, Figs 15/16) at
simulator scale: PD aggregation vs PD disaggregation vs TaiChi on the
ShareGPT-like chatbot workload under a balanced SLO, with the estimator's
timing for the H100.  The simulator computes no tensor, so it runs on the
host alone and takes no ``--device``.

  PYTHONPATH=src python -m repro_torch.examples.serve_goodput \\
      [--grid 60,80,100,110,120,130] [--n 250]
"""
import argparse

from repro_torch.core.latency import SLO
from repro_torch.core.policies import Sliders
from repro_torch.sim.simulator import ServingConfig, goodput_sweep
from repro_torch.sim.workload import SHAREGPT


def main(argv=None):
    """Sweep the three settings; returns {name: goodput}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--grid", default="60,80,100,110,120,130",
                    help="comma-separated request rates (QPS) to try")
    ap.add_argument("--n", type=int, default=250,
                    help="requests a rate")
    args = ap.parse_args(argv)
    slo = SLO(ttft=1.5, tpot=0.030)
    grid = [float(q) for q in args.grid.split(",")]
    configs = {
        "PD aggregation   ": ServingConfig(
            policy="aggregation", sliders=Sliders(2, 2, 1024, 1024)),
        "PD disaggregation": ServingConfig(
            policy="disaggregation", sliders=Sliders(2, 2, 0, 0)),
        "TaiChi (hybrid)  ": ServingConfig(
            policy="taichi", sliders=Sliders(2, 2, 1024, 256)),
    }
    print(f"balanced SLO: TTFT<{slo.ttft}s TPOT<{slo.tpot*1e3:.0f}ms; "
          f"goodput = max QPS with >=90% attainment\n")
    results = {}
    for name, sc in configs.items():
        g, stats = goodput_sweep(sc, slo, SHAREGPT, grid, n_requests=args.n)
        results[name] = g
        curve = "  ".join(f"{s.qps:g}:{s.slo_attainment:.2f}"
                          for s in stats)
        print(f"{name} goodput={g:>5g} qps   [{curve}]")
    tai = results["TaiChi (hybrid)  "]
    for name, g in results.items():
        if "TaiChi" not in name and g > 0:
            print(f"TaiChi vs {name.strip()}: "
                  f"{(tai - g) / g * 100:+.0f}% goodput")
    return {name.strip(): g for name, g in results.items()}


if __name__ == "__main__":
    main()
