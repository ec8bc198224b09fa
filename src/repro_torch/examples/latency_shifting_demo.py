"""Latency-shifting under the microscope: drive a small TaiChi cluster
into memory pressure and watch Algorithm 1 (flowing decode) move the
longest-output request to a P-heavy instance and flow it back as its
TPOT approaches the SLO — with REAL token generation preserved across
the migrations (the engine is bit-exact across flows).

  PYTHONPATH=src python -m repro_torch.examples.latency_shifting_demo \\
      [--device cpu]
"""
import argparse

from repro_torch.configs import reduced_config
from repro_torch.core.cluster import Cluster
from repro_torch.core.estimator import CostModel
from repro_torch.core.hw import InstanceSpec
from repro_torch.core.latency import SLO
from repro_torch.core.policies import Sliders, TaiChiPolicy, build_instances
from repro_torch.engine.engine import TorchExecutor
from repro_torch.engine.request import Request
from repro_torch.examples._device import add_device_arg, check_device
from repro_torch.models import transformer as tf


def main(argv=None):
    """Run the burst; returns the cluster (its ``degrade_count`` counts
    the watermark-triggered flows)."""
    ap = argparse.ArgumentParser()
    add_device_arg(ap)
    args = ap.parse_args(argv)
    check_device(args.device)
    cfg = reduced_config("smollm-135m")
    params = tf.init_params(0, cfg, device=args.device)
    cost = CostModel(cfg, InstanceSpec(tp=1))
    sliders = Sliders(n_p=1, n_d=1, s_p=64, s_d=16,
                      watermark=0.5, alpha=0.9)
    # tiny HBM -> pressure.  The instance adopts its executor's block
    # allocator, so the pool itself is cut to 24 blocks (the reference's
    # example cuts only the instance's figure, which its paged executor
    # then replaces with a pool of 288 blocks: it never degrades)
    instances = build_instances(
        cost, sliders, lambda: TorchExecutor(cfg, params, n_slots=8,
                                             max_seq=512, hbm_blocks=24,
                                             device=args.device),
        hbm_blocks=24, block_size=16)
    n, prompt = 8, 48
    # the TPOT limit in the estimator's own time: ten P-heavy iterations
    # (a chunk beside the burst's decodes), so that a flowed request's
    # TPOT approaches it, and flows back, whatever the card's derates
    slo = SLO(ttft=10.0, tpot=10 * cost.iteration_time(
        [(sliders.s_p, 0)], [prompt] * n))
    policy = TaiChiPolicy(instances, cost, slo.ttft, slo.tpot, sliders)
    cluster = Cluster(policy, cost)

    # simultaneous burst so decodes overlap and D-heavy HBM crosses the
    # watermark while outputs are mid-flight
    reqs = [Request(prompt_len=prompt, max_new_tokens=32,
                    hidden_output_len=32, arrival=0.0)
            for i in range(n)]
    cluster.run(reqs)

    print(f"TPOT limit: {slo.tpot * 1e3:.1f} ms  "
          f"degrade flows: {cluster.degrade_count}  "
          f"backflows: {cluster.backflow_count}  "
          f"total transfers: {cluster.transfer_count}")
    for r in reqs:
        print(f"  req {r.rid}: migrations={r.n_migrations} "
              f"out={len(r.output_tokens)}/{r.target_output_len} "
              f"tpot={(r.tpot() or 0)*1e3:.1f}ms")
    assert cluster.degrade_count > 0, \
        "expected watermark-triggered degradation"
    print("\nflowing decode demonstrated with real token generation.")
    return cluster


if __name__ == "__main__":
    main()
