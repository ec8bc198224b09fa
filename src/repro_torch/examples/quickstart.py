"""Quickstart: serve a small model with batched requests through the
full TaiChi stack (proxy -> P-heavy/D-heavy instances -> real PyTorch
engine).  Tokens are really computed; time is the estimator's for the
H100, so scheduling behaves as it would there.

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
import argparse

from repro_torch.configs import reduced_config
from repro_torch.core.cluster import Cluster
from repro_torch.core.estimator import CostModel
from repro_torch.core.hw import InstanceSpec
from repro_torch.core.latency import SLO
from repro_torch.core.policies import Sliders, TaiChiPolicy, build_instances
from repro_torch.engine.engine import TorchExecutor
from repro_torch.examples._device import add_device_arg, check_device
from repro_torch.models import transformer as tf
from repro_torch.sim.workload import LengthDist, WorkloadSpec


def main(argv=None):
    """Serve 16 requests; returns the run's ``RunStats``."""
    ap = argparse.ArgumentParser()
    add_device_arg(ap)
    args = ap.parse_args(argv)
    check_device(args.device)
    cfg = reduced_config("smollm-135m")
    print(f"model: {cfg.name} ({cfg.param_count()/1e6:.1f}M params)")
    params = tf.init_params(0, cfg, device=args.device)
    cost = CostModel(cfg, InstanceSpec(tp=1))

    # TaiChi sliders: 1 P-heavy (chunk 32) + 1 D-heavy (chunk 16)
    sliders = Sliders(n_p=1, n_d=1, s_p=32, s_d=16)
    instances = build_instances(
        cost, sliders, lambda: TorchExecutor(cfg, params, n_slots=8,
                                             max_seq=512,
                                             device=args.device),
        hbm_blocks=256, block_size=16)
    slo = SLO(ttft=5.0, tpot=0.5)
    policy = TaiChiPolicy(instances, cost, slo.ttft, slo.tpot, sliders)
    cluster = Cluster(policy, cost)

    wl = WorkloadSpec("demo",
                      LengthDist(mu=3.2, sigma=0.4, lo=8, hi=96),
                      LengthDist(mu=2.0, sigma=0.5, lo=2, hi=16))
    reqs = wl.sample_requests(16, qps=4.0, seed=0)
    print(f"serving {len(reqs)} requests...")
    cluster.run(reqs)

    for r in reqs[:5]:
        print(f"  req {r.rid}: prompt={r.prompt_len:3d} -> "
              f"{len(r.output_tokens)} tokens "
              f"(ttft={r.ttft()*1e3:6.1f}ms tpot="
              f"{(r.tpot() or 0)*1e3:5.1f}ms "
              f"prefill@inst{r.prefill_instance} "
              f"decode@inst{r.decode_instance}) "
              f"tokens={r.output_tokens[:6]}...")
    st = cluster.stats(reqs, slo, 4.0)
    print(f"attainment={st.slo_attainment:.2f} "
          f"p90_ttft={st.p90_ttft*1e3:.0f}ms "
          f"p90_tpot={st.p90_tpot*1e3:.1f}ms "
          f"transfers={cluster.transfer_count}")
    return st


if __name__ == "__main__":
    main()
