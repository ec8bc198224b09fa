"""The port's examples (``repro_torch.examples``) on the CPU at small
sizes, each held to its own end condition: quickstart's requests all
finish within the SLO, the latency-shifting demo degrades under memory
pressure, the goodput sweep equals the reference's on the reference's
hardware numbers, and the trainer's loss falls and its checkpoint
restores bit for bit."""
import os
import subprocess
import sys

import pytest
import torch

from repro.core.latency import SLO as JaxSLO
from repro.core.policies import Sliders as JaxSliders
from repro.sim import simulator as jax_sim
from repro.sim.workload import SHAREGPT as JAX_SHAREGPT
from repro_torch.core import hw
from repro_torch.examples import (latency_shifting_demo, quickstart,
                                  serve_goodput, train_smollm)
from repro_torch.sim import simulator as sim

from test_torch_cluster import SAME_HW
from test_torch_helpers import cap_threads

cap_threads()

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def test_quickstart_serves_every_request():
    st = quickstart.main(["--device", "cpu"])
    assert len(st.reqs) == 16
    assert st.slo_attainment == 1.0
    assert all(len(r.output_tokens) == r.target_output_len for r in st.reqs)


def test_latency_shifting_demo_degrades_and_flows_back():
    cluster = latency_shifting_demo.main(["--device", "cpu"])
    assert cluster.degrade_count > 0 and cluster.backflow_count > 0
    assert cluster.transfer_count >= cluster.degrade_count


def test_serve_goodput_equals_the_reference_on_its_hardware(monkeypatch):
    monkeypatch.setattr(sim, "InstanceSpec",
                        lambda tp: hw.InstanceSpec(hw=SAME_HW, tp=tp))
    got = serve_goodput.main(["--grid", "60,100", "--n", "40"])
    settings = {"PD aggregation": ("aggregation", (2, 2, 1024, 1024)),
                "PD disaggregation": ("disaggregation", (2, 2, 0, 0)),
                "TaiChi (hybrid)": ("taichi", (2, 2, 1024, 256))}
    assert set(got) == set(settings)
    for name, (policy, sl) in settings.items():
        ref, _ = jax_sim.goodput_sweep(
            jax_sim.ServingConfig(policy=policy, sliders=JaxSliders(*sl)),
            JaxSLO(ttft=1.5, tpot=0.030), JAX_SHAREGPT, [60.0, 100.0],
            n_requests=40)
        assert got[name] == ref, name
    assert got["TaiChi (hybrid)"] > 0


def test_train_smollm_loss_falls_and_checkpoint_restores(tmp_path):
    path = os.path.join(tmp_path, "ck.npz")
    history, equal = train_smollm.main(
        ["--device", "cpu", "--steps", "12", "--batch", "4", "--seq", "32",
         "--ckpt", path])
    assert history[-1]["loss"] < history[0]["loss"] * 0.95
    assert equal and os.path.exists(path + ".meta.json")


def test_examples_run_as_modules():
    """``python -m`` runs an example; without a card, one asked for the
    card exits saying so."""
    env = {**os.environ, "PYTHONPATH": SRC}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.examples.serve_goodput",
         "--grid", "60", "--n", "20"], env=env, capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.count("goodput=") == 3
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            quickstart.main([])
