"""The scheduling shell of the port against the reference's.

(i) With ``SimExecutor`` on both sides and the SAME numbers in both
``HardwareSpec``s, the framework-free core must make bit-identical
decisions: the two are the same code, so every float is computed by the
same operations in the same order and equality is exact.
(ii) The slice as a whole: a P-heavy and a D-heavy instance under
``TaiChiPolicy`` with real executors on both sides generate identical
tokens for every request, with flowing-decode migrations on both."""
import dataclasses

import pytest

from repro.configs import reduced_config as jax_reduced
from repro.core import hw as jax_hw
from repro.core.cluster import Cluster as JaxCluster
from repro.core.estimator import CostModel as JaxCostModel
from repro.core.latency import SLO as JaxSLO
from repro.core.policies import Sliders as JaxSliders
from repro.core.policies import TaiChiPolicy as JaxTaiChi
from repro.core.policies import build_instances as jax_build_instances
from repro.engine.engine import JaxExecutor
from repro.sim import simulator as jax_sim
from repro.sim.workload import WORKLOADS as JAX_WORKLOADS
from repro.sim.workload import LengthDist as JaxLengthDist
from repro.sim.workload import WorkloadSpec as JaxWorkloadSpec
from repro_torch.configs import reduced_config
from repro_torch.core import hw
from repro_torch.core.cluster import Cluster
from repro_torch.core.estimator import CostModel
from repro_torch.core.latency import SLO
from repro_torch.core.policies import Sliders, TaiChiPolicy, build_instances
from repro_torch.engine.engine import TorchExecutor
from repro_torch.sim import simulator as sim
from repro_torch.sim.workload import WORKLOADS, LengthDist, WorkloadSpec

from test_torch_helpers import (both_params, cap_threads,  # noqa: F401
                                copying_reference)

cap_threads()

# the reference's host arrays may alias its in-flight inputs on the CPU
pytestmark = pytest.mark.usefixtures("copying_reference")

#: the port's dataclass filled with the reference's numbers
SAME_HW = hw.HardwareSpec(**dataclasses.asdict(jax_hw.V5E))


def _fields(reqs):
    return [(r.rid, r.prompt_len, r.prefill_instance, r.decode_instance,
             r.first_token_time, r.finish_time, r.output_len, r.n_migrations, r.state.value)
            for r in reqs]


@pytest.mark.parametrize("policy",
                         ["taichi", "aggregation", "disaggregation"])
def test_sim_schedules_bit_identical(policy, monkeypatch):
    # build_cluster constructs InstanceSpec(tp=...) with the module's
    # default hardware: give the port's the reference's numbers
    monkeypatch.setattr(
        sim, "InstanceSpec",
        lambda tp: hw.InstanceSpec(hw=SAME_HW, tp=tp))
    kw = dict(model="qwen2.5-14b", tp=4, policy=policy)
    qps, n, seed = 30.0, 120, 3
    ref_reqs = JAX_WORKLOADS["sharegpt"].sample_requests(n, qps, seed=seed)
    got_reqs = WORKLOADS["sharegpt"].sample_requests(n, qps, seed=seed)
    assert [(r.prompt_len, r.arrival) for r in ref_reqs] == \
        [(r.prompt_len, r.arrival) for r in got_reqs]
    ref_c = jax_sim.build_cluster(
        jax_sim.ServingConfig(sliders=JaxSliders(2, 2, 1024, 256), **kw),
        JaxSLO(1.5, 0.03), seed=seed)
    got_c = sim.build_cluster(
        sim.ServingConfig(sliders=Sliders(2, 2, 1024, 256), **kw),
        SLO(1.5, 0.03), seed=seed)
    ref_c.run(ref_reqs)
    got_c.run(got_reqs)
    # request ids come from a per-package counter: compare the rest
    assert [f[1:] for f in _fields(got_reqs)] == \
        [f[1:] for f in _fields(ref_reqs)]
    assert got_c.transfer_count == ref_c.transfer_count
    assert got_c.backflow_count == ref_c.backflow_count
    ref_st = ref_c.stats(ref_reqs, JaxSLO(1.5, 0.03), qps)
    got_st = got_c.stats(got_reqs, SLO(1.5, 0.03), qps)
    assert got_st.summary() == ref_st.summary()


def test_run_sim_and_estimator_agree_with_reference_numbers(monkeypatch):
    monkeypatch.setattr(
        sim, "InstanceSpec",
        lambda tp: hw.InstanceSpec(hw=SAME_HW, tp=tp))
    sc = dict(model="qwen2.5-3b", tp=1, policy="taichi")
    ref = jax_sim.run_sim(jax_sim.ServingConfig(**sc), JaxSLO(1.5, 0.03),
                          JAX_WORKLOADS["sharegpt"], 20.0, 60, seed=1)
    got = sim.run_sim(sim.ServingConfig(**sc), SLO(1.5, 0.03),
                      WORKLOADS["sharegpt"], 20.0, 60, seed=1)
    assert got.summary() == ref.summary()
    from repro.configs import get_config as jax_get
    from repro_torch.configs import get_config
    a = JaxCostModel(jax_get("qwen2.5-3b"), jax_hw.InstanceSpec(tp=2))
    b = CostModel(get_config("qwen2.5-3b"),
                  hw.InstanceSpec(hw=SAME_HW, tp=2))
    assert a.itemsize == b.itemsize == 2
    assert a.iteration_time([(512, 128)], [900, 40]) == \
        b.iteration_time([(512, 128)], [900, 40])
    assert a.transfer_time(3000) == b.transfer_time(3000)


def test_h100_spec_is_the_cards_own():
    spec = hw.H100
    assert (spec.peak_flops, spec.hbm_bw) == (989e12, 3.35e12)
    assert spec.hbm_bytes == 80 * 10 ** 9 and spec.ici_bw == 450e9
    assert not hasattr(hw, "V5E")
    ref = jax_hw.V5E
    # the measured derates are the port's, not copies of the reference's
    assert (spec.prefill_mfu, spec.decode_membw_eff,
            spec.iteration_overhead_s) != (
        ref.prefill_mfu, ref.decode_membw_eff, ref.iteration_overhead_s)
    assert hw.InstanceSpec(tp=2).flops == 2 * 989e12


#: qwen2.5-3b's mean decode-only iteration on the card, in seconds: the
#: median of three ``chip_smoke.py --serve`` runs of the ``serve`` phase
#: (graph replays and first-use captures; H100 80GB HBM3 at 700 W),
#: which ``PERF.md`` records with the derates they gave
CARD_DECODE_ONLY_S = 11.57e-3


def test_h100_derates_model_the_cards_decode_iteration():
    """The derates in ``core/hw.py`` model a decode-only iteration of
    ``serve``'s mean batch (11 rows at 1,080 tokens of context) within
    25 % of the card's measured mean."""
    from repro_torch.configs import get_config
    cost = CostModel(get_config("qwen2.5-3b"), hw.InstanceSpec(tp=1))
    t = cost.iteration_time((), [1080] * 11)
    assert abs(t - CARD_DECODE_ONLY_S) <= 0.25 * CARD_DECODE_ONLY_S, t


def _serve(torch_side: bool, cfg, params):
    """quickstart's stack at a small size: 1 P-heavy + 1 D-heavy."""
    if torch_side:
        cost = CostModel(cfg, hw.InstanceSpec(hw=SAME_HW, tp=1))
        sl = Sliders(n_p=1, n_d=1, s_p=32, s_d=16)
        instances = build_instances(
            cost, sl, lambda: TorchExecutor(cfg, params, n_slots=8,
                                            max_seq=256, device="cpu"),
            hbm_blocks=256, block_size=16)
        policy = TaiChiPolicy(instances, cost, 5.0, 0.5, sl)
        cluster, spec = Cluster(policy, cost), WorkloadSpec(
            "demo", LengthDist(mu=3.2, sigma=0.4, lo=8, hi=96),
            LengthDist(mu=2.0, sigma=0.5, lo=2, hi=16), tokenized=True,
            vocab_size=cfg.vocab_size)
    else:
        cost = JaxCostModel(cfg, jax_hw.InstanceSpec(tp=1))
        sl = JaxSliders(n_p=1, n_d=1, s_p=32, s_d=16)
        instances = jax_build_instances(
            cost, sl, lambda: JaxExecutor(cfg, params, n_slots=8,
                                          max_seq=256),
            hbm_blocks=256, block_size=16)
        policy = JaxTaiChi(instances, cost, 5.0, 0.5, sl)
        cluster, spec = JaxCluster(policy, cost), JaxWorkloadSpec(
            "demo", JaxLengthDist(mu=3.2, sigma=0.4, lo=8, hi=96),
            JaxLengthDist(mu=2.0, sigma=0.5, lo=2, hi=16), tokenized=True,
            vocab_size=cfg.vocab_size)
    reqs = spec.sample_requests(12, qps=4.0, seed=0)
    cluster.run(reqs)
    return cluster, reqs, instances


def test_two_instance_taichi_cluster_token_exact():
    cj, ct = jax_reduced("smollm-135m"), reduced_config("smollm-135m")
    pj, pt = both_params(cj, ct, seed=33)
    ref_c, ref_reqs, _ = _serve(False, cj, pj)
    got_c, got_reqs, instances = _serve(True, ct, pt)
    assert len(got_reqs) == 12
    for a, b in zip(got_reqs, ref_reqs):
        assert a.prompt_tokens == b.prompt_tokens
        assert a.done() and b.done()
        assert len(a.output_tokens) == a.target_output_len
        assert a.output_tokens == b.output_tokens
        assert (a.prefill_instance, a.decode_instance) == \
            (b.prefill_instance, b.decode_instance)
    assert got_c.transfer_count > 0 and ref_c.transfer_count > 0
    assert got_c.transfer_count == ref_c.transfer_count
    for inst in instances:
        ex = inst.executor
        ex.kv.check_invariants()
        assert 0 < ex.host_readbacks <= inst.iterations


def test_payload_checksum_hashes_tensors_numpy_cannot_hold():
    """Migration payloads are dicts of tensors; bfloat16 (and a tensor on
    the card) has no numpy view, so the checksum hashes raw bytes."""
    import torch

    from repro_torch.serving.faults import payload_checksum
    k = torch.arange(64, dtype=torch.float32).reshape(2, 4, 8).bfloat16()
    a = {"paged_blocks": {"k": k, "v": k + 1}, "pos": 3, "kv_format": "fp"}
    b = {"paged_blocks": {"k": k.clone(), "v": k + 1}, "pos": 3,
         "kv_format": "fp"}
    assert payload_checksum(a) == payload_checksum(b)
    b["paged_blocks"]["k"][1, 2, 3] += 1
    assert payload_checksum(a) != payload_checksum(b)
    # same bytes, other shape or type: another hash
    c = {"paged_blocks": {"k": k.reshape(4, 2, 8), "v": k + 1}, "pos": 3,
         "kv_format": "fp"}
    assert payload_checksum(a) != payload_checksum(c)


def test_recovery_tree_map_concatenates_block_payloads():
    import torch

    from repro_torch.serving.recovery import _tree_map
    a = {"k": torch.zeros(2, 16, 1, 4), "v": torch.ones(2, 16, 1, 4)}
    b = {"k": torch.ones(2, 16, 1, 4), "v": torch.zeros(2, 16, 1, 4)}
    out = _tree_map(lambda *xs: torch.cat(xs, dim=1), a, b)
    assert out["k"].shape == (2, 32, 1, 4)
    assert out["k"][:, 16:].all() and not out["k"][:, :16].any()
    nested = _tree_map(lambda x: x + 1, ({"a": torch.zeros(1)}, [2.0]))
    assert nested[0]["a"].item() == 1 and nested[1] == [3.0]
