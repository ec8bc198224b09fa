"""The port's offline slider search (paper §3.1) against the reference's
on the case of ``tests/test_autotune.py``, with the estimator on the
reference's hardware numbers (``test_torch_cluster.SAME_HW``): the same
sliders, goodput, attainment and trials, in order."""
from repro.core.autotune import search_sliders as jax_search
from repro.core.latency import SLO as JaxSLO
from repro.sim.workload import SHAREGPT as JAX_SHAREGPT
from repro_torch.core import hw
from repro_torch.core.autotune import search_sliders
from repro_torch.core.latency import SLO
from repro_torch.sim import simulator as sim
from repro_torch.sim.workload import SHAREGPT

from test_torch_cluster import SAME_HW
from test_torch_helpers import cap_threads

cap_threads()

CASE = dict(qps_grid=[60, 100], n_requests=60, ratios=[(2, 2)],
            sp_grid=[1024], sd_grid=[128, 256, 1024])


def _sliders(s):
    return (s.n_p, s.n_d, s.s_p, s.s_d, s.watermark, s.alpha)


def test_search_matches_the_reference(monkeypatch):
    monkeypatch.setattr(sim, "InstanceSpec",
                        lambda tp: hw.InstanceSpec(hw=SAME_HW, tp=tp))
    ref = jax_search("qwen2.5-14b", JaxSLO(ttft=1.5, tpot=0.030),
                     JAX_SHAREGPT, **CASE)
    got = search_sliders("qwen2.5-14b", SLO(ttft=1.5, tpot=0.030), SHAREGPT,
                         **CASE)
    assert _sliders(got.sliders) == _sliders(ref.sliders)
    assert got.goodput == ref.goodput
    assert got.attainment_at_goodput == ref.attainment_at_goodput
    assert [(_sliders(s), g) for s, g in got.trials] == \
        [(_sliders(s), g) for s, g in ref.trials]
    # the reference test's own checks, on the port's result
    assert got.sliders.n_p + got.sliders.n_d == 4
    assert got.sliders.s_d <= got.sliders.s_p
    assert len(got.trials) == 3
    assert all(got.goodput >= g for _, g in got.trials)
