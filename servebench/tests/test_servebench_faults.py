"""A run of a tiny cell on the CPU, through every step of ``run.py`` but
its look for a card: sound, it is correct; with the timed path broken
underneath (each fault a serving cell can have), ``correct`` comes out
false.  And the comparison's control (the reference in float8) fails the
comparison where the program passes."""
from __future__ import annotations

import os
import sys

import pytest
import torch

from conftest import BENCH, tiny_cell

sys.path.insert(0, os.path.join(BENCH, "tools"))

import run  # noqa: E402

SECONDS = 2.0


def serve(seed=11):
    torch.set_num_threads(2)
    return run.run(tiny_cell(), seed, SECONDS, False, device="cpu")


def test_a_sound_run_is_correct():
    result, compared = serve()
    assert result["correct"], compared
    assert result["attempted"] == round(
        tiny_cell().traffic["arrivals"]["rate_per_s"] * SECONDS)
    assert compared["widest_logit_gap"]["tokens"] >= 40
    assert set(result["metrics"]) == {"ttft_p90_s", "tpot_p90_s",
                                      "setup_s"}


def state_unchanged(monkeypatch):
    """Every step leaves the KV pool as it found it."""
    from repro_torch.models import attention
    monkeypatch.setattr(attention, "paged_write",
                        lambda ck, cv, *a, **kw: (ck, cv))


def half_the_batch(monkeypatch):
    """Each step's second half of rows is left out: of the batch axis, or
    of the token axis where the batch axis is 1 (the token-major mixed
    step lays its rows out as [1, N])."""
    from repro_torch.models import transformer as tf
    forward = tf.forward

    def half(*a, **kw):
        out = forward(*a, **kw)
        B, T = out[0].shape[:2]
        if B > 1:
            out[0][B // 2:] = 0
        elif T > 1:
            out[0][:, T // 2:] = 0
        return out

    monkeypatch.setattr(tf, "forward", half)


def exchange_dropped(monkeypatch):
    """Flowing decode moves a request without its KV."""
    from repro_torch.engine.engine import TorchExecutor
    extract = TorchExecutor.extract_state

    def empty(self, req):
        state = extract(self, req)
        for t in state.get("paged_blocks", {}).values():
            t.zero_()
        return state

    monkeypatch.setattr(TorchExecutor, "extract_state", empty)


def token_altered(monkeypatch):
    """A token is changed where it is sampled."""
    from repro_torch.engine.engine import TorchExecutor
    sample = TorchExecutor._sample_on_device
    monkeypatch.setattr(
        TorchExecutor, "_sample_on_device",
        lambda self, lg: (sample(self, lg) + 1) % lg.shape[-1])


@pytest.mark.parametrize("fault", [state_unchanged, half_the_batch,
                                   exchange_dropped, token_altered])
def test_a_broken_timed_path_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    result, compared = serve()
    assert not result["correct"], compared


def test_the_control_fails_where_the_program_passes():
    """At the tiny size in bf16: the float8 reference's widest gap lies
    above every seed's program gap."""
    import readings
    cell = tiny_cell()
    cell.config["torch_dtype"] = "bfloat16"
    torch.set_num_threads(2)
    rows = readings.readings("tiny", SECONDS, [21, 22, 23], [21, 22, 23],
                             device="cpu", cell=cell, emit=lambda **kw: None)
    assert min(r["control_gap"] for r in rows) > max(
        r["program_gap"] for r in rows), rows
    assert all(r["migrated"] for r in rows), rows
