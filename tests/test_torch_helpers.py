"""Helpers shared by the port's parity tests: the same numpy-made
weights on both sides, and the cap on each test process's threads."""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as jax_tf
from repro_torch.convert import params_from_jax

# threads a test process's torch may use
TEST_THREADS = 1


def cap_threads(n=TEST_THREADS):
    """Hold this process's torch to ``n`` intra-op and ``n`` inter-op
    threads, and the processes it starts to ``n`` OpenMP threads.

    Every other ``tests/test_torch_*.py`` calls it at import, so that a
    run of any subset of them is capped.  Each of pytest's workers
    (``-n 6``) imports every test file while it collects, so the first
    call caps the worker before any test runs, whichever file it then
    draws, and the reference's tests in that worker run under the same
    cap.  Left at its default, each worker's torch takes a thread a core,
    and six workers' threads fighting over eight cores ran the slowest
    tests 14 to 25 times longer than they take alone.
    The inter-op pool can be sized only before its first parallel work,
    and only once; a later call with the same ``n`` leaves it be."""
    os.environ["OMP_NUM_THREADS"] = str(n)
    if torch.get_num_threads() != n:
        torch.set_num_threads(n)
    if torch.get_num_interop_threads() != n:
        torch.set_num_interop_threads(n)


def numpy_params(cfg_jax, seed=0):
    """The reference's parameter tree for ``cfg_jax`` with every leaf
    drawn with numpy from ``seed`` (norm gains and biases too, which the
    reference initialises to zero and would leave untested)."""
    shapes = jax.eval_shape(
        lambda: jax_tf.init_params(jax.random.PRNGKey(0), cfg_jax))
    rng = np.random.default_rng(seed)

    def draw(s):
        if len(s.shape) >= 2 and s.shape[-2] > 1 and s.shape[-1] > 1:
            fan_in = s.shape[-2]
            scale = 1.0 if s.shape[-2] == cfg_jax.vocab_size \
                else fan_in ** -0.5
        else:
            scale = 0.05          # norm gains (as 1 + w) and biases
        return (rng.standard_normal(s.shape) * scale).astype(np.float32)

    return jax.tree.map(draw, shapes)


class CopyingJnp:
    """``jax.numpy`` whose ``asarray`` copies its input.  On the CPU
    backend the reference's ``JaxExecutor`` hands ``jnp.asarray`` the
    numpy arrays ``self.positions`` and ``self.last_token``, which may
    alias them, and updates them in place while the step that reads them
    is still in flight (the dense decode advances ``positions`` right
    after its dispatch).  Under load its greedy streams then vary from
    run to run (a zamba2 migration round trip gave two distinct streams
    in 12 runs beside six busy processes; the port's gave one).  With
    copies the reference is its algorithm alone."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def asarray(a, *args, **kw):
        return jnp.array(np.array(a), *args, **kw)


@pytest.fixture
def copying_reference(monkeypatch):
    """The reference's engine with copying ``jnp.asarray`` (see
    :class:`CopyingJnp`)."""
    import repro.engine.engine as jax_engine
    monkeypatch.setattr(jax_engine, "jnp", CopyingJnp())


def scaled_err(got, ref):
    """Largest gap between two logit arrays over the larger of 1 and the
    reference's largest magnitude (the forward tests hold it to 2e-3)."""
    ref = np.asarray(ref, np.float32)
    return float(np.abs(np.asarray(got) - ref).max()
                 / max(float(np.abs(ref).max()), 1.0))


def both_params(cfg_jax, cfg_torch, seed=0):
    tree = numpy_params(cfg_jax, seed)
    return (jax.tree.map(jnp.asarray, tree),
            params_from_jax(tree, cfg_torch, device="cpu"))


def test_numpy_params_are_deterministic_and_converted_leaf_for_leaf():
    import torch

    from repro.configs import reduced_config as jax_reduced
    from repro_torch.configs import reduced_config

    cj, ct = jax_reduced("qwen2.5-3b"), reduced_config("qwen2.5-3b")
    a, b = numpy_params(cj, 5), numpy_params(cj, 5)
    assert all(np.array_equal(x, y) for x, y in
               zip(jax.tree.leaves(a), jax.tree.leaves(b)))
    pj, pt = both_params(cj, ct, 5)
    stacked = pj["segments"][0][0]
    assert len(pt["layers"]) == cj.num_layers
    for li, layer in enumerate(pt["layers"]):
        np.testing.assert_array_equal(layer["attn"]["wq"].numpy(),
                                      np.asarray(stacked["attn"]["wq"][li]))
        np.testing.assert_array_equal(layer["attn"]["bk"].numpy(),
                                      np.asarray(stacked["attn"]["bk"][li]))
        np.testing.assert_array_equal(layer["mlp"]["w_down"].numpy(),
                                      np.asarray(stacked["mlp"]["w_down"][li]))
        np.testing.assert_array_equal(layer["ln2"].numpy(),
                                      np.asarray(stacked["ln2"][li]))
    assert pt["embed"].dtype == torch.float32
    np.testing.assert_array_equal(pt["lm_head"].numpy(),
                                  np.asarray(pj["lm_head"]))


_CAP_CHILD = """
import subprocess, sys, torch
from test_torch_helpers import cap_threads
cap_threads(%(n)d)
cap_threads(%(n)d)                # a second call is a no-op, not an error
child = subprocess.run(
    [sys.executable, "-c", "import torch; print(torch.get_num_threads())"],
    capture_output=True, text=True, check=True).stdout
print(torch.get_num_threads(), torch.get_num_interop_threads(), int(child))
"""


@pytest.mark.parametrize("n", [1, 2])
def test_cap_threads_holds_here_and_in_a_child(n):
    """In a fresh process, the cap at ``n`` sizes both of torch's pools,
    holds through a second call, and reaches a torch process that it
    starts."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "OMP_NUM_THREADS"}
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(root, "src"), os.path.join(root, "tests")])
    out = subprocess.run(
        [sys.executable, "-c", _CAP_CHILD % dict(n=n)], env=env,
        capture_output=True, text=True, check=True, timeout=120).stdout
    assert out.split() == [str(n)] * 3
