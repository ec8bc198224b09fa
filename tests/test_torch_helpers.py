"""Helpers shared by the port's parity tests: the same numpy-made
weights on both sides."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.models import transformer as jax_tf
from repro_torch.convert import params_from_jax


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
