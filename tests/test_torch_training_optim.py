"""The port's optimizer and training loop (``training/optimizer.py``,
``training/train.{train_loop,synthetic_lm_batches}``) against the
reference's, on the CPU: the AdamW step against the reference's over
three steps on the same gradients, clipping, the schedule, and the
reference's own loop tests, ported."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.training import optimizer as jax_opt
from repro_torch.configs import reduced_config
from repro_torch.training.optimizer import (AdamWConfig, adamw_update,
                                            global_norm, init_opt_state,
                                            schedule)
from repro_torch.training.train import synthetic_lm_batches, train_loop

from test_torch_training import _t


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------

def _opt_tree(dtype, seed):
    rng = np.random.default_rng(seed)
    shapes = {"w": (16, 24), "b": (24,), "layers": [{"u": (8, 8, 3)},
                                                    {"u": (8, 8, 3)}]}
    params = jax.tree.map(
        lambda s: rng.standard_normal(s).astype(np.float32), shapes,
        is_leaf=lambda s: isinstance(s, tuple))
    grads = [jax.tree.map(lambda a: (rng.standard_normal(a.shape) * 0.3)
                          .astype(np.float32), params) for _ in range(3)]
    pj = jax.tree.map(lambda a: jnp.asarray(a, dtype), params)
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    pt = jax.tree.map(lambda a: _t(a).to(tdt), params)
    return pj, pt, grads


def _bf16_bits(a):
    return np.asarray(a).view(np.int16).astype(np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_reference_over_three_steps(dtype):
    """Three steps (warm-up, clipping active on the first) on the same
    gradients: float32 parameters within 1e-6 relative, bf16 parameters
    bit-equal but for one ulp on at most 1 % of the elements; moments
    float32 within 1e-6 relative (1e-8 absolute near zero, values to
    ~0.05); the step count and the norms equal."""
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    cfg = AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=5, clip_norm=5.0)
    jcfg = jax_opt.AdamWConfig(**dataclasses.asdict(cfg))
    pj, pt, grads = _opt_tree(jdt, 101)
    sj, st = jax_opt.init_opt_state(pj), init_opt_state(pt)
    for g in grads:
        pj, sj, nj = jax_opt.adamw_update(
            jcfg, pj, jax.tree.map(jnp.asarray, g), sj)
        out, st2, nt = adamw_update(cfg, pt, jax.tree.map(_t, g), st)
        assert out is pt and st2 is st           # in place
        np.testing.assert_allclose(float(nt), float(nj), rtol=1e-6)
    assert int(st.step) == int(sj.step) == 3
    for a, b in zip(jax.tree.leaves(pt), jax.tree.leaves(pj)):
        if dtype == "float32":
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-7)
        else:
            assert a.dtype == torch.bfloat16
            ulps = np.abs(_bf16_bits(a.view(torch.int16).numpy())
                          - _bf16_bits(np.asarray(b)))
            assert ulps.max() <= 1
            assert (ulps > 0).mean() <= 0.01
    for tree_t, tree_j in ((st.m, sj.m), (st.v, sj.v)):
        for a, b in zip(jax.tree.leaves(tree_t), jax.tree.leaves(tree_j)):
            assert a.dtype == torch.float32
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-8)


def test_adamw_first_step_is_signed_lr():
    """After one step with beta-corrected moments, |delta| ~ lr for a
    constant gradient (AdamW property)."""
    cfg = AdamWConfig(lr=1e-2, weight_decay=0.0, warmup_steps=0,
                      clip_norm=1e9)
    params = {"w": torch.ones((4, 4))}
    before = params["w"].clone()
    state = init_opt_state(params)
    _, state, gnorm = adamw_update(cfg, params, {"w": torch.full((4, 4),
                                                                 0.5)},
                                   state)
    np.testing.assert_allclose((before - params["w"]).numpy(), 1e-2,
                               rtol=1e-4)
    assert float(gnorm) == pytest.approx(0.5 * 4, rel=1e-5)


def test_grad_clipping():
    cfg = AdamWConfig(lr=1e-3, clip_norm=1.0, warmup_steps=0)
    params = {"w": torch.zeros((8,))}
    state = init_opt_state(params)
    _, state, gnorm = adamw_update(cfg, params,
                                   {"w": torch.full((8,), 100.0)}, state)
    # clipped moments: m = (1-b1) * g * scale, scale = 1/gnorm
    scale = 1.0 / float(gnorm)
    np.testing.assert_allclose(state.m["w"].numpy(), 0.1 * 100.0 * scale,
                               rtol=1e-4)


def test_schedule_warmup_and_decay():
    cfg = AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                      min_lr_ratio=0.1)
    assert float(schedule(cfg, torch.tensor(5.0))) == pytest.approx(0.5)
    assert float(schedule(cfg, torch.tensor(10.0))) == pytest.approx(1.0)
    end = float(schedule(cfg, torch.tensor(100.0)))
    assert end == pytest.approx(0.1, rel=1e-3)
    jcfg = jax_opt.AdamWConfig(**dataclasses.asdict(cfg))
    for s in (0.0, 3.0, 10.0, 37.0, 99.0, 150.0):
        got = schedule(cfg, torch.tensor(s))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got),
                                   float(jax_opt.schedule(jcfg,
                                                          jnp.float32(s))),
                                   rtol=1e-6)


def test_global_norm():
    t = {"a": torch.tensor([3.0]), "b": [torch.tensor([4.0])]}
    assert float(global_norm(t)) == pytest.approx(5.0)
    assert float(global_norm({"a": torch.tensor([3.0]).bfloat16()})) == 3.0


# ---------------------------------------------------------------------------
# the loop
# ---------------------------------------------------------------------------

def test_loss_decreases_smollm():
    cfg = reduced_config("smollm-135m")
    _, hist = train_loop(cfg, steps=25, batch=4, seq=64, log_every=5,
                         device="cpu")
    assert hist[-1]["loss"] < hist[0]["loss"] * 0.95
    assert all(np.isfinite(h["grad_norm"]) for h in hist)


def test_synthetic_batches_are_seeded_bigrams():
    cfg = reduced_config("smollm-135m")
    a = next(synthetic_lm_batches(cfg, 3, 40, seed=5, device="cpu"))
    b = next(synthetic_lm_batches(cfg, 3, 40, seed=5, device="cpu"))
    assert torch.equal(a["tokens"], b["tokens"])
    assert a["labels"] is a["tokens"] and a["tokens"].shape == (3, 40)
    t, V = a["tokens"], cfg.vocab_size
    follows = (t[:, 1:] == (t[:, :-1] * 7 + 3) % V) \
        | (t[:, 1:] == (t[:, :-1] * 31 + 17) % V)
    assert follows.all()
    assert (t[:, 1:] == (t[:, :-1] * 7 + 3) % V).float().mean() > 0.8
