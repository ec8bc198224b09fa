"""The port's training stack (``models/common.softmax_xent``,
``transformer.train_loss``, ``training/{optimizer,train,checkpoint}.py``,
``launch/train.py``) against the reference's, on the CPU: the loss and
every gradient leaf against ``jax.value_and_grad`` on the same
numpy-made weights, the optimizer step against the reference's over
three steps, and the reference's own training tests, ported."""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jax_reduced
from repro.models import common as jax_common
from repro.models import mamba2 as jax_m2
from repro.models import transformer as jax_tf
from repro.training import optimizer as jax_opt
from repro_torch.configs import reduced_config
from repro_torch.convert import params_from_jax, params_to_numpy
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.models import common
from repro_torch.models import transformer as tf
from repro_torch.training.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.training.optimizer import (AdamWConfig, adamw_update,
                                            global_norm, init_opt_state,
                                            schedule, tree_leaves)
from repro_torch.training.train import (loss_and_grads, make_eval_step,
                                        make_train_step,
                                        synthetic_lm_batches, train_loop)

from test_torch_helpers import numpy_params

#: a gradient leaf: max |port - reference| <= GRAD_RTOL * max |reference|
#: + GRAD_ATOL
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-7


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# the loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True], ids=["no_mask", "mask"])
def test_softmax_xent_matches_reference(masked):
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((3, 7, 50)) * 4).astype(np.float32)
    labels = rng.integers(0, 50, size=(3, 7)).astype(np.int32)
    mask = (rng.random((3, 7)) < 0.6).astype(np.float32) if masked else None
    ref = jax_common.softmax_xent(
        jnp.asarray(logits), jnp.asarray(labels),
        None if mask is None else jnp.asarray(mask))
    got = common.softmax_xent(_t(logits), _t(labels),
                              None if mask is None else _t(mask))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)
    # bf16 logits are scored in float32; an all-zero mask divides by 1
    bf = torch.from_numpy(logits).bfloat16()
    assert common.softmax_xent(bf, _t(labels)).dtype == torch.float32
    assert float(common.softmax_xent(_t(logits), _t(labels),
                                     torch.zeros(3, 7))) == 0.0


# ---------------------------------------------------------------------------
# train_loss and its gradients against jax.value_and_grad
# ---------------------------------------------------------------------------

def _batch(cfg, seed, B=2, T=12):
    """numpy batch: tokens = labels, plus the family's embeddings."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, cfg.vocab_size, size=(B, T)).astype(np.int32)
    b = {"tokens": toks, "labels": toks}
    if cfg.family == "audio":
        b["audio_embeds"] = rng.standard_normal(
            (B, 16, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        b["image_embeds"] = rng.standard_normal(
            (B, cfg.num_image_tokens, cfg.vision_dim)).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: _t(v) for k, v in b.items()})


def _reference_x64(cj, tree, bj):
    """The reference's gradients with parameters and embeddings in
    float64 (its softmaxes still take float32, as it casts them): how far
    its float32 gradients lie from this measures its own float32
    rounding."""
    with jax.enable_x64(True):
        c64 = dataclasses.replace(cj, dtype="float64")
        f64 = lambda a: jnp.asarray(np.asarray(a), jnp.float64) \
            if np.asarray(a).dtype.kind == "f" else jnp.asarray(a)
        p64 = jax.tree.map(f64, tree)
        b64 = {k: f64(v) for k, v in bj.items()}
        g = jax.grad(lambda p: jax_tf.train_loss(p, c64, b64))(p64)
        return jax.tree.map(lambda a: np.asarray(a, np.float64), g)


def _assert_grads_close(gt, gj, cfg, g64=None):
    """Every leaf of the port's gradient tree (converted back to the
    reference's stacked layout) against the reference's: within
    GRAD_RTOL of the leaf's largest value (plus GRAD_ATOL) or, given
    ``g64``, within twice the reference's own float32 rounding (its
    distance from ``g64``) where that is larger."""
    gt_np = params_to_numpy(gt, cfg)
    assert jax.tree.structure(gt_np) == jax.tree.structure(gj)
    exact = jax.tree.leaves(g64) if g64 is not None \
        else [None] * len(jax.tree.leaves(gj))
    for (path, ref), got, ex in zip(jax.tree_util.tree_leaves_with_path(gj),
                                    jax.tree.leaves(gt_np), exact):
        ref = np.asarray(ref, np.float32)
        assert got.shape == ref.shape, path
        err = float(np.abs(got - ref).max())
        bound = GRAD_RTOL * float(np.abs(ref).max()) + GRAD_ATOL
        if ex is not None:
            bound = max(bound, 2 * float(np.abs(ref - ex).max()))
        assert err <= bound, (jax.tree_util.keystr(path), err, bound)


TRAIN_ARCHS = ["smollm-135m", "whisper-base", "llava-next-34b",
               "granite-moe-3b-a800m", "zamba2-7b", "mamba2-1.3b"]


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_train_loss_and_every_gradient_match_reference(arch):
    """Reduced float32 configs; granite's loss carries its MoE aux loss,
    zamba2's and mamba2's run the SSD scan's plain versions (through
    ``SSDScanFn``: the plain reverse walk is the backward on the CPU).
    whisper-base is the one family where float32 itself cannot hold
    1e-4: its random encoder's output, with no final norm, reaches
    ~100, the cross-attention scores a spread of ~30, and the softmax's
    backward cancels over keys that large; the reference's own float32
    gradients lie 3e-4 to 9e-4 of a leaf's largest value from its float64
    evaluation (which the MoE and Mamba2 families' scans cannot run), so
    there a leaf may also be within twice that."""
    cj, ct = jax_reduced(arch), reduced_config(arch)
    tree = numpy_params(cj, 81)
    pj = jax.tree.map(jnp.asarray, tree)
    pt = params_from_jax(tree, ct, device="cpu")
    bj, bt = _batch(cj, 82)
    lj, gj = jax.value_and_grad(
        lambda p: jax_tf.train_loss(p, cj, bj))(pj)
    lt, gt = loss_and_grads(pt, ct, bt)
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-5)
    if cj.family == "moe":
        _, _, aux = tf.forward(pt, ct, bt["tokens"])
        assert float(aux.detach()) > 0.0
    _assert_grads_close(gt, gj, cj, _reference_x64(cj, tree, bj)
                        if arch == "whisper-base" else None)


def test_remat_gives_the_same_gradients():
    """Each layer under ``torch.utils.checkpoint`` (cfg.remat, no cache,
    grad on) recomputes the same forward: equal loss and gradients, on
    the encoder-decoder stack and through the SSD scan's Function (its
    recomputed forward saves its inputs again) too."""
    for arch in ("whisper-base", "smollm-135m", "mamba2-1.3b"):
        ct = reduced_config(arch)
        _, bt = _batch(ct, 91)
        params = tf.init_params(3, ct, device="cpu")
        l0, g0 = loss_and_grads(params, ct, bt)
        l1, g1 = loss_and_grads(params, dataclasses.replace(ct, remat=True),
                                bt)
        assert float(l0) == float(l1)
        for a, b in zip(tree_leaves(g0), tree_leaves(g1)):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-7)


def test_accum_steps_matches_one_batch():
    """Two microbatches' gradients summed in float32 and halved equal the
    whole batch's (equal microbatches: the means agree)."""
    ct = reduced_config("smollm-135m")
    _, bt = _batch(ct, 92, B=4)
    params = tf.init_params(4, ct, device="cpu")
    l1, g1 = loss_and_grads(params, ct, bt)
    l2, g2 = loss_and_grads(params, ct, bt, accum_steps=2)
    np.testing.assert_allclose(float(l2), float(l1), rtol=1e-6)
    for a, b in zip(tree_leaves(g1), tree_leaves(g2)):
        assert b.dtype == torch.float32
        torch.testing.assert_close(b, a.float(), rtol=1e-5, atol=1e-7)


def test_ssd_scan_plain_gradients_match_reference():
    """The scan's plain version, the one the port trains through, against
    ``jax.grad`` of the reference's ``ssd_chunked`` (every input)."""
    rng = np.random.default_rng(93)
    b, t, h, p, g, n, chunk = 1, 32, 2, 16, 1, 8, 8
    x = rng.standard_normal((b, t, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, t, h)))).astype(np.float32)
    A = (-np.exp(rng.standard_normal(h))).astype(np.float32)
    B = rng.standard_normal((b, t, g, n)).astype(np.float32)
    C = rng.standard_normal((b, t, g, n)).astype(np.float32)
    w = rng.standard_normal((b, t, h, p)).astype(np.float32)

    def ref_loss(*a):
        y, s = jax_m2.ssd_chunked(*a, chunk)
        return jnp.sum(y * w) + jnp.sum(s)

    gj = jax.grad(ref_loss, argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(a) for a in (x, dt, A, B, C)))
    ins = [_t(a).requires_grad_(True) for a in (x, dt, A, B, C)]
    y, s = ssd_ops.ssd_scan(*ins, chunk)
    (y * _t(w)).sum().add(s.sum()).backward()
    for got, ref in zip(ins, gj):
        ref = np.asarray(ref)
        err = float(np.abs(got.grad.numpy() - ref).max())
        assert err <= 1e-4 * float(np.abs(ref).max()) + 1e-6, err


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
# the loop, the checkpoint and the launcher
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


def test_train_step_and_eval_step():
    cfg = reduced_config("whisper-base")
    _, bt = _batch(cfg, 111)
    params = tf.init_params(5, cfg, device="cpu")
    before = params["layers"][-1]["xattn"]["wq"].clone()
    loss0 = float(make_eval_step(cfg)(params, bt))
    step = make_train_step(cfg, AdamWConfig(lr=1e-2, warmup_steps=0))
    state = init_opt_state(params)
    params, state, m = step(params, state, bt)
    assert float(m["loss"]) == pytest.approx(loss0, rel=1e-6)
    assert int(m["step"]) == 1 and np.isfinite(float(m["grad_norm"]))
    assert not torch.equal(before, params["layers"][-1]["xattn"]["wq"])
    assert float(make_eval_step(cfg)(params, bt)) < loss0


@pytest.mark.parametrize("arch", ["gemma3-1b", "qwen2.5-3b"])
def test_checkpoint_roundtrip_with_opt_state(arch, tmp_path):
    """Parameters (bf16 for qwen2.5-3b: through float32 on the host) and
    optimizer state come back bit-equal, typed as the template; a step
    from the loaded state equals a step from the saved one."""
    cfg = reduced_config(arch)
    if arch == "qwen2.5-3b":
        cfg = dataclasses.replace(cfg, dtype="bfloat16")
    params = tf.init_params(0, cfg, device="cpu")
    opt_cfg = AdamWConfig(warmup_steps=1)
    step = make_train_step(cfg, opt_cfg)
    batch = next(synthetic_lm_batches(cfg, 2, 16, device="cpu"))
    state = init_opt_state(params)
    params, state, _ = step(params, state, batch)
    path = os.path.join(tmp_path, "c.npz")
    save_checkpoint(path, params, state, meta={"arch": cfg.name},
                    cfg=cfg)
    template = tf.init_params(1, cfg, device="cpu")
    p2, s2 = load_checkpoint(path, template, init_opt_state(template))
    for a, b in zip(tree_leaves(params), tree_leaves(p2)):
        assert b.dtype == a.dtype == cfg.param_dtype
        assert torch.equal(a.detach(), b)
    assert int(s2.step) == int(state.step) == 1
    for a, b in zip(tree_leaves((state.m, state.v)),
                    tree_leaves((s2.m, s2.v))):
        assert torch.equal(a, b)
    with open(path + ".meta.json") as f:
        assert json.load(f) == {"arch": cfg.name}
    _, _, m1 = step(params, state, batch)
    _, _, m2 = step(p2, s2, batch)
    assert float(m1["loss"]) == float(m2["loss"])


def test_launch_train_on_the_cpu(tmp_path, capsys):
    from repro_torch.launch import train as launch_train
    path = os.path.join(tmp_path, "ck.npz")
    launch_train.main(["--arch", "smollm-135m", "--steps", "3", "--batch",
                       "2", "--seq", "16", "--device", "cpu", "--ckpt",
                       path])
    out = capsys.readouterr().out
    hist = json.loads(out[:out.index("]") + 1])
    assert [h["step"] for h in hist] == [0, 2]
    assert "checkpoint saved to" in out and os.path.exists(path)
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="--device cpu"):
            launch_train.main(["--steps", "1"])
