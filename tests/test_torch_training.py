"""The port's training loss (``models/common.softmax_xent``,
``transformer.train_loss``, ``training/train.loss_and_grads``) against
the reference's, on the CPU: the loss and every gradient leaf against
``jax.value_and_grad`` on the same numpy-made weights, remat, gradient
accumulation and the SSD scan's plain gradients.  The optimizer and the
loop are in ``test_torch_training_optim.py``, the train step, the
checkpoint and the launcher in ``test_torch_training_loop.py``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jax_reduced
from repro.models import common as jax_common
from repro.models import mamba2 as jax_m2
from repro.models import transformer as jax_tf
from repro_torch.configs import reduced_config
from repro_torch.convert import params_from_jax, params_to_numpy
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.models import common
from repro_torch.models import transformer as tf
from repro_torch.training.optimizer import tree_leaves
from repro_torch.training.train import loss_and_grads

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
