"""Checkpoints cross between the port and the reference, and the
synthetic LM stream's ``structured`` flag.

On reduced smollm-135m with numpy-made weights and optimizer moments, in
float32 and in bf16: the port restores the reference's file bit for bit
(bf16 arrives there as raw ``V2`` records), and the reference restores the
port's (bf16 arrives as float32, which its loader casts exactly); both
files hold the same keys.  The reference cannot restore its own bf16
file: that trap is pinned so that the day it changes is seen.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jax_reduced
from repro.training import checkpoint as jax_ckpt
from repro.training.optimizer import OptState as JaxOptState
from repro_torch.configs import reduced_config
from repro_torch.convert import params_from_jax
from repro_torch.models import transformer as tf
from repro_torch.training.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.training.optimizer import OptState, init_opt_state
from repro_torch.training.train import synthetic_lm_batches

from test_torch_helpers import cap_threads, numpy_params

cap_threads()

ARCH = "smollm-135m"
DTYPES = ["float32", "bfloat16"]


def _configs(dtype):
    return (dataclasses.replace(jax_reduced(ARCH), dtype=dtype),
            dataclasses.replace(reduced_config(ARCH), dtype=dtype))


def _reference_state(cj, seed):
    """The reference's parameters in the config's type and an optimizer
    state with numpy-made float32 moments at step 7."""
    tree = numpy_params(cj, seed)
    params = jax.tree.map(lambda a: jnp.asarray(a, cj.param_dtype), tree)
    rng = np.random.default_rng(seed + 1)
    moment = lambda: jax.tree.map(
        lambda a: jnp.asarray(rng.standard_normal(a.shape), jnp.float32),
        tree)
    return params, JaxOptState(step=jnp.asarray(7, jnp.int32), m=moment(),
                               v=moment())


def _port_of(tree, ct, dtype=None):
    return params_from_jax(jax.tree.map(np.asarray, tree), ct, device="cpu",
                           dtype=dtype)


def _by_path(tree, prefix=""):
    """{path: leaf} of a nested dict / list, whatever its key order."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _by_path(sub, f"{prefix}{key}/").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _by_path(sub, f"{prefix}{i}/").items()}
    return {prefix.rstrip("/"): tree}


def _assert_same(want, got, dtype):
    want, got = _by_path(want), _by_path(got)
    assert sorted(want) == sorted(got)
    for k, a in want.items():
        assert got[k].dtype == dtype, k
        np.testing.assert_array_equal(_bits(a), _bits(got[k]), err_msg=k)


def _bits(t):
    """A tensor's bits, so that bf16 leaves compare bit for bit."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


@pytest.mark.parametrize("dtype", DTYPES)
def test_port_restores_the_references_file_bit_for_bit(dtype, tmp_path):
    cj, ct = _configs(dtype)
    params, opt = _reference_state(cj, 11)
    path = os.path.join(tmp_path, "ref.npz")
    jax_ckpt.save_checkpoint(path, params, opt, meta={"arch": cj.name})
    with np.load(path) as data:
        assert "params/segments/0/0/attn/wk" in data.files
        if dtype == "bfloat16":
            assert data["params/embed"].dtype.kind == "V"
    template = tf.init_params(3, ct, device="cpu")
    p2, s2 = load_checkpoint(path, template, init_opt_state(template))
    _assert_same(_port_of(params, ct), p2, ct.param_dtype)
    assert int(s2.step) == 7 and s2.step.dtype == torch.int32
    for ref, got in ((opt.m, s2.m), (opt.v, s2.v)):
        _assert_same(_port_of(ref, ct, torch.float32), got, torch.float32)


@pytest.mark.parametrize("dtype", DTYPES)
def test_reference_restores_the_ports_file_bit_for_bit(dtype, tmp_path):
    cj, ct = _configs(dtype)
    params_j, opt_j = _reference_state(cj, 12)
    params = _port_of(params_j, ct)
    opt = OptState(step=torch.tensor(7, dtype=torch.int32),
                   m=_port_of(opt_j.m, ct, torch.float32),
                   v=_port_of(opt_j.v, ct, torch.float32))
    port_path = os.path.join(tmp_path, "port.npz")
    save_checkpoint(port_path, params, opt, meta={"arch": ct.name}, cfg=ct)
    # the same keys as the reference's file for the same state
    ref_path = os.path.join(tmp_path, "ref.npz")
    jax_ckpt.save_checkpoint(ref_path, params_j, opt_j)
    with np.load(port_path) as a, np.load(ref_path) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].shape == b[k].shape, k
    template_j = jax.tree.map(jnp.zeros_like, params_j)
    opt_template = JaxOptState(step=jnp.zeros((), jnp.int32),
                               m=jax.tree.map(jnp.zeros_like, opt_j.m),
                               v=jax.tree.map(jnp.zeros_like, opt_j.v))
    p2, o2 = jax_ckpt.load_checkpoint(port_path, template_j, opt_template)
    for a, b in zip(jax.tree.leaves(params_j), jax.tree.leaves(p2)):
        assert b.dtype == a.dtype
        np.testing.assert_array_equal(np.asarray(a).view(np.uint8),
                                      np.asarray(b).view(np.uint8))
    assert int(o2.step) == 7
    for a, b in zip(jax.tree.leaves((opt_j.m, opt_j.v)),
                    jax.tree.leaves((o2.m, o2.v))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_port_reads_its_per_layer_layout(tmp_path):
    """A file in the port's earlier layout (``params/layers/<i>/...``,
    float32 bf16 leaves) still restores, bit for bit."""
    cj, ct = _configs("bfloat16")
    params = _port_of(_reference_state(cj, 13)[0], ct)
    flat = {}

    def walk(tree, prefix):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, f"{prefix}{k}/")
        elif isinstance(tree, list):
            for i, v in enumerate(tree):
                walk(v, f"{prefix}{i}/")
        else:
            flat["params/" + prefix.rstrip("/")] = tree.float().numpy()

    walk(params, "")
    path = os.path.join(tmp_path, "old.npz")
    np.savez(path, **flat)
    p2, s2 = load_checkpoint(path, tf.init_params(4, ct, device="cpu"))
    assert s2 is None
    _assert_same(params, p2, torch.bfloat16)


def test_reference_cannot_restore_its_own_bf16_file(tmp_path):
    """A trap in the reference: its bf16 leaves are saved as ``V2``
    records, which its loader cannot cast back (``ROADMAP.md``, "Traps in
    the reference")."""
    cj, _ = _configs("bfloat16")
    params, _ = _reference_state(cj, 14)
    path = os.path.join(tmp_path, "ref.npz")
    jax_ckpt.save_checkpoint(path, params)
    with pytest.raises(ValueError):
        jax_ckpt.load_checkpoint(path, params)


def test_unstructured_batches_are_uniform_tokens():
    cfg = reduced_config(ARCH)
    batch = next(synthetic_lm_batches(cfg, 8, 64, seed=3, structured=False,
                                      device="cpu"))
    tok = batch["tokens"]
    assert tok.shape == (8, 64) and torch.equal(batch["labels"], tok)
    assert int(tok.min()) >= 0 and int(tok.max()) < cfg.vocab_size
    prev, nxt = tok[:, :-1], tok[:, 1:]
    V = cfg.vocab_size
    bigram = (nxt == (prev * 7 + 3) % V) | (nxt == (prev * 31 + 17) % V)
    assert float(bigram.float().mean()) < 0.05
    assert len(torch.unique(tok)) > V // 2


def test_structured_batches_follow_the_bigram_map():
    cfg = reduced_config(ARCH)
    stream = synthetic_lm_batches(cfg, 16, 128, seed=3, device="cpu")
    tok = next(stream)["tokens"]
    again = next(synthetic_lm_batches(cfg, 16, 128, seed=3,
                                      structured=True, device="cpu"))
    assert torch.equal(tok, again["tokens"])
    prev, nxt = tok[:, :-1], tok[:, 1:]
    V = cfg.vocab_size
    main = float((nxt == (prev * 7 + 3) % V).float().mean())
    other = (nxt == (prev * 31 + 17) % V) & (nxt != (prev * 7 + 3) % V)
    assert 0.85 < main < 0.95
    assert bool(((nxt == (prev * 7 + 3) % V) | other).all())
