"""The port's MoE family against the reference on the CPU, on the same
numpy-made weights (float32 reduced configs):

* ``moe_ffn`` against ``repro.models.moe.moe_ffn`` — global dispatch
  (T == 1) and per-row dispatch (T > 1), with and without dropped slots —
  outputs and the load-balance loss within 1e-5;
* the forward pass of reduced granite-moe-3b-a800m and arctic-480b
  (dense residual), cache-free and chunked over a dense cache;
* ``TorchExecutor`` against ``JaxExecutor``, greedy and token-exact, where
  the full-slot-batch decode's capacity is shared with rows it does not
  schedule: an idle slot and a row part-way through its prefill, both
  below a decoding row in slot order (token-major drop priority).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jax_reduced
from repro.models import moe as jax_moe
from repro.models import transformer as jax_tf
from repro_torch.configs import get_config, reduced_config
from repro_torch.convert import params_from_jax
from repro_torch.engine.engine import packable
from repro_torch.models import moe
from repro_torch.models import transformer as tf

from test_torch_engine import Side
from test_torch_helpers import (both_params, copying_reference,  # noqa: F401
                                scaled_err)

MOE_ARCHS = ["granite-moe-3b-a800m", "arctic-480b"]


def _moe_params(cfg, rng):
    d, E, f = cfg.d_model, cfg.num_experts, cfg.expert_d_ff
    draw = lambda s, fan: (rng.standard_normal(s) * fan ** -0.5).astype(
        np.float32)
    return {"router": draw((d, E), d), "w_gate": draw((E, d, f), d),
            "w_up": draw((E, d, f), d), "w_down": draw((E, f, d), f)}


def _dropped(cfg, router, x):
    """Slots the reference's dispatch drops for x [B, T, d]: past its
    expert's capacity in its group (the batch at T == 1, else a row)."""
    B, T, _ = x.shape
    _, idx, _ = jax_moe._route({"router": jnp.asarray(router)}, cfg,
                               jnp.asarray(x))
    groups = np.asarray(idx).reshape((1, -1) if T == 1 else (B, -1))
    E, k, cf = cfg.num_experts, cfg.top_k, cfg.capacity_factor
    cap = max(1, int(-(-(B if T == 1 else T) * k * cf // E)))
    return sum(int(np.maximum(np.bincount(g, minlength=E) - cap, 0).sum())
               for g in groups)


@pytest.mark.parametrize("cf", [1.25, 0.5], ids=["cf1.25", "drops"])
@pytest.mark.parametrize("B,T", [(7, 1), (2, 13)], ids=["global", "per_row"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_ffn_matches_reference(arch, B, T, cf):
    cj = dataclasses.replace(jax_reduced(arch), capacity_factor=cf)
    ct = dataclasses.replace(reduced_config(arch), capacity_factor=cf)
    rng = np.random.default_rng(B * T)
    p = _moe_params(cj, rng)
    x = rng.standard_normal((B, T, cj.d_model)).astype(np.float32)
    oj, aj = jax_moe.moe_ffn({k: jnp.asarray(v) for k, v in p.items()}, cj,
                             jnp.asarray(x))
    ot, at = moe.moe_ffn({k: torch.from_numpy(v) for k, v in p.items()}, ct,
                         torch.from_numpy(x))
    assert ot.shape == (B, T, cj.d_model) and at.dtype == torch.float32
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), atol=1e-5)
    np.testing.assert_allclose(float(at), float(aj), atol=1e-5)
    dropped = _dropped(cj, p["router"], x)
    assert (dropped > 0) == (cf < 1), dropped


def test_route_breaks_ties_to_the_lower_expert():
    """Equal router logits: the lower expert index first, as
    ``jax.lax.top_k`` orders them."""
    cfg = dataclasses.replace(reduced_config("granite-moe-3b-a800m"),
                              num_experts=6, top_k=3)
    d = cfg.d_model
    router = np.zeros((d, 6), np.float32)
    router[0] = [1.0, 3.0, 3.0, 2.0, 3.0, 2.0]
    x = np.zeros((1, 2, d), np.float32)
    x[..., 0] = 1.0
    cj = dataclasses.replace(jax_reduced("granite-moe-3b-a800m"),
                             num_experts=6, top_k=3)
    _, ij, _ = jax_moe._route({"router": jnp.asarray(router)}, cj,
                              jnp.asarray(x))
    _, it, _ = moe._route({"router": torch.from_numpy(router)}, cfg,
                          torch.from_numpy(x))
    assert it.tolist() == np.asarray(ij).tolist() == [[[1, 2, 4]] * 2]


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_forward_matches_reference(arch):
    """Cache-free, then three chunks and two decode steps over a dense
    cache: logits to the scaled 2e-3 of the other forward tests, greedy
    tokens equal, and the summed load-balance loss."""
    cj, ct = jax_reduced(arch), reduced_config(arch)
    pj, pt = both_params(cj, ct, seed=41)
    assert pt["layers"][0]["moe"]["router"].dtype == torch.float32
    assert ("dense_mlp" in pt["layers"][0]) == ct.dense_residual
    toks = np.random.default_rng(42).integers(
        1, cj.vocab_size, size=(2, 40)).astype(np.int32)
    lj, _, aj = jax_tf.forward(pj, cj, jnp.asarray(toks))
    lt, _, at = tf.forward(pt, ct, torch.from_numpy(toks))
    assert scaled_err(lt.numpy(), lj) < 2e-3
    np.testing.assert_array_equal(lt.numpy().argmax(-1),
                                  np.asarray(lj).argmax(-1))
    assert float(at) > 0
    np.testing.assert_allclose(float(at), float(aj), rtol=1e-5)
    cache_j = jax_tf.init_cache(cj, 2, 64)
    cache_t = tf.init_cache(ct, 2, 64, device="cpu")
    at_ = 0
    for n in (17, 16, 5, 1, 1):
        pos = np.broadcast_to(np.arange(at_, at_ + n, dtype=np.int32)[None],
                              (2, n)).copy()
        chunk = toks[:, at_:at_ + n]
        lj, cache_j, _ = jax_tf.forward(pj, cj, jnp.asarray(chunk),
                                        jnp.asarray(pos), cache_j)
        lt, _, _ = tf.forward(pt, ct, torch.from_numpy(chunk),
                              torch.from_numpy(pos), cache_t)
        assert scaled_err(lt.numpy(), lj) < 2e-3
        at_ += n


def test_moe_params_and_cache_layout():
    """A bf16 reduced config's parameters keep a float32 router; the dense
    cache at granite-moe-3b-a800m's registered width, as shapes (nothing
    is allocated): KV over all 32 layers."""
    small = dataclasses.replace(reduced_config("granite-moe-3b-a800m"),
                                dtype="bfloat16")
    blk = tf.init_params(0, small, device="cpu")["layers"][0]
    assert tuple(blk["moe"]["w_gate"].shape) == (4, 256, 128)
    assert blk["moe"]["router"].dtype == torch.float32
    assert blk["moe"]["w_up"].dtype == torch.bfloat16
    cfg = get_config("granite-moe-3b-a800m")
    cache = tf.init_cache(cfg, 8, 64, device="meta")
    assert set(cache) == {"k", "v"}
    assert tuple(cache["k"].shape) == (32, 8, 64, 8, 64)
    assert not packable(cfg)
    with pytest.raises(ValueError, match="all-ATTN"):
        tf.init_paged_cache(reduced_config("granite-moe-3b-a800m"), 4, 16,
                            device="cpu")


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_converted_bf16_tree_is_the_references_leaf_for_leaf(arch):
    """A bf16 config's reference parameters, converted: every leaf in the
    reference's own type (the router float32) with its values."""
    import jax

    cj = dataclasses.replace(jax_reduced(arch), dtype="bfloat16")
    ct = dataclasses.replace(reduced_config(arch), dtype="bfloat16")
    tree = jax_tf.init_params(jax.random.PRNGKey(3), cj)
    pt = params_from_jax(jax.tree.map(np.asarray, tree), ct, device="cpu")
    stacked = tree["segments"][0][0]
    want = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    for li, layer in enumerate(pt["layers"]):
        for path, leaf in jax.tree_util.tree_leaves_with_path(stacked):
            keys = [k.key for k in path]
            got = layer
            for k in keys:
                got = got[k]
            ref = np.asarray(leaf[li])
            assert got.dtype == want[ref.dtype.name], keys
            np.testing.assert_array_equal(got.float().numpy(),
                                          ref.astype(np.float32))
    assert pt["layers"][0]["moe"]["router"].dtype == torch.float32


# -- the decode's shared capacity -------------------------------------------

def _serve_beside_idle_and_prefilling(side, batched):
    """Four slots.  A (slot 0) finishes after 3 tokens and leaves its slot
    idle while B (slot 1, a 70-token prompt) decodes; C then arrives,
    takes slot 0 and prefills in chunks beside B's decodes.  Every
    full-slot-batch decode routes the idle slot's and C's rows before
    B's."""
    ex, inst = side.make(n_slots=4, chunk=24, batched=batched)
    rng = np.random.default_rng(3)
    reqs = [side.Request(prompt_len=n, max_new_tokens=m, hidden_output_len=m,
                         prompt_tokens=list(map(int, rng.integers(1, 500,
                                                                  size=n))))
            for n, m in ((20, 3), (70, 10), (41, 5))]
    inst.enqueue_prefill(reqs[0])
    now = 0.0
    for it in range(80):
        if it == 2:
            inst.enqueue_prefill(reqs[1])
        if it == 7:
            inst.enqueue_prefill(reqs[2])
        dur, done, _ = inst.run_iteration(now)
        now += dur
        for r in done:
            inst.admit_decode(r)
        if all(r.done() for r in reqs):
            break
    assert all(r.done() for r in reqs)
    return [r.output_tokens for r in reqs]


@pytest.mark.usefixtures("copying_reference")
@pytest.mark.parametrize("batched", [True, False], ids=["batched", "rowwise"])
def test_decode_capacity_counts_the_rows_it_does_not_schedule(batched):
    """At a capacity factor of 0.5 (one slot an expert at four rows) the
    rows a decode does not schedule decide which of B's slots are
    dropped: the port sends them, with the reference's tokens, positions
    and reads, through the experts and stays token-exact."""
    cj = dataclasses.replace(jax_reduced("granite-moe-3b-a800m"),
                             capacity_factor=0.5)
    ct = dataclasses.replace(reduced_config("granite-moe-3b-a800m"),
                             capacity_factor=0.5)
    pj, pt = both_params(cj, ct, seed=31)
    ref = _serve_beside_idle_and_prefilling(Side(False, pj, cj), batched)
    got = _serve_beside_idle_and_prefilling(Side(True, pt, ct), batched)
    assert got == ref
    assert [len(o) for o in got] == [3, 10, 5]
