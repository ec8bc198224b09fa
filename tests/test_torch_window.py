"""The port's sliding-window (local / global) family against the reference
on the CPU, on the same numpy-made weights (float32 reduced gemma3-1b:
window 32, eight layers, five local to one global):

* the ring buffer's pieces — ``ring_slot_positions``, the modular slot of
  ``write_cache`` and the ``T >= S`` tail — against the reference's;
* the reference's ``test_sliding_window_ring_buffer_never_reads_stale``
  scenario (three windows of prefill, then decode) and a chunk longer
  than the ring;
* the forward pass, cache-free and chunked, and a windowed layer under a
  decode's row mask: masked rows write nothing and read as unmasked;
* ``TorchExecutor`` against ``JaxExecutor`` with an idle slot and a row
  prefilling beside a decode past the window;
* the dense cache's ring leaves: their sizes, and ``copy_prefix`` and the
  paged pool refusing them.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jax_reduced
from repro.models import attention as jax_attn
from repro.models import transformer as jax_tf
from repro_torch.configs import get_config, reduced_config
from repro_torch.engine import migrate
from repro_torch.models import attention as attn
from repro_torch.models import transformer as tf

from test_torch_engine import Side
from test_torch_helpers import (both_params, copying_reference,  # noqa: F401
                                scaled_err)
from test_torch_moe import _serve_beside_idle_and_prefilling

ARCH = "gemma3-1b"


def test_ring_slot_positions_match_reference():
    ends = np.array([0, 1, 5, 8, 9, 31, 77], np.int32)
    got = attn.ring_slot_positions(torch.from_numpy(ends), 8)
    ref = jax_attn.ring_slot_positions(jnp.asarray(ends), 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("start,T", [(3, 4), (6, 5), (13, 8)])
def test_ring_write_wraps_like_reference(start, T):
    """Writes at positions past the ring's S = 8 slots land in slot
    ``p % S``, per row."""
    rng = np.random.default_rng(start)
    ck = rng.standard_normal((2, 8, 1, 4)).astype(np.float32)
    new = rng.standard_normal((2, T, 1, 4)).astype(np.float32)
    st = np.array([start, start + 2], np.int32)
    rk, _ = jax_attn.write_cache(jnp.asarray(ck), jnp.asarray(ck),
                                 jnp.asarray(new), jnp.asarray(new),
                                 jnp.asarray(st))
    tk = torch.from_numpy(ck.copy())
    attn.write_cache(tk, torch.from_numpy(ck.copy()), torch.from_numpy(new),
                     torch.from_numpy(new), torch.from_numpy(st))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(rk))


@pytest.fixture(scope="module")
def gemma():
    cj, ct = jax_reduced(ARCH), reduced_config(ARCH)
    pj, pt = both_params(cj, ct, seed=51)
    return cj, ct, pj, pt


def test_ring_buffer_never_reads_stale(gemma):
    """The reference's scenario: 96 tokens (three windows) prefilled in
    chunks of 16 over a 128-slot cache, the last logits against the
    cache-free forward; then two decode steps against the reference's."""
    cj, ct, pj, pt = gemma
    B, S = 2, 96
    tokens = np.random.default_rng(52).integers(
        0, cj.vocab_size, size=(B, S + 2)).astype(np.int32)
    full, _, _ = tf.forward(pt, ct, torch.from_numpy(tokens[:, :S]))
    cache = tf.init_cache(ct, B, 128, device="cpu")
    assert cache["k_local"].shape[2] == 32 and cache["k"].shape[2] == 128
    cache_j = jax_tf.init_cache(cj, B, 128)
    for c in range(6):
        start = torch.full((B,), c * 16, dtype=torch.int32)
        last, _ = tf.prefill(pt, ct, torch.from_numpy(
            tokens[:, c * 16:(c + 1) * 16]), cache, start)
        _, cache_j = jax_tf.prefill(pj, cj, jnp.asarray(
            tokens[:, c * 16:(c + 1) * 16]), cache_j,
            jnp.full((B,), c * 16, jnp.int32))
    assert scaled_err(last.numpy(), full[:, -1].numpy()) < 2e-3
    for i in range(2):
        pos = np.full((B,), S + i, np.int32)
        lt, _ = tf.decode_step(pt, ct, torch.from_numpy(tokens[:, S + i:
                                                               S + i + 1]),
                               cache, torch.from_numpy(pos))
        lj, cache_j = jax_tf.decode_step(pj, cj, jnp.asarray(
            tokens[:, S + i:S + i + 1]), cache_j, jnp.asarray(pos))
        assert scaled_err(lt.numpy(), lj) < 2e-3
        np.testing.assert_array_equal(lt.numpy().argmax(-1),
                                      np.asarray(lj).argmax(-1))


def test_chunk_longer_than_the_ring(gemma):
    """A 40-token chunk at offset 10 over a 32-slot ring: it attends over
    the prior ring and itself, then only its last 32 tokens are written
    (the ``T >= S`` tail); the ring after it equals the reference's."""
    cj, ct, pj, pt = gemma
    tokens = np.random.default_rng(53).integers(
        0, cj.vocab_size, size=(1, 60)).astype(np.int32)
    cache = tf.init_cache(ct, 1, 64, device="cpu")
    cache_j = jax_tf.init_cache(cj, 1, 64)
    for at, n in ((0, 10), (10, 40), (50, 10)):
        pos = np.arange(at, at + n, dtype=np.int32)[None]
        lt, _, _ = tf.forward(pt, ct, torch.from_numpy(tokens[:, at:at + n]),
                              torch.from_numpy(pos), cache)
        lj, cache_j, _ = jax_tf.forward(pj, cj, jnp.asarray(
            tokens[:, at:at + n]), jnp.asarray(pos), cache_j)
        assert scaled_err(lt.numpy(), lj) < 2e-3
    # the port stacks the ring layers in execution order: the period's
    # five local layers, then the two trailing ones
    seg0, seg1 = cache_j["segments"]
    ring_j = np.stack([np.asarray(seg0[i]["k"][0]) for i in range(5)]
                      + [np.asarray(seg1[i]["k"][0]) for i in range(2)])
    np.testing.assert_allclose(cache["k_local"].numpy(), ring_j, atol=1e-4)


def test_forward_matches_reference(gemma):
    """Cache-free over 70 tokens (past two windows): logits to the scaled
    2e-3 of the other forward tests, greedy tokens equal."""
    cj, ct, pj, pt = gemma
    tokens = np.random.default_rng(54).integers(
        1, cj.vocab_size, size=(2, 70)).astype(np.int32)
    lj, _, aj = jax_tf.forward(pj, cj, jnp.asarray(tokens))
    lt, _, at = tf.forward(pt, ct, torch.from_numpy(tokens))
    assert scaled_err(lt.numpy(), lj) < 2e-3
    np.testing.assert_array_equal(lt.numpy().argmax(-1),
                                  np.asarray(lj).argmax(-1))
    assert float(at) == float(aj) == 0.0


def test_windowed_decode_row_mask_drops_writes_not_reads(gemma):
    """A full-slot-batch decode with row 1 masked (``valid_len`` 0): the
    masked row's ring and global KV are as before the step, and every
    row's logits are those of the unmasked step (the reference's decode,
    which has no row mask)."""
    cj, ct, pj, pt = gemma
    B = 3
    tokens = np.random.default_rng(55).integers(
        1, cj.vocab_size, size=(B, 41)).astype(np.int32)
    cache = tf.init_cache(ct, B, 64, device="cpu")
    pos = np.broadcast_to(np.arange(40, dtype=np.int32)[None], (B, 40))
    tf.forward(pt, ct, torch.from_numpy(tokens[:, :40]),
               torch.from_numpy(pos.copy()), cache)
    before = {n: t.clone() for n, t in cache.items()}
    step = torch.from_numpy(np.full((B, 1), 40, np.int32))
    tok = torch.from_numpy(tokens[:, 40:41])
    masked, _, _ = tf.forward(pt, ct, tok, step, cache,
                              valid_len=torch.tensor([1, 0, 1]))
    after_masked = {n: t.clone() for n, t in cache.items()}
    for n, t in before.items():
        cache[n].copy_(t)
    plain, _, _ = tf.forward(pt, ct, tok, step, cache)
    np.testing.assert_array_equal(masked.numpy(), plain.numpy())
    for n in cache:
        assert torch.equal(after_masked[n][:, 1], before[n][:, 1]), n
        assert torch.equal(after_masked[n][:, 0::2], cache[n][:, 0::2]), n


@pytest.mark.usefixtures("copying_reference")
@pytest.mark.parametrize("batched", [True, False], ids=["batched", "rowwise"])
def test_rows_beside_a_decode_token_exact(gemma, batched):
    """``test_torch_moe.py``'s plan on gemma3: an idle slot and a row
    part-way through its prefill (a 41-token prompt in 23-token chunks)
    beside a row decoding past its 32-slot ring.  The reference's
    full-slot decode writes those rows' KV at their frontiers, the port's
    drops the writes (``valid_len``); the tokens are the reference's."""
    cj, ct, pj, pt = gemma
    ref = _serve_beside_idle_and_prefilling(Side(False, pj, cj), batched)
    got = _serve_beside_idle_and_prefilling(Side(True, pt, ct), batched)
    assert got == ref


def test_ring_leaves_layout_and_refusals():
    """gemma3-1b at its registered width, as shapes: 4 global layers of
    ``max_seq`` slots, 22 local ones of the 1024-token window.  A ring
    has no token boundary (``copy_prefix`` refuses it) and no block
    identity (the paged pool refuses the family)."""
    cfg = get_config(ARCH)
    cache = tf.init_cache(cfg, 8, 4096, device="meta")
    assert tuple(cache["k"].shape) == (4, 8, 4096, 1, 256)
    assert tuple(cache["k_local"].shape) == (22, 8, 1024, 1, 256)
    assert tuple(tf.init_cache(cfg, 1, 512, device="meta")["v_local"]
                 .shape) == (22, 1, 512, 1, 256)
    small = tf.init_cache(reduced_config(ARCH), 2, 64, device="cpu")
    with pytest.raises(ValueError, match="ring buffers"):
        migrate.copy_prefix(small, 0, 1, 16)
    with pytest.raises(ValueError, match="all-ATTN"):
        tf.init_paged_cache(reduced_config(ARCH), 4, 16, device="cpu")
