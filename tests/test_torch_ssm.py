"""The port's Mamba2 / hybrid path against the reference on the CPU, on
the same numpy-made inputs and weights:

* the SSD scan wrapper's plain version ``ssd_scan_ref``
  against the reference's sequential ``ssd_naive_ref`` and its Pallas
  ``ssd_scan`` in interpret mode, at the shapes of
  ``tests/test_kernels.py`` plus a chunk of 215 (atol 2e-3, the bound that
  test holds the reference's kernel to: float32 sums over a chunk in
  another order, exp of another library);
* ``mamba2_block`` (prefill, then a decode continuation) and ``forward``
  on reduced zamba2 and mamba2 with converted parameters (float32; logits
  to a scaled 2e-3, caches to 1e-4);
* the recurrent-state fault of the reference's dense decode, pinned as a
  pair: the port's first token for a row prefilled beside a decode is the
  cache-free forward's, while the reference advances that row's state.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jax_reduced
from repro.core.instance import IterationPlan as JaxPlan
from repro.engine.engine import JaxExecutor
from repro.engine.request import Request as JaxRequest
from repro.kernels.ssd_scan.ops import ssd_scan as jax_ssd_scan
from repro.kernels.ssd_scan.ref import ssd_naive_ref
from repro.models import mamba2 as jax_m2
from repro.models import transformer as jax_tf
from repro_torch.configs import get_config, reduced_config
from repro_torch.convert import params_from_jax
from repro_torch.core.instance import IterationPlan
from repro_torch.engine.engine import TorchExecutor
from repro_torch.engine.request import Request
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.models import mamba2 as m2
from repro_torch.models import transformer as tf

from test_torch_helpers import (both_params, cap_threads,  # noqa: F401
                                copying_reference, numpy_params)

cap_threads()

# the reference's host arrays may alias its in-flight inputs on the CPU
pytestmark = pytest.mark.usefixtures("copying_reference")

SSD_ATOL = 2e-3


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _ssd_inputs(b, t, h, p, g, n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, t, h)))).astype(np.float32)
    A = (-np.exp(rng.standard_normal(h))).astype(np.float32)
    B = rng.standard_normal((b, t, g, n)).astype(np.float32)
    C = rng.standard_normal((b, t, g, n)).astype(np.float32)
    s0 = (rng.standard_normal((b, h, p, n)) * 0.1).astype(np.float32)
    return x, dt, A, B, C, s0


SSD_SHAPES = [               # b, t, h, p, g, n, chunk
    (2, 64, 4, 32, 1, 16, 16),
    (1, 128, 8, 64, 1, 64, 32),
    (1, 32, 2, 16, 2, 8, 8),         # multi-group
    (2, 96, 4, 32, 1, 32, 32),       # t not a power of two
    (1, 430, 2, 16, 1, 8, 215),      # a chunk that is no power of two
]


@pytest.mark.parametrize("b,t,h,p,g,n,chunk", SSD_SHAPES)
def test_ssd_scan_plain_matches_reference(b, t, h, p, g, n, chunk):
    x, dt, A, B, C, s0 = _ssd_inputs(b, t, h, p, g, n)
    jx = [jnp.asarray(a) for a in (x, dt, A, B, C, s0)]
    y_naive, s_naive = ssd_naive_ref(*jx)
    y_kern, s_kern = jax_ssd_scan(*jx[:5], chunk, jx[5])
    before = ssd_ops.ssd_scan.launches
    y, s = ssd_ops.ssd_scan(*(_t(a) for a in (x, dt, A, B, C)), chunk,
                            _t(s0))
    assert ssd_ops.ssd_scan.launches == before      # plain version on CPU
    assert y.dtype == torch.float32 and s.dtype == torch.float32
    for ref_y, ref_s in ((y_naive, s_naive), (y_kern, s_kern)):
        np.testing.assert_allclose(y.numpy(), np.asarray(ref_y),
                                   atol=SSD_ATOL)
        np.testing.assert_allclose(s.numpy(), np.asarray(ref_s),
                                   atol=SSD_ATOL)


def test_ssd_no_init_state():
    x, dt, A, B, C, _ = _ssd_inputs(1, 32, 2, 16, 1, 8)
    y_ref, s_ref = ssd_naive_ref(*(jnp.asarray(a) for a in (x, dt, A, B, C)),
                                 None)
    y, s = ssd_ops.ssd_scan(*(_t(a) for a in (x, dt, A, B, C)), 8, None)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), atol=SSD_ATOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), atol=SSD_ATOL)


def _ssd_recurrence_f64(x, dt, A, B, C, s0):
    """The scan token by token in float64: the exact answer the chunked
    algorithm rearranges (single group)."""
    s = s0.astype(np.float64)
    ys = []
    for i in range(x.shape[1]):
        s = (s * np.exp(dt[:, i] * A)[:, :, None, None]
             + (x[:, i] * dt[:, i][..., None])[..., None]
             * B[:, i, 0][:, None, None, :])
        ys.append(np.einsum("bn,bhpn->bhp", C[:, i, 0], s))
    return np.stack(ys, 1), s


def test_ssd_scan_accuracy_at_large_step_sums():
    """A-values of -1 to -16 (``init_mamba2``) and softplus step sizes put
    the in-chunk sums of dt * A near -3000 over a 256-token chunk.  Each
    decay exp(cum_i - cum_j) is formed from a float64 difference rounded
    once, so y stays within 2e-5 (|y| up to ~35) of the float64
    recurrence; float32 differences of the rounded sums miss by ~2.5e-4."""
    rng = np.random.default_rng(0)
    b, t, h, p, n = 1, 512, 4, 8, 8
    x = rng.standard_normal((b, t, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, t, h)))).astype(np.float32)
    A = -np.linspace(1.0, 16.0, h).astype(np.float32)
    B = rng.standard_normal((b, t, 1, n)).astype(np.float32)
    C = rng.standard_normal((b, t, 1, n)).astype(np.float32)
    s0 = (0.1 * rng.standard_normal((b, h, p, n))).astype(np.float32)
    y_gold, s_gold = _ssd_recurrence_f64(
        *(a.astype(np.float64) for a in (x, dt, A, B, C, s0)))
    assert np.abs(np.cumsum(dt[:, :256] * A, axis=1)).max() > 2000
    y, s = ssd_ops.ssd_scan(*(_t(a) for a in (x, dt, A, B, C)), 256, _t(s0))
    np.testing.assert_allclose(y.numpy(), y_gold, rtol=0, atol=2e-5)
    np.testing.assert_allclose(s.numpy(), s_gold, rtol=0, atol=1e-6)


def test_ssd_decode_step_matches_reference():
    x, dt, A, B, C, s0 = _ssd_inputs(2, 1, 4, 16, 2, 8, seed=4)
    ref_y, ref_s = jax_m2.ssd_decode_step(
        *(jnp.asarray(a) for a in (x[:, 0], dt[:, 0], A, B[:, 0], C[:, 0],
                                   s0)))
    y, s = m2.ssd_decode_step(*(_t(a) for a in (x[:, 0], dt[:, 0], A,
                                                B[:, 0], C[:, 0], s0)))
    np.testing.assert_allclose(y.numpy(), np.asarray(ref_y), atol=1e-5)
    np.testing.assert_allclose(s.numpy(), np.asarray(ref_s), atol=1e-5)


def test_scan_wrapper_refuses_other_devices_and_shapes():
    x, dt, A, B, C, _ = _ssd_inputs(1, 16, 2, 16, 1, 8)
    meta = [torch.empty(a.shape, device="meta") for a in (x, dt, A, B, C)]
    with pytest.raises(RuntimeError):
        ssd_ops.ssd_scan(*meta, 8)
    with pytest.raises(ValueError):
        ssd_ops.ssd_scan_ref(*(_t(a) for a in (x, dt, A, B, C)), 5)


# -- the mixer block and the model -------------------------------------------

def _scaled_close(lt, lj, atol=2e-3):
    lj = np.asarray(lj)
    scale = max(float(np.abs(lj).max()), 1.0)
    np.testing.assert_allclose(lt.numpy() / scale, lj / scale, atol=atol)


def test_mamba2_block_prefill_then_decode_matches_reference():
    cj, ct = jax_reduced("zamba2-7b"), reduced_config("zamba2-7b")
    tree = numpy_params(cj, seed=12)
    mixer = tree["segments"][0][0]["mixer"]
    pj = {k: jnp.asarray(v[0]) for k, v in mixer.items()}
    pt = {k: _t(v[0]) for k, v in mixer.items()}
    rng = np.random.default_rng(13)
    x = rng.standard_normal((2, 11, cj.d_model)).astype(np.float32)
    x1 = rng.standard_normal((2, 1, cj.d_model)).astype(np.float32)
    cache_j = jax_m2.init_mamba2_cache(cj, 2, jnp.float32)
    cache_t = m2.init_mamba2_cache(ct, 2, torch.float32, device="cpu")
    oj, cache_j = jax_m2.mamba2_block(pj, cj, jnp.asarray(x), cache_j)
    ot, out_cache = m2.mamba2_block(pt, ct, _t(x), cache_t)
    assert out_cache is cache_t                      # updated in place
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), atol=1e-4)
    for name in ("conv", "ssm"):
        np.testing.assert_allclose(cache_t[name].numpy(),
                                   np.asarray(cache_j[name]), atol=1e-4)
    oj, cache_j = jax_m2.mamba2_block(pj, cj, jnp.asarray(x1), cache_j)
    ot, _ = m2.mamba2_block(pt, ct, _t(x1), cache_t)
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), atol=1e-4)
    np.testing.assert_allclose(cache_t["ssm"].numpy(),
                               np.asarray(cache_j["ssm"]), atol=1e-4)
    # a decode row mask keeps the masked row's state as it was
    before = {n: t.clone() for n, t in cache_t.items()}
    m2.mamba2_block(pt, ct, _t(x1), cache_t,
                    valid_len=torch.tensor([1, 0]))
    assert torch.equal(cache_t["ssm"][1], before["ssm"][1])
    assert torch.equal(cache_t["conv"][1], before["conv"][1])
    assert not torch.equal(cache_t["ssm"][0], before["ssm"][0])
    with pytest.raises(NotImplementedError, match="padded prefill"):
        m2.mamba2_block(pt, ct, _t(x), cache_t,
                        valid_len=torch.tensor([11, 5]))


def test_chunk_rule_follows_the_reference(monkeypatch):
    """T <= ssm_chunk is one chunk of any length (215), longer T halves
    the chunk until it divides T (300 -> 4)."""
    cfg = reduced_config("mamba2-1.3b")
    p = tf.init_params(0, cfg, device="cpu")["layers"][0]["mixer"]
    seen = []
    real = ssd_ops.ssd_scan

    def spy(x, dt, A, B, C, chunk, init_state=None):
        seen.append((chunk, dt.dtype))
        return real(x, dt, A, B, C, chunk, init_state)

    monkeypatch.setattr(ssd_ops, "ssd_scan", spy)
    for T in (215, 300):
        m2.mamba2_block(p, cfg, torch.zeros((1, T, cfg.d_model)))
    assert [c for c, _ in seen] == [215, 4]
    assert seen[0][1] == torch.float32       # dt in the activation type


@pytest.mark.parametrize("arch", ["zamba2-7b", "mamba2-1.3b"])
def test_forward_matches_reference(arch):
    """Cache-free forward; then over a dense cache of two rows, a prefill
    chunk of the first row alone (the dense chunked-prefill path), a
    second chunk, and a decode step of both rows."""
    cj, ct = jax_reduced(arch), reduced_config(arch)
    pj, pt = both_params(cj, ct, seed=14)
    rng = np.random.default_rng(15)
    tokens = rng.integers(1, cj.vocab_size, size=(2, 20)).astype(np.int32)
    lj, _, _ = jax_tf.forward(pj, cj, jnp.asarray(tokens))
    lt, _, _ = tf.forward(pt, ct, _t(tokens))
    _scaled_close(lt, lj)
    cache_j = jax_tf.init_cache(cj, 2, 48)
    cache_t = tf.init_cache(ct, 2, 48, device="cpu")
    for s, e in ((0, 13), (13, 20)):
        pos = np.broadcast_to(np.arange(s, e, dtype=np.int32), (2, e - s))
        lj, cache_j, _ = jax_tf.forward(pj, cj, jnp.asarray(tokens[:, s:e]),
                                        jnp.asarray(pos), cache_j)
        lt, out, _ = tf.forward(pt, ct, _t(tokens[:, s:e]), _t(pos),
                                cache_t)
        assert out is cache_t
        _scaled_close(lt, lj)
    tok1 = rng.integers(1, cj.vocab_size, size=(2, 1)).astype(np.int32)
    p1 = np.full((2, 1), 20, np.int32)
    lj, cache_j, _ = jax_tf.forward(pj, cj, jnp.asarray(tok1),
                                    jnp.asarray(p1), cache_j)
    lt, _, _ = tf.forward(pt, ct, _t(tok1), _t(p1), cache_t)
    _scaled_close(lt, lj)
    np.testing.assert_array_equal(lt.numpy().argmax(-1),
                                  np.asarray(lj).argmax(-1))
    # the stacked caches hold the reference's per-layer leaves (states of
    # a few units after 21 tokens: relative 1e-4)
    seg = cache_j["segments"][0]
    state_i = 0
    for period in range(cj.segments()[0].n_periods):
        for pos_i, _ in enumerate(cj.segments()[0].pattern):
            ref = np.asarray(seg[pos_i]["ssm"][period])
            np.testing.assert_allclose(cache_t["ssm"][state_i].numpy(), ref,
                                       rtol=1e-4, atol=1e-4)
            state_i += 1


def test_convert_keeps_float32_mixer_leaves_in_a_bf16_model():
    cj = jax_reduced("zamba2-7b")
    cfg = dataclasses.replace(reduced_config("zamba2-7b"), dtype="bfloat16")
    pt = params_from_jax(numpy_params(cj, seed=1), cfg, device="cpu")
    mixer = pt["layers"][1]["mixer"]
    for name in ("A_log", "dt_bias", "D"):
        assert mixer[name].dtype == torch.float32
    assert mixer["in_proj"].dtype == torch.bfloat16
    assert pt["shared_attn"]["wq"].dtype == torch.bfloat16
    assert set(pt["layers"][1]) == {"ln1", "mixer", "ln2", "mlp", "ln_attn"}
    ref = tf.init_params(0, cfg, device="cpu")
    assert set(ref) == set(pt)
    assert ref["layers"][1]["mixer"]["A_log"].dtype == torch.float32


def test_zamba2_cache_shapes_at_full_width():
    """The dense cache at zamba2-7b's width, as a shape count (nothing is
    allocated): KV over the 13 shared-attention layers, f32 SSM state over
    all 81 recurrent layers."""
    cfg = get_config("zamba2-7b")
    cache = tf.init_cache(cfg, 2, 16, device="meta")
    assert tuple(cache["k"].shape) == (13, 2, 16, 32, 112)
    assert tuple(cache["ssm"].shape) == (81, 2, 112, 64, 64)
    assert cache["ssm"].dtype == torch.float32
    assert cache["conv"].dtype == torch.bfloat16
    assert [s for s in tf.cache_slots(cfg)[:6]] == [
        (None, 0), (None, 1), (None, 2), (None, 3), (None, 4), (0, 5)]


# -- the recurrent-state fault of the reference's dense decode ---------------

def _fault_run(executor, Req, Plan, cfg, prompts, co_decode: bool):
    """Request A (prompt 6) prefills alone, then request B prefills 8 + 1
    tokens; with ``co_decode`` A decodes beside both of B's chunks.
    Returns (B's first token, B's SSM state after its first chunk)."""
    a = Req(prompt_len=6, max_new_tokens=4, hidden_output_len=4,
            prompt_tokens=list(prompts[0]))
    b = Req(prompt_len=9, max_new_tokens=2, hidden_output_len=2,
            prompt_tokens=list(prompts[1]))

    def step(items, decodes):
        executor.execute(Plan(items, decodes))
        for r, take in items:
            r.prefill_pos += take

    executor.add_request(a)
    step([(a, 6)], [])
    executor.add_request(b)
    step([(b, 8)], [a] if co_decode else [])
    slot = executor.slots.slot(b.rid)
    ssm = executor.cache["segments"][0][0]["ssm"][:, slot] \
        if isinstance(executor.cache, dict) and "segments" in executor.cache \
        else executor.cache["ssm"][:, slot]
    state = np.array(ssm, np.float32)
    step([(b, 1)], [a] if co_decode else [])
    return b.output_tokens[0], state


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-7b"])
def test_recurrent_row_prefilled_beside_a_decode(arch):
    """B prefills 8 + 1 tokens while A decodes.  The port's first token for
    B is the cache-free forward's argmax, with or without the decode, and
    its state after B's first chunk does not depend on A's decode; the
    reference's dense decode advances B's state (the fault the port does
    not copy)."""
    cj, ct = jax_reduced(arch), reduced_config(arch)
    pj, pt = both_params(cj, ct, seed=17)
    rng = np.random.default_rng(18)
    prompts = [list(map(int, rng.integers(1, cj.vocab_size, size=n)))
               for n in (6, 9)]
    gold, _, _ = tf.forward(pt, ct, torch.tensor([prompts[1]]))
    gold = int(gold[0, -1].argmax())

    port = {}
    for co in (False, True):
        ex = TorchExecutor(ct, pt, 2, 64, device="cpu")
        port[co] = _fault_run(ex, Request, IterationPlan, ct, prompts, co)
    assert port[True][0] == port[False][0] == gold
    np.testing.assert_array_equal(port[True][1], port[False][1])

    ref = {}
    for co in (False, True):
        ex = JaxExecutor(cj, pj, 2, 64)
        ref[co] = _fault_run(ex, JaxRequest, JaxPlan, cj, prompts, co)
    assert ref[False][0] == gold
    assert np.abs(ref[True][1] - ref[False][1]).max() > 1e-2
