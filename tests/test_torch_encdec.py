"""The encoder-decoder (whisper-base) and VLM (llava-next-34b) paths of
the port against the reference's, on reduced float32 configs, the same
numpy-made weights (converted, not re-drawn) and numpy-made audio and
image embeddings, on the CPU (the dense kernels' plain versions carry the
cached self-attention)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jax_reduced
from repro.models import attention as jax_attn
from repro.models import transformer as jax_tf
from repro_torch.configs import reduced_config
from repro_torch.models import attention as attn
from repro_torch.models import transformer as tf

from test_torch_helpers import cap_threads, both_params, scaled_err

cap_threads()

# logits: the tolerance of tests/test_torch_models.py's model tests
ATOL = 2e-3
ARCHS = ["whisper-base", "llava-next-34b"]
FRAMES = 24          # audio frames (after the stubbed front end)


def _t(a):
    return torch.from_numpy(np.array(a))


def _setup(arch, seed):
    cj, ct = jax_reduced(arch), reduced_config(arch)
    pj, pt = both_params(cj, ct, seed=seed)
    return cj, ct, pj, pt


def _embeds(cfg, B, seed):
    """{"audio_embeds": [B, FRAMES, d]} or {"image_embeds": [B, S_img,
    vision_dim]}, numpy from ``seed``, as (reference kwargs, port
    kwargs)."""
    rng = np.random.default_rng(seed)
    if cfg.family == "audio":
        name, shape = "audio_embeds", (B, FRAMES, cfg.d_model)
    else:
        name, shape = "image_embeds", (B, cfg.num_image_tokens,
                                       cfg.vision_dim)
    a = rng.standard_normal(shape).astype(np.float32)
    return {name: jnp.asarray(a)}, {name: _t(a)}


def _close(got, ref, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               atol=atol)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_with_modality_embeds_matches_reference(arch):
    """Cache-free forward (the training path): whisper's encoder over the
    audio and every decoder layer's cross-attention, llava's projected
    image tokens ahead of the text (logits over both)."""
    cj, ct, pj, pt = _setup(arch, 31)
    B, T = 2, 10
    tokens = np.random.default_rng(32).integers(
        1, cj.vocab_size, size=(B, T)).astype(np.int32)
    ej, et = _embeds(cj, B, 33)
    lj, _, aux_j = jax_tf.forward(pj, cj, jnp.asarray(tokens), **ej)
    lt, none_cache, aux_t = tf.forward(pt, ct, _t(tokens), **et)
    assert none_cache is None
    assert lt.shape == lj.shape
    if arch == "llava-next-34b":
        assert lt.shape[1] == cj.num_image_tokens + T
    _close(lt, lj)
    np.testing.assert_array_equal(lt.numpy().argmax(-1),
                                  np.asarray(lj).argmax(-1))
    assert float(aux_t) == float(aux_j) == 0.0


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_through_the_caches(arch):
    """A prefill that carries the embeddings, a second text chunk without
    them (whisper: through the cross cache alone), then 4 decode steps:
    logits at every step and the caches (self KV and, for whisper, the
    cross KV) against the reference's."""
    cj, ct, pj, pt = _setup(arch, 41)
    B, S = 2, 64
    rng = np.random.default_rng(42)
    ej, et = _embeds(cj, B, 43)
    cross = FRAMES if cj.family == "audio" else 0
    cache_j = jax_tf.init_cache(cj, B, S, cross_len=cross)
    cache_t = tf.init_cache(ct, B, S, device="cpu", cross_len=cross)
    if cross:
        assert cache_t["ck"].shape == (cj.num_layers, B, FRAMES,
                                       cj.num_kv_heads, cj.head_dim)
    n_img = cj.num_image_tokens if cj.family == "vlm" else 0
    t1 = rng.integers(1, cj.vocab_size, size=(B, 6)).astype(np.int32)
    t2 = rng.integers(1, cj.vocab_size, size=(B, 5)).astype(np.int32)
    start = np.zeros(B, np.int32)
    lj, cache_j = jax_tf.prefill(pj, cj, jnp.asarray(t1), cache_j,
                                 jnp.asarray(start), **ej)
    lt, out = tf.prefill(pt, ct, _t(t1), cache_t, _t(start), **et)
    assert out is cache_t               # updated in place
    _close(lt, lj)
    pos = start + n_img + 6
    lj, cache_j = jax_tf.prefill(pj, cj, jnp.asarray(t2), cache_j,
                                 jnp.asarray(pos))
    lt, _ = tf.prefill(pt, ct, _t(t2), cache_t, _t(pos))
    _close(lt, lj)
    pos = pos + 5
    tok = np.asarray(lj).argmax(-1).astype(np.int32)
    for _ in range(4):
        lj, cache_j = jax_tf.decode_step(pj, cj, jnp.asarray(tok[:, None]),
                                         cache_j, jnp.asarray(pos))
        lt, _ = tf.decode_step(pt, ct, _t(tok[:, None]), cache_t, _t(pos))
        _close(lt, lj)
        np.testing.assert_array_equal(lt.numpy().argmax(-1),
                                      np.asarray(lj).argmax(-1))
        tok = np.asarray(lj).argmax(-1).astype(np.int32)
        pos = pos + 1
    # float32 values to some tens (the random encoder's output grows over
    # its layers): within 1e-4 of the largest, the absolute tolerance of
    # the caches in tests/test_torch_models.py
    ref = cache_j["segments"][-1][0]
    for name in ("k", "ck", "cv") if cross else ("k",):
        assert scaled_err(cache_t[name].numpy(), ref[name]) <= 1e-4, name


@pytest.mark.parametrize("arch", ARCHS)
def test_full_prefill_matches_reference(arch):
    """The prompt prefilled in chunks of 8, the first carrying the
    embeddings, against the reference's scan, and against one-shot
    prefill of the same prompt."""
    cj, ct, pj, pt = _setup(arch, 51)
    B, S, C = 2, 24, 8
    tokens = np.random.default_rng(52).integers(
        1, cj.vocab_size, size=(B, S)).astype(np.int32)
    ej, et = _embeds(cj, B, 53)
    cross = FRAMES if cj.family == "audio" else 0
    lj, _ = jax_tf.full_prefill(pj, cj, jnp.asarray(tokens),
                                jax_tf.init_cache(cj, B, 64,
                                                  cross_len=cross),
                                C, **ej)
    cache = tf.init_cache(ct, B, 64, device="cpu", cross_len=cross)
    lt, out = tf.full_prefill(pt, ct, _t(tokens), cache, C, **et)
    assert out is cache
    _close(lt, lj)
    one, _ = tf.prefill(pt, ct, _t(tokens),
                        tf.init_cache(ct, B, 64, device="cpu",
                                      cross_len=cross),
                        torch.zeros(B, dtype=torch.long), **et)
    np.testing.assert_allclose(lt.numpy(), one.numpy(), atol=1e-4)
    with pytest.raises(ValueError, match="does not divide"):
        tf.full_prefill(pt, ct, _t(tokens[:, :20]), cache, C, **et)


def _cross_inputs(seed, S, with_valid):
    cj, ct = jax_reduced("whisper-base"), reduced_config("whisper-base")
    _, pt = both_params(cj, ct, seed=seed)
    xp = pt["layers"][-1]["xattn"]
    rng = np.random.default_rng(seed + 1)
    B, T = 2, 5
    x = rng.standard_normal((B, T, cj.d_model)).astype(np.float32)
    enc = rng.standard_normal((B, S, cj.d_model)).astype(np.float32)
    valid = None
    if with_valid:
        valid = np.arange(S)[None, :] < np.array([[S], [S // 2]])
    xj = {k: jnp.asarray(v.numpy()) for k, v in xp.items()}
    return cj, ct, xp, xj, x, enc, valid


@pytest.mark.parametrize("with_valid", [False, True],
                         ids=["all_keys", "kv_valid"])
def test_cross_attention_and_project_cross_kv_match_reference(with_valid):
    cj, ct, xp, xj, x, enc, valid = _cross_inputs(61, 12, with_valid)
    kvj = jax_attn.project_cross_kv(xj, cj, jnp.asarray(enc))
    kvt = attn.project_cross_kv(xp, ct, _t(enc))
    for n in ("k", "v"):
        assert kvt[n].shape == (2, 12, cj.num_kv_heads, cj.head_dim)
        _close(kvt[n], kvj[n], atol=1e-5)
    oj = jax_attn.cross_attention(
        xj, cj, jnp.asarray(x), kvj,
        None if valid is None else jnp.asarray(valid))
    ot = attn.cross_attention(xp, ct, _t(x), kvt,
                              None if valid is None else _t(valid))
    _close(ot, oj, atol=1e-5)


def test_cross_attention_over_zero_keys_is_zero_and_finite():
    """A cross cache nothing has written (cross_len 0, the text-only
    decoder) gives zero, never NaN, as the reference does."""
    cj, ct, xp, xj, x, enc, _ = _cross_inputs(71, 0, False)
    kvt = attn.project_cross_kv(xp, ct, _t(enc))
    ot = attn.cross_attention(xp, ct, _t(x), kvt)
    oj = jax_attn.cross_attention(
        xj, cj, jnp.asarray(x),
        jax_attn.project_cross_kv(xj, cj, jnp.asarray(enc)))
    assert torch.isfinite(ot).all()
    assert not ot.any()
    np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))


def test_decoder_without_audio_or_cross_cache_raises():
    ct = reduced_config("whisper-base")
    params = tf.init_params(0, ct, device="cpu")
    with pytest.raises(ValueError, match="audio_embeds or a cache"):
        tf.forward(params, ct, torch.ones((1, 4), dtype=torch.long))


@pytest.mark.parametrize("arch", ARCHS)
def test_executor_refuses_audio_and_vlm(arch):
    """The executor serves both families text-only, as the reference's
    does: whisper on the dense path over a cross cache of 0 keys, llava on
    the paged pool (``tests/test_torch_family_serving.py`` holds their
    tokens).  What it refuses is a migrated state of the other family's
    kind: a dense row for llava's pool, pool blocks for whisper's rows."""
    from repro_torch.engine.engine import MigrationFormatError, TorchExecutor
    from repro_torch.engine.request import Request
    ct = reduced_config(arch)
    ex = TorchExecutor(ct, tf.init_params(0, ct, device="cpu"), n_slots=2,
                       max_seq=64, device="cpu")
    assert ex.paged == (arch == "llava-next-34b")
    if not ex.paged:
        assert tuple(ex.cache["cv"].shape[:3]) == (ct.num_layers, 2, 0)
    req = Request(prompt_len=4, max_new_tokens=2, prompt_tokens=[1, 2, 3, 4])
    other = ({"row": {}} if ex.paged else
             {"paged_blocks": {}, "n_blocks": 1})
    with pytest.raises(MigrationFormatError):
        ex.insert_state(req, {**other, "pos": 4, "last_token": 0})
