"""The port's model modules against the reference's, on the same
numpy-made inputs and weights, on the CPU (the kernels' plain versions
carry the paged read)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jax_reduced
from repro.models import attention as jax_attn
from repro.models import common as jax_common
from repro.models import transformer as jax_tf
from repro_torch.configs import get_config, reduced_config
from repro_torch.models import attention as attn
from repro_torch.models import common
from repro_torch.models import transformer as tf

from test_torch_helpers import both_params

# elementwise float32 functions: a few ulp between two math libraries
ELEMENTWISE_ATOL = 2e-6


def _t(a):
    return torch.from_numpy(np.array(a))


def test_rms_norm_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    w = (rng.standard_normal(64) * 0.1).astype(np.float32)
    ref = jax_common.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6)
    out = common.rms_norm(_t(x), _t(w), 1e-6)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                               atol=ELEMENTWISE_ATOL)


def test_apply_rope_matches_reference_half_split():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 4, 64)).astype(np.float32)
    pos = np.array([[0, 1, 2, 3, 4, 5, 6],
                    [90, 91, 92, 93, 94, 95, 96]], np.int32)
    ref = jax_common.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)
    out = common.apply_rope(_t(x), _t(pos), 1e6)
    # angles up to ~100 rad: sin/cos of two libraries agree to ~1e-5
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5)
    # precomputed tables give the same result
    out2 = common.apply_rope(_t(x), _t(pos), 1e6,
                             common.rope_tables(_t(pos), 64, 1e6))
    np.testing.assert_array_equal(out2.numpy(), out.numpy())


def test_mlp_matches_reference():
    rng = np.random.default_rng(2)
    p = {k: (rng.standard_normal(s) * 0.1).astype(np.float32)
         for k, s in (("w_gate", (32, 96)), ("w_up", (32, 96)),
                      ("w_down", (96, 32)))}
    x = rng.standard_normal((2, 3, 32)).astype(np.float32)
    ref = jax_common.mlp({k: jnp.asarray(v) for k, v in p.items()},
                         jnp.asarray(x))
    out = common.mlp({k: _t(v) for k, v in p.items()}, _t(x))
    # float32 matmuls of depth 96 summed in another order
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_quantize_int8_bit_equal():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 9, 2, 64)).astype(np.float32)
    x[0, 0] = 0.0                       # all-zero token: scale 1
    x[1, 1, 0, :4] = [0.5, 1.5, 2.5, -0.5]   # ties after scaling
    x[1, 1, 0, 4:] = 0.0
    x[1, 1, 0, 5] = 127.0               # amax 127 -> scale exactly 1
    qj, sj = jax_attn.quantize_int8(jnp.asarray(x))
    qt, st = attn.quantize_int8(_t(x))
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    assert st[0, 0, 0] == 1.0
    assert qt[1, 1, 0, :4].tolist() == [0, 2, 2, 0]   # half to even


@pytest.mark.parametrize("with_valid", [False, True])
def test_paged_write_bit_equal_and_padding_dropped(with_valid):
    rng = np.random.default_rng(4)
    bs, nblk, hkv, d = 16, 6, 2, 8
    P = bs * nblk
    ck = rng.standard_normal((P, hkv, d)).astype(np.float32)
    cv = rng.standard_normal((P, hkv, d)).astype(np.float32)
    B, T = 3, 8
    kn = rng.standard_normal((B, T, hkv, d)).astype(np.float32)
    vn = rng.standard_normal((B, T, hkv, d)).astype(np.float32)
    start = np.array([12, 0, 30], np.int32)
    pos = start[:, None] + np.arange(T, dtype=np.int32)[None]
    # row 1 has no second block; row 2's table is too narrow for pos >= 32
    tables = np.array([[4, 1], [2, -1], [5, 3]], np.int32)
    valid = np.array([8, 3, 0], np.int32) if with_valid else None
    rk, rv = jax_attn.paged_write(
        jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(kn), jnp.asarray(vn),
        jnp.asarray(pos), jnp.asarray(tables), bs,
        None if valid is None else jnp.asarray(valid))
    dump = np.zeros((1, hkv, d), np.float32)
    tk, tv = _t(np.concatenate([ck, dump])), _t(np.concatenate([cv, dump]))
    ok, ov = attn.paged_write(tk, tv, _t(kn), _t(vn), _t(pos), _t(tables),
                              bs, None if valid is None else _t(valid))
    assert ok is tk and ov is tv        # updated in place
    np.testing.assert_array_equal(tk[:P].numpy(), np.asarray(rk))
    np.testing.assert_array_equal(tv[:P].numpy(), np.asarray(rv))
    if with_valid:
        # row 2 is all padding: its blocks keep their old contents
        np.testing.assert_array_equal(tk[5 * bs:6 * bs].numpy(),
                                      ck[5 * bs:6 * bs])


def test_paged_gather_matches_reference():
    rng = np.random.default_rng(5)
    pool = rng.standard_normal((64, 2, 8)).astype(np.float32)
    tables = np.array([[3, 0, -1], [1, -1, -1]], np.int32)
    rd, rp = jax_attn.paged_gather(jnp.asarray(pool), jnp.asarray(tables), 16)
    td, tp = attn.paged_gather(_t(pool), _t(tables), 16)
    np.testing.assert_array_equal(td.numpy(), np.asarray(rd))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(rp))


def test_config_and_registry_match_reference():
    from repro.configs import get_config as jax_get, list_archs
    import dataclasses
    for name in list_archs():
        a, b = jax_get(name), get_config(name)
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert a.param_count() == b.param_count()
        assert a.kv_cache_bytes(2, 100) == b.kv_cache_bytes(2, 100)
        assert [dataclasses.astuple(s) for s in a.segments()] == \
            [dataclasses.astuple(s) for s in b.segments()]
    assert get_config("qwen2.5-3b").param_dtype == torch.bfloat16


@pytest.mark.parametrize("quant", [None, "int8"], ids=["fp", "int8"])
@pytest.mark.parametrize("arch", ["smollm-135m", "qwen3-14b", "qwen2.5-3b"])
def test_paged_forward_matches_reference(arch, quant):
    """A mixed chunk (full row, decode row, short row, padding row) and
    then a decode step over the same pool: logits to the scaled atol
    2e-3 that tests/test_kernel_integration.py holds the reference's own
    kernel path to, greedy tokens identical, pools equal."""
    cj, ct = jax_reduced(arch), reduced_config(arch)
    pj, pt = both_params(cj, ct, seed=7)
    rng = np.random.default_rng(8)
    bs, nblk = 16, 12
    pool_j = jax_tf.init_paged_cache(cj, nblk, bs, quant=quant)
    pool_t = tf.init_paged_cache(ct, nblk, bs, quant=quant, device="cpu")
    B, T = 4, 24
    tokens = rng.integers(1, cj.vocab_size, size=(B, T)).astype(np.int32)
    start = np.array([0, 16, 5, 0], np.int32)
    valid = np.array([24, 1, 17, 0], np.int32)
    tables = np.full((B, 4), -1, np.int32)
    tables[0, :2], tables[1, :2], tables[2, :2] = [3, 7], [1, 9], [0, 5]
    pos = start[:, None] + np.arange(T, dtype=np.int32)[None]

    def scaled_close(lt, lj):
        lj = np.asarray(lj)
        scale = max(float(np.abs(lj).max()), 1.0)
        np.testing.assert_allclose(lt.numpy() / scale, lj / scale,
                                   atol=2e-3)
        np.testing.assert_array_equal(lt.numpy().argmax(-1),
                                      lj.argmax(-1))

    lj, pool_j, _ = jax_tf.forward(
        pj, cj, jnp.asarray(tokens), jnp.asarray(pos), pool_j,
        valid_len=jnp.asarray(valid),
        block_tables=(jnp.asarray(tables), bs))
    lt, out_pool, _ = tf.forward(
        pt, ct, _t(tokens), _t(pos), pool_t, valid_len=_t(valid),
        block_tables=(_t(tables), bs))
    assert out_pool is pool_t           # updated in place
    for b in range(B):
        n = int(valid[b])
        if n:
            scaled_close(lt[b, :n], lj[b, :n])
    ref_pool = pool_j["segments"][0][0]
    for name, leaf in pool_t.items():
        ref = np.asarray(ref_pool[name])
        got = leaf[:, :-1].numpy()
        if quant and name in ("k", "v"):
            # a float32 difference of one ulp can flip a rounding tie
            assert (np.abs(got.astype(np.int32) - ref) <= 1).all()
            assert (got != ref).mean() < 1e-3
        else:
            np.testing.assert_allclose(got, ref, atol=1e-4)

    tok1 = rng.integers(1, cj.vocab_size, size=(B, 1)).astype(np.int32)
    p1 = (start + valid).astype(np.int32)[:, None]
    lj, _, _ = jax_tf.forward(pj, cj, jnp.asarray(tok1), jnp.asarray(p1),
                              pool_j, block_tables=(jnp.asarray(tables), bs))
    lt, _, _ = tf.forward(pt, ct, _t(tok1), _t(p1), pool_t,
                          block_tables=(_t(tables), bs))
    scaled_close(lt[:3], lj[:3])


def test_dense_cache_and_cache_free_forward_match_reference():
    cj, ct = jax_reduced("qwen2.5-3b"), reduced_config("qwen2.5-3b")
    pj, pt = both_params(cj, ct, seed=9)
    rng = np.random.default_rng(10)
    B, T, S = 2, 12, 32
    tokens = rng.integers(1, cj.vocab_size, size=(B, T)).astype(np.int32)
    lj, _, _ = jax_tf.forward(pj, cj, jnp.asarray(tokens))
    lt, none_cache, _ = tf.forward(pt, ct, _t(tokens))
    assert none_cache is None
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=2e-3)
    # chunked prefill + decode over a dense cache, second row padded
    cache_j = jax_tf.init_cache(cj, B, S)
    cache_t = tf.init_cache(ct, B, S, device="cpu")
    start = np.array([0, 0], np.int32)
    valid = np.array([12, 7], np.int32)
    pos = start[:, None] + np.arange(T, dtype=np.int32)[None]
    lj, cache_j, _ = jax_tf.forward(pj, cj, jnp.asarray(tokens),
                                    jnp.asarray(pos), cache_j,
                                    valid_len=jnp.asarray(valid))
    lt, _, _ = tf.forward(pt, ct, _t(tokens), _t(pos), cache_t,
                          valid_len=_t(valid))
    np.testing.assert_allclose(lt[0].numpy(), np.asarray(lj[0]), atol=2e-3)
    np.testing.assert_allclose(lt[1, :7].numpy(), np.asarray(lj[1, :7]),
                               atol=2e-3)
    np.testing.assert_allclose(
        cache_t["k"].numpy(),
        np.asarray(cache_j["segments"][0][0]["k"]), atol=1e-4)
    tok1 = rng.integers(1, cj.vocab_size, size=(B, 1)).astype(np.int32)
    lj, _ = jax_tf.decode_step(pj, cj, jnp.asarray(tok1), cache_j,
                               jnp.asarray(valid))
    lt, _ = tf.decode_step(pt, ct, _t(tok1), cache_t, _t(valid))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=2e-3)


@pytest.mark.parametrize("arch", ["whisper-base", "llava-next-34b"])
def test_unported_block_types_raise(arch):
    """The encoder-decoder blocks (whisper) and image inputs (llava's
    projector) raise and name the slice that brings them."""
    cfg = reduced_config(arch)
    with pytest.raises(NotImplementedError,
                       match="not in the port yet.*next slice"):
        params = tf.init_params(0, cfg, device="cpu")
        tokens = torch.ones((1, 4), dtype=torch.long)
        tf.forward(params, cfg, tokens, image_embeds=torch.zeros(
            (1, cfg.num_image_tokens, cfg.vision_dim)))


def test_hybrid_forward_matches_reference():
    """Reduced zamba2 (Mamba2 layers with a shared attention block every
    second layer), cache-free: logits to the scaled 2e-3 of the other
    forward tests, greedy tokens identical."""
    cj, ct = jax_reduced("zamba2-7b"), reduced_config("zamba2-7b")
    pj, pt = both_params(cj, ct, seed=19)
    tokens = np.random.default_rng(20).integers(
        1, cj.vocab_size, size=(2, 17)).astype(np.int32)
    lj, _, _ = jax_tf.forward(pj, cj, jnp.asarray(tokens))
    lt, _, _ = tf.forward(pt, ct, _t(tokens))
    lj = np.asarray(lj)
    scale = max(float(np.abs(lj).max()), 1.0)
    np.testing.assert_allclose(lt.numpy() / scale, lj / scale, atol=2e-3)
    np.testing.assert_array_equal(lt.numpy().argmax(-1), lj.argmax(-1))


def test_init_params_is_seeded_and_shaped():
    cfg = reduced_config("qwen2.5-3b")
    a = tf.init_params(3, cfg, device="cpu")
    b = tf.init_params(3, cfg, device="cpu")
    c = tf.init_params(4, cfg, device="cpu")
    assert len(a["layers"]) == cfg.num_layers
    assert torch.equal(a["layers"][1]["attn"]["wq"],
                       b["layers"][1]["attn"]["wq"])
    assert not torch.equal(a["embed"], c["embed"])
    assert a["layers"][0]["attn"]["bq"].shape == (4 * 64,)
    n = sum(t.numel() for t in [a["embed"], a["lm_head"], a["final_norm"]])
    n += sum(t.numel() for blk in a["layers"]
             for sub in blk.values()
             for t in (sub.values() if isinstance(sub, dict) else [sub]))
    # param_count() leaves out norm gains and biases
    extra = cfg.d_model * (2 * cfg.num_layers + 1) \
        + cfg.num_layers * (4 + 2 + 2) * 64
    assert n == cfg.param_count() + extra
