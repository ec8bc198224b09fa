"""Plain PyTorch versions of the port's two paged-attention kernels
against the reference's Pallas kernels run in interpret mode, on the same
numpy-made inputs.  float32 everywhere; atol 1e-4 (sums in another
order, exp of another library), the bound ``tests/test_kernels.py``
holds the reference's own kernels to."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.chunked_prefill_attention.ops import (
    paged_chunked_prefill_attention as jax_prefill)
from repro.kernels.decode_attention.ops import (
    paged_decode_attention as jax_decode)
from repro.models.attention import quantize_int8 as jax_quantize
from repro_torch.kernels.chunked_prefill_attention.ops import (
    paged_chunked_prefill_attention, paged_chunked_prefill_attention_ref)
from repro_torch.kernels.decode_attention.ops import (
    paged_decode_attention, paged_decode_attention_ref)
from test_torch_helpers import cap_threads

cap_threads()

ATOL = 1e-4
BS, NBLK, D = 16, 24, 64


def _pools(seed, hkv, quant):
    rng = np.random.default_rng(seed)
    k = rng.normal(size=(NBLK * BS, hkv, D)).astype(np.float32)
    v = rng.normal(size=(NBLK * BS, hkv, D)).astype(np.float32)
    if not quant:
        return k, v, None, None
    kq, ks = jax_quantize(jnp.asarray(k))
    vq, vs = jax_quantize(jnp.asarray(v))
    return (np.asarray(kq), np.asarray(vq), np.asarray(ks), np.asarray(vs))


def _rand_tables(rng, lengths, width):
    tables = np.full((len(lengths), width), -1, np.int32)
    pool = list(range(NBLK))
    rng.shuffle(pool)
    for b, ln in enumerate(lengths):
        nb = -(-int(ln) // BS)
        tables[b, :nb] = [pool.pop() for _ in range(nb)]
    return tables


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _with_dump_row(a):
    """The port's pools carry one spare row past P; the kernels' plain
    versions must ignore it, so fill it with NaN."""
    if a is None:
        return None
    pad = np.full((1,) + a.shape[1:], np.nan if a.dtype.kind == "f" else 77,
                  a.dtype)
    return np.concatenate([a, pad], axis=0)


DECODE_CASES = {
    # the reference test's own case (tests/test_paged.py)
    "reference_case": dict(lengths=[37, 5, 160], hq=8, hkv=2, width=11),
    "block_boundaries": dict(lengths=[16, 32, 1, 48], hq=8, hkv=2, width=4),
    "off_boundaries": dict(lengths=[17, 31, 2, 47], hq=8, hkv=2, width=8),
    "g1": dict(lengths=[37, 5, 90], hq=2, hkv=2, width=8),
    "g3": dict(lengths=[37, 5, 90], hq=9, hkv=3, width=8),
    "g8": dict(lengths=[60, 7, 100], hq=8, hkv=1, width=8),
    "empty_row": dict(lengths=[0, 20], hq=8, hkv=2, width=4),
}


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_paged_decode_plain_matches_pallas(case, quant):
    c = DECODE_CASES[case]
    rng = np.random.default_rng(1)
    k, v, ks, vs = _pools(0, c["hkv"], quant)
    lengths = np.array(c["lengths"], np.int32)
    tables = _rand_tables(rng, lengths, c["width"])
    q = rng.normal(size=(len(lengths), c["hq"], D)).astype(np.float32)
    ref = jax_decode(_j(q), _j(k), _j(v), _j(tables), _j(lengths),
                     block_size=BS, k_scale=_j(ks), v_scale=_j(vs),
                     interpret=True)
    args = (_t(q), _t(_with_dump_row(k)), _t(_with_dump_row(v)),
            _t(tables), _t(lengths))
    kw = dict(block_size=BS, k_scale=_t(_with_dump_row(ks)),
              v_scale=_t(_with_dump_row(vs)))
    out = paged_decode_attention_ref(*args, **kw)
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)
    # on a CPU tensor the wrapper takes the plain version, and counts no
    # kernel launch
    before = paged_decode_attention.launches
    np.testing.assert_array_equal(
        paged_decode_attention(*args, **kw).numpy(), out.numpy())
    assert paged_decode_attention.launches == before


PREFILL_CASES = {
    # the reference test's own case: real chunk, short chunk, decode row
    "reference_case": dict(starts=[10, 0, 36], valids=[8, 5, 1], tq=8,
                           hq=8, hkv=2, width=9),
    "padding_and_decode_rows": dict(starts=[0, 40, 0, 63],
                                    valids=[0, 1, 16, 1], tq=16, hq=8,
                                    hkv=2, width=8),
    "block_boundaries": dict(starts=[16, 0, 32], valids=[16, 32, 16],
                             tq=32, hq=8, hkv=2, width=4),
    "off_boundaries": dict(starts=[15, 1, 33], valids=[18, 30, 13],
                           tq=32, hq=8, hkv=2, width=8),
    "g1": dict(starts=[10, 0, 36], valids=[8, 5, 1], tq=8, hq=2, hkv=2,
               width=8),
    "g3": dict(starts=[10, 0, 36], valids=[8, 5, 1], tq=8, hq=9, hkv=3,
               width=8),
    "g8": dict(starts=[10, 0, 36], valids=[8, 5, 1], tq=8, hq=8, hkv=1,
               width=8),
}


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("case", sorted(PREFILL_CASES))
def test_paged_prefill_plain_matches_pallas(case, quant):
    c = PREFILL_CASES[case]
    rng = np.random.default_rng(2)
    k, v, ks, vs = _pools(0, c["hkv"], quant)
    starts = np.array(c["starts"], np.int32)
    valids = np.array(c["valids"], np.int32)
    tables = _rand_tables(rng, starts + valids, c["width"])
    q = rng.normal(size=(len(starts), c["tq"], c["hq"], D)) \
        .astype(np.float32)
    ref = np.asarray(jax_prefill(
        _j(q), _j(k), _j(v), _j(tables), _j(starts), _j(valids),
        block_size=BS, k_scale=_j(ks), v_scale=_j(vs), interpret=True))
    args = (_t(q), _t(_with_dump_row(k)), _t(_with_dump_row(v)),
            _t(tables), _t(starts), _t(valids))
    kw = dict(block_size=BS, k_scale=_t(_with_dump_row(ks)),
              v_scale=_t(_with_dump_row(vs)))
    out = paged_chunked_prefill_attention_ref(*args, **kw)
    assert torch.isfinite(out).all()
    for b in range(len(starts)):
        n = int(valids[b])            # tokens past valid: caller drops
        np.testing.assert_allclose(out[b, :n].numpy(), ref[b, :n],
                                   atol=ATOL)
        if n == 0 and starts[b] == 0:
            assert not out[b].any()   # a padding row comes out zero
    before = paged_chunked_prefill_attention.launches
    np.testing.assert_array_equal(
        paged_chunked_prefill_attention(*args, **kw).numpy(), out.numpy())
    assert paged_chunked_prefill_attention.launches == before


def test_negative_table_entries_are_clamped_not_read():
    """-1 entries inside the attended range are clamped like the
    reference's wrapper clamps them (block 0), never an index error."""
    rng = np.random.default_rng(3)
    k, v, _, _ = _pools(0, 2, False)
    lengths = np.array([40], np.int32)
    tables = np.array([[5, -1, 7, -1]], np.int32)
    q = rng.normal(size=(1, 8, D)).astype(np.float32)
    ref = jax_decode(_j(q), _j(k), _j(v), _j(tables), _j(lengths),
                     block_size=BS, interpret=True)
    out = paged_decode_attention_ref(_t(q), _t(k), _t(v), _t(tables),
                                     _t(lengths), block_size=BS)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)
