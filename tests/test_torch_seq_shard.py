"""Kernels 3 and 4 over a cache split along its slot axis: the plain
versions' log-sum-exp form on each slot shard, with the shard's local
lengths (kernel 3) or the chunk's offset less the shard's first slot
(kernel 4, negative or past the shard), combined by the port's
``combine_stacked`` (the one-process form of the all-reduce combine the
sharded model runs), against the whole call and the reference's oracles.
numpy-seeded float32 inputs; head dims 64 and 128; 1, 5 and 8 query
heads a KV head."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.chunked_prefill_attention.ref import \
    chunked_prefill_attention_ref as jax_prefill_ref
from repro.kernels.decode_attention.ref import \
    decode_attention_ref as jax_decode_ref
from repro_torch.kernels.chunked_prefill_attention.ops import (
    chunked_prefill_attention, chunked_prefill_attention_ref)
from repro_torch.kernels.decode_attention.ops import (
    decode_attention, decode_attention_ref)
from repro_torch.kernels.paged_args import NEG_INF
from repro_torch.models.attention import combine_partials, combine_stacked

S, HKV = 64, 2
DIMS = [64, 128]
GROUPS = [1, 5, 8]
SHARDS = [2, 4]
# rows: no key, a length that ends inside the first shard (of 4 and of
# 2), the whole cache, one inside a middle shard
LENGTHS = [0, 5, S, 37]
# kernel 4: a 16-token chunk at 24; on 4 shards of 16 slots its offset
# there is 24, 8, -8 and -24, on 2 shards of 32 it is 24 and -8
TQ, PREFIX = 16, 24
# float32 sums in another order (the combine's rescaling, the split sums)
TOL_WHOLE = 1e-6
TOL_REF = 1e-5


def _inputs(d, g, seed, tq=None):
    rng = np.random.default_rng(seed)
    B = len(LENGTHS)
    qshape = (B, HKV * g, d) if tq is None else (B, tq, HKV * g, d)
    q = rng.standard_normal(qshape).astype(np.float32)
    k = rng.standard_normal((B, S, HKV, d)).astype(np.float32)
    v = rng.standard_normal((B, S, HKV, d)).astype(np.float32)
    return q, k, v


def _decode_shards(q, k, v, lengths, n):
    sr = S // n
    outs, lses = [], []
    for i in range(n):
        off = i * sr
        loc = torch.clamp(lengths - off, 0, sr).to(torch.int32)
        o, lse = decode_attention(q, k[:, off:off + sr], v[:, off:off + sr],
                                  loc, return_lse=True)
        outs.append(o)
        lses.append(lse)
    return combine_stacked(torch.stack(outs), torch.stack(lses))


def _prefill_shards(q, k, v, n):
    sr = S // n
    outs, lses = [], []
    for i in range(n):
        off = i * sr
        o, lse = chunked_prefill_attention(
            q, k[:, off:off + sr], v[:, off:off + sr], PREFIX - off,
            return_lse=True)
        outs.append(o)
        lses.append(lse)
    return combine_stacked(torch.stack(outs), torch.stack(lses))


@pytest.mark.parametrize("n", SHARDS)
@pytest.mark.parametrize("g", GROUPS)
@pytest.mark.parametrize("d", DIMS)
def test_decode_slot_shards_combine_to_the_whole_call(d, g, n):
    q, k, v = (torch.from_numpy(x) for x in _inputs(d, g, 100 + d + g))
    lengths = torch.tensor(LENGTHS, dtype=torch.int32)
    got = _decode_shards(q, k, v, lengths, n)
    whole = decode_attention(q, k, v, lengths)
    assert got.shape == whole.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), whole.numpy(), atol=TOL_WHOLE,
                               rtol=0)
    # the row with no key, on every shard, comes out zero
    assert not got[0].any()
    # the reference's oracle (NaN for a row with no key: rows with keys)
    ref = np.asarray(jax_decode_ref(jnp.asarray(q.numpy()),
                                    jnp.asarray(k.numpy()),
                                    jnp.asarray(v.numpy()),
                                    jnp.asarray(lengths.numpy())))
    np.testing.assert_allclose(got.numpy()[1:], ref[1:], atol=TOL_REF,
                               rtol=0)


@pytest.mark.parametrize("n", SHARDS)
@pytest.mark.parametrize("g", GROUPS)
@pytest.mark.parametrize("d", DIMS)
def test_prefill_slot_shards_combine_to_the_whole_call(d, g, n):
    q, k, v = (torch.from_numpy(x)
               for x in _inputs(d, g, 200 + d + g, tq=TQ))
    got = _prefill_shards(q, k, v, n)
    whole = chunked_prefill_attention(q, k, v, PREFIX)
    assert got.shape == whole.shape == q.shape
    np.testing.assert_allclose(got.numpy(), whole.numpy(), atol=TOL_WHOLE,
                               rtol=0)
    ref = np.asarray(jax_prefill_ref(jnp.asarray(q.numpy()),
                                     jnp.asarray(k.numpy()),
                                     jnp.asarray(v.numpy()), PREFIX))
    np.testing.assert_allclose(got.numpy(), ref, atol=TOL_REF, rtol=0)


def _masked_scores_lse(q, k, mask):
    """torch.logsumexp of the scores [B, Hq, ..., S] the mask keeps; -1e30
    where it keeps none."""
    s = torch.einsum("b...hd,bshd->bh...s",
                     q, k.repeat_interleave(q.shape[-2] // k.shape[2], 2))
    s = s * q.shape[-1] ** -0.5
    lse = torch.logsumexp(s.masked_fill(~mask, float("-inf")), dim=-1)
    return torch.where(torch.isfinite(lse), lse, torch.full((), NEG_INF))


@pytest.mark.parametrize("g", GROUPS)
@pytest.mark.parametrize("d", DIMS)
def test_lse_is_the_logsumexp_of_the_masked_scores(d, g):
    q, k, v = (torch.from_numpy(x) for x in _inputs(d, g, 300 + d + g))
    lengths = torch.tensor(LENGTHS, dtype=torch.int32)
    o, lse = decode_attention_ref(q, k, v, lengths, return_lse=True)
    torch.testing.assert_close(o, decode_attention_ref(q, k, v, lengths),
                               rtol=0, atol=0)
    mask = (torch.arange(S)[None, :] < lengths[:, None].long())[:, None, :]
    want = _masked_scores_lse(q, k, mask)
    assert lse.shape == (len(LENGTHS), HKV * g) and lse.dtype == torch.float32
    assert lse[0].eq(NEG_INF).all()
    np.testing.assert_allclose(lse.numpy(), want.numpy(), atol=1e-5, rtol=0)

    qt, kt, vt = (torch.from_numpy(x)
                  for x in _inputs(d, g, 400 + d + g, tq=TQ))
    # a negative offset leaves the chunk's first 8 tokens without a key
    for prefix in (PREFIX, -8):
        o, lse = chunked_prefill_attention_ref(qt, kt, vt, prefix,
                                               return_lse=True)
        torch.testing.assert_close(
            o, chunked_prefill_attention_ref(qt, kt, vt, prefix), rtol=0,
            atol=0)
        kpos = torch.arange(S)[None, :]
        qpos = prefix + torch.arange(TQ)[:, None]
        mask = ((kpos <= qpos) & (kpos < prefix + TQ))[None, None]
        want = _masked_scores_lse(qt, kt, mask).permute(0, 2, 1)
        assert lse.shape == (len(LENGTHS), TQ, HKV * g)
        np.testing.assert_allclose(lse.numpy(), want.numpy(), atol=1e-5,
                                   rtol=0)
        if prefix < 0:
            assert lse[:, :-prefix].eq(NEG_INF).all()
            assert not o[:, :-prefix].any()


def test_combine_without_a_group_is_the_partial_itself():
    """One rank (no process group): the partial comes back, bit for bit
    in bf16, and a row with no key stays zero."""
    rng = np.random.default_rng(5)
    o = torch.from_numpy(rng.standard_normal((3, 4, 64)).astype(np.float32))
    lse = torch.from_numpy(rng.standard_normal((3, 4)).astype(np.float32))
    o[1] = 0
    lse[1] = NEG_INF
    for dt in (torch.float32, torch.bfloat16):
        got = combine_partials(o.to(dt), lse)
        assert got.dtype == dt
        assert torch.equal(got, o.to(dt))
