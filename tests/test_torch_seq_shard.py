"""Kernels 3 and 4 over a cache split along its slot axis: the plain
versions' log-sum-exp form on each slot shard, with the shard's local
lengths (kernel 3) or the chunk's offset less the shard's first slot
(kernel 4, negative or past the shard), combined by the port's
``combine_stacked`` (the one-process form of the all-reduce combine the
sharded model runs), against the whole call and the reference's oracles.
numpy-seeded float32 inputs; head dims 64 and 128; 1, 5 and 8 query
heads a KV head.

Then the two reads of a slot-split cache that no kernel computes, the
sliding-window ring and the T-padded dense chunk: the masked partial
softmax they take on each slot shard, and ``self_attention`` on a cache
split over 2 and 4 gloo processes (in subprocesses) against the
unsharded port and the reference's ``self_attention``, with the read's
collectives counted."""
import dataclasses
import os
import socket
import subprocess
import sys
import tempfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jax_reduced
from repro.models import attention as jax_attn
from repro.kernels.chunked_prefill_attention.ref import \
    chunked_prefill_attention_ref as jax_prefill_ref
from repro.kernels.decode_attention.ref import \
    decode_attention_ref as jax_decode_ref
from repro_torch.kernels.chunked_prefill_attention.ops import (
    chunked_prefill_attention, chunked_prefill_attention_ref)
from repro_torch.kernels.decode_attention.ops import (
    decode_attention, decode_attention_ref)
from repro_torch.configs import reduced_config
from repro_torch.kernels.paged_args import NEG_INF, masked_softmax
from repro_torch.models import attention as attn
from repro_torch.models.attention import combine_partials, combine_stacked

ROOT = os.path.join(os.path.dirname(__file__), "..")

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


# ---------------------------------------------------------------------------
# the masked partial, and the two reads it serves on a slot-split cache:
# the sliding-window ring and the T-padded dense chunk
# ---------------------------------------------------------------------------

def _partial_inputs(seed, B=3, T=5, S=24, g=4, d=32):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((B, T, HKV * g, d))
                         .astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((B, S, HKV, d))
                             .astype(np.float32)) for _ in range(2))
    mask = torch.from_numpy(rng.random((B, 1, 1, T, S)) < 0.5)
    mask[0, ..., 2, :] = False          # a query with no key
    return q, k, v, mask


def test_masked_partial_lse_is_the_logsumexp_of_the_masked_scores():
    """``_masked_partial``: o the masked softmax's (bit for bit), lse the
    log-sum-exp of the scores the mask keeps; a query with no key, and a
    piece with no key at all, give lse -1e30 and o zero; two pieces
    combined give the whole."""
    q, k, v, mask = _partial_inputs(500)
    o, lse = attn._masked_partial(q, k, v, mask)
    probs = masked_softmax(attn._gqa_scores(q, k), mask)
    want_o = torch.einsum("bkgts,bskd->btkgd", probs, v).flatten(2, 3)
    assert o.shape == q.shape and lse.shape == q.shape[:3]
    assert lse.dtype == torch.float32
    assert torch.equal(o, want_o)
    want = _masked_scores_lse(q, k, mask[:, 0]).permute(0, 2, 1)
    np.testing.assert_allclose(lse.numpy(), want.numpy(), atol=1e-5, rtol=0)
    assert lse[0, 2].eq(NEG_INF).all() and not o[0, 2].any()

    o0, lse0 = attn._masked_partial(q, k, v, torch.zeros_like(mask))
    assert lse0.eq(NEG_INF).all() and not o0.any()
    for dt in (torch.float32, torch.bfloat16):
        # q and the keys in bf16: o in q's type, lse float32
        o_dt, lse_dt = attn._masked_partial(q.to(dt), k.to(dt), v.to(dt),
                                            mask)
        assert o_dt.dtype == dt and lse_dt.dtype == torch.float32

    h = k.shape[1] // 2
    pieces = [attn._masked_partial(q, k[:, sl], v[:, sl], mask[..., sl])
              for sl in (slice(0, h), slice(h, None))]
    got = combine_stacked(torch.stack([p[0] for p in pieces]),
                          torch.stack([p[1] for p in pieces]))
    np.testing.assert_allclose(got.numpy(), o.numpy(), atol=TOL_WHOLE,
                               rtol=0)


# the reads through ``self_attention`` on one layer: float32, 4 query
# heads over 2 KV heads of 16, a model width of 64; two rows
RD, RHQ, RHKV, RDH, RB = 64, 4, 2, 16, 2
#: name -> (slots, window, chunk length, rows' first positions, valid_len)
READS = {
    # a ring not yet full (row 0) and one wrapped (row 1), one token
    "ring_decode": (16, 16, 1, (5, 40), None),
    # a chunk longer than the ring: it reads the prior ring and itself,
    # then writes its last 16 tokens
    "ring_wrap": (16, 16, 20, (3, 37), None),
    # a chunk across the ring's end, shorter than the ring
    "ring_chunk": (16, 16, 6, (13, 29), None),
    # rows of unequal offsets padded to one length (the dense cache)
    "padded": (64, 0, 8, (10, 40), (8, 3)),
}
READ_MESHES = [(2, 2), (1, 4)]

_READ_WORKER = r"""
import dataclasses, sys, numpy as np, torch, torch.distributed as dist
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.analysis.roofline import CollectiveCounter
from repro_torch.configs import reduced_config
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import attention as attn

rank, port, data = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=4)
try:
    inp = dict(np.load(data + "/inputs.npz"))
    cfg = dataclasses.replace(reduced_config("gemma3-1b"), **%(dims)r)
    params = {n: torch.from_numpy(inp[n]) for n in ("wq", "wk", "wv", "wo")}
    out = {}
    for shape in %(meshes)r:
        mesh = make_local_mesh(model=shape[1], device="cpu")
        rows = lambda t: shd.shard(mesh, shd.P(("data",)), t)
        for name, (S, window, T, starts, valid) in %(reads)r.items():
            # the cache split along its slots over the model axis
            cache = shd.shard(
                mesh, {n: shd.P(("data",), "model", None, None)
                       for n in ("k", "v")},
                {n: torch.from_numpy(inp[f"{name}_{n}"]) for n in ("k", "v")})
            pos = torch.tensor(starts)[:, None] + torch.arange(T)[None, :]
            vl = None if valid is None else rows(torch.tensor(valid))
            counter = CollectiveCounter()
            with torch.no_grad(), implicit_replication(), counter:
                y, cache = attn.self_attention(
                    params, cfg, rows(torch.from_numpy(inp[name + "_x"])),
                    rows(pos), cache, window=window, valid_len=vl)
            key = f"{name}_{shape[0]}x{shape[1]}"
            out[key] = y.full_tensor().numpy()
            out[key + "_k"] = cache["k"].full_tensor().numpy()
            out[key + "_v"] = cache["v"].full_tensor().numpy()
            out[key + "_placements"] = np.array(str(cache["k"].placements))
            out[key + "_gathers"] = np.array(
                counter.counts.get("all_gather_into_tensor", 0))
            out[key + "_reduces"] = np.array(counter.counts.get("all_reduce",
                                                                0))
            out[key + "_reduce_bytes"] = np.array(
                counter.bytes_by_op.get("all_reduce", 0))
    if rank == 0:
        np.savez(data + "/out.npz", **out)
finally:
    dist.destroy_process_group()
"""


def _read_cfgs():
    dims = dict(d_model=RD, num_heads=RHQ, num_kv_heads=RHKV, head_dim=RDH)
    return (dims, dataclasses.replace(jax_reduced("gemma3-1b"), **dims),
            dataclasses.replace(reduced_config("gemma3-1b"), **dims))


@pytest.fixture(scope="module")
def reads():
    """(inputs, the sharded runs' outputs): one launch of four gloo
    processes for every read and mesh."""
    dims, _, _ = _read_cfgs()
    rng = np.random.default_rng(600)
    inputs = {n: (rng.standard_normal(s) * 0.2).astype(np.float32)
              for n, s in (("wq", (RD, RHQ * RDH)), ("wk", (RD, RHKV * RDH)),
                           ("wv", (RD, RHKV * RDH)), ("wo", (RHQ * RDH, RD)))}
    for name, (S, _, T, _, _) in READS.items():
        inputs[name + "_x"] = rng.standard_normal(
            (RB, T, RD)).astype(np.float32)
        for n in ("k", "v"):
            # what earlier writes left in every slot (the masks decide
            # which are live)
            inputs[f"{name}_{n}"] = rng.standard_normal(
                (RB, S, RHKV, RDH)).astype(np.float32)
    with tempfile.TemporaryDirectory() as d:
        np.savez(os.path.join(d, "inputs.npz"), **inputs)
        code = _READ_WORKER % dict(dims=dims, meshes=READ_MESHES,
                                   reads=READS)
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                   OMP_NUM_THREADS="1")
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = str(s.getsockname()[1])
        procs = [subprocess.Popen([sys.executable, "-c", code, str(r), port,
                                   d], env=env, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for r in range(4)]
        errs = []
        for p in procs:
            try:
                _, err = p.communicate(timeout=240)
            except subprocess.TimeoutExpired:
                p.kill()
                _, err = p.communicate()
            errs.append((p.returncode, err[-3000:]))
        assert all(rc == 0 for rc, _ in errs), errs
        out = dict(np.load(os.path.join(d, "out.npz")))
    return inputs, out


def _plain_reads(inputs, name):
    """The unsharded port's and the reference's (out, k, v) for a read."""
    S, window, T, starts, valid = READS[name]
    _, cj, ct = _read_cfgs()
    pos = np.asarray(starts)[:, None] + np.arange(T)[None, :]
    vl = None if valid is None else np.asarray(valid, np.int32)
    x, ck, cv = (inputs[name + s] for s in ("_x", "_k", "_v"))
    pt = {n: torch.from_numpy(inputs[n]) for n in ("wq", "wk", "wv", "wo")}
    cache = {"k": torch.from_numpy(ck.copy()),
             "v": torch.from_numpy(cv.copy())}
    with torch.no_grad():
        y, cache = attn.self_attention(
            pt, ct, torch.from_numpy(x), torch.from_numpy(pos), cache,
            window=window, valid_len=None if vl is None
            else torch.from_numpy(vl))
    port = (y.numpy(), cache["k"].numpy(), cache["v"].numpy())
    pj = {n: jnp.asarray(inputs[n]) for n in ("wq", "wk", "wv", "wo")}
    yj, cj_out = jax_attn.self_attention(
        pj, cj, jnp.asarray(x), jnp.asarray(pos, jnp.int32),
        {"k": jnp.asarray(ck), "v": jnp.asarray(cv)}, window=window,
        valid_len=None if vl is None else jnp.asarray(vl))
    ref = (np.asarray(yj), np.asarray(cj_out["k"]), np.asarray(cj_out["v"]))
    return port, ref


@pytest.mark.parametrize("mesh", READ_MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("name", list(READS))
def test_slot_split_read_matches_port_and_reference(reads, name, mesh):
    """The read on a cache split along its slots over 2 ((2, 2): rows
    over the data axis) and 4 ranks ((1, 4)), against the unsharded
    port's and the reference's ``self_attention`` on the same inputs:
    the output within the file's tolerances of its largest value (the
    output projection follows the attention here), the cache written as
    theirs (the T-padded rows only their valid tokens)."""
    inputs, out = reads
    key = f"{name}_{mesh[0]}x{mesh[1]}"
    assert "Shard(dim=1)" in str(out[key + "_placements"])
    (y, k, v), (yj, kj, vj) = _plain_reads(inputs, name)
    assert out[key].shape == y.shape == yj.shape
    scale = max(1.0, float(np.abs(y).max()))
    np.testing.assert_allclose(out[key], y, atol=TOL_WHOLE * scale, rtol=0)
    np.testing.assert_allclose(out[key], yj, atol=TOL_REF * scale, rtol=0)
    for got, port, ref in ((out[key + "_k"], k, kj),
                           (out[key + "_v"], v, vj)):
        # the new keys come from products over fewer rows a rank
        scale = max(1.0, float(np.abs(port).max()))
        np.testing.assert_allclose(got, port, atol=TOL_WHOLE * scale, rtol=0)
        np.testing.assert_allclose(got, ref, atol=TOL_REF * scale, rtol=0)


@pytest.mark.parametrize("mesh", READ_MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("name", list(READS))
def test_slot_split_read_gathers_nothing(reads, name, mesh):
    """``CollectiveCounter`` over the read: no all-gather (the cache
    stays where it lies); two all-reduces, the combine's max of lse and
    its sum, over the one mesh dimension that splits the slots, of a
    float32 lse and D + 1 float32 values a query row of the rank's rows,
    where a ring's rows are only the chunk's first ``window - 1`` (the
    later queries see no slot of the ring)."""
    _, out = reads
    S, window, T, _, _ = READS[name]
    key = f"{name}_{mesh[0]}x{mesh[1]}"
    assert int(out[key + "_gathers"]) == 0
    assert int(out[key + "_reduces"]) == 2
    rows = RB // mesh[0] * (min(T, window - 1) if window else T)
    assert int(out[key + "_reduce_bytes"]) == rows * RHQ * 4 * (RDH + 2)
