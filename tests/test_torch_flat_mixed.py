"""The paged mixed step laid out token-major (``engine/flat.py``,
``attention.FlatRows``) against the same step over ``pack_mixed``'s grid
[B, T], on the CPU: the same greedy tokens, hidden states within float32
tolerance, the same KV in every slot the rows write, and the padding's
writes in the pool's dump slot alone.  Each step holds chunks of unequal
length beside decode rows, pad rows (``valid == 0``), a chunk after a
claimed prefix (``start > 0``) and a decode row at the ``max_seq - 1``
clamp; its valid tokens number one below, exactly at and one past a
multiple of ``FLAT_ALIGN``."""
import numpy as np
import pytest
import torch

from repro_torch.configs import reduced_config
from repro_torch.engine import batching
from repro_torch.engine.engine import TorchExecutor
from repro_torch.engine.flat import FLAT_ALIGN, pack_flat
from repro_torch.models import transformer as tf
from repro_torch.models.attention import FlatRows
from test_torch_helpers import cap_threads

cap_threads()

BS, MAX_SEQ, SLOTS, BLOCKS = 8, 128, 8, 96
T_BUCKETS = (16, 32, 64, 128)

#: (chunk length, start) of each row; length-1 rows are decode rows.
#: Five rows pad to B = 8 (three pad rows); the 20-token chunk follows a
#: claimed prefix of 16; a decode row sits at the max_seq - 1 clamp
BASE = [(20, 16), (1, 50), (1, MAX_SEQ - 1), (1, 9)]
CASES = {"below": [(36, 0)] + BASE,           # 59 valid tokens: N 64
         "at": [(41, 0)] + BASE,              # 64: N 64
         "past": [(42, 0)] + BASE}            # 65: N 128


def _params(cfg, seed=0):
    """The port's random parameters, with norm gains and biases drawn
    too (``init_params`` leaves them zero)."""
    params = tf.init_params(seed, cfg, device="cpu")
    g = torch.Generator().manual_seed(seed + 1)
    leaves = [params["final_norm"]] + [
        t for block in params["layers"] for p in block.values()
        for t in (p.values() if isinstance(p, dict) else (p,))]
    for t in leaves:
        if t.ndim == 1:
            t.copy_(0.05 * torch.randn(t.shape, generator=g))
    return params


def _step(arch, quant, case, seed=0):
    """An executor whose pool holds random KV, and one mixed step's grid
    over it: (executor, packed, host tables of its rows)."""
    cfg = reduced_config(arch)
    ex = TorchExecutor(cfg, _params(cfg, seed), n_slots=SLOTS,
                       max_seq=MAX_SEQ, t_buckets=T_BUCKETS,
                       cache_block_size=BS, hbm_blocks=BLOCKS,
                       kv_quant=quant, device="cpu")
    g = torch.Generator().manual_seed(seed + 2)
    for leaf in ex.kv.pool.values():
        if leaf.dtype == torch.int8:
            leaf.copy_(torch.randint(-127, 128, leaf.shape, generator=g))
        else:
            leaf.copy_(torch.rand(leaf.shape, generator=g) + 0.5)
    rng = np.random.default_rng(seed)
    free = list(rng.permutation(BLOCKS))
    rows = CASES[case]
    chunks = [list(rng.integers(1, cfg.vocab_size, n)) for n, _ in rows]
    tables = []
    for n, start in rows:
        t = np.full(ex.kv.max_blocks, -1, np.int32)
        nb = -(-min(start + n, MAX_SEQ) // BS)
        t[:nb] = [free.pop() for _ in range(nb)]
        tables.append(t)
    packed = batching.pack_mixed(chunks, [s for _, s in rows], tables,
                                 T_BUCKETS, ex.kv.max_blocks, BS)
    return ex, packed


@torch.no_grad()
def _grid_forward(ex, packed, pool):
    """The step over the grid [B, T] (the layout every layer ran over
    before the token-major one): hidden states [B, T, d]."""
    tokens, start, valid, tables = (torch.from_numpy(a) for a in (
        packed.tokens, packed.start, packed.valid, packed.tables))
    T = tokens.shape[1]
    positions = torch.clamp(
        start[:, None] + torch.arange(T, dtype=torch.int32)[None],
        max=ex.max_seq - 1)
    hidden, _, _ = tf.forward(ex.params, ex.cfg, tokens, positions, pool,
                              compute_logits=False, valid_len=valid,
                              block_tables=(tables, BS))
    return hidden


def _written(packed):
    """Pool slots the step's valid tokens write."""
    out = set()
    for b in range(packed.tokens.shape[0]):
        for t in range(int(packed.valid[b])):
            pos = min(int(packed.start[b]) + t, MAX_SEQ - 1)
            out.add(int(packed.tables[b, pos // BS]) * BS + pos % BS)
    return sorted(out)


@pytest.mark.parametrize("case", sorted(CASES))
def test_pack_flat_lists_the_valid_tokens_row_by_row(case):
    _, packed = _step("smollm-135m", None, case)
    flat = pack_flat(packed, MAX_SEQ)
    B, T = packed.tokens.shape
    n = int(packed.valid.sum())
    assert n == {"below": 59, "at": 64, "past": 65}[case]
    assert len(flat.tokens) == -(-n // FLAT_ALIGN) * FLAT_ALIGN
    assert (packed.valid == 0).sum() == 3 and B == 8
    want = [(b * T + t, packed.tokens[b, t],
             min(packed.start[b] + t, MAX_SEQ - 1))
            for b in range(B) for t in range(packed.valid[b])]
    assert list(zip(flat.index[:n], flat.tokens[:n],
                    flat.positions[:n])) == want
    assert (flat.index[n:] == B * T).all()
    assert (flat.tokens[n:] == 0).all() and (flat.positions[n:] == 0).all()
    real = packed.valid > 0
    assert list(flat.last[real]) == list(np.cumsum(packed.valid)[real] - 1)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("quant", [None, "int8"], ids=["fp", "int8"])
@pytest.mark.parametrize("arch", ["smollm-135m", "qwen2.5-3b"])
def test_flat_step_matches_grid_step(arch, quant, case):
    ex, packed = _step(arch, quant, case)
    pool0 = {k: v.clone() for k, v in ex.kv.pool.items()}
    grid_pool = {k: v.clone() for k, v in pool0.items()}
    hidden = _grid_forward(ex, packed, grid_pool)
    B, T = packed.tokens.shape
    valid = torch.from_numpy(packed.valid)
    want = ex._sample_on_device(ex._last_logits(hidden, valid))

    # the executor's own step: greedy tokens of the real rows
    flat = pack_flat(packed, MAX_SEQ)
    got = ex._mixed_step(packed, flat)
    real = packed.valid > 0
    assert torch.equal(got[real], want[real])

    # the forward's hidden states, token-major, at the grid's cells
    n = int(valid.sum())
    flat_pool = {k: v.clone() for k, v in pool0.items()}
    rows = FlatRows(torch.from_numpy(flat.index), torch.from_numpy(
        packed.start), valid, T)
    with torch.no_grad():
        fh, _, _ = tf.forward(
            ex.params, ex.cfg, torch.from_numpy(flat.tokens)[None],
            torch.from_numpy(flat.positions)[None], flat_pool,
            compute_logits=False, flat=rows,
            block_tables=(torch.from_numpy(packed.tables), BS))
    torch.testing.assert_close(fh[0, :n],
                               hidden.reshape(B * T, -1)[flat.index[:n]])

    # KV: the flat step's pools equal the grid step's in every slot but
    # the dump slot P, and change only where the valid tokens write
    P = pool0["k"].shape[1] - 1
    wrote = torch.tensor(_written(packed))
    kept = torch.ones(P, dtype=torch.bool)
    kept[wrote] = False
    for pool in (ex.kv.pool, flat_pool):
        for name, leaf in pool.items():
            assert torch.equal(leaf[:, :P], grid_pool[name][:, :P]), name
            assert torch.equal(leaf[:, :P][:, kept], pool0[name][:, :P][
                :, kept]), name
            assert not torch.equal(leaf[:, wrote], pool0[name][:, wrote])
