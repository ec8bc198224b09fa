"""GQA attention with KV-cache support for train / chunked-prefill /
decode, cross-attention and the encoder's bidirectional attention — the
reference's ``models/attention.py``.

Cache layout per attention layer: ``{"k": [B, S, Hkv, Dh], "v": ...}``
(dense) or ``{"k": [P + 1, Hkv, Dh], "v": ...}`` (paged block pool, see
``paged_write``).  ``S`` is the cache capacity: the full max sequence for
global layers or the sliding window for gemma3-style local layers (a ring
buffer: position p lives in slot ``p % S``).  Keys are stored with RoPE
already applied at their absolute position, so reads are position-free.
Masks are computed analytically from the per-row write position.

Where the reference returns an updated copy of a donated cache buffer,
the port UPDATES THE CACHE IN PLACE and returns the same tensors.  On
DTensor parameters and caches (the sharded path, ``distributed/``) the
cache writes, the kernels' calls and the attention products run on each
rank's local shards (``hints.local``).  A dense cache split along its
slot axis (``cache_specs``' ``auto`` where the KV heads do not divide
the model axis, or ``seq``) is read where it lies: each rank runs the
kernel (or the masked softmax, below) over its own slots and returns a
partial result with its log-sum-exp, and the partials are combined over
the split axis by small all-reduces (:func:`combine_partials`), as the
reference's compiled program reduces the softmax over a sharded axis.
No collective moves the cache: not the dense cache's, not a ring's.

The cache read goes through the hand-written kernels' wrappers — paged
decode / chunked prefill over a block pool, dense decode / chunked
prefill over a per-row cache: on a CUDA tensor they launch the kernel,
on a CPU tensor they take the plain version.  A dense chunk padded to a
common length (``valid_len`` with T > 1) is the one read left to a
masked softmax, as in the reference, and so is the sliding-window read
(no Pallas kernel of the reference computes it); on a slot-split cache
both take it piece by piece (:func:`_masked_partial`).  The other reads no
Pallas kernel of the reference computes are plain PyTorch too: the
cache-free (training) path, cross-attention over a precomputed encoder
KV, and the encoder's bidirectional self-attention.
"""
from __future__ import annotations

import torch

from repro_torch.distributed import hints
from repro_torch.kernels.chunked_prefill_attention.ops import (
    chunked_prefill_attention, paged_chunked_prefill_attention)
from repro_torch.kernels.decode_attention.ops import (decode_attention,
                                                      paged_decode_attention)
# rows with no valid key (all-masked) come out zero, as the kernels' do
from repro_torch.kernels.paged_args import (MIN_DENOMINATOR, NEG_INF,
                                            masked_lse,
                                            masked_softmax as _masked_softmax)
from repro_torch.models.common import apply_rope, dense_init, rms_norm


def init_attention(gen: torch.Generator, cfg, *, rope: bool = True):
    d, dh = cfg.d_model, cfg.head_dim
    hq, hkv = cfg.num_heads, cfg.num_kv_heads
    dt, dev = cfg.param_dtype, gen.device
    p = {
        "wq": dense_init(gen, (d, hq * dh), dt),
        "wk": dense_init(gen, (d, hkv * dh), dt),
        "wv": dense_init(gen, (d, hkv * dh), dt),
        "wo": dense_init(gen, (hq * dh, d), dt),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((hq * dh,), dtype=dt, device=dev)
        p["bk"] = torch.zeros((hkv * dh,), dtype=dt, device=dev)
        p["bv"] = torch.zeros((hkv * dh,), dtype=dt, device=dev)
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros((dh,), dtype=dt, device=dev)
        p["k_norm"] = torch.zeros((dh,), dtype=dt, device=dev)
    return p


def _project_qkv(p, cfg, x):
    B, T, _ = x.shape
    hq, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = hints.whole_axis(q, hq).reshape(B, T, hq, dh)
    k = hints.whole_axis(k, hkv).reshape(B, T, hkv, dh)
    v = hints.whole_axis(v, hkv).reshape(B, T, hkv, dh)
    # pin the KV-head axis to the model axis where hints are installed
    k = hints.constrain_heads(k)
    v = hints.constrain_heads(v)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return q, k, v


def _gqa_scores(q, k):
    """q [B,T,Hq,D], k [B,S,Hkv,D] -> scores [B,Hkv,G,T,S]."""
    B, T, hq, dh = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    if hints.active():
        # the query heads split into (KV head, group): the KV-head axis
        # on the model axis, as the keys' own
        q = hints.constrain_heads(q, groups=hkv)
        k = hints.constrain_heads(k)
    qg = hints.whole_axis(q, hkv, axis=2).reshape(B, T, hkv, g, dh)
    return hints.einsum("btkgd,bskd->bkgts", qg, k) * (dh ** -0.5)


def _gqa_out(probs, v, wo):
    """probs [B,Hkv,G,T,S], v [B,S,Hkv,D] -> [B,T,d_model]."""
    out = hints.flatten_heads(hints.einsum("bkgts,bskd->btkgd", probs, v))
    return out @ wo


def causal_mask(q_pos, kv_pos, window: int = 0):
    """q_pos [B,T], kv_pos [B,S] absolute positions -> mask [B,1,1,T,S]."""
    m = kv_pos[:, None, :] <= q_pos[:, :, None]
    m = m & (kv_pos[:, None, :] >= 0)
    if window:
        m = m & ((q_pos[:, :, None] - kv_pos[:, None, :]) < window)
    return m[:, None, None, :, :]


def ring_slot_positions(write_end, capacity: int):
    """Absolute position held by each ring-buffer slot after sequential
    writes ending at ``write_end`` (exclusive), -1 for a slot not yet
    written.  write_end: [B] -> [B, capacity]."""
    j = torch.arange(capacity, device=write_end.device)[None, :]
    last = write_end[:, None].long() - 1
    a = last - torch.remainder(last - j, capacity)
    return torch.where((a >= 0) & (write_end[:, None] > 0), a,
                       torch.full_like(a, -1))


def quantize_int8(x):
    """Symmetric per-token int8 KV quantization: x [..., D] ->
    (q int8 [..., D], scale f32 [...]) with ``x ~= q * scale``.  The
    scale is amax/127 per (token, kv head); all-zero tokens (fresh pool
    slots, padding) get scale 1 so dequantization is exact zero.
    ``torch.round`` rounds half to even, as the reference does."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def paged_destinations(positions, tables, block_size: int, P: int,
                       valid_len=None):
    """Flat pool slot [B*T] of every new token: ``tables[b, pos // bs] *
    bs + pos % bs``, or the dump slot ``P`` for tokens that must not land
    (padding beyond ``valid_len``, unallocated blocks)."""
    T = positions.shape[1]
    NB = tables.shape[1]
    bi = torch.div(positions, block_size, rounding_mode="floor")
    blk = torch.gather(tables, 1, bi.clamp(0, NB - 1).long())
    ok = (blk >= 0) & (bi < NB)
    if valid_len is not None:
        ok = ok & (torch.arange(T, device=positions.device)[None, :]
                   < valid_len[:, None])
    dest = torch.where(ok, blk * block_size + positions % block_size,
                       torch.full_like(blk, P))
    return dest.reshape(-1).long()


class FlatRows:
    """A paged step laid out token-major (the mixed step): its N tokens
    run every per-token layer as one row [1, N], and only the paged
    chunked-prefill kernel reads them in its per-row grid [B, T], row b
    starting at ``start[b]`` with ``valid[b]`` tokens.  ``index`` [N] is
    each token's cell ``b * T + t`` of the grid, or ``B * T`` for a
    padding token: a cell past the grid, which the kernel never reads.
    The grid of queries is allocated and zeroed at the first layer and
    refilled by every later one."""

    def __init__(self, index, start, valid, T: int):
        self.index = index.long()
        self.start, self.valid, self.T = start, valid, T
        self.B = start.shape[0]
        # the cell a token's output is read from: a padding token reads
        # the grid's last cell, and its output is dropped
        self.read = self.index.clamp(max=self.B * T - 1)
        self._q = None

    def destinations(self, positions, tables, block_size: int, P: int):
        """Pool slot [N] of every token: :func:`paged_destinations` over
        the grid, taken at ``index`` (``P`` for a padding token)."""
        grid = positions.new_zeros(self.B * self.T + 1)
        grid.index_copy_(0, self.index, positions.reshape(-1))
        dest = paged_destinations(grid[:-1].view(self.B, self.T), tables,
                                  block_size, P, self.valid)
        return torch.cat([dest, dest.new_full((1,), P)])[self.index]

    def to_grid(self, q):
        """q [1, N, H, D] -> the kernel's [B, T, H, D]."""
        if self._q is None:
            self._q = q.new_zeros((self.B * self.T + 1,) + q.shape[2:])
        self._q.index_copy_(0, self.index, q[0])
        return self._q[:-1].view((self.B, self.T) + q.shape[2:])

    def from_grid(self, o):
        """The kernel's o [B, T, H, D] -> [1, N, H, D]."""
        return o.reshape((self.B * self.T,) + o.shape[2:]) \
            .index_select(0, self.read)[None]


def paged_write(cache_k, cache_v, k_new, v_new, positions, tables,
                block_size: int, valid_len=None, dest=None):
    """Scatter [B,T] new KV into a physical block pool, IN PLACE.

    cache_k/cache_v: [P + 1, Hkv, D] flat-token pools (P = num_blocks *
    bs, block-major) whose last row is a dump slot that nothing reads.
    The reference routes invalid tokens to the out-of-range slot P and
    lets the scatter drop them; a scatter here has no drop mode, and a
    boolean-mask select would force a device sync in every layer, so the
    same slot P exists and swallows them — a fixed-shape ``index_copy_``.
    positions: [B,T] absolute positions; tables: [B,NB] int32 block
    tables (entry < 0 = unallocated).  ``dest`` may carry the result of
    :func:`paged_destinations` computed once for all layers.
    Returns the same two tensors.
    """
    B, T = k_new.shape[:2]
    if dest is None:
        dest = paged_destinations(positions, tables, block_size,
                                  cache_k.shape[0] - 1, valid_len)
    cache_k.index_copy_(0, dest, k_new.reshape((B * T,) + k_new.shape[2:])
                        .to(cache_k.dtype))
    cache_v.index_copy_(0, dest, v_new.reshape((B * T,) + v_new.shape[2:])
                        .to(cache_v.dtype))
    return cache_k, cache_v


def paged_gather(pool, tables, block_size: int):
    """Gather a per-row dense KV view [B, NB*bs, Hkv, D] from the block
    pool, plus logical kv positions [B, NB*bs] (-1 for unallocated
    blocks).  The kernels dereference the table themselves instead of
    materializing this view; it serves tests and tools."""
    B, NB = tables.shape
    idx = (tables.clamp(min=0).long()[:, :, None] * block_size
           + torch.arange(block_size, device=tables.device)[None, None, :])
    dense = pool[idx.reshape(B, NB * block_size)]
    kv_pos = torch.where(
        torch.repeat_interleave(tables >= 0, block_size, dim=1),
        torch.arange(NB * block_size, device=tables.device)[None, :],
        torch.full((1, 1), -1, device=tables.device, dtype=torch.long))
    return dense, kv_pos


def write_cache(cache_k, cache_v, k_new, v_new, start, valid_len=None):
    """Write [B,T] new KV at absolute positions start..start+T (per row)
    into dense caches [B, S, Hkv, D], IN PLACE.  start: [B] int.  The
    slot of position p is ``p % S`` (a ring buffer when S is a window).
    Assumes T <= S.

    valid_len: optional [B] — rows padded to a common T bucket only
    write their first ``valid_len`` tokens.  A padding token keeps its
    own (distinct) slot and writes back what the slot already holds, so
    the scatter keeps a fixed shape and needs no spare slot.
    """
    if hints.is_sharded(cache_k):
        # a rank writes the slots it holds; the plain body below needs
        # none of that body's gathers of the new KV
        return _write_cache_sharded(cache_k, cache_v, k_new, v_new, start,
                                    valid_len)
    B, T = k_new.shape[:2]
    S = cache_k.shape[1]
    dev = k_new.device
    pos = start[:, None] + torch.arange(T, device=dev)[None, :]
    slots = (pos % S).long()
    bidx = torch.arange(B, device=dev)[:, None].expand(B, T)
    k_new = k_new.to(cache_k.dtype)
    v_new = v_new.to(cache_v.dtype)
    if valid_len is not None:
        keep = (torch.arange(T, device=dev)[None, :]
                < valid_len[:, None])[:, :, None, None]
        k_new = torch.where(keep, k_new, cache_k[bidx, slots])
        v_new = torch.where(keep, v_new, cache_v[bidx, slots])
    cache_k[bidx, slots] = k_new
    cache_v[bidx, slots] = v_new
    return cache_k, cache_v


def _write_cache_local(cache_k, cache_v, k_new, v_new, start, valid_len,
                       offset: int, S: int):
    """:func:`write_cache` on one rank's shard of a cache whose slot axis
    (S in all) is split: the shard holds slots ``offset ..`` of each row.
    A token whose slot lies elsewhere writes, at the nearest slot of the
    shard, the value that slot ends with (the new value of the token
    that owns it, else the old one), so that the scatter keeps a fixed
    shape and its duplicate indices all carry one value."""
    B, T = k_new.shape[:2]
    S_loc = cache_k.shape[1]
    dev = k_new.device
    start = start.long()[:, None]
    slot = (start + torch.arange(T, device=dev)[None, :]) % S
    j = torch.clamp(slot - offset, 0, S_loc - 1)
    writer = torch.remainder(offset + j - start, S)      # token owning j
    n = valid_len.long()[:, None] if valid_len is not None else T
    keep = (writer < n)[:, :, None, None]
    bidx = torch.arange(B, device=dev)[:, None].expand(B, T)
    wcl = torch.clamp(writer, max=T - 1)
    for cache, new in ((cache_k, k_new), (cache_v, v_new)):
        new = new.to(cache.dtype)
        cache[bidx, j] = torch.where(keep, new[bidx, wcl], cache[bidx, j])


def _slot_dims(cache):
    """The mesh dimensions that split a DTensor cache [B, S, Hkv, D]
    along its slot axis S, in mesh order (none for a plain tensor)."""
    if not hints.is_sharded(cache):
        return []
    from torch.distributed.tensor import Shard
    return [i for i, p in enumerate(cache.placements)
            if isinstance(p, Shard) and p.dim == 1]


def _slot_offset(mesh, s_dims, S: int) -> int:
    """The first slot of this rank's shard of an S-slot axis split over
    the mesh dimensions ``s_dims`` (DTensor's even split, the first
    dimension the major one)."""
    shard, n = 0, 1
    for i in s_dims:
        shard = shard * mesh.size(i) + mesh.get_local_rank(i)
        n *= mesh.size(i)
    return shard * -(-S // n)


def _write_cache_sharded(cache_k, cache_v, k_new, v_new, start, valid_len):
    """:func:`write_cache` into DTensor caches, in place on each rank's
    shard (an in-place write cannot change a DTensor's placements).  The
    new KV follows the cache's batch and head splits and is whole along
    T; where the cache splits its slot axis, each rank writes the slots
    it holds."""
    mesh = cache_k.device_mesh
    cpl = tuple(cache_k.placements)
    new_pl = hints.placements_for(cache_k, (0, None, 2, 3))
    vec_pl = hints.placements_for(cache_k, (0,))
    s_dims = _slot_dims(cache_k)
    S = cache_k.shape[1]

    def local(ck, cv, kn, vn, st, vl):
        _write_cache_local(ck, cv, kn, vn, st, vl,
                           _slot_offset(mesh, s_dims, S), S)

    hints.local_call(local, (cache_k, cache_v, k_new, v_new, start,
                             valid_len),
                     (cpl, cpl, new_pl, new_pl, vec_pl, vec_pl), None, mesh)
    return cache_k, cache_v


#: axis maps (``hints.local``) of a dense read on local shards, against
#: the cache [B, S, Hkv, D]: the cache whole along S (a cache split along
#: S takes :func:`_read_slot_shards` instead), q [B, Hq, D] / [B, T, Hq,
#: D] split as its rows and its KV heads, a per-row vector as the rows
_KV, _Q1, _QT, _ROWS = (0, None, 2, None), (0, 2, None), \
    (0, None, 2, None), (0,)


def _combine(o, lse, reduce):
    """Attention over keys cut into pieces from each piece's result ``o``
    [..., D] and its float32 log-sum-exp ``lse`` [...] (-1e30 where the
    piece holds no live key); ``reduce(x, op)`` takes ``op`` ("max" or
    "sum") over the pieces.  ``M`` the max of lse, then the sums of
    ``exp(lse - M) o`` and ``exp(lse - M)`` in float32 (one reduction of
    D + 1 values a row), divided; in o's type.  A row with no key in any
    piece comes out zero."""
    m = reduce(lse, "max")
    w = torch.where(lse > NEG_INF / 2, torch.exp(lse - m),
                    torch.zeros((), device=lse.device))
    packed = reduce(torch.cat([o.float() * w[..., None], w[..., None]],
                              dim=-1), "sum")
    out = packed[..., :-1] / packed[..., -1:].clamp_min(MIN_DENOMINATOR)
    return out.to(o.dtype)


def _masked_partial(q, k, v, mask):
    """Attention of q [B, T, Hq, D] over a piece of the keys, k, v [B, S,
    Hkv, D], that ``mask`` [B, 1, 1, T, S] keeps: ``(o, lse)``, o [B, T,
    Hq, D] in q's type, lse the float32 [B, T, Hq] log-sum-exp of the
    kept scores, -1e30 (and o zero) for a query the piece gives no key,
    as the kernels' log-sum-exp forms return them.  The plain masked
    softmax of the unsplit read, on the piece."""
    B, T, hq, dh = q.shape
    scores = _gqa_scores(q, k)
    probs = _masked_softmax(scores, mask)
    o = torch.einsum("bkgts,bskd->btkgd", probs.to(q.dtype), v)
    lse = masked_lse(scores, mask).permute(0, 3, 1, 2)
    return o.reshape(B, T, hq, dh), lse.reshape(B, T, hq)


def combine_partials(o, lse, groups=()):
    """:func:`_combine` over the pieces one a rank of each process group
    in ``groups``: an all-reduce max of lse and an all-reduce sum of
    D + 1 float32 values a row a group, as functional collectives
    (``_c10d_functional``, which the dry-run counts; the ops themselves,
    without ``funcol``'s asynchronous wrapper, whose eager dispatch cost
    ~0.3 ms a call on the host).  With no group, ``o`` itself up to one
    rounding to float32 and back."""
    c10d = torch.ops._c10d_functional

    def reduce(x, op):
        for g in groups:
            x = c10d.wait_tensor(c10d.all_reduce(x, op, g.group_name))
        return x

    return _combine(o, lse, reduce)


def combine_stacked(o, lse):
    """:func:`_combine` over pieces stacked on a leading axis (o [n, ...,
    D], lse [n, ...]) in one process: the plain version of
    :func:`combine_partials`, for tests and tools."""
    return _combine(o, lse, lambda x, op: (
        x.amax(0, keepdim=True) if op == "max"
        else x.sum(0, keepdim=True)))[0]


def _decode_shard(q, k, v, lengths, offset: int):
    """Kernel 3 on a rank's slot shard (slots ``offset ..`` of each row):
    a row's live keys are a prefix of the slot axis, so here the first
    ``clamp(length - offset, 0, S_r)`` of the shard."""
    n = torch.clamp(lengths.long() - offset, 0, k.shape[1])
    return decode_attention(q, k, v, n.to(torch.int32), return_lse=True)


def _prefill_shard(q, k, v, start, offset: int):
    """Kernel 4 on a rank's slot shard: the chunk at ``start`` is, on
    slots ``offset ..``, the chunk at ``start - offset``."""
    return chunked_prefill_attention(q, k, v, start[0] - offset,
                                     return_lse=True)


def _padded_kv_pos(positions, S: int, offset: int = 0):
    """Positions [B, S] held by slots ``offset ..`` of a full cache
    written sequentially: slot j holds position j once the row's
    frontier has passed it, else -1."""
    j = offset + torch.arange(S, device=positions.device)[None, :]
    return torch.where(j < positions[:, -1:] + 1, j, torch.full_like(j, -1))


def _padded_shard(q, k, v, positions, offset: int):
    """The T-padded chunk's masked softmax on a rank's slot shard."""
    kv_pos = _padded_kv_pos(positions, k.shape[1], offset)
    return _masked_partial(q, k, v, causal_mask(positions, kv_pos))


def _read_slot_shards(read, q, ck, cv, arg, q_dims):
    """A read of a DTensor cache split along its slot axis, where it
    lies: on each rank, ``read(q, k, v, arg, offset)`` over the rank's
    own slots (q whole over the mesh dimensions that split them: a few
    KB), the partials then combined over those dimensions only
    (:func:`combine_partials`).  The result is split as ``q_dims`` maps
    q onto the cache."""
    mesh = ck.device_mesh
    s_dims = _slot_dims(ck)
    groups = [mesh.get_group(i) for i in s_dims]
    S = ck.shape[1]
    cpl = tuple(ck.placements)
    q_pl = hints.placements_for(ck, q_dims)

    def region(q, k, v, a):
        o, lse = read(q, k, v, a, _slot_offset(mesh, s_dims, S))
        return combine_partials(o, lse, groups)

    return hints.local_call(region, (q, ck, cv, arg),
                            (q_pl, cpl, cpl, hints.placements_for(ck, _ROWS)),
                            q_pl, mesh)


def _read_ring_shards(q, k, v, ck, cv, positions, window: int):
    """:func:`_ring_attention`'s read of a ring cache split along its
    slots, where it lies: each rank's masked softmax over its own slots
    (their positions ``ring_slot_positions``' slice from the rank's
    offset), the partials combined over the splitting mesh dimensions.
    The chunk's fresh keys, whole on every rank, join the piece of the
    rank whose offset is 0, so that they enter the combine once.  Only
    the chunk's first ``window - 1`` queries reach back past the chunk
    into the ring; where the slots lie on more than one rank, each rank
    attends the later ones over the fresh keys alone, so that a long
    chunk's combine moves those rows only.  q [B, T, Hq, D] -> o, split
    as q."""
    mesh = ck.device_mesh
    s_dims = _slot_dims(ck)
    groups = [mesh.get_group(i) for i in s_dims]
    S = ck.shape[1]
    cpl = tuple(ck.placements)
    q_pl = hints.placements_for(ck, _QT)
    kv_pl = hints.placements_for(ck, _KV)
    pieces = 1
    for i in s_dims:
        pieces *= mesh.size(i)

    def region(q, k, v, ck, cv, pos):
        offset = _slot_offset(mesh, s_dims, S)
        h = q.shape[1] if pieces == 1 else min(q.shape[1], window - 1)
        kv_pos = ring_slot_positions(pos[:, 0], S)[
            :, offset:offset + ck.shape[1]]
        if offset == 0:
            kv_pos = torch.cat([kv_pos, pos.long()], dim=1)
            ck, cv = torch.cat([ck, k], dim=1), torch.cat([cv, v], dim=1)
        o, lse = _masked_partial(q[:, :h], ck, cv,
                                 causal_mask(pos[:, :h], kv_pos, window))
        o = combine_partials(o, lse, groups)
        if h == q.shape[1]:
            return o
        tail, _ = _masked_partial(q[:, h:], k, v,
                                  causal_mask(pos[:, h:], pos, window))
        return torch.cat([o, tail], dim=1)

    return hints.local_call(region, (q, k, v, ck, cv, positions),
                            (q_pl, kv_pl, kv_pl, cpl, cpl,
                             hints.placements_for(ck, _ROWS)), q_pl, mesh)


def self_attention(p, cfg, x, positions, cache=None, *, window: int = 0,
                   rope: bool = True, valid_len=None, block_tables=None,
                   rope_cs=None, write_dest=None, flat=None):
    """positions: [B,T] absolute positions of x's tokens.

    cache=None  -> pure in-chunk causal attention.
    cache={k,v} -> write chunk into cache, attend over full cache (chunked
                   prefill when T>1, decode when T==1).
    window      -> a sliding window (gemma3 local layers): the cache is a
                   ring buffer of S = min(window, max_seq) slots.
    valid_len   -> optional [B] per-row valid token counts for T-padded
                   batched prefill: padding KV writes are dropped, padded
                   queries are masked off by causality (their outputs are
                   discarded by the caller).  With T == 1 a row mask:
                   rows with 0 write no KV and read as if they had.
    block_tables -> optional ``(tables [B,NB] int32, block_size)``: the
                   cache is a PAGED pool ({k,v}: [P + 1, Hkv, D]) and each
                   row's KV is addressed through its block table.
    rope_cs / write_dest -> optional per-forward precomputations
                   (``common.rope_tables``, ``paged_destinations``) shared
                   by all layers.
    flat         -> optional :class:`FlatRows` with ``block_tables``: x is
                   [1, N, d], the step's tokens laid out token-major, and
                   only the kernel's read takes its per-row grid.
    Returns (out [B,T,d], cache); the cache is updated in place.
    """
    B, T, _ = x.shape
    if valid_len is not None and cache is None:
        raise NotImplementedError("valid_len packing requires a KV cache")
    if block_tables is not None and (cache is None or window):
        raise NotImplementedError(
            "paged KV requires a full (non-windowed) cache")
    q, k, v = _project_qkv(p, cfg, x)
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta, rope_cs)
        k = apply_rope(k, positions, cfg.rope_theta, rope_cs)
    if block_tables is not None:
        return _paged_attention(p, cfg, x, q, k, v, positions, cache,
                                block_tables, valid_len, write_dest, flat)
    if cache is None:
        mask = causal_mask(positions, positions, window)
        probs = _masked_softmax(_gqa_scores(q, k), mask)
        return _gqa_out(probs.to(x.dtype), v, p["wo"]), None
    if window:
        return _ring_attention(p, x, q, k, v, positions, cache, window,
                               valid_len)
    held = None
    if T == 1 and valid_len is not None:
        # decode of a full slot batch: a row the step does not schedule
        # writes no KV, yet reads as the reference's unmasked decode does,
        # its own key at its frontier included, so that what it hands the
        # next layers (an MoE's routing among them) is the reference's.
        # Its frontier slot is written, read, then given back.
        rows = torch.arange(B, device=x.device)
        slots = positions[:, 0].long() % cache["k"].shape[1]
        held = cache["k"][rows, slots], cache["v"][rows, slots]
    ck, cv = write_cache(cache["k"], cache["v"], k, v, positions[:, 0],
                         None if held is not None else valid_len)
    split_slots = bool(_slot_dims(ck))
    if T == 1:
        # decode: the dense decode kernel over each row's first
        # position + 1 keys
        lengths = (positions[:, -1] + 1).to(torch.int32)
        if split_slots:
            o = _read_slot_shards(_decode_shard, q[:, 0], ck, cv, lengths,
                                  _Q1)
        else:
            o = hints.local(decode_attention, ck,
                            in_dims=(_Q1, _KV, _KV, _ROWS),
                            out_dims=_Q1)(q[:, 0], ck, cv, lengths)
        o = o[:, None]
        if held is not None:
            write_cache(ck, cv, held[0][:, None], held[1][:, None],
                        positions[:, 0], 1 - valid_len)
    elif valid_len is None:
        # exact-shape chunk: the dense chunked-prefill kernel takes one
        # offset for the batch (the engine prefills dense rows one slot
        # at a time)
        if split_slots:
            o = _read_slot_shards(_prefill_shard, q, ck, cv,
                                  positions[:, 0], _QT)
        else:
            o = hints.local(
                lambda q, k, v, start: chunked_prefill_attention(q, k, v,
                                                                 start[0]),
                ck, in_dims=(_QT, _KV, _KV, _ROWS), out_dims=_QT)(
                    q, ck, cv, positions[:, 0])
    elif split_slots:
        # T-padded rows of unequal offsets on a slot-split cache: the
        # masked softmax on each rank's slots, the partials combined
        o = _read_slot_shards(_padded_shard, q, ck, cv, positions, _QT)
    else:
        # T-padded rows of unequal offsets: masked softmax over the cache
        kv_pos = _padded_kv_pos(positions, ck.shape[1])
        mask = causal_mask(positions, kv_pos)
        probs = _masked_softmax(_gqa_scores(q, ck), mask)
        return _gqa_out(probs.to(x.dtype), cv, p["wo"]), cache
    out = o.reshape(B, T, -1).to(x.dtype) @ p["wo"]
    return out, cache


def _ring_attention(p, x, q, k, v, positions, cache, window: int,
                    valid_len=None):
    """Sliding-window attention over a ring-buffer cache [B, S, Hkv, D]
    (S = min(window, max_seq)).  Writing first would overwrite keys still
    needed by the chunk's early queries, so the chunk attends over the
    prior cache plus its own fresh keys, then writes itself (its last S
    tokens when T >= S).  ``valid_len`` drops the writes it excludes (a
    row mask at T == 1: the rows a full-slot-batch decode does not
    schedule); it changes no read.  A ring split along its slots is read
    where it lies (:func:`_read_ring_shards`).  Returns (out, cache), the
    cache updated in place."""
    B, T = x.shape[:2]
    S = cache["k"].shape[1]
    start = positions[:, 0]
    if _slot_dims(cache["k"]):
        o = _read_ring_shards(q, k, v, cache["k"], cache["v"], positions,
                              window)
        out = o.reshape(B, T, -1).to(x.dtype) @ p["wo"]
    else:
        kv_pos = torch.cat([ring_slot_positions(start, S),
                            positions.long()], dim=1)
        mask = causal_mask(positions, kv_pos, window)
        k_all = torch.cat([cache["k"], k], dim=1)
        v_all = torch.cat([cache["v"], v], dim=1)
        probs = _masked_softmax(_gqa_scores(q, k_all), mask)
        out = _gqa_out(probs.to(x.dtype), v_all, p["wo"])
    if T >= S:
        k, v = k[:, -S:], v[:, -S:]
        start = positions[:, -1] + 1 - S
        if valid_len is not None:
            valid_len = torch.clamp(valid_len - (T - S), min=0)
    write_cache(cache["k"], cache["v"], k, v, start, valid_len)
    return out, cache


def _paged_attention(p, cfg, x, q, k, v, positions, cache, block_tables,
                     valid_len, write_dest=None, flat=None):
    """Write the chunk into the block pool, attend over the row's
    table-resident KV.  T == 1 goes to the paged decode kernel, T > 1
    (chunked prefill, and the decode rows with ``valid == 1`` of a mixed
    batch) and a token-major step (``flat``) to the paged chunked-prefill
    kernel."""
    B, T, _ = x.shape
    names = sorted(cache)
    bs = block_tables[1]

    def core(q, k, v, positions, tables, valid_len, write_dest, *leaves):
        return _paged_core(q, k, v, positions, dict(zip(names, leaves)),
                           (tables, bs), valid_len, write_dest, flat)

    # on DTensor pools [P + 1, Hkv, D], on local shards: a pool has no row
    # axis, so every rank takes every row (q, the new KV, the tables
    # whole along B) and its own KV heads where the pools split them
    heads = (None, None, 1, None)
    o = hints.local(
        core, cache["k"], in_dims=(heads,) * 3 + ((),) * 4 + tuple(
            tuple(range(cache[n].ndim)) for n in names),
        out_dims=heads)(q, k, v, positions, block_tables[0], valid_len,
                        write_dest, *(cache[n] for n in names))
    out = o.reshape(B, T, -1).to(x.dtype) @ p["wo"]
    return out, cache


def _paged_core(q, k, v, positions, cache, block_tables, valid_len,
                write_dest, flat=None):
    """The pool write and the paged kernel's read -> o [B, T, Hq, D]
    (with ``flat``, q, k, v and o are [1, N, H, D] and only the read
    takes the kernel's grid)."""
    B, T = q.shape[:2]
    tables, bs = block_tables
    quant = "k_scale" in cache
    scales = {}
    if quant:
        # int8 tier: quantize the chunk once at write time; scales live
        # in sibling [P + 1, Hkv] pools addressed by the same destinations
        k, ks = quantize_int8(k)
        v, vs = quantize_int8(v)
        if write_dest is None:
            write_dest = paged_destinations(
                positions, tables, bs, cache["k"].shape[0] - 1, valid_len)
        paged_write(cache["k_scale"], cache["v_scale"], ks, vs, positions,
                    tables, bs, valid_len, write_dest)
        scales = dict(k_scale=cache["k_scale"], v_scale=cache["v_scale"])
    ck, cv = paged_write(cache["k"], cache["v"], k, v, positions, tables,
                         bs, valid_len, write_dest)
    if flat is not None:
        return flat.from_grid(paged_chunked_prefill_attention(
            flat.to_grid(q), ck, cv, tables, flat.start, flat.valid,
            block_size=bs, **scales))
    if T == 1:
        o = paged_decode_attention(
            q[:, 0], ck, cv, tables, (positions[:, -1] + 1).to(torch.int32),
            block_size=bs, **scales)
        return o[:, None]
    valid = (valid_len if valid_len is not None
             else torch.full((B,), T, dtype=torch.int32, device=q.device))
    return paged_chunked_prefill_attention(
        q, ck, cv, tables, positions[:, 0].to(torch.int32),
        valid.to(torch.int32), block_size=bs, **scales)


def init_cross_attention(gen: torch.Generator, cfg):
    return init_attention(gen, cfg, rope=False)


def cross_attention(p, cfg, x, kv, kv_valid=None):
    """x [B,T,d] attends over precomputed cross KV {k,v} [B,S,Hkv,D]: no
    RoPE, no causality; ``kv_valid`` [B,S] bool masks keys.  Over S = 0
    keys (a cross cache nothing has written) the output is zero."""
    q, _, _ = _project_qkv(p, cfg, x)
    scores = _gqa_scores(q, kv["k"])
    if kv_valid is None:
        mask = torch.ones(scores.shape[-2:], dtype=torch.bool,
                          device=x.device)[None, None, None]
    else:
        mask = kv_valid[:, None, None, None, :]
    probs = _masked_softmax(scores, mask)
    return _gqa_out(probs.to(x.dtype), kv["v"], p["wo"])


def project_cross_kv(p, cfg, enc_out):
    """Cross-attention KV from the encoder output, computed once a
    prefill: {k, v} [B, S, Hkv, D]."""
    B, S, _ = enc_out.shape
    hkv, dh = cfg.num_kv_heads, cfg.head_dim
    k = enc_out @ p["wk"]
    v = enc_out @ p["wv"]
    if cfg.qkv_bias:
        k, v = k + p["bk"], v + p["bv"]
    return {"k": hints.whole_axis(k, hkv).reshape(B, S, hkv, dh),
            "v": hints.whole_axis(v, hkv).reshape(B, S, hkv, dh)}


def encoder_attention(p, cfg, x, positions, rope_cs=None):
    """The encoder's bidirectional self-attention: RoPE at ``positions``
    [B,S] (the frames' ``arange``), no mask, the softmax in float32."""
    q, k, v = _project_qkv(p, cfg, x)
    q = apply_rope(q, positions, cfg.rope_theta, rope_cs)
    k = apply_rope(k, positions, cfg.rope_theta, rope_cs)
    probs = torch.softmax(_gqa_scores(q, k).float(), dim=-1)
    return _gqa_out(probs.to(x.dtype), v, p["wo"])
