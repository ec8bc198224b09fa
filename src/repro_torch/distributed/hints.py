"""Optional in-model sharding hints — the reference's
``distributed/hints.py`` on DTensor.

The model code is mesh-agnostic.  ``set_hints`` installs the axis names
(and, optionally, the ``DeviceMesh``); the ``constrain_*`` calls then
redistribute an intermediate DTensor to the layout the reference pins
with ``with_sharding_constraint``.  Where no hints are installed, or the
tensor is a plain one (single card, CPU tests), every call returns its
input at the cost of one attribute read.

DTensor does not pad as GSPMD does: a head count that does not divide
the model axis stays whole on every rank (an all-gather, which the
dry-run counts) where GSPMD would pad it.  The regions that write a
cache in place or call a hand-written kernel run on local shards
(:func:`local`, over ``torch.distributed.tensor.experimental.local_map``):
a model module calls ``hints.local(fn, ref, in_dims, out_dims)(*args)``
once, which is ``fn`` itself on plain tensors.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional, Tuple

import torch

_state = threading.local()


def set_hints(batch_axes: Optional[Tuple], model_axis: Optional[str],
              seq_parallel: bool = False, mesh=None):
    _state.batch = batch_axes
    _state.model = model_axis
    _state.seq_parallel = seq_parallel
    _state.mesh = mesh


def clear_hints():
    _state.batch = None
    _state.model = None
    _state.seq_parallel = False
    _state.mesh = None


@contextlib.contextmanager
def hints(batch_axes, model_axis, seq_parallel: bool = False, mesh=None):
    set_hints(batch_axes, model_axis, seq_parallel, mesh)
    try:
        yield
    finally:
        clear_hints()


def active() -> bool:
    return getattr(_state, "model", None) is not None


_DTENSOR = []


def is_sharded(x) -> bool:
    """True for a DTensor (only the sharded path makes them)."""
    if not _DTENSOR:
        from torch.distributed.tensor import DTensor
        _DTENSOR.append(DTensor)
    return isinstance(x, _DTENSOR[0])


def _mesh_of(x):
    return getattr(_state, "mesh", None) or x.device_mesh


def _size(mesh, axes) -> int:
    names = list(mesh.mesh_dim_names)
    n = 1
    for a in (axes if isinstance(axes, tuple) else (axes,)):
        n *= mesh.shape[names.index(a)]
    return n


def _redistribute(x, spec):
    from repro_torch.distributed.sharding import to_placements
    mesh = _mesh_of(x)
    placements = to_placements(spec, mesh)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(mesh, placements)


def _batch_entry(x, mesh):
    b = _state.batch
    if b is None or x.shape[0] <= 1 or x.shape[0] % _size(mesh, b):
        return None
    return b


def constrain_heads(x, *, batch_first: bool = True,
                    groups: Optional[int] = None):
    """x: [B, T, H, D] (or [B, S, H, D] KV) -> H on the model axis, B on
    the data axes.  H stays whole where it (or ``groups``, the KV heads a
    query's H is about to be split into) does not divide the model
    axis."""
    if getattr(_state, "model", None) is None or not is_sharded(x):
        return x
    from repro_torch.distributed.sharding import P
    mesh = _mesh_of(x)
    b = _batch_entry(x, mesh) if batch_first else None
    h = _state.model if (groups or x.shape[2]) % _size(
        mesh, _state.model) == 0 else None
    return _redistribute(x, P(b, None, h, None))


def whole_axis(x, parts: int, axis: int = -1):
    """x's ``axis`` (by default the last) is about to be split into
    ``parts`` leading parts (heads of [B, T, H * D]).  Where a DTensor
    splits that axis so that a shard would end inside a part, gather it
    first (DTensor cannot unflatten it; GSPMD pads or reshards there).
    ``parts=1`` gathers any split.  This keeps a sharded forward correct,
    so it runs with or without hints."""
    if not is_sharded(x):
        return x
    from torch.distributed.tensor import Replicate, Shard
    axis = axis % x.ndim
    split = [i for i, p in enumerate(x.placements)
             if isinstance(p, Shard) and p.dim % x.ndim == axis]
    n = 1
    for i in split:
        n *= x.device_mesh.size(i)
    if parts % n == 0:
        return x
    return x.redistribute(x.device_mesh, [
        Replicate() if i in split else p for i, p in enumerate(x.placements)])


def constrain_tokens(x):
    """x: [B, T, d] residual-stream activations at a block's entry.  With
    seq_parallel the token axis shards over 'model' between blocks
    (sequence parallelism: norms/residuals run on T / model tokens; the
    next product gathers them).  The reference tests T % 16, the model
    axis's size on its production mesh; this tests the mesh's own size.

    Otherwise a DTensor stream is split by rows only, with or without
    hints: DTensor keeps whatever split an op chose, and a stream split
    along d (the embedding's split) turns the next products into partial
    sums, and one split along T into strided splits DTensor's products
    cannot take.  GSPMD settles the stream so by itself."""
    if not is_sharded(x):
        return x
    if getattr(_state, "model", None) is not None \
            and getattr(_state, "seq_parallel", False):
        from repro_torch.distributed.sharding import P
        mesh = _mesh_of(x)
        b = _batch_entry(x, mesh)
        t = _state.model if x.shape[1] % _size(mesh, _state.model) == 0 \
            else None
        return _redistribute(x, P(b, t, None))
    pl = placements_for(x, (0, None, None))
    if tuple(x.placements) == pl:
        return x
    return x.redistribute(x.device_mesh, pl)


# ---------------------------------------------------------------------------
# Regions on local shards
# ---------------------------------------------------------------------------

def rows_like(t, ref):
    """``t`` ([B, ...], plain or DTensor) split by rows as ``ref`` [B,
    ...] is, where ``ref`` is a DTensor; else ``t`` as it is.  Position
    and mask tensors a forward makes from the global batch size take
    their rows' split so, else every rank would compute them for the
    whole batch."""
    return split_like(t, ref, (0,) + (None,) * (t.ndim - 1))


def split_like(t, ref, dims=None):
    """``t`` split as :func:`placements_for` ``(ref, dims)`` gives (by
    default as ``ref`` itself is, before an in-place copy into ``ref``,
    which cannot change placements), where ``ref`` is a DTensor (a plain
    ``t``, which every rank holds whole, is cut locally: no collective);
    else ``t`` as it is."""
    if not is_sharded(ref):
        return t
    pl = placements_for(ref, range(ref.ndim) if dims is None else dims)
    if is_sharded(t):
        return t if tuple(t.placements) == pl else \
            t.redistribute(ref.device_mesh, pl)
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(t, ref.device_mesh, pl, src_data_rank=None)


def embed(table, ids):
    """``table[ids]`` (table [V, d], ids [B, T]); on a DTensor table, on
    local shards: the table keeps its split of d (any split of V, FSDP's,
    is gathered first), the ids their rows' split, and the result [B, T,
    d] splits both.  DTensor's own lookup takes no ids split over two
    mesh axes, and its backward writes a whole-table gradient."""
    if not is_sharded(table):
        return table[ids]
    from torch.distributed.tensor import Replicate, Shard
    mesh = table.device_mesh
    t_pl = tuple(p if isinstance(p, Shard) and p.dim == 1 else Replicate()
                 for p in table.placements)
    i_pl = tuple(p if isinstance(p, Shard) and isinstance(t, Replicate)
                 else Replicate() for p, t in zip(
                     ids.placements if is_sharded(ids) else t_pl, t_pl))
    out = tuple(Shard(2) if isinstance(t, Shard) else i
                for t, i in zip(t_pl, i_pl))
    return local_call(lambda t, i: t[i], (table, ids), (t_pl, i_pl), out,
                      mesh)


def on_shards(fn, x, whole=()):
    """``fn(x)`` on x's local shards, the result split as x is: for a
    function that keeps x's split axes (a cut along ``whole``, which is
    gathered first where it is split).  A plain ``x`` goes to ``fn``."""
    if not is_sharded(x):
        return fn(x)
    from torch.distributed.tensor import Replicate, Shard
    pl = tuple(Replicate() if isinstance(p, Shard) and p.dim in whole
               else p for p in x.placements)
    return local_call(fn, (x,), (pl,), pl, x.device_mesh)


def flatten_heads(x):
    """[B, T, H, ...] -> [B, T, H * ...]; on a DTensor, on local shards:
    the heads keep their split (the rest is gathered first).  DTensor's
    own flatten would, on the way back, unflatten a gradient split along
    the merged axis, which fails where the heads do not divide the
    split."""
    if not is_sharded(x):
        return x.flatten(2)
    from torch.distributed.tensor import Replicate, Shard
    pl = tuple(Replicate() if isinstance(p, Shard) and p.dim >= 3 else p
               for p in x.placements)
    return local_call(lambda t: t.flatten(2), (x,), (pl,), pl,
                      x.device_mesh)


def placements_for(ref, dims):
    """Placements that split each axis of a tensor as ``ref`` splits the
    axis ``dims`` maps it to: ``dims[i]`` is the axis of ``ref`` that
    axis i follows, or None for an axis kept whole.  A mesh dimension
    that splits an axis of ``ref`` no axis follows replicates."""
    from torch.distributed.tensor import Replicate, Shard
    inv = {r: i for i, r in enumerate(dims) if r is not None}
    return tuple(Shard(inv[p.dim]) if isinstance(p, Shard) and p.dim in inv
                 else Replicate() for p in ref.placements)


class Summed:
    """An output of :func:`local` that sums over the axes ``over`` of
    its reference (a token sum): each rank holds a partial sum where the
    reference splits one of them.  ``dims`` maps the output's own axes
    as in :func:`placements_for`."""

    def __init__(self, dims, over):
        self.dims, self.over = tuple(dims), tuple(over)

    def placements(self, ref):
        from torch.distributed.tensor import Partial, Shard
        return tuple(Partial() if isinstance(p, Shard) and p.dim in self.over
                     else q for p, q in zip(ref.placements,
                                            placements_for(ref, self.dims)))


def local(fn, ref, in_dims, out_dims):
    """``fn`` itself where ``ref`` is a plain tensor (the unsharded path
    pays one attribute read); on a DTensor ``ref``, ``fn`` on each rank's
    local shards (:func:`local_call`), every argument and output split as
    :func:`placements_for` ``(ref, dims)`` gives.  ``in_dims[i]`` maps
    argument i, or is None for one passed as it is (a number, a None);
    ``out_dims`` maps the one output, or is a list of maps (or
    :class:`Summed`) for several.  A region that writes a cache in place
    or calls a hand-written kernel's wrapper runs so: the wrapper sees
    plain tensors."""
    if not is_sharded(ref):
        return fn

    def at(d):
        return d.placements(ref) if isinstance(d, Summed) else \
            placements_for(ref, d)

    in_pls = tuple(None if d is None else at(d) for d in in_dims)
    out_pls = [at(d) for d in out_dims] if isinstance(out_dims, list) \
        else at(out_dims)
    return lambda *args: local_call(fn, args, in_pls, out_pls,
                                    ref.device_mesh)


def local_call(fn, args, in_placements, out_placements, mesh):
    """``fn(*args)`` on each rank's local shards
    (``torch.distributed.tensor.experimental.local_map``).  ``args[i]``
    is first brought to ``in_placements[i]``: a DTensor is redistributed
    (a collective where it must gather or reduce), a plain tensor, which
    every rank holds whole, is cut locally; None leaves an argument as
    it is.  ``out_placements`` wraps the outputs: the placements of one
    output, a list of them for several, or None (fn returns nothing)."""
    from torch.distributed.tensor import Placement, distribute_tensor
    from torch.distributed.tensor.experimental import local_map
    if out_placements is not None:
        if all(isinstance(p, Placement) for p in out_placements):
            out_placements = list(out_placements)
        else:
            out_placements = tuple(list(p) for p in out_placements)
    conv = []
    for a, pl in zip(args, in_placements):
        if pl is not None and a is not None:
            if is_sharded(a):
                if tuple(a.placements) != tuple(pl):
                    a = a.redistribute(mesh, pl)
            else:
                a = distribute_tensor(a, mesh, pl, src_data_rank=None)
        conv.append(a)
    pls = tuple(pl if a is not None else None
                for a, pl in zip(conv, in_placements))

    def dense(*local):
        # a DTensor takes a local tensor (an output, or a gradient on the
        # way back) as laid out like a contiguous one of its global shape
        # and views it so: everything crossing the region's edge is made
        # contiguous
        out = fn(*(_DenseGrad.apply(t) if _needs_grad(t) else t
                   for t in local))
        if isinstance(out, tuple):
            return tuple(_dense(o) for o in out)
        return _dense(out)

    return local_map(dense, out_placements=out_placements, in_placements=pls,
                     device_mesh=mesh)(*conv)


def _needs_grad(t) -> bool:
    return isinstance(t, torch.Tensor) and t.requires_grad \
        and torch.is_grad_enabled()


def _dense(t):
    return t.contiguous() if isinstance(t, torch.Tensor) else t


class _DenseGrad(torch.autograd.Function):
    """Identity whose gradient leaves contiguous."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def einsum(eq: str, *operands):
    """``torch.einsum``; on DTensors, on local shards.  Each mesh
    dimension splits the index letter the first split operand splits by
    it: every operand that holds that letter is split along it, the
    others are whole on that dimension, and the result is split along it
    too (or is a partial sum, where the letter is contracted).  DTensor's
    own einsum would flatten two split letters into one product axis (a
    strided split its batched products cannot take)."""
    if not any(is_sharded(o) for o in operands):
        return torch.einsum(eq, *operands)
    from torch.distributed.tensor import Partial, Replicate, Shard
    ins, out = eq.replace(" ", "").split("->")
    ins = ins.split(",")
    i, ref = next((i, o) for i, o in enumerate(operands) if is_sharded(o))
    letters = [ins[i][p.dim] if isinstance(p, Shard) else None
               for p in ref.placements]
    in_pls = [tuple(Shard(spec.index(l)) if l is not None and l in spec
                    else Replicate() for l in letters) for spec in ins]
    out_pl = tuple(Replicate() if l is None else
                   (Shard(out.index(l)) if l in out else Partial())
                   for l in letters)
    return local_call(lambda *ops: torch.einsum(eq, *ops), operands,
                      in_pls, out_pl, ref.device_mesh)
