"""Per-architecture-family sharding rules over a torch ``DeviceMesh`` —
the reference's ``distributed/sharding.py`` with DTensor placements where
the reference has GSPMD partition specs.

Mesh axes: ``("data", "model")`` single-pod (16x16 = 256 cards) or
``("pod", "data", "model")`` multi-pod (2x16x16 = 512).  Batch shards
over ("pod","data"); tensor/expert parallelism over "model".

Rules are name-based over the port's trees (a leaf's name is its key in
the innermost dict that holds it):

  last-axis 'model'      : wq wk wv w_gate w_up in_proj bq bk bv conv_w
                           conv_b dt_bias A_log D norm_w embed-d lm_head-V
  second-to-last 'model' : wo w_down out_proj
  expert axis 'model'    : moe w_gate/w_up/w_down ([E, d, f] etc.)
  replicated             : ln* q_norm k_norm final_norm router

The rules index axes from the end, so the port's per-layer leaves get
the reference's specs for its leaves stacked over scan periods, less
their leading periods entry.

Activations / caches:
  tokens  [B, T]            -> (dp, None)
  KV      [L, B, S, H, D]   -> (None, dp, None, 'model', None)
  ssm     [L, B, H, P, N]   -> (None, dp, 'model', None, None)
  batch=1 (long_500k)       -> dp dropped (replicated batch)

A spec is a :class:`P`: entry i names the mesh axis (or a tuple of axes,
major first) that tensor axis i is split over, None where it is whole.
:func:`to_placements` turns it into DTensor placements and :func:`shard`
distributes a tree of tensors by a tree of specs.
"""
from __future__ import annotations

from typing import Dict, Tuple

from repro_torch.models import transformer as tf
from repro_torch.models.config import ModelConfig


class P(tuple):
    """A partition spec: ``P(None, "model")``, ``P(("pod", "data"),
    None)``.  Shorter than the tensor's rank: the missing trailing axes
    are whole.  ``P()`` is fully replicated."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return "P" + tuple.__repr__(self)


def axis_sizes(mesh) -> Dict[str, int]:
    """Mesh axis name -> size, for a ``DeviceMesh`` or any object with
    ``axis_names`` and ``devices`` (the tests' stand-in meshes)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def data_axes(mesh) -> Tuple:
    """The composite data-parallel axis: ('pod','data') when a pod axis
    exists, else 'data'."""
    return ("pod", "data") if "pod" in axis_sizes(mesh) else ("data",)


# ---------------------------------------------------------------------------
# Trees (nested dicts / lists / tuples / NamedTuples of leaves)
# ---------------------------------------------------------------------------

def _is_leaf(x) -> bool:
    return isinstance(x, P) or not isinstance(x, (dict, list, tuple))


def map_with_path(fn, tree, *rest, path=()):
    """``fn(path, leaf, *rest_leaves)`` over congruent trees; ``path`` is
    the tuple of dict keys and sequence indices down to the leaf."""
    if _is_leaf(tree):
        return fn(path, tree, *rest)
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, *(r[k] for r in rest),
                                 path=path + (k,))
                for k, v in tree.items()}
    items = [map_with_path(fn, v, *(r[i] for r in rest), path=path + (i,))
             for i, v in enumerate(tree)]
    if hasattr(tree, "_fields"):
        return type(tree)(*items)
    return type(tree)(items)


def _names(path):
    return [p for p in path if isinstance(p, str)]


# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------

_LAST_MODEL = {"wq", "wk", "wv", "w_gate", "w_up", "in_proj", "bq", "bk",
               "bv", "conv_w", "conv_b", "dt_bias", "A_log", "D", "norm_w",
               "projector"}
_PENULT_MODEL = {"wo", "w_down", "out_proj"}
_REPLICATED = {"ln1", "ln2", "ln_x", "ln_attn", "final_norm", "q_norm",
               "k_norm", "router"}


def _param_rule(path, leaf, model_size: int) -> P:
    """Input placements take no padding (as jit's input shardings in the
    reference), so every rule falls back along a preference chain and
    ends replicated if nothing divides."""
    names = _names(path)
    name = names[-1] if names else ""
    in_moe = "moe" in names
    nd = leaf.ndim

    def at(*axes: int) -> P:
        for axis in axes:
            if leaf.shape[axis] % model_size == 0 and leaf.shape[axis] > 1:
                spec = [None] * nd
                spec[axis] = "model"
                return P(*spec)
        return P()

    if name == "embed":
        return at(-1)                      # [V, d] shard d (cheap gather)
    if name == "lm_head":
        return at(-1, -2)                  # [d, V] vocab, else d
    if name in _REPLICATED:
        return P()
    if in_moe and name in ("w_gate", "w_up", "w_down"):
        return at(-3, -1, -2)              # expert parallel, else TP
    if name in _LAST_MODEL:
        return at(-1)
    if name in _PENULT_MODEL:
        return at(-2)
    return P()


def param_specs(cfg: ModelConfig, model_size: int = 16):
    return map_with_path(lambda p, l: _param_rule(p, l, model_size),
                         tf.abstract_params(cfg))


def opt_state_specs(cfg: ModelConfig, zero1: bool = False, mesh=None):
    """AdamW moments shard like params.  zero1=True additionally shards
    every moment's first free axis (size > 1) over the data axes
    (optimizer-state sharding).  The reference's stacked leaves put the
    data axes on their periods axis wherever it has more than one
    period; the port's per-layer leaves have no such axis, and take the
    rule on their own first free axis, as a one-period stack does."""
    from repro_torch.training.optimizer import OptState
    ps = param_specs(cfg)
    if not zero1:
        return OptState(step=P(), m=ps, v=ps)
    dp = data_axes(mesh) if mesh is not None else ("data",)

    def zspec(_, spec: P, leaf) -> P:
        entries = list(spec) + [None] * (leaf.ndim - len(spec))
        for i, e in enumerate(entries):
            if e is None and leaf.shape[i] > 1:
                entries[i] = dp
                break
        return P(*entries)

    zs = map_with_path(zspec, ps, tf.abstract_params(cfg))
    return OptState(step=P(), m=zs, v=zs)


# ---------------------------------------------------------------------------
# Activation / batch / cache specs
# ---------------------------------------------------------------------------

def batch_specs(cfg: ModelConfig, mesh, batch: int,
                family_inputs: bool = True):
    dp = data_axes(mesh)
    bdim = dp if batch > 1 else None
    spec = {"tokens": P(bdim, None), "labels": P(bdim, None)}
    if cfg.family == "vlm":
        spec["image_embeds"] = P(bdim, None, None)
    if cfg.family == "audio":
        spec["audio_embeds"] = P(bdim, None, None)
    return spec


#: cache leaves holding attention KV [L, B, S, H, D]
KV_LEAVES = ("k", "v", "ck", "cv", "k_local", "v_local")


def cache_specs(cfg: ModelConfig, mesh, batch: int, max_seq: int,
                cross_len: int = 8, kv_mode: str = "auto"):
    """Spec tree congruent with ``tf.init_cache``'s output.

    kv_mode:
      'auto'  — KV heads shard over 'model' when divisible, else the
                sequence axis (each rank reads its own slots; the partial
                softmaxes are combined by all-reduce, as the reference's
                compiled program does).
      'batch' — KV shards over the data axis only, replicated across
                'model': every cache write is device-local, at the cost
                of model_size x more KV memory per device.
      'seq'   — force sequence-axis sharding.
    """
    dp = data_axes(mesh)
    sizes = axis_sizes(mesh)
    model_size = sizes["model"]
    bdim = dp if batch > 1 else None
    dp_size = 1
    for n, s in sizes.items():
        if n != "model":
            dp_size *= s

    def bspec(dim: int):
        return bdim if (bdim and dim % dp_size == 0) else None

    def rule(path, leaf):
        names = _names(path)
        name = names[-1] if names else ""
        if name in KV_LEAVES:
            b, s, h = leaf.shape[1], leaf.shape[2], leaf.shape[3]
            if kv_mode == "batch":
                return P(None, bspec(b), None, None, None)
            if kv_mode == "seq" and s % model_size == 0:
                return P(None, bspec(b), "model", None, None)
            if kv_mode == "auto":
                if h % model_size == 0:
                    return P(None, bspec(b), None, "model", None)
                if s % model_size == 0:
                    return P(None, bspec(b), "model", None, None)
            return P(None, bspec(b), None, None, None)
        if name == "ssm":
            h = leaf.shape[2]
            m = "model" if h % model_size == 0 else None
            return P(None, bspec(leaf.shape[1]), m, None, None)
        if name == "conv":
            c = leaf.shape[3]
            m = "model" if c % model_size == 0 else None
            return P(None, bspec(leaf.shape[1]), None, m)
        return P(*([None] * leaf.ndim))

    shapes = tf.abstract_cache(cfg, batch, max_seq, cross_len=cross_len)
    return map_with_path(rule, shapes)


# ---------------------------------------------------------------------------
# Specs -> DTensor placements
# ---------------------------------------------------------------------------

def to_placements(spec: P, mesh):
    """One placement a mesh dimension: ``Shard(i)`` where ``spec`` names
    that mesh axis on tensor axis i, else ``Replicate()``.  A tuple entry
    splits one tensor axis over several mesh axes, the first the major
    one, as JAX does; DTensor splits in mesh order, so the tuple must
    list them in that order."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for axis, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        dims = [names.index(a) for a in axes]
        if dims != sorted(dims):
            raise ValueError(f"{spec}: mesh axes {axes} out of mesh order "
                             f"{tuple(names)}")
        for d in dims:
            if not isinstance(out[d], Replicate):
                raise ValueError(f"{spec}: mesh axis {names[d]} used twice")
            out[d] = Shard(axis)
    return tuple(out)


def shard(mesh, spec_tree, tensors):
    """Distribute a tree of tensors by a congruent tree of specs; returns
    the tree of DTensors.  Every rank holds the whole tensor (made from
    the same seed, or fake) and keeps its own shard of it: no collective
    runs."""
    from torch.distributed.tensor import distribute_tensor
    return map_with_path(
        lambda _, spec, t: distribute_tensor(
            t, mesh, to_placements(spec, mesh), src_data_rank=None),
        spec_tree, tensors)
