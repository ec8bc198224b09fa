"""Bridge between the reference's parameter pytree and the port's
parameters.

``params_from_jax`` takes the tree of ``repro.models.transformer
.init_params`` with every leaf already turned into a numpy array (the
caller does the ``np.asarray``; this module imports neither framework of
the reference), and returns the port's ``{"embed", "lm_head",
"final_norm", ["shared_attn",] ["projector",] "layers": [...]}``;
``params_to_numpy`` goes back, to numpy leaves in the reference's stacked
layout (float32 for bf16 leaves).  The reference stacks
the blocks of pattern position ``pi`` of segment ``si`` over the segment's
periods (``tree["segments"][si][pi]`` leaves are ``[n_periods, ...]``);
the port holds one dict a layer, in execution order: segment, then
period, then pattern position.  The hybrid family's ``shared_attn`` is one
unstacked block.  The leaves the reference keeps in float32 (the Mamba2
mixer's ``A_log``, ``dt_bias``, ``D`` and the MoE ``router``) stay float32
whatever the model's type.
"""
from __future__ import annotations

import numpy as np
import torch

#: leaves that are float32 whatever the parameter type: the Mamba2
#: mixer's, and the MoE router
FLOAT32_LEAVES = ("A_log", "dt_bias", "D", "router")
#: unstacked top-level leaves (the VLM's projector only in that family)
TOP_LEAVES = ("embed", "lm_head", "final_norm", "projector")


def _to_tensor(a, device, dtype):
    a = np.asarray(a)
    if a.dtype.kind not in "fiub":
        # e.g. ml_dtypes bfloat16: widen on the host first
        a = a.astype(np.float32)
    return torch.from_numpy(np.array(a, order="C")).to(device=device,
                                                        dtype=dtype)


def _map_leaves(tree, fn, name=None):
    """``fn(leaf name, leaf)`` on every leaf; a leaf's name is its key in
    the innermost dict that holds it."""
    if isinstance(tree, dict):
        return {k: _map_leaves(v, fn, k) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_leaves(v, fn, name) for v in tree)
    return fn(name, tree)


def params_from_jax(tree, cfg, device="cuda", dtype=None):
    """Reference params pytree (numpy leaves) -> the port's parameters on
    ``device`` in ``dtype`` (default: the config's parameter type)."""
    dtype = dtype or cfg.param_dtype

    def conv(name, a):
        return _to_tensor(a, device,
                          torch.float32 if name in FLOAT32_LEAVES else dtype)

    params = {k: conv(k, tree[k]) for k in TOP_LEAVES if k in tree}
    if "shared_attn" in tree:
        params["shared_attn"] = _map_leaves(tree["shared_attn"], conv)
    layers = []
    for seg, seg_params in zip(cfg.segments(), tree["segments"]):
        for period in range(seg.n_periods):
            for pos_params in seg_params:
                layers.append(_map_leaves(
                    pos_params,
                    lambda name, a: conv(name, np.asarray(a)[period])))
    params["layers"] = layers
    return params


def host_numpy(t: torch.Tensor):
    """``t`` as a host numpy array; bf16 (which numpy lacks) as float32,
    exactly."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def params_to_numpy(params, cfg):
    """The port's parameters -> the reference's tree (``{"embed", ...,
    "segments": ((stacked block, ...), ...)}``) with numpy leaves, each
    pattern position's blocks stacked over its periods again; bf16 leaves
    come back as float32 (exact)."""
    tree = {k: host_numpy(params[k]) for k in TOP_LEAVES if k in params}
    if "shared_attn" in params:
        tree["shared_attn"] = _map_leaves(params["shared_attn"],
                                          lambda _, t: host_numpy(t))
    layers = iter(params["layers"])
    segs = []
    for seg in cfg.segments():
        per_period = [[next(layers) for _ in seg.pattern]
                      for _ in range(seg.n_periods)]
        segs.append(tuple(
            _stack([blocks[pi] for blocks in per_period])
            for pi in range(len(seg.pattern))))
    tree["segments"] = tuple(segs)
    return tree


def _stack(blocks):
    """Stack the same leaf of every block dict in ``blocks`` on a new
    leading axis."""
    first = blocks[0]
    if isinstance(first, dict):
        return {k: _stack([b[k] for b in blocks]) for k in first}
    return np.stack([host_numpy(b) for b in blocks])
