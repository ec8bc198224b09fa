"""Bridge from the reference's parameter pytree to the port's parameters.

``params_from_jax`` takes the tree of ``repro.models.transformer
.init_params`` with every leaf already turned into a numpy array (the
caller does the ``np.asarray``; this module imports neither framework of
the reference), and returns the port's ``{"embed", "lm_head",
"final_norm", ["shared_attn",] "layers": [...]}``.  The reference stacks
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

    params = {k: conv(k, tree[k]) for k in ("embed", "lm_head", "final_norm")}
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
