"""Checkpointing: parameters and optimizer state as one flat ``.npz``, in
the reference's own layout, so that a checkpoint crosses between the two
packages.

A file holds ``params/<path>``, ``opt/step``, ``opt/m/<path>`` and
``opt/v/<path>``, where a path joins dict keys (sorted) and list or tuple
indices with ``/``, plus ``<path>.meta.json``.  The paths are those of the
reference's parameter tree: its layers are stacked by pattern position
over their periods (``params/segments/<segment>/<position>/attn/wk``, a
leading axis of periods), where the port keeps one dict a layer.
``save_checkpoint`` stacks the port's layers into that tree
(``convert.params_to_numpy``) for the parameters and for both moments, so
that its file has the very keys the reference writes for the same
parameters.  ``load_checkpoint`` reads that layout, and the port's older
per-layer one (``params/layers/<i>/...``), into a template of the port's
tree, each leaf on the template leaf's device and in its type.

numpy has no bfloat16.  The port stores a bf16 leaf as float32: the
widening is exact, and it is the one form both packages restore bit for
bit (the reference's loader casts float32 to bf16 exactly, but cannot cast
its own bf16 leaves back, which numpy saves as raw two-byte ``V2``
records).  ``load_checkpoint`` reads either form: float32, or ``V2``
records taken as the bits of bf16 values.
"""
from __future__ import annotations

import json
import os
import re
from typing import Optional

import numpy as np
import torch

from repro_torch.convert import host_numpy, params_to_numpy
from repro_torch.training.optimizer import OptState

_STACKED = re.compile(r"segments/(\d+)/(\d+)/(.*)")


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in sorted(tree.items()):
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix.rstrip("/")] = np.asarray(tree)
    return out


def save_checkpoint(path: str, params, opt_state: Optional[OptState] = None,
                    meta: Optional[dict] = None, *, cfg):
    """Write ``params`` (and ``opt_state``) of the model ``cfg`` under the
    reference's keys; bf16 leaves as float32."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays = {"params/" + k: v
              for k, v in _flatten(params_to_numpy(params, cfg)).items()}
    if opt_state is not None:
        arrays["opt/step"] = host_numpy(opt_state.step)
        for name, tree in (("m", opt_state.m), ("v", opt_state.v)):
            arrays.update({f"opt/{name}/{k}": v for k, v in
                           _flatten(params_to_numpy(tree, cfg)).items()})
    np.savez(path, **arrays)
    if meta is not None:
        with open(path + ".meta.json", "w") as f:
            json.dump(meta, f, indent=2)


def _per_layer(flat):
    """A flat tree in either layout, with the stacked ``segments`` leaves
    cut into the port's ``layers/<i>/...`` ones.  The layer order is the
    reference's execution order — segment, then period, then pattern
    position — and each segment's periods are its leaves' leading axis,
    so the file alone fixes the mapping."""
    out, stacked = {}, {}
    for key, arr in flat.items():
        m = _STACKED.fullmatch(key)
        if m is None:
            out[key] = arr
        else:
            si, pi, rest = int(m[1]), int(m[2]), m[3]
            stacked.setdefault(si, {}).setdefault(pi, {})[rest] = arr
    layer = 0
    for si in sorted(stacked):
        positions = stacked[si]
        n_pos = max(positions) + 1
        n_periods = len(next(iter(positions[0].values())))
        for period in range(n_periods):
            for pi in range(n_pos):
                for rest, arr in positions[pi].items():
                    out[f"layers/{layer}/{rest}"] = arr[period]
                layer += 1
    return out


def _tensor(arr, like: torch.Tensor):
    """A stored leaf as a tensor typed and placed as ``like``; ``V2``
    records are the bits of bf16 values."""
    arr = np.asarray(arr)
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        t = torch.from_numpy(np.array(arr).view(np.int16)).view(
            torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    return t.to(device=like.device, dtype=like.dtype)


def _unflatten_into(template, flat, prefix):
    if isinstance(template, dict):
        return {k: _unflatten_into(v, flat, f"{prefix}{k}/")
                for k, v in template.items()}
    if isinstance(template, (tuple, list)):
        return type(template)(_unflatten_into(v, flat, f"{prefix}{i}/")
                              for i, v in enumerate(template))
    return _tensor(flat[prefix.rstrip("/")], template)


def load_checkpoint(path: str, params_template,
                    opt_template: Optional[OptState] = None):
    """(params, opt_state or None) from ``path`` — written by either
    package — shaped, placed and typed as the templates."""
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    sub = lambda pre: _per_layer({k[len(pre):]: v for k, v in flat.items()
                                  if k.startswith(pre)})
    params = _unflatten_into(params_template, sub("params/"), "")
    opt_state = None
    if opt_template is not None and "opt/step" in flat:
        opt_state = OptState(
            step=_tensor(flat["opt/step"], opt_template.step),
            m=_unflatten_into(opt_template.m, sub("opt/m/"), ""),
            v=_unflatten_into(opt_template.v, sub("opt/v/"), ""))
    return params, opt_state
