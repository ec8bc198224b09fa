"""Checkpointing: parameters and optimizer state as one flat ``.npz`` —
the reference's ``training/checkpoint.py`` and its key scheme
(``params/<path>``, ``opt/step``, ``opt/m/<path>``, ``opt/v/<path>``; a
path joins dict keys, sorted, and list indices with ``/``) over the
port's tree, plus ``<path>.meta.json``.  The tree is rebuilt from a
template, so a checkpoint restores onto freshly initialised parameters,
each leaf on the template leaf's device and in its type.  numpy has no
bfloat16: bf16 leaves are stored as float32 and come back bit-equal.
"""
from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from repro_torch.convert import host_numpy
from repro_torch.training.optimizer import OptState


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in sorted(tree.items()):
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix.rstrip("/")] = host_numpy(tree)
    return out


def save_checkpoint(path: str, params, opt_state: Optional[OptState] = None,
                    meta: Optional[dict] = None):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays = {"params/" + k: v for k, v in _flatten(params).items()}
    if opt_state is not None:
        arrays["opt/step"] = host_numpy(opt_state.step)
        arrays.update({"opt/m/" + k: v
                       for k, v in _flatten(opt_state.m).items()})
        arrays.update({"opt/v/" + k: v
                       for k, v in _flatten(opt_state.v).items()})
    np.savez(path, **arrays)
    if meta is not None:
        with open(path + ".meta.json", "w") as f:
            json.dump(meta, f, indent=2)


def _unflatten_into(template, flat, prefix):
    if isinstance(template, dict):
        return {k: _unflatten_into(v, flat, f"{prefix}{k}/")
                for k, v in template.items()}
    if isinstance(template, (tuple, list)):
        return type(template)(_unflatten_into(v, flat, f"{prefix}{i}/")
                              for i, v in enumerate(template))
    arr = flat[prefix.rstrip("/")]
    return torch.from_numpy(np.array(arr)).to(device=template.device,
                                              dtype=template.dtype)


def load_checkpoint(path: str, params_template,
                    opt_template: Optional[OptState] = None):
    """(params, opt_state or None) from ``path``, shaped, placed and
    typed as the templates."""
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    sub = lambda pre: {k[len(pre):]: v for k, v in flat.items()
                       if k.startswith(pre)}
    params = _unflatten_into(params_template, sub("params/"), "")
    opt_state = None
    if opt_template is not None and "opt/step" in flat:
        opt_state = OptState(
            step=_unflatten_into(opt_template.step,
                                 {"": flat["opt/step"]}, ""),
            m=_unflatten_into(opt_template.m, sub("opt/m/"), ""),
            v=_unflatten_into(opt_template.v, sub("opt/v/"), ""))
    return params, opt_state
