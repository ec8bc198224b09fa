"""The weights a cell serves: random, made from ``--seed`` on the device,
as the configuration's family lays them out (``servebench/families/``).

The weights are one flat buffer in the served type, filled by one draw
of a ``torch.Generator`` on the device and scaled group by group (a
group is a run of leaves with one standard deviation), so set-up makes
tens of GB in a few calls.  The leaves are views of that buffer, in the
family's order, and the family puts them into the params the program
and the reference take; nothing the program derives from them is read
back.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict

import torch

import families
from harness.traffic import rng_for

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def make_params(config: dict, seed: int, device, flat=None):
    """(params, flat): the weights of ``seed`` as views of one buffer.
    Given the ``flat`` of an earlier call, the new weights are drawn into
    it, so every view (and every CUDA graph that reads one) stays valid."""
    family = families.load(config)
    specs = family.leaf_specs(config)
    dtype = DTYPES[config["torch_dtype"]]
    total = sum(_numel(s) for _, s, _ in specs)
    if flat is None:
        flat = torch.empty(total, dtype=dtype, device=device)
    gen = torch.Generator(device=flat.device)
    gen.manual_seed(int(rng_for(seed, "weights").integers(1 << 62)))
    with torch.no_grad():
        flat.normal_(generator=gen)
        runs: Dict[str, tuple] = OrderedDict()
        off = 0
        for _, shape, g in specs:
            n = _numel(shape)
            lo, _ = runs.get(g, (off, off))
            runs[g] = (lo, off + n)
            off += n
        for g, (lo, hi) in runs.items():
            flat[lo:hi].mul_(family.group_std(config, g))
    leaves = {}
    off = 0
    for path, shape, _ in specs:
        n = _numel(shape)
        leaves[path] = flat[off:off + n].view(shape)
        off += n
    return family.tree(leaves, config), flat
