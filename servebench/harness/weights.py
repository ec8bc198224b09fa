"""The model a cell serves: the port's ``ModelConfig`` built from the
configuration file, and random weights made from ``--seed`` on the
device.

The weights are one flat buffer in the served type, filled by one draw
of a ``torch.Generator`` on the device and scaled group by group (a
group is a run of leaves with one standard deviation), so set-up makes
tens of GB in a few calls.  The leaves are views of that buffer in the
port's layout (``models/transformer.py``: ``embed``, ``lm_head``,
``final_norm``, ``layers``); with tied embeddings ``lm_head`` is the
transposed view of ``embed``.  Norm gains are stored as offsets from 1,
the port's convention, and the reference reads them so.  The same
tensors go to the program and to the reference; nothing the program
derives from them is read back.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Dict, List, Tuple

import torch

from harness.traffic import rng_for

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def port_config(config: dict):
    """The ``repro_torch`` ModelConfig of a configuration file: the
    registry's entry for ``port_arch`` (its family and block pattern) with
    every size and constant taken from the file."""
    from repro_torch.configs import get_config
    base = get_config(config["port_arch"])
    heads = int(config["num_attention_heads"])
    return dataclasses.replace(
        base, name=config["name"],
        num_layers=int(config["num_hidden_layers"]),
        d_model=int(config["hidden_size"]),
        num_heads=heads,
        num_kv_heads=int(config["num_key_value_heads"]),
        d_ff=int(config["intermediate_size"]),
        vocab_size=int(config["vocab_size"]),
        head_dim=int(config.get("head_dim")
                     or int(config["hidden_size"]) // heads),
        qkv_bias=bool(config.get("attention_bias", False)),
        rope_theta=float(config["rope_theta"]),
        norm_eps=float(config["rms_norm_eps"]),
        dtype=config["torch_dtype"])


def leaf_specs(config: dict) -> List[Tuple[tuple, tuple, str]]:
    """(path, shape, group) of every drawn leaf, grouped so each group is
    one run of the flat buffer."""
    d = int(config["hidden_size"])
    ff = int(config["intermediate_size"])
    V = int(config["vocab_size"])
    hq = int(config["num_attention_heads"])
    hkv = int(config["num_key_value_heads"])
    dh = int(config.get("head_dim") or d // hq)
    L = int(config["num_hidden_layers"])
    bias = bool(config.get("attention_bias", False))
    groups: "OrderedDict[str, list]" = OrderedDict(
        (g, []) for g in ("embed", "fan_in_d", "fan_in_ff", "fan_in_heads",
                          "norm", "bias"))
    groups["embed"].append((("embed",), (V, d)))
    if not config.get("tie_word_embeddings", False):
        groups["fan_in_d"].append((("lm_head",), (d, V)))
    groups["norm"].append((("final_norm",), (d,)))
    for i in range(L):
        lay = ("layers", i)
        groups["norm"] += [(lay + ("ln1",), (d,)), (lay + ("ln2",), (d,))]
        groups["fan_in_d"] += [
            (lay + ("attn", "wq"), (d, hq * dh)),
            (lay + ("attn", "wk"), (d, hkv * dh)),
            (lay + ("attn", "wv"), (d, hkv * dh)),
            (lay + ("mlp", "w_gate"), (d, ff)),
            (lay + ("mlp", "w_up"), (d, ff))]
        groups["fan_in_heads"].append((lay + ("attn", "wo"), (hq * dh, d)))
        groups["fan_in_ff"].append((lay + ("mlp", "w_down"), (ff, d)))
        if bias:
            groups["bias"] += [(lay + ("attn", "bq"), (hq * dh,)),
                               (lay + ("attn", "bk"), (hkv * dh,)),
                               (lay + ("attn", "bv"), (hkv * dh,))]
    return [(path, shape, g) for g, leaves in groups.items()
            for path, shape in leaves]


def group_std(config: dict, group: str) -> float:
    init = config["init"]
    d = int(config["hidden_size"])
    hq = int(config["num_attention_heads"])
    dh = int(config.get("head_dim") or d // hq)
    return {"embed": float(init["embed_std"]),
            "fan_in_d": d ** -0.5,
            "fan_in_ff": int(config["intermediate_size"]) ** -0.5,
            "fan_in_heads": (hq * dh) ** -0.5,
            "norm": float(init["norm_std"]),
            "bias": float(init["bias_std"])}[group]


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def make_params(config: dict, seed: int, device, flat=None):
    """(params, flat): the weights of ``seed`` as views of one buffer.
    Given the ``flat`` of an earlier call, the new weights are drawn into
    it, so every view (and every CUDA graph that reads one) stays valid."""
    specs = leaf_specs(config)
    dtype = DTYPES[config["torch_dtype"]]
    total = sum(_numel(s) for _, s, _ in specs)
    if flat is None:
        flat = torch.empty(total, dtype=dtype, device=device)
    gen = torch.Generator(device=flat.device)
    gen.manual_seed(int(rng_for(seed, "weights").integers(1 << 62)))
    with torch.no_grad():
        flat.normal_(generator=gen)
        runs: Dict[str, list] = OrderedDict()
        off = 0
        for _, shape, g in specs:
            n = _numel(shape)
            lo, _ = runs.get(g, (off, off))
            runs[g] = (lo, off + n)
            off += n
        for g, (lo, hi) in runs.items():
            flat[lo:hi].mul_(group_std(config, g))
    params: dict = {"layers": [dict(attn={}, mlp={}) for _ in range(
        int(config["num_hidden_layers"]))]}
    off = 0
    for path, shape, _ in specs:
        n = _numel(shape)
        leaf = flat[off:off + n].view(shape)
        off += n
        node = params
        for key in path[:-1]:
            node = node[key]
        node[path[-1]] = leaf
    if config.get("tie_word_embeddings", False):
        params["lm_head"] = params["embed"].t()
    return params, flat
