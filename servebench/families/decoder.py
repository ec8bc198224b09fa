"""The ``decoder`` family: decoder-only transformers of the port's paged
main path (``models/transformer.py``), the Qwen2 and Yi / Llama blocks.

Weights, in the port's layout: ``embed`` [V, d], ``lm_head`` [d, V] (with
tied embeddings the transposed view of ``embed``), ``final_norm`` [d],
``layers[i]`` with ``ln1``, ``ln2`` [d], ``attn`` {``wq`` [d, Hq Dh],
``wk``, ``wv`` [d, Hkv Dh], ``wo`` [Hq Dh, d], ``bq``/``bk``/``bv`` with
``attention_bias``} and ``mlp`` {``w_gate``, ``w_up`` [d, F], ``w_down``
[F, d]}.  Norm gains are stored as offsets from 1, the port's convention,
and the reference (``reference/model.py``) reads them so.

The model step: a token at position ``p`` costs 2 x (the layer matrices'
parameters) + 4 Hq D (p + 1) in each layer, and a produced token also
costs its ``lm_head`` row (2 d V).  These are the model's FLOPs, not the
program's: padding rows and the logits of unfinished prefill rows are
not counted.  A request carries its prompt ids alone.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Iterable, List, Tuple

from harness import count
from reference import model as ref


def _sizes(config: dict):
    d = int(config["hidden_size"])
    hq = int(config["num_attention_heads"])
    return dict(d=d, ff=int(config["intermediate_size"]),
                V=int(config["vocab_size"]), hq=hq,
                hkv=int(config["num_key_value_heads"]),
                dh=int(config.get("head_dim") or d // hq),
                L=int(config["num_hidden_layers"]))


def port_config(config: dict):
    """The ``repro_torch`` ModelConfig of a configuration file: the
    registry's entry for ``port_arch`` (its family and block pattern) with
    every size and constant taken from the file."""
    from repro_torch.configs import get_config
    base = get_config(config["port_arch"])
    s = _sizes(config)
    return dataclasses.replace(
        base, name=config["name"], num_layers=s["L"], d_model=s["d"],
        num_heads=s["hq"], num_kv_heads=s["hkv"], d_ff=s["ff"],
        vocab_size=s["V"], head_dim=s["dh"],
        qkv_bias=bool(config.get("attention_bias", False)),
        rope_theta=float(config["rope_theta"]),
        norm_eps=float(config["rms_norm_eps"]),
        dtype=config["torch_dtype"])


def leaf_specs(config: dict) -> List[Tuple[tuple, tuple, str]]:
    """(path, shape, group) of every drawn leaf, grouped so each group is
    one run of the flat buffer."""
    s = _sizes(config)
    d, ff, V = s["d"], s["ff"], s["V"]
    hq, hkv, dh = s["hq"], s["hkv"], s["dh"]
    bias = bool(config.get("attention_bias", False))
    groups: "OrderedDict[str, list]" = OrderedDict(
        (g, []) for g in ("embed", "fan_in_d", "fan_in_ff", "fan_in_heads",
                          "norm", "bias"))
    groups["embed"].append((("embed",), (V, d)))
    if not config.get("tie_word_embeddings", False):
        groups["fan_in_d"].append((("lm_head",), (d, V)))
    groups["norm"].append((("final_norm",), (d,)))
    for i in range(s["L"]):
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
    s = _sizes(config)
    return {"embed": float(init["embed_std"]),
            "fan_in_d": s["d"] ** -0.5,
            "fan_in_ff": s["ff"] ** -0.5,
            "fan_in_heads": (s["hq"] * s["dh"]) ** -0.5,
            "norm": float(init["norm_std"]),
            "bias": float(init["bias_std"])}[group]


def tree(leaves: dict, config: dict) -> dict:
    """The params dict of the drawn views (``{path: tensor}``)."""
    params: dict = {"layers": [dict(attn={}, mlp={}) for _ in range(
        int(config["num_hidden_layers"]))]}
    for path, leaf in leaves.items():
        node = params
        for key in path[:-1]:
            node = node[key]
        node[path[-1]] = leaf
    if config.get("tie_word_embeddings", False):
        params["lm_head"] = params["embed"].t()
    return params


def logits(params, config, seqs, mm=ref.exact_mm):
    """``reference/model.py``'s logits; a request carries no inputs."""
    return ref.logits(params, config, [(t, first) for t, first, _ in seqs],
                      mm=mm)


def shape(config: dict, block_size: int) -> count.Shape:
    s = _sizes(config)
    return count.Shape(s["L"], s["d"], s["hq"], s["hkv"], s["dh"], s["ff"],
                       s["V"], block_size)


def layer_matrix_params(shape: count.Shape) -> int:
    d, dh = shape.d_model, shape.head_dim
    return (d * dh * (shape.heads + 2 * shape.kv_heads)
            + shape.heads * dh * d + 3 * d * shape.d_ff)


def model_flops(shape: count.Shape, rows: Iterable[Tuple[int, int, bool]],
                extras=()) -> float:
    """Model FLOPs of rows of ``(start, valid, produces a token)``; a
    request's prompt is all tokens, so ``extras`` adds nothing."""
    per_token = 2.0 * layer_matrix_params(shape) * shape.layers
    attn = 4.0 * shape.heads * shape.head_dim * shape.layers
    head = 2.0 * shape.d_model * shape.vocab
    flops = 0.0
    for s, v, emits in rows:
        if v <= 0:
            continue
        flops += v * per_token + attn * (v * s + v * (v + 1) / 2.0)
        if emits:
            flops += head
    return flops


#: a request carries its prompt ids alone: nothing is drawn for it
inputs = None


def request_kwargs(arrival) -> dict:
    return {}
