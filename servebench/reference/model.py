"""The ``decoder`` family's reference (``families/decoder.py``): the plain
float32 forward of the benchmark's decoder-only models, as their
configuration files state them:

* Qwen2 (``Qwen/Qwen2.5-3B``): RMSNorm, rotary positions (half-split,
  ``rope_theta``), grouped-query attention with a bias on q, k and v,
  SwiGLU MLP, tied input and output embeddings;
* Yi / Llama (the text model of ``llava-hf/llava-v1.6-34b-hf``): the same
  block without the q/k/v bias, untied output embeddings.

The tensors are the benchmark's (``harness/weights.py``), in the served
layout (``families/decoder.py``): ``embed`` [V, d], ``lm_head`` [d, V],
``final_norm`` [d], ``layers[i]`` with ``ln1``, ``ln2`` [d], ``attn``
{``wq`` [d, Hq Dh], ``wk``, ``wv`` [d, Hkv Dh], ``wo`` [Hq Dh, d],
``bq``/``bk``/``bv``} and ``mlp`` {``w_gate``, ``w_up`` [d, F],
``w_down`` [F, d]}.  Norm gains are stored as offsets from 1 (the gain
is ``1 + w``).

The forward runs layer by layer over every sequence it is given, each
layer's weights cast to float32 only while that layer runs, so it fits
beside weights that fill most of the card.  Matrix products go through
``mm`` (``precision.py``): exact float32 (TF32 off) by default; ``fp8_mm``
rounds both operands to float8 e4m3 (per-row and per-column scales)
first, the precision a faster program might be tempted to serve in, and
is the comparison's control.
"""
from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import torch

from reference.precision import exact, exact_mm

#: queries a block of the attention products takes at once
Q_BLOCK = 1024


def rms_norm(x, w, eps):
    x = x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps)
    return x * (1.0 + w.float())


def rope(x, pos, theta):
    """x [T, H, D] at positions ``pos`` [T]; pairs (i, i + D/2)."""
    d = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                        device=x.device) / d))
    ang = pos.float()[:, None] * inv[None]
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(q, k, v, mm):
    """Causal grouped-query attention: q [T, Hq, D], k, v [T, Hkv, D]."""
    T, hq, d = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    kt = k.permute(1, 2, 0)                       # [Hkv, D, T]
    vh = v.permute(1, 0, 2)                       # [Hkv, T, D]
    out = torch.empty_like(q)
    for lo in range(0, T, Q_BLOCK):
        hi = min(lo + Q_BLOCK, T)
        qb = q[lo:hi].reshape(hi - lo, hkv, g, d).permute(1, 2, 0, 3)
        s = mm(qb.reshape(hkv, g * (hi - lo), d), kt) * d ** -0.5
        s = s.reshape(hkv, g, hi - lo, T)
        qpos = torch.arange(lo, hi, device=q.device)[:, None]
        kpos = torch.arange(T, device=q.device)[None]
        s = s.masked_fill(kpos > qpos, float("-inf"))
        p = torch.softmax(s, dim=-1).reshape(hkv, g * (hi - lo), T)
        o = mm(p, vh).reshape(hkv, g, hi - lo, d)
        out[lo:hi] = o.permute(2, 0, 1, 3).reshape(hi - lo, hq, d)
    return out


def block(x, w, config, mm):
    """One decoder layer on one sequence's hidden states x [T, d]."""
    hq = int(config["num_attention_heads"])
    hkv = int(config["num_key_value_heads"])
    d = int(config["hidden_size"])
    dh = int(config.get("head_dim") or d // hq)
    eps = float(config["rms_norm_eps"])
    theta = float(config["rope_theta"])
    T = x.shape[0]
    pos = torch.arange(T, device=x.device)
    a = w["attn"]
    h = rms_norm(x, w["ln1"], eps)
    q, k, v = mm(h, a["wq"]), mm(h, a["wk"]), mm(h, a["wv"])
    if "bq" in a:
        q, k, v = q + a["bq"], k + a["bk"], v + a["bv"]
    q = rope(q.reshape(T, hq, dh), pos, theta)
    k = rope(k.reshape(T, hkv, dh), pos, theta)
    o = attention(q, k, v.reshape(T, hkv, dh), mm)
    x = x + mm(o.reshape(T, hq * dh), a["wo"])
    h = rms_norm(x, w["ln2"], eps)
    m = w["mlp"]
    u = torch.nn.functional.silu(mm(h, m["w_gate"])) * mm(h, m["w_up"])
    return x + mm(u, m["w_down"])


def _f32(tree):
    if isinstance(tree, dict):
        return {k: _f32(v) for k, v in tree.items()}
    return tree.float()


@torch.no_grad()
def logits(params, config, seqs: Sequence[Tuple[torch.Tensor, int]],
           mm: Callable = exact_mm) -> List[torch.Tensor]:
    """For each (tokens [T], first) of ``seqs``: float32 logits [T - first,
    V] at positions first .. T - 1 (the logits that choose tokens first +
    1 .. T)."""
    exact()
    xs = [params["embed"][t.long()].float() for t, _ in seqs]
    for layer in params["layers"]:
        w = _f32(layer)
        xs = [block(x, w, config, mm) for x in xs]
        del w
    eps = float(config["rms_norm_eps"])
    head = params["lm_head"].float()
    out = [mm(rms_norm(x[first:], params["final_norm"], eps), head)
           for x, (_, first) in zip(xs, seqs)]
    del head
    return out
