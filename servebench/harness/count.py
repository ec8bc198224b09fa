"""Operations and bytes of the served work, counted from the served shapes,
and the card's published peaks.

The two paged kernels of the main path, per call (one layer):

* kernel 1, ``paged_decode`` (``kernels/csrc/paged_decode.cu``): one
  query token a row over the row's ``n`` keys.  Bytes: each active row's
  keys and values (``n`` x Hkv x D x 2 tensors), its query and output
  (Hq x D each) and its block-table entries; FLOPs: 4 Hq D n (QK^T and
  PV, two operations a multiply-add).
* kernel 2, ``paged_prefill`` (``kernels/csrc/paged_prefill.cu``): a row
  of ``v`` new tokens at offset ``s`` reads ``s + v`` keys; bytes as above
  with ``v`` queries and outputs; FLOPs 4 Hq D (v s + v (v + 1) / 2), the
  causal triangle.

Each input byte is counted once and each output byte once, whatever a
kernel reads again; rows that carry no work (padding rows, rows frozen
in a horizon) count nothing.  So a share of the roofline computed from
these counts is a lower bound of what the kernel achieves on the work
the request needed.

A model's FLOPs are its family's (``servebench/families/``): the shape
below is what the kernels count, and a family returns it.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Tuple

#: published dense peaks, per card name (NVIDIA's H100 SXM data sheet,
#: without sparsity, at the full 700 W power limit)
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops_per_s": 989e12,
                              "hbm_bytes_per_s": 3.35e12,
                              "power_limit_w": 700.0},
}


def peaks(device_name: str) -> dict:
    if device_name not in PEAKS:
        raise KeyError(f"no published peaks for {device_name!r}")
    return PEAKS[device_name]


@dataclasses.dataclass(frozen=True)
class Shape:
    """The sizes the counts need (a family's ``shape`` of the configuration
    file): ``layers`` is the number of layers that call kernels 1 and 2
    once a step."""
    layers: int
    d_model: int
    heads: int
    kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    block_size: int = 16
    kv_bytes: int = 2          # bytes of one cached element (bf16)
    act_bytes: int = 2         # bytes of a query / output element


def decode_call(shape: Shape, keys: Iterable[int]) -> Tuple[float, float]:
    """(FLOPs, bytes) of one kernel-1 call whose active rows read ``keys``
    keys each."""
    hq, hkv, dh = shape.heads, shape.kv_heads, shape.head_dim
    flops = nbytes = 0.0
    for n in keys:
        flops += 4.0 * hq * dh * n
        nbytes += (2.0 * n * hkv * dh * shape.kv_bytes
                   + 2.0 * hq * dh * shape.act_bytes
                   + 4.0 * -(-n // shape.block_size))
    return flops, nbytes


def prefill_call(shape: Shape, rows: Iterable[Tuple[int, int]]
                 ) -> Tuple[float, float]:
    """(FLOPs, bytes) of one kernel-2 call over rows of ``(start, valid)``
    (a decode row riding along is ``(position, 1)``)."""
    hq, hkv, dh = shape.heads, shape.kv_heads, shape.head_dim
    flops = nbytes = 0.0
    for s, v in rows:
        if v <= 0:
            continue
        n = s + v
        flops += 4.0 * hq * dh * (v * s + v * (v + 1) / 2.0)
        nbytes += (2.0 * n * hkv * dh * shape.kv_bytes
                   + 2.0 * v * hq * dh * shape.act_bytes
                   + 4.0 * -(-n // shape.block_size))
    return flops, nbytes


def least_seconds(flops: float, nbytes: float, device_name: str
                  ) -> Tuple[float, str]:
    """The least time the card could take, and which peak bounds it."""
    pk = peaks(device_name)
    t_f = flops / pk["bf16_flops_per_s"]
    t_b = nbytes / pk["hbm_bytes_per_s"]
    return (t_f, "flops") if t_f >= t_b else (t_b, "bytes")
