"""Token-major layout of the paged mixed step.

``batching.pack_mixed`` pads an iteration's rows to one ``[B, T]`` grid:
B to a power of two, T to the bucket of the longest chunk, so a decode
row (a chunk of one token) beside a long chunk is almost all padding.
The paged chunked-prefill kernel reads its queries in that grid, but
every other layer of the step (projections, MLP, norms, RoPE, residuals)
works token by token.  :func:`pack_flat` lists the grid's valid tokens
row by row, so those layers run over them alone (``[1, N]``); the
model's ``attention.FlatRows`` maps them into the grid for the kernel
and back.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.engine.batching import PackedMixed

#: the flat token axis is a multiple of this (the tensor cores' tiles),
#: so the per-token layers see few distinct shapes
FLAT_ALIGN = 64


@dataclasses.dataclass
class PackedFlat:
    """Host-side arrays of one mixed step laid out token-major: the N
    tokens (N the valid tokens rounded up to ``FLAT_ALIGN``) of a
    ``PackedMixed`` grid [B, T], row by row, then padding."""
    tokens: np.ndarray      # [N] int32 token ids (0 = padding)
    positions: np.ndarray   # [N] int32 positions (0 = padding)
    index: np.ndarray       # [N] int32 grid cell b * T + t (B * T = padding)
    last: np.ndarray        # [B] int32 each row's last token (a pad row's: any)


def pack_flat(packed: PackedMixed, max_seq: int) -> PackedFlat:
    """The valid tokens of ``packed``, row by row, at their positions
    (clamped to ``max_seq - 1``, as the grid's step clamps them); padding
    tokens sit at position 0 and name the cell past the grid, so their KV
    goes to the pool's dump slot and their queries to no row."""
    B, T = packed.tokens.shape
    valid = packed.valid
    n = int(valid.sum())
    N = -(-max(n, 1) // FLAT_ALIGN) * FLAT_ALIGN
    cells = np.flatnonzero(np.arange(T)[None, :] < valid[:, None])
    grid_pos = np.minimum(packed.start[:, None] + np.arange(T)[None, :],
                          max_seq - 1)
    tokens = np.zeros(N, np.int32)
    positions = np.zeros(N, np.int32)
    index = np.full(N, B * T, np.int32)
    tokens[:n] = packed.tokens.reshape(-1)[cells]
    positions[:n] = grid_pos.reshape(-1)[cells]
    index[:n] = cells
    ends = np.cumsum(valid)
    last = np.maximum(ends - 1, 0).astype(np.int32)
    return PackedFlat(tokens, positions, index, last)
