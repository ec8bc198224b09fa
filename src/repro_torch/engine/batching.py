"""Packing + bucketing for the batched prefill executor.

All prefill chunks of an iteration are packed into one padded
``[B, T_bucket]`` batch with per-row start positions, valid lengths, and
cache-slot indices.  Both axes are *bucketed* to a small set of sizes so
the number of jit compile variants stays bounded:

  * ``T`` is rounded up to the smallest configured token bucket (powers
    of two by default) — per-row valid lengths mask the padding;
  * ``B`` is rounded up to the next power of two — padding rows carry an
    out-of-range slot index so their cache scatter is dropped on-device.

Worst-case compile variants = ``len(t_buckets) * log2(max_batch)``, vs.
one variant per distinct (chunk length x batch size) pair without
bucketing.  Bigger buckets waste compute on padding; smaller buckets
compile more variants — the knob is ``JaxExecutor(t_buckets=...)``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np


def default_t_buckets(max_seq: int, smallest: int = 16) -> Tuple[int, ...]:
    """Powers of two from ``smallest`` up to (and including) max_seq."""
    buckets = []
    b = smallest
    while b < max_seq:
        buckets.append(b)
        b *= 2
    buckets.append(max_seq)
    return tuple(buckets)


def bucket(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n (next power of two beyond the largest)."""
    for b in buckets:
        if n <= b:
            return b
    b = max(buckets)
    while b < n:
        b *= 2
    return b


def bucket_batch(n: int) -> int:
    """Next power of two >= n."""
    b = 1
    while b < n:
        b *= 2
    return b


@dataclasses.dataclass
class PackedPrefill:
    """Host-side arrays for one packed prefill call.

    ``slots`` rows beyond the real batch hold ``n_slots`` (out of range):
    their on-device cache scatter drops, their gather clamps harmlessly.
    """
    tokens: np.ndarray      # [B, T] int32, zero-padded
    start: np.ndarray       # [B] int32 absolute start position per row
    valid: np.ndarray       # [B] int32 valid token count per row (0 = pad row)
    slots: np.ndarray       # [B] int32 cache row per request (or n_slots)


@dataclasses.dataclass
class PackedMixed:
    """Host-side arrays for one fused mixed prefill+decode call over the
    paged cache.  Decode rows are just chunks of length 1 (their token
    is the last sampled token, their start the row's position); padding
    rows have ``valid == 0`` and an all ``-1`` table (every KV write is
    dropped on-device)."""
    tokens: np.ndarray      # [B, T] int32, zero-padded
    start: np.ndarray       # [B] int32 absolute start position per row
    valid: np.ndarray       # [B] int32 valid token count per row (0 = pad)
    tables: np.ndarray      # [B, NB] int32 block tables (-1 = unallocated)


def pack_mixed(chunks, starts: Sequence[int], table_rows,
               t_buckets: Sequence[int], max_blocks: int,
               block_size: int) -> PackedMixed:
    """Pack mixed prefill chunks + decode steps into one bucketed batch.

    ``table_rows[i]`` is row i's full block table (np int32, -1 filled).
    All three batch axes are bucketed: T to the configured token
    buckets, B to the next power of two, and the table width NB to the
    smallest power of two covering every row's read frontier
    ``ceil((start + len) / block_size)`` (capped at ``max_blocks``) —
    so decode-heavy iterations over short contexts attend over far
    fewer kv columns than ``max_seq``.
    """
    B = bucket_batch(len(chunks))
    longest = max(len(c) for c in chunks)
    # decode-only iterations are the steady-state hot path: keep them at
    # T == 1 instead of padding to the smallest prefill bucket
    T = 1 if longest == 1 else bucket(longest, t_buckets)
    need = max(-(-(st + len(c)) // block_size)
               for c, st in zip(chunks, starts))
    NB = min(bucket_batch(max(need, 1)), max_blocks)
    if NB < need:
        raise ValueError(f"row needs {need} blocks, table holds {NB}")
    tokens = np.zeros((B, T), np.int32)
    start = np.zeros(B, np.int32)
    valid = np.zeros(B, np.int32)
    tables = np.full((B, NB), -1, np.int32)
    for i, (toks, st, row) in enumerate(zip(chunks, starts, table_rows)):
        take = len(toks)
        tokens[i, :take] = toks
        start[i] = st
        valid[i] = take
        tables[i] = row[:NB]
    return PackedMixed(tokens, start, valid, tables)


@dataclasses.dataclass
class PackedDecode:
    """Host-side arrays for one K-step fused decode-horizon call over the
    paged cache.  One row per scheduled decode request; padding rows have
    ``budget == 0`` and an all ``-1`` table, so the on-device done-mask
    freezes them at step 0 and every KV write they would make drops."""
    tokens: np.ndarray      # [B] int32 last sampled token per row
    start: np.ndarray       # [B] int32 current cache position per row
    budget: np.ndarray      # [B] int32 tokens this row may emit (0 = pad)
    tables: np.ndarray      # [B, NB] int32 block tables (-1 = unallocated)


def pack_decode(last_tokens: Sequence[int], positions: Sequence[int],
                budgets: Sequence[int], table_rows,
                max_blocks: int, block_size: int) -> PackedDecode:
    """Pack a decode-only horizon batch.  ``B`` buckets to the next power
    of two and the table width ``NB`` to the smallest power of two
    covering every row's end-of-horizon frontier ``ceil((pos + budget) /
    block_size)`` (capped at ``max_blocks`` — positions clamp on-device
    past ``max_seq``, so the cap is never short)."""
    B = bucket_batch(len(last_tokens))
    need = max(-(-(p + b) // block_size)
               for p, b in zip(positions, budgets))
    NB = min(bucket_batch(max(need, 1)), max_blocks)
    tokens = np.zeros(B, np.int32)
    start = np.zeros(B, np.int32)
    budget = np.zeros(B, np.int32)
    tables = np.full((B, NB), -1, np.int32)
    for i, (tok, p, b, row) in enumerate(
            zip(last_tokens, positions, budgets, table_rows)):
        tokens[i] = tok
        start[i] = p
        budget[i] = b
        tables[i] = row[:NB]
    return PackedDecode(tokens, start, budget, tables)


def pack_prefill(chunks, starts: Sequence[int], row_slots: Sequence[int],
                 n_slots: int, t_buckets: Sequence[int]) -> PackedPrefill:
    """Pack per-request prefill chunks (``chunks[i]`` = token list starting
    at absolute position ``starts[i]``, cache row ``row_slots[i]``) into
    one bucketed batch."""
    B = bucket_batch(len(chunks))
    T = bucket(max(len(c) for c in chunks), t_buckets)
    tokens = np.zeros((B, T), np.int32)
    start = np.zeros(B, np.int32)
    valid = np.zeros(B, np.int32)
    slots = np.full(B, n_slots, np.int32)
    for i, (toks, st, sl) in enumerate(zip(chunks, starts, row_slots)):
        take = len(toks)
        tokens[i, :take] = toks
        start[i] = st
        valid[i] = take
        slots[i] = sl
    return PackedPrefill(tokens, start, valid, slots)
