"""KV/state migration between instances — the substrate of flowing decode
scheduling — on the port's dense cache.

A dense cache (``models.transformer.init_cache``) is a dict of tensors
whose layout is ``[layers, B, ...]``: the batch axis (axis 1) is the
slot.  A migration extracts one slot across all leaves, ships it (the
*time* is charged by the estimator, ``CostModel.transfer_time``), and
inserts it into a free slot of the destination instance's cache.  Where
the reference returns updated copies of the cache, these operations
write the destination IN PLACE and return the same dict.
"""
from __future__ import annotations

from typing import Dict

import torch

#: leaves whose axis 2 is the token position (recurrent state has none)
_KV_LEAVES = ("k", "v")


def extract_row(cache: Dict[str, torch.Tensor], slot: int):
    """Copy one request's state out of the cache: ``{name: [layers, ...]}``."""
    return {name: leaf[:, slot].clone() for name, leaf in cache.items()}


def insert_row(cache: Dict[str, torch.Tensor], row, slot: int):
    """Write an extracted row into ``slot`` of the cache, in place."""
    for name, leaf in cache.items():
        leaf[:, slot].copy_(row[name])
    return cache


def copy_prefix(cache: Dict[str, torch.Tensor], src_slot: int,
                dst_slot: int, n_tokens: int):
    """Copy the first ``n_tokens`` KV columns of ``src_slot`` into
    ``dst_slot``, in place.  Only valid for full-cache attention families
    (KV at position p depends only on tokens [0, p] — recurrent state
    cannot be sliced at a token boundary)."""
    if set(cache) - set(_KV_LEAVES):
        raise ValueError("copy_prefix needs an attention-only cache: "
                         "recurrent state has no token boundary")
    for leaf in cache.values():
        leaf[:, dst_slot, :n_tokens].copy_(leaf[:, src_slot, :n_tokens])
    return cache


def zero_row(cache: Dict[str, torch.Tensor], slot: int):
    """Reset one slot's state in place (recurrent SSM/conv state must not
    leak between requests; KV is masked by position so zeroing is belt-
    and-braces)."""
    for leaf in cache.values():
        leaf[:, slot].zero_()
    return cache


def row_bytes(row) -> int:
    """Bytes of an extracted row (or of one slot's views of a cache)."""
    return sum(t.numel() * t.element_size() for t in row.values())
