"""Physical paged KV cache: the tensors behind the block bookkeeping.

``SharedBlockAllocator`` (cache/shared_allocator.py) hands out abstract
block ids with ref-counted sharing, CoW, and LRU retention.  This module
makes those ids PHYSICAL: block id ``b`` owns token slots
``[b*block_size, (b+1)*block_size)`` of a flat pool tensor per attention
layer (``transformer.init_paged_cache``), and each resident request's
batch row carries an int32 block table mapping logical block index ->
block id.  Prefix reuse, migration, and admission all become block-table
pointer updates:

  * a prefix-cache hit takes *references* on the matched blocks — the
    new row's table simply aliases them (no tensor gather);
  * migration ships only the blocks a request owns, and the destination
    aliases whatever prefix blocks it already caches;
  * device-memory admission is bounded by blocks actually referenced,
    not by ``n_slots x max_seq`` worth of reserved rows.

The pool is device memory on ``device``, stacked over layers
(``{"k": [L, P + 1, Hkv, Dh], ...}``; row P is the dump slot of
``attention.paged_write`` and belongs to no block) and UPDATED IN PLACE;
tables live host-side as numpy (they are per-iteration inputs, bucketed
by ``batching.pack_mixed``).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.cache.shared_allocator import SharedBlockAllocator
from repro_torch.models import transformer as tf
from repro_torch.models.config import DTYPES


class PagedKVCache:
    def __init__(self, cfg, n_slots: int, max_seq: int, num_blocks: int,
                 block_size: int, dtype=None,
                 allocator: Optional[SharedBlockAllocator] = None,
                 quant: Optional[str] = None, device="cuda"):
        self.cfg = cfg
        self.n_slots = n_slots
        self.max_seq = max_seq
        self.block_size = block_size
        self.dtype = dtype
        self.quant = quant
        self.device = torch.device(device)
        # table width: blocks addressable by in-range positions.  The
        # allocator may hold MORE blocks for a request (growth headroom
        # beyond max_seq is never read or written) — tables truncate.
        self.max_blocks = -(-max_seq // block_size)
        self.allocator = allocator or SharedBlockAllocator(
            num_blocks, block_size)
        if self.allocator.block_size != block_size:
            raise ValueError("allocator/pool block_size mismatch")
        self.num_blocks = self.allocator.num_blocks
        self.pool = tf.init_paged_cache(cfg, self.num_blocks, block_size,
                                        dtype, quant=quant,
                                        device=self.device)
        self.tables = np.full((n_slots, self.max_blocks), -1, np.int32)
        self._fill = np.zeros(n_slots, np.int32)   # valid entries per row

    # ------------------------------------------------------------------
    # bookkeeping <-> tensors
    # ------------------------------------------------------------------
    def rebind_allocator(self, allocator: SharedBlockAllocator):
        """Adopt an externally owned allocator (the instance's prefix
        cache): its block ids become the pool's physical indices.  Must
        happen before any KV is written (the pool is rebuilt when the
        block count differs)."""
        if allocator is self.allocator:
            return
        if allocator.block_size != self.block_size:
            raise ValueError("allocator/pool block_size mismatch")
        self.allocator = allocator
        if allocator.num_blocks != self.num_blocks:
            self.num_blocks = allocator.num_blocks
            self.pool = None          # free the old pool before the new
            self.pool = tf.init_paged_cache(self.cfg, self.num_blocks,
                                            self.block_size, self.dtype,
                                            quant=self.quant,
                                            device=self.device)
        self.tables.fill(-1)
        self._fill.fill(0)

    def blocks_for(self, tokens: int) -> int:
        return self.allocator.blocks_for(tokens)

    def ensure(self, rid: int, tokens: int):
        """Executor-owned bookkeeping growth: reserve blocks so ``rid``
        can hold ``tokens`` total context (no-op when already covered)."""
        if not self.allocator.holds(rid):
            self.allocator.allocate(rid, tokens)
        else:
            self.allocator.extend(rid, tokens)

    def refresh_row(self, slot: int, rid: int):
        """Rebuild a slot's block table from the allocator's ordered
        owned-block list (logical block i == i-th owned block)."""
        self.tables[slot].fill(-1)
        bids = self.allocator.owned(rid)[: self.max_blocks]
        if bids:
            self.tables[slot, : len(bids)] = bids
        self._fill[slot] = len(bids)

    def refresh_row_if_grown(self, slot: int, rid: int):
        """Decode steady-state fast path: a live request's owned list is
        append-only (the engine never CoW-forks blocks it holds — writes
        only ever target exclusively owned tail blocks), so the table is
        stale only when the owned COUNT changed since the last refresh
        — once per block_size tokens, not per step."""
        n = min(self.allocator.owned_count(rid), self.max_blocks)
        if n != self._fill[slot]:
            self.refresh_row(slot, rid)

    def grow_for(self, slot: int, rid: int, tokens: int,
                 external_bookkeeping: bool):
        """Dispatch-time growth: make sure ``rid`` owns blocks covering
        ``tokens`` total context (skipped under external bookkeeping,
        where the Instance already extended the shared allocator) and
        bring the slot's table up to date.  Returns the table row."""
        if not external_bookkeeping:
            self.ensure(rid, tokens)
        self.refresh_row_if_grown(slot, rid)
        return self.tables[slot]

    def clear_row(self, slot: int):
        self.tables[slot].fill(-1)
        self._fill[slot] = 0

    def row_bids(self, slot: int) -> List[int]:
        return [int(b) for b in self.tables[slot] if b >= 0]

    # ------------------------------------------------------------------
    # migration: ship / land owned blocks
    # ------------------------------------------------------------------
    def _token_index(self, bids: Sequence[int]):
        idx = (np.asarray(bids, np.int64)[:, None] * self.block_size
               + np.arange(self.block_size, dtype=np.int64)).reshape(-1)
        return torch.from_numpy(idx).to(self.device)

    def extract_blocks(self, bids: Sequence[int]):
        """Gather whole blocks out of the pool: a dict of leaves
        [L, len(bids)*bs, Hkv, Dh] in logical order (new tensors)."""
        idx = self._token_index(bids)
        return {name: leaf.index_select(1, idx)
                for name, leaf in self.pool.items()}

    def insert_blocks(self, bids: Sequence[int], blocks,
                      skip_blocks: int = 0):
        """Scatter shipped blocks into this pool at ``bids`` (logical
        order), in place.  The first ``skip_blocks`` are skipped — the
        destination already caches them and the table aliases its own
        copies.  The blocks may lie on the host (spill and replication
        payloads); their leaves must be this pool's, in its types — a
        payload is never cast."""
        take = bids[skip_blocks:]
        if not take:
            return
        if set(blocks) != set(self.pool) or any(
                blocks[name].dtype != leaf.dtype
                for name, leaf in self.pool.items()):
            have = {n: str(t.dtype) for n, t in blocks.items()}
            want = {n: str(t.dtype) for n, t in self.pool.items()}
            raise ValueError(f"shipped blocks {have} do not match this "
                             f"pool's leaves {want}")
        idx = self._token_index(take)
        off = skip_blocks * self.block_size
        n = len(take) * self.block_size
        for name, leaf in self.pool.items():
            src = blocks[name][:, off:off + n]
            leaf.index_copy_(1, idx, src.to(self.device))

    # ------------------------------------------------------------------
    def token_bytes(self) -> int:
        """KV bytes per cached token, summed over layers."""
        return sum((a.numel() // a.shape[1]) * a.element_size()
                   for a in self.pool.values())

    def pool_bytes(self) -> int:
        """Bytes of the ``num_blocks * block_size`` token slots (the dump
        row is not a slot and is not counted)."""
        return self.token_bytes() * self.num_blocks * self.block_size

    def effective_capacity_ratio(self) -> float:
        """Resident tokens per device byte relative to the unquantized
        pool (1.0 when quantization is off)."""
        if self.quant is None:
            return 1.0
        ref = PagedKVCache.token_bytes_for(self.cfg, self.dtype)
        return ref / self.token_bytes()

    @staticmethod
    def token_bytes_for(cfg, dtype=None, quant: Optional[str] = None) -> int:
        """KV bytes per cached token for a config without materializing
        a pool (sizing block budgets)."""
        if quant not in (None, "int8"):
            raise ValueError(f"unsupported KV quantization {quant!r}")
        per_head = cfg.num_layers * 2 * cfg.num_kv_heads
        if quant == "int8":
            return per_head * (cfg.head_dim + 4)
        itemsize = (DTYPES[cfg.dtype][1] if dtype is None
                    else torch.empty((), dtype=dtype).element_size())
        return per_head * cfg.head_dim * itemsize

    # ------------------------------------------------------------------
    # invariants (exercised by property tests)
    # ------------------------------------------------------------------
    def check_invariants(self):
        """A block referenced by k live table rows must carry at least k
        request references (every live row's rid holds one per owned
        block — a table must never outlive its blocks), and the
        allocator's conservation law holds."""
        a = self.allocator
        assert a.free_blocks + a.cached_blocks + a.used_blocks \
            == a.num_blocks
        counts: dict = {}
        for slot in range(self.n_slots):
            for b in self.row_bids(slot):
                counts[b] = counts.get(b, 0) + 1
        for b, n in counts.items():
            assert a.refcount(b) >= n, (b, n, a.refcount(b))
