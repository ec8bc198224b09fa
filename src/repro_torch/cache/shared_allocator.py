"""Ref-counted, copy-on-write paged block allocator with LRU retention.

Extends the ``BlockAllocator`` invariants (kvcache.py) to shared blocks:

  * a block may be owned by MANY readers — ``refcount(bid) >= 1`` while
    any request holds it, and it is returned to circulation only when
    the count reaches 0;
  * ``free + cached + used == total`` always, where *used* counts
    distinct referenced blocks, *cached* counts refcount-0 blocks
    retained for prefix reuse (registered in a prefix tree), and *free*
    counts immediately reusable blocks;
  * a cached block is only ever reclaimed through ``evict`` — which
    refuses blocks with ``refcount > 0``;
  * writes into a shared block go through ``fork`` (copy-on-write): the
    writer gets a private copy, the original keeps its other readers.

Admission math (``can_allocate`` / ``can_extend``) is over *available*
blocks (free + evictable), so with nothing cached the allocator behaves
bit-identically to the exclusive ``BlockAllocator``.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Sequence, Set

from repro_torch.engine.kvcache import OutOfBlocks


class SharedBlockAllocator:
    def __init__(self, num_blocks: int, block_size: int = 16,
                 on_evict: Optional[Callable] = None,
                 pick_eviction: Optional[Callable] = None):
        """on_evict(bid): eviction notifier (prefix tree node removal).
        pick_eviction(): returns the bid to reclaim next (e.g. LRU leaf
        of the prefix tree); defaults to the internal LRU order."""
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.on_evict = on_evict
        self.pick_eviction = pick_eviction
        self._refcount: Dict[int, int] = {}
        self._owned: Dict[int, List[int]] = {}        # rid -> ordered bids
        self._free: List[int] = list(range(num_blocks - 1, -1, -1))
        self._cached: "OrderedDict[int, None]" = OrderedDict()
        self._registered: Set[int] = set()
        self.eviction_count = 0

    # ------------------------------------------------------------------
    # BlockAllocator-compatible surface
    # ------------------------------------------------------------------
    def blocks_for(self, tokens: int) -> int:
        return -(-max(tokens, 1) // self.block_size)

    @property
    def free_blocks(self) -> int:
        """Immediately free (no eviction needed)."""
        return len(self._free)

    @property
    def cached_blocks(self) -> int:
        """Refcount-0 blocks retained for reuse (evictable on demand)."""
        return len(self._cached)

    @property
    def available_blocks(self) -> int:
        return len(self._free) + len(self._cached)

    @property
    def used_blocks(self) -> int:
        """Distinct blocks referenced by at least one request."""
        return len(self._refcount)

    def utilization(self) -> float:
        return self.used_blocks / self.num_blocks

    def holds(self, rid: int) -> bool:
        return rid in self._owned

    def refcount(self, bid: int) -> int:
        return self._refcount.get(bid, 0)

    def owned(self, rid: int) -> List[int]:
        return list(self._owned.get(rid, ()))

    def owned_count(self, rid: int) -> int:
        """len(owned(rid)) without copying the list (hot-path probe)."""
        return len(self._owned.get(rid, ()))

    def bytes_owned(self, rid: int, bytes_per_token: int) -> int:
        return (len(self._owned.get(rid, ()))
                * self.block_size * bytes_per_token)

    # ------------------------------------------------------------------
    def can_allocate(self, tokens: int, shared=0) -> bool:
        """``shared``: count of prefix blocks, or the bid list itself.
        With the list, currently-cached shared bids are excluded from the
        evictable pool (referencing them removes them from it)."""
        if isinstance(shared, int):
            n_shared, cached_shared = shared, 0
        else:
            n_shared = len(shared)
            cached_shared = sum(1 for b in shared if b in self._cached)
        return (self.blocks_for(tokens) - n_shared
                <= self.available_blocks - cached_shared)

    def allocate(self, rid: int, tokens: int,
                 shared: Sequence[int] = ()) -> None:
        """Reserve blocks for a request: take a reference on each block
        in ``shared`` (the matched prefix, in order) and draw fresh
        exclusive blocks for the remainder."""
        if rid in self._owned:
            raise ValueError(f"rid {rid} already allocated")
        need = self.blocks_for(tokens)
        n_fresh = need - len(shared)
        if n_fresh < 0:
            raise ValueError("shared prefix longer than allocation")
        # refs first, so eviction below can never reclaim the prefix.
        # Roll back on a mid-list failure (a bid evicted between the
        # caller's peek and this claim): partial increfs must not leak.
        taken = 0
        try:
            for bid in shared:
                self._incref(bid)
                taken += 1
        except KeyError:
            for bid in shared[:taken]:
                self._decref(bid)
            raise
        fresh: List[int] = []
        try:
            for _ in range(n_fresh):
                fresh.append(self._take_fresh())
        except OutOfBlocks:
            self._free.extend(fresh)           # return partial draw
            for bid in shared:
                self._decref(bid)
            raise
        self._owned[rid] = list(shared) + fresh
        for bid in fresh:
            self._refcount[bid] = 1

    def can_extend(self, rid: int, tokens: int) -> bool:
        need = self.blocks_for(tokens) - len(self._owned.get(rid, ()))
        return need <= self.available_blocks

    def extend(self, rid: int, tokens: int) -> None:
        held = self._owned.get(rid)
        if held is None:
            raise KeyError(rid)
        extra = self.blocks_for(tokens) - len(held)
        fresh: List[int] = []
        try:
            for _ in range(max(extra, 0)):
                fresh.append(self._take_fresh())
        except OutOfBlocks:
            self._free.extend(fresh)          # atomic: return partial draw
            raise
        for bid in fresh:
            self._refcount[bid] = 1
            held.append(bid)

    def free(self, rid: int) -> int:
        """Drop all of a request's references.  Reversed order puts
        suffix blocks at the LRU end, so prefixes outlive their tails."""
        held = self._owned.pop(rid, [])
        for bid in reversed(held):
            self._decref(bid)
        return len(held)

    # ------------------------------------------------------------------
    # sharing / CoW / retention
    # ------------------------------------------------------------------
    def fork(self, rid: int, index: int) -> int:
        """Copy-on-write: replace the request's ``index``-th block with a
        private copy iff it is shared (refcount > 1).  Returns the bid
        the request now owns at that position."""
        held = self._owned[rid]
        bid = held[index]
        if self._refcount[bid] <= 1:
            return bid
        new = self._take_fresh()
        self._refcount[new] = 1
        held[index] = new
        self._decref(bid)
        return new

    def register(self, bid: int) -> None:
        """Mark a block's content as cacheable: at refcount 0 it is
        retained (LRU) instead of freed."""
        if self._refcount.get(bid, 0) <= 0 and bid not in self._cached:
            raise KeyError(f"bid {bid} not live")
        self._registered.add(bid)

    def is_registered(self, bid: int) -> bool:
        return bid in self._registered

    def evict(self, bid: int) -> None:
        """Reclaim one cached block.  Never touches referenced blocks."""
        if self._refcount.get(bid, 0) > 0:
            raise ValueError(f"evicting referenced block {bid}")
        if bid not in self._cached:
            raise KeyError(bid)
        del self._cached[bid]
        self._registered.discard(bid)
        self._free.append(bid)
        self.eviction_count += 1
        if self.on_evict is not None:
            self.on_evict(bid)

    # ------------------------------------------------------------------
    # tier promotion / replication support
    # ------------------------------------------------------------------
    def adopt_cached(self) -> int:
        """Draw a block directly into the retained cache (refcount 0,
        registered) — the HBM landing spot for a block promoted from a
        lower tier or replicated in from another instance.  May evict
        other cached blocks to make room (which re-spills them when a
        spill tier is wired to ``on_evict``)."""
        bid = self._take_fresh()
        self._registered.add(bid)
        self._cached[bid] = None
        return bid

    def pin(self, bid: int) -> None:
        """Take a reference on a live or cached block.  Guards multi-step
        promotions: a pinned block can neither be evicted nor picked as
        a victim while tensor copies for its neighbours are in flight."""
        self._incref(bid)

    def unpin(self, bid: int) -> None:
        self._decref(bid)

    # ------------------------------------------------------------------
    def _incref(self, bid: int) -> None:
        n = self._refcount.get(bid, 0)
        if n == 0:
            if bid not in self._cached:
                raise KeyError(f"bid {bid} not shareable")
            del self._cached[bid]
        self._refcount[bid] = n + 1

    def _decref(self, bid: int) -> None:
        n = self._refcount[bid] - 1
        if n > 0:
            self._refcount[bid] = n
            return
        del self._refcount[bid]
        if bid in self._registered:
            self._cached[bid] = None          # newest LRU position
        else:
            self._free.append(bid)

    def _take_fresh(self) -> int:
        if self._free:
            return self._free.pop()
        if not self._cached:
            raise OutOfBlocks("no free or evictable blocks")
        victim = None
        if self.pick_eviction is not None:
            victim = self.pick_eviction()
        if victim not in self._cached or self._refcount.get(victim, 0) > 0:
            # the callback is advisory, never trusted: a referenced,
            # unknown, or already-evicted victim would corrupt the pool
            # (double-free / dropping live KV) — fall back to LRU order
            victim = next(iter(self._cached))     # oldest retained
        self.evict(victim)
        return self._free.pop()
