"""Per-instance shared-prefix KV cache: prefix tree + shared allocator.

The facade an ``Instance`` owns when prefix caching is enabled.  It is
pure bookkeeping (block ids, token hashes) — tensor reuse on the real
engine is the executor's ``claim_prefix``, which this layer caps.

Lifecycle per request:

  match_tokens(prompt)          # pure — proxy routing peeks at all instances
  acquire(rid, prompt, hit, n)  # admission: ref matched blocks + fresh rest
  commit(rid, prompt)           # prefill done: full prompt blocks -> tree
  release(rid)                  # decref; refcount-0 registered blocks are
                                # RETAINED (LRU) for future prefix hits

Eviction is demand-driven inside the allocator; the tree supplies the
LRU-*leaf* victim so interior prefixes stay matchable, and is notified
on every eviction so it never maps a reclaimed block.

With ``spill_blocks > 0`` a host-RAM tier catches evicted blocks: the
eviction notifier copies the block out (through the executor-installed
``fetch_block`` callback; bookkeeping-only on the simulator) before the
tree forgets it, and ``prefetch`` promotes contiguous spilled extensions
of a prompt's HBM prefix back into the pool ahead of admission — a radix
match that once hit never silently degrades to recompute while the host
tier still holds the blocks.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

from repro_torch.cache.prefix_tree import PrefixTree
from repro_torch.cache.shared_allocator import SharedBlockAllocator
from repro_torch.cache.spill import HostSpillPool
from repro_torch.engine.kvcache import OutOfBlocks


class PrefixCache:
    def __init__(self, num_blocks: int, block_size: int = 16,
                 spill_blocks: int = 0):
        self.block_size = block_size
        self.tree = PrefixTree(block_size)
        self.spill = (HostSpillPool(spill_blocks, block_size)
                      if spill_blocks > 0 else None)
        self._fetch_block: Optional[Callable] = None
        self._load_block: Optional[Callable] = None
        self.allocator = SharedBlockAllocator(
            num_blocks, block_size,
            on_evict=self._on_evict,
            pick_eviction=self._pick_lru_leaf)

    def _pick_lru_leaf(self) -> Optional[int]:
        node = self.tree.lru_evictable(
            lambda bid: self.allocator.refcount(bid) == 0)
        return None if node is None else node.bid

    # ------------------------------------------------------------------
    # host spill tier
    # ------------------------------------------------------------------
    def bind_tiers(self, fetch_block: Optional[Callable] = None,
                   load_block: Optional[Callable] = None):
        """Executor hook: ``fetch_block(bid) -> payload`` copies a pool
        block to host memory, ``load_block(bid, payload)`` writes one
        back.  Unbound (the simulator) the spill tier is bookkeeping
        only — capacity and hit modeling without tensor traffic."""
        self._fetch_block = fetch_block
        self._load_block = load_block

    def _on_evict(self, bid: int):
        if self.spill is not None:
            nodes = self.tree._by_bid.get(bid, ())
            payload = (self._fetch_block(bid)
                       if nodes and self._fetch_block is not None else None)
            for node in nodes:
                self.spill.put(node.chain, node.tokens, payload)
        self.tree.remove_bid(bid)

    def prefetch(self, prompt_tokens: Sequence[int]) -> int:
        """Promote host-spilled blocks that contiguously extend the
        prompt's HBM-resident prefix back into the pool.  Returns tokens
        promoted.  The path is pinned for the duration so the evictions
        that make room can never reclaim what is being promoted."""
        if self.spill is None or not len(self.spill):
            return 0
        bs = self.block_size
        cap = self.max_match_tokens(prompt_tokens) // bs
        if cap <= 0:
            return 0
        path = self.tree.match(prompt_tokens, cap)
        depth = len(path)
        if depth >= cap:
            return 0
        run = self.spill.match_from(prompt_tokens, depth, cap, touch=False)
        if not run:
            return 0
        alloc = self.allocator
        bids = [n.bid for n in path]
        pinned: List[int] = []
        promoted = 0
        try:
            for bid in bids:
                alloc.pin(bid)
                pinned.append(bid)
            for chain, payload in run:
                if self._load_block is not None and payload is None:
                    break       # bookkeeping-only entry on a tensor engine
                try:
                    # may cascade-evict (re-spilling victims) to make room
                    bid = alloc.adopt_cached()
                except OutOfBlocks:
                    break
                if chain not in self.spill:
                    # the eviction cascade above LRU-dropped this very
                    # entry from the host tier: undo the adoption
                    alloc.evict(bid)
                    break
                alloc.pin(bid)
                pinned.append(bid)
                if self._load_block is not None:
                    self._load_block(bid, payload)
                self.spill.take(chain)
                bids.append(bid)
                promoted += 1
                self.tree.insert(
                    prompt_tokens[:(depth + promoted) * bs], bids)
        finally:
            for bid in reversed(pinned):
                alloc.unpin(bid)
        return promoted * bs

    @property
    def spilled_blocks(self) -> int:
        return 0 if self.spill is None else len(self.spill)

    def clear(self) -> int:
        """Total cache loss (instance crash): evict every cached
        refcount-0 block and drop the host spill tier with it — nothing
        survives the node.  Blocks still held by requests are untouched;
        evacuate those requests first.  Returns HBM blocks dropped."""
        spill, self.spill = self.spill, None   # no re-spilling mid-wipe
        dropped = 0
        try:
            for bid in list(self.allocator._cached):
                self.allocator.evict(bid)
                dropped += 1
        finally:
            self.spill = spill
        if self.spill is not None:
            self.spill.clear()
        return dropped

    # ------------------------------------------------------------------
    # cross-instance replication
    # ------------------------------------------------------------------
    def hot_prefixes(self, max_paths: int = 2,
                     min_hits: int = 3) -> List[tuple]:
        """Hottest matchable token prefixes, for the controller's
        epoch-boundary replication pass: ``[(token_prefix, hits)]``."""
        return self.tree.hot_paths(max_paths, min_hits)

    def admit_replica(self, tokens: Sequence[int],
                      n_blocks: int) -> Optional[Tuple[int, List[int]]]:
        """Adopt HBM blocks for a prefix replicated in from another
        instance.  Returns ``(skip, bids)`` — the full block list for
        the admitted prefix, of which the first ``skip`` were already
        resident (no tensor load needed) — or None when nothing new fit.
        Replicas never evict local content: adoption stops at the free
        watermark."""
        bs = self.block_size
        n_blocks = min(n_blocks, len(tokens) // bs)
        path = self.tree.match(tokens, n_blocks)
        skip = len(path)
        if skip >= n_blocks:
            return None
        alloc = self.allocator
        bids = [n.bid for n in path]
        pinned: List[int] = []
        try:
            for bid in bids:
                alloc.pin(bid)
                pinned.append(bid)
            for i in range(skip, n_blocks):
                if alloc.free_blocks <= 0:
                    break
                bid = alloc.adopt_cached()
                alloc.pin(bid)
                pinned.append(bid)
                bids.append(bid)
                self.tree.insert(tokens[:(i + 1) * bs], bids)
        finally:
            for bid in reversed(pinned):
                alloc.unpin(bid)
        if len(bids) <= skip:
            return None
        return skip, bids

    # ------------------------------------------------------------------
    def max_match_tokens(self, prompt_tokens: Sequence[int]) -> int:
        """Hit cap: full blocks only, and at least one token must remain
        to prefill (prefill emits the first output token)."""
        return ((len(prompt_tokens) - 1)
                // self.block_size * self.block_size)

    def match_tokens(self, prompt_tokens: Sequence[int]) -> int:
        """Longest reusable prefix in tokens.  Pure (no refcounts taken,
        no LRU recency touched) — this is what cache-aware routing peeks
        at on every instance per arrival."""
        cap = self.max_match_tokens(prompt_tokens) // self.block_size
        if cap <= 0:
            return 0
        return (len(self.tree.match(prompt_tokens, cap, touch=False))
                * self.block_size)

    def match_tokens_tiered(self, prompt_tokens: Sequence[int]) -> int:
        """HBM hit plus its contiguous host-spilled extension — what
        admission can reuse after a ``prefetch``.  Pure, for routing."""
        hbm = self.match_tokens(prompt_tokens)
        if self.spill is None or not len(self.spill):
            return hbm
        cap = self.max_match_tokens(prompt_tokens) // self.block_size
        depth = hbm // self.block_size
        if depth >= cap:
            return hbm
        run = self.spill.match_from(prompt_tokens, depth, cap, touch=False)
        return hbm + len(run) * self.block_size

    def matched_bids(self, prompt_tokens: Sequence[int], hit_tokens: int,
                     touch: bool = True) -> List[int]:
        n = hit_tokens // self.block_size
        return [nd.bid
                for nd in self.tree.match(prompt_tokens, n, touch=touch)][:n]

    # ------------------------------------------------------------------
    def can_acquire(self, prompt_tokens: Sequence[int], hit_tokens: int,
                    total_tokens: int) -> bool:
        """Pure admission check — run BEFORE the executor claims its
        slot/rows, so a memory-blocked request has no side effects to
        unwind."""
        shared = (self.matched_bids(prompt_tokens, hit_tokens, touch=False)
                  if hit_tokens else [])
        if len(shared) * self.block_size < hit_tokens:
            return False
        return self.allocator.can_allocate(total_tokens, shared)

    def acquire(self, rid: int, prompt_tokens: Sequence[int],
                hit_tokens: int, total_tokens: int) -> bool:
        """Admission: reference ``hit_tokens`` worth of cached prefix
        blocks and draw fresh blocks to cover ``total_tokens``.  False
        (nothing held) when even eviction can't make room."""
        shared = (self.matched_bids(prompt_tokens, hit_tokens)
                  if hit_tokens else [])
        if len(shared) * self.block_size < hit_tokens:
            return False                      # evicted between peek/claim
        if not self.allocator.can_allocate(total_tokens, shared):
            return False
        self.allocator.allocate(rid, total_tokens, shared=shared)
        return True

    def commit(self, rid: int, prompt_tokens: Sequence[int]) -> int:
        """Prefill complete: publish the request's full prompt blocks to
        the tree (first writer wins per position) and mark them retained.
        Returns how many blocks this request newly published."""
        bids = self.allocator.owned(rid)
        n_full = len(prompt_tokens) // self.block_size
        newly = self.tree.insert(prompt_tokens[:n_full * self.block_size],
                                 bids[:n_full])
        for bid in newly:
            self.allocator.register(bid)
        return len(newly)

    def release(self, rid: int) -> int:
        return self.allocator.free(rid)
