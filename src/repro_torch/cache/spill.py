"""Host-RAM spill tier for evicted KV blocks.

When the HBM block pool evicts a refcount-0 registered block, its
content is copied to a host-side buffer instead of being dropped, so a
later radix match can *prefetch* it back instead of silently
recomputing the prefix.  The tier is deliberately flat: one entry per
block, keyed by the block's **chained prefix hash** (the same hash the
``PrefixTree`` edges use), so

  * blocks spill independently and in any order — HBM eviction is
    LRU-leaf-first (children before parents), and a child entry whose
    ancestors are still HBM-resident needs no placeholder chain here;
  * a match walks the prompt's chain hashes and extends an HBM-resident
    prefix with the longest *contiguous* run of spilled blocks — a hole
    (an entry LRU-dropped from the host tier) truncates the run, never
    corrupts it;
  * content is verified against the stored block tokens on every hit,
    mirroring the tree's collision-degrades-to-miss guarantee.

Payloads are opaque to this module: the executor stores per-block host
copies of the paged pool leaves (numpy), the simulator stores ``None``
(bookkeeping-only tier — capacity/goodput modeling without tensors).
"""
from __future__ import annotations

from collections import OrderedDict
from typing import List, Optional, Sequence, Tuple

from repro_torch.cache.prefix_tree import chain_hashes


class HostSpillPool:
    def __init__(self, capacity_blocks: int, block_size: int = 16):
        self.capacity = capacity_blocks
        self.block_size = block_size
        # chain hash -> (block tokens, payload); insertion order == LRU
        self._entries: "OrderedDict[int, Tuple[tuple, object]]" = \
            OrderedDict()
        self.spilled = 0            # blocks ever accepted from HBM
        self.dropped = 0            # blocks LRU-dropped from the host tier
        self.promoted = 0           # blocks prefetched back to HBM

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, chain: int) -> bool:
        return chain in self._entries

    def clear(self) -> int:
        """Drop every spilled block (host memory of a crashed node is as
        gone as its HBM).  Returns entries dropped."""
        n = len(self._entries)
        self._entries.clear()
        return n

    # ------------------------------------------------------------------
    def put(self, chain: int, blk_tokens: Sequence[int],
            payload) -> bool:
        """Accept one evicted block.  Re-spilling the same content
        refreshes recency; overflow drops the oldest entries."""
        if self.capacity <= 0:
            return False
        self.spilled += chain not in self._entries
        self._entries[chain] = (tuple(blk_tokens), payload)
        self._entries.move_to_end(chain)
        while len(self._entries) > self.capacity:
            self._entries.popitem(last=False)
            self.dropped += 1
        return True

    def match_from(self, tokens: Sequence[int], start_block: int,
                   max_blocks: Optional[int] = None,
                   touch: bool = True) -> List[Tuple[int, object]]:
        """Contiguous run of spilled blocks extending an HBM-resident
        prefix of ``start_block`` full blocks: ``[(chain, payload)]``.
        ``touch=False`` keeps routing peeks side-effect free."""
        run: List[Tuple[int, object]] = []
        for i, (h, blk) in enumerate(chain_hashes(tokens, self.block_size)):
            if max_blocks is not None and i >= max_blocks:
                break
            if i < start_block:
                continue
            entry = self._entries.get(h)
            if entry is None or entry[0] != blk:
                break
            if touch:
                self._entries.move_to_end(h)
            run.append((h, entry[1]))
        return run

    def touch(self, chain: int) -> bool:
        """Refresh an entry's LRU recency without re-copying its
        payload (incremental checkpoint capture: present blocks are
        touched, only absent ones are exported again)."""
        if chain not in self._entries:
            return False
        self._entries.move_to_end(chain)
        return True

    def take(self, chain: int):
        """Remove an entry and return its payload (block promoted back
        to HBM — if it is evicted again it simply re-spills)."""
        _, payload = self._entries.pop(chain)
        self.promoted += 1
        return payload

    def stats(self) -> dict:
        return {"resident": len(self._entries), "capacity": self.capacity,
                "spilled": self.spilled, "dropped": self.dropped,
                "promoted": self.promoted}
