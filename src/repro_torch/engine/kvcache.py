"""Paged KV-cache block allocator (bookkeeping) + slot management.

The allocator tracks HBM occupancy in fixed-size token blocks per request
— this is what drives the memory-watermark decisions of flowing decode
scheduling (Algorithm 1's ``M``).  Invariants (property-tested):

  * a block is owned by at most one request;
  * free + used == total, always;
  * freeing a request returns exactly the blocks it held;
  * utilization() is monotone in the set of live requests' context lens.

The actual tensor cache in the JAX engine is slot-contiguous (slot index
== batch row, position == cache column): the allocator decides
*admission* and *eviction/migration*, the tensors follow.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional


class OutOfBlocks(Exception):
    pass


@dataclasses.dataclass
class BlockAllocator:
    num_blocks: int
    block_size: int = 16

    def __post_init__(self):
        self._owned: Dict[int, int] = {}      # rid -> blocks held
        self._free = self.num_blocks

    # ------------------------------------------------------------------
    def blocks_for(self, tokens: int) -> int:
        return -(-max(tokens, 1) // self.block_size)

    @property
    def free_blocks(self) -> int:
        return self._free

    @property
    def used_blocks(self) -> int:
        return self.num_blocks - self._free

    def utilization(self) -> float:
        return self.used_blocks / self.num_blocks

    def holds(self, rid: int) -> bool:
        return rid in self._owned

    # ------------------------------------------------------------------
    def allocate(self, rid: int, tokens: int):
        """Reserve blocks for a request's current context."""
        need = self.blocks_for(tokens)
        if rid in self._owned:
            raise ValueError(f"rid {rid} already allocated")
        if need > self._free:
            raise OutOfBlocks(f"need {need}, free {self._free}")
        self._owned[rid] = need
        self._free -= need

    def can_allocate(self, tokens: int) -> bool:
        return self.blocks_for(tokens) <= self._free

    def extend(self, rid: int, tokens: int):
        """Grow a request's reservation to cover ``tokens`` total context."""
        need = self.blocks_for(tokens)
        have = self._owned.get(rid)
        if have is None:
            raise KeyError(rid)
        if need <= have:
            return
        extra = need - have
        if extra > self._free:
            raise OutOfBlocks(f"extend needs {extra}, free {self._free}")
        self._owned[rid] = need
        self._free -= extra

    def can_extend(self, rid: int, tokens: int) -> bool:
        need = self.blocks_for(tokens) - self._owned.get(rid, 0)
        return need <= self._free

    def free(self, rid: int) -> int:
        held = self._owned.pop(rid, 0)
        self._free += held
        return held

    def bytes_owned(self, rid: int, bytes_per_token: int) -> int:
        return self._owned.get(rid, 0) * self.block_size * bytes_per_token


@dataclasses.dataclass
class SlotTable:
    """Batch-row slots of the tensor cache: rid <-> row index."""
    n_slots: int

    def __post_init__(self):
        self._slot_of: Dict[int, int] = {}
        self._free = list(range(self.n_slots - 1, -1, -1))

    def acquire(self, rid: int, avoid=()) -> int:
        """Pop a free slot; prefer one not in ``avoid`` (the engine's
        retained prefix-donor slots) so cached rows survive longest."""
        if not self._free:
            raise OutOfBlocks("no free slots")
        s = None
        if avoid:
            for i in range(len(self._free) - 1, -1, -1):
                if self._free[i] not in avoid:
                    s = self._free.pop(i)
                    break
        if s is None:
            s = self._free.pop()
        self._slot_of[rid] = s
        return s

    def acquire_slot(self, rid: int, slot: int) -> int:
        """Claim a SPECIFIC free slot (prefix-donor adoption)."""
        self._free.remove(slot)
        self._slot_of[rid] = slot
        return slot

    def release(self, rid: int) -> Optional[int]:
        s = self._slot_of.pop(rid, None)
        if s is not None:
            self._free.append(s)
        return s

    def slot(self, rid: int) -> int:
        return self._slot_of[rid]

    def slots_of(self, rids) -> List[int]:
        """Batch lookup for packed execution (one row per request)."""
        return [self._slot_of[r] for r in rids]

    def has(self, rid: int) -> bool:
        return rid in self._slot_of

    def is_free(self, slot: int) -> bool:
        return slot in self._free

    @property
    def free_slots(self) -> int:
        return len(self._free)
