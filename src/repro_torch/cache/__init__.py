"""Shared-prefix KV-cache subsystem: ref-counted copy-on-write block
sharing, a radix tree over per-block token hashes, and the per-instance
facade that admission/routing consults (see prefix_cache.py)."""
from repro_torch.cache.prefix_cache import PrefixCache
from repro_torch.cache.prefix_tree import PrefixTree, chain_hashes
from repro_torch.cache.shared_allocator import SharedBlockAllocator

__all__ = ["PrefixCache", "PrefixTree", "SharedBlockAllocator",
           "chain_hashes"]
