"""Radix/prefix tree over per-block token hashes.

One node per KV block: the edge into a node is the *chained* hash of its
token block (hash of (parent_chain_hash, block tokens)), so a node at
depth ``d`` identifies a unique d-block token prefix.  Each node carries
an opaque ``bid`` — the allocator block id holding that block's KV
(instance-level sharing), or the cache slot whose row holds the whole
prefix up to this depth (engine-level donor index).

Matching walks the chain from the root and returns the node path; the
two users interpret it differently:

  * the block-level ``PrefixCache`` takes ``[n.bid for n in path]`` —
    every block along the path is individually reusable;
  * the engine donor index takes ``(len(path), path[-1].bid)`` — a node
    registered at depth d implies its slot row holds the *entire*
    d-block prefix (chains can only be extended by rows that contain
    their parents).

Token blocks are stored in the node and verified on match, so a 64-bit
hash collision degrades to a miss, never to wrong-token reuse.
"""
from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Sequence

_ROOT_HASH = 0


class Node:
    __slots__ = ("chain", "tokens", "bid", "parent", "children",
                 "last_used", "hit_count")

    def __init__(self, chain: int, tokens: tuple, bid, parent: "Node"):
        self.chain = chain
        self.tokens = tokens          # this block's token ids (verification)
        self.bid = bid
        self.parent = parent
        self.children: Dict[int, "Node"] = {}
        self.last_used = 0
        self.hit_count = 0            # touching matches through this node


def chain_hashes(tokens: Sequence[int], block_size: int):
    """Yields (chain_hash, block_tokens) per *full* block — lazily, so a
    walk that misses at depth k hashes only k+1 blocks, not the whole
    prompt (peeks run per instance per arrival)."""
    h = _ROOT_HASH
    for i in range(0, (len(tokens) // block_size) * block_size, block_size):
        blk = tuple(int(t) for t in tokens[i:i + block_size])
        h = hash((h, blk))
        yield h, blk


class PrefixTree:
    def __init__(self, block_size: int):
        self.block_size = block_size
        self.root = Node(_ROOT_HASH, (), None, None)
        self._by_bid: Dict[object, List[Node]] = {}
        self._clock = itertools.count(1)
        self.node_count = 0

    # ------------------------------------------------------------------
    def match(self, tokens: Sequence[int],
              max_blocks: Optional[int] = None,
              touch: bool = True) -> List[Node]:
        """Longest cached prefix: the node path (root excluded).

        ``touch=False`` keeps the walk side-effect free (LRU recency
        unchanged) — routing peeks probe EVERY instance, and must not
        refresh blocks on instances that never receive the request."""
        path: List[Node] = []
        node = self.root
        for h, blk in chain_hashes(tokens, self.block_size):
            if max_blocks is not None and len(path) >= max_blocks:
                break
            child = node.children.get(h)
            if child is None or child.tokens != blk:
                break
            if touch:
                child.last_used = next(self._clock)
                child.hit_count += 1
            path.append(child)
            node = child
        return path

    def insert(self, tokens: Sequence[int], bids: Sequence) -> List:
        """Register blocks for a full-block token prefix.  Existing nodes
        keep their original bid (first writer wins — duplicate-content
        blocks stay unregistered).  Returns the bids newly registered."""
        node = self.root
        newly = []
        for (h, blk), bid in zip(chain_hashes(tokens, self.block_size), bids):
            child = node.children.get(h)
            if child is None or child.tokens != blk:
                child = Node(h, blk, bid, node)
                node.children[h] = child
                self._by_bid.setdefault(bid, []).append(child)
                self.node_count += 1
                newly.append(bid)
            child.last_used = next(self._clock)
            node = child
        return newly

    # ------------------------------------------------------------------
    def holds(self, bid) -> bool:
        return bid in self._by_bid

    def bids(self):
        return self._by_bid.keys()

    def remove_bid(self, bid) -> None:
        """Drop every node registered under ``bid`` (block evicted, or
        slot row reused).  Detached subtrees become unmatchable; their
        nodes are pruned so they cannot resurface under a stale chain."""
        for node in self._by_bid.pop(bid, []):
            self._detach(node)

    def _detach(self, node: Node) -> None:
        # iterative (explicit stack): chains reach prompt_len/block_size
        # deep — 1024 for 16k contexts at block 16 — past the default
        # Python recursion limit
        if node.parent is None:
            return                            # already pruned
        node.parent.children.pop(node.chain, None)
        node.parent = None
        stack = [node]
        while stack:
            n = stack.pop()
            self.node_count -= 1
            # prune the (now unreachable) subtree from the bid index
            for child in n.children.values():
                bucket = self._by_bid.get(child.bid)
                if bucket is not None:
                    try:
                        bucket.remove(child)
                    except ValueError:
                        pass
                    if not bucket:
                        del self._by_bid[child.bid]
                child.parent = None
                stack.append(child)
            n.children.clear()

    # ------------------------------------------------------------------
    def hot_paths(self, max_paths: int = 2,
                  min_hits: int = 3) -> List[tuple]:
        """Hottest matchable prefixes for cross-instance replication:
        ``[(token_prefix, hits)]``, hottest first.  For every chain whose
        nodes each matched at least ``min_hits`` times, only the deepest
        such node is reported (a parent's hit count is always >= its
        children's, so the frontier is well defined)."""
        out = []
        stack = [(self.root, ())]
        while stack:
            node, toks = stack.pop()
            for child in node.children.values():
                ctoks = toks + child.tokens
                if child.hit_count >= min_hits:
                    if not any(c.hit_count >= min_hits
                               for c in child.children.values()):
                        out.append((ctoks, child.hit_count))
                    stack.append((child, ctoks))
        out.sort(key=lambda e: -e[1])
        return out[:max_paths]

    # ------------------------------------------------------------------
    def lru_evictable(self, evictable) -> Optional[Node]:
        """Least-recently-used *leaf* whose bid satisfies ``evictable``
        (leaf-first keeps interior prefixes matchable, sglang-style).
        Iterative — see _detach."""
        best: Optional[Node] = None
        stack = [self.root]
        while stack:
            node = stack.pop()
            for child in node.children.values():
                if child.children:
                    stack.append(child)
                elif evictable(child.bid) and (
                        best is None or child.last_used < best.last_used):
                    best = child
        return best
