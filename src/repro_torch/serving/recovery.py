"""Warm recovery: request-progress checkpoints + post-crash KV
re-replication.

The cluster's fault tolerance resolves every crash victim terminally, but a
crash still costs each victim its whole prefix — evacuation is
preemption-by-recompute from token 0, and hot-prefix replicas that
lived on the dead instance stay gone until the controller's next
epoch.  The ``RecoveryManager`` converts "survive crashes" into
"barely pay for crashes":

* **Progress checkpoints.**  At every committed iteration the manager
  snapshots each resident request's stream position (prompt + emitted
  tokens processed so far), advancing a per-request record whenever it
  grew by ``checkpoint_tokens`` since the last snapshot.  The records
  are rid-keyed and token-free, so they work for the simulator's
  tokenless workloads too.

* **KV materialization** (optional, ``materialize_kv``).  When the
  executor can export paged blocks (``export_request_blocks``), the
  checkpointed blocks are copied into a cluster-level
  ``HostSpillPool`` keyed by the same chained block hashes the prefix
  tree uses — the pool lives on the router host, so a victim's blocks
  survive its instance.  Only blocks absent from the pool are copied
  (incremental), and refresh order is tail-to-head so LRU drops eat
  run tails instead of punching holes at the front.

* **Warm restore.**  On ``fail_instance`` the cluster consults
  ``plan_restore`` before falling back to recompute-from-0: the victim
  resumes from its snapshot (re-prefilling only the tokens since it),
  adopting materialized blocks directly when a live engine can land
  them — greedy token-exact either way, because the resume path is the
  ordinary recompute stream at a non-zero start position.

* **Post-crash re-replication** (``rereplicate``).  The manager records
  where hot-prefix replicas land (``on_replica_landed``); when an
  instance dies, every replicated path it held is immediately
  re-established from a surviving holder onto the coldest healthy peer
  instead of waiting for the controller's next epoch.

Everything is default-off (``RecoveryConfig.enable=False``): a cluster
without a manager attached takes none of these paths and stays
bit-identical to the pre-recovery build.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Optional, Set, Tuple

import torch

from repro_torch.cache.prefix_tree import chain_hashes
from repro_torch.cache.spill import HostSpillPool


def _tree_map(fn, tree, *rest):
    """Apply ``fn`` leaf-wise over parallel trees of dicts / tuples /
    lists of tensors (the block payloads of ``extract_blocks``)."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


@dataclasses.dataclass
class RecoveryConfig:
    """Warm-recovery knobs (pass ``recovery=`` to ``Cluster`` /
    ``build_cluster``).  ``enable=False`` keeps every hook inert."""
    enable: bool = False
    #: snapshot a request's progress every N newly processed tokens —
    #: smaller = less re-prefill after a crash, more checkpoint work
    checkpoint_tokens: int = 32
    #: copy checkpointed KV blocks into the host-side recovery pool
    #: (needs an executor with ``export_request_blocks``; the sim's
    #: bookkeeping executor restores from the progress record alone)
    materialize_kv: bool = True
    #: recovery-pool capacity in blocks (cluster-level host RAM)
    store_blocks: int = 4096
    #: re-establish hot-prefix replicas lost with a crashed instance
    #: immediately, instead of waiting for the controller's next epoch
    rereplicate: bool = True


class RecoveryManager:
    """Cluster-level warm-recovery state: per-request progress records,
    an optional materialized-KV pool, and the replica-placement
    registry.  Survives any single instance (it models state on the
    router host, outside every instance's HBM and spill tier)."""

    def __init__(self, cfg: Optional[RecoveryConfig] = None):
        self.cfg = cfg or RecoveryConfig(enable=True)
        #: rid -> furthest checkpointed stream position (monotone)
        self._progress: Dict[int, int] = {}
        #: materialized KV blocks, keyed by chained block hash; created
        #: lazily at first capture so the block size matches the source
        #: executor's
        self.pool: Optional[HostSpillPool] = None
        #: replicated-prefix registry: tokens -> holder instance ids
        self._replicas: Dict[Tuple[int, ...], Set[int]] = {}
        # counters (exposed via Cluster.recovery_counters)
        self.checkpoints = 0
        self.ckpt_blocks = 0
        self.warm_plans = 0
        self.rereplications = 0

    # ------------------------------------------------------------------
    # checkpoint capture (called from Cluster._post_iteration: the
    # executor pipeline is flushed there on both sync and async paths)
    # ------------------------------------------------------------------
    def on_commit(self, cluster, inst, now: float):
        tracer = cluster.tracer
        for req in itertools.chain(inst.decoding.values(),
                                   inst.pending_decode,
                                   inst.prefill_queue):
            out = req.output_len
            # KV written so far covers [0, context_len - 1) once decode
            # has started (the engine's slot position trails the emitted
            # token by one); cap at stream length - 1 so a warm restore
            # always has >= 1 token left to re-prefill (the completion
            # of which emits the next NEW token, exactly like cold)
            ctx = min(req.context_len - (1 if out else 0),
                      req.prompt_len + out - 1)
            last = self._progress.get(req.rid, 0)
            if ctx - last < self.cfg.checkpoint_tokens:
                continue
            self._progress[req.rid] = ctx
            self.checkpoints += 1
            blocks = (self._materialize(inst, req, ctx, out)
                      if self.cfg.materialize_kv else 0)
            if tracer is not None:
                tracer.event(req.rid, now, "checkpoint", ctx=ctx,
                             blocks=blocks)

    def _materialize(self, inst, req, ctx: int, out: int) -> int:
        hook = getattr(inst.executor, "export_request_blocks", None)
        if hook is None or not req.prompt_tokens:
            return 0
        bs = getattr(inst.executor, "cache_block_size", 16)
        if self.pool is None:
            self.pool = HostSpillPool(self.cfg.store_blocks, bs)
        elif self.pool.block_size != bs:
            return 0                      # mixed-block-size cluster
        stream = tuple(req.prompt_tokens) \
            + tuple(req.output_tokens[:out])
        n = min(ctx, len(stream)) // bs
        if n <= 0:
            return 0
        chains = []
        for i, (h, blk) in enumerate(chain_hashes(stream, bs)):
            if i >= n:
                break
            chains.append((h, blk))
        missing = [i for i, (h, _) in enumerate(chains)
                   if h not in self.pool]
        payloads = hook(req, missing) if missing else {}
        if payloads is None:
            return 0
        landed = 0
        # tail-to-head so the head of the run is always the most
        # recently used: capacity drops then eat tails, never punch
        # holes that truncate the whole contiguous restore run
        for i in range(len(chains) - 1, -1, -1):
            h, blk = chains[i]
            if i in payloads:
                self.pool.put(h, blk, payloads[i])
                landed += 1
            else:
                self.pool.touch(h)
        self.ckpt_blocks += landed
        return landed

    def drop(self, rid: int):
        """A request resolved terminally: its progress record is dead
        weight.  Materialized blocks are NOT dropped — they are keyed
        by content chain (shared across identical prefixes) and age out
        of the pool by LRU instead."""
        self._progress.pop(rid, None)

    # ------------------------------------------------------------------
    # warm restore
    # ------------------------------------------------------------------
    def plan_restore(self, req) -> Optional[dict]:
        """Restore plan for a crash victim, or None for cold recompute.
        ``pos`` is the checkpointed stream position (progress-record
        restore, bookkeeping executors); ``engine`` is an assembled
        migration-format state when a contiguous materialized run
        exists (live paged executors adopt it via ``insert_state``)."""
        if not self.cfg.enable:
            return None
        out = req.output_len
        ctx = min(self._progress.get(req.rid, 0),
                  req.prompt_len + out - 1)
        if ctx < 1:
            return None
        engine = (self._assemble(req, ctx, out)
                  if self.cfg.materialize_kv and self.pool is not None
                  else None)
        self.warm_plans += 1
        return {"pos": ctx, "engine": engine}

    def _assemble(self, req, ctx: int, out: int) -> Optional[dict]:
        if not req.prompt_tokens:
            return None
        bs = self.pool.block_size
        stream = tuple(req.prompt_tokens) \
            + tuple(req.output_tokens[:out])
        n_max = ctx // bs
        if n_max < 1:
            return None
        run = self.pool.match_from(stream, 0, max_blocks=n_max)
        fmt = None
        kvs = []
        for _, payload in run:
            if payload is None:
                break                     # bookkeeping entry: no tensors
            if fmt is None:
                fmt = payload["fmt"]
            if payload["fmt"] != fmt:
                break
            kvs.append(payload["kv"])
        if not kvs:
            return None
        n = len(kvs)
        pos = n * bs
        # live payloads only: the sim never reaches this path
        blocks = kvs[0] if n == 1 else _tree_map(
            lambda *xs: torch.cat(xs, dim=1), *kvs)
        return {"paged_blocks": blocks, "n_blocks": n, "pos": pos,
                "last_token": int(stream[pos - 1]),
                "prompt_tokens": list(req.prompt_tokens),
                "kv_format": fmt, "block_size": bs}

    # ------------------------------------------------------------------
    # post-crash KV re-replication
    # ------------------------------------------------------------------
    def on_replica_landed(self, tokens, src_iid: Optional[int],
                          dst_iid: int):
        """A "replicate" TRANSFER landed: record both ends as holders
        of the path (the registry is what makes a crashed holder's
        replicas recoverable without an epoch-boundary rescan)."""
        key = tuple(tokens)
        if not key:
            return
        holders = self._replicas.setdefault(key, set())
        if src_iid is not None:
            holders.add(src_iid)
        holders.add(dst_iid)

    def holders(self, tokens) -> Set[int]:
        return self._replicas.get(tuple(tokens), set())

    def on_instance_failed(self, cluster, inst, now: float) -> int:
        """Re-establish every replicated path the dead instance held:
        ship it from a surviving holder to the coldest healthy peer
        (fewest used blocks) that misses it.  Best effort — replicas
        are a performance tier, never correctness."""
        if not self.cfg.rereplicate:
            return 0
        shipped = 0
        for key, holders in list(self._replicas.items()):
            if inst.iid not in holders:
                continue
            holders.discard(inst.iid)
            src = self._find_source(cluster, key, holders)
            if src is None:
                if not holders:
                    self._replicas.pop(key, None)
                continue
            cands = [i for i in cluster.instances
                     if i is not src and i.schedulable
                     and i.prefix_cache is not None
                     and not self._holds_path(i, key)]
            if not cands:
                continue
            dst = min(cands, key=lambda i: i.allocator.used_blocks)
            if cluster.replicate_prefix(src, dst, list(key), now):
                shipped += 1
                self.rereplications += 1
                if cluster.tracer is not None:
                    cluster.tracer.global_event(
                        now, "rereplicate", src=src.iid, dst=dst.iid,
                        tokens=len(key))
        return shipped

    @staticmethod
    def _holds_path(inst, key: Tuple[int, ...]) -> bool:
        pc = inst.prefix_cache
        n = len(key) // pc.block_size
        if n <= 0:
            return True
        return len(pc.tree.match(key, n, touch=False)) >= n

    def _find_source(self, cluster, key, holders):
        # surviving registered holders first (cheap), then any healthy
        # instance that still caches the path
        ranked = sorted(cluster.instances,
                        key=lambda i: i.iid not in holders)
        for i in ranked:
            if i.schedulable and i.prefix_cache is not None \
                    and self._holds_path(i, key):
                return i
        return None

    # ------------------------------------------------------------------
    def counters(self) -> dict:
        c = {
            "checkpoints": self.checkpoints,
            "checkpointed_requests": len(self._progress),
            "ckpt_blocks": self.ckpt_blocks,
            "warm_plans": self.warm_plans,
            "rereplications": self.rereplications,
        }
        if self.pool is not None:
            c["pool"] = self.pool.stats()
        return c
