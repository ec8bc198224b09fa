"""PyTorch serving engine: executes mixed chunked-prefill + decode
batches on an actual model, on the card (or on the CPU when the caller
passes ``device="cpu"``, as the parity tests do).

This slice ports the **paged** executor path of the reference's
``JaxExecutor``: KV lives in a physical block pool addressed through
per-slot int32 block tables (``repro_torch.engine.paged``).  Every
iteration — prefill chunks AND decode steps together — executes as ONE
fused step: decode rows are packed as length-1 chunks next to the prefill
rows, attention reads KV through the block tables with the hand-written
paged kernels, sampling happens on the device, and only token ids cross
the host boundary.  Prefix reuse and migration are block-table pointer
updates, and admission is bounded by blocks actually referenced.

Not in the port yet, each raising where it would be reached: the batched
dense and row-wise fallback paths (``paged=False`` / ``batched=False``,
with the two dense attention kernels), the K-step decode horizon
(``horizon_capable`` is False, so an ``Instance`` plans ``horizon == 1``
only), prefix-block export/import for replication and checkpoints, and
the binding of the host spill tier.

``step_async`` dispatches the step and returns a :class:`PendingStep`
at once (CUDA launches are asynchronous); the single blocking readback
of the token ids happens at ``resolve()``.  ``execute`` is the
synchronous wrapper (``step_async(plan).resolve()``).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.cache.prefix_cache import PrefixCache
from repro_torch.engine import batching
from repro_torch.engine.kvcache import SlotTable
from repro_torch.engine.paged import PagedKVCache
from repro_torch.engine.request import Request
from repro_torch.models import transformer as tf
from repro_torch.models.config import ATTN, ModelConfig

_LATER_DENSE = ("the batched dense and row-wise executor paths are not in "
                "the port yet: they come with the slice that ports the "
                "dense decode and dense chunked-prefill kernels")
_LATER_HORIZON = ("the K-step decode horizon is not in the port yet: it "
                  "comes with the slice that ports the online serving loop")
_LATER_SPILL = ("binding the host spill tier to the pool is not in the "
                "port yet: it comes with the slice that ports prefix-block "
                "export/import")


class MigrationFormatError(ValueError):
    """A migrated engine state's KV format (dense row vs. paged blocks)
    does not match the destination executor's format.  Dense<->paged
    cross-migration is unsupported — migrate between like engines."""



class PendingStep:
    """An in-flight executor iteration: the device work is enqueued, the
    host readback is deferred.

    ``resolve()`` performs the (single) blocking host sync, applies
    tokens/EOS to the step's requests through the executor-supplied
    closure, and returns the eos dict — the same contract as
    ``execute``.  ``ready()`` asks the CUDA event recorded behind the
    step whether the device has finished (always true on the CPU);
    ``prefetch()`` makes the one device->host copy of the token ids.

    ``emitted`` maps rid -> tokens produced this step (populated at
    resolve; consumers fall back to the plan's per-row budgets when a
    rid is absent)."""

    def __init__(self, executor, arrays, apply_fn, horizon: int = 1,
                 event=None):
        self._ex = executor
        self._arrays = tuple(arrays)
        self._apply = apply_fn
        self._event = event
        self.horizon = horizon
        self._np: Optional[list] = None
        self.eos: Optional[Dict[int, bool]] = None
        self.emitted: Dict[int, int] = {}
        self.resolved = False

    def ready(self) -> bool:
        """True once the device has passed the step's event
        (non-blocking)."""
        if self._np is not None or self._event is None:
            return True
        return bool(self._event.query())

    def prefetch(self):
        """Materialize the device results on the host.  Every
        materialization counts as a readback; it additionally counts as
        a blocking sync unless the device was already done."""
        if self._np is None:
            if self._arrays:
                self._ex.host_readbacks += 1
                if not self.ready():
                    self._ex.host_syncs += 1
            self._np = [a.cpu().numpy() for a in self._arrays]
        return self._np

    def resolve(self) -> Dict[int, bool]:
        if not self.resolved:
            arrays = self.prefetch()
            self.eos = self._apply(arrays, self)
            self.resolved = True
            if self._ex is not None and self._ex._pending is self:
                self._ex._pending = None
        return self.eos


class ImmediateStep:
    """Trivial pending step for executors with nothing in flight (the
    simulator's token oracle, empty plans)."""

    horizon = 1

    def __init__(self, eos: Optional[Dict[int, bool]] = None):
        self.eos = dict(eos or {})
        self.emitted: Dict[int, int] = {}
        self.resolved = False

    def ready(self) -> bool:
        return True

    def prefetch(self):
        return []

    def resolve(self) -> Dict[int, bool]:
        self.resolved = True
        return self.eos


def _prefill_window(req: Request, start: int, take: int):
    """Map an instance-space prefill window to (token chunk, cache
    position).  Normally the identity on ``prompt_tokens``; after a
    preemption-by-recompute the request re-prefills from negative
    ``prefill_pos`` and the true stream is prompt + the output tokens
    generated before eviction, at position ``start + recompute_offset``
    (see Request.recompute_offset)."""
    off = req.recompute_offset
    if not off:
        return req.prompt_tokens[start:start + take], start
    pos = start + off
    stream = list(req.prompt_tokens) + list(req.output_tokens[:off])
    return stream[pos:pos + take], pos


def packable(cfg: ModelConfig) -> bool:
    """True if T-padded packed prefill is token-exact for this config:
    every layer is full-cache global attention (padding KV writes are
    dropped and padded positions are masked by causality).  Ring-buffer
    windows would be overwritten by padding slots, recurrent SSM state
    would advance through padding, and capacity-dropping MoE would route
    padding tokens into expert capacity."""
    return all(b == ATTN for seg in cfg.segments() for b in seg.pattern)


class TorchExecutor:
    """Implements the core.instance.Executor protocol with a real model
    on ``device`` — the paged path of the reference's ``JaxExecutor``,
    with its constructor arguments plus ``device``.

    ``device="cuda"`` (the default) needs a card and raises without one;
    ``device="cpu"`` runs the same code with the kernels' plain versions.
    ``params`` must already live on ``device``."""

    #: decode-growth headroom (tokens) reserved beyond the known context
    #: at admission — mirrors Instance._admit_prefill
    HEADROOM = 64

    #: no fused multi-step decode in this slice: an Instance must plan
    #: ``horizon == 1`` iterations only
    horizon_capable = False

    def __init__(self, cfg: ModelConfig, params, n_slots: int, max_seq: int,
                 eos_id: Optional[int] = None, greedy: bool = True,
                 seed: int = 0, batched: bool = True,
                 t_buckets: Optional[Sequence[int]] = None,
                 temperature: float = 1.0, prefix_cache: bool = False,
                 cache_block_size: int = 16,
                 paged: Optional[bool] = None,
                 hbm_blocks: Optional[int] = None,
                 kv_quant: Optional[str] = None,
                 kv_spill_blocks: int = 0, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "TorchExecutor(device='cuda'): no CUDA device is available "
                "(pass device='cpu' to run the plain versions on the CPU)")
        if not batched or paged is False:
            raise NotImplementedError(_LATER_DENSE)
        if not packable(cfg):
            raise NotImplementedError(
                f"{cfg.name}: only all-ATTN configs can page; "
                + _LATER_DENSE)
        if kv_spill_blocks:
            raise NotImplementedError(_LATER_SPILL)
        if kv_quant not in (None, "int8"):
            raise ValueError(f"unsupported kv_quant: {kv_quant!r}")
        self.cfg = cfg
        self.params = params
        self.n_slots = n_slots
        self.max_seq = max_seq
        self.eos_id = eos_id
        self.greedy = greedy
        self.temperature = temperature
        self.paged = True       # what an Instance asks before it adopts
        self.t_buckets = (batching.default_t_buckets(max_seq)
                          if t_buckets is None else tuple(sorted(t_buckets)))
        self.slots = SlotTable(n_slots)
        self.positions = np.zeros(n_slots, np.int32)
        self.last_token = np.zeros(n_slots, np.int32)
        self._rng = np.random.default_rng(seed)
        # non-greedy sampling draws from this generator; it cannot match
        # the reference's draws, so every exactness claim is greedy
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        self.prefix_cache_enabled = prefix_cache
        self.cache_block_size = cache_block_size
        self._claimed: set = set()
        self._preadded: set = set()
        self._deferred_states: dict = {}
        self.prefix_adoptions = 0
        # async-step pipeline state + observability (test hooks):
        # host_readbacks counts every device->host result
        # materialization; host_syncs counts only the BLOCKING ones
        # (device not yet done when the host asked)
        self._pending: Optional[PendingStep] = None
        self.host_readbacks = 0
        self.host_syncs = 0
        # ---- paged physical cache ------------------------------------
        self.kv_quant = kv_quant
        self.prefix_cache_obj: Optional[PrefixCache] = None
        # True once an Instance drives allocate/extend/free on our
        # allocator (unified bookkeeping) — the executor then only READS
        # owned-block lists; False = executor self-manages (standalone
        # construction with a separate instance allocator).
        self._external_bookkeeping = False
        max_blocks = -(-max_seq // cache_block_size)
        # default pool: dense-equivalent capacity + per-slot growth
        # headroom (admission is still per-block by actual context)
        nb = (hbm_blocks if hbm_blocks is not None else
              n_slots * (max_blocks + self.HEADROOM // cache_block_size))
        alloc = None
        if self.prefix_cache_enabled:
            self.prefix_cache_obj = PrefixCache(nb, cache_block_size)
            alloc = self.prefix_cache_obj.allocator
        self.kv = PagedKVCache(cfg, n_slots, max_seq, nb, cache_block_size,
                               allocator=alloc, quant=kv_quant,
                               device=self.device)
        # a migration lands by aliasing cached prefix blocks, so only the
        # non-shared suffix is charged (cluster._start_transfer)
        self.prefix_aware_transfer = True

    # ------------------------------------------------------------------
    # device steps
    # ------------------------------------------------------------------
    def _sample_on_device(self, logits):
        if self.greedy:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        probs = torch.softmax(logits.float() / self.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=self._gen)[:, 0] \
            .to(torch.int32)

    @torch.no_grad()
    def _mixed_fused(self, tokens, start, valid, tables):
        """ONE fused mixed prefill+decode step over the block pool (which
        it updates in place): forward without logits, the last valid
        hidden state of every row, ``lm_head``, sampling.  Returns the
        token ids [B] on the device."""
        T = tokens.shape[1]
        positions = torch.clamp(
            start[:, None] + torch.arange(T, dtype=torch.int32,
                                          device=self.device)[None],
            max=self.max_seq - 1)          # padding must not leave range
        hidden, _, _ = tf.forward(
            self.params, self.cfg, tokens, positions, self.kv.pool,
            compute_logits=False, valid_len=valid,
            block_tables=(tables, self.cache_block_size))
        idx = torch.clamp(valid - 1, min=0).long()[:, None, None] \
            .expand(-1, 1, hidden.shape[-1])
        last = torch.gather(hidden, 1, idx)[:, 0]
        logits = last @ self.params["lm_head"]
        return self._sample_on_device(logits)

    # ------------------------------------------------------------------
    # unified bookkeeping surface
    # ------------------------------------------------------------------
    @property
    def allocator(self):
        """The block allocator whose ids index the physical pool — an
        Instance adopts this so admission and the tensors share one
        source of truth."""
        return self.kv.allocator

    def use_external_bookkeeping(self):
        """An Instance now drives allocate/extend/free on our allocator;
        the executor only reads owned-block lists from here on."""
        self._external_bookkeeping = True

    def adopt_prefix_cache(self, pc: PrefixCache) -> bool:
        """Bind an instance-owned PrefixCache: its allocator's block ids
        become the pool's physical indices and its radix tree becomes
        the donor index.  Returns False (no rebind) when incompatible."""
        if pc.block_size != self.cache_block_size:
            return False
        if pc.spill is not None:
            raise NotImplementedError(_LATER_SPILL)
        self.prefix_cache_obj = pc
        self.prefix_cache_enabled = True
        self.kv.rebind_allocator(pc.allocator)
        self._external_bookkeeping = True
        return True

    def sync(self):
        """Block until all in-flight device work has landed."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def cache_bytes(self) -> int:
        """Device bytes held by the KV block pool."""
        return self.kv.pool_bytes()

    # ------------------------------------------------------------------
    def _acquire_slot(self, rid: int) -> int:
        """Acquire a free slot.  Retention is block-level on the paged
        path (the allocator keeps committed blocks), so no slot is a
        donor worth avoiding."""
        return self.slots.acquire(rid)

    def claim_prefix(self, req: Request, max_tokens: int) -> int:
        """Reuse cached KV for the longest resident prefix of
        ``req.prompt_tokens`` (capped at ``max_tokens``, full blocks).
        Acquires the request's slot; ``add_request`` then skips its own
        acquisition.  Returns the claimed token count."""
        if not self.prefix_cache_enabled or not req.prompt_tokens:
            return 0
        return self._claim_prefix_paged(req, max_tokens)

    def _claim_prefix_paged(self, req: Request, max_tokens: int) -> int:
        """Paged prefix hit = copy-on-write block-table aliasing: the new
        request takes REFERENCES on the matched blocks (no tensor
        gather, no row adoption special case — live and finished donors
        are identical because blocks, not slots, hold the KV)."""
        pc = self.prefix_cache_obj
        bs = self.cache_block_size
        cap = (min(max_tokens, len(req.prompt_tokens) - 1, self.max_seq - 1)
               // bs * bs)
        hit = min(pc.match_tokens(req.prompt_tokens), cap)
        if hit <= 0:
            return 0
        slot = self._acquire_slot(req.rid)
        if not self._external_bookkeeping:
            total = len(req.prompt_tokens) + self.HEADROOM
            if not pc.acquire(req.rid, req.prompt_tokens, hit, total):
                self.slots.release(req.rid)
                return 0
            self.kv.refresh_row(slot, req.rid)
        else:
            # the Instance's PrefixCache.acquire (same allocator) takes
            # the references; the table row is built at add_request
            self.kv.clear_row(slot)
        self.positions[slot] = hit
        self.last_token[slot] = 0
        self._claimed.add(req.rid)
        self.prefix_adoptions += 1
        return hit

    def add_request(self, req: Request):
        if req.rid in self._preadded:
            # state already inserted by a migration (insert_state)
            self._preadded.discard(req.rid)
            return
        if req.rid in self._deferred_states:
            # memory-full at inject time: the admission gate has now
            # cleared this request — land the stashed migrated blocks
            # (plain allocation; the prefix-aliasing fast path is only
            # taken when the pool had room at inject)
            state = self._deferred_states.pop(req.rid)
            slot = self._acquire_slot(req.rid)
            if not self._external_bookkeeping:
                self.kv.ensure(req.rid, state["pos"] + self.HEADROOM)
            self._land_blocks(req, state, slot)
            return
        if req.rid in self._claimed:
            # slot acquired + prefix KV inherited by claim_prefix;
            # re-tabling would wipe it.  Unified bookkeeping: the
            # Instance has taken the block references by now —
            # materialize the table row
            self._claimed.discard(req.rid)
            self.kv.refresh_row(self.slots.slot(req.rid), req.rid)
            return
        slot = self._acquire_slot(req.rid)
        if not self._external_bookkeeping:
            # recompute_offset: a preempted request re-prefills its
            # whole context (prompt + regenerated output), not just
            # the prompt
            self.kv.ensure(req.rid,
                           max(req.prompt_len + req.recompute_offset,
                               1) + self.HEADROOM)
        self.kv.refresh_row(slot, req.rid)
        self.positions[slot] = 0
        if req.prompt_tokens is None:
            req.prompt_tokens = list(
                self._rng.integers(1, self.cfg.vocab_size,
                                   size=req.prompt_len))

    def release(self, req: Request):
        # retention is block-level: freeing decrefs, and registered
        # (committed) blocks are RETAINED in the allocator's LRU —
        # no slot-donor bookkeeping needed
        self._claimed.discard(req.rid)
        self._preadded.discard(req.rid)
        self._deferred_states.pop(req.rid, None)
        slot = self.slots.release(req.rid)
        if slot is not None:
            self.kv.clear_row(slot)
        if not self._external_bookkeeping:
            self.kv.allocator.free(req.rid)    # no-op if never held

    def _register_donor(self, req: Request, slot: int):
        """Prefill complete (or migrated-in state landed): blocks ARE the
        donor currency — publish + retain the prompt's full blocks in
        the shared radix tree (idempotent: the Instance commits through
        the same PrefixCache at prefill completion)."""
        if not self.prefix_cache_enabled or not req.prompt_tokens:
            return
        if (self.prefix_cache_obj is not None
                and self.kv.allocator.holds(req.rid)):
            self.prefix_cache_obj.commit(req.rid, req.prompt_tokens)

    # ------------------------------------------------------------------
    def execute(self, plan) -> Dict[int, bool]:
        """Synchronous wrapper: dispatch + immediately resolve."""
        return self.step_async(plan).resolve()

    def step_async(self, plan) -> PendingStep:
        """Dispatch one planned iteration WITHOUT waiting for device
        results.  Host-deterministic bookkeeping (prefill position
        advances, block-table growth) happens now so the serving loop
        may keep scheduling; token-dependent state (output tokens,
        ``last_token``, EOS, donor registration) lands at
        ``resolve()``.  At most one step may be in flight per
        executor."""
        if self._pending is not None and not self._pending.resolved:
            raise RuntimeError(
                "step_async: previous step not resolved — the pipeline "
                "must be flushed (commit the in-flight iteration) first")
        step = self._step_paged(plan)
        if isinstance(step, PendingStep):
            self._pending = step
        return step

    def abort_step(self, pending=None):
        """Fault path: abandon an in-flight dispatched step without
        resolving it.  The device work is discarded — no tokens are
        applied, no donor registration happens — and the single-step
        pipeline guard is released so the instance can dispatch again
        after recovery."""
        step = pending if pending is not None else self._pending
        if step is not None:
            step.resolved = True
        if self._pending is step:
            self._pending = None

    def on_crash(self):
        """Total device-memory loss: forget everything device-side that
        outlives individual requests — slot rows, donor registrations,
        deferred migration payloads.  Per-request frees happened via
        ``release`` during evacuation; this drops the residue."""
        self.abort_step()
        self._claimed.clear()
        self._preadded.clear()
        self._deferred_states.clear()
        for rid in list(self.slots._slot_of):
            slot = self.slots.release(rid)
            if slot is not None:
                self.kv.clear_row(slot)
            if not self._external_bookkeeping \
                    and self.kv.allocator.holds(rid):
                self.kv.allocator.free(rid)

    # ---- paged hot path: one fused mixed-batch step -------------------
    def _step_paged(self, plan) -> PendingStep:
        """Dispatch a whole TaiChi iteration — every prefill chunk AND
        every decode step — as ONE fused step over the block pool.
        Decode rows ride along as length-1 chunks (token = last sampled
        token, start = row position); per-row valid lengths and block
        tables make the geometry uniform.  A decode-only iteration stays
        at T == 1 and runs the paged decode kernel; any other runs the
        paged chunked-prefill kernel."""
        if getattr(plan, "horizon", 1) > 1:
            raise NotImplementedError(_LATER_HORIZON)
        rows = []   # (req, slot, start, chunk, completes, is_decode)
        if plan.prefill_items:
            for req, start, take, completes in plan.prefill_rows():
                chunk, pos = _prefill_window(req, start, take)
                rows.append((req, self.slots.slot(req.rid), pos,
                             chunk, completes, False))
        for req in plan.decode_reqs:
            slot = self.slots.slot(req.rid)
            # clamp like the device step does: contexts past max_seq keep
            # rewriting the last position (the dense ring would wrap)
            rows.append((req, slot,
                         min(int(self.positions[slot]), self.max_seq - 1),
                         [int(self.last_token[slot])], False, True))
        if not rows:
            return ImmediateStep()
        table_rows = [
            self.kv.grow_for(slot, req.rid,
                             min(start + len(chunk), self.max_seq),
                             self._external_bookkeeping)
            for req, slot, start, chunk, _, _ in rows]
        packed = batching.pack_mixed(
            [chunk for _, _, _, chunk, _, _ in rows],
            [start for _, _, start, _, _, _ in rows],
            table_rows, self.t_buckets, self.kv.max_blocks,
            self.cache_block_size)
        dev = self.device
        toks_dev = self._mixed_fused(
            torch.from_numpy(packed.tokens).to(dev, non_blocking=True),
            torch.from_numpy(packed.start).to(dev, non_blocking=True),
            torch.from_numpy(packed.valid).to(dev, non_blocking=True),
            torch.from_numpy(packed.tables).to(dev, non_blocking=True))
        event = None
        if dev.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(dev))
        # position advances are token-independent: land them at dispatch
        # so the next plan (and the decode rows' next dispatch) sees the
        # post-iteration frontier without waiting on the device
        for req, slot, start, chunk, _, is_dec in rows:
            if is_dec:
                self.positions[slot] += 1
            else:
                self.positions[slot] = start + len(chunk)

        def apply(arrays, handle) -> Dict[int, bool]:
            toks = arrays[0]
            eos: Dict[int, bool] = {}
            for i, (req, slot, start, chunk, completes, is_dec) in \
                    enumerate(rows):
                if is_dec:
                    tok = int(toks[i])
                    req.output_tokens.append(tok)
                    self.last_token[slot] = tok
                    handle.emitted[req.rid] = 1
                    if self.eos_id is not None and tok == self.eos_id:
                        eos[req.rid] = True
                    continue
                if completes:
                    tok = int(toks[i])
                    req.output_tokens.append(tok)
                    self.last_token[slot] = tok
                    self._register_donor(req, slot)
                    if self.eos_id is not None and tok == self.eos_id:
                        eos[req.rid] = True
            return eos

        return PendingStep(self, (toks_dev,), apply, event=event)

    # ------------------------------------------------------------------
    def extract_state(self, req: Request):
        if self._pending is not None and not self._pending.resolved:
            # an eject mid-step would read post-step tensors against
            # pre-step host bookkeeping — the scheduler must commit
            # (flush) the in-flight iteration before migrating
            raise RuntimeError(
                f"extract_state({req.rid}): an async step is in flight; "
                "resolve it (commit the iteration) before ejecting")
        slot = self.slots.slot(req.rid)
        # ship only the blocks actually covering the written context
        # (growth headroom stays home)
        ctx = int(self.positions[slot])
        n = self.kv.blocks_for(max(ctx, 1))
        bids = self.kv.allocator.owned(req.rid)[:n]
        return {"paged_blocks": self.kv.extract_blocks(bids),
                "n_blocks": len(bids), "pos": ctx,
                "last_token": int(self.last_token[slot]),
                "prompt_tokens": list(req.prompt_tokens or ()),
                "kv_format": self.kv_quant or "fp"}

    def insert_state(self, req: Request, state):
        if not isinstance(state, dict) or "paged_blocks" not in state:
            raise MigrationFormatError(
                f"request {req.rid}: migrated state is in 'dense' "
                "row format but the destination executor is 'paged' "
                "— dense<->paged cross-migration is unsupported; "
                "migrate between like engines")
        return self._insert_state_paged(req, state)

    def _insert_state_paged(self, req: Request, state):
        """Land migrated blocks: alias whatever prefix the destination
        already caches (those shipped blocks are discarded), scatter
        only the non-shared suffix, and republish the prompt blocks to
        this instance's donor index.

        When the pool is memory-full the landing is DEFERRED instead of
        raising: the state is stashed and materialized by add_request
        once the instance's admission gate (can_allocate in
        _try_admit_pending) lets the request through — same graceful
        queueing as the dense path's allocation-at-admission contract."""
        fmt = state.get("kv_format", "fp")
        want = self.kv_quant or "fp"
        if fmt != want:
            # int8 blocks carry scale leaves fp pools don't have (and
            # vice versa) — a blind scatter would silently misinterpret
            # the payload; migrate between like-quantized engines
            raise MigrationFormatError(
                f"request {req.rid}: migrated KV is {fmt!r} but the "
                f"destination pool is {want!r} — cross-format "
                "migration is unsupported")
        prompt = req.prompt_tokens or state.get("prompt_tokens") or []
        shared_bids: list = []
        if self.prefix_cache_enabled and self.prefix_cache_obj and prompt:
            pc = self.prefix_cache_obj
            hit = min(pc.match_tokens(prompt),
                      (state["n_blocks"] - 1) * self.cache_block_size)
            if hit > 0:
                shared_bids = pc.matched_bids(prompt, hit)
        alloc = self.kv.allocator
        total = state["pos"] + self.HEADROOM
        if not alloc.can_allocate(total, shared_bids):
            self._deferred_states[req.rid] = state
            return
        slot = self._acquire_slot(req.rid)
        alloc.allocate(req.rid, total, shared=shared_bids)
        self._land_blocks(req, state, slot, len(shared_bids))
        self._preadded.add(req.rid)

    def _land_blocks(self, req: Request, state, slot: int,
                     skip_blocks: int = 0):
        self.kv.refresh_row(slot, req.rid)
        self.kv.insert_blocks(
            self.kv.allocator.owned(req.rid)[:state["n_blocks"]],
            state["paged_blocks"], skip_blocks=skip_blocks)
        self.positions[slot] = state["pos"]
        self.last_token[slot] = state["last_token"]
        # donor re-registration after migration-in (open ROADMAP item):
        # republish the full prompt blocks so the migrated context is
        # adoptable on this instance
        self._register_donor(req, slot)

    def migration_bytes(self, req: Request) -> int:
        slot = self.slots.slot(req.rid)
        n = self.kv.blocks_for(max(int(self.positions[slot]), 1))
        return n * self.cache_block_size * self.kv.token_bytes()


class SimExecutor:
    """Token oracle for the event-driven simulator: no tensors, no
    compute.  EOS arrives when the request's hidden output length is
    reached (the instance observes it only as done())."""

    #: the simulator models the paper system, where migrations ship only
    #: the non-shared suffix when the destination caches the prefix
    prefix_aware_transfer = True

    #: no tensors exist: a warm restore needs only the allocator/slot
    #: bookkeeping (the Instance may resume a request at a checkpointed
    #: position without landing KV — on a real engine that would decode
    #: garbage, so the restore path gates on this attribute)
    bookkeeping_only = True

    def execute(self, plan) -> Dict[int, bool]:
        return {}

    def step_async(self, plan) -> ImmediateStep:
        """Nothing computes, so nothing is ever in flight — but exposing
        the async surface lets the serving loop run its dispatch/commit
        pipeline (and the horizon timing model) deterministically in
        simulation."""
        return ImmediateStep()

    def add_request(self, req: Request):
        pass

    def claim_prefix(self, req: Request, max_tokens: int) -> int:
        """No physical rows to gather — the instance-level block cache
        is the full model of HBM retention in simulation."""
        return max_tokens

    def release(self, req: Request):
        pass

    def extract_state(self, req: Request):
        return None

    def insert_state(self, req: Request, state):
        pass
