"""PyTorch serving engine: executes mixed chunked-prefill + decode
batches on an actual model, on the card (or on the CPU when the caller
passes ``device="cpu"``, as the parity tests do).

Three executor paths, as in the reference's ``JaxExecutor``:

* **paged** (default for all-ATTN configs): KV lives in a physical block
  pool addressed through per-slot int32 block tables
  (``repro_torch.engine.paged``).  Every iteration — prefill chunks AND
  decode steps together — executes as ONE fused step: decode rows are
  packed as length-1 chunks next to the prefill rows, attention reads KV
  through the block tables with the hand-written paged kernels, sampling
  happens on the device, and only token ids cross the host boundary.
  Prefix reuse and migration are block-table pointer updates, and
  admission is bounded by blocks actually referenced.
* **batched dense** (the families that cannot page — recurrent state,
  sliding-window rings, capacity-dropping MoE, the encoder-decoder — and
  ``paged=False``): a slot-contiguous dense cache
  (``models.transformer.init_cache``); packed T-padded prefill where
  padding is safe, else exact-shape slot rows; one full-slot-batch decode.
  The dense decode, dense chunked-prefill and SSD-scan kernels carry it.
* **row-wise reference** (``batched=False``): per-request exact-shape
  prefill on a copied-out cache row and host-side sampling — the
  token-exact oracle the other paths are tested against.

The engine's requests carry text only, as the reference's do.  The VLM
family (llava) is an all-ATTN stack and pages like any other; its image
projector is unused.  The encoder-decoder (whisper) takes the dense path:
its cache holds a cross-attention KV of 0 keys (``cross_len`` 0), its
encoder is skipped, and every decoder layer's cross-attention over no
keys gives 0, as the reference's does.

The full-slot-batch decode of the dense paths decodes only the rows the
plan schedules: the others pass a zero ``valid_len``, so they write no KV
and keep their recurrent (conv / SSM) state exactly as it was.  The
reference lets that decode advance the recurrent state of every slot, and
so corrupts a recurrent row whose chunked prefill is part-way done when a
decode runs beside it; the port follows the model's semantics (the
cache-free forward) instead.  The unscheduled rows are still computed, as
the reference computes them (their ``last_token`` at their ``positions``,
reading their own key as if written): an MoE layer routes them, and they
take their place in the experts' capacity as in the reference.

A dense executor bounds admission by its rows: its ``allocator`` (a
:class:`DenseRowAllocator`) grants at most one request a row, and a
migrated row lands when that admission happens.

Two serving-loop-facing mechanisms sit on top of the three paths, as in
the reference:

* **multi-step decode horizon** — a decode-only iteration whose plan
  carries ``horizon == K > 1`` runs K decode steps in one dispatch (paged
  and packed-dense paths, ``horizon_capable``): sampling stays on the
  device between steps, per-row done-masks freeze rows that emit EOS or
  exhaust their per-row budget (their KV writes drop via ``valid_len``),
  and block tables are pre-grown to the end-of-horizon frontier.  One
  readback then retires up to ``K x B`` tokens.
* **non-blocking ``step_async``** — every path enqueues its device work
  and returns a :class:`PendingStep` at once (CUDA launches are
  asynchronous); the single blocking readback happens at ``resolve()``.
  ``execute`` is the synchronous wrapper (``step_async(plan).resolve()``).

On the card every decode-only step — the paged horizon for any K (a K = 1
decode-only iteration of the paged path is a one-step horizon), the
packed-dense horizon and the full-slot-batch dense decode — is replayed
from a CUDA graph captured at its bucket's first use
(``repro_torch.engine.graphs``), the counterpart of the reference's
``jax.jit``.  Mixed and prefill steps run eagerly.  On the CPU the same
step functions run directly.

The KV tiers' tensor legs sit on the paged pool, as in the reference: the
prefix cache's host spill tier copies an evicted block to host memory and
scatters it back in place on promotion (``_bind_spill``), and whole
blocks leave and land for hot-prefix replication
(``export_prefix_blocks`` / ``import_prefix_blocks``) and warm-recovery
checkpoints (``export_request_blocks``).  Every payload is host-resident
(CPU tensors) and tagged with its KV format; every copy is ordered on the
current stream behind the steps already enqueued, and a landing writes
the pool in place, so the captured graphs keep reading the pool they
were captured on.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.cache.prefix_cache import PrefixCache
from repro_torch.cache.prefix_tree import PrefixTree
from repro_torch.engine import batching, migrate
from repro_torch.engine.graphs import StepGraphs
from repro_torch.engine.kvcache import BlockAllocator, OutOfBlocks, SlotTable
from repro_torch.engine.paged import PagedKVCache
from repro_torch.engine.request import Request
from repro_torch.models import transformer as tf
from repro_torch.models.config import ATTN, ModelConfig
from repro_torch.serving.tracing import HOST_SPANS

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
    rid is absent).  ``iid`` and ``it`` name the instance and iteration
    of the step's host spans (``exec.fetch``) where they were recorded."""

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
        self.iid: Optional[int] = None
        self.it: Optional[int] = None

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
            with HOST_SPANS.span("exec.fetch", self.iid, self.it):
                self._fetch()
        return self._np

    def _fetch(self):
        if self._np is None:
            if self._arrays:
                self._ex.host_readbacks += 1
                if not self.ready():
                    self._ex.host_syncs += 1
            self._np = [a.cpu().numpy() for a in self._arrays]
        return self._np

    def resolve(self) -> Dict[int, bool]:
        if not self.resolved:
            with HOST_SPANS.span("exec.fetch", self.iid, self.it):
                self.eos = self._apply(self._fetch(), self)
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


def _budgets(plan):
    """Per-row token budgets of a decode plan (one each when the plan
    carries none)."""
    return (getattr(plan, "decode_budgets", None)
            or [1] * len(plan.decode_reqs))


def packable(cfg: ModelConfig) -> bool:
    """True if T-padded packed prefill is token-exact for this config:
    every layer is full-cache global attention (padding KV writes are
    dropped and padded positions are masked by causality).  Ring-buffer
    windows would be overwritten by padding slots, recurrent SSM state
    would advance through padding, and capacity-dropping MoE would route
    padding tokens into expert capacity."""
    return all(b == ATTN for seg in cfg.segments() for b in seg.pattern)


class DenseRowAllocator(BlockAllocator):
    """Admission for a dense cache of ``n_rows`` rows of ``max_seq``
    tokens: blocks as any allocator counts them (Algorithm 1's memory
    gauge), and at most one request a row.  An ``Instance`` adopts it as
    it adopts a paged executor's allocator, so the requests it admits
    never outnumber the rows the tensors hold."""

    def __init__(self, n_rows: int, max_seq: int, block_size: int):
        super().__init__(n_rows * -(-max_seq // block_size), block_size)
        self.n_rows = n_rows

    def can_allocate(self, tokens: int) -> bool:
        return len(self._owned) < self.n_rows and super().can_allocate(tokens)

    def allocate(self, rid: int, tokens: int):
        if rid not in self._owned and len(self._owned) >= self.n_rows:
            raise OutOfBlocks(f"all {self.n_rows} rows are held")
        super().allocate(rid, tokens)


class TorchExecutor:
    """Implements the core.instance.Executor protocol with a real model
    on ``device`` — the reference's ``JaxExecutor``, with its constructor
    arguments plus ``device``.

    ``device="cuda"`` (the default) needs a card and raises without one;
    ``device="cpu"`` runs the same code with the kernels' plain versions.
    ``params`` must already live on ``device``."""

    #: decode-growth headroom (tokens) reserved beyond the known context
    #: at admission — mirrors Instance._admit_prefill
    HEADROOM = 64

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
        if kv_quant not in (None, "int8"):
            raise ValueError(f"unsupported kv_quant: {kv_quant!r}")
        self.cfg = cfg
        self.params = params
        self.n_slots = n_slots
        self.max_seq = max_seq
        self.eos_id = eos_id
        self.greedy = greedy
        self.temperature = temperature
        self.batched = batched
        self.packed = batched and packable(cfg)
        # paged wherever paging is exact, unless the caller says no
        self.paged = self.packed if paged is None else (bool(paged)
                                                        and self.packed)
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
        # prefix-KV reuse: KV at position p depends only on tokens [0, p]
        # iff every layer is full-cache global attention — same gate as
        # T-padding (and as paging)
        self.prefix_cache_enabled = prefix_cache and packable(cfg)
        self.cache_block_size = cache_block_size
        self._donors = PrefixTree(cache_block_size)   # dense donor rows
        self._claimed: set = set()
        self._preadded: set = set()
        self._deferred_states: dict = {}
        self.prefix_adoptions = 0
        # async-step pipeline state + observability (test hooks):
        # host_readbacks counts every device->host result
        # materialization; host_syncs counts only the BLOCKING ones
        # (device not yet done when the host asked)
        self._pending: Optional[PendingStep] = None
        # the last step's ``exec.enqueue.*`` span that holds CUDA events
        self._timed = None
        self.host_readbacks = 0
        self.host_syncs = 0
        self.horizon_calls = 0
        self.horizon_tokens = 0
        # decode-only steps replay as CUDA graphs on the card; the
        # sampling generator is registered with every graph
        self.graphs = (StepGraphs(self.device,
                                  () if greedy else (self._gen,))
                       if self.device.type == "cuda" else None)
        self.kv_quant = kv_quant if self.paged else None
        self.kv: Optional[PagedKVCache] = None
        self.cache = None
        self.prefix_cache_obj: Optional[PrefixCache] = None
        # True once an Instance drives allocate/extend/free on our
        # allocator (unified bookkeeping) — the executor then only READS
        # owned-block lists; False = executor self-manages (standalone
        # construction with a separate instance allocator).
        self._external_bookkeeping = False
        if self.paged:
            max_blocks = -(-max_seq // cache_block_size)
            # default pool: dense-equivalent capacity + per-slot growth
            # headroom (admission is still per-block by actual context)
            nb = (hbm_blocks if hbm_blocks is not None else
                  n_slots * (max_blocks + self.HEADROOM // cache_block_size))
            alloc = None
            if self.prefix_cache_enabled:
                self.prefix_cache_obj = PrefixCache(
                    nb, cache_block_size, spill_blocks=kv_spill_blocks)
                alloc = self.prefix_cache_obj.allocator
            self.kv = PagedKVCache(cfg, n_slots, max_seq, nb,
                                   cache_block_size, allocator=alloc,
                                   quant=kv_quant, device=self.device)
            if self.prefix_cache_obj is not None:
                self._bind_spill(self.prefix_cache_obj)
            self._rows = None
        else:
            self.cache = tf.init_cache(cfg, n_slots, max_seq,
                                       device=self.device)
            self._rows = DenseRowAllocator(n_slots, max_seq,
                                           cache_block_size)
        # only the paged path lands a migration by aliasing cached prefix
        # blocks; the dense path ships and scatters the full row, so its
        # transfers must be charged in full (cluster._start_transfer)
        self.prefix_aware_transfer = self.paged

    # ------------------------------------------------------------------
    # device steps
    # ------------------------------------------------------------------
    def _to_dev(self, a):
        """A host array as a tensor on the device (copied first: the host
        arrays are updated right after the launch)."""
        return torch.from_numpy(np.array(a)).to(self.device,
                                                non_blocking=True)

    def _event(self):
        if self.device.type != "cuda":
            return None
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        return event

    def _sample_on_device(self, logits):
        if self.greedy:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        probs = torch.softmax(logits.float() / self.temperature, dim=-1)
        # one draw of index i with probability p_i: argmax of p / E with
        # E ~ Exp(1) (torch.multinomial's method for one sample, without
        # its host-side check of the probabilities, which a graph cannot
        # hold)
        race = torch.empty_like(probs).exponential_(generator=self._gen)
        return torch.argmax(probs / race, dim=-1).to(torch.int32)

    def _dispatch(self, key, fn, *host_arrays):
        """Run the decode-only step ``fn`` (device tensors in, a tuple of
        device tensors out) on the host arrays: on the card as a replay
        of the graph captured for ``key``, on the CPU directly."""
        if self.graphs is None:
            return fn(*(self._to_dev(a) for a in host_arrays))
        return self.graphs.run(key, fn, host_arrays)

    def _last_logits(self, hidden, valid):
        """``lm_head`` on the last valid hidden state of every row."""
        idx = torch.clamp(valid - 1, min=0).long()[:, None, None] \
            .expand(-1, 1, hidden.shape[-1])
        return torch.gather(hidden, 1, idx)[:, 0] @ self.params["lm_head"]

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
        return self._sample_on_device(self._last_logits(hidden, valid))

    @torch.no_grad()
    def _decode_fused(self, tokens, pos, active):
        """Full-slot-batch decode over the dense cache; only rows with
        ``active == 1`` write KV and advance their recurrent state.
        Returns the token ids [n_slots] on the device."""
        logits = self._decode(tokens, pos, active)
        return self._sample_on_device(logits)

    def _horizon_steps(self, forward, tok0, pos0, budget, K: int):
        """K decode steps with on-device sampling: ``forward(last, pos,
        step)`` gives one step's logits [B, V] for the tokens ``last`` at
        positions ``pos``, writing KV (and advancing recurrent state) only
        for rows with ``step == 1``.  A row is active while it has not
        emitted EOS and has budget left; a frozen row's token and
        position hold still, so the final carries are exact per-row
        states.  Returns one int32 tensor [K + 4, B]: the K steps' tokens,
        then tokens emitted, last token, position and done (one
        readback)."""
        last, pos = tok0, pos0
        emitted = torch.zeros_like(pos0)
        done = torch.zeros_like(pos0, dtype=torch.bool)
        toks = []
        for _ in range(K):
            active = (~done) & (emitted < budget)
            step = active.to(torch.int32)
            tok = self._sample_on_device(forward(last, pos, step))
            tok = torch.where(active, tok, last)
            if self.eos_id is not None:
                done = done | (active & (tok == self.eos_id))
            last, pos, emitted = tok, pos + step, emitted + step
            toks.append(tok)
        return torch.cat([torch.stack(toks), emitted[None], last[None],
                          pos[None], done[None].to(torch.int32)])

    @torch.no_grad()
    def _horizon_paged(self, tok0, pos0, budget, tables, K: int):
        """K fused decode steps over the block pool (updated in place);
        positions clamp to ``max_seq - 1`` as in the mixed step."""
        def forward(last, pos, step):
            p = torch.clamp(pos, max=self.max_seq - 1)
            hidden, _, _ = tf.forward(
                self.params, self.cfg, last[:, None], p[:, None],
                self.kv.pool, compute_logits=False, valid_len=step,
                block_tables=(tables, self.cache_block_size))
            return hidden[:, 0] @ self.params["lm_head"]
        return self._horizon_steps(forward, tok0, pos0, budget, K)

    @torch.no_grad()
    def _horizon_dense(self, tok0, pos0, budget, K: int):
        """K fused decode steps over the full slot batch of the dense cache:
        slots with budget 0 (unscheduled) never write.  Positions are not
        clamped, as in the reference."""
        def forward(last, pos, step):
            return self._decode(last[:, None], pos, step)
        return self._horizon_steps(forward, tok0, pos0, budget, K)

    @torch.no_grad()
    def _prefill_packed(self, tokens, start, valid, slots, n_real: int):
        """T-padded prefill of several dense rows (all-ATTN configs): the
        rows' cache is gathered, prefilled and scattered back (the real
        rows only).  Returns the token ids [B] on the device."""
        T = tokens.shape[1]
        positions = torch.clamp(
            start[:, None] + torch.arange(T, dtype=torch.int32,
                                          device=self.device)[None],
            max=self.max_seq - 1)          # padding must not wrap slots
        rows = {name: leaf.index_select(1, slots)
                for name, leaf in self.cache.items()}
        hidden, _, _ = tf.forward(self.params, self.cfg, tokens, positions,
                                  rows, compute_logits=False,
                                  valid_len=valid)
        for name, leaf in self.cache.items():
            leaf.index_copy_(1, slots[:n_real], rows[name][:, :n_real])
        return self._sample_on_device(self._last_logits(hidden, valid))

    @torch.no_grad()
    def _prefill_slot(self, tokens, start, slot: int):
        """Exact-shape prefill of one slot (families where padding is
        unsafe), on the slot's views of the cache.  Returns the token id
        [1] on the device."""
        positions = start[:, None] + torch.arange(
            tokens.shape[1], dtype=torch.int32, device=self.device)[None]
        row = {name: leaf[:, slot:slot + 1]
               for name, leaf in self.cache.items()}
        hidden, _, _ = tf.forward(self.params, self.cfg, tokens, positions,
                                  row, compute_logits=False)
        return self._sample_on_device(hidden[:, -1] @ self.params["lm_head"])

    # ---- reference path (host-side sampling, logits cross) ----
    @torch.no_grad()
    def _decode(self, tokens, pos, active):
        logits, _, _ = tf.forward(self.params, self.cfg, tokens,
                                  pos[:, None], self.cache,
                                  valid_len=active)
        return logits[:, -1]

    @torch.no_grad()
    def _prefill_row(self, row_cache, tokens, start):
        positions = start[:, None] + torch.arange(
            tokens.shape[1], dtype=torch.int32, device=self.device)[None]
        logits, _, _ = tf.forward(self.params, self.cfg, tokens, positions,
                                  row_cache)
        return logits[:, -1]

    def _sample_batch(self, logits):
        return self._sample_on_device(logits)

    # ------------------------------------------------------------------
    # unified bookkeeping surface
    # ------------------------------------------------------------------
    @property
    def horizon_capable(self) -> bool:
        """True when this executor can fuse K>1 decode steps: the paged
        pool and the packed dense path freeze rows via ``valid_len``,
        which needs full-cache attention everywhere (the same gate as
        T-padded packing); other families stay at K=1."""
        return self.paged or self.packed

    @property
    def allocator(self):
        """The allocator an Instance adopts so admission and the tensors
        share one source of truth: the block allocator whose ids index
        the physical pool, or the dense cache's row allocator."""
        return self.kv.allocator if self.paged else self._rows

    def use_external_bookkeeping(self):
        """An Instance now drives allocate/extend/free on our allocator;
        the executor only reads owned-block lists from here on."""
        self._external_bookkeeping = True

    def adopt_prefix_cache(self, pc: PrefixCache) -> bool:
        """Bind an instance-owned PrefixCache: its allocator's block ids
        become the pool's physical indices and its radix tree becomes
        the donor index.  Returns False (no rebind) when incompatible."""
        if not self.paged or pc.block_size != self.cache_block_size:
            return False
        self.prefix_cache_obj = pc
        self.prefix_cache_enabled = True
        pool = self.kv.pool
        self.kv.rebind_allocator(pc.allocator)
        if self.graphs is not None and self.kv.pool is not pool:
            # the pool was rebuilt: graphs holding the old one are stale
            self.graphs.clear()
        self._bind_spill(pc)
        self._external_bookkeeping = True
        return True

    def _bind_spill(self, pc: PrefixCache):
        """Give the prefix cache's host spill tier real tensor legs:
        eviction copies a block's pool slice to host memory, promotion
        scatters it back into whatever block id the allocator hands out.
        Without this binding the tier still runs (bookkeeping-only
        payloads), which is what the simulator uses."""
        if pc.spill is None:
            return
        pc.bind_tiers(fetch_block=self.fetch_block,
                      load_block=self.load_block)

    def _host_blocks(self, bids: Sequence[int]):
        """Host copies of whole pool blocks, every leaf (an int8 pool's
        scales too), in logical order.  The gather is enqueued on the
        current stream behind every step already dispatched (a graph's
        replay, or the side stream a first use ran on, which the current
        stream waits for) and the copy blocks on that stream only."""
        return {name: leaf.cpu()
                for name, leaf in self.kv.extract_blocks(bids).items()}

    def fetch_block(self, bid: int):
        """The spill tier's eviction leg: a host copy of block ``bid``."""
        return self._host_blocks([bid])

    def load_block(self, bid: int, payload):
        """The spill tier's promotion leg: scatter a host copy back into
        block ``bid`` in place (a captured graph reads the same pool)."""
        self.kv.insert_blocks([bid], payload)

    def sync(self):
        """Block until all in-flight device work has landed."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def cache_bytes(self) -> int:
        """Device bytes held by the KV cache (pool or dense rows)."""
        if self.paged:
            return self.kv.pool_bytes()
        return sum(t.numel() * t.element_size() for t in self.cache.values())

    # ------------------------------------------------------------------
    def _acquire_slot(self, rid: int) -> int:
        """Acquire a free slot, preferring rows that are NOT retained
        dense prefix donors; whatever row is reused stops being a donor
        (the paged path retains blocks, not rows)."""
        avoid = set(self._donors.bids()) if self.prefix_cache_enabled else ()
        slot = self.slots.acquire(rid, avoid=avoid)
        self._donors.remove_bid(slot)
        return slot

    def claim_prefix(self, req: Request, max_tokens: int) -> int:
        """Reuse cached KV for the longest resident prefix of
        ``req.prompt_tokens`` (capped at ``max_tokens``, full blocks).

        Dense: adopts the donor row outright when it is free (a finished
        request's retained slot — zero copies), otherwise copies the
        matched columns from the live donor's row into a fresh slot.
        Acquires the request's slot either way; ``add_request`` then
        skips its own acquisition.  Returns the claimed token count."""
        if not self.prefix_cache_enabled or not req.prompt_tokens:
            return 0
        if self.paged:
            return self._claim_prefix_paged(req, max_tokens)
        bs = self.cache_block_size
        cap = min(max_tokens, len(req.prompt_tokens) - 1,
                  self.max_seq - 1) // bs
        path = self._donors.match(req.prompt_tokens, cap) if cap > 0 else []
        if not path:
            return 0
        donor = path[-1].bid                  # deepest node's row holds
        h = len(path) * bs                    # the whole matched prefix
        if self.slots.is_free(donor):
            self.slots.acquire_slot(req.rid, donor)
            self._donors.remove_bid(donor)
            slot = donor
            self.prefix_adoptions += 1
        else:
            slot = self._acquire_slot(req.rid)
            migrate.copy_prefix(self.cache, donor, slot, h)
        # stale columns >= h are dead: masked by position until prefill/
        # decode overwrites them in order (same argument as zero_row)
        self.positions[slot] = h
        self.last_token[slot] = 0
        self._claimed.add(req.rid)
        return h

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
            # the admission gate has now cleared a migrated-in request:
            # land its stashed state (paged: memory was full at inject;
            # dense: a row is taken only with an admission)
            state = self._deferred_states.pop(req.rid)
            slot = self._acquire_slot(req.rid)
            if not self.paged:
                self._land_row(req, state, slot)
                return
            if not self._external_bookkeeping:
                self.kv.ensure(req.rid, state["pos"] + self.HEADROOM)
            self._land_blocks(req, state, slot)
            return
        if req.rid in self._claimed:
            # slot acquired + prefix KV inherited by claim_prefix;
            # zeroing / re-tabling would wipe it
            self._claimed.discard(req.rid)
            if self.paged:
                # unified bookkeeping: the Instance has taken the block
                # references by now — materialize the table row
                self.kv.refresh_row(self.slots.slot(req.rid), req.rid)
            return
        slot = self._acquire_slot(req.rid)
        if self.paged:
            if not self._external_bookkeeping:
                # recompute_offset: a preempted request re-prefills its
                # whole context (prompt + regenerated output), not just
                # the prompt
                self.kv.ensure(req.rid,
                               max(req.prompt_len + req.recompute_offset,
                                   1) + self.HEADROOM)
            self.kv.refresh_row(slot, req.rid)
        else:
            migrate.zero_row(self.cache, slot)
        self.positions[slot] = 0
        if req.prompt_tokens is None:
            req.prompt_tokens = list(
                self._rng.integers(1, self.cfg.vocab_size,
                                   size=req.prompt_len))

    def release(self, req: Request):
        self._preadded.discard(req.rid)
        self._deferred_states.pop(req.rid, None)
        if self.paged:
            # retention is block-level: freeing decrefs, and registered
            # (committed) blocks are RETAINED in the allocator's LRU —
            # no slot-donor bookkeeping needed
            self._claimed.discard(req.rid)
            slot = self.slots.release(req.rid)
            if slot is not None:
                self.kv.clear_row(slot)
            if not self._external_bookkeeping:
                self.kv.allocator.free(req.rid)    # no-op if never held
            return
        # the freed row keeps its donor registration: its prompt KV
        # stays adoptable until the slot is reacquired
        if req.rid in self._claimed and self.slots.has(req.rid):
            # claim never consumed (admission unwound): the row's prefix
            # columns are valid KV — re-register it as a retained donor
            # instead of forfeiting what adoption deregistered
            slot = self.slots.slot(req.rid)
            n = int(self.positions[slot]) // self.cache_block_size
            if n > 0 and req.prompt_tokens:
                self._donors.insert(
                    req.prompt_tokens[:n * self.cache_block_size],
                    [slot] * n)
        self._claimed.discard(req.rid)
        self.slots.release(req.rid)

    def _register_donor(self, req: Request, slot: int):
        """Prefill complete (or migrated-in state landed): publish the
        prompt's full blocks as reusable prefix KV."""
        if not self.prefix_cache_enabled or not req.prompt_tokens:
            return
        if self.paged:
            # blocks ARE the donor currency: publish + retain them in
            # the shared radix tree (idempotent: the Instance commits
            # through the same PrefixCache at prefill completion)
            if (self.prefix_cache_obj is not None
                    and self.kv.allocator.holds(req.rid)):
                self.prefix_cache_obj.commit(req.rid, req.prompt_tokens)
            return
        n = len(req.prompt_tokens) // self.cache_block_size
        if n > 0:
            self._donors.insert(
                req.prompt_tokens[:n * self.cache_block_size], [slot] * n)

    # ------------------------------------------------------------------
    def _row_cache(self, slot: int):
        """A copy of one slot's dense cache (the row-wise oracle works on
        its own row and writes it back)."""
        return {name: leaf[:, slot:slot + 1].clone()
                for name, leaf in self.cache.items()}

    def _write_row_cache(self, slot: int, row_cache):
        for name, leaf in self.cache.items():
            leaf[:, slot:slot + 1].copy_(row_cache[name])

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
        executor.

        While host spans record, the dispatch is one
        ``exec.enqueue.mixed`` span (a plan with prefill rows) or
        ``exec.enqueue.decode`` (decode only), with CUDA events around
        its device work on the card; the last step's events, which its
        resolve has passed, are read then and let go."""
        if self._pending is not None and not self._pending.resolved:
            raise RuntimeError(
                "step_async: previous step not resolved — the pipeline "
                "must be flushed (commit the in-flight iteration) first")
        if not HOST_SPANS.recording():
            step = self._step(plan)
        else:
            kind = "mixed" if plan.prefill_items else "decode"
            with HOST_SPANS.span("exec.enqueue." + kind) as sp:
                events = None
                if sp is not None and self.device.type == "cuda":
                    if self._timed is not None:
                        HOST_SPANS.device_ms(self._timed, wait=False)
                    events = (torch.cuda.Event(enable_timing=True),
                              torch.cuda.Event(enable_timing=True))
                    events[0].record()
                step = self._step(plan)
                if sp is not None:
                    if events is not None:
                        events[1].record()
                        sp.events, self._timed = events, sp
                    step.iid, step.it = sp.iid, sp.it
        if isinstance(step, PendingStep):
            self._pending = step
        return step

    def _step(self, plan):
        if self.paged:
            return self._step_paged(plan)
        if self.batched:
            return self._step_batched(plan)
        return self._step_reference(plan)

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
        self._donors = PrefixTree(self.cache_block_size)
        self._claimed.clear()
        self._preadded.clear()
        self._deferred_states.clear()
        for rid in list(self.slots._slot_of):
            slot = self.slots.release(rid)
            if self.paged and slot is not None:
                self.kv.clear_row(slot)
            if self.paged and not self._external_bookkeeping \
                    and self.kv.allocator.holds(rid):
                self.kv.allocator.free(rid)

    # ---- paged hot path: one fused mixed-batch step -------------------
    def _step_paged(self, plan) -> PendingStep:
        """Dispatch a whole TaiChi iteration — every prefill chunk AND
        every decode step — as ONE fused step over the block pool.
        Decode rows ride along as length-1 chunks (token = last sampled
        token, start = row position); per-row valid lengths and block
        tables make the geometry uniform and run the paged chunked-prefill
        kernel.  A decode-only iteration takes the K-step horizon (K = 1
        included) and runs the paged decode kernel."""
        if not plan.prefill_items and plan.decode_reqs:
            return self._step_horizon_paged(plan,
                                            getattr(plan, "horizon", 1))
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
        sp = HOST_SPANS.top("exec.enqueue.mixed")
        if sp is not None:
            n_dec = sum(1 for row in rows if row[5])
            B, T = packed.tokens.shape
            sp.note(B=B, T=T, NB=packed.tables.shape[1],
                    valid=int(packed.valid.sum()),
                    prefill_rows=len(rows) - n_dec, decode_rows=n_dec)
        toks_dev = self._mixed_fused(
            self._to_dev(packed.tokens), self._to_dev(packed.start),
            self._to_dev(packed.valid), self._to_dev(packed.tables))
        event = self._event()
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

    def _step_horizon_paged(self, plan, K: int) -> PendingStep:
        """K fused decode steps over the block pool: grow every row's
        table to its end-of-horizon frontier, dispatch once (on the card,
        a graph replay keyed by the packed ``(B, NB)`` and K), read back
        once."""
        rows = []   # (req, slot, pos, budget)
        for req, b in zip(plan.decode_reqs, _budgets(plan)):
            slot = self.slots.slot(req.rid)
            pos = int(self.positions[slot])
            self.kv.grow_for(slot, req.rid, min(pos + b, self.max_seq),
                             self._external_bookkeeping)
            rows.append((req, slot, pos, b))
        packed = batching.pack_decode(
            [int(self.last_token[s]) for _, s, _, _ in rows],
            [p for _, _, p, _ in rows], [b for _, _, _, b in rows],
            [self.kv.tables[s] for _, s, _, _ in rows],
            self.kv.max_blocks, self.cache_block_size)
        B, NB = packed.tables.shape
        sp = HOST_SPANS.top("exec.enqueue.decode")
        if sp is not None:
            sp.note(B=B, K=K, rows=len(rows),
                    replay=(self.graphs is not None
                            and ("paged", B, NB, K) in self.graphs.graphs))
        out = self._dispatch(
            ("paged", B, NB, K),
            lambda *a: (self._horizon_paged(*a, K=K),),
            packed.tokens, packed.start, packed.budget, packed.tables)
        if K == 1:
            # one step emits one token a row, whatever the device says:
            # land the advance at dispatch, as the mixed step does
            for _, slot, _, _ in rows:
                self.positions[slot] += 1
        return self._horizon_step(
            out, K, [(req, slot, i) for i, (req, slot, _, _) in
                     enumerate(rows)])

    def _horizon_step(self, out, K: int, rows) -> PendingStep:
        """The pending step of a dispatched K-step horizon whose result
        ``out[0]`` is ``_horizon_steps``'; ``rows`` are (request, slot,
        its column of the result).  At resolve only these rows' slots are
        updated: other slots may have been written host-side (a migration
        landing) while the step was in flight."""
        event = self._event()
        if K > 1:
            self.horizon_calls += 1

        def apply(arrays, handle) -> Dict[int, bool]:
            res = arrays[0]
            emitted, last, pos, done = res[K:K + 4]
            eos: Dict[int, bool] = {}
            for req, slot, c in rows:
                n = int(emitted[c])
                handle.emitted[req.rid] = n
                req.output_tokens.extend(int(t) for t in res[:n, c])
                self.last_token[slot] = int(last[c])
                self.positions[slot] = int(pos[c])
                if K > 1:
                    self.horizon_tokens += n
                if done[c]:
                    eos[req.rid] = True
            return eos

        return PendingStep(self, out, apply, K, event=event)

    # ---- batched dense path ------------------------------------------
    def _decode_mask(self, decode_reqs):
        """[n_slots] int32: 1 for the slots the plan decodes."""
        active = np.zeros(self.n_slots, np.int32)
        for req in decode_reqs:
            active[self.slots.slot(req.rid)] = 1
        return active

    def _step_batched(self, plan) -> PendingStep:
        K = getattr(plan, "horizon", 1)
        if K > 1 and self.packed and not plan.prefill_items \
                and plan.decode_reqs:
            return self._step_horizon_dense(plan, K)
        arrays: list = []
        appliers: list = []
        if plan.prefill_items:
            rows = plan.prefill_rows()
            if self.packed:
                self._dispatch_prefill_packed(rows, arrays, appliers)
            else:
                self._dispatch_prefill_slots(rows, arrays, appliers)
        if plan.decode_reqs:
            # one call over the full slot batch: the prefill dispatches
            # above already advanced their rows' positions, and those rows
            # (like every row the plan does not decode) are masked out
            decode_reqs = list(plan.decode_reqs)
            toks_dev, = self._dispatch(
                ("dense", 1), lambda *a: (self._decode_fused(*a),),
                self.last_token[:, None], self.positions,
                self._decode_mask(decode_reqs))
            arrays.append(toks_dev)
            for req in decode_reqs:
                self.positions[self.slots.slot(req.rid)] += 1

            def apply_decode(toks, handle, eos):
                for req in decode_reqs:
                    slot = self.slots.slot(req.rid)
                    tok = int(toks[slot])
                    req.output_tokens.append(tok)
                    self.last_token[slot] = tok
                    handle.emitted[req.rid] = 1
                    if self.eos_id is not None and tok == self.eos_id:
                        eos[req.rid] = True

            appliers.append(apply_decode)
        if not arrays:
            return ImmediateStep()
        event = self._event()

        def apply(np_arrays, handle) -> Dict[int, bool]:
            eos: Dict[int, bool] = {}
            for arr, fn in zip(np_arrays, appliers):
                fn(arr, handle, eos)
            return eos

        return PendingStep(self, arrays, apply, event=event)

    def _step_horizon_dense(self, plan, K: int) -> PendingStep:
        """K fused decode steps over the slot-contiguous dense cache: the
        full slot batch rides along, with per-slot budgets freezing every
        slot the plan does not decode."""
        slot_budget = np.zeros(self.n_slots, np.int32)
        rows = []   # (req, slot, slot)
        for req, b in zip(plan.decode_reqs, _budgets(plan)):
            slot = self.slots.slot(req.rid)
            slot_budget[slot] = b
            rows.append((req, slot, slot))
        out = self._dispatch(
            ("dense", K), lambda *a: (self._horizon_dense(*a, K=K),),
            self.last_token, self.positions, slot_budget)
        return self._horizon_step(out, K, rows)

    def _dispatch_prefill_packed(self, rows, arrays, appliers):
        windows = [_prefill_window(req, start, take)
                   for req, start, take, _ in rows]
        chunks = [c for c, _ in windows]
        row_slots = self.slots.slots_of([req.rid for req, _, _, _ in rows])
        packed = batching.pack_prefill(
            chunks, [pos for _, pos in windows], row_slots,
            self.n_slots, self.t_buckets)
        # padding rows (slot n_slots) gather some real row; only the real
        # rows are scattered back
        slots = np.minimum(packed.slots, self.n_slots - 1).astype(np.int64)
        toks_dev = self._prefill_packed(
            self._to_dev(packed.tokens), self._to_dev(packed.start),
            self._to_dev(packed.valid), self._to_dev(slots), len(rows))
        arrays.append(toks_dev)
        for i, (req, start, take, completes) in enumerate(rows):
            self.positions[row_slots[i]] = windows[i][1] + take

        def apply_prefill(toks, handle, eos):
            for i, (req, start, take, completes) in enumerate(rows):
                if not completes:
                    continue
                slot = row_slots[i]
                tok = int(toks[i])
                req.output_tokens.append(tok)
                self.last_token[slot] = tok
                self._register_donor(req, slot)
                if self.eos_id is not None and tok == self.eos_id:
                    eos[req.rid] = True

        appliers.append(apply_prefill)

    def _dispatch_prefill_slots(self, rows, arrays, appliers):
        for req, start, take, completes in rows:
            slot = self.slots.slot(req.rid)
            tokens, pos = _prefill_window(req, start, take)
            tok_dev = self._prefill_slot(
                self._to_dev(np.asarray(tokens, np.int32)[None]),
                self._to_dev(np.array([pos], np.int32)), slot)
            self.positions[slot] = pos + take
            arrays.append(tok_dev)

            def apply_row(toks, handle, eos, req=req, slot=slot,
                          completes=completes):
                if not completes:
                    return
                tok = int(toks[0])
                req.output_tokens.append(tok)
                self.last_token[slot] = tok
                self._register_donor(req, slot)
                if self.eos_id is not None and tok == self.eos_id:
                    eos[req.rid] = True

            appliers.append(apply_row)

    # ---- row-wise reference path (token-exact oracle) ----------------
    def _step_reference(self, plan) -> PendingStep:
        """The oracle keeps its simple one-call-per-row structure; it is
        wrapped lazily so ``step_async`` has a uniform surface (compute
        runs at resolve — there is nothing worth overlapping here)."""
        return PendingStep(
            self, (), lambda arrays, handle: self._execute_reference(plan))

    def _execute_reference(self, plan) -> Dict[int, bool]:
        eos: Dict[int, bool] = {}
        # --- chunked prefill (row-wise, exact shapes) ---
        for req, take in plan.prefill_items:
            slot = self.slots.slot(req.rid)
            tokens, pos = _prefill_window(req, req.prefill_pos, take)
            row_cache = self._row_cache(slot)
            last = self._prefill_row(
                row_cache, self._to_dev(np.asarray(tokens, np.int32)[None]),
                self._to_dev(np.array([pos], np.int32)))
            self._write_row_cache(slot, row_cache)
            self.positions[slot] = pos + take
            if take == req.prefill_remaining:
                # the sampled first token is NOT yet in the cache; it is
                # written when fed to the next decode step at position
                # == prompt_len (positions[slot] already points there).
                # Sampling happens on device — only the token id crosses.
                tok_dev = self._sample_batch(last)
                self.host_readbacks += 1
                self.host_syncs += 1
                tok = int(tok_dev.cpu()[0])
                req.output_tokens.append(tok)
                self.last_token[slot] = tok
                self._register_donor(req, slot)
                if self.eos_id is not None and tok == self.eos_id:
                    eos[req.rid] = True
        # --- decode (full slot batch, the scheduled rows only) ---
        if plan.decode_reqs:
            logits = self._decode(
                self._to_dev(self.last_token[:, None]),
                self._to_dev(self.positions),
                self._to_dev(self._decode_mask(plan.decode_reqs)))
            toks = self._sample_batch(logits).cpu().numpy()
            self.host_readbacks += 1
            self.host_syncs += 1
            for req in plan.decode_reqs:
                slot = self.slots.slot(req.rid)
                tok = int(toks[slot])
                req.output_tokens.append(tok)
                self.last_token[slot] = tok
                self.positions[slot] += 1
                if self.eos_id is not None and tok == self.eos_id:
                    eos[req.rid] = True
        return eos

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
        if not self.paged:
            return {"row": migrate.extract_row(self.cache, slot),
                    "pos": int(self.positions[slot]),
                    "last_token": int(self.last_token[slot])}
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
        if self.paged:
            if not isinstance(state, dict) or "paged_blocks" not in state:
                raise MigrationFormatError(
                    f"request {req.rid}: migrated state is in 'dense' "
                    "row format but the destination executor is 'paged' "
                    "— dense<->paged cross-migration is unsupported; "
                    "migrate between like engines")
            return self._insert_state_paged(req, state)
        if not isinstance(state, dict) or "row" not in state:
            raise MigrationFormatError(
                f"request {req.rid}: migrated state is in 'paged' block "
                "format but the destination executor is 'dense' — "
                "dense<->paged cross-migration is unsupported; migrate "
                "between like engines")
        row = state["row"]
        if set(row) != set(self.cache) or any(
                row[n].shape != self.cache[n][:, 0].shape for n in row):
            raise MigrationFormatError(
                f"request {req.rid}: the migrated row's leaves do not "
                "match this executor's dense cache")
        # a row is taken only with an admission (the row allocator's
        # grant): the state lands at add_request
        self._deferred_states[req.rid] = state

    def _land_row(self, req: Request, state, slot: int):
        migrate.insert_row(self.cache, state["row"], slot)
        self.positions[slot] = state["pos"]
        self.last_token[slot] = state["last_token"]
        # donor re-registration after migration-in: the landed row holds
        # valid KV for the full prompt — make it adoptable here too
        self._register_donor(req, slot)

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

    def export_request_blocks(self, req: Request, indices):
        """Host copies of the blocks at the given indices of ``req``'s
        owned block run (warm-recovery checkpoint materialization).
        Side-effect free — no refcounts, no LRU touches, no slot state;
        each payload carries its quantization format so the restore
        path can refuse a mismatched destination pool.  None when this
        executor cannot export (dense path, request not held, or an
        async step still in flight — mid-flight tensors are torn)."""
        if not self.paged or not self.kv.allocator.holds(req.rid):
            return None
        if self._pending is not None and not self._pending.resolved:
            return None
        bids = self.kv.allocator.owned(req.rid)
        fmt = self.kv_quant or "fp"
        return {i: {"fmt": fmt, "kv": self._host_blocks([bids[i]])}
                for i in indices if 0 <= i < len(bids)}

    # ------------------------------------------------------------------
    # hot-prefix replication (block-granular, no request attached)
    # ------------------------------------------------------------------
    def export_prefix_blocks(self, tokens: Sequence[int]):
        """Host copies of the cached pool blocks covering the longest
        resident full-block prefix of ``tokens``, for replication to a
        peer instance.  Side-effect free (no refcounts, no LRU touch) and
        deliberately NOT capped like match_tokens: a hot path's last full
        block is worth shipping even when a future request would still
        owe one prefill token."""
        pc = self.prefix_cache_obj
        if not self.paged or pc is None:
            return None
        n = len(tokens) // self.cache_block_size
        path = pc.tree.match(tokens, n, touch=False)
        if not path:
            return None
        bids = [nd.bid for nd in path]
        return {"paged_blocks": self._host_blocks(bids),
                "n_blocks": len(bids),
                "tokens": list(tokens[:len(bids) * self.cache_block_size]),
                "kv_format": self.kv_quant or "fp"}

    def import_prefix_blocks(self, state) -> int:
        """Land replicated prefix blocks into this pool and publish them
        to the donor tree.  Returns blocks newly admitted (0 when the
        prefix is already resident, nothing fit below the free
        watermark, or the payload carries no tensors — a bookkeeping-
        only payload must never alias garbage pool contents)."""
        pc = self.prefix_cache_obj
        if not self.paged or pc is None:
            return 0
        fmt = state.get("kv_format", "fp")
        want = self.kv_quant or "fp"
        if fmt != want:
            raise MigrationFormatError(
                f"replicated KV is {fmt!r} but the destination pool is "
                f"{want!r} — cross-format replication is unsupported")
        if state.get("paged_blocks") is None:
            return 0
        res = pc.admit_replica(state["tokens"], state["n_blocks"])
        if res is None:
            return 0
        skip, bids = res
        self.kv.insert_blocks(bids, state["paged_blocks"],
                              skip_blocks=skip)
        return len(bids) - skip

    def migration_bytes(self, req: Request) -> int:
        slot = self.slots.slot(req.rid)
        if not self.paged:
            # the whole row ships (its views: nothing is copied to count)
            return migrate.row_bytes({name: leaf[:, slot]
                                      for name, leaf in self.cache.items()})
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
