"""Analytical execution-time estimator (the paper's Vidur analogue).

The paper's scheduling (Algorithm 2) *requires* an execution-time
predictor: "The recent research Vidur models it and provides an accurate
and efficient execution time predictor, which we leverage" (§3.4).  Vidur
is GPU-profiled; here we derive times from first principles on the target
card (roofline: max(compute, memory) + overhead), which reproduces the
paper's two key phenomenological facts:

  * Obs 2 — decode-iteration time is *linear* in the number of prefill
    tokens piggybacked in the batch (compute-bound linear ops add time
    proportional to chunk tokens): TPOT = intercept + slope * interference.
  * Obs 3 — prefill processing capacity grows with chunk size (per-
    iteration overhead and decode piggyback amortize over more tokens).

Estimates are *per mixed batch iteration*: one instance executes
``prefill_tokens`` of chunked prefill (at a given context offset) plus a
batch of decodes in lock-step (aggregated batch handling).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from repro_torch.core.hw import InstanceSpec
from repro_torch.models.config import ModelConfig, dtype_itemsize


@dataclasses.dataclass(frozen=True)
class CostModel:
    cfg: ModelConfig
    inst: InstanceSpec = InstanceSpec()

    def __post_init__(self):
        # The estimator sits on the proxy's per-arrival hot path (every
        # routing decision sums prefill_time over whole queues), so the
        # config-derived constants are computed once here and the
        # context-dependent lookups are memoized.  Pure caching — the
        # formulas are unchanged.  (object.__setattr__: frozen dataclass.)
        object.__setattr__(self, "_itemsize", None)
        object.__setattr__(self, "_active_params", None)
        object.__setattr__(self, "_weight_bytes", None)
        object.__setattr__(self, "_kv_per_token", None)
        object.__setattr__(self, "_state_bytes_cache", {})
        object.__setattr__(self, "_prefill_time_cache", {})
        object.__setattr__(self, "_attn_const", None)

    # ------------------------------------------------------------------
    # static model quantities
    # ------------------------------------------------------------------
    @property
    def itemsize(self) -> int:
        if self._itemsize is None:
            object.__setattr__(self, "_itemsize",
                               dtype_itemsize(self.cfg.dtype))
        return self._itemsize

    @property
    def active_params(self) -> int:
        # matmul-relevant weights: exclude the embedding gather
        if self._active_params is None:
            object.__setattr__(
                self, "_active_params",
                self.cfg.active_param_count()
                - self.cfg.vocab_size * self.cfg.d_model)
        return self._active_params

    @property
    def weight_bytes(self) -> int:
        if self._weight_bytes is None:
            object.__setattr__(self, "_weight_bytes",
                               self.cfg.active_param_count() * self.itemsize)
        return self._weight_bytes

    def kv_bytes_per_token(self) -> float:
        """KV/state bytes appended per context token (amortized; SSM state
        is O(1) so contributes ~0 per token)."""
        if self._kv_per_token is None:
            object.__setattr__(self, "_kv_per_token",
                               self.cfg.kv_cache_bytes(1, 4096) / 4096)
        return self._kv_per_token

    def state_bytes(self, context: int) -> int:
        """Total cache bytes for one request at a given context length —
        the migration payload of flowing decode scheduling."""
        context = max(context, 1)
        b = self._state_bytes_cache.get(context)
        if b is None:
            b = self.cfg.kv_cache_bytes(1, context)
            self._state_bytes_cache[context] = b
        return b

    # ------------------------------------------------------------------
    # per-phase primitives
    # ------------------------------------------------------------------
    def _matmul_flops(self, tokens: int) -> float:
        return 2.0 * self.active_params * tokens

    def _attn_flops(self, tokens: int, ctx_start: float) -> float:
        """Attention score+value FLOPs for ``tokens`` new tokens whose
        context grows from ctx_start."""
        cfg = self.cfg
        if self._attn_const is None:
            n_attn = cfg.attn_layer_count()
            object.__setattr__(
                self, "_attn_const",
                (n_attn, 4.0 * n_attn * cfg.num_heads * cfg.head_dim))
        n_attn, flop_coeff = self._attn_const
        if n_attn == 0 or cfg.num_heads == 0:
            # SSM: linear-in-T mixer; fold into a small constant per token
            return 0.0
        avg_ctx = ctx_start + tokens / 2.0
        if cfg.sliding_window and cfg.local_global_ratio:
            r = cfg.local_global_ratio
            n_local = n_attn * r / (r + 1)
            n_global = n_attn - n_local
            eff_ctx = (n_local * min(avg_ctx, cfg.sliding_window)
                       + n_global * avg_ctx) / n_attn
        else:
            eff_ctx = avg_ctx
        return flop_coeff * tokens * eff_ctx

    def _kv_read_bytes(self, context: int) -> float:
        return self.state_bytes(context)

    def _tp_collective_time(self, tokens: int) -> float:
        """Per-layer all-reduce of activations across the TP group."""
        if self.inst.tp <= 1:
            return 0.0
        cfg = self.cfg
        n_layers = cfg.num_layers + cfg.num_encoder_layers
        bytes_ = (2.0 * tokens * cfg.d_model * self.itemsize * n_layers
                  * 2 * (self.inst.tp - 1) / self.inst.tp)
        return bytes_ / (self.inst.hw.ici_bw * self.inst.hw.ici_links)

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------
    def iteration_time(self, prefill_items: Sequence[tuple] = (),
                       decode_contexts: Sequence[int] = ()) -> float:
        """Time of one mixed-batch iteration.

        prefill_items: [(chunk_tokens, ctx_start), ...]
        decode_contexts: context length of each decode request in batch.
        """
        hw = self.inst
        p_tokens = sum(t for t, _ in prefill_items)
        d_tokens = len(decode_contexts)
        flops = self._matmul_flops(p_tokens + d_tokens)
        for t, c in prefill_items:
            flops += self._attn_flops(t, c)
        for c in decode_contexts:
            flops += self._attn_flops(1, c)
        t_compute = flops / (hw.flops * hw.hw.prefill_mfu)

        bytes_ = float(self.weight_bytes)
        for c in decode_contexts:
            bytes_ += self._kv_read_bytes(c)
        for t, c in prefill_items:
            bytes_ += self._kv_read_bytes(c) + t * self.kv_bytes_per_token()
        t_mem = bytes_ / (hw.hbm_bw * hw.hw.decode_membw_eff)

        t_coll = self._tp_collective_time(p_tokens + d_tokens)
        return (max(t_compute, t_mem) + t_coll
                + hw.hw.iteration_overhead_s)

    def prefill_time(self, prompt_len: int, chunk_size: int,
                     decode_batch: int = 0) -> float:
        """Total execution time to prefill ``prompt_len`` tokens with a
        given chunk size, assuming ``decode_batch`` decodes piggybacked in
        every iteration (Algorithm 2's E term)."""
        if chunk_size <= 0:
            return float("inf")
        key = (prompt_len, chunk_size, decode_batch)
        cached = self._prefill_time_cache.get(key)
        if cached is not None:
            return cached
        total, pos = 0.0, 0
        while pos < prompt_len:
            c = min(chunk_size, prompt_len - pos)
            total += self.iteration_time(
                [(c, pos)], [512] * decode_batch)
            pos += c
        if len(self._prefill_time_cache) < 1 << 18:
            self._prefill_time_cache[key] = total
        return total

    def decode_iteration_time(self, batch: int, avg_context: int,
                              chunk_tokens: int = 0) -> float:
        """Decode-iteration latency with optional prefill interference —
        the linear-TPOT primitive (Obs 2)."""
        items = [(chunk_tokens, 1024)] if chunk_tokens else []
        return self.iteration_time(items, [avg_context] * max(batch, 1))

    def transfer_time(self, context: int) -> float:
        """KV/state migration time between instances (paper §3.5: async
        NCCL; here the instance-to-instance link of ``hw.py``)."""
        return self.state_bytes(context) / self.inst.interconnect_bw

    def prefill_capacity(self, chunk_size: int, decode_batch: int = 0,
                         prompt_len: int = 3000) -> float:
        """Prefill tokens/second at steady state (paper Fig 8)."""
        t = self.prefill_time(prompt_len, chunk_size, decode_batch)
        return prompt_len / t
