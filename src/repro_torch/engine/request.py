"""Request lifecycle for the serving engine and simulator.

A request moves through:  QUEUED -> PREFILL -> DECODE -> FINISHED,
possibly migrating between instances during DECODE (flowing decode
scheduling) and having its prefill and decode on *different* instances
(disaggregated request handling — hybrid mode's key freedom).

Latency accounting follows the paper (§2.1 / vLLM measurement):
  TTFT  = first-token time - arrival (includes queueing, prefill
          execution, and any decode-queue wait before the first decode).
  TPOT  = (last_token_time - first_token_time) / (n_output - 1),
          i.e. mean per-token latency excluding the first token.
"""
from __future__ import annotations

import dataclasses
import enum
import itertools
from typing import List, Optional

_rid_counter = itertools.count()


class State(enum.Enum):
    QUEUED = "queued"
    PREFILL = "prefill"
    DECODE = "decode"
    MIGRATING = "migrating"
    FINISHED = "finished"
    REJECTED = "rejected"      # early rejection (proxy, Mooncake-style)
    CANCELLED = "cancelled"    # shed from the admission queue, aborted by
                               # the client, or still queued when a
                               # graceful drain began
    FAILED = "failed"          # unrecoverable fault (instance crash under
                               # fail-stop, transfer retries exhausted,
                               # crash-recovery loop bound hit)


#: states a request never leaves — every submitted request must reach one
TERMINAL_STATES = (State.FINISHED, State.REJECTED, State.CANCELLED,
                   State.FAILED)


@dataclasses.dataclass
class Request:
    prompt_len: int
    max_new_tokens: int
    arrival: float = 0.0
    rid: int = dataclasses.field(default_factory=lambda: next(_rid_counter))
    # hidden ground truth for the simulator (the SCHEDULER must never read
    # this — output length is unknown a priori; paper Challenge 2):
    hidden_output_len: Optional[int] = None
    prompt_tokens: Optional[list] = None      # real token ids (engine, or
                                              # tokenized sim workloads)
    # ground truth from the workload generator: how many leading tokens
    # were emitted before in the same session/system-prompt group (the
    # scheduler must never read this — it's for measuring prefix share):
    shared_prefix_len: Optional[int] = None
    # admission-queue priority class (router-side; None = default class)
    priority: Optional[str] = None

    state: State = State.QUEUED
    prefill_pos: int = 0                      # prompt tokens processed
    cached_prefix_len: int = 0                # tokens served from KV cache
    # preemption-by-recompute: output length at the last preemption.  The
    # re-prefill token stream is prompt + the first ``recompute_offset``
    # output tokens, and the true cache position of a re-prefill chunk is
    # ``prefill_pos + recompute_offset`` (prefill_pos restarts negative so
    # the existing accounting — prefill_remaining, context_len — holds).
    recompute_offset: int = 0
    output_len: int = 0                       # tokens emitted so far
    output_tokens: List[int] = dataclasses.field(default_factory=list)

    # timing
    first_token_time: Optional[float] = None
    last_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    prefill_instance: Optional[int] = None
    decode_instance: Optional[int] = None
    n_migrations: int = 0
    # flowing-decode bookkeeping: output length at the last backflow —
    # TPOT of a flowed-back request is "reset" (paper §3.3 step 3)
    tpot_reset_len: int = 0
    tpot_reset_time: Optional[float] = None
    # prefill tokens co-batched during this request's decode iterations
    # (numerator of "interference intensity", paper §2.3.1)
    interference_tokens: int = 0
    # terminal outcome detail: "stop" (EOS) / "length" for FINISHED,
    # "abort" for client-cancelled, a failure reason for FAILED
    finish_reason: Optional[str] = None
    # fault recovery: times this request was evacuated off a failed /
    # quarantined instance (or lost a transfer) and re-prefilled; bounded
    # by FaultToleranceConfig.max_recoveries
    n_recoveries: int = 0
    # warm recovery: a restore plan from the RecoveryManager's latest
    # checkpoint ({"pos": stream position, "engine": optional
    # migration-format state}).  Consumed (and cleared) by the admitting
    # instance; None = ordinary cold recompute-from-0 path.
    restore_state: Optional[dict] = None

    # ----------------------------------------------------------------
    @property
    def target_output_len(self) -> int:
        if self.hidden_output_len is not None:
            return min(self.hidden_output_len, self.max_new_tokens)
        return self.max_new_tokens

    @property
    def prefill_remaining(self) -> int:
        return self.prompt_len - self.prefill_pos

    @property
    def context_len(self) -> int:
        return self.prefill_pos + self.output_len

    def record_token(self, now: float):
        self.output_len += 1
        if self.first_token_time is None:
            self.first_token_time = now
            self.tpot_reset_time = now
        self.last_token_time = now

    def ttft(self) -> Optional[float]:
        if self.first_token_time is None:
            return None
        return self.first_token_time - self.arrival

    def tpot(self) -> Optional[float]:
        """Mean per-output-token latency, excluding the first token."""
        if self.first_token_time is None or self.output_len <= 1:
            return None
        return ((self.last_token_time - self.first_token_time)
                / (self.output_len - 1))

    def current_tpot(self, now: float) -> Optional[float]:
        """TPOT *since the last backflow reset* — Algorithm 1 monitors this
        to decide flow-back (paper: 'logically treated as a new request,
        with its output length reset')."""
        n = self.output_len - self.tpot_reset_len
        if self.tpot_reset_time is None or n <= 1:
            return None
        return (self.last_token_time - self.tpot_reset_time) / (n - 1)

    def reset_tpot_window(self):
        self.tpot_reset_len = self.output_len
        self.tpot_reset_time = self.last_token_time

    def done(self) -> bool:
        return self.output_len >= self.target_output_len

    @property
    def remaining_output(self) -> int:
        """Tokens this request may still emit — the cap on its per-row
        decode-horizon budget (a K-step loop must stop exactly where
        the K=1 schedule would)."""
        return max(self.target_output_len - self.output_len, 0)

    @property
    def effective_output_len(self) -> int:
        """Output length since the last backflow reset — what longest-first
        degradation ranks on (a flowed-back request counts as 'new')."""
        return self.output_len - self.tpot_reset_len

    def interference_intensity(self) -> Optional[float]:
        if self.output_len == 0:
            return None
        return self.interference_tokens / self.output_len
