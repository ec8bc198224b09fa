"""Router-side admission queue: priority/fairness classes, bounded
depth.

Today's router either places an arrival immediately or (with early
rejection) drops it on the floor — a burst at 2x the sustainable rate
turns into a rejection storm even though the cluster could absorb it
over the next few seconds.  The admission queue sits between
``ServingLoop.submit`` and ``Cluster.submit``:

* arrivals enqueue under a **priority class** (``interactive`` >
  ``standard`` > ``batch`` by default, configurable);
* the loop **releases** requests to the cluster only while the
  in-flight population is below ``max_inflight`` — bursts queue here,
  bounded by ``max_depth``, instead of flooding instance queues;
* dequeue order is strict priority between classes of different
  priority and **weighted stride fairness** between classes of equal
  priority (FIFO within a class), so one chatty tenant class cannot
  starve its peers;
* when the queue is full, the *lowest-priority newest* entry is
  displaced in favor of a higher-priority arrival (the displaced
  request is rejected); an arrival that is itself lowest priority is
  rejected outright;
* ``shed`` drops from the back of the lowest classes — the
  controller's admission actuator when both TTFT and TPOT are starved
  (sliders cannot conjure capacity; shedding the cheapest queued work
  can).

Queue wait (release time - arrival) is a first-class telemetry span:
the loop reports it to ``TelemetryWindow.on_queue_wait`` and exports
depth gauges per class.
"""
from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Dict, List, Optional, Tuple

#: name -> (priority rank, fairness weight); lower rank wins, weight
#: splits service among classes of equal rank
PRIORITY_CLASSES: Dict[str, Tuple[int, float]] = {
    "interactive": (0, 1.0),
    "standard": (1, 3.0),
    "batch": (2, 1.0),
}


@dataclasses.dataclass
class AdmissionConfig:
    max_depth: int = 256          # queued entries across all classes
    max_inflight: int = 64        # released-but-unfinished cap
    classes: Dict[str, Tuple[int, float]] = dataclasses.field(
        default_factory=lambda: dict(PRIORITY_CLASSES))
    default_class: str = "standard"
    shed_fraction: float = 0.5    # controller actuator: share shed/epoch
    # per-class token-rate limits: class -> tokens (prompt +
    # max_new_tokens, charged at release) per ``budget_window`` seconds.
    # Classes absent from the map are unlimited; None disables the
    # mechanism entirely (bit-identical to the pre-budget queue).
    token_budgets: Optional[Dict[str, float]] = None
    budget_window: float = 1.0


@dataclasses.dataclass
class Entry:
    req: object                   # repro_torch.engine.request.Request
    cls: str
    enq_time: float


class AdmissionQueue:
    def __init__(self, cfg: Optional[AdmissionConfig] = None):
        self.cfg = cfg or AdmissionConfig()
        if self.cfg.default_class not in self.cfg.classes:
            raise ValueError(
                f"default class {self.cfg.default_class!r} not in classes")
        self._q: Dict[str, deque] = {c: deque() for c in self.cfg.classes}
        # stride scheduling between equal-priority classes: each dequeue
        # advances the class's pass by 1/weight; the smallest pass among
        # the non-empty top-priority classes serves next
        self._pass: Dict[str, float] = {c: 0.0 for c in self.cfg.classes}
        self.enqueued = 0
        self.released = 0
        self.released_by_class: Dict[str, int] = \
            {c: 0 for c in self.cfg.classes}
        self.displaced = 0
        self.shed_count = 0
        # token-rate limiting: tumbling window of tokens charged per
        # class (charged at release — the moment load hits the cluster)
        self._budget_window_start = 0.0
        self._window_tokens: Dict[str, float] = \
            {c: 0.0 for c in self.cfg.classes}
        self.budget_deferrals = 0     # pops refused by budget gating
        # drain-rate estimate for Retry-After: recent release timestamps
        self._release_times: deque = deque(maxlen=32)

    # ------------------------------------------------------------------
    def resolve_class(self, name: Optional[str]) -> str:
        return name if name in self._q else self.cfg.default_class

    def __len__(self) -> int:
        return sum(len(d) for d in self._q.values())

    def depth_by_class(self) -> Dict[str, int]:
        return {c: len(d) for c, d in self._q.items()}

    def oldest_wait(self, now: float) -> float:
        heads = [d[0].enq_time for d in self._q.values() if d]
        return (now - min(heads)) if heads else 0.0

    def _rank(self, cls: str) -> int:
        return self.cfg.classes[cls][0]

    # ------------------------------------------------------------------
    def push(self, req, cls: str, now: float) -> Tuple[bool, List[Entry]]:
        """Enqueue under ``cls``.  Returns ``(accepted, displaced)``:
        at bounded depth a strictly lower-priority queued entry is
        displaced (newest first) to make room; an arrival no better
        than everything queued is refused."""
        cls = self.resolve_class(cls)
        displaced: List[Entry] = []
        if len(self) >= self.cfg.max_depth:
            victim_cls = self._displacement_victim(self._rank(cls))
            if victim_cls is None:
                return False, displaced
            displaced.append(self._q[victim_cls].pop())   # newest waited
            self.displaced += 1                           # least: drop it
        self._q[cls].append(Entry(req, cls, now))
        self.enqueued += 1
        return True, displaced

    def _displacement_victim(self, incoming_rank: int) -> Optional[str]:
        worst = None
        for c, d in self._q.items():
            if d and self._rank(c) > incoming_rank:
                if worst is None or self._rank(c) > self._rank(worst):
                    worst = c
        return worst

    # ------------------------------------------------------------------
    def _roll_budget_window(self, now: float):
        if now - self._budget_window_start >= self.cfg.budget_window:
            self._budget_window_start = now
            for c in self._window_tokens:
                self._window_tokens[c] = 0.0

    def _under_budget(self, cls: str) -> bool:
        budgets = self.cfg.token_budgets
        if budgets is None or cls not in budgets:
            return True
        return self._window_tokens[cls] < budgets[cls]

    def pop(self, now: Optional[float] = None) -> Optional[Entry]:
        """Strict priority between ranks; weighted stride fairness
        within a rank; FIFO within a class.  With ``token_budgets``
        configured, classes over their window budget are skipped; None
        with a non-empty queue means nothing is releasable this tick
        (callers must stop draining, not spin)."""
        live = [c for c, d in self._q.items() if d]
        if not live:
            return None
        if self.cfg.token_budgets is not None and now is not None:
            self._roll_budget_window(now)
            eligible = [c for c in live if self._under_budget(c)]
            if not eligible:
                self.budget_deferrals += 1
                return None
            live = eligible
        top = min(self._rank(c) for c in live)
        cands = [c for c in live if self._rank(c) == top]
        cls = min(cands, key=lambda c: (self._pass[c], c))
        self._pass[cls] += 1.0 / self.cfg.classes[cls][1]
        # keep an idle class from banking unbounded credit: floor every
        # pass at the serving class's new pass minus one full quantum
        floor = self._pass[cls] - 1.0
        for c in self._q:
            if self._pass[c] < floor:
                self._pass[c] = floor
        self.released += 1
        self.released_by_class[cls] += 1
        entry = self._q[cls].popleft()
        # charge the request's worst-case token footprint against the
        # class window (output length is unknown a priori, so the cap
        # is the honest ceiling)
        self._window_tokens[cls] += (
            getattr(entry.req, "prompt_len", 0)
            + getattr(entry.req, "max_new_tokens", 0))
        if now is not None:
            self._release_times.append(now)
        return entry

    # ------------------------------------------------------------------
    def shed(self, fraction: Optional[float] = None,
             max_rank_protect: int = 0) -> List[Entry]:
        """Admission control as an actuator: drop ``fraction`` of the
        queue from the back of the lowest-priority classes upward,
        never touching classes ranked <= ``max_rank_protect``.
        Newest-first within a class — they have waited least and their
        TTFT clocks have the most headroom left to re-submit."""
        n = int(len(self) * (self.cfg.shed_fraction
                             if fraction is None else fraction))
        out: List[Entry] = []
        for c in sorted(self._q, key=self._rank, reverse=True):
            if self._rank(c) <= max_rank_protect:
                break
            d = self._q[c]
            while d and len(out) < n:
                out.append(d.pop())
            if len(out) >= n:
                break
        self.shed_count += len(out)
        return out

    def remove(self, rid: int) -> Optional[Entry]:
        """Pull one queued entry out by request id (client abandoned it
        before release).  Returns the entry, or None if ``rid`` is not
        queued here (already released, or never admitted)."""
        for d in self._q.values():
            for e in d:
                if e.req.rid == rid:
                    d.remove(e)
                    return e
        return None

    def retry_after_hint(self, now: Optional[float] = None) -> int:
        """Whole seconds a refused client should wait before retrying.
        With enough release history the hint is backlog / observed
        drain rate (how long the current queue actually takes to empty
        at the measured pace); otherwise it falls back to release-cycle
        counting (depth / max_inflight).  Clamped to [1, 60]."""
        if len(self._release_times) >= 2:
            span = self._release_times[-1] - self._release_times[0]
            if span > 0.0:
                rate = (len(self._release_times) - 1) / span
                return int(max(1, min(60, math.ceil(len(self) / rate))))
        cycles = len(self) / max(1, self.cfg.max_inflight)
        return int(max(1, min(60, 1 + cycles)))

    def drain(self) -> List[Entry]:
        """Empty the queue (graceful shutdown: these resolve
        cancelled)."""
        out = [e for c in sorted(self._q, key=self._rank)
               for e in self._q[c]]
        for d in self._q.values():
            d.clear()
        return out

    # ------------------------------------------------------------------
    def gauges(self, now: float) -> dict:
        out = {
            "depth": len(self),
            "depth_by_class": self.depth_by_class(),
            "oldest_wait_s": round(self.oldest_wait(now), 4),
            "enqueued_total": self.enqueued,
            "released_total": self.released,
            "released_by_class": dict(self.released_by_class),
            "displaced_total": self.displaced,
            "shed_total": self.shed_count,
        }
        if self.cfg.token_budgets is not None:
            out["budget_deferrals_total"] = self.budget_deferrals
            out["window_tokens_by_class"] = {
                c: self._window_tokens[c] for c in self.cfg.token_budgets}
        return out
