"""Seeded, deterministic fault injection for the serving stack.

The injector describes *what goes wrong and when*; the recovery
machinery lives in ``repro.core.cluster`` (``fail_instance`` /
``quarantine_instance`` / ``recover_instance``, TRANSFER retry with
backoff) and ``repro.serving.server`` (watchdog, probation-based
re-admission).  Faults are expressed in event time so the same schedule
replays identically against ``SimExecutor`` and the live
``JaxExecutor`` paths.

Fault kinds
-----------
- ``CRASH``      instance dies with total HBM/KV loss (prefix cache and
                 host spill tier included); residents are evacuated
                 through preemption-by-recompute.
- ``STALL``      transient slowdown: the instance's next dispatches run
                 ``duration`` seconds behind the cost model, which is
                 exactly what the watchdog's step-deadline check keys on.
- ``EXEC_ERROR`` the instance's next executor step raises
                 ``InjectedFault``; the cluster catches it and
                 quarantines the instance.
- ``RECOVER``    explicit revival of a dead/quarantined instance
                 (quarantined instances also re-admit via the watchdog's
                 probation timer without a scheduled RECOVER).

TRANSFER faults are not scheduled by time — the injector is consulted
at every TRANSFER landing and drops/corrupts with the configured
probabilities, consuming its private RNG in event order (deterministic
for a fixed seed and schedule).
"""
from __future__ import annotations

import dataclasses
import hashlib
import random
from typing import Iterable, List, Optional, Sequence

import torch

from repro_torch.serving.tracing import HOST_SPANS

CRASH = "crash"
STALL = "stall"
EXEC_ERROR = "exec_error"
RECOVER = "recover"

#: transfer outcomes returned by ``FaultInjector.transfer_outcome``
DELIVER = "deliver"
DROP = "drop"
CORRUPT = "corrupt"

_INSTANCE_KINDS = (CRASH, STALL, EXEC_ERROR, RECOVER)


class InjectedFault(RuntimeError):
    """Raised by an armed executor step — the cluster's exec-error
    handler must treat it exactly like a real device failure."""


@dataclasses.dataclass
class Fault:
    """One scheduled instance fault at event time ``t``."""
    t: float
    kind: str                      # CRASH | STALL | EXEC_ERROR | RECOVER
    iid: int
    duration: float = 0.0          # STALL only: seconds of slowdown

    def __post_init__(self):
        if self.kind not in _INSTANCE_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}")


class FaultInjector:
    """Deterministic fault source: a sorted schedule of instance faults
    plus per-transfer drop/corruption probabilities.

    The cluster owns the delivery mechanics: ``Cluster.attach_faults``
    pushes one FAULT event per scheduled fault onto the event heap (so
    faults fire at exactly ``t`` in event order) and calls
    ``transfer_outcome`` at each TRANSFER landing.
    """

    def __init__(self, faults: Iterable[Fault] = (), seed: int = 0,
                 transfer_drop_p: float = 0.0,
                 transfer_corrupt_p: float = 0.0):
        self.schedule: List[Fault] = sorted(faults, key=lambda f: f.t)
        self.transfer_drop_p = transfer_drop_p
        self.transfer_corrupt_p = transfer_corrupt_p
        self._rng = random.Random(seed)
        # separate stream for retry-backoff jitter so adding jitter
        # never perturbs the transfer_outcome() sequence for a seed
        self._jitter_rng = random.Random(seed ^ 0x5EED)
        # counters (observability; the cluster keeps its own too)
        self.fired = {k: 0 for k in _INSTANCE_KINDS}
        self.transfer_drops = 0
        self.transfer_corruptions = 0

    # ------------------------------------------------------------------
    @classmethod
    def random_schedule(cls, seed: int, iids: Sequence[int], t_end: float,
                        n_crashes: int = 1, n_stalls: int = 2,
                        n_exec_errors: int = 1,
                        stall_duration: float = 0.5,
                        recover_after: Optional[float] = None,
                        transfer_drop_p: float = 0.0,
                        transfer_corrupt_p: float = 0.0) -> "FaultInjector":
        """Seeded random schedule over ``iids`` within ``(0, t_end)`` —
        the chaos tests' randomized schedule.  Each crash optionally gets
        a matching RECOVER ``recover_after`` seconds later."""
        rng = random.Random(seed)
        faults: List[Fault] = []
        def at() -> float:
            return rng.uniform(t_end * 0.1, t_end * 0.8)
        for _ in range(n_crashes):
            t, iid = at(), rng.choice(list(iids))
            faults.append(Fault(t, CRASH, iid))
            if recover_after is not None:
                faults.append(Fault(t + recover_after, RECOVER, iid))
        for _ in range(n_stalls):
            faults.append(Fault(at(), STALL, rng.choice(list(iids)),
                                duration=stall_duration))
        for _ in range(n_exec_errors):
            faults.append(Fault(at(), EXEC_ERROR, rng.choice(list(iids))))
        return cls(faults, seed=seed, transfer_drop_p=transfer_drop_p,
                   transfer_corrupt_p=transfer_corrupt_p)

    # ------------------------------------------------------------------
    def record(self, fault: Fault):
        self.fired[fault.kind] += 1

    def transfer_outcome(self) -> str:
        """Fate of one TRANSFER landing: DELIVER / DROP / CORRUPT.
        Consumes the injector RNG exactly once per landing so a fixed
        seed yields a fixed outcome sequence."""
        if self.transfer_drop_p <= 0.0 and self.transfer_corrupt_p <= 0.0:
            return DELIVER
        u = self._rng.random()
        if u < self.transfer_drop_p:
            self.transfer_drops += 1
            return DROP
        if u < self.transfer_drop_p + self.transfer_corrupt_p:
            self.transfer_corruptions += 1
            return CORRUPT
        return DELIVER

    def retry_jitter(self, base: float, prev: float, cap: float) -> float:
        """Decorrelated-jitter backoff delay: uniform in
        ``[base, 3 * prev]``, capped.  Transfers that failed together
        (e.g. all landings during a stall) fan out instead of retrying
        in lockstep the way a capped pure exponential would."""
        return min(cap, self._jitter_rng.uniform(
            base, max(base, prev) * 3.0))

    def arm_exec_error(self, instance) -> None:
        """One-shot: the instance's next ``step_async``/``execute``
        raises ``InjectedFault``.  Wraps the executor rather than the
        instance so the fault surfaces on the same call path a real
        device error would (works for SimExecutor and JaxExecutor)."""
        ex = instance.executor
        orig_step, orig_exec = ex.step_async, ex.execute

        def restore():
            ex.step_async, ex.execute = orig_step, orig_exec

        def boom(*a, **kw):
            restore()
            raise InjectedFault(
                f"injected executor fault on instance {instance.iid}")

        ex.step_async = boom
        ex.execute = boom


# ---------------------------------------------------------------------------
# content-hash verification for migrated KV payloads
# ---------------------------------------------------------------------------

@HOST_SPANS.traced("migrate.checksum")
def payload_checksum(state) -> str:
    """Deterministic content hash of a migration payload (nested
    dicts/lists of scalars, numpy arrays, torch tensors, bytes).  Computed at send
    and re-checked at landing so a corrupted transfer is detected and
    retried rather than silently decoded."""
    h = hashlib.blake2b(digest_size=16)
    _feed(h, state)
    return h.hexdigest()


def _feed(h, obj) -> None:
    if obj is None:
        h.update(b"\x00N")
    elif isinstance(obj, (bytes, bytearray)):
        h.update(b"\x00B")
        h.update(bytes(obj))
    elif isinstance(obj, str):
        h.update(b"\x00S")
        h.update(obj.encode())
    elif isinstance(obj, bool):
        h.update(b"\x00b1" if obj else b"\x00b0")
    elif isinstance(obj, (int, float)):
        h.update(b"\x00n")
        h.update(repr(obj).encode())
    elif isinstance(obj, dict):
        h.update(b"\x00D")
        for k in sorted(obj, key=repr):
            _feed(h, k)
            _feed(h, obj[k])
    elif isinstance(obj, (list, tuple, set, frozenset)):
        h.update(b"\x00L")
        items = sorted(obj, key=repr) if isinstance(
            obj, (set, frozenset)) else obj
        for it in items:
            _feed(h, it)
    elif isinstance(obj, torch.Tensor):
        # a tensor of the card (or bfloat16, which numpy cannot hold) has
        # no __array__: hash its raw bytes through one host copy
        t = obj.detach().contiguous().cpu()
        h.update(b"\x00T")
        h.update(str(t.dtype).encode())
        h.update(str(tuple(t.shape)).encode())
        h.update(t.reshape(-1).view(torch.uint8).numpy().tobytes())
    elif hasattr(obj, "__array__") or type(obj).__name__ == "ndarray":
        import numpy as np
        arr = np.asarray(obj)
        h.update(b"\x00A")
        h.update(str(arr.dtype).encode())
        h.update(str(arr.shape).encode())
        h.update(arr.tobytes())
    elif dataclasses.is_dataclass(obj):
        h.update(b"\x00C")
        h.update(type(obj).__name__.encode())
        _feed(h, dataclasses.asdict(obj))
    else:
        h.update(b"\x00O")
        h.update(repr(obj).encode())
