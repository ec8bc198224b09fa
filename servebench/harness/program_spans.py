"""What the host-span readers (``servebench/metrics/<name>.py``) read: the
program's own host spans (``repro_torch.serving.tracing.HOST_SPANS``),
which record while ``torch.profiler`` does.  The recorder keeps its newest
session, so after a ``--trace 1`` run it holds the spans of the traced
slice.  A span's self time is its duration less what its children cover.

Each metric returns None where there is nothing to read: a checkout of
the program without the recorder, or a session without the spans the
metric reads.  The arithmetic takes any list of span records with
``name``, ``t0``, ``t1`` (ns; None while open), ``parent`` (index in the
list, -1 for a root) and ``attrs``."""
from __future__ import annotations

from typing import List, Optional

#: the root span, one a call of ``ServingLoop.run``
ROOT = "loop.run"


def session() -> Optional[list]:
    """The spans of the program's recorder's newest session (None where
    the program has no recorder)."""
    try:
        from repro_torch.serving import tracing
    except ImportError:
        return None
    rec = getattr(tracing, "HOST_SPANS", None)
    return None if rec is None else list(rec.spans)


def self_ns(spans) -> List[Optional[int]]:
    """Each span's duration less its closed children's (None while open)."""
    out = [None if s.t1 is None else s.t1 - s.t0 for s in spans]
    for s in spans:
        if s.parent >= 0 and s.t1 is not None \
                and out[s.parent] is not None:
            out[s.parent] -= s.t1 - s.t0
    return out


def _closed(spans, pred):
    own = self_ns(spans)
    return [(s, own[i]) for i, s in enumerate(spans)
            if own[i] is not None and pred(s.name)]


def host_unnamed_share(spans) -> Optional[float]:
    """100 x the self time of ``loop.run`` over its whole time: the
    share of the loop's host time in no named span."""
    if not spans:
        return None
    roots = _closed(spans, lambda n: n == ROOT)
    total = sum(s.t1 - s.t0 for s, _ in roots)
    return 100.0 * sum(own for _, own in roots) / total if total else None


def sched_ms(spans) -> Optional[float]:
    """Self time of the ``sched.*`` and ``cluster.*`` spans, in ms an
    executor iteration (an ``exec.enqueue.*`` span).  A migration's data
    movement (its ``migrate.*`` children: the KV export, the payload's
    checksums) is not in it."""
    if not spans:
        return None
    iters = sum(1 for s in spans if s.name.startswith("exec.enqueue."))
    if not iters:
        return None
    own = _closed(spans, lambda n: n.startswith(("sched.", "cluster.")))
    return 1e-6 * sum(o for _, o in own) / iters


def prefill_enqueue_ms(spans) -> Optional[float]:
    """Mean self time, in ms, of an ``exec.enqueue.mixed`` span (a step
    with prefill rows)."""
    if not spans:
        return None
    own = [o for s, o in _closed(spans, lambda n: n == "exec.enqueue.mixed")
           if s.attrs.get("prefill_rows", 1) > 0]
    return 1e-6 * sum(own) / len(own) if own else None


def mixed_pad_share(spans) -> Optional[float]:
    """100 x (1 - valid token positions / B x T) over the mixed steps that
    noted their packed shape."""
    if not spans:
        return None
    steps = [s.attrs for s in spans if s.name == "exec.enqueue.mixed"
             and "T" in s.attrs]
    cells = sum(a["B"] * a["T"] for a in steps)
    if not cells:
        return None
    return 100.0 * (1.0 - sum(a["valid"] for a in steps) / cells)


def emit_us(spans) -> Optional[float]:
    """Self time of ``loop.emit`` in microseconds a token it streamed."""
    if not spans:
        return None
    own = _closed(spans, lambda n: n == "loop.emit")
    tokens = sum(s.attrs.get("tokens", 0) for s, _ in own)
    return 1e-3 * sum(o for _, o in own) / tokens if tokens else None
