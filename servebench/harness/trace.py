"""Reading the profiler's trace of a run's steady slice (``torch.profiler``
with CUPTI): time the device was busy, time by kernel, and the idle gaps,
each labelled with the benchmark's host span that was open at the time
(``loop.pace``, ``exec.dispatch.prefill``, ``exec.dispatch.decode``,
``exec.readback``; ``host.other`` where none was)."""
from __future__ import annotations

import collections
from typing import Dict, List, Tuple

import numpy as np

SPANS = ("loop.pace", "exec.dispatch.prefill", "exec.dispatch.decode",
         "exec.readback")
OTHER = "host.other"


def _union(intervals: np.ndarray) -> np.ndarray:
    """Merged [start, end] rows of ``intervals`` (sorted by start)."""
    out = []
    s, e = intervals[0]
    for a, b in intervals[1:]:
        if a > e:
            out.append((s, e))
            s, e = a, b
        elif b > e:
            e = b
    out.append((s, e))
    return np.array(out, dtype=np.int64)


def read(prof) -> dict:
    """Busy and window seconds, seconds by kernel name and idle seconds by
    host span, from a stopped ``torch.profiler.profile``."""
    from torch.autograd import DeviceType
    dev: List[Tuple[int, int, str]] = []
    spans: List[Tuple[int, int, str]] = []
    lo, hi = None, None
    for e in prof.profiler.kineto_results.events():
        s, t = e.start_ns(), e.end_ns()
        lo = s if lo is None else min(lo, s)
        hi = t if hi is None else max(hi, t)
        if e.device_type() == DeviceType.CUDA:
            if e.name() not in SPANS:   # not the spans' device mirrors
                dev.append((s, t, e.name()))
        elif e.is_user_annotation() and e.name() in SPANS:
            spans.append((s, t, e.name()))
    out = {"window_s": 0.0 if lo is None else (hi - lo) * 1e-9,
           "busy_s": 0.0, "kernels": {}, "idle_by_span": {},
           "device_events": len(dev), "spans": len(spans)}
    if not dev:
        return out
    by_name: Dict[str, float] = collections.defaultdict(float)
    for s, t, name in dev:
        by_name[name] += (t - s) * 1e-9
    iv = np.array(sorted((s, t) for s, t, _ in dev), dtype=np.int64)
    busy = _union(iv)
    out["busy_s"] = float((busy[:, 1] - busy[:, 0]).sum()) * 1e-9
    out["kernels"] = dict(by_name)
    # idle gaps: before the first busy interval, between, after the last
    starts = np.concatenate([[lo], busy[:, 1]])
    ends = np.concatenate([busy[:, 0], [hi]])
    keep = ends > starts
    starts, ends = starts[keep], ends[keep]
    idle = collections.defaultdict(float)
    if len(starts):
        spans.sort()
        sp_s = np.array([s for s, _, _ in spans], dtype=np.int64)
        sp_e = np.array([t for _, t, _ in spans], dtype=np.int64)
        names = [n for _, _, n in spans]
        mids = (starts + ends) // 2
        idx = np.searchsorted(sp_s, mids, side="right") - 1
        for g, i, m in zip(ends - starts, idx, mids):
            label = names[i] if i >= 0 and sp_e[i] >= m else OTHER
            idle[label] += g * 1e-9
    out["idle_by_span"] = dict(idle)
    return out


def top(d: Dict[str, float], n: int = 10, width: int = 160
        ) -> List[list]:
    return [[k[:width], v] for k, v in
            sorted(d.items(), key=lambda kv: -kv[1])[:n]]
