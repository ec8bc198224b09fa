"""What the per-layer readers (``servebench/metrics/<name>.py``) read: one
run's records, and the arithmetic each reader applies to them.  A reader
returns None where its run holds nothing to read; a share of a roofline
or of a peak is never written as 0 for want of data."""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from harness import count
from harness.measure import percentile


@dataclasses.dataclass
class RunView:
    shape: count.Shape
    device: str
    power_limit_w: Optional[float]
    profile: Optional[dict]          # trace.read() of the traced slice
    slice: list                      # serve.Dispatch of the traced slice
    window: list                     # of the window, outside the slice
    lags: List[float]                # sink wall time - loop time, a token
    transfers: int
    finished: int
    pool_blocks: List[int]           # blocks of each instance's pool


def model_flops(run: RunView, dispatches) -> float:
    rows = []
    for d in dispatches:
        if d.kind == "decode":
            # every token of the horizon: row position p at step s
            rows += [(p + s, 1, True) for p, b in d.decode
                     for s in range(min(b, d.steps))]
        else:
            rows += [(s, v, c) for s, v, c in d.prefill]
            rows += [(p, 1, True) for p, _ in d.decode]
    return count.model_tokens(run.shape, rows)


def least_kernel_seconds(run: RunView, kernel: str) -> float:
    """The least time of the slice's calls of ``kernel`` (one call a layer
    of each step), each call bound by its FLOPs or its bytes."""
    total = 0.0
    for d in run.slice:
        if kernel == "paged_decode" and d.kind == "decode":
            for s in range(d.steps):
                keys = [p + s + 1 for p, b in d.decode if b > s]
                if keys:
                    f, b = count.decode_call(run.shape, keys)
                    total += count.least_seconds(f, b, run.device)[0]
        elif kernel == "paged_prefill" and d.kind == "mixed":
            rows = [(s, v) for s, v, _ in d.prefill] \
                + [(p, 1) for p, _ in d.decode]
            f, b = count.prefill_call(run.shape, rows)
            total += count.least_seconds(f, b, run.device)[0]
    return total * run.shape.layers


#: kernel names (as CUPTI reports them) of each paged kernel's launches
KERNEL_NAMES = {
    "paged_decode": (("decode_split_kernel", "PoolView"),
                     ("decode_combine_kernel",)),
    "paged_prefill": (("prefill_mma_kernel", "PoolView"),
                      ("prefill_fma_kernel", "PoolView")),
}


def kernel_seconds(run: RunView, kernel: str) -> float:
    pats = KERNEL_NAMES[kernel]
    return sum(t for name, t in run.profile["kernels"].items()
               if any(all(p in name for p in pat) for pat in pats))


def roofline_share(run: RunView, kernel: str) -> Optional[float]:
    if run.profile is None:
        return None
    t = kernel_seconds(run, kernel)
    least = least_kernel_seconds(run, kernel)
    if t <= 0 or least <= 0:
        return None
    return 100.0 * least / t


def mfu(run: RunView) -> Optional[float]:
    if run.profile is None or not run.slice or run.profile["window_s"] <= 0:
        return None
    peak = count.peaks(run.device)["bf16_flops_per_s"]
    return 100.0 * model_flops(run, run.slice) / (
        run.profile["window_s"] * peak)


def device_idle_share(run: RunView) -> Optional[float]:
    p = run.profile
    if p is None or p["window_s"] <= 0 or p["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])


def decode_step_ms(run: RunView) -> Optional[float]:
    xs = [d.device_ms() / d.steps for d in run.window
          if d.kind == "decode" and d.replayed]
    return float(np.mean(xs)) if xs else None


def prefill_iter_ms(run: RunView) -> Optional[float]:
    xs = [d.device_ms() for d in run.window if d.prefill]
    return float(np.mean(xs)) if xs else None


def kv_peak_share(run: RunView) -> Optional[float]:
    if not run.window:
        return None
    used = [0] * len(run.pool_blocks)
    peak = 0
    for d in sorted(run.window + run.slice, key=lambda d: d.t):
        used[d.inst] = d.used_blocks
        peak = max(peak, sum(used))
    return 100.0 * peak / sum(run.pool_blocks)


def clock_lag_s(run: RunView) -> Optional[float]:
    return percentile(run.lags, 90) if run.lags else None


def transfers_per_request(run: RunView) -> Optional[float]:
    return run.transfers / run.finished if run.finished else None
