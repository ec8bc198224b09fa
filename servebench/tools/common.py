"""Set-up shared by the tools that serve several windows in one process
(``sweep.py``, ``readings.py``): one set of executors and weights, each
window run as ``run.py`` runs it."""
from __future__ import annotations

import copy
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
sys.path[:0] = [BENCH, os.path.join(ROOT, "src")]
os.environ["REPRO_TORCH_BUILD_DIR"] = os.path.join(ROOT, "build")


def session(workload: str, seed: int, seconds: float, rate=None,
            device="cuda", cell=None, executor=None):
    """(cell, bench, params, flat): ``workload``'s cell (at ``rate``
    requests a second and with the ``executor`` overrides, if given), its
    weights for ``seed`` and a set-up Bench."""
    import torch

    from harness.serve import Bench
    from harness.spec import load_cell
    from harness.weights import make_params
    cell = cell or load_cell(workload)
    if rate is not None:
        cell.traffic = copy.deepcopy(cell.traffic)
        cell.traffic["arrivals"]["rate_per_s"] = rate
    if executor:
        cell.config = copy.deepcopy(cell.config)
        cell.config["executor"].update(executor)
    params, flat = make_params(cell.config, seed, device)
    bench = Bench(cell, seed, seconds, False, device)
    bench.setup(params)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return cell, bench, params, flat


def window(bench, seed: int, rate=None):
    """Serves one window (and drain) of ``seed`` at ``rate`` on the
    bench's executors; returns its end-to-end numbers."""
    from harness.measure import end_to_end
    if rate is not None:
        bench.cell.traffic["arrivals"]["rate_per_s"] = rate
    bench.seed = seed
    bench.set_traffic()
    t0 = time.perf_counter()
    bench.capture_window_buckets()
    bench.run_window()
    w = bench.window_timed()
    e2e = end_to_end(w, bench.limits, bench.sink.in_window, bench.seconds)
    half = sorted(w, key=lambda r: r.due)
    k = len(half) // 2
    ttft = lambda rs: sorted(r.ttft() for r in rs)[len(rs) // 2]
    out = dict(e2e, seed=seed, rate=bench.traffic.rate, requests=len(w),
               unfinished_at_close=sum(
                   1 for r in w if r.first is None or
                   (r.last or 0) >= bench.seconds and not r.finished),
               ttft_p50_first_half=ttft(half[:k]) if k else None,
               ttft_p50_second_half=ttft(half[k:]) if k else None,
               transfers=bench.cluster.transfer_count,
               exec_errors=bench.cluster.exec_errors,
               captures_in_window=bench.captures_in_window,
               setup_and_window_s=time.perf_counter() - t0,
               drain_end_s=bench.end)
    return out


def emit(**kw):
    print(json.dumps(kw, default=float), flush=True)
