#!/usr/bin/env python3
"""Runs one cell of the serving benchmark once, on one machine's cards.

    python3 servebench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell (an entry of ``workloads`` in ``BENCHMARK.json``) names a model
configuration (``servebench/configs/``) and a traffic mix
(``servebench/traffic/``).  The run makes the weights and the requests
from ``--seed``, sets the program up and warms it, serves the mix for
``--seconds`` on the program's main path (``harness/serve.py``), and then
compares a sample of what it served with the plain reference
(``harness/check.py``).  The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics, read by
``servebench/metrics/<name>.py``), ``device``, with ``--trace 1`` a
``breakdown``, and last ``compared``: each number the comparison held
beside its limit.  The same numbers end standard error.

It exits non-zero and prints no result without a CUDA card (or with
fewer than the cell asks for), without the program (``src/``), or when a
module of JAX or of the reference package (``repro``) was loaded.  The
program's kernels are built into ``build/`` in this checkout at the
first run and found there by later ones.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [HERE, os.path.join(ROOT, "src")]
# the program's kernel build cache: a fixed directory in this checkout
os.environ["REPRO_TORCH_BUILD_DIR"] = os.path.join(ROOT, "build")

#: top-level modules that may not be loaded in a run (compared whole:
#: ``repro_torch`` is the program and allowed)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def process_age_s() -> float:
    """Seconds since this process started (its start time in
    ``/proc/self/stat`` against the boot clock)."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return time.clock_gettime(time.CLOCK_BOOTTIME) - start
    except (OSError, ValueError, IndexError):
        return 0.0


AGE0 = process_age_s() - (time.perf_counter() - T0)


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def power_limit_w():
    """The card's power limit, as ``nvidia-smi`` reads it (None where it
    cannot)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30, check=True).stdout
        return float(out.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def run(cell, seed: int, seconds: float, trace: bool, device="cuda"):
    """One run of ``cell``: returns (result, compared)."""
    import torch

    from harness import check, count, readout, trace as tracing
    from harness.measure import candidates, end_to_end
    from harness.serve import Bench
    from harness.spec import read_metrics
    from harness.weights import make_params

    cuda = torch.device(device).type == "cuda"
    bench = Bench(cell, seed, seconds, trace, device)
    params, _ = make_params(cell.config, seed, device)
    if cuda:
        torch.cuda.synchronize()
        bench.notes["free_after_weights"] = torch.cuda.mem_get_info()[0]
    bench.notes["weights_s"] = time.perf_counter() - T0
    bench.setup(params)
    if cuda:
        bench.notes["free_after_setup"] = torch.cuda.mem_get_info()[0]
    bench.run_window()
    setup_s = AGE0 + (bench.setup_end - T0)
    found = forbidden_modules()
    if found:
        raise SystemExit(f"forbidden modules loaded in the run: {found}")
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    window = bench.window_timed()
    e2e = end_to_end(window, bench.limits, bench.sink.in_window,
                     bench.seconds)
    e2e["setup_s"] = setup_s
    bench.notes["stats"] = candidates(window)
    finished = bench.finished_requests()
    roles = bench.roles()
    cluster = bench.cluster
    exec_errors = cluster.exec_errors
    failed = sum(r.failed for r in window)
    view = None
    if trace:
        cfg = bench.cfg
        shape = count.Shape(cfg.num_layers, cfg.d_model, cfg.num_heads,
                            cfg.num_kv_heads, cfg.head_dim, cfg.d_ff,
                            cfg.vocab_size, bench.ex["block_size"])
        prof = bench.profile
        t0 = prof.t0 if prof is not None and prof.t0 else float("inf")
        t1 = prof.t1 if prof is not None and prof.t1 else float("inf")
        close = bench.setup_end + bench.seconds
        view = readout.RunView(
            shape=shape, device=torch.cuda.get_device_name(0),
            power_limit_w=power_limit_w(),
            profile=(tracing.read(prof.prof) if prof is not None
                     and prof.done else None),
            slice=[d for d in bench.log if t0 <= d.t < t1],
            window=[d for d in bench.log
                    if d.t < close and not t0 <= d.t < t1],
            lags=bench.sink.lags, transfers=cluster.transfer_count,
            finished=len(finished),
            pool_blocks=[e.kv.num_blocks for e in bench.executors])
    del cluster
    bench.release()

    mix_check = cell.traffic["check"]
    sample = check.choose(finished, seed, roles, mix_check["served_tokens"],
                          mix_check["max_tokens"])
    t_check = time.perf_counter()
    gap, n_cmp = check.widest_gap(params, cell.config, sample, device)
    bench.notes["check_s"] = time.perf_counter() - t_check
    limit = float(cell.config["check"]["gap_limit"])
    compared = {
        "widest_logit_gap": {"value": gap, "limit": limit,
                             "tokens": n_cmp, "requests": len(sample)},
        "executor_errors": {"value": exec_errors, "limit": 0},
        # a graph captured inside the window: set-up's prediction of the
        # window's buckets (harness/serve.py) no longer holds
        "captures_in_window": {"value": bench.captures_in_window,
                               "limit": 0},
    }
    correct = (n_cmp > 0 and gap <= limit and exec_errors == 0
               and bench.captures_in_window == 0)
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": len(window),
              "failed": int(failed)}
    if trace:
        metrics = read_metrics(cell.per_layer, view)
        p = view.profile or {}
        dev.update(busy_s=p.get("busy_s", 0.0),
                   window_s=p.get("window_s", 0.0),
                   power_limit_w=view.power_limit_w)
        if view.profile is not None:
            bench.notes.update(
                trace_wall_s=prof.t1 - prof.t0,
                trace_device_events=p["device_events"],
                trace_spans=p["spans"], trace_dispatches=len(view.slice))
            result["breakdown"] = {
                "device_ops": tracing.top(p["kernels"]),
                "idle_gaps": tracing.top(p["idle_by_span"])}
    else:
        metrics = {m["name"]: {"value": float(e2e[m["name"]]),
                               "unit": m["unit"]} for m in cell.end_to_end}
    result["metrics"] = metrics
    result["device"] = dev
    result["notes"] = dict(bench.notes, drain_end_s=bench.end,
                           sampled=len(sample), sampled_tokens=n_cmp)
    return result, compared


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from harness.spec import load_cell
    cell = load_cell(args.workload)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.cuda.reset_peak_memory_stats()
    result, compared = run(cell, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    result["compared"] = compared
    for name, c in compared.items():
        print(f"compared {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
