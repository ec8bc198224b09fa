#!/usr/bin/env python3
"""The readings a cell's comparison limit is set from: for each seed, the
weights of that seed, one window at the cell's own rate, and the widest
logit gap of the program's served tokens against the float32 reference;
for the control seeds also the control's gap (the reference in float8 in
the program's place, ``harness/check.py``).  One set-up serves every
seed (the weights are redrawn in place).

    python3 servebench/tools/readings.py --workload llava-next-34b.chat-sat \
        --seconds 20 --seeds 1,2,3 --control-seeds 1,2,3
"""
from __future__ import annotations

import argparse
import time

import common


def readings(workload, seconds, seeds, control_seeds, device="cuda",
             cell=None, emit=common.emit):
    from harness import check
    from harness.weights import make_params
    cell, bench, params, flat = common.session(workload, seeds[0], seconds,
                                               device=device, cell=cell)
    out = []
    for seed in seeds:
        make_params(cell.config, seed, device, flat=flat)
        e2e = common.window(bench, seed)
        finished = bench.finished_requests()
        sample = check.choose(finished, seed, bench.roles(),
                              cell.traffic["check"]["served_tokens"],
                              cell.traffic["check"]["max_tokens"])
        t0 = time.perf_counter()
        gap, n = check.widest_gap(params, cell.config, sample, device,
                                  bench.inputs)
        row = dict(seed=seed, program_gap=gap, tokens=n,
                   requests=len(sample),
                   migrated=sum(r.n_migrations > 0 for r in sample),
                   check_s=time.perf_counter() - t0,
                   ttft_p90_s=e2e["ttft_p90_s"],
                   slo_attainment=e2e["slo_attainment"],
                   exec_errors=e2e["exec_errors"],
                   captures_in_window=e2e["captures_in_window"])
        if seed in control_seeds:
            row["control_gap"], _ = check.control_gap(
                params, cell.config, sample, device, bench.inputs)
        bench.finish()
        emit(**row)
        out.append(row)
    bench.release()
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args()
    seeds = [int(s) for s in args.seeds.split(",")]
    ctl = [int(s) for s in args.control_seeds.split(",") if s]
    readings(args.workload, args.seconds, seeds, ctl)


if __name__ == "__main__":
    main()
