#!/usr/bin/env python3
"""Finds a cell's knee: serves its mix at each of a list of rates, one
window for each of ``--repeats`` seeds, on one set-up, and prints a JSON
line per window (the end-to-end numbers and whether a backlog grew).
``--executor`` overrides keys of the configuration's ``executor`` (a pool
size, say).  Exits 1 where a window had executor errors.

    python3 servebench/tools/sweep.py --workload llava-next-34b.chat-sat \
        --seed 11 --seconds 30 --rates 0.4,0.7,1.0 --repeats 2 \
        [--executor hbm_blocks=8192,n_slots=1024]
"""
from __future__ import annotations

import argparse
import sys

import common


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--repeats", type=int, default=1)
    ap.add_argument("--executor", default="")
    args = ap.parse_args()
    rates = [float(r) for r in args.rates.split(",")]
    executor = {k: int(v) for k, v in
                (kv.split("=") for kv in args.executor.split(",") if kv)}
    _, bench, _, _ = common.session(args.workload, args.seed, args.seconds,
                                    rates[0], executor=executor)
    common.emit(phase="setup", executor=bench.ex, **bench.notes)
    errors = 0
    seed = args.seed
    for rate in rates:
        for _ in range(args.repeats):
            row = common.window(bench, seed, rate)
            errors += row["exec_errors"]
            common.emit(phase="rate", **row)
            bench.finish()
            seed += 1
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
