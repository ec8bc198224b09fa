"""On the card, at each cell's own size and load: the comparison's
control (the float32 reference computed with float8 products in the
program's place) fails the cell's limit on three seeds, and the program
passes it on the same seeds.  Runs only where there is a CUDA card:

    python -m pytest -q -m gpu servebench/tests/test_servebench_control.py
"""
from __future__ import annotations

import gc
import os
import sys

import pytest

from conftest import BENCH
from harness.spec import load_benchmark, load_cell

sys.path.insert(0, os.path.join(BENCH, "tools"))

SEEDS = (9001, 9002, 9003)
WINDOW_S = 20.0


@pytest.mark.gpu
@pytest.mark.parametrize("workload",
                         [w["name"] for w in load_benchmark()["workloads"]])
def test_control_fails_and_program_passes(workload):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import readings
    cell = load_cell(workload)
    limit = cell.config["check"]["gap_limit"]
    rows = readings.readings(workload, WINDOW_S, list(SEEDS), list(SEEDS))
    gc.collect()
    torch.cuda.empty_cache()     # the next cell's weights need the card
    for r in rows:
        assert r["program_gap"] <= limit < r["control_gap"], r
