"""What one cell is, found by name: ``BENCHMARK.json`` at the root of the
checkout, the cell's configuration file (its ``file``), its traffic mix
(``servebench/traffic/<traffic>.json``) and the readers of its per-layer
metrics (``servebench/metrics/<name>.py``, one reader for every metric
of one name before its first dot).  A cell, a mix or a metric is
added by adding a file and an entry; nothing here names one."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional

#: the checkout's root (``servebench/harness/spec.py`` -> the root)
ROOT = Path(__file__).resolve().parents[2]
BENCH_DIR = ROOT / "servebench"
TRAFFIC_DIR = BENCH_DIR / "traffic"
METRICS_DIR = BENCH_DIR / "metrics"


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict            # the configuration file, as it is run
    traffic: dict           # the traffic mix's file
    traffic_name: str
    end_to_end: List[dict]  # the cell's end-to-end metrics (entries)
    per_layer: List[dict]   # the cell's per-layer metrics (entries)


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell_metrics(bench: dict, cell: str):
    """(end-to-end entries, per-layer entries) that ``cell`` reports: an
    entry with ``workloads`` where it lists the cell; a per-layer entry
    without it wherever its ``moves`` is reported."""
    e2e = [m for m in bench["end_to_end"] if _reports(m, cell)]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (cell in m["workloads"] if "workloads" in m
                 else m["moves"] in names)]
    return e2e, layer


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = load_benchmark(root)
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                       f"{sorted(entries)}")
    w = entries[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads(
        (root / "servebench" / "traffic" / f"{w['traffic']}.json")
        .read_text())
    e2e, layer = cell_metrics(bench, name)
    return Cell(name, int(w["chips"]), config, traffic, w["traffic"], e2e,
                layer)


def reader_path(metric: str, root: Path = ROOT) -> Path:
    """``servebench/metrics/<metric>.py``, or where that is absent the
    reader of the metric's name before its first dot (``mfu.chat`` is
    read by ``mfu.py``)."""
    d = root / "servebench" / "metrics"
    path = d / f"{metric}.py"
    return path if path.exists() else d / f"{metric.split('.', 1)[0]}.py"


def load_reader(metric: str, root: Path = ROOT) -> Callable:
    """The ``read`` function of the metric's reader (``reader_path``)."""
    spec = importlib.util.spec_from_file_location(
        "servebench_metric_" + metric.replace(".", "_").replace("-", "_"),
        reader_path(metric, root))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_metrics(entries: List[dict], run, root: Path = ROOT
                 ) -> Dict[str, dict]:
    """Each per-layer metric's reader over ``run``; a reader that finds
    nothing returns None and its metric is left out."""
    out: Dict[str, dict] = {}
    for m in entries:
        value: Optional[float] = load_reader(m["name"], root)(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
