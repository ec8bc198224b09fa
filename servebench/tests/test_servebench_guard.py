"""Nothing a run imports is JAX, the reference package or the old
benchmarks, and the plain reference imports nothing of the program."""
from __future__ import annotations

import ast
import glob
import json
import os
import subprocess
import sys

from conftest import BENCH, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}

#: imports every module a run loads: the entry point, the program's
#: serving stack and every metric reader of BENCHMARK.json
LOAD_RUN = r"""
import json, os, sys
sys.argv = ["run.py"]
sys.path.insert(0, {bench!r})
import run
from harness import check, readout, trace
from harness.serve import program, traced_classes
from harness.spec import load_benchmark, load_reader
from harness.weights import port_config
P = program()
traced_classes(P)
bench = load_benchmark()
for c in bench["configs"]:
    port_config(json.load(open(os.path.join({root!r}, c["file"]))))
for m in bench["per_layer"]:
    load_reader(m["name"])
print(json.dumps({{name: getattr(mod, "__file__", None)
                   for name, mod in list(sys.modules.items())}}))
"""


def loaded(code: str) -> dict:
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, env=env, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def top(name: str) -> str:
    return name.split(".")[0]


def test_a_run_loads_no_jax_nor_the_reference_package():
    mods = loaded(LOAD_RUN.format(bench=BENCH, root=ROOT))
    assert "repro_torch" in {top(m) for m in mods}
    assert not {top(m) for m in mods} & FORBIDDEN, sorted(
        {top(m) for m in mods} & FORBIDDEN)
    old = os.path.join(ROOT, "benchmarks") + os.sep
    assert not [m for m, f in mods.items() if f and f.startswith(old)]


def test_names_are_compared_whole():
    # the program's name begins with the reference package's
    assert top("repro_torch.serving.server") not in FORBIDDEN
    assert top("repro.models") in FORBIDDEN


def test_the_reference_imports_nothing_of_the_program():
    mods = loaded(f"import sys, json; sys.path.insert(0, {BENCH!r}); "
                  "import reference.model; print(json.dumps({n: None for n "
                  "in sys.modules}))")
    tops = {top(m) for m in mods}
    assert not tops & (FORBIDDEN | {"repro_torch", "harness"}), tops
    for path in glob.glob(os.path.join(BENCH, "reference", "*.py")):
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            for n in names:
                assert top(n) in {"torch", "__future__", "typing", "math"}, \
                    (path, n)


def test_no_file_of_the_benchmark_reads_the_old_benchmarks():
    for path in glob.glob(os.path.join(BENCH, "**", "*.py"),
                          recursive=True):
        if os.path.basename(path) == os.path.basename(__file__):
            continue
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Constant) and isinstance(node.value,
                                                             str):
                assert "benchmarks/" not in node.value, path
            if isinstance(node, ast.ImportFrom) and node.module:
                assert top(node.module) != "benchmarks", path
            if isinstance(node, ast.Import):
                assert all(top(a.name) != "benchmarks" for a in node.names)
