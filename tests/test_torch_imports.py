"""The port stands alone: no module of ``repro_torch`` (nor
``chip_smoke.py``) imports jax, flax or the reference package, and the
package imports where there is no GPU, no nvcc and no triton (kernels
are built at the first launch, never at import)."""
import ast
import importlib
import pathlib
import subprocess
import sys

import pytest
from test_torch_helpers import cap_threads

cap_threads()

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.module


@pytest.mark.parametrize(
    "path", _port_files(),
    ids=lambda p: str(p.relative_to(ROOT)))
def test_no_reference_or_jax_import(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_port_has_files_to_check():
    names = {p.name for p in _port_files()}
    assert {"engine.py", "graphs.py", "attention.py", "cluster.py",
            "server.py", "admission.py", "chip_smoke.py", "gateway.py",
            "http.py", "pipeline.py", "protocol.py", "tokenizer.py",
            "train.py", "optimizer.py", "checkpoint.py"} <= names
    rel = {str(p.relative_to(ROOT)) for p in _port_files()}
    assert {"src/repro_torch/training/train.py",
            "src/repro_torch/training/optimizer.py",
            "src/repro_torch/training/checkpoint.py",
            "src/repro_torch/launch/train.py",
            "src/repro_torch/core/autotune.py",
            "src/repro_torch/examples/quickstart.py",
            "src/repro_torch/examples/latency_shifting_demo.py",
            "src/repro_torch/examples/serve_goodput.py",
            "src/repro_torch/examples/train_smollm.py",
            "src/repro_torch/distributed/sharding.py",
            "src/repro_torch/distributed/hints.py",
            "src/repro_torch/launch/mesh.py",
            "src/repro_torch/launch/specs.py",
            "src/repro_torch/launch/dryrun.py",
            "src/repro_torch/launch/hillclimb.py",
            "src/repro_torch/analysis/roofline.py"} <= rel


#: what a front-end tokenizer worker imports (the package, the frontend
#: package it passes through, and the modules it runs): none loads torch
TORCH_FREE = ["repro_torch", "repro_torch.frontend",
              "repro_torch.frontend.pipeline",
              "repro_torch.frontend.protocol",
              "repro_torch.frontend.tokenizer",
              "repro_torch.frontend.admission"]


@pytest.mark.parametrize("mod", TORCH_FREE)
def test_module_loads_no_torch(mod):
    code = ("import importlib, sys\n"
            f"importlib.import_module({mod!r})\n"
            "print(sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('torch', 'numpy')))\n")
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env={"PYTHONPATH": str(PORT.parent), "PATH": ""}, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"


def test_port_imports_without_jax_or_toolchain():
    """Import every module of the port in a fresh interpreter whose PATH
    holds no nvcc; jax and the reference must stay unloaded."""
    mods = []
    for p in sorted(PORT.rglob("*.py")):
        parts = p.relative_to(PORT.parent).with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        f"{sorted(FORBIDDEN)!r}]\n"
        "assert not bad, bad\n"
        "import repro_torch.kernels.build as b\n"
        "assert b._lib is None\n"
        "print('ok', len(sys.modules))\n")
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env={"PYTHONPATH": str(PORT.parent), "PATH": ""}, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.startswith("ok")


def test_kernel_sources_are_package_data():
    csrc = PORT / "kernels" / "csrc"
    assert {p.name for p in csrc.iterdir()} >= {
        "paged_common.cuh", "paged_decode.cu", "paged_prefill.cu"}
    importlib.import_module("repro_torch.kernels.build")


def test_wrappers_refuse_to_fall_back_without_a_card():
    """A tensor that is not on the CPU never reaches the plain version:
    the meta device stands in for a device the kernels cannot serve."""
    import torch

    from repro_torch.kernels.decode_attention.ops import (
        paged_decode_attention)
    q = torch.empty((1, 4, 64), device="meta")
    pool = torch.empty((33, 2, 64), device="meta")
    with pytest.raises(RuntimeError):
        paged_decode_attention(
            q, pool, pool, torch.empty((1, 2), dtype=torch.int32,
                                       device="meta"),
            torch.empty((1,), dtype=torch.int32, device="meta"),
            block_size=16)


def test_executor_raises_without_a_card():
    import torch

    from repro_torch.configs import reduced_config
    from repro_torch.engine.engine import TorchExecutor
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchExecutor(reduced_config("smollm-135m"), {}, n_slots=2,
                      max_seq=64)


#: framework-free modules carried over from the reference: a later diff
#: against the reference must show import lines only
CARRIED_OVER = [
    "engine/request.py", "engine/kvcache.py", "engine/batching.py",
    "cache/shared_allocator.py", "cache/prefix_tree.py",
    "cache/prefix_cache.py", "cache/spill.py", "cache/__init__.py",
    "core/instance.py", "core/cluster.py", "core/policies.py",
    "core/proxy.py", "core/flowing.py", "core/latency.py",
    "sim/workload.py", "serving/tracing.py", "sim/simulator.py",
    "configs/registry.py", "configs/__init__.py",
    "serving/metrics.py", "serving/controller.py",
    "frontend/tokenizer.py", "frontend/protocol.py",
    "frontend/http.py", "frontend/gateway.py",
]


@pytest.mark.parametrize("rel", CARRIED_OVER)
def test_carried_over_module_differs_only_in_import_lines(rel):
    ref = (ROOT / "src" / "repro" / rel).read_text().splitlines()
    got = (PORT / rel).read_text().splitlines()
    assert len(ref) == len(got)
    for a, b in zip(ref, got):
        if a != b:
            assert a.lstrip().startswith(("from ", "import ")), (a, b)
            assert a.replace("repro.", "repro_torch.") == b
