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


#: carried-over modules that the port instruments with its host spans
#: (``repro_torch.serving.tracing.HOST_SPANS``): their syntax trees are
#: compared, with that instrumentation taken out of the port's
INSTRUMENTED = {"core/instance.py", "core/cluster.py", "serving/tracing.py"}

#: what the port took out of a carried-over module (read by nothing)
REMOVED = {"serving/tracing.py": {"Tracer.ttft_breakdown"}}

#: what the port added to a carried-over module: the names its new
#: imports and definitions bind (the recorder of host spans)
ADDED = {"serving/tracing.py": {
    "functools", "time", "torch", "_profiler_enabled", "_Mirror",
    "MAX_SPANS", "HostSpan", "_Off", "_Skip", "_OFF", "HostSpans",
    "HOST_SPANS"}}

#: the scopes whose docstring the port rewrote ("" is the module's)
REWORDED = {"serving/tracing.py": {"", "Tracer.to_chrome_trace"}}


def _on_host_spans(node) -> bool:
    """A call of a method of ``HOST_SPANS``."""
    return (isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and isinstance(node.func.value, ast.Name)
            and node.func.value.id == "HOST_SPANS")


def _without_host_spans(body):
    """``body`` with the host spans taken out: a ``with`` of spans gives
    its statements; a statement that is a call on ``HOST_SPANS``, or adds
    one's result (``x += HOST_SPANS...``), goes; so does a decorator that
    is one."""
    out = []
    for stmt in body:
        if isinstance(stmt, ast.With) and all(
                _on_host_spans(i.context_expr) and i.optional_vars is None
                for i in stmt.items):
            out += _without_host_spans(stmt.body)
            continue
        if isinstance(stmt, (ast.Expr, ast.AugAssign)) \
                and _on_host_spans(stmt.value):
            continue
        for field in ("body", "orelse", "finalbody"):
            if isinstance(getattr(stmt, field, None), list):
                setattr(stmt, field, _without_host_spans(getattr(stmt, field)))
        for h in getattr(stmt, "handlers", ()):
            h.body = _without_host_spans(h.body)
        if hasattr(stmt, "decorator_list"):
            stmt.decorator_list = [d for d in stmt.decorator_list
                                   if not _on_host_spans(d)]
        out.append(stmt)
    return out


def _defined(stmt):
    if isinstance(stmt, (ast.FunctionDef, ast.ClassDef)):
        return stmt.name
    if isinstance(stmt, ast.AnnAssign) and isinstance(stmt.target, ast.Name):
        return stmt.target.id
    if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
            and isinstance(stmt.targets[0], ast.Name):
        return stmt.targets[0].id
    return None


def _drop(tree, names, scope="") -> set:
    """Take the definitions named in ``names`` (``Class.method``) out of
    ``tree``, at any scope; returns the names found."""
    found = set()
    keep = []
    for s in tree.body:
        name = _defined(s)
        if name is not None and scope + name in names:
            found.add(scope + name)
            continue
        if isinstance(s, (ast.ClassDef, ast.FunctionDef)):
            found |= _drop(s, names, f"{scope}{s.name}.")
        keep.append(s)
    tree.body = keep
    return found


def _ported(module):
    if module == "repro" or (module or "").startswith("repro."):
        return "repro_torch" + module[len("repro"):]
    return module


def _import_lines(tree, ours=False):
    """The module's own import lines, alias by alias, taken out of
    ``tree``: (module, level, name, asname); the reference's modules named
    as the port's."""
    out = []
    for s in tree.body:
        if isinstance(s, ast.Import):
            out += [(None, 0, a.name if ours else _ported(a.name), a.asname)
                    for a in s.names]
        elif isinstance(s, ast.ImportFrom):
            out += [(s.module if ours else _ported(s.module), s.level,
                     a.name, a.asname) for a in s.names]
    tree.body = [s for s in tree.body
                 if not isinstance(s, (ast.Import, ast.ImportFrom))]
    return out


def _reword(tree, scopes):
    """Take the docstrings of ``scopes`` out of ``tree``."""
    for scope in scopes:
        node = tree
        for n in filter(None, scope.split(".")):
            node = next(s for s in node.body if _defined(s) == n)
        first = node.body[0]
        assert isinstance(first, ast.Expr) \
            and isinstance(first.value, ast.Constant) \
            and isinstance(first.value.value, str), scope
        node.body = node.body[1:]


def _trees_without_host_spans(rel):
    """The reference's module and the port's, each a list of top-level
    statements, with the host spans and ``ADDED`` taken out of the port's,
    ``REMOVED`` out of the reference's and ``REWORDED``'s docstrings out of
    both; the port's import lines must be the reference's."""
    ref = ast.parse((ROOT / "src" / "repro" / rel).read_text())
    got = ast.parse((PORT / rel).read_text())
    for node in ast.walk(ref):             # imports inside functions
        if isinstance(node, ast.ImportFrom):
            node.module = _ported(node.module)
    added = ADDED.get(rel, set())
    ref_imports = _import_lines(ref)
    got_imports, found = [], set()
    for m, lv, n, a in _import_lines(got, ours=True):
        bound = a or n.split(".")[0]
        if bound in added:
            found.add(bound)
        elif (m, n) != ("repro_torch.serving.tracing", "HOST_SPANS"):
            got_imports.append((m, lv, n, a))
    assert got_imports == ref_imports
    got.body = _without_host_spans(got.body)
    found |= _drop(got, added)
    assert found == added, added - found
    removed = REMOVED.get(rel, set())
    assert _drop(ref, removed) == removed
    _reword(ref, REWORDED.get(rel, ()))
    _reword(got, REWORDED.get(rel, ()))
    # the step keys of the tracer's events (``iid`` and ``it`` of an
    # ``.event`` call that has an ``it``)
    for node in ast.walk(got):
        if isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr == "event" \
                and any(k.arg == "it" for k in node.keywords):
            node.keywords = [k for k in node.keywords
                             if k.arg not in ("iid", "it")]
    return ref, got


@pytest.mark.parametrize("rel", CARRIED_OVER)
def test_carried_over_module_differs_only_in_import_lines(rel):
    """Line for line, but the import lines; a module the port instruments
    with host spans: its import lines and its syntax tree, with the spans
    taken out, are the reference's, but for ``ADDED``, ``REMOVED``,
    ``REWORDED`` and the step keys of the tracer's events."""
    if rel in INSTRUMENTED:
        ref, got = _trees_without_host_spans(rel)
        assert [_defined(s) for s in ref.body] \
            == [_defined(s) for s in got.body]
        for a, b in zip(ref.body, got.body):
            assert ast.dump(a, indent=1) == ast.dump(b, indent=1), \
                _defined(a)
        return
    ref = (ROOT / "src" / "repro" / rel).read_text().splitlines()
    got = (PORT / rel).read_text().splitlines()
    assert len(ref) == len(got)
    for a, b in zip(ref, got):
        if a != b:
            assert a.lstrip().startswith(("from ", "import ")), (a, b)
            assert a.replace("repro.", "repro_torch.") == b
