"""Multi-pod dry-run driver.

Traces every (architecture x input shape) case on the production meshes
(single-pod 16x16 and multi-pod 2x16x16) as one rank of a fake process
group of the mesh's world size (backend ``"fake"``: no peer, no
transfer), with every tensor a fake one (``FakeTensorMode``: shapes and
types, no allocation), and records per device: the FLOPs of the traced
rank's products and attention (``FlopCounterMode``'s formulas), the
bytes of every collective DTensor issues (``CollectiveCounter``), and
the live bytes of the rank (arguments, outputs, peak).  It writes one
JSON record per case under ``runs/dryrun_torch/`` and exits 1 on any
failure.  This is the counterpart of the reference's dry-run, which
compiles on 512 fake host devices (``XLA_FLAGS``); it runs on the host
by design, as the reference's does.

The reference counts a scan body once in ``cost_analysis`` and rebuilds
the costs from shallow unrolled probes (``_probe_costs``).  The port has
no scan: its trace runs every layer and every prefill chunk, so its
counts need no probes (``"cost_method": "traced"``).

Like the reference's, the dry-run traces the models' plain path: the
kernels' wrappers take their plain PyTorch versions on the host's fake
tensors, on each rank's local shards.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-14b --shape decode_32k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh single|multi|both] [--jobs 6]
  PYTHONPATH=src python -m repro_torch.launch.dryrun \
      --case qwen3-14b:prefill_32k:single --case qwen3-14b:train_4k:multi
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time
import traceback
import weakref

import torch

from repro_torch.analysis.roofline import (CollectiveCounter, LocalOpMode,
                                           roofline_report)
from repro_torch.configs import ASSIGNED
from repro_torch.distributed import hints as hints_mod
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import SHAPES, applicable, build_case

RUNS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                        "runs", "dryrun_torch")

FLOPS_NOTE = ("FlopCounterMode's formulas: matrix products, convolutions "
              "and attention only (elementwise ops, norms and softmax "
              "are not counted)")


# ---------------------------------------------------------------------------
# The fake world
# ---------------------------------------------------------------------------

def start_fake_world(world: int):
    """A fake process group of ``world`` ranks, this process rank 0
    (re-initialised where one of another size exists)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == world and \
                dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def stop_fake_world():
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# Tracing one rank
# ---------------------------------------------------------------------------

class _Shadow:
    """Entered around DTensor's sharding propagation's run of an op on
    global-shape fake tensors (it learns the output's shape so): the
    rank's counters skip those ops."""
    depth = 0

    def __enter__(self):
        _Shadow.depth += 1

    def __exit__(self, *exc):
        _Shadow.depth -= 1


#: the method of DTensor's ``ShardingPropagator`` that runs an op on
#: global-shape fake tensors, by torch version (the first one present)
_SHADOW_METHODS = ("_propagate_tensor_meta_non_cached",
                   "_propagate_tensor_meta")


@contextlib.contextmanager
def _skip_shadow_ops():
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    name = next((n for n in _SHADOW_METHODS
                 if hasattr(ShardingPropagator, n)), None)
    if name is None:
        raise RuntimeError(
            f"torch {torch.__version__}: DTensor's ShardingPropagator has "
            f"none of {_SHADOW_METHODS}, so the dry-run cannot tell its "
            f"shape propagation's ops from the rank's own")
    old = getattr(ShardingPropagator, name)

    def shadowed(self, *args, **kwargs):
        with _Shadow():
            return old(self, *args, **kwargs)

    setattr(ShardingPropagator, name, shadowed)
    try:
        yield
    finally:
        setattr(ShardingPropagator, name, old)


def _alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
    """DTensor's change of a shard's axis as one ``all_to_all_single``
    (piece i of the old axis to rank i, the pieces received laid along
    the new axis).  DTensor's own CPU path (for gloo, which has no
    all-to-all) gathers the whole tensor and cuts it, which would count
    ``mesh.size(mesh_dim)`` times the bytes a card's all-to-all moves."""
    from torch.distributed import _functional_collectives as funcol
    n = mesh.size(mesh_dim)
    x = input.unflatten(shard_dim, (n, -1)).movedim(shard_dim, 0)
    rest = x.shape[1:]
    y = funcol.all_to_all_single(x.contiguous().flatten(0, 1), None, None,
                                 (mesh, mesh_dim))
    if isinstance(y, funcol.AsyncCollectiveTensor):
        y = y.wait()
    y = y.unflatten(0, (n,) + rest[:1]).movedim(0, gather_dim)
    return y.flatten(gather_dim, gather_dim + 1).contiguous()


@contextlib.contextmanager
def _card_alltoall():
    from torch.distributed.tensor import placement_types
    if not hasattr(placement_types, "shard_dim_alltoall"):
        raise RuntimeError(
            f"torch {torch.__version__}: DTensor's placement_types has no "
            f"shard_dim_alltoall, so the dry-run cannot count a change of "
            f"a shard's axis as one all-to-all")
    old = placement_types.shard_dim_alltoall
    placement_types.shard_dim_alltoall = _alltoall
    try:
        yield
    finally:
        placement_types.shard_dim_alltoall = old


class RankTrace(LocalOpMode):
    """FLOPs and live bytes of the traced rank's local ops.  A storage an
    op makes counts from then until it is freed (``weakref.finalize``);
    the arguments' storages are not counted (``known``)."""

    def __init__(self, known=()):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flops = flop_registry
        self.flops = 0
        self.live = 0
        self.peak = 0
        self._tracked = {}
        self._known = set(id(s) for s in known)

    def on_op(self, func, args, kwargs, out):
        if _Shadow.depth:
            return
        fn = self._flops.get(func._overloadpacket)
        if fn is not None:
            self.flops += fn(*args, **kwargs, out_val=out)
        for t in _tensors(out):
            self.track(t)

    def track(self, t):
        st = t.untyped_storage()
        key = id(st)
        if key in self._tracked or key in self._known:
            return
        n = st.nbytes()
        self._tracked[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def _free(self, key):
        self.live -= self._tracked.pop(key, 0)


def _tensors(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tensors(v)]
    return []


def _locals(tree):
    """The traced rank's local tensors of a tree of DTensors (and plain
    tensors)."""
    return [t.to_local() if hints_mod.is_sharded(t) else t
            for t in _tensors(tree)]


def trace_case(case, mesh, use_hints: bool = False,
               seq_parallel: bool = False, sites: bool = False) -> dict:
    """Distribute ``case.args`` by ``case.in_specs`` over ``mesh``, run
    ``case.fn`` once on them, and return the traced rank's counts:
    ``arg_bytes``, ``out_bytes``, ``temp_bytes``,
    ``peak_bytes_per_device``, ``flops_per_device``,
    ``collective_bytes_per_device``, ``collectives`` (a count by op),
    ``collective_bytes_by_op``, ``trace_s`` and ``torch`` (the version
    traced: DTensor's placement choices, and so the collectives, change
    between versions); with ``sites``, ``collective_bytes_by_site``, the
    bytes by op and the model code's line that issued them, largest
    first."""
    from torch.distributed.tensor.experimental import implicit_replication
    mode = case.fake_mode
    with mode:
        args = tuple(shd.shard(mesh, spec, a)
                     for spec, a in zip(case.in_specs, case.args))
    arg_locals = _locals(args)
    arg_bytes = sum(t.numel() * t.element_size() for t in arg_locals)
    rank = RankTrace(known=[t.untyped_storage() for t in arg_locals])
    coll = CollectiveCounter(sites=sites)
    hint = (hints_mod.hints(shd.data_axes(mesh), "model", seq_parallel,
                            mesh) if use_hints else contextlib.nullcontext())
    t0 = time.perf_counter()
    with mode, implicit_replication(), _skip_shadow_ops(), \
            _card_alltoall(), coll, rank, hint:
        out = case.fn(*args)
        outs = _locals(out)
        for t in outs:
            rank.track(t)
    trace_s = time.perf_counter() - t0
    seen, out_bytes = set(), 0
    known = set(id(t.untyped_storage()) for t in arg_locals)
    for t in outs:
        key = id(t.untyped_storage())
        if key not in known and key not in seen:
            seen.add(key)
            out_bytes += t.untyped_storage().nbytes()
    peak = arg_bytes + rank.peak
    by_site = {} if not sites else {"collective_bytes_by_site": {
        k: float(v) for k, v in coll.bytes_by_site.most_common()}}
    return {
        "arg_bytes": int(arg_bytes),
        "out_bytes": int(out_bytes),
        "temp_bytes": int(peak - arg_bytes),
        "peak_bytes_per_device": int(peak),
        "flops_per_device": float(rank.flops),
        "collective_bytes_per_device": float(coll.total_bytes),
        "collectives": dict(coll.counts),
        "collective_bytes_by_op": {k: float(v)
                                   for k, v in coll.bytes_by_op.items()},
        "trace_s": round(trace_s, 3),
        "torch": torch.__version__,
        **by_site,
    }


def use_hints_for(case) -> bool:
    """Hints where the reference's measurements showed them to win:
    prefill, and FSDP training; off for decode and non-FSDP training."""
    return case.kind == "prefill" or (case.kind == "train"
                                      and "fsdp" in case.note)


def run_case(arch: str, shape: str, multi_pod: bool,
             verbose: bool = True, use_hints: bool = True,
             sites: bool = False) -> dict:
    world = 512 if multi_pod else 256
    start_fake_world(world)
    mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
    case = build_case(arch, shape, mesh)
    hinted = use_hints and use_hints_for(case)
    counts = trace_case(case, mesh, use_hints=hinted, sites=sites)
    rec = {
        "arch": arch, "shape": shape,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "n_devices": world,
        "kind": case.kind, "note": case.note, "hints": hinted,
        **counts,
        "cost_method": "traced",
        "flops_note": FLOPS_NOTE,
    }
    rec["roofline"] = roofline_report(rec)
    if verbose:
        print(json.dumps(rec, indent=2))
    return rec


def save(rec: dict, runs_dir: str = RUNS_DIR):
    os.makedirs(runs_dir, exist_ok=True)
    name = f"{rec['arch']}__{rec['shape']}__{rec['mesh']}.json"
    with open(os.path.join(runs_dir, name), "w") as f:
        json.dump(rec, f, indent=2)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ASSIGNED)
    ap.add_argument("--shape", choices=sorted(SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--case", action="append", default=[],
                    metavar="ARCH:SHAPE:single|multi",
                    help="one case (repeatable); replaces --arch/--shape/"
                         "--mesh/--all")
    ap.add_argument("--runs-dir", default=RUNS_DIR)
    ap.add_argument("--jobs", type=int, default=1,
                    help="cases traced side by side, each in a process of "
                         "its own")
    ap.add_argument("--sites", action="store_true",
                    help="also record the collective bytes by the model "
                         "code's line that issued them (slower)")
    args = ap.parse_args(argv)

    archs = ASSIGNED if (args.all or not args.arch) else [args.arch]
    shapes = sorted(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    # (multi_pod, arch, shape): one world size at a time, the fake group
    # re-initialised between the single-pod and the multi-pod pass
    todo = [(mp, a, s) for mp in meshes for a in archs for s in shapes]
    if args.case:
        todo = []
        for c in args.case:
            a, s, m = c.split(":")
            todo.append((m == "multi", a, s))
        todo.sort(key=lambda c: c[0])
    if args.jobs > 1:
        return _fan_out(todo, args)
    ok = fail = skip = 0
    t_all = time.perf_counter()
    try:
        for mp, arch, shape in todo:
            mname = "2x16x16" if mp else "16x16"
            app, why = applicable(arch, shape)
            if not app:
                if mp == todo[0][0]:
                    print(f"SKIP {arch} x {shape}: {why}")
                    skip += 1
                continue
            path = os.path.join(
                args.runs_dir, f"{arch}__{shape}__{mname}.json")
            if args.skip_existing and os.path.exists(path):
                ok += 1
                continue
            tag = f"{arch} x {shape} x {mname}"
            try:
                t0 = time.perf_counter()
                rec = run_case(arch, shape, mp, verbose=False,
                               sites=args.sites)
                save(rec, args.runs_dir)
                r = rec["roofline"]
                print(f"OK   {tag}: peak/dev="
                      f"{rec['peak_bytes_per_device'] / 2**30:.2f}"
                      f"GiB dominant={r['dominant']} "
                      f"trace={rec['trace_s']:.1f}s "
                      f"({time.perf_counter() - t0:.0f}s)",
                      flush=True)
                ok += 1
            except Exception as e:
                print(f"FAIL {tag}: {type(e).__name__}: {e}")
                traceback.print_exc()
                fail += 1
    finally:
        stop_fake_world()
    print(f"\ndry-run complete: {ok} ok, {fail} failed, {skip} skipped "
          f"in {time.perf_counter() - t_all:.0f}s (torch {torch.__version__})")
    if fail:
        raise SystemExit(1)


def _fan_out(todo, args):
    """Each applicable case of ``todo`` through this module's CLI in a
    process of its own, ``args.jobs`` at a time, the training cases (the
    longest traces) first; exits 1 on any failed case."""
    from concurrent.futures import ThreadPoolExecutor
    cases = [c for c in todo if applicable(c[1], c[2])[0]]
    cases.sort(key=lambda c: SHAPES[c[2]]["kind"] != "train")
    env = dict(os.environ, OMP_NUM_THREADS="1")

    def one(c):
        mp, arch, shape = c
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--case",
               f"{arch}:{shape}:{'multi' if mp else 'single'}",
               "--runs-dir", args.runs_dir] + (
                   ["--skip-existing"] if args.skip_existing else []) + (
                   ["--sites"] if args.sites else [])
        r = subprocess.run(cmd, env=env, capture_output=True, text=True)
        print("".join(l + "\n" for l in r.stdout.splitlines()
                      if l.startswith(("OK", "FAIL"))), end="", flush=True)
        if r.returncode:
            print(r.stderr[-3000:], file=sys.stderr)
        return r.returncode == 0

    t_all = time.perf_counter()
    with ThreadPoolExecutor(args.jobs) as pool:
        done = list(pool.map(one, cases))
    fail = done.count(False)
    skip = len({(a, s) for _, a, s in todo if not applicable(a, s)[0]})
    print(f"\ndry-run complete: {len(done) - fail} ok, {fail} failed, "
          f"{skip} skipped in "
          f"{time.perf_counter() - t_all:.0f}s ({args.jobs} jobs, "
          f"torch {torch.__version__})")
    if fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
