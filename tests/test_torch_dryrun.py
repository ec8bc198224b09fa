"""The port's dry-run (``repro_torch.launch.dryrun``): ``trace_case`` on
a fake (2, 4) mesh for a reduced config of each family, train, prefill
and decode; on a fake (2, 2, 2) mesh (the multi-pod batch axes) for the
hybrid family's prefill and decode; and one full-size case through the
CLI.  The fake process groups live in subprocesses."""
import json
import os
import subprocess
import sys
import tempfile

import pytest
import torch

from repro_torch.launch import dryrun
from test_torch_helpers import cap_threads

cap_threads()

ROOT = os.path.join(os.path.dirname(__file__), "..")
FAMILIES = ["qwen2.5-3b", "granite-moe-3b-a800m", "mamba2-1.3b",
            "zamba2-7b", "whisper-base", "llava-next-34b"]
SHAPES = ["train_4k", "prefill_32k", "decode_32k"]
MESHES = {"2x4": ((2, 4), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
# what each mesh traces: DTensor's sharding propagation over a three-axis
# mesh costs several times a two-axis one's, so (2, 2, 2) traces the
# family that holds both attention and the scan, and no training step;
# (2, 4) also the sliding-window family's decode, whose ring caches (one
# KV head) split along their slots
MESH_CASES = {"2x4": [(a, s) for a in FAMILIES for s in SHAPES]
              + [("gemma3-1b", "decode_32k")],
              "2x2x2": [("zamba2-7b", s) for s in ("prefill_32k",
                                                   "decode_32k")]}
CASES = [(a, s, m) for m, cases in MESH_CASES.items() for a, s in cases]

_WORKER = r"""
import dataclasses, json, sys
import torch
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs import reduced_config
from repro_torch.distributed import sharding as shd
from repro_torch.launch import dryrun, specs
from repro_torch.launch.specs import build_case

meshes = json.loads(sys.argv[1])
# the plumbing under test, not the depth or the length of the walks: one
# period of layers (``probe_cfg``), one scan chunk a sequence and short
# training rows (the scan's backward walks 64-token tiles; tracing cost,
# not what is checked).  A VLM row holds at least 512 image positions
# before its text.
TRAIN_SEQ = {"vlm": 1024}
dryrun.start_fake_world(8)
out = {}
try:
    for mname, (shape, names, cases) in meshes.items():
        mesh = init_device_mesh("cpu", tuple(shape),
                                mesh_dim_names=tuple(names))
        sizes = shd.axis_sizes(mesh)
        for arch, sname in cases:
            cfg = specs.probe_cfg(dataclasses.replace(
                reduced_config(arch), ssm_chunk=4096), 1)
            specs.SHAPES["train_4k"] = dict(
                specs.SHAPES["train_4k"], seq=TRAIN_SEQ.get(cfg.family, 128))
            case = build_case(arch, sname, mesh, cfg=cfg,
                              prefill_chunks=2)
            expect = 0
            def shard_bytes(spec, t):
                n = t.element_size()
                for i, d in enumerate(t.shape):
                    e = spec[i] if i < len(spec) else None
                    div = 1
                    for a in (e if isinstance(e, tuple) else
                              (() if e is None else (e,))):
                        div *= sizes[a]
                    assert d % div == 0, (arch, sname, t.shape, spec)
                    n *= d // div
                return n
            def local(_, spec, t):
                global expect
                expect += shard_bytes(spec, t)
            for spec, a in zip(case.in_specs, case.args):
                shd.map_with_path(local, spec, a)
            rec = dryrun.trace_case(case, mesh,
                                    use_hints=dryrun.use_hints_for(case),
                                    sites=sname == "decode_32k")
            rec["expect_arg_bytes"] = expect
            # a rank's bytes of the KV caches split along their slot
            # axis ([L, B, S, H, D] leaves, S on the model axis), and of
            # the sliding-window ring caches among them
            rec["slot_split_cache_bytes"] = rec["ring_split_cache_bytes"] = 0
            if case.kind != "train":
                cspec, cache = case.in_specs[1], case.args[1]
                for name in shd.KV_LEAVES:
                    if name in cache and len(cspec[name]) > 2 \
                            and cspec[name][2] == "model":
                        n = shard_bytes(cspec[name], cache[name])
                        rec["slot_split_cache_bytes"] += n
                        if name.endswith("_local"):
                            rec["ring_split_cache_bytes"] += n
            out[f"{arch}|{sname}|{mname}"] = rec
finally:
    dryrun.stop_fake_world()
print("RESULT " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def traces():
    """Every trace, one subprocess a mesh (run side by side)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER,
         json.dumps({name: mesh + (MESH_CASES[name],)})],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name, mesh in MESHES.items()]
    out = {}
    for p in procs:
        try:
            stdout, stderr = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            p.kill()
            stdout, stderr = p.communicate()
        assert p.returncode == 0, stderr[-4000:]
        line = [l for l in stdout.splitlines() if l.startswith("RESULT ")]
        out.update(json.loads(line[-1][len("RESULT "):]))
    return out


@pytest.mark.parametrize("arch,shape,mesh", CASES)
def test_trace_case_counts(traces, arch, shape, mesh):
    rec = traces[f"{arch}|{shape}|{mesh}"]
    # the arguments are exactly the local shards the spec trees give
    assert rec["arg_bytes"] == rec["expect_arg_bytes"] > 0
    assert rec["peak_bytes_per_device"] >= rec["arg_bytes"]
    assert rec["temp_bytes"] == rec["peak_bytes_per_device"] \
        - rec["arg_bytes"]
    assert rec["out_bytes"] > 0
    assert rec["flops_per_device"] > 0
    # every case splits its parameters over the model axis: something
    # is gathered or reduced
    assert rec["collective_bytes_per_device"] > 0
    assert sum(rec["collectives"].values()) > 0
    assert rec["collective_bytes_per_device"] == pytest.approx(
        sum(rec["collective_bytes_by_op"].values()))
    if arch == "qwen2.5-3b" and mesh == "2x4" and shape != "train_4k":
        # its 2 KV heads do not divide the model axis of 4
        assert rec["slot_split_cache_bytes"] > 0
    if shape == "decode_32k" and mesh == "2x4" \
            and rec["slot_split_cache_bytes"]:
        # a cache split along its slot axis is read where it lies: what
        # is gathered is less than the rank's share of it, and, where
        # ring caches split so, than the rank's share of the rings alone
        gathered = rec["collective_bytes_by_op"].get(
            "all_gather_into_tensor", 0)
        assert gathered < rec["slot_split_cache_bytes"], rec
        if rec["ring_split_cache_bytes"]:
            assert gathered < rec["ring_split_cache_bytes"], rec
    if arch == "gemma3-1b":
        assert rec["ring_split_cache_bytes"] > 0


@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_collective_bytes_by_site(traces, arch):
    """``sites``: the collective bytes by the model code's line that
    issued them add up to the total; where the cache is split along its
    slot axis, the combine of the partial softmaxes is among them."""
    rec = traces[f"{arch}|decode_32k|2x4"]
    by_site = rec["collective_bytes_by_site"]
    assert sum(by_site.values()) == pytest.approx(
        rec["collective_bytes_per_device"])
    combine = [k for k in by_site
               if k.startswith("all_reduce attention.py:")
               and k.endswith(" reduce")]
    assert bool(combine) == bool(rec["slot_split_cache_bytes"]), by_site


def test_dryrun_cli_full_size_case():
    """smollm-135m decode_32k at full size on the 16x16 mesh, through
    the CLI, into a temporary runs directory."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    with tempfile.TemporaryDirectory() as d:
        r = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             "smollm-135m", "--shape", "decode_32k", "--runs-dir", d],
            env=env, capture_output=True, text=True, timeout=300)
        assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
        assert "1 ok, 0 failed" in r.stdout
        with open(os.path.join(d, "smollm-135m__decode_32k__16x16.json")) \
                as f:
            rec = json.load(f)
    assert rec["n_devices"] == 256 and rec["cost_method"] == "traced"
    for key in ("arg_bytes", "out_bytes", "temp_bytes",
                "peak_bytes_per_device", "flops_per_device",
                "collective_bytes_per_device", "collectives", "trace_s"):
        assert key in rec, key
    assert rec["torch"] == torch.__version__
    roof = rec["roofline"]
    assert roof["collective_link"] == "dcn"
    # as the reference's record of the case reads: its 3 KV heads leave
    # the cache split along its slots, read where it lies
    assert roof["dominant"] == "memory"
    assert 0 < rec["arg_bytes"] <= rec["peak_bytes_per_device"]


def test_missing_private_hooks_fail_clearly(monkeypatch):
    """The dry-run leans on two private names of DTensor; a torch without
    them fails with a message that names them, not a bare error."""
    from torch.distributed.tensor import placement_types
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    for name in dryrun._SHADOW_METHODS:
        monkeypatch.delattr(ShardingPropagator, name, raising=False)
    with pytest.raises(RuntimeError, match="ShardingPropagator"):
        with dryrun._skip_shadow_ops():
            pass
    monkeypatch.delattr(placement_types, "shard_dim_alltoall")
    with pytest.raises(RuntimeError, match="shard_dim_alltoall"):
        with dryrun._card_alltoall():
            pass


def test_jobs_fan_out_runs_each_case_in_a_process(monkeypatch, capsys):
    """``--jobs``: one CLI process a case, the training cases first, the
    cases that do not apply skipped, a failed case failing the run."""
    calls = []

    def run(cmd, **kw):
        calls.append(cmd[cmd.index("--case") + 1])
        assert kw["env"]["OMP_NUM_THREADS"] == "1"
        rc = 1 if "decode" in calls[-1] else 0
        return subprocess.CompletedProcess(cmd, rc, f"OK   {calls[-1]}\n",
                                           "")

    monkeypatch.setattr(dryrun.subprocess, "run", run)
    with pytest.raises(SystemExit):
        dryrun.main(["--arch", "qwen2.5-3b", "--mesh", "both", "--jobs",
                     "2", "--runs-dir", "unused"])
    assert len(calls) == 6 and all("train_4k" in c for c in calls[:2])
    assert "long_500k" not in " ".join(calls)
    out = capsys.readouterr().out
    assert "4 ok, 2 failed, 1 skipped" in out
