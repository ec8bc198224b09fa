"""The port's launch plumbing (``repro_torch.launch.specs``,
``analysis.roofline``) against the reference's: shape applicability,
probe configs, case construction on stand-in meshes, model FLOPs, the
roofline's H100 terms, and ``CollectiveCounter`` against the byte total
of the reference's HLO parser test (a fake world, in a subprocess)."""
import os
import subprocess
import sys

import pytest

from repro.analysis.roofline import \
    model_flops_per_device as jax_model_flops
from repro.configs import ASSIGNED
from repro.launch.specs import build_case as jax_build_case
from repro_torch.analysis.roofline import (collective_link,
                                           model_flops_per_device,
                                           roofline_report)
from repro_torch.configs import get_config
from repro_torch.core.hw import H100
from repro_torch.distributed.sharding import P
from repro_torch.launch.specs import (SHAPES, applicable, build_case,
                                      probe_cfg, true_periods)
from tests.test_sharding import MULTI, SINGLE
from test_torch_helpers import cap_threads

cap_threads()

ROOT = os.path.join(os.path.dirname(__file__), "..")


def test_applicability_matrix():
    runs = {(a, s) for a in ASSIGNED for s in SHAPES
            if applicable(a, s)[0]}
    # 10 archs x 4 shapes - 7 long_500k skips = 33
    assert len(runs) == 33
    assert ("mamba2-1.3b", "long_500k") in runs
    assert ("zamba2-7b", "long_500k") in runs
    assert ("gemma3-1b", "long_500k") in runs
    assert ("qwen3-14b", "long_500k") not in runs
    assert ("whisper-base", "long_500k") not in runs


@pytest.mark.parametrize("arch", ASSIGNED)
def test_probe_cfg_preserves_pattern(arch):
    cfg = get_config(arch)
    p1, p2 = probe_cfg(cfg, 1), probe_cfg(cfg, 2)
    assert p1.scan_unroll and p2.scan_unroll
    assert p1.segments()[0].pattern == cfg.segments()[0].pattern
    assert p1.segments()[0].n_periods == 1
    assert p2.segments()[0].n_periods == 2
    assert true_periods(cfg) >= 1


def _tup(spec):
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


@pytest.mark.parametrize("arch", ["qwen3-14b", "mamba2-1.3b",
                                  "whisper-base", "llava-next-34b",
                                  "arctic-480b"])
@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_build_case_structure(arch, shape):
    case = build_case(arch, shape, SINGLE)
    ref = jax_build_case(arch, shape, SINGLE)
    assert case.kind == ref.kind == SHAPES[shape]["kind"]
    assert case.note == ref.note
    assert len(case.args) == len(case.in_specs) == len(ref.args)
    if shape == "train_4k":
        params, opt, batch = case.args
        assert set(batch) == set(ref.args[2])
        for k, v in batch.items():
            assert tuple(v.shape) == tuple(ref.args[2][k].shape), k
            assert _tup(case.in_specs[2][k]) == \
                _tup(ref.in_specs[2][k]), k
        assert opt.m["embed"].dtype.is_floating_point
        assert tuple(opt.m["embed"].shape) == tuple(params["embed"].shape)
    else:
        assert tuple(case.args[2].shape) == (128, 1)       # decode tokens
        assert tuple(case.args[3].shape) == (128,)
        assert _tup(case.in_specs[2]) == _tup(ref.in_specs[2])
        assert _tup(case.in_specs[3]) == _tup(ref.in_specs[3])
        # the cache: every port leaf shaped as the reference's leaves
        # of its kind, stacked over the layers that hold it
        for name, leaf in case.args[1].items():
            assert tuple(leaf.shape[1:]) in {
                tuple(x.shape[1:]) for x in _ref_cache_leaves(ref, name)}
    # fake tensors: no storage behind the full-size arguments
    from torch._subclasses.fake_tensor import FakeTensor
    assert isinstance(case.args[0]["embed"], FakeTensor)


def _ref_cache_leaves(ref, name):
    import jax
    key = {"k_local": "k", "v_local": "v"}.get(name, name)
    out = []
    for path, leaf in jax.tree_util.tree_leaves_with_path(ref.args[1]):
        if getattr(path[-1], "key", None) == key:
            out.append(leaf)
    return out


def test_arctic_uses_fsdp():
    case = build_case("arctic-480b", "train_4k", SINGLE)
    assert case.note == "fsdp"
    # the experts' big weights take the data axis on top of the model
    spec = case.in_specs[0]["layers"][0]["moe"]["w_gate"]
    assert "model" in spec and ("data",) in spec
    assert build_case("smollm-135m", "train_4k", SINGLE).note == ""


def test_multipod_batch_axes():
    case = build_case("qwen3-14b", "train_4k", MULTI)
    assert case.in_specs[2]["tokens"] == P(("pod", "data"), None)
    # long_500k batch=1 must not shard batch
    case = build_case("gemma3-1b", "long_500k", MULTI)
    assert case.in_specs[2] == P(None, None)


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("arch", ASSIGNED)
def test_model_flops_match_reference(arch, shape):
    for n in (256, 512):
        assert model_flops_per_device(arch, shape, n) == \
            jax_model_flops(arch, shape, n)


def test_roofline_report_h100_terms_and_link():
    rec = {"arch": "qwen3-14b", "shape": "decode_32k", "n_devices": 256,
           "flops_per_device": 989e9, "peak_bytes_per_device": 3.35e9,
           "collective_bytes_per_device": 4e8}
    r = roofline_report(rec)
    assert r["compute_s"] == pytest.approx(1e-3)
    assert r["memory_s"] == pytest.approx(1e-3)
    assert r["collective_link"] == "dcn"
    assert r["collective_s"] == pytest.approx(4e8 / H100.dcn_bw)
    assert r["dominant"] == "collective" and r["fits_hbm"]
    one_host = roofline_report(dict(rec, n_devices=8))
    assert one_host["collective_link"] == "nvlink"
    assert one_host["collective_s"] == pytest.approx(4e8 / 450e9)
    assert one_host["dominant"] in ("compute", "memory")
    assert collective_link(9) == ("dcn", H100.dcn_bw)
    big = roofline_report(dict(rec, peak_bytes_per_device=81e9))
    assert not big["fits_hbm"] and big["dominant"] == "memory"


_COUNTER_SCRIPT = r"""
import torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed import _functional_collectives as funcol
from torch._subclasses.fake_tensor import FakeTensorMode
from repro_torch.analysis.roofline import CollectiveCounter
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=16)
try:
    mesh = init_device_mesh("cpu", (8, 2), mesh_dim_names=("a", "b"))
    with FakeTensorMode():
        e = lambda *s, dt=torch.bfloat16: torch.empty(s, dtype=dt)
        with CollectiveCounter() as c:
            outs = [
                funcol.all_gather_tensor(e(32, 4096), 0, (mesh, 0)),
                funcol.all_reduce(e(128, dt=torch.float32), "sum", (mesh, 0)),
                funcol.reduce_scatter_tensor(e(128, 1024), "sum", 0,
                                             (mesh, 0)),
                funcol.all_to_all_single(e(8, 64, dt=torch.float32), None,
                                         None, (mesh, 0)),
                funcol.permute_tensor(e(4, dt=torch.int32), [1, 0],
                                      (mesh, 1)),
                funcol.all_gather_tensor(e(1, 2), 0, (mesh, 1)),
            ]
            outs = [funcol.wait_tensor(o) for o in outs]
    assert [tuple(o.shape) for o in outs] == [
        (256, 4096), (128,), (16, 1024), (8, 64), (4,), (2, 2)], outs
    print(c.total_bytes, dict(c.counts))
finally:
    dist.destroy_process_group()
"""


def test_collective_counter_counts_output_bytes_once():
    """The shapes of the reference's ``test_collective_parser_counts_ops``
    through torch's collectives: the output bytes of each, none again at
    its ``wait_tensor``, the same total."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-c", _COUNTER_SCRIPT], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    total, counts = r.stdout.strip().splitlines()[-1].split(" ", 1)
    expect = (256 * 4096 * 2 + 128 * 4 + 16 * 1024 * 2 + 8 * 64 * 4
              + 4 * 4 + 2 * 2 * 2)
    assert int(total) == expect
    counts = eval(counts)
    assert counts["all_gather_into_tensor"] == 2
    assert counts["all_reduce"] == 1
    assert counts["reduce_scatter_tensor"] == 1
    assert counts["all_to_all_single"] == 2     # the permute is one too
    assert "wait_tensor" not in counts


_EAGER_COUNTER_SCRIPT = r"""
import torch, torch.distributed as dist
from torch.distributed import _functional_collectives as funcol
from repro_torch.analysis.roofline import CollectiveCounter
dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                        world_size=1)
try:
    with CollectiveCounter() as c:
        out = funcol.all_reduce(torch.ones(128), "sum", dist.group.WORLD)
        out = out + 0
    print(c.total_bytes, dict(c.counts))
finally:
    dist.destroy_process_group()
"""


def test_collective_counter_skips_the_eager_result_wrapper():
    """Eager ``funcol`` wraps a collective's result in a
    ``_c10d_functional._wrap_tensor_autograd`` op (not under fake
    tensors, where it waits instead): the counter counts the collective
    alone."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-c", _EAGER_COUNTER_SCRIPT],
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    total, counts = r.stdout.strip().splitlines()[-1].split(" ", 1)
    assert int(total) == 128 * 4
    assert eval(counts) == {"all_reduce": 1}
