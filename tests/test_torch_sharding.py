"""The port's sharding rules (``repro_torch.distributed.sharding``)
against the reference's, leaf for leaf, for every assigned architecture on
both production mesh geometries; the port's own divisibility and "every
big weight is sharded" checks; ``to_placements`` on a fake mesh.

The port holds one dict a layer where the reference stacks a pattern
position's layers over its scan periods: a port layer is paired with its
reference leaf through the segment / period / position order that
``repro_torch.convert`` uses, and the reference spec's leading (periods)
entry is dropped."""
import functools
import os
import subprocess
import sys

import pytest

from repro.configs import ASSIGNED
from repro.configs import get_config as jax_config
from repro.distributed import sharding as jshd
from repro.launch.specs import probe_cfg as jax_probe_cfg
from repro_torch.configs import get_config
from repro_torch.distributed import sharding as shd
from repro_torch.models import transformer as tf
from tests.test_sharding import MULTI, SINGLE
from test_torch_helpers import cap_threads

cap_threads()

MESHES = [SINGLE, MULTI]
MESH_IDS = ["16x16", "2x16x16"]
ROOT = os.path.join(os.path.dirname(__file__), "..")


def _tuple(spec):
    """A spec as a plain tuple; a one-axis tuple entry as its axis name
    (JAX's ``PartitionSpec`` stores ``("data",)`` so)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


@functools.lru_cache(maxsize=None)
def _ref_param_specs(arch):
    return jshd.param_specs(jax_config(arch), 16)


@functools.lru_cache(maxsize=None)
def _ref_opt_specs(arch, zero1, multi):
    mesh = MULTI if multi else SINGLE
    return jshd.opt_state_specs(jax_config(arch), zero1=zero1, mesh=mesh)


@functools.lru_cache(maxsize=None)
def _ref_opt_specs_one_period(arch, multi):
    mesh = MULTI if multi else SINGLE
    return jshd.opt_state_specs(jax_probe_cfg(jax_config(arch), 1),
                                zero1=True, mesh=mesh)


def _layer_sites(cfg):
    """(segment, position) of every port layer, in execution order."""
    return [(si, pi) for si, seg in enumerate(cfg.segments())
            for _ in range(seg.n_periods) for pi in range(len(seg.pattern))]


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _leaves(tree):
    """[(path, leaf)] of a port spec tree, in the tree's order."""
    out = []
    shd.map_with_path(lambda p, x: out.append((p, x)), tree)
    return out


def _paired(port_tree, ref_tree, cfg):
    """[(path, port spec, reference spec less its periods entry, periods
    entry)] over every port leaf."""
    sites = _layer_sites(cfg)
    out = []
    for path, spec in _leaves(port_tree):
        if path[0] == "layers":
            si, pi = sites[path[1]]
            ref = _tuple(_get(ref_tree["segments"][si][pi], path[2:]))
            lead, ref = (ref[0], ref[1:]) if ref else (None, ())
        else:
            ref, lead = _tuple(_get(ref_tree, path)), None
        out.append((path, _tuple(spec), ref, lead))
    return out


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ASSIGNED)
def test_param_specs_match_reference(arch, mesh):
    model = shd.axis_sizes(mesh)["model"]
    cfg = get_config(arch)
    pairs = _paired(shd.param_specs(cfg, model), _ref_param_specs(arch),
                    cfg)
    assert pairs
    for path, mine, ref, lead in pairs:
        assert lead is None, (arch, path)
        assert mine == ref, (arch, path, mine, ref)


@pytest.mark.parametrize("zero1", [False, True], ids=["tp", "zero1"])
@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ASSIGNED)
def test_opt_state_specs_match_reference(arch, mesh, zero1):
    """With ZeRO-1 the reference puts the data axes on a stacked leaf's
    periods axis wherever it has more than one period; the port has no
    such axis, and matches the reference's own specs for a one-period
    stack (``probe_cfg(cfg, 1)``) there."""
    multi = mesh is MULTI
    cfg = get_config(arch)
    mine = shd.opt_state_specs(cfg, zero1=zero1, mesh=mesh)
    ref = _ref_opt_specs(arch, zero1, multi)
    assert _tuple(mine.step) == _tuple(ref.step) == ()
    one = _ref_opt_specs_one_period(arch, multi) if zero1 else None
    dp = _tuple((shd.data_axes(mesh),))[0]
    for part in ("m", "v"):
        for path, got, want, lead in _paired(getattr(mine, part),
                                             getattr(ref, part), cfg):
            if lead is not None:
                assert zero1 and lead == dp, (arch, path, lead)
                si, pi = _layer_sites(cfg)[path[1]]
                want = _tuple(_get(getattr(one, part)["segments"][si][pi],
                                   path[2:]))[1:]
            assert got == want, (arch, part, path, got, want)


@pytest.mark.parametrize("batch", [1, 128])
@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ASSIGNED)
def test_batch_specs_match_reference(arch, mesh, batch):
    mine = shd.batch_specs(get_config(arch), mesh, batch)
    ref = jshd.batch_specs(jax_config(arch), mesh, batch)
    assert {k: _tuple(v) for k, v in mine.items()} == \
        {k: _tuple(v) for k, v in ref.items()}


@functools.lru_cache(maxsize=None)
def _ref_cache_leaf_specs(arch, multi, batch, seq, kv_mode):
    """Reference cache spec of each leaf name (every stacked leaf of one
    name gets one spec)."""
    mesh = MULTI if multi else SINGLE
    cfg = jax_config(arch)
    specs = jshd.cache_specs(cfg, mesh, batch, seq, cross_len=1500,
                             kv_mode=kv_mode)
    out = {}
    for seg, seg_specs in zip(cfg.segments(), specs["segments"]):
        for btype, pos in zip(seg.pattern, seg_specs):
            for name, spec in (pos or {}).items():
                key = ("k_local" if name == "k" else "v_local") \
                    if btype == "attn_local" and name in ("k", "v") else name
                assert out.setdefault(key, _tuple(spec)) == _tuple(spec)
    return out


@pytest.mark.parametrize("kv_mode", ["auto", "batch", "seq"])
@pytest.mark.parametrize("batch,seq", [(128, 32768), (1, 524288)],
                         ids=["decode_32k", "long_500k"])
@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ASSIGNED)
def test_cache_specs_match_reference(arch, mesh, batch, seq, kv_mode):
    mine = shd.cache_specs(get_config(arch), mesh, batch, seq,
                           cross_len=1500, kv_mode=kv_mode)
    ref = _ref_cache_leaf_specs(arch, mesh is MULTI, batch, seq, kv_mode)
    assert {k: _tuple(v) for k, v in mine.items()} == ref


def _check_divisible(spec_tree, shape_tree, mesh, what):
    sizes = shd.axis_sizes(mesh)

    def check(path, spec, leaf):
        for i, e in enumerate(spec):
            if e is None:
                continue
            total = 1
            for a in (e if isinstance(e, tuple) else (e,)):
                total *= sizes[a]
            assert leaf.shape[i] % total == 0, (what, path, leaf.shape, i, e)

    shd.map_with_path(check, spec_tree, shape_tree)


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ASSIGNED)
def test_param_and_cache_specs_divisible(arch, mesh):
    cfg = get_config(arch)
    model = shd.axis_sizes(mesh)["model"]
    _check_divisible(shd.param_specs(cfg, model), tf.abstract_params(cfg),
                     mesh, f"{arch} params")
    for batch, seq in ((128, 32768), (1, 524288)):
        _check_divisible(
            shd.cache_specs(cfg, mesh, batch, seq, cross_len=1500),
            tf.abstract_cache(cfg, batch, seq, cross_len=1500), mesh,
            f"{arch} cache")


@pytest.mark.parametrize("arch", ASSIGNED)
def test_every_big_weight_is_sharded(arch):
    """No >= 64 MiB tensor of the port's tree (a single layer's leaf)
    ends up fully replicated."""
    cfg = get_config(arch)

    def check(path, spec, leaf):
        if leaf.numel() * 2 >= 64 * 1024 ** 2:
            assert any(e is not None for e in spec), (arch, path, leaf.shape)

    shd.map_with_path(check, shd.param_specs(cfg, 16),
                      tf.abstract_params(cfg))


class _Names:
    def __init__(self, names):
        self.mesh_dim_names = names


def test_to_placements_tuple_axis_and_order():
    from torch.distributed.tensor import Replicate, Shard
    mesh = _Names(("pod", "data", "model"))
    assert shd.to_placements(shd.P(("pod", "data"), None, "model"), mesh) \
        == (Shard(0), Shard(0), Shard(2))
    assert shd.to_placements(shd.P(), mesh) == (Replicate(),) * 3
    assert shd.to_placements(shd.P(None, "data"), mesh) == \
        (Replicate(), Shard(1), Replicate())
    with pytest.raises(ValueError):
        shd.to_placements(shd.P(("data", "pod")), mesh)
    with pytest.raises(ValueError):
        shd.to_placements(shd.P("model", "model"), mesh)


_FAKE_MESH_SCRIPT = r"""
import torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch.distributed.device_mesh import init_device_mesh
from torch._subclasses.fake_tensor import FakeTensorMode
from repro_torch.distributed import sharding as shd
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=16)
try:
    mesh = init_device_mesh("cpu", (2, 2, 4),
                            mesh_dim_names=("pod", "data", "model"))
    with FakeTensorMode():
        t = {"w": torch.empty(8, 12, 16), "b": [torch.empty(6)]}
        specs = {"w": shd.P(("pod", "data"), None, "model"), "b": [shd.P()]}
        d = shd.shard(mesh, specs, t)
    w, b = d["w"], d["b"][0]
    assert tuple(w.shape) == (8, 12, 16), w.shape
    assert tuple(w.to_local().shape) == (2, 12, 4), w.to_local().shape
    assert [str(p) for p in w.placements] == ["S(0)", "S(0)", "S(2)"], \
        w.placements
    assert tuple(b.to_local().shape) == (6,)
    print("OK")
finally:
    dist.destroy_process_group()
"""


def test_shard_on_fake_2x2x4_mesh():
    """A tuple axis splits one tensor axis over pod and data, pod major;
    run in a subprocess (a process group stays out of the test
    process)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-c", _FAKE_MESH_SCRIPT], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and "OK" in r.stdout, r.stderr[-3000:]
