"""The port's sharded forward (DTensor parameters and caches over a
``DeviceMesh``, ``repro_torch.distributed``) against the unsharded port
and the reference, on the CPU: four gloo processes on meshes (2, 2) and
(1, 4) run a prefill and four decode steps of reduced configs; rank 0
gathers the logits.  The (1, 4) mesh puts qwen2.5-3b-smoke's 2 KV heads
over a model axis of 4: the heads stay whole (gathered) and its cache
splits its slot axis instead (``cache_specs``' ``auto``), which the
sharded write and the read of each rank's slot shard, whose partial
softmaxes are combined by all-reduce, must handle.  The process group
lives in the subprocesses only."""
import os
import socket
import subprocess
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jax_reduced
from repro.models import transformer as jax_tf
from repro_torch.configs import reduced_config
from repro_torch.convert import params_from_jax
from repro_torch.models import transformer as tf

from test_torch_helpers import cap_threads, numpy_params

cap_threads()

ROOT = os.path.join(os.path.dirname(__file__), "..")
ARCHS = ["qwen2.5-3b", "mamba2-1.3b", "gemma3-1b", "granite-moe-3b-a800m"]
MESHES = [(2, 2), (1, 4)]
B, T, S, STEPS = 2, 16, 64, 4
# the tolerance tests/test_torch_models.py holds the unsharded forward
# to against the reference (float32 logits)
ATOL = 2e-3
WORLD = 4
# the paged pool: blocks of BS tokens, each row's table (2 x 4 blocks,
# shuffled over the pool)
BLOCKS, BS = 10, 8
TABLES = np.array([[7, 2, 9, 4], [1, 8, 3, 6]], np.int32)

_WORKER = r"""
import os, sys, numpy as np, torch, torch.distributed as dist
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.configs import reduced_config
from repro_torch.convert import params_from_jax
from repro_torch.distributed import hints, sharding as shd
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import transformer as tf

rank, port, data = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=%(world)d)
try:
    inputs = np.load(data + "/inputs.npz")
    out = {}
    for arch in %(archs)r:
        cfg = reduced_config(arch)
        tree = np.load(data + f"/{arch}.npy", allow_pickle=True).item()
        for shape in %(meshes)r:
            mesh = make_local_mesh(model=shape[1], device="cpu")
            params = shd.shard(mesh, shd.param_specs(cfg, shape[1]),
                               params_from_jax(tree, cfg, device="cpu"))
            cache = shd.shard(mesh, shd.cache_specs(cfg, mesh, %(B)d,
                                                    %(S)d),
                              tf.init_cache(cfg, %(B)d, %(S)d, device="cpu"))
            rows = lambda t: shd.shard(mesh, shd.P(("data",)), t)
            toks = torch.from_numpy(inputs[arch + "_tokens"])
            steps = torch.from_numpy(inputs[arch + "_steps"])
            logits = []
            with torch.no_grad(), implicit_replication(), \
                    hints.hints(("data",), "model", mesh=mesh):
                last, cache = tf.prefill(params, cfg, rows(toks), cache,
                                         rows(torch.zeros(%(B)d,
                                                          dtype=torch.long)))
                logits.append(last.full_tensor())
                for i in range(%(steps)d):
                    last, cache = tf.decode_step(
                        params, cfg, rows(steps[:, i:i + 1]), cache,
                        rows(torch.full((%(B)d,), %(T)d + i)))
                    logits.append(last.full_tensor())
            if arch == "qwen2.5-3b":
                # a paged pool [L, P + 1, Hkv, D], its KV heads split
                # over the model axis where they divide it
                pool = tf.init_paged_cache(cfg, %(blocks)d, %(bs)d,
                                           device="cpu")
                h = "model" if cfg.num_kv_heads %% shape[1] == 0 else None
                pool = shd.shard(mesh, {k: shd.P(None, None, h, None)
                                        for k in pool}, pool)
                tables = (torch.from_numpy(inputs["tables"]), %(bs)d)
                paged = []
                with torch.no_grad(), implicit_replication(), \
                        hints.hints(("data",), "model", mesh=mesh):
                    last, pool = tf.prefill(
                        params, cfg, rows(toks), pool,
                        rows(torch.zeros(%(B)d, dtype=torch.long)),
                        block_tables=tables)
                    paged.append(last.full_tensor())
                    for i in range(%(steps)d):
                        last, pool = tf.decode_step(
                            params, cfg, rows(steps[:, i:i + 1]), pool,
                            rows(torch.full((%(B)d,), %(T)d + i)),
                            block_tables=tables)
                        paged.append(last.full_tensor())
                out[f"paged_{shape[0]}x{shape[1]}"] = torch.stack(
                    paged).numpy()
            # the training loss (the vocabulary-split cross-entropy) and
            # lm_head's gradient through the sharded forward
            head = params["lm_head"].detach().requires_grad_(True)
            params["lm_head"] = head
            batch = {"tokens": rows(toks),
                     "labels": rows(torch.from_numpy(
                         inputs[arch + "_labels"]))}
            with implicit_replication(), \
                    hints.hints(("data",), "model", mesh=mesh):
                loss = tf.train_loss(params, cfg, batch)
                grad = torch.autograd.grad(loss, [head])[0]
            key = f"{arch}_{shape[0]}x{shape[1]}"
            out[key + "_loss"] = loss.full_tensor().detach().numpy()
            out[key + "_grad"] = grad.full_tensor().numpy()
            out[f"{arch}_{shape[0]}x{shape[1]}"] = torch.stack(
                logits).numpy()
            out[f"{arch}_{shape[0]}x{shape[1]}_kind"] = np.array(
                [type(last).__name__, str(cache[sorted(cache)[0]].placements)])
    if rank == 0:
        np.savez(data + "/out.npz", **out)
finally:
    dist.destroy_process_group()
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def run():
    """(inputs by arch, the sharded run's output) — one launch of four
    processes for every arch and mesh, the unsharded runs (``_plain``)
    meanwhile."""
    with tempfile.TemporaryDirectory() as d:
        rng = np.random.default_rng(3)
        inputs, params = {}, {}
        for i, arch in enumerate(ARCHS):
            cj = jax_reduced(arch)
            params[arch] = numpy_params(cj, seed=20 + i)
            np.save(os.path.join(d, f"{arch}.npy"), params[arch],
                    allow_pickle=True)
            inputs[arch + "_tokens"] = rng.integers(
                1, cj.vocab_size, size=(B, T)).astype(np.int64)
            inputs[arch + "_steps"] = rng.integers(
                1, cj.vocab_size, size=(B, STEPS)).astype(np.int64)
            inputs[arch + "_labels"] = rng.integers(
                1, cj.vocab_size, size=(B, T)).astype(np.int64)
        inputs["tables"] = TABLES
        np.savez(os.path.join(d, "inputs.npz"), **inputs)
        code = _WORKER % dict(world=WORLD, archs=ARCHS, meshes=MESHES, B=B,
                              S=S, T=T, steps=STEPS, blocks=BLOCKS, bs=BS)
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                   OMP_NUM_THREADS="1")
        port = str(_free_port())
        procs = [subprocess.Popen([sys.executable, "-c", code, str(r), port,
                                   d], env=env, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for r in range(WORLD)]
        # the unsharded runs while the ranks run
        for arch in ARCHS:
            _plain(arch, params[arch], inputs)
        errs = []
        for p in procs:
            try:
                _, err = p.communicate(timeout=240)
            except subprocess.TimeoutExpired:
                p.kill()
                _, err = p.communicate()
            errs.append((p.returncode, err[-3000:]))
        assert all(rc == 0 for rc, _ in errs), errs
        out = dict(np.load(os.path.join(d, "out.npz")))
    return inputs, params, out


_PLAIN = {}


def _plain(arch, tree, inputs):
    """The unsharded port's and the reference's logits [1 + STEPS, B, V]
    for the same calls (once an arch: both meshes compare with them)."""
    if arch not in _PLAIN:
        _PLAIN[arch] = _plain_run(arch, tree, inputs)
    return _PLAIN[arch]


def _plain_run(arch, tree, inputs):
    cj, ct = jax_reduced(arch), reduced_config(arch)
    pt = params_from_jax(tree, ct, device="cpu")
    pj = jax.tree.map(jnp.asarray, tree)
    toks, steps = inputs[arch + "_tokens"], inputs[arch + "_steps"]
    cache_t = tf.init_cache(ct, B, S, device="cpu")
    cache_j = jax_tf.init_cache(cj, B, S)
    zero = np.zeros(B, np.int32)
    with torch.no_grad():
        lt, cache_t = tf.prefill(pt, ct, torch.from_numpy(toks), cache_t,
                                 torch.from_numpy(zero).long())
        port = [lt.numpy()]
        lj, cache_j = jax_tf.prefill(pj, cj, jnp.asarray(toks, jnp.int32),
                                     cache_j, jnp.asarray(zero))
        ref = [np.asarray(lj)]
        for i in range(STEPS):
            pos = np.full(B, T + i, np.int32)
            lt, cache_t = tf.decode_step(
                pt, ct, torch.from_numpy(steps[:, i:i + 1]), cache_t,
                torch.from_numpy(pos).long())
            port.append(lt.numpy())
            lj, cache_j = jax_tf.decode_step(
                pj, cj, jnp.asarray(steps[:, i:i + 1], jnp.int32), cache_j,
                jnp.asarray(pos))
            ref.append(np.asarray(lj))
    return np.stack(port), np.stack(ref)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_forward_matches_port_and_reference(run, arch, mesh):
    inputs, params, out = run
    got = out[f"{arch}_{mesh[0]}x{mesh[1]}"]
    kind = out[f"{arch}_{mesh[0]}x{mesh[1]}_kind"]
    assert kind[0] == "DTensor"
    port, ref = _plain(arch, params[arch], inputs)
    assert got.shape == port.shape == ref.shape
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, port, atol=ATOL)
    np.testing.assert_allclose(got, ref, atol=ATOL)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_train_loss_and_gradient_match_port(run, arch, mesh):
    """``train_loss`` through the sharded forward (the cross-entropy over
    a split vocabulary on local shards) and lm_head's gradient, against
    the unsharded port: float32 sums in another order, to 1e-5 of the
    loss and of the gradient's largest value."""
    inputs, params, out = run
    key = f"{arch}_{mesh[0]}x{mesh[1]}"
    ct = reduced_config(arch)
    pt = params_from_jax(params[arch], ct, device="cpu")
    head = pt["lm_head"].requires_grad_(True)
    batch = {"tokens": torch.from_numpy(inputs[arch + "_tokens"]),
             "labels": torch.from_numpy(inputs[arch + "_labels"])}
    loss = tf.train_loss(pt, ct, batch)
    grad = torch.autograd.grad(loss, [head])[0].numpy()
    np.testing.assert_allclose(out[key + "_loss"], loss.item(), rtol=1e-5)
    assert np.abs(out[key + "_grad"] - grad).max() <= \
        1e-5 * np.abs(grad).max()


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_sharded_paged_forward_matches_port(run, mesh):
    """qwen2.5-3b-smoke over a paged pool as DTensors (KV heads split
    over the model axis on (2, 2), whole on (1, 4)): the pool write and
    the paged kernels' read on local shards give the unsharded port's
    logits."""
    inputs, params, out = run
    ct = reduced_config("qwen2.5-3b")
    pt = params_from_jax(params["qwen2.5-3b"], ct, device="cpu")
    pool = tf.init_paged_cache(ct, BLOCKS, BS, device="cpu")
    tables = (torch.from_numpy(TABLES), BS)
    toks = torch.from_numpy(inputs["qwen2.5-3b_tokens"])
    steps = torch.from_numpy(inputs["qwen2.5-3b_steps"])
    with torch.no_grad():
        last, pool = tf.prefill(pt, ct, toks, pool,
                                torch.zeros(B, dtype=torch.long),
                                block_tables=tables)
        want = [last.numpy()]
        for i in range(STEPS):
            last, pool = tf.decode_step(pt, ct, steps[:, i:i + 1], pool,
                                        torch.full((B,), T + i),
                                        block_tables=tables)
            want.append(last.numpy())
    np.testing.assert_allclose(out[f"paged_{mesh[0]}x{mesh[1]}"],
                               np.stack(want), atol=ATOL)


def test_qwen_cache_splits_slots_on_the_1x4_mesh(run):
    """2 KV heads over a model axis of 4: ``auto`` splits the slot axis
    (the write and the read on local shards, the read's partials
    combined by all-reduce: no gather of the cache)."""
    _, _, out = run
    assert "Shard(dim=2)" in out["qwen2.5-3b_1x4_kind"][1]
    assert "Shard(dim=3)" in out["qwen2.5-3b_2x2_kind"][1]


def test_no_process_group_in_the_test_process(run):
    import torch.distributed as dist
    assert not dist.is_initialized()
