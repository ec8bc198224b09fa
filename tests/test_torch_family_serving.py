"""The encoder-decoder (whisper-base) and VLM (llava-next-34b) families
served through ``TorchExecutor`` against the reference's ``JaxExecutor``,
greedy and token-exact, on reduced float32 configs and the same
numpy-made weights, on the CPU.

The engine's requests carry text only.  whisper takes the dense path
(``packable`` is false): its cache holds a cross KV of 0 keys, so every
decoder layer's cross-attention gives 0 and the encoder never runs, as in
the reference.  llava is an all-ATTN stack and takes the paged path, its
projector unused.  Each is held on the batched path with prefill and
decode mixed under K-step horizons (llava fuses them; whisper, like the
reference, stays at K = 1), through a migration round trip between two
executors of its kind, and in a two-instance ``Cluster`` under
``TaiChiPolicy``; and the launcher serves both on the CPU.
"""
import numpy as np
import pytest

from repro.configs import reduced_config as jax_reduced
from repro_torch.configs import reduced_config
from repro_torch.launch import serve

from test_torch_cluster import _serve
from test_torch_engine import Side
from test_torch_helpers import (both_params, cap_threads,  # noqa: F401
                                copying_reference)
from test_torch_serving_live import _summary

cap_threads()

# the reference's host arrays may alias its in-flight inputs on the CPU
pytestmark = pytest.mark.usefixtures("copying_reference")

ARCHS = ["whisper-base", "llava-next-34b"]


@pytest.fixture(scope="module", params=ARCHS)
def sides(request):
    cj, ct = jax_reduced(request.param), reduced_config(request.param)
    pj, pt = both_params(cj, ct, seed=61)
    return Side(False, pj, cj), Side(True, pt, ct)


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(1, 500, size=n))) for n in lengths]


def _generate(side, prompts, n_out, *, chunk=16, max_horizon=1,
              arrive_at=None):
    """Serve ``prompts`` on one instance of ``side``; request i joins at
    iteration ``arrive_at[i]`` (all at once by default), so that later
    prompts prefill beside earlier ones' decodes."""
    ex, inst = side.make(n_slots=len(prompts) + 1, chunk=chunk)
    inst.max_horizon = max_horizon
    reqs = [side.Request(prompt_len=len(p), max_new_tokens=n_out,
                         hidden_output_len=n_out, prompt_tokens=list(p))
            for p in prompts]
    arrive_at = arrive_at or [0] * len(reqs)
    now = 0.0
    for it in range(400):
        for r, at in zip(reqs, arrive_at):
            if at == it:
                inst.enqueue_prefill(r)
        dur, done, _ = inst.run_iteration(now)
        now += dur
        for r in done:
            inst.admit_decode(r)
        if all(r.done() for r in reqs):
            break
    assert all(r.done() for r in reqs)
    return [r.output_tokens for r in reqs], ex, inst


def test_batched_steps_and_horizon(sides):
    """Four prompts arriving at iterations 0, 2, 5 and 9, in 16-token
    chunks, with decode horizons up to K = 8: later chunks run beside
    earlier rows' decodes, and decode-only iterations fuse up to 8 steps
    on llava (on both sides) but stay at one on whisper (not
    ``packable``, hence not ``horizon_capable``, as the reference).  The
    streams equal the reference's and the port's own K = 1 run."""
    jax_side, torch_side = sides
    prompts = _prompts(1, (9, 41, 23, 30))
    kw = dict(max_horizon=8, arrive_at=[0, 2, 5, 9])
    ref, jex, _ = _generate(jax_side, prompts, 20, **kw)
    got, ex, inst = _generate(torch_side, prompts, 20, **kw)
    k1, _, _ = _generate(torch_side, prompts, 20, arrive_at=kw["arrive_at"])
    assert got == ref == k1
    assert all(len(o) == 20 for o in got)
    fused = torch_side.cfg.family == "vlm"
    assert ex.paged == jex.paged == fused
    assert ex.horizon_capable == fused
    assert ex.horizon_calls == jex.horizon_calls
    assert ex.horizon_tokens == jex.horizon_tokens
    assert (ex.horizon_calls > 0) == fused
    assert (max(inst.horizon_hist) == 8) == fused
    if ex.paged:
        ex.kv.check_invariants()
        assert ex.cache is None
    else:
        # the text-only decoder's cross cache holds no keys
        assert tuple(ex.cache["ck"].shape[:3]) == (
            torch_side.cfg.num_layers, ex.n_slots, 0)
        assert ex.cache_bytes() > 0
    assert 0 < ex.host_readbacks <= inst.iterations


def _migrated(side):
    """A request prefilled and decoded three steps on A, ejected, injected
    into B (an executor of the same kind), and finished there."""
    prompt = _prompts(3, (26,))[0]
    exA, iA = side.make(n_slots=3, chunk=16)
    exB, iB = side.make(n_slots=3, chunk=16, iid=1)
    iB.itype = side.P
    req = side.Request(prompt_len=len(prompt), max_new_tokens=9,
                       hidden_output_len=9, prompt_tokens=list(prompt))
    iA.enqueue_prefill(req)
    now = 0.0
    while req.prefill_remaining > 0:
        dur, _, _ = iA.run_iteration(now)
        now += dur
    iA.admit_decode(req)
    for _ in range(3):
        dur, _, _ = iA.run_iteration(now)
        now += dur
    nbytes = exA.migration_bytes(req)
    state = iA.eject(req)
    iB.inject(req, state)
    while not req.done():
        dur, _, _ = iB.run_iteration(now)
        now += dur
    return req.output_tokens, nbytes, state, exB


def test_migration_round_trip(sides):
    jax_side, torch_side = sides
    ref, ref_bytes, _, _ = _migrated(jax_side)
    got, got_bytes, state, exB = _migrated(torch_side)
    assert got == ref and len(got) == 9
    assert got_bytes == ref_bytes > 0
    if torch_side.cfg.family == "vlm":
        assert state["n_blocks"] == -(-state["pos"] // 16)
        exB.kv.check_invariants()
    else:
        # the row ships its 0-key cross cache with its self-attention KV
        assert state["row"]["ck"].shape[1] == 0
        assert set(state["row"]) == {"k", "v", "ck", "cv"}


def test_taichi_cluster_token_exact(sides):
    """quickstart's stack (``test_torch_cluster._serve``: one P-heavy and
    one D-heavy instance, 12 seeded requests): every request's tokens,
    placement and the transfer count equal the reference's."""
    jax_side, torch_side = sides
    ref_c, ref_reqs, _ = _serve(False, jax_side.cfg, jax_side.params)
    got_c, got_reqs, instances = _serve(True, torch_side.cfg,
                                        torch_side.params)
    for a, b in zip(got_reqs, ref_reqs):
        assert a.prompt_tokens == b.prompt_tokens
        assert a.done() and b.done()
        assert a.output_tokens == b.output_tokens
        assert (a.prefill_instance, a.decode_instance) == \
            (b.prefill_instance, b.decode_instance)
    assert got_c.transfer_count == ref_c.transfer_count > 0
    for inst in instances:
        if inst.executor.paged:
            inst.executor.kv.check_invariants()


@pytest.mark.parametrize("engine", ["torch", "live"])
@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_serves_the_family_on_the_cpu(arch, engine, capsys):
    serve.main(["--engine", engine, "--arch", arch, "--reduced", "--device",
                "cpu", "--qps", "4", "--n", "8"])
    st = _summary(capsys.readouterr().out)
    assert st["model"] == reduced_config(arch).name
    assert st["device"] == "cpu" and st["real_tokens"] > 0
    if engine == "live":
        assert st["streamed_tokens"] == st["real_tokens"]
        assert (st["horizon_calls"] > 0) == (arch == "llava-next-34b")
