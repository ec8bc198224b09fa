"""``--engine live`` of the port on the CPU (``--reduced --device cpu``):
the launcher's streamed runs on smollm-135m (paged, K-step horizons),
zamba2-7b, granite-moe-3b-a800m and gemma3-1b (dense, K = 1), greedy
streams that do not depend on the
horizon or on the non-blocking pipeline, and a drain-and-flip mid-run
that leaves every stream as an undisturbed run gives it."""
import json

import pytest

from repro_torch.core.instance import D_HEAVY, P_HEAVY
from repro_torch.core.latency import SLO
from repro_torch.engine.request import State
from repro_torch.launch import serve
from test_torch_helpers import cap_threads

cap_threads()

SLO_LOOSE = SLO(ttft=5.0, tpot=0.5)        # these tests are about tokens
CPU = ["--engine", "live", "--reduced", "--device", "cpu", "--qps", "4"]


def _summary(out: str):
    """The last JSON object the launcher printed (its summary, indented:
    it opens on a line of its own)."""
    lines = out.splitlines()
    at = max(i for i, line in enumerate(lines) if line == "{")
    return json.loads("\n".join(lines[at:]))


@pytest.mark.parametrize("arch", ["smollm-135m", "zamba2-7b",
                                  "granite-moe-3b-a800m", "gemma3-1b"])
def test_live_cli_streams_every_token(arch, capsys):
    serve.main(CPU + ["--arch", arch, "--n", "8"])
    st = _summary(capsys.readouterr().out)
    assert st["device"] == "cpu" and st["n"] == 8
    assert st["streamed_tokens"] == st["real_tokens"] > 0
    assert st["host_readbacks"] > 0
    if arch == "smollm-135m":
        assert st["horizon_calls"] > 0 and st["horizon_tokens"] > 0
    else:                    # not packable: no horizon, as the reference
        assert st["horizon_calls"] == st["horizon_tokens"] == 0


def test_live_cli_without_a_card_exits():
    with pytest.raises(SystemExit, match="no CUDA device"):
        serve.main(["--engine", "live", "--reduced", "--arch",
                    "smollm-135m", "--n", "2"])


def _streams(arch, *flags, n=8, flip=False):
    """Run the launcher's loop; return (prompts, outputs, loop).
    ``flip`` turns the D-heavy instance to P-heavy once it decodes (the
    loop's ``flipped`` attribute then names it)."""
    args = serve.parse_args(CPU + ["--arch", arch, "--n", str(n), *flags])
    streamed = {}
    _, loop, _, _ = serve.live_loop(
        args, SLO_LOOSE,
        on_token=lambda r, t, tok: streamed.setdefault(r.rid, []).append(tok))
    if flip:
        d_inst = next(i for i in loop.cluster.instances
                      if i.itype == D_HEAVY)
        guard = 0
        while not d_inst.decoding and guard < 4000:
            assert loop.run(max_steps=5) > 0 or loop._arrivals is not None
            guard += 1
        assert d_inst.decoding, "need in-flight decodes before the flip"
        assert loop.flip_role(d_inst, P_HEAVY, 64)
        loop.flipped = d_inst
    loop.run()
    assert all(r.state == State.FINISHED for r in loop.requests)
    for r in loop.requests:
        assert streamed[r.rid] == r.output_tokens
    return ([r.prompt_tokens for r in loop.requests],
            [r.output_tokens for r in loop.requests], loop)


@pytest.mark.parametrize("arch", ["smollm-135m", "zamba2-7b",
                                  "granite-moe-3b-a800m", "gemma3-1b"])
def test_live_streams_do_not_depend_on_horizon_or_pipeline(arch):
    prompts, base, _ = _streams(arch, "--horizon", "1", "--no-async")
    for flags in (("--horizon", "8"), ("--horizon", "8", "--no-async"),
                  ("--horizon", "1")):
        p, out, loop = _streams(arch, *flags)
        assert p == prompts
        assert out == base, flags
        calls = sum(i.executor.horizon_calls for i in loop.cluster.instances)
        assert (calls > 0) == (flags[1] == "8" and arch == "smollm-135m")


def test_async_horizon_loop_survives_a_role_flip():
    """ServingLoop + non-blocking cluster + K = 8 horizons: a drain-and-
    flip mid-run migrates the D-heavy instance's decodes and every stream
    stays what the synchronous K = 1 run gives."""
    prompts, base, _ = _streams("smollm-135m", "--horizon", "1",
                                "--no-async")
    p, out, loop = _streams("smollm-135m", "--horizon", "8", flip=True)
    cluster = loop.cluster
    assert cluster.role_flip_count == 1
    assert loop.flipped.itype == P_HEAVY
    assert p == prompts and out == base
    assert sum(i.executor.horizon_calls for i in cluster.instances) > 0
