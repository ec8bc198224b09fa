"""The port's network front end (``repro_torch.frontend``) against the
reference's (``repro.frontend``): the pure layers byte for byte on the
same inputs (request parsing, SSE framing, response bodies and usage,
the response head, the byte tokenizer and its incremental detokenizer),
the token pipeline inline and in spawned worker processes that load no
torch, and the live server over ``TorchExecutor(device="cpu")`` whose
concurrent streams carry exactly the detokenised greedy tokens the
reference's engine gives the same prompts, then drain gracefully.  Every
socket, thread and process is joined under a timeout of its own."""
import dataclasses
import json
import os
import pathlib
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from repro.configs import reduced_config as jax_reduced
from repro.core.latency import SLO as JaxSLO
from repro.core.policies import Sliders as JaxSliders
from repro.engine.engine import JaxExecutor
from repro.engine.request import Request as JaxRequest
from repro.frontend import AdmissionConfig as JaxAdmissionConfig
from repro.frontend import ByteTokenizer as JaxByteTokenizer
from repro.frontend import IncrementalDetokenizer as JaxDetokenizer
from repro.frontend import TokenPipeline as JaxTokenPipeline
from repro.frontend import http as jax_http
from repro.frontend import protocol as jax_protocol
from repro.serving import ServingLoop as JaxServingLoop
from repro.sim.simulator import ServingConfig as JaxServingConfig
from repro.sim.simulator import build_cluster as jax_build_cluster
from repro_torch.configs import reduced_config
from repro_torch.core.latency import SLO
from repro_torch.core.policies import Sliders
from repro_torch.engine.engine import TorchExecutor
from repro_torch.engine.request import State
from repro_torch.frontend import (AdmissionConfig, ByteTokenizer,
                                  FrontendConfig, FrontendServer,
                                  IncrementalDetokenizer, TokenPipeline)
from repro_torch.frontend import http, protocol
from repro_torch.launch import serve
from repro_torch.serving import ServingLoop
from repro_torch.sim.simulator import ServingConfig, build_cluster

from test_torch_helpers import (both_params, cap_threads,  # noqa: F401
                                copying_reference)

cap_threads()

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")
JOIN_S = 120            # every join and socket below waits at most this


# ---------------------------------------------------------------------------
# pure layers, byte for byte
# ---------------------------------------------------------------------------

PARSE_CASES = [
    ("/v1/completions", {"model": "m", "prompt": "hi", "max_tokens": 7,
                         "stream": True}, None),
    ("/v1/completions", {"prompt": ["one"]}, None),
    ("/v1/completions", {"prompt": "x", "priority": "interactive"},
     {"x-priority": "batch"}),
    ("/v1/completions", {"prompt": "x"}, {"x-priority": "batch"}),
    ("/v1/completions", {"prompt": "héllo 日本", "echo": True}, None),
    ("/v1/chat/completions", {"messages": [
        {"role": "system", "content": "be brief"},
        {"role": "user", "content": "hi"}], "max_tokens": 3}, None),
    ("/v1/completions", b"{not json", None),
    ("/v1/completions", b"[1,2]", None),
    ("/v1/completions", {"prompt": "x", "n": 2}, None),
    ("/v1/completions", {"prompt": "x", "max_tokens": 0}, None),
    ("/v1/completions", {"prompt": ""}, None),
    ("/v1/completions", {"prompt": ["a", "b"]}, None),
    ("/v1/chat/completions", {"messages": []}, None),
    ("/v1/chat/completions", {"messages": [{"role": "user"}]}, None),
    ("/v1/embeddings", {}, None),
]


def _parse(mod, path, body, headers):
    raw = body if isinstance(body, bytes) else json.dumps(body).encode()
    try:
        return ("ok", dataclasses.asdict(
            mod.parse_request(path, raw, headers)))
    except mod.ProtocolError as e:
        return ("error", e.status, e.err_type, str(e), e.body())


@pytest.mark.parametrize("path,body,headers", PARSE_CASES,
                         ids=[f"parse{i}" for i in range(len(PARSE_CASES))])
def test_parse_request_equals_reference(path, body, headers):
    assert _parse(protocol, path, body, headers) == \
        _parse(jax_protocol, path, body, headers)


FORMAT_CASES = [
    ("sse_event", ({"a": 1, "b": [1, "é"]},)),
    ("stream_chunk", ("completion", "cmpl-1", "m", 123, "ab")),
    ("stream_chunk", ("completion", "cmpl-1", "m", 123, "", "length")),
    ("stream_chunk", ("chat", "c-1", "m", 123, "日本")),
    ("stream_chunk", ("chat", "c-1", "m", 123, "", "stop")),
    ("final_response", ("chat", "c-1", "m", 1, "out", "length", 11, 5)),
    ("final_response", ("completion", "cmpl-2", "m", 9, "⟨300⟩x", "stop",
                        3, 0)),
]


@pytest.mark.parametrize("fn,args", FORMAT_CASES,
                         ids=[f"{f}{i}" for i, (f, _) in
                              enumerate(FORMAT_CASES)])
def test_formatting_equals_reference(fn, args):
    got = getattr(protocol, fn)(*args)
    assert isinstance(got, bytes)
    assert got == getattr(jax_protocol, fn)(*args)
    if fn == "final_response":          # usage maths
        usage = json.loads(got)["usage"]
        assert usage["total_tokens"] == args[-2] + args[-1]


def test_constants_and_response_head_equal_reference():
    for name in ("COMPLETIONS", "CHAT_COMPLETIONS", "SSE_DONE",
                 "DEFAULT_PRIORITY"):
        assert getattr(protocol, name) == getattr(jax_protocol, name)
    assert http.REASONS == jax_http.REASONS
    for args in ((200, "application/json", "", 12),
                 (503, "application/json", "Retry-After: 2\r\n", 0),
                 (200, "text/event-stream",
                  "Transfer-Encoding: chunked\r\n", None)):
        assert http._head(*args) == jax_http._head(*args)


TEXTS = ["hello", "héllo wörld", "日本語テスト", "mixed: é日x", "a⚡é日"]


@pytest.mark.parametrize("text", TEXTS)
def test_tokenizer_round_trip_equals_reference(text):
    ids = ByteTokenizer.encode(text)
    assert ids == JaxByteTokenizer.encode(text)
    assert all(0 <= i < 256 for i in ids)
    assert ByteTokenizer.decode(ids) == text


@pytest.mark.parametrize("ids", [
    ByteTokenizer.encode("a⚡é日"),                  # split UTF-8
    ByteTokenizer.encode("é")[:1] + [300] + ByteTokenizer.encode("z"),
    [300, 151935, 65, 0xE6, 0x97],                   # markers, dangling
], ids=["split-utf8", "marker-mid-sequence", "dangling-tail"])
def test_incremental_detok_equals_reference(ids):
    got, ref = IncrementalDetokenizer(), JaxDetokenizer()
    pieces = [got.feed(i) for i in ids] + [got.flush()]
    assert pieces == [ref.feed(i) for i in ids] + [ref.flush()]
    assert "".join(pieces) == JaxByteTokenizer.decode(ids)


# ---------------------------------------------------------------------------
# token pipeline
# ---------------------------------------------------------------------------

def _pipeline_frames(Pipeline, n_workers, stream, kind="completion"):
    frames, done = [], threading.Event()

    def sink(rid, payload, is_done, t_event, pid):
        frames.append((payload, is_done, pid))
        if is_done:
            done.set()

    with Pipeline(n_workers=n_workers) as pipe:
        ids = pipe.tokenize("hé!").result(timeout=JOIN_S)
        pipe.open_stream(7, kind, "cmpl-7", "m", 1, stream, sink)
        for i in ids + [300]:
            pipe.push_tokens(7, [i], 0.0)
        pipe.finish(7, "length", len(ids), 0.0)
        assert done.wait(timeout=JOIN_S)
        procs = list(pipe._procs)
    return ids, frames, procs


@pytest.mark.parametrize("stream", [True, False], ids=["stream", "whole"])
@pytest.mark.parametrize("kind", ["completion", "chat"])
def test_pipeline_inline_equals_reference(stream, kind):
    got = _pipeline_frames(TokenPipeline, 0, stream, kind)
    ref = _pipeline_frames(JaxTokenPipeline, 0, stream, kind)
    assert got[0] == ref[0] == ByteTokenizer.encode("hé!")
    assert [f[:2] for f in got[1]] == [f[:2] for f in ref[1]]
    assert all(pid == os.getpid() for _, _, pid in got[1])
    assert got[1][-1][1] and not any(d for _, d, _ in got[1][:-1])


def _maps_torch(pid: int) -> bool:
    """True when process ``pid`` has torch's library mapped (it imported
    torch)."""
    return "libtorch" in pathlib.Path(f"/proc/{pid}/maps").read_text()


@pytest.mark.skipif(not sys.platform.startswith("linux"),
                    reason="reads /proc/<pid>/maps")
def test_pipeline_workers_run_the_string_work_without_torch():
    assert _maps_torch(os.getpid())     # the check sees torch where it is
    seen = []
    with TokenPipeline(n_workers=2) as pipe:
        ids = pipe.tokenize("worker").result(timeout=JOIN_S)
        got = threading.Event()

        def sink(rid, payload, done, t_event, pid):
            seen.append((payload, pid))
            if done:
                got.set()

        pipe.open_stream(3, "completion", "cmpl-3", "m", 1, True, sink)
        pipe.push_tokens(3, ids, time.monotonic())
        pipe.finish(3, "length", len(ids), time.monotonic())
        assert got.wait(timeout=JOIN_S)
        pids = [p.pid for p in pipe._procs]
        assert all(not _maps_torch(pid) for pid in pids)
    assert seen and all(pid in pids for _, pid in seen)
    assert os.getpid() not in pids
    assert ids == ByteTokenizer.encode("worker")


WORKER_PROBE = """
import json, os, sys, torch
from repro_torch.frontend import TokenPipeline
with TokenPipeline(n_workers=1) as pipe:
    ids = pipe.tokenize("probe").result(timeout={t})
    pid = pipe._procs[0].pid
    maps = open(f"/proc/{{pid}}/maps").read()
    mine = open("/proc/self/maps").read()
print(json.dumps({{"ids": ids, "worker_torch": "libtorch" in maps,
                  "main_torch": "libtorch" in mine, "pid": pid,
                  "main": os.getpid()}}))
"""


@pytest.mark.skipif(not sys.platform.startswith("linux"),
                    reason="reads /proc/<pid>/maps")
def test_workers_skip_a_main_script_that_imports_torch(tmp_path):
    """A spawned child re-runs its parent's main script before its target
    (``chip_smoke.py`` imports torch at the top): the pipeline starts its
    workers without it.  (That the worker's import chain alone loads no
    torch is ``test_torch_imports.py::test_module_loads_no_torch``.)"""
    script = tmp_path / "probe.py"
    script.write_text(WORKER_PROBE.format(t=JOIN_S))
    out = subprocess.run([sys.executable, str(script)], capture_output=True,
                         text=True, env={**os.environ, "PYTHONPATH": SRC},
                         timeout=JOIN_S)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.splitlines()[-1])
    assert got["ids"] == ByteTokenizer.encode("probe")
    assert got["main_torch"] and not got["worker_torch"]
    assert got["pid"] != got["main"]


# ---------------------------------------------------------------------------
# the live server over the torch engine on the CPU
# ---------------------------------------------------------------------------

N_CLIENTS = 6
MAX_TOKENS = 8
LOOSE = dict(ttft=5.0, tpot=0.5)       # these tests are about tokens


@pytest.fixture(scope="module")
def weights():
    cj, ct = jax_reduced("smollm-135m"), reduced_config("smollm-135m")
    pj, pt = both_params(cj, ct, seed=41)
    return (cj, pj), (ct, pt)


def _torch_loop(cfg, params, max_inflight):
    slo = SLO(**LOOSE)
    sc = ServingConfig(model="smollm-135m", tp=1, policy="taichi",
                       sliders=Sliders(n_p=1, n_d=1, s_p=64, s_d=32),
                       hbm_blocks=512)
    factory = lambda: TorchExecutor(cfg, params, n_slots=8, max_seq=512,
                                    device="cpu")
    cluster = build_cluster(sc, slo, executor_factory=factory)
    return ServingLoop(cluster, slo, admission=AdmissionConfig(
        max_depth=64, max_inflight=max_inflight))


def _reference_tokens(cfg, params, prompts, max_inflight):
    """Greedy tokens of the reference's engine for ``prompts``, through
    its serving loop (a direct submission, no HTTP)."""
    slo = JaxSLO(**LOOSE)
    sc = JaxServingConfig(model="smollm-135m", tp=1, policy="taichi",
                          sliders=JaxSliders(n_p=1, n_d=1, s_p=64, s_d=32),
                          hbm_blocks=512)
    factory = lambda: JaxExecutor(cfg, params, n_slots=8, max_seq=512)
    loop = JaxServingLoop(jax_build_cluster(sc, slo,
                                            executor_factory=factory), slo,
                          admission=JaxAdmissionConfig(
                              max_depth=64, max_inflight=max_inflight))
    handles = []
    for p in prompts:
        ids = JaxByteTokenizer.encode(p)
        handles.append(loop.submit(JaxRequest(
            prompt_len=len(ids), max_new_tokens=MAX_TOKENS,
            prompt_tokens=list(ids))))
    loop.run()
    return [list(h.result().output_tokens) for h in handles]


def _post(port, path, body, out, idx):
    s = socket.create_connection(("127.0.0.1", port), timeout=JOIN_S)
    try:
        raw = json.dumps(body).encode()
        s.sendall((f"POST {path} HTTP/1.1\r\nHost: t\r\n"
                   f"Content-Length: {len(raw)}\r\n"
                   "Connection: close\r\n\r\n").encode() + raw)
        data = b""
        while chunk := s.recv(65536):
            data += chunk
    finally:
        s.close()
    out[idx] = data


def _get(port, path):
    s = socket.create_connection(("127.0.0.1", port), timeout=JOIN_S)
    try:
        s.sendall((f"GET {path} HTTP/1.1\r\nHost: t\r\n"
                   "Connection: close\r\n\r\n").encode())
        data = b""
        while chunk := s.recv(65536):
            data += chunk
    finally:
        s.close()
    head, _, body = data.partition(b"\r\n\r\n")
    return int(head.split(b" ", 2)[1]), body


def parse_reply(data, stream):
    """(status, text, finished, usage) of one HTTP reply: an SSE stream
    (de-chunked; ``finished`` once ``[DONE]`` arrived) or a JSON body."""
    head, _, payload = data.partition(b"\r\n\r\n")
    status = int(head.split(b" ", 2)[1])
    if status != 200:
        return status, "", False, None
    if not stream:
        obj = json.loads(payload)
        choice = obj["choices"][0]
        text = choice.get("text")
        if text is None:
            text = choice["message"]["content"]
        return status, text, choice["finish_reason"] == "length", \
            obj["usage"]
    body, rest = b"", payload
    while rest:
        size, _, rest = rest.partition(b"\r\n")
        n = int(size, 16)
        if n == 0:
            break
        body += rest[:n]
        rest = rest[n + 2:]
    text, finished, errored = "", False, False
    for ev in body.split(b"\n\n"):
        if not ev.startswith(b"data: "):
            continue
        if ev == b"data: [DONE]":
            finished = True
            continue
        obj = json.loads(ev[len(b"data: "):])
        if "choices" not in obj:
            errored = True
            continue
        choice = obj["choices"][0]
        text += choice.get("text") or choice.get("delta", {}).get(
            "content", "")
    return status, text, finished and not errored, None


def _detok(ids):
    d = IncrementalDetokenizer()
    return "".join(d.feed(t) for t in ids) + d.flush()


def _client_body(i):
    """Client ``i``: streaming or not, completions or chat."""
    stream, chat = i % 2 == 0, i % 3 == 1
    if chat:
        body = {"messages": [{"role": "user",
                              "content": f"client {i}: quick fox"}]}
        path = protocol.CHAT_COMPLETIONS
    else:
        body = {"prompt": f"client {i}: the quick brown fox #{i}"}
        path = protocol.COMPLETIONS
    body.update(max_tokens=MAX_TOKENS, stream=stream)
    text = protocol.parse_request(path, json.dumps(body).encode()
                                  ).prompt_text
    return path, body, text


@pytest.mark.usefixtures("copying_reference")
def test_live_server_streams_the_reference_tokens(weights):
    (cj, pj), (ct, pt) = weights
    loop = _torch_loop(ct, pt, max_inflight=4)
    srv = FrontendServer(loop, FrontendConfig(port=0, tok_workers=2))
    th = threading.Thread(target=srv.run, daemon=True)
    th.start()
    try:
        assert srv.started.wait(timeout=JOIN_S)
        clients = [_client_body(i) for i in range(N_CLIENTS)]
        out = {}
        threads = [threading.Thread(target=_post, daemon=True,
                                    args=(srv.port, path, body, out, i))
                   for i, (path, body, _) in enumerate(clients)]
        for t in threads:
            t.start()
        status, health = _get(srv.port, "/healthz")
        assert status == 200 and json.loads(health)["status"] == "ok"
        for t in threads:
            t.join(timeout=JOIN_S)
            assert not t.is_alive()
        status, metrics = _get(srv.port, "/metrics")
        assert status == 200 and json.loads(metrics)["wire"]["frames"] > 0
        assert srv.seen_worker_pids
        assert os.getpid() not in srv.seen_worker_pids
    finally:
        srv.shutdown()
        th.join(timeout=JOIN_S)
    assert not th.is_alive(), "graceful shutdown must end run()"

    by_prompt = {tuple(r.prompt_tokens): r for r in loop.requests}
    texts = [text for _, _, text in clients]
    assert len(by_prompt) == N_CLIENTS
    for i, (path, body, text) in enumerate(clients):
        status, got, finished, usage = parse_reply(out[i], body["stream"])
        assert status == 200 and finished, i
        r = by_prompt[tuple(ByteTokenizer.encode(text))]
        assert r.state == State.FINISHED
        assert len(r.output_tokens) == MAX_TOKENS
        assert got == _detok(r.output_tokens)           # wire exactness
        if usage is not None:
            assert usage == {"prompt_tokens": r.prompt_len,
                             "completion_tokens": MAX_TOKENS,
                             "total_tokens": r.prompt_len + MAX_TOKENS}
    ref = _reference_tokens(cj, pj, texts, max_inflight=4)
    assert [by_prompt[tuple(ByteTokenizer.encode(t))].output_tokens
            for t in texts] == ref


def test_live_server_drain_finishes_inflight(weights):
    _, (ct, pt) = weights
    loop = _torch_loop(ct, pt, max_inflight=2)
    srv = FrontendServer(loop, FrontendConfig(port=0, tok_workers=0))
    th = threading.Thread(target=srv.run, daemon=True)
    th.start()
    out = {}
    threads = []
    try:
        assert srv.started.wait(timeout=JOIN_S)
        threads = [threading.Thread(
            target=_post, daemon=True,
            args=(srv.port, protocol.COMPLETIONS,
                  {"prompt": f"drain {i}", "max_tokens": MAX_TOKENS,
                   "stream": True}, out, i)) for i in range(5)]
        for t in threads:
            t.start()
        deadline = time.monotonic() + JOIN_S
        while not any(i.decoding for i in loop.cluster.instances) \
                and time.monotonic() < deadline:
            time.sleep(0.01)
    finally:
        srv.shutdown()
        for t in threads:
            t.join(timeout=JOIN_S)
        th.join(timeout=JOIN_S)
    assert not th.is_alive() and not any(t.is_alive() for t in threads)
    finished = 0
    for i in range(5):
        status, text, done, _ = parse_reply(out[i], True)
        finished += status == 200 and done
    assert finished >= 1, "in-flight work must run to completion"
    for r in loop.requests:
        assert r.state in (State.FINISHED, State.CANCELLED)
        if r.state == State.FINISHED:
            assert len(r.output_tokens) == MAX_TOKENS


# ---------------------------------------------------------------------------
# the launcher's --serve
# ---------------------------------------------------------------------------

def test_serve_without_a_card_exits():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    with pytest.raises(SystemExit, match="no CUDA device"):
        serve.main(["--engine", "live", "--serve", "127.0.0.1:0",
                    "--reduced", "--arch", "smollm-135m"])


def serve_cli_round_trip():
    """Start ``--serve 127.0.0.1:0 --reduced --device cpu`` in a process
    of its own, read the bound port from its ``serving`` line, stream one
    completion, stop it with SIGINT.  Returns (reply, exit code, stdout
    lines, stderr)."""
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--engine",
           "live", "--serve", "127.0.0.1:0", "--arch", "smollm-135m",
           "--reduced", "--device", "cpu", "--tok-workers", "1"]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            env={**os.environ, "PYTHONPATH": SRC})
    lines = []
    try:
        for line in proc.stdout:
            lines.append(line)
            if line.startswith("serving "):
                break
        assert lines and lines[-1].startswith("serving "), lines
        port = int(lines[-1].split("http://127.0.0.1:")[1].split()[0])
        out = {}
        _post(port, protocol.COMPLETIONS,
              {"prompt": "hello", "max_tokens": 5, "stream": True}, out, 0)
        proc.send_signal(signal.SIGINT)
        rest, err = proc.communicate(timeout=JOIN_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=JOIN_S)
    return out[0], proc.returncode, lines + rest.splitlines(), err


def test_serve_cli_answers_a_streamed_completion_on_the_cpu():
    reply, rc, lines, err = serve_cli_round_trip()
    assert rc == 0, err[-2000:]
    status, text, finished, _ = parse_reply(reply, True)
    assert status == 200 and finished and text
    snap = json.loads(lines[-1])          # the drained loop's snapshot
    assert snap["admission"]["enqueued_total"] == 1
    assert np.isfinite(snap["wire"]["frames"])
