"""Front-end gateway: HTTP server <-> token pipeline <-> serving loop.

Thread architecture (three worlds, queue boundaries between all):

  asyncio thread          engine thread              detok workers
  --------------          -------------              -------------
  HTTP accept/parse  -->  loop.serve(stop):          per-rid detok +
  tokenize (worker)       ingress drain, admission   response/SSE
  SubmitMsg -> ingress    queue, event core          formatting
  per-req asyncio.Queue   on_token: ONE queue put -> ("frames"/"done")
  <- call_soon_threadsafe <------ reader thread ------------+
  chunked SSE writes

The engine's token hot path (``RequestHandle`` on_token) does exactly
one ``Queue.put`` — every string operation (incremental UTF-8 decode,
JSON formatting, SSE framing) happens in the detokenizer worker
processes.  Each SSE frame carries the ``time.monotonic()`` stamp of
the engine event that produced it; the asyncio writer reports the
engine->socket span to ``TelemetryWindow.record_wire``.

Graceful shutdown (SIGINT/SIGTERM or ``shutdown()``): stop accepting
HTTP, signal the engine's drain (queued admission entries resolve
CANCELLED, in-flight requests run to completion and their SSE streams
flush), then close the HTTP server and the pipeline.
"""
from __future__ import annotations

import asyncio
import dataclasses
import json
import signal
import threading
import time
from typing import Optional, Set

from repro_torch.frontend import protocol
from repro_torch.frontend.http import HttpServer, Response
from repro_torch.frontend.pipeline import TokenPipeline
from repro_torch.serving.server import AbortMsg, ServingLoop, SubmitMsg

from repro_torch.engine.request import Request, State


@dataclasses.dataclass
class FrontendConfig:
    host: str = "127.0.0.1"
    port: int = 8000                  # 0 = ephemeral (tests)
    model: str = "repro"
    tok_workers: int = 2              # 0 = inline pipeline (one process)
    max_tokens_cap: int = 512         # server-side clamp on max_tokens
    drain_timeout: float = 30.0       # flush window for graceful stop


class _ReqCtx:
    """Per-request bridge state living on the asyncio thread."""

    def __init__(self, rid: int, req_id: str, stream: bool):
        self.rid = rid
        self.req_id = req_id
        self.stream = stream
        self.frames: asyncio.Queue = asyncio.Queue()
        self.done_fired = False       # once-only guard for the done path


class FrontendServer:
    """Deployable server in front of a ``ServingLoop``.

    The loop is built by the caller (any executor: sim or JAX; for a
    real deployment use ``WallClock`` + ``pace=True`` and an
    ``AdmissionConfig``).  ``run()`` blocks until ``shutdown()`` or a
    signal; tests run it on a background thread and wait on
    ``started``."""

    def __init__(self, loop: ServingLoop,
                 cfg: Optional[FrontendConfig] = None):
        self.loop = loop
        self.cfg = cfg or FrontendConfig()
        self.pipeline = TokenPipeline(n_workers=self.cfg.tok_workers)
        self.http: Optional[HttpServer] = None
        self.port: Optional[int] = None
        self.started = threading.Event()
        self.seen_worker_pids: Set[int] = set()
        self._stop_engine = threading.Event()
        self._engine_thread: Optional[threading.Thread] = None
        self._aio: Optional[asyncio.AbstractEventLoop] = None
        self._shutdown_ev: Optional[asyncio.Event] = None
        self._ctxs = {}               # rid -> _ReqCtx (asyncio thread)

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def run(self, install_signals: bool = False):
        """Blocking entry point: starts the pipeline, the engine thread
        and the HTTP server, runs until shutdown."""
        asyncio.run(self._main(install_signals))

    def shutdown(self):
        """Thread-safe graceful-stop trigger."""
        if self._aio is not None and self._shutdown_ev is not None:
            self._aio.call_soon_threadsafe(self._shutdown_ev.set)

    async def _main(self, install_signals: bool):
        self._aio = asyncio.get_running_loop()
        self._shutdown_ev = asyncio.Event()
        if install_signals:
            for sig in (signal.SIGINT, signal.SIGTERM):
                self._aio.add_signal_handler(sig, self._shutdown_ev.set)
        self.pipeline.start()
        self._engine_thread = threading.Thread(
            target=self.loop.serve, args=(self._stop_engine,),
            name="engine", daemon=True)
        self._engine_thread.start()
        self.http = HttpServer(self._handle, self.cfg.host, self.cfg.port)
        await self.http.start()
        self.port = self.http.port
        self.started.set()
        try:
            await self._shutdown_ev.wait()
        finally:
            # drain order matters: refuse new HTTP work, let the engine
            # finish its in-flight population (frames keep flowing into
            # open SSE streams while we wait), THEN flush connections
            self.http.refusing = True
            self._stop_engine.set()
            await self._aio.run_in_executor(
                None, self._engine_thread.join, self.cfg.drain_timeout)
            await self.http.stop(self.cfg.drain_timeout)
            self.pipeline.stop()
            self.started.clear()

    # ------------------------------------------------------------------
    # HTTP routing
    # ------------------------------------------------------------------
    async def _handle(self, method: str, path: str, headers: dict,
                      body: bytes) -> Response:
        if method == "GET" and path == "/healthz":
            alive = (self._engine_thread is not None
                     and self._engine_thread.is_alive())
            insts = [{"iid": i.iid, "itype": i.itype,
                      "health": getattr(i, "health", "ok"),
                      "draining": i.draining}
                     for i in self.loop.cluster.instances]
            healthy = alive and any(i["health"] == "ok" for i in insts)
            status = ("ok" if healthy else
                      "engine down" if not alive else
                      "no healthy instances")
            return Response(200 if healthy else 503, body=json.dumps(
                {"status": status, "instances": insts}).encode())
        if method == "GET" and (path == "/metrics"
                                or path.startswith("/metrics?")):
            return self._metrics(headers, path)
        if path in (protocol.COMPLETIONS, protocol.CHAT_COMPLETIONS):
            if method != "POST":
                return Response(405, body=protocol.ProtocolError(
                    405, f"{method} not allowed").body())
            try:
                api = protocol.parse_request(path, body, headers)
            except protocol.ProtocolError as e:
                return Response(e.status, body=e.body())
            return await self._completion(api)
        return Response(404, body=protocol.ProtocolError(
            404, f"no route for {method} {path}").body())

    def _metrics(self, headers: dict, path: str) -> Response:
        """Serialize the loop's telemetry snapshot.  The window's lock
        makes the snapshot internally consistent against the engine
        thread's event ingestion (the former retry-on-RuntimeError loop
        is gone with it).  Content negotiation: JSON by default;
        Prometheus exposition text when the client asks for text/plain
        or OpenMetrics (or forces it with ``?format=prometheus``)."""
        snap = self.loop.snapshot(self.loop.receipt_now())
        accept = headers.get("accept", "")
        if ("text/plain" in accept or "openmetrics" in accept
                or "format=prometheus" in path):
            from repro_torch.serving.tracing import prometheus_text
            return Response(
                200, content_type="text/plain; version=0.0.4",
                body=prometheus_text(snap).encode())
        return Response(200, body=json.dumps(snap, default=str).encode())

    # ------------------------------------------------------------------
    # completion lifecycle
    # ------------------------------------------------------------------
    async def _completion(self, api: protocol.ApiRequest) -> Response:
        receipt = self.loop.receipt_now()     # connection-receipt truth
        ids = await asyncio.wrap_future(
            self.pipeline.tokenize(api.prompt_text))
        req = Request(prompt_len=len(ids),
                      max_new_tokens=min(api.max_tokens,
                                         self.cfg.max_tokens_cap),
                      arrival=receipt, prompt_tokens=list(ids))
        rid = req.rid
        prefix = "chatcmpl" if api.kind == "chat" else "cmpl"
        ctx = _ReqCtx(rid, f"{prefix}-{rid}", api.stream)
        self._ctxs[rid] = ctx
        self.pipeline.open_stream(
            rid, api.kind, ctx.req_id, api.model or self.cfg.model,
            int(time.time()),
            api.stream, self._on_frames)
        aio = self._aio

        def on_token(r, t, tok):
            # ENGINE THREAD hot path: one queue put, zero string work
            if tok is not None:
                self.pipeline.push_tokens(rid, [tok], time.monotonic())

        def reply(handle):
            # engine thread, after submit: resolution (immediate
            # rejection included) happens on this same thread, so
            # setting on_done here is race-free; if the request already
            # resolved during submit, fire the path ourselves
            handle.on_done = on_done
            if handle.done:
                on_done(handle.req)

        def on_done(r):
            if r.state == State.FINISHED:
                # EOS before the token budget ran out reports "stop";
                # hitting max_tokens reports "length"
                self.pipeline.finish(rid, r.finish_reason or "length",
                                     len(ids), time.monotonic())
            else:                     # rejected / cancelled: bypass the
                aio.call_soon_threadsafe(     # worker, report status
                    ctx.frames.put_nowait, ("status", r.state.value))

        self.loop.ingress.put(SubmitMsg(
            req=req, priority=api.priority, receipt=receipt,
            on_token=on_token, reply=reply))

        # first item decides the response shape: a request rejected
        # before any output must answer 503, not an empty 200 stream
        first = await ctx.frames.get()
        if first[0] == "status":
            self._close_ctx(rid)
            status = first[1]
            headers = None
            if status == "rejected":
                # overload refusal: tell the client when the current
                # admission backlog should have cleared
                q = self.loop.admission
                headers = {"Retry-After": str(
                    q.retry_after_hint() if q is not None else 1)}
            return Response(503, headers=headers,
                            body=protocol.ProtocolError(
                503, f"request {status} by the server"
                     + (" (overloaded)" if status == "rejected" else ""),
                err_type="server_error").body())
        if not api.stream:
            # non-streaming: the worker sent one ("frames", body, done)
            payload, done, t_event, _pid = first[1:]
            self.loop.telemetry.record_wire(time.monotonic() - t_event)
            self._close_ctx(rid)
            return Response(200, body=payload)
        return Response(200, stream=self._sse(ctx, first),
                        on_disconnect=lambda: self._close_ctx(rid))

    async def _sse(self, ctx: _ReqCtx, first):
        item = first
        try:
            while True:
                if item[0] == "status":
                    # cancelled/rejected mid-stream: close the stream
                    # honestly with a finish_reason instead of hanging
                    yield protocol.sse_event(
                        {"id": ctx.req_id,
                         "object": "error",
                         "error": {"message":
                                   f"request {item[1]} by the server"}})
                    yield protocol.SSE_DONE
                    return
                payload, done, t_event, _pid = item[1:]
                self.loop.telemetry.record_wire(
                    time.monotonic() - t_event)
                yield payload
                if done:
                    return
                item = await ctx.frames.get()
        finally:
            self._close_ctx(ctx.rid)

    # ------------------------------------------------------------------
    def _on_frames(self, rid: int, payload: bytes, done: bool,
                   t_event: float, pid: int):
        """Pipeline reader thread -> the request's asyncio queue."""
        self.seen_worker_pids.add(pid)
        ctx = self._ctxs.get(rid)
        if ctx is None or self._aio is None:
            return
        try:
            self._aio.call_soon_threadsafe(
                ctx.frames.put_nowait, ("frames", payload, done, t_event,
                                        pid))
        except RuntimeError:
            pass                      # event loop already closed

    def _close_ctx(self, rid: int):
        self._ctxs.pop(rid, None)
        self.pipeline.close(rid)
        # client gone before the request resolved (SSE disconnect, or a
        # dropped non-streaming connection): propagate the abort so the
        # engine stops generating into a dead socket and frees the
        # request's KV blocks.  A no-op for normally-completed requests.
        handle = self.loop._handles.get(rid)
        if handle is not None and not handle.done:
            self.loop.ingress.put(AbortMsg(rid))
