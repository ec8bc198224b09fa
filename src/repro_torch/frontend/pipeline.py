"""Multi-process tokenize/detokenize pipeline.

sglang's hybrid TokenizerManager/DetokenizerManager is the exemplar:
string work — encoding prompts, incrementally decoding token streams,
formatting response JSON/SSE frames — is offloaded to worker
*processes* connected by lightweight queues, so the engine's token hot
path (``Instance.token_sink``) does nothing but a queue ``put``.  Each
in-flight request has **affinity** to one worker (``rid % n``), which
keeps its incremental detokenizer state local to that worker and its
frames in order; tokenize jobs are spread the same way by job id.

Wire format over the queues (plain tuples, cheap to pickle):

  main -> worker                       worker -> main
  ("tok", job, text)                   ("tok", job, ids, pid)
  ("open", rid, meta)
  ("tokens", rid, ids, t_event)        ("frames", rid, bytes, t_event, pid)
  ("fin", rid, reason, p_tok, c_tok, t)("done", rid, bytes, t_event, pid)
  ("close", rid)
  None (shutdown)

``meta``: (kind, req_id, model, created, stream) — everything
``repro_torch.frontend.protocol`` needs to format either API flavor.  A
worker answers a non-streaming request with a single ("done", body)
after accumulating deltas; a streaming request gets incremental
("frames", sse-bytes) and a final ("done", last-chunk + [DONE]).

``n_workers=0`` degrades to an inline (in-process) pipeline with the
identical interface — the fast tests and single-process deployments
use it; worker pids then equal the main pid, which is exactly what the
process-isolation test asserts against.
"""
from __future__ import annotations

import contextlib
import itertools
import os
import queue
import sys
import threading
import types
from concurrent.futures import Future
from typing import Callable, Dict, Optional

from repro_torch.frontend import protocol
from repro_torch.frontend.tokenizer import (ByteTokenizer,
                                            IncrementalDetokenizer)


class _StreamState:
    """Per-request detok + formatting state (lives on ONE worker)."""

    def __init__(self, meta):
        self.kind, self.req_id, self.model, self.created, self.stream = meta
        self.detok = IncrementalDetokenizer()
        self.text_parts = []          # non-stream accumulation
        self.completion_tokens = 0

    def feed(self, ids) -> str:
        self.completion_tokens += len(ids)
        return "".join(self.detok.feed(i) for i in ids)


def _handle(msg, streams: Dict[int, _StreamState], emit) -> bool:
    """Shared worker logic (mp worker loop AND inline mode).  ``emit``
    receives the outbox tuple; returns False on shutdown."""
    if msg is None:
        return False
    op = msg[0]
    if op == "tok":
        _, job, text = msg
        emit(("tok", job, ByteTokenizer.encode(text), os.getpid()))
    elif op == "open":
        _, rid, meta = msg
        streams[rid] = _StreamState(meta)
    elif op == "tokens":
        _, rid, ids, t_event = msg
        st = streams.get(rid)
        if st is None:
            return True
        text = st.feed(ids)
        if st.stream:
            if text:
                emit(("frames", rid, protocol.stream_chunk(
                    st.kind, st.req_id, st.model, st.created, text),
                    t_event, os.getpid()))
        else:
            st.text_parts.append(text)
    elif op == "fin":
        _, rid, reason, p_tok, t_event = msg
        st = streams.pop(rid, None)
        if st is None:
            return True
        tail = st.detok.flush()
        if st.stream:
            payload = b""
            if tail:
                payload += protocol.stream_chunk(
                    st.kind, st.req_id, st.model, st.created, tail)
            payload += protocol.stream_chunk(
                st.kind, st.req_id, st.model, st.created, "", reason)
            payload += protocol.SSE_DONE
        else:
            st.text_parts.append(tail)
            payload = protocol.final_response(
                st.kind, st.req_id, st.model, st.created,
                "".join(st.text_parts), reason, p_tok,
                st.completion_tokens)
        emit(("done", rid, payload, t_event, os.getpid()))
    elif op == "close":
        streams.pop(msg[1], None)
    return True


def _worker_main(inbox, outbox):
    """Worker process entry point: drain the inbox forever.  Imports in
    this module are string-only (protocol/tokenizer — no torch, no
    numpy), and the workers start without the parent's main script
    (``_bare_main``), so spawn start-up stays cheap."""
    streams: Dict[int, _StreamState] = {}
    while True:
        if not _handle(inbox.get(), streams, outbox.put):
            break


@contextlib.contextmanager
def _bare_main():
    """Start spawned workers without the parent's main script.  A spawned
    child first re-runs the parent's ``__main__`` script (as
    ``__mp_main__``) and only then unpickles its target, so a server
    started from a script that imports torch would load torch into every
    worker.  The workers need nothing of that script: while they start,
    ``__main__`` is an empty module, which spawn does not re-run."""
    main = sys.modules["__main__"]
    sys.modules["__main__"] = types.ModuleType("__main__")
    try:
        yield
    finally:
        sys.modules["__main__"] = main


class TokenPipeline:
    """Main-process façade: routes jobs to workers, routes results to
    per-request callbacks via a reader thread.

    Callbacks (called from the reader thread — register thread-safe
    consumers, e.g. ``asyncio.loop.call_soon_threadsafe``):
      on_frames(rid, payload: bytes, done: bool, t_event, worker_pid)
    """

    def __init__(self, n_workers: int = 2, start_method: str = "spawn"):
        self.n_workers = n_workers
        self._start_method = start_method
        self._job_ids = itertools.count()
        self._tok_futures: Dict[int, Future] = {}
        self._sinks: Dict[int, Callable] = {}
        self._lock = threading.Lock()
        self._procs = []
        self._inboxes = []
        self._outbox = None
        self._reader: Optional[threading.Thread] = None
        self._inline_streams: Dict[int, _StreamState] = {}
        self.started = False

    # ------------------------------------------------------------------
    def start(self):
        if self.started:
            return
        self.started = True
        if self.n_workers <= 0:
            return                      # inline mode: nothing to spawn
        import multiprocessing as mp
        ctx = mp.get_context(self._start_method)
        self._outbox = ctx.Queue()
        with _bare_main():
            for _ in range(self.n_workers):
                inbox = ctx.Queue()
                p = ctx.Process(target=_worker_main,
                                args=(inbox, self._outbox), daemon=True)
                p.start()
                self._inboxes.append(inbox)
                self._procs.append(p)
        self._reader = threading.Thread(target=self._read_loop,
                                        name="detok-reader", daemon=True)
        self._reader.start()

    def stop(self):
        if not self.started:
            return
        self.started = False
        for inbox in self._inboxes:
            try:
                inbox.put(None)
            except (ValueError, OSError):
                pass
        for p in self._procs:
            p.join(timeout=2.0)
            if p.is_alive():
                p.terminate()
        if self._outbox is not None:
            self._outbox.put(None)      # unblock the reader
        if self._reader is not None:
            self._reader.join(timeout=2.0)
        self._procs, self._inboxes = [], []

    # ------------------------------------------------------------------
    def _send(self, idx: int, msg):
        if self.n_workers <= 0:
            _handle(msg, self._inline_streams, self._dispatch)
        else:
            self._inboxes[idx % self.n_workers].put(msg)

    def _read_loop(self):
        while True:
            msg = self._outbox.get()
            if msg is None:
                break
            self._dispatch(msg)

    def _dispatch(self, msg):
        op = msg[0]
        if op == "tok":
            _, job, ids, _pid = msg
            with self._lock:
                fut = self._tok_futures.pop(job, None)
            if fut is not None:
                fut.set_result(ids)
        elif op in ("frames", "done"):
            _, rid, payload, t_event, pid = msg
            done = op == "done"
            with self._lock:
                sink = self._sinks.get(rid)
                if done:
                    self._sinks.pop(rid, None)
            if sink is not None:
                sink(rid, payload, done, t_event, pid)

    # ------------------------------------------------------------------
    # tokenize side
    # ------------------------------------------------------------------
    def tokenize(self, text: str) -> Future:
        """Offload one prompt encoding; resolves to the token id
        list."""
        job = next(self._job_ids)
        fut: Future = Future()
        with self._lock:
            self._tok_futures[job] = fut
        self._send(job, ("tok", job, text))
        return fut

    # ------------------------------------------------------------------
    # detokenize side (per-request affinity: everything keys on rid)
    # ------------------------------------------------------------------
    def open_stream(self, rid: int, kind: str, req_id: str, model: str,
                    created: int, stream: bool, on_frames: Callable):
        with self._lock:
            self._sinks[rid] = on_frames
        self._send(rid, ("open", rid,
                         (kind, req_id, model, created, stream)))

    def push_tokens(self, rid: int, ids, t_event: float):
        """THE token hot path: one queue put, no string work."""
        self._send(rid, ("tokens", rid, ids, t_event))

    def finish(self, rid: int, reason: str, prompt_tokens: int,
               t_event: float):
        self._send(rid, ("fin", rid, reason, prompt_tokens, t_event))

    def close(self, rid: int):
        with self._lock:
            self._sinks.pop(rid, None)
        self._send(rid, ("close", rid))

    # ------------------------------------------------------------------
    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
