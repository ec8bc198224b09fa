"""Minimal asyncio HTTP/1.1 server with SSE streaming.

Hand-rolled on ``asyncio.start_server`` — the repo carries no web
framework, and the server needs exactly four things a framework would
mostly get in the way of: request parsing, chunked SSE streaming,
connection-level backpressure (``await drain()``), and graceful drain
(stop accepting, let in-flight streams flush, then close).

The application side implements ``handle(method, path, headers, body)
-> Response``.  A ``Response`` either carries a complete ``body`` or a
``stream`` — an async iterator of byte frames written with chunked
transfer encoding (each SSE frame is one chunk, flushed immediately).
"""
from __future__ import annotations

import asyncio
import dataclasses
from typing import AsyncIterator, Callable, Dict, Optional, Tuple

#: request line + headers size cap (sanity, not security)
MAX_HEADER_BYTES = 32768
MAX_BODY_BYTES = 8 * 1024 * 1024

REASONS = {200: "OK", 400: "Bad Request", 404: "Not Found",
           405: "Method Not Allowed", 413: "Payload Too Large",
           500: "Internal Server Error", 503: "Service Unavailable"}


@dataclasses.dataclass
class Response:
    status: int = 200
    content_type: str = "application/json"
    body: Optional[bytes] = None
    stream: Optional[AsyncIterator[bytes]] = None
    #: extra response headers (e.g. Retry-After on overload 503s)
    headers: Optional[Dict[str, str]] = None
    #: called when the client goes away mid-stream (cleanup hook)
    on_disconnect: Optional[Callable[[], None]] = None


class HttpError(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status


async def _read_request(reader: asyncio.StreamReader
                        ) -> Optional[Tuple[str, str, Dict[str, str], bytes]]:
    """Parse one request; None on clean EOF before a request line."""
    try:
        head = await reader.readuntil(b"\r\n\r\n")
    except asyncio.IncompleteReadError as e:
        if not e.partial:
            return None
        raise HttpError(400, "truncated request head")
    except asyncio.LimitOverrunError:
        raise HttpError(413, "request head too large")
    if len(head) > MAX_HEADER_BYTES:
        raise HttpError(413, "request head too large")
    lines = head.decode("latin-1").split("\r\n")
    parts = lines[0].split(" ")
    if len(parts) != 3:
        raise HttpError(400, f"malformed request line: {lines[0]!r}")
    method, path, _version = parts
    headers: Dict[str, str] = {}
    for ln in lines[1:]:
        if not ln:
            continue
        k, _, v = ln.partition(":")
        headers[k.strip().lower()] = v.strip()
    n = int(headers.get("content-length", "0") or "0")
    if n > MAX_BODY_BYTES:
        raise HttpError(413, "request body too large")
    body = await reader.readexactly(n) if n else b""
    return method, path, headers, body


def _head(status: int, content_type: str, extra: str = "",
          length: Optional[int] = None) -> bytes:
    reason = REASONS.get(status, "")
    h = (f"HTTP/1.1 {status} {reason}\r\n"
         f"Content-Type: {content_type}\r\n")
    if length is not None:
        h += f"Content-Length: {length}\r\n"
    return (h + extra + "\r\n").encode("latin-1")


class HttpServer:
    def __init__(self, handler, host: str = "127.0.0.1", port: int = 0):
        """``handler``: async callable (method, path, headers, body) ->
        Response.  ``port=0`` binds an ephemeral port (tests)."""
        self.handler = handler
        self.host = host
        self.port = port
        self._server: Optional[asyncio.AbstractServer] = None
        self._conns: set = set()
        self.refusing = False          # graceful drain: 503 new requests

    # ------------------------------------------------------------------
    async def start(self):
        self._server = await asyncio.start_server(
            self._client, self.host, self.port,
            limit=MAX_HEADER_BYTES)
        self.port = self._server.sockets[0].getsockname()[1]
        return self

    async def stop(self, flush_timeout: float = 30.0):
        """Graceful: stop accepting, wait for in-flight connections to
        flush (SSE streams run to completion), then close stragglers."""
        self.refusing = True
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
        deadline = asyncio.get_event_loop().time() + flush_timeout
        while self._conns and asyncio.get_event_loop().time() < deadline:
            await asyncio.sleep(0.02)
        for task in list(self._conns):
            task.cancel()

    # ------------------------------------------------------------------
    async def _client(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter):
        task = asyncio.current_task()
        self._conns.add(task)
        try:
            while True:                # keep-alive request loop
                try:
                    parsed = await _read_request(reader)
                except HttpError as e:
                    await self._plain(writer, e.status, str(e))
                    break
                if parsed is None:
                    break
                method, path, headers, body = parsed
                if self.refusing:
                    await self._plain(writer, 503, "server is draining")
                    break
                try:
                    resp = await self.handler(method, path, headers, body)
                except HttpError as e:
                    resp = Response(e.status, body=(
                        b'{"error": {"message": "%s"}}'
                        % str(e).encode()))
                if resp.stream is not None:
                    await self._stream(writer, resp)
                    break              # one stream per connection
                await self._respond(writer, resp)
                if headers.get("connection", "").lower() == "close":
                    break
        except (ConnectionResetError, BrokenPipeError,
                asyncio.CancelledError):
            pass
        finally:
            self._conns.discard(task)
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionResetError, BrokenPipeError):
                pass

    async def _plain(self, writer, status: int, message: str):
        body = (b'{"error": {"message": "%s"}}'
                % message.encode("utf-8", "replace"))
        writer.write(_head(status, "application/json",
                           "Connection: close\r\n", len(body)) + body)
        await writer.drain()

    async def _respond(self, writer, resp: Response):
        body = resp.body or b""
        extra = "".join(f"{k}: {v}\r\n"
                        for k, v in (resp.headers or {}).items())
        writer.write(_head(resp.status, resp.content_type,
                           extra=extra, length=len(body)) + body)
        await writer.drain()

    async def _stream(self, writer, resp: Response):
        """Chunked SSE: one chunk per frame, drained per write so the
        client sees tokens the moment the engine emits them and a slow
        client applies backpressure instead of ballooning buffers."""
        writer.write(_head(resp.status, "text/event-stream",
                           "Cache-Control: no-cache\r\n"
                           "Connection: close\r\n"
                           "Transfer-Encoding: chunked\r\n"))
        await writer.drain()
        try:
            async for frame in resp.stream:
                writer.write(b"%x\r\n" % len(frame) + frame + b"\r\n")
                await writer.drain()
            writer.write(b"0\r\n\r\n")
            await writer.drain()
        except (ConnectionResetError, BrokenPipeError):
            if resp.on_disconnect is not None:
                resp.on_disconnect()
            raise
