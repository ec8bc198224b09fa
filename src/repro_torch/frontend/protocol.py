"""OpenAI-compatible wire schema.

Request parsing for ``/v1/completions`` (string prompt) and
``/v1/chat/completions`` (message list), plus the response and SSE
chunk builders.  Everything here is a pure function over plain values
— no engine types, no numpy — because response formatting runs inside
the detokenizer worker *processes* (``repro.frontend.pipeline``) and
the objects must cross a ``multiprocessing`` queue cheaply.

Greedy-only engine: ``temperature``/``top_p`` are accepted and ignored
(the toy models sample greedily on-device), ``n`` must be 1.  The
priority class for the router-side admission queue rides either in the
body (``"priority": "interactive"``) or the ``x-priority`` header.
"""
from __future__ import annotations

import dataclasses
import json
from typing import List, Optional

#: admission classes, highest priority first (see frontend.admission)
DEFAULT_PRIORITY = "standard"

COMPLETIONS = "/v1/completions"
CHAT_COMPLETIONS = "/v1/chat/completions"


class ProtocolError(Exception):
    """Maps to an HTTP error response in OpenAI's error envelope."""

    def __init__(self, status: int, message: str,
                 err_type: str = "invalid_request_error"):
        super().__init__(message)
        self.status = status
        self.err_type = err_type

    def body(self) -> bytes:
        return json.dumps({"error": {
            "message": str(self), "type": self.err_type,
            "param": None, "code": None}}).encode()


@dataclasses.dataclass
class ApiRequest:
    """One parsed API call, engine-agnostic."""
    kind: str                       # "completion" | "chat"
    model: str
    prompt_text: str                # chat messages flattened to one text
    max_tokens: int
    stream: bool
    priority: str
    echo: bool = False


def _flatten_chat(messages) -> str:
    """Deterministic chat template: ``role: content`` lines plus the
    assistant cue.  A real deployment would use the model's template —
    the toy tokenizer only needs a stable, injective flattening."""
    if not isinstance(messages, list) or not messages:
        raise ProtocolError(400, "'messages' must be a non-empty list")
    parts = []
    for m in messages:
        if not isinstance(m, dict) or "role" not in m or "content" not in m:
            raise ProtocolError(
                400, "each message needs 'role' and 'content'")
        parts.append(f"{m['role']}: {m['content']}")
    parts.append("assistant:")
    return "\n".join(parts)


def parse_request(path: str, body: bytes,
                  headers: Optional[dict] = None) -> ApiRequest:
    """Parse one POST body into an ``ApiRequest`` (raises
    ``ProtocolError`` on anything malformed)."""
    try:
        obj = json.loads(body or b"{}")
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        raise ProtocolError(400, f"request body is not valid JSON: {e}")
    if not isinstance(obj, dict):
        raise ProtocolError(400, "request body must be a JSON object")
    if obj.get("n", 1) != 1:
        raise ProtocolError(400, "only n=1 is supported")
    max_tokens = obj.get("max_tokens", 16)
    if not isinstance(max_tokens, int) or max_tokens < 1:
        raise ProtocolError(400, "'max_tokens' must be a positive integer")
    stream = bool(obj.get("stream", False))
    priority = obj.get("priority") or (headers or {}).get(
        "x-priority", DEFAULT_PRIORITY)
    if path == COMPLETIONS:
        prompt = obj.get("prompt")
        if isinstance(prompt, list):      # OpenAI allows a 1-element list
            if len(prompt) != 1 or not isinstance(prompt[0], str):
                raise ProtocolError(
                    400, "'prompt' must be a string (or [string])")
            prompt = prompt[0]
        if not isinstance(prompt, str) or not prompt:
            raise ProtocolError(400, "'prompt' must be a non-empty string")
        return ApiRequest("completion", obj.get("model", ""),
                          prompt, max_tokens, stream, str(priority),
                          echo=bool(obj.get("echo", False)))
    if path == CHAT_COMPLETIONS:
        return ApiRequest("chat", obj.get("model", ""),
                          _flatten_chat(obj.get("messages")),
                          max_tokens, stream, str(priority))
    raise ProtocolError(404, f"unknown endpoint {path}")


# ---------------------------------------------------------------------------
# response / chunk builders (run in the detokenizer workers)
# ---------------------------------------------------------------------------

def sse_event(payload: dict) -> bytes:
    """One SSE frame: ``data: <json>\\n\\n``."""
    return b"data: " + json.dumps(payload, separators=(",", ":")).encode() \
        + b"\n\n"


SSE_DONE = b"data: [DONE]\n\n"


def _ident(kind: str, req_id: str, model: str, created: int) -> dict:
    return {"id": req_id,
            "object": ("chat.completion.chunk" if kind == "chat"
                       else "text_completion"),
            "created": created, "model": model}


def stream_chunk(kind: str, req_id: str, model: str, created: int,
                 text: str, finish_reason: Optional[str] = None) -> bytes:
    """One streamed delta as an SSE frame (both API flavors)."""
    if kind == "chat":
        delta = {"content": text} if text else {}
        choice = {"index": 0, "delta": delta,
                  "finish_reason": finish_reason}
    else:
        choice = {"index": 0, "text": text, "logprobs": None,
                  "finish_reason": finish_reason}
    return sse_event({**_ident(kind, req_id, model, created),
                      "choices": [choice]})


def final_response(kind: str, req_id: str, model: str, created: int,
                   text: str, finish_reason: str,
                   prompt_tokens: int, completion_tokens: int) -> bytes:
    """The single non-streaming response body."""
    if kind == "chat":
        choice = {"index": 0,
                  "message": {"role": "assistant", "content": text},
                  "finish_reason": finish_reason}
        obj = "chat.completion"
    else:
        choice = {"index": 0, "text": text, "logprobs": None,
                  "finish_reason": finish_reason}
        obj = "text_completion"
    return json.dumps({
        **_ident(kind, req_id, model, created), "object": obj,
        "choices": [choice],
        "usage": {"prompt_tokens": prompt_tokens,
                  "completion_tokens": completion_tokens,
                  "total_tokens": prompt_tokens + completion_tokens},
    }).encode()
