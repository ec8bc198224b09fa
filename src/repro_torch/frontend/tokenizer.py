"""Deterministic byte-level tokenizer + incremental detokenizer.

The repro models are randomly initialized, so no pretrained vocabulary
exists to load (and the container must not download one).  The wire
still needs a *real* text<->token boundary with the hard parts of
production detokenization, so we use a byte tokenizer:

* ``encode``: UTF-8 bytes, one token id per byte (ids 0..255) — always
  within every registered config's vocab.
* ``IncrementalDetokenizer``: streaming decode with the classic
  incremental-detok hazard handled — a multi-byte UTF-8 sequence split
  across decode steps is *held* until its continuation bytes arrive,
  so no replacement characters leak mid-stream.  Token ids >= 256
  (the model decodes over its full vocab) render as a deterministic
  ``⟨id⟩`` marker, flushing any pending partial sequence first.

Both directions are pure Python over small state, safe to run inside
``multiprocessing`` workers (no jax, no numpy).
"""
from __future__ import annotations

import codecs
from typing import List

#: ids below this are raw UTF-8 bytes; at/above render as markers
BYTE_VOCAB = 256


class ByteTokenizer:
    """Stateless encode side (the TokenizerManager's unit of work)."""

    vocab_size = BYTE_VOCAB

    @staticmethod
    def encode(text: str) -> List[int]:
        return list(text.encode("utf-8"))

    @staticmethod
    def decode(ids: List[int]) -> str:
        """Batch decode (oracle for tests): identical output to feeding
        an ``IncrementalDetokenizer`` one id at a time."""
        det = IncrementalDetokenizer()
        return "".join(det.feed(i) for i in ids) + det.flush()


class IncrementalDetokenizer:
    """Per-request streaming decoder (the DetokenizerManager's state)."""

    def __init__(self):
        self._dec = codecs.getincrementaldecoder("utf-8")(errors="replace")

    def feed(self, token_id: int) -> str:
        """Text newly completed by this token (may be '' while a
        multi-byte sequence is pending)."""
        if 0 <= token_id < BYTE_VOCAB:
            return self._dec.decode(bytes([token_id]))
        # out-of-byte-range id: close any dangling partial sequence
        # (renders as U+FFFD — the bytes can no longer complete), then
        # emit the deterministic marker
        return self._dec.decode(b"", True) + f"⟨{token_id}⟩"

    def flush(self) -> str:
        """End of stream: force out any incomplete trailing sequence."""
        return self._dec.decode(b"", True)
