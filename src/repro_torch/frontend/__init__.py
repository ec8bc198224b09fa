"""Network front-end of the port: OpenAI-compatible HTTP/SSE serving on
top of the online serving runtime.

Three layers (each usable alone):

* ``repro_torch.frontend.protocol`` — wire schema: OpenAI
  ``/v1/completions`` and ``/v1/chat/completions`` request parsing,
  response/chunk formatting, and SSE framing.  Pure functions over plain
  values, so the detokenizer workers can format responses out-of-process.
* ``repro_torch.frontend.pipeline`` — the multi-process token pipeline
  (TokenizerManager/DetokenizerManager): tokenization and incremental
  detokenization + response formatting run in worker processes with
  per-request affinity, so ``Instance.token_sink`` events never block
  on host-side string work.
* ``repro_torch.frontend.http`` + ``repro_torch.frontend.gateway`` — the
  asyncio HTTP/SSE server and the bridge that runs a ``ServingLoop`` on
  an engine thread behind it (ingress queue, admission, graceful drain,
  ``/healthz`` + ``/metrics``).

``repro_torch.frontend.admission`` holds the router-side admission queue
(priority/fairness classes, bounded depth) that the serving loop uses
to absorb bursts instead of rejecting them.

Everything this package imports at load — admission, pipeline, protocol,
tokenizer — is free of torch, so the pipeline's spawned workers start
without it.  The gateway (which reaches the engine) loads lazily.
"""
from repro_torch.frontend.admission import (AdmissionConfig, AdmissionQueue,
                                            PRIORITY_CLASSES)
from repro_torch.frontend.pipeline import TokenPipeline
from repro_torch.frontend.tokenizer import (ByteTokenizer,
                                            IncrementalDetokenizer)


def __getattr__(name):
    # the gateway imports repro_torch.serving (which itself imports this
    # package for the admission queue) — load it lazily to keep the
    # import graph acyclic, and torch out of the pipeline's workers
    if name in ("FrontendConfig", "FrontendServer"):
        from repro_torch.frontend import gateway
        return getattr(gateway, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "AdmissionConfig", "AdmissionQueue", "ByteTokenizer",
    "FrontendConfig", "FrontendServer", "IncrementalDetokenizer",
    "PRIORITY_CLASSES", "TokenPipeline",
]
