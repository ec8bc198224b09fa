"""Serving-side pieces the scheduling core needs: fault injection, warm
recovery and request-lifecycle tracing (all default off).  The online
``ServingLoop``, its metrics, controller and clocks are not in the port
yet.

Re-exports resolve lazily (PEP 562): the cluster core imports
``repro_torch.serving.faults`` at module load, and an eager import here
would close the cycle back onto the half-initialized cluster.
"""
_EXPORTS = {
    "Fault": "repro_torch.serving.faults",
    "FaultInjector": "repro_torch.serving.faults",
    "RecoveryConfig": "repro_torch.serving.recovery",
    "RecoveryManager": "repro_torch.serving.recovery",
    "TraceConfig": "repro_torch.serving.tracing",
    "Tracer": "repro_torch.serving.tracing",
    "prometheus_text": "repro_torch.serving.tracing",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}")
    import importlib
    return getattr(importlib.import_module(mod), name)
