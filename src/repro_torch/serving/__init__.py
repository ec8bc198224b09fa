"""Online serving runtime of the port: continuous ingestion, streaming
and adaptive slider control (``ServingLoop``, its metrics, controller
and clocks) on top of the discrete-event cluster core, with the pieces
that core needs: fault injection, warm recovery and request-lifecycle
tracing (all default off).

Re-exports resolve lazily (PEP 562): the cluster core imports
``repro_torch.serving.faults`` at module load, and an eager ``server``
import here would close the cycle back onto the half-initialized
cluster.
"""
_EXPORTS = {
    "VirtualClock": "repro_torch.serving.clock",
    "WallClock": "repro_torch.serving.clock",
    "ControllerConfig": "repro_torch.serving.controller",
    "SliderController": "repro_torch.serving.controller",
    "Fault": "repro_torch.serving.faults",
    "FaultInjector": "repro_torch.serving.faults",
    "MetricsLog": "repro_torch.serving.metrics",
    "RecoveryConfig": "repro_torch.serving.recovery",
    "RecoveryManager": "repro_torch.serving.recovery",
    "TelemetryWindow": "repro_torch.serving.metrics",
    "AbortMsg": "repro_torch.serving.server",
    "RequestHandle": "repro_torch.serving.server",
    "ServingLoop": "repro_torch.serving.server",
    "SubmitMsg": "repro_torch.serving.server",
    "WatchdogConfig": "repro_torch.serving.server",
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
