"""paddle_tpu_torch.observability — the metric plane of the port, the
counterpart of ``paddle_tpu/observability``:

- :mod:`.metrics` the typed Counter/Gauge/Histogram registry
- :mod:`.runlog`  the structured JSONL run log
- :mod:`.tracing` per-request traces and their blame attribution
- :mod:`.export`  Prometheus text and JSON snapshot exporters (served at
  ``GET /metrics`` by ``serving.http.ServingHTTPServer``)
- :mod:`.compile_tracker` the serving steps' compiles (a captured CUDA
  graph on the card, a new input signature on the CPU), under the
  reference's ``xla_compiles`` / ``xla_compile_ms`` names
- :mod:`.devprof` the device-cost observatory: counted step costs,
  sampled device timing, roofline verdicts and the decode blame split

``paddle_tpu_torch.monitor`` (the STAT_* counter API) is a thin shim
over the registry here.
"""

from __future__ import annotations

from . import compile_tracker, devprof, export, metrics, runlog, tracing
from .compile_tracker import RecompileWarning, compiles, reset_compiles
from .export import prometheus_text, snapshot, validate_prometheus_text
from .metrics import (DEFAULT_BUCKETS, Counter, Gauge, Histogram,
                      MetricsRegistry)
from .runlog import log_event, recent


def counter(name: str, help_str: str = "") -> Counter:
    """Get-or-create a counter in the default registry."""
    return metrics.DEFAULT.counter(name, help_str)


def gauge(name: str, help_str: str = "") -> Gauge:
    """Get-or-create a gauge in the default registry."""
    return metrics.DEFAULT.gauge(name, help_str)


def histogram(name: str, help_str: str = "", buckets=None) -> Histogram:
    """Get-or-create a histogram in the default registry."""
    return metrics.DEFAULT.histogram(name, help_str, buckets=buckets)


__all__ = [
    "compile_tracker", "devprof", "export", "metrics", "runlog", "tracing",
    "RecompileWarning", "compiles", "reset_compiles",
    "prometheus_text", "snapshot", "validate_prometheus_text",
    "MetricsRegistry", "Counter", "Gauge", "Histogram", "DEFAULT_BUCKETS",
    "log_event", "recent", "counter", "gauge", "histogram",
]
