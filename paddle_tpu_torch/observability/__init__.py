"""paddle_tpu_torch.observability — the metric plane of the port, the
counterpart of ``paddle_tpu/observability``:

- :mod:`.metrics` the typed Counter/Gauge/Histogram registry
- :mod:`.runlog`  the structured JSONL run log

``paddle_tpu_torch.monitor`` (the STAT_* counter API) is a thin shim
over the registry here. Not ported yet: the compile tracker (a captured
graph is counted by ``traces["count"]`` instead), devprof, tracing and
the Prometheus/JSON exporters (``export.py``, ``http.py``).
"""

from __future__ import annotations

from . import metrics, runlog
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
    "metrics", "runlog",
    "MetricsRegistry", "Counter", "Gauge", "Histogram", "DEFAULT_BUCKETS",
    "log_event", "recent", "counter", "gauge", "histogram",
]
