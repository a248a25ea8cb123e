"""Runtime counters — a copy of ``paddle_tpu/monitor.py``, the
StatRegistry analog (platform/monitor.h:76,129).

``STAT_ADD("STAT_total_feasign_num_in_mem", n)`` style counters used by
the serving, router and resilience planes; thread-safe, exported as a dict.
``stat_time(name)`` adds a minimal latency facility on the same
registry: phase timings (serving prefill/decode, checkpoint IO) land in
``stats()`` as ``<name>_calls`` / ``<name>_ms`` without a separate
metrics stack.

This module is a *shim*: every
``stat_add`` counter is a Counter and every ``stat_time`` site a
Histogram in ``paddle_tpu_torch.observability.metrics.DEFAULT``. The
dict-shaped API (exact key names, int/float types, dotted fault-site
names) is unchanged — the whole chaos suite pins it.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict

from .observability import metrics as _metrics

_lock = threading.Lock()
# names this shim has created in the shared registry, by flavor — needed
# so stats()/reset() cover exactly the STAT plane and leave native
# instruments (serving histograms, compile counters) alone
_counter_names: set = set()
_timer_names: set = set()


def _registry() -> _metrics.MetricsRegistry:
    return _metrics.DEFAULT


def stat_add(name: str, value: int = 1):
    with _lock:
        _counter_names.add(name)
    _registry().counter(name).add(int(value))


def stat_set(name: str, value: int):
    with _lock:
        _counter_names.add(name)
    _registry().counter(name).set(int(value))


def stat_get(name: str) -> int:
    reg = _registry()
    with _lock:
        if name in _counter_names:
            inst = reg.get(name)
            return inst.value if inst is not None else 0
        # derived stat_time keys kept readable through stat_get, as the
        # flat-dict store allowed
        for suffix in ("_calls", "_ms"):
            if name.endswith(suffix) and name[:-len(suffix)] in _timer_names:
                inst = reg.get(name[:-len(suffix)])
                if inst is None:
                    return 0
                return inst.count if suffix == "_calls" else inst.sum
    return 0


@contextlib.contextmanager
def stat_time(name: str):
    """``with stat_time("STAT_serving_prefill"): ...`` — records one
    call and its wall-clock milliseconds as ``<name>_calls`` (int) and
    ``<name>_ms`` (float total) alongside the ordinary counters, so
    ``stats()["STAT_serving_prefill_ms"] /
    stats()["STAT_serving_prefill_calls"]`` is the mean latency."""
    with _lock:
        _timer_names.add(name)
    hist = _registry().histogram(name)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        hist.observe((time.perf_counter() - t0) * 1e3)


def stats() -> Dict[str, float]:
    reg = _registry()
    out: Dict[str, float] = {}
    with _lock:
        counters = list(_counter_names)
        timers = list(_timer_names)
    for name in counters:
        inst = reg.get(name)
        if inst is not None:
            out[name] = inst.value
    for name in timers:
        inst = reg.get(name)
        if inst is not None:
            out[name + "_calls"] = inst.count
            out[name + "_ms"] = inst.sum
    return out


def stats_with_prefix(prefix: str) -> Dict[str, int]:
    """Counters under one namespace, e.g. ``stats_with_prefix
    ("STAT_fault_")`` — how the chaos suite asserts every injection and
    every recovery was actually observed, not just survived."""
    return {k: v for k, v in stats().items() if k.startswith(prefix)}


def reset():
    reg = _registry()
    with _lock:
        names = _counter_names | _timer_names
        _counter_names.clear()
        _timer_names.clear()
    for name in names:
        reg.unregister(name)


# C++-style aliases
STAT_ADD = stat_add
STAT_RESET = reset
