"""Profiler: scoped host events, a chrome-trace output and device tracing
through ``torch.profiler`` — the counterpart of ``paddle_tpu/profiler.py``.

Capability analog of the reference's profiler plane: RAII RecordEvent
markers (platform/profiler.h:126), EnableProfiler/DisableProfiler
(:208-211), CUPTI DeviceTracer (device_tracer.h:41), the
fluid/profiler.py python surface (:131-255) and tools/timeline.py's
chrome://tracing converter. Host events are recorded in-process AND
opened as ``torch.profiler.record_function`` ranges, so they appear in
the device trace beside the kernels they enclose (the JAX package opens
a ``TraceAnnotation`` in its xplane timeline); device tracing is
``torch.profiler.profile`` over the CPU and, where present, CUDA
(CUPTI), its chrome trace written into ``trace_dir``.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import threading
import time
from typing import Dict, List, Optional

import torch

_lock = threading.Lock()
_enabled = False
_events: List[dict] = []
_trace_dir: Optional[str] = None
_device_prof = None

#: the chrome trace ``torch.profiler`` writes into ``trace_dir``
DEVICE_TRACE_FILE = "device_trace.json"


class RecordEvent:
    """Scoped annotation (platform/profiler.h:126 RAII analog); usable
    as a context manager or decorator. The host event is recorded only
    while the profiler is on; the ``record_function`` range always opens
    (it costs nothing while no ``torch.profiler`` session records)."""

    def __init__(self, name: str):
        self.name = name
        self._range = None
        self._t0 = 0

    def __enter__(self):
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        self._range.__exit__(*exc)
        with _lock:
            # _enabled is mutated by start/stop_profiler under _lock;
            # read it there too so a concurrent stop can't interleave
            if _enabled:
                _events.append({
                    "name": self.name,
                    "ts": self._t0 / 1e3,     # chrome trace uses us
                    "dur": (t1 - self._t0) / 1e3,
                    "tid": threading.get_ident() % 100000,
                })
        return False

    def __call__(self, fn):
        @functools.wraps(fn)
        def wrapper(*a, **kw):
            with RecordEvent(self.name):
                return fn(*a, **kw)
        return wrapper


def start_profiler(state: str = "All", trace_dir: Optional[str] = None):
    """fluid/profiler.py start_profiler parity. With ``trace_dir`` a
    ``torch.profiler`` device trace records too (CPU, and CUDA where the
    host has a card)."""
    global _enabled, _trace_dir, _device_prof
    with _lock:
        _events.clear()
        _enabled = True
    if trace_dir:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
        _device_prof, _trace_dir = prof, trace_dir


def stop_profiler(sorted_key: Optional[str] = None,
                  profile_path: str = "/tmp/profile"):
    """Stop, write a chrome://tracing JSON of the host events to
    ``profile_path`` (and the device trace to ``trace_dir``'s
    :data:`DEVICE_TRACE_FILE`) and print the summary table
    (fluid/profiler.py stop_profiler + tools/timeline.py collapsed into
    one step)."""
    global _enabled, _trace_dir, _device_prof
    with _lock:
        _enabled = False
        events = list(_events)
        _events.clear()
    if _device_prof is not None:
        prof, trace_dir = _device_prof, _trace_dir
        _device_prof, _trace_dir = None, None
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.__exit__(None, None, None)
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(trace_dir, DEVICE_TRACE_FILE))
    trace = {"traceEvents": [
        {"name": e["name"], "ph": "X", "ts": e["ts"], "dur": e["dur"],
         "pid": 0, "tid": e["tid"], "cat": "host"} for e in events]}
    d = os.path.dirname(profile_path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(profile_path, "w") as f:
        json.dump(trace, f)
    summary = summarize(events, sorted_key)
    if summary:
        name_w = max(len(s["name"]) for s in summary)
        print(f"{'Event':{name_w}s}  {'Calls':>6s}  {'Total(ms)':>10s}  "
              f"{'Avg(ms)':>10s}")
        for s in summary:
            print(f"{s['name']:{name_w}s}  {s['calls']:6d}  "
                  f"{s['total_ms']:10.3f}  {s['avg_ms']:10.3f}")
    _print_metrics_summary()
    return summary


def _print_metrics_summary():
    """Counter/histogram totals from the observability plane, appended
    to the host-event table so one report covers both."""
    from . import observability
    snap = observability.snapshot()
    counters = {**snap["counters"], **snap["gauges"]}
    hists = snap["histograms"]
    if counters:
        print("Counters:")
        name_w = max(len(n) for n in counters)
        for name in sorted(counters):
            print(f"  {name:{name_w}s}  {counters[name]}")
    if hists:
        print(f"{'Histogram':28s}  {'Count':>7s}  {'Sum':>12s}  "
              f"{'p50':>10s}  {'p95':>10s}  {'p99':>10s}")
        for name in sorted(hists):
            h = hists[name]
            if not h["count"]:
                continue
            row = [f"{h[k]:10.4g}" if h[k] is not None else f"{'-':>10s}"
                   for k in ("p50", "p95", "p99")]
            print(f"{name:28s}  {h['count']:7d}  {h['sum']:12.4g}  "
                  + "  ".join(row))
    comp = snap.get("compiles") or {}
    if comp:
        # a capture of a CUDA graph on the card, a new key on the CPU
        print("Compiles (captures):")
        for qual in sorted(comp):
            c = comp[qual]
            print(f"  {qual}: {c['count']} "
                  f"({c['total_ms']:.1f} ms captured)")
    costs = snap.get("device_costs") or {}
    if costs:
        print("Device costs (per captured entry):")
        for qual in sorted(costs):
            c = costs[qual]

            def _fmt(v):
                return "n/a" if v is None else f"{v:.4g}"

            print(f"  {qual}: flops={_fmt(c.get('flops'))} "
                  f"hbm_bytes={_fmt(c.get('hbm_bytes'))} "
                  f"out_bytes={_fmt(c.get('out_bytes'))}")


def summarize(events: List[dict], sorted_key: Optional[str] = None):
    agg: Dict[str, dict] = {}
    for e in events:
        a = agg.setdefault(e["name"], {"name": e["name"], "calls": 0,
                                       "total_ms": 0.0})
        a["calls"] += 1
        a["total_ms"] += e["dur"] / 1e3
    out = list(agg.values())
    for a in out:
        a["avg_ms"] = a["total_ms"] / a["calls"]
    key = {"total": "total_ms", "ave": "avg_ms", "calls": "calls",
           None: "total_ms"}.get(sorted_key, "total_ms")
    out.sort(key=lambda a: -a[key])
    return out


@contextlib.contextmanager
def profiler(state: str = "All", sorted_key: Optional[str] = None,
             profile_path: str = "/tmp/profile",
             trace_dir: Optional[str] = None):
    """``with profiler.profiler(): ...`` context (fluid/profiler.py:255)."""
    start_profiler(state, trace_dir)
    try:
        yield
    finally:
        stop_profiler(sorted_key, profile_path)
