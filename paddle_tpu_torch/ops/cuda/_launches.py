"""Launch counting of the kernel wrappers, safe across threads.

Each kernel module keeps ``launches`` (an int, or a dict by kernel) and,
where a kernel has two routes, ``launches_by_route``. A wrapper counts
each launch through :func:`count`, which takes :data:`lock`, so replicas
stepped from worker threads count every launch. While a capture records
(:func:`recording`), a launch onto a stream that is capturing goes into
the recorded dict instead: that is how a CUDA-graph capture learns what
one replay will launch (the capture itself runs nothing), whichever
thread made the launch (autograd runs a captured backward on a thread of
its own), without touching the counts other threads add to meanwhile on
streams that do not capture.

A count's key is ``(module, kernel, route)``: ``kernel`` None for a
module whose ``launches`` is an int, ``route`` None for the per-kernel
totals (``jit.launch_counts``' keys).
"""

from __future__ import annotations

import contextlib
import threading

import torch

#: guards every module's ``launches`` and ``launches_by_route``
lock = threading.RLock()
_record = None      # the open capture's recording; one capture at a time


def _name(module) -> str:
    return module.__name__.rsplit(".", 1)[1]


def count(module, kernel=None, route=None):
    """One launch of ``kernel`` of ``module`` on ``route``: into the open
    recording when the launching thread's current stream is capturing,
    else into the module's counts."""
    name = _name(module)
    keys = [(name, kernel, None)]
    if route is not None:
        keys.append((name, kernel or name, route))
    with lock:
        if _record is not None and torch.cuda.is_current_stream_capturing():
            for k in keys:
                _record[k] = _record.get(k, 0) + 1
            return
        if kernel is None:
            module.launches += 1
        else:
            module.launches[kernel] += 1
        if route is not None:
            module.launches_by_route[kernel or name][route] += 1


@contextlib.contextmanager
def recording():
    """The launches onto a capturing stream inside go into the yielded
    dict (keyed as :func:`count`'s), not into the modules' counts."""
    global _record
    with lock:
        if _record is not None:
            raise RuntimeError("one capture records its launches at a time")
        _record = rec = {}
    try:
        yield rec
    finally:
        with lock:
            _record = None
