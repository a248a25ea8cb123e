"""The compile tracker — the counterpart of
``paddle_tpu/observability/compile_tracker.py``, with its surface and its
metric names.

The reference wraps every ``jax.jit`` entry in ``tracked_jit`` and counts
XLA compiles. The port has no XLA: a serving step is a
:class:`~paddle_tpu_torch.jit.HeldStep`, and its "compile" is a CUDA
graph captured on the card, or a new input signature on the CPU, which
the step cache already counts in ``traces["count"]``. The step reports
each one here, from the same place, with the reference's site name and
labels (``decode_step_paged``, ``decode_megastep_paged{n=8}``,
``serving_prefill_paged{bucket=16}``, ...), so that:

- a process-wide record per (name, labels) aggregates the count, the
  wall time of the calls that captured, and the last few abstract
  shape/dtype signatures (:func:`compiles`);
- the metrics registry carries ``xla_compiles{fn=...}`` and the
  ``xla_compile_ms`` histogram (the reference's names, kept so that
  ``/metrics`` reads the same in both packages: ROADMAP C);
- with ``FLAGS_warn_recompiles=N`` (N > 0) a site that compiles more
  than N times raises a :class:`RecompileWarning` through
  ``warnings.warn`` naming the offending signature, mirrored into the
  run log.

The port's step keeps two graphs per entry (greedy and sampled), each
reported under the entry's site, so a site's count is its entry's
``traces["count"]``. :func:`watch` tells a caller of each compile as it
happens, with the call's arguments (the soak attributes a capture to
the engine whose pools the step held).
"""

from __future__ import annotations

import collections
import contextlib
import threading
import warnings
from typing import Any, Dict, Optional, Tuple

from .. import flags as _flags
from . import metrics as _metrics
from . import runlog as _runlog


class RecompileWarning(UserWarning):
    """A tracked step compiled more often than FLAGS_warn_recompiles."""


def _qualname(name: str, labels: Dict[str, str]) -> str:
    if not labels:
        return name
    inner = ",".join(f"{k}={v}" for k, v in sorted(labels.items()))
    return f"{name}{{{inner}}}"


class _CompileRecord:
    """Aggregate compile stats for one (name, labels) site."""

    __slots__ = ("name", "labels", "count", "total_ms",
                 "signatures", "last_signature")

    def __init__(self, name: str, labels: Dict[str, str]):
        self.name = name
        self.labels = dict(labels)
        self.count = 0
        self.total_ms = 0.0
        # the last few (signature, ms) pairs: enough to attribute a
        # recompile loop without unbounded growth
        self.signatures: collections.deque = collections.deque(maxlen=8)
        self.last_signature: Optional[str] = None


_lock = threading.Lock()
_watchers: list = []
_records: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], _CompileRecord] = {}


def _record_for(name: str, labels: Dict[str, str]) -> _CompileRecord:
    key = (name, tuple(sorted(labels.items())))
    with _lock:
        rec = _records.get(key)
        if rec is None:
            rec = _records[key] = _CompileRecord(name, labels)
        return rec


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _leaves(x)
    elif tree is not None:
        yield tree


def _describe_leaf(x: Any) -> str:
    shape = getattr(x, "shape", None)
    dtype = getattr(x, "dtype", None)
    if shape is not None and dtype is not None:
        dims = ",".join(str(d) for d in shape)
        name = getattr(dtype, "name", None) or str(dtype).replace(
            "torch.", "")
        return f"{name}[{dims}]"
    return type(x).__name__


_SIG_MAX_CHARS = 512


def abstract_signature(args: tuple, kwargs: dict) -> str:
    """Abstract shape/dtype signature of a call, e.g.
    ``float32[4,32],int32[4],int``: tensors and arrays as
    ``dtype[dims]``, other leaves by type (None leaves dropped, as a
    pytree flattening drops them)."""
    leaves = list(_leaves((tuple(args), dict(kwargs))))
    sig = ",".join(_describe_leaf(x) for x in leaves)
    if len(sig) > _SIG_MAX_CHARS:
        sig = sig[:_SIG_MAX_CHARS] + f"...({len(leaves)} leaves)"
    return sig


def note_compile(name: str, labels: Optional[Dict[str, str]], args,
                 wall_ms: float) -> str:
    """Account one compile of site ``(name, labels)``: a graph captured
    (card) or a new input signature (CPU) for the call ``args``, which
    took ``wall_ms``. Returns the call's abstract signature."""
    rec = _record_for(name, dict(labels or {}))
    sig = abstract_signature(tuple(args), {})
    with _lock:
        prev_sig = rec.last_signature
        rec.count += 1
        rec.total_ms += wall_ms
        rec.signatures.append({"signature": sig, "ms": round(wall_ms, 3)})
        rec.last_signature = sig
        count_now = rec.count
    reg = _metrics.DEFAULT
    # site labels may not shadow the fn= label carrying the site name
    lbls = {k: v for k, v in rec.labels.items() if k != "fn"}
    lbls["fn"] = rec.name
    reg.counter("xla_compiles",
                "XLA compiles per tracked function").labels(**lbls).add(1)
    reg.histogram("xla_compile_ms",
                  "wall ms of calls that triggered an XLA compile"
                  ).observe(wall_ms)
    for fn in list(_watchers):
        fn(name, dict(labels or {}), args)
    limit = int(_flags.get_flag("warn_recompiles") or 0)
    if limit > 0 and count_now > limit:
        qual = _qualname(rec.name, rec.labels)
        msg = (f"XLA recompile: {qual} compiled {count_now} times "
               f"(FLAGS_warn_recompiles={limit}); offending signature "
               f"{sig!r}" +
               (f"; previous signature {prev_sig!r}"
                if prev_sig and prev_sig != sig else ""))
        warnings.warn(RecompileWarning(msg), stacklevel=4)
        _runlog.log_event("recompile_warning", fn=rec.name,
                          labels=rec.labels, count=count_now,
                          limit=limit, signature=sig,
                          previous_signature=prev_sig)
    return sig


@contextlib.contextmanager
def watch(fn):
    """Call ``fn(name, labels, args)`` at each compile inside the block,
    in the compiling thread (``args``: the step's small inputs, then its
    held tensors)."""
    with _lock:
        _watchers.append(fn)
    try:
        yield
    finally:
        with _lock:
            _watchers.remove(fn)


def compiles() -> Dict[str, Dict[str, Any]]:
    """Snapshot of all tracked compile sites, keyed by qualified name
    (``decode_step``, ``serving_prefill{bucket=8}``, ...)."""
    with _lock:
        out: Dict[str, Dict[str, Any]] = {}
        for rec in _records.values():
            out[_qualname(rec.name, rec.labels)] = {
                "name": rec.name,
                "labels": dict(rec.labels),
                "count": rec.count,
                "total_ms": round(rec.total_ms, 3),
                "last_signature": rec.last_signature,
                "signatures": [dict(s) for s in rec.signatures],
            }
        return out


def reset_compiles():
    """Drop all compile records (tests)."""
    with _lock:
        _records.clear()
