"""Structured run log — append-only JSONL event stream; a copy of
``paddle_tpu/observability/runlog.py``.

``log_event(kind, **fields)`` stamps each event with a process-wide
monotonically increasing sequence number, wall time, and a monotonic
clock reading, then appends one JSON line to
``FLAGS_runlog_dir/runlog-<pid>.jsonl``. Producers in the port: the
serving engine (admission / retirement / speculative acceptance /
megasteps / weight swaps), the replica router (routing, drains, kills,
restarts, autoscaling) and the fault injector (every firing).

When ``FLAGS_runlog_dir`` is empty (the default) nothing touches the
filesystem; the last few hundred events are still kept in an in-memory
ring (``recent()``) so tests and post-mortem debugging can see them.

Rotation is size-capped: once the active file exceeds
``FLAGS_runlog_max_mb`` it is renamed to ``<name>.1`` (replacing any
previous ``.1``) and a fresh file is started — worst case two caps of
disk per process, no matter how long the run.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Any, Deque, Dict, List, Optional

from .. import flags as _flags

_lock = threading.Lock()
_seq = 0
_ring: Deque[Dict[str, Any]] = collections.deque(maxlen=512)

# active file state: (directory the file was opened under, path, handle,
# bytes written so far) — reopened whenever FLAGS_runlog_dir changes
_open_dir: Optional[str] = None
_path: Optional[str] = None
_fh = None
_bytes = 0


def enabled() -> bool:
    """True when events are being persisted to disk."""
    return bool(_flags.get_flag("runlog_dir"))


def _ensure_open(directory: str):
    """Open (or re-open after a flag change / rotation) the JSONL file.
    Caller holds ``_lock``."""
    global _open_dir, _path, _fh, _bytes
    if _fh is not None and _open_dir == directory:
        return
    if _fh is not None:
        try:
            _fh.close()
        except OSError:
            pass
        _fh = None
    os.makedirs(directory, exist_ok=True)
    _open_dir = directory
    _path = os.path.join(directory, f"runlog-{os.getpid()}.jsonl")
    _fh = open(_path, "a", encoding="utf-8")
    _bytes = _fh.tell()


def _rotate_locked():
    """Rename the active file to ``.1`` and start fresh."""
    global _fh, _bytes
    if _fh is None or _path is None:
        return
    try:
        _fh.close()
    except OSError:
        pass
    try:
        os.replace(_path, _path + ".1")
    except OSError:
        pass
    _fh = open(_path, "a", encoding="utf-8")
    _bytes = 0


def log_event(kind: str, **fields) -> Dict[str, Any]:
    """Record one structured event; returns the event dict."""
    global _seq, _bytes
    directory = _flags.get_flag("runlog_dir")
    with _lock:
        _seq += 1
        event: Dict[str, Any] = {
            "seq": _seq,
            "ts": time.time(),
            "mono": time.monotonic(),
            "kind": str(kind),
        }
        event.update(fields)
        _ring.append(event)
        if not directory:
            return event
        try:
            _ensure_open(directory)
            line = json.dumps(event, default=str) + "\n"
            _fh.write(line)
            _fh.flush()
            _bytes += len(line)
            cap = float(_flags.get_flag("runlog_max_mb")) * 1e6
            if cap > 0 and _bytes > cap:
                _rotate_locked()
        except OSError:
            pass  # observability must never take down the workload
        return event


def recent(n: int = 100) -> List[Dict[str, Any]]:
    """Last ``n`` events (newest last), disk-backed or not."""
    with _lock:
        items = list(_ring)
    return items[-n:]


def current_path() -> Optional[str]:
    """Path of the active JSONL file, or None when not persisting."""
    with _lock:
        return _path if _fh is not None else None


def close():
    """Flush and close the active file (tests / interpreter exit)."""
    global _fh, _open_dir
    with _lock:
        if _fh is not None:
            try:
                _fh.close()
            except OSError:
                pass
            _fh = None
            _open_dir = None
