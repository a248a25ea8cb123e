"""Runtime concurrency sanitizer — lock-order and guarded-state checks;
the port's copy of ``paddle_tpu/analysis/concurrency.py`` (the port
imports nothing of the JAX package).

The dynamic half of the serving concurrency plane (the static half is
:mod:`paddle_tpu_torch.analysis.lifecycle` /
``python3 -m paddle_tpu_torch.tools.lint_serving``). Two checks, both
gated by ``FLAGS_sanitize_locks`` and both zero-cost when the flag is
off:

- **Lock-order inversions.** :func:`make_lock` hands out plain
  ``threading.Lock``/``RLock`` objects normally, and
  :class:`SanitizedLock` wrappers under the flag. Each sanitized
  acquisition records directed edges *held lock -> acquired lock* into
  a process-wide order graph; an edge that closes a cycle is a
  potential deadlock (thread 1 takes A then B, thread 2 takes B then
  A) and is reported with the acquiring thread and its held-lock set.
  Inversions are *recorded*, never raised — the interleaving that
  witnesses the edge is usually not the one that deadlocks, so the
  soak asserts ``len(cycles()) == 0`` after the fact instead. Every
  outermost acquire also bumps the ``sanitizer_lock_acquires`` counter.

- **Guarded state.** :func:`declare_guarded` registers "attribute X of
  this object is only written under lock L" (mirroring the static
  ``# guarded-by: <lock>`` declarations the linter checks). Under the
  flag the object's class is swapped for a generated subclass whose
  ``__setattr__`` verifies the declared lock is held by the writing
  thread; a bare write records a violation and raises
  :class:`GuardedStateError`. Rebinding writes are what Python lets us
  intercept — ``self._completed += 1`` is caught, ``list.append`` is
  not (the static checker covers container mutators).

Besides the reference's serving and registry locks, the port's own
locks of the CUDA-graph machinery come from :func:`make_lock` too
(``jit._capture_lock``, each model's ``model_trace_lock`` and a
``HeldStep``'s own lock), so the order graph covers the locks a
replay and a capture take beside the engines'. A lock is sanitized
when it is made: the module-level ones (the capture lock, the metrics
registry) are made at import, so a process that wants them watched
sets ``FLAGS_sanitize_locks=1`` in its environment.

This module is intentionally stdlib-only at import time: sanitized
locks are created during package bootstrap (the metrics registry lock)
before ``paddle_tpu_torch.flags`` or the observability plane finish
loading, so both are resolved lazily at first use.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

__all__ = [
    "GuardedStateError", "SanitizedLock", "cycles", "declare_guarded",
    "enabled", "guards_of", "make_lock", "report", "reset",
    "sanitizer_report", "violations",
]

# ---------------------------------------------------------------- state

_tls = threading.local()            # .held: List[SanitizedLock]
_graph_lock = threading.Lock()      # guards everything below
_edges: Dict[int, Dict[int, dict]] = {}   # id(lock) -> id(lock) -> info
_names: Dict[int, str] = {}               # id(lock) -> display name
_cycles: List[dict] = []
_cycle_keys: set = set()
_violations: List[dict] = []
_acquires = 0                       # total sanitized first-acquisitions
_lock_seq = [0]                     # instance suffix for display names

_obs_counter = None                 # lazily bound observability Counter


def enabled() -> bool:
    """Whether ``FLAGS_sanitize_locks`` is on (False during the early
    bootstrap window before the flags module exists)."""
    try:
        from .. import flags as _flags
        return bool(_flags.get_flag("sanitize_locks"))
    except Exception:
        return False


def _held() -> list:
    held = getattr(_tls, "held", None)
    if held is None:
        held = _tls.held = []
    return held


def _bump_obs_counter():
    global _obs_counter
    if _obs_counter is None:
        try:
            from .. import observability as _obs
            _obs_counter = _obs.counter(
                "sanitizer_lock_acquires",
                "lock acquisitions instrumented by the concurrency "
                "sanitizer (FLAGS_sanitize_locks)")
        except Exception:
            return
    _obs_counter.add(1)


def _reaches(src: int, dst: int) -> Optional[List[int]]:
    """DFS under _graph_lock: a path src -> ... -> dst in the order
    graph, as a node list, or None."""
    stack = [(src, [src])]
    seen = {src}
    while stack:
        node, path = stack.pop()
        if node == dst:
            return path
        for nxt in _edges.get(node, ()):
            if nxt not in seen:
                seen.add(nxt)
                stack.append((nxt, path + [nxt]))
    return None


class SanitizedLock:
    """A ``threading.Lock``/``RLock`` that reports to the sanitizer.

    Same interface as the lock it wraps (``acquire``/``release``/
    context manager), plus :meth:`held_by_current_thread` for the
    guarded-state check. Reentrant re-acquisitions of an RLock are
    not re-instrumented — only the outermost acquire records edges.
    """

    def __init__(self, name: str, reentrant: bool = False):
        self._inner = (threading.RLock() if reentrant
                       else threading.Lock())
        self.reentrant = reentrant
        with _graph_lock:
            _lock_seq[0] += 1
            self.name = f"{name}#{_lock_seq[0]}"
            self.base_name = name
            _names[id(self)] = self.name
        self._owner: Optional[int] = None
        self._count = 0

    # ------------------------------------------------------- lock API
    def acquire(self, blocking: bool = True, timeout: float = -1):
        me = threading.get_ident()
        if self.reentrant and self._owner == me:
            got = self._inner.acquire(blocking, timeout)
            if got:
                self._count += 1
            return got
        got = self._inner.acquire(blocking, timeout)
        if got:
            self._owner = me
            self._count = 1
            self._note_acquired()
        return got

    def release(self):
        if self.reentrant and self._owner == threading.get_ident() \
                and self._count > 1:
            self._count -= 1
            self._inner.release()
            return
        self._owner = None
        self._count = 0
        held = _held()
        if self in held:
            held.remove(self)
        self._inner.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def locked(self) -> bool:
        if self.reentrant:
            return self._owner is not None
        return self._inner.locked()

    def held_by_current_thread(self) -> bool:
        return self._owner == threading.get_ident()

    # ------------------------------------------------- instrumentation
    def _note_acquired(self):
        global _acquires
        held = _held()
        with _graph_lock:
            _acquires += 1
            for prior in held:
                src, dst = id(prior), id(self)
                if src == dst:
                    continue
                bucket = _edges.setdefault(src, {})
                if dst in bucket:
                    continue
                back = _reaches(dst, src)
                if back is not None:
                    names = tuple(_names.get(n, "?") for n in back)
                    key = frozenset(n.split("#")[0] for n in names)
                    if key not in _cycle_keys:
                        _cycle_keys.add(key)
                        _cycles.append({
                            "locks": list(names) + [names[0]],
                            "edge": (prior.name, self.name),
                            "thread": threading.current_thread().name,
                            "held": [h.name for h in held],
                        })
                bucket[dst] = {"thread":
                               threading.current_thread().name}
        held.append(self)
        _bump_obs_counter()

    def __repr__(self):
        return f"<SanitizedLock {self.name} held={self.locked()}>"


def make_lock(name: str, reentrant: bool = False):
    """A lock for serving/observability state: plain (zero overhead)
    when ``FLAGS_sanitize_locks`` is off, a :class:`SanitizedLock`
    under the flag. ``name`` is the diagnostic label edges and cycle
    reports carry (e.g. ``"engine._lock"``)."""
    if not enabled():
        return threading.RLock() if reentrant else threading.Lock()
    return SanitizedLock(name, reentrant=reentrant)


# ------------------------------------------------------- guarded state

class GuardedStateError(RuntimeError):
    """A declared-guarded attribute was written without its lock."""


_guard_classes: Dict[type, type] = {}
_GUARDS_ATTR = "_sanitize_guards__"


def _guarded_setattr(self, name, value):
    guards = self.__dict__.get(_GUARDS_ATTR)
    if guards is not None:
        lk = guards.get(name)
        if lk is not None and not (
                isinstance(lk, SanitizedLock)
                and lk.held_by_current_thread()):
            lock_name = getattr(lk, "name", repr(lk))
            info = {
                "class": type(self).__name__,
                "attr": name,
                "lock": lock_name,
                "thread": threading.current_thread().name,
                "held": [h.name for h in _held()],
            }
            with _graph_lock:
                _violations.append(info)
            raise GuardedStateError(
                f"write to {type(self).__name__}.{name} without "
                f"holding its declared lock {lock_name} "
                f"(thread {info['thread']}, holding {info['held']})")
    object.__setattr__(self, name, value)


def declare_guarded(obj, guards: Dict[str, object]):
    """Register "these attributes of ``obj`` are only written under
    that lock". ``guards`` maps attribute name -> lock, where the lock
    is either the lock object itself or the name of an attribute on
    ``obj`` holding it (``{"_completed": "_lock"}``). No-op unless the
    sanitizer is enabled AND the resolved lock is sanitized (a plain
    lock can't answer "does this thread hold you"). Call it at the end
    of ``__init__`` — construction writes precede the declaration and
    are exempt by design."""
    if not enabled():
        return obj
    resolved: Dict[str, object] = {}
    for attr, lk in guards.items():
        if isinstance(lk, str):
            lk = getattr(obj, lk)
        if isinstance(lk, SanitizedLock):
            resolved[attr] = lk
    if not resolved:
        return obj
    existing = obj.__dict__.get(_GUARDS_ATTR)
    if existing is not None:
        existing.update(resolved)
        return obj
    object.__setattr__(obj, _GUARDS_ATTR, resolved)
    cls = type(obj)
    guard_cls = _guard_classes.get(cls)
    if guard_cls is None:
        guard_cls = type(cls.__name__, (cls,),
                         {"__setattr__": _guarded_setattr})
        _guard_classes[cls] = guard_cls
    object.__setattr__(obj, "__class__", guard_cls)
    return obj


def guards_of(obj) -> Dict[str, str]:
    """attr -> lock-name view of an object's dynamic declarations."""
    guards = obj.__dict__.get(_GUARDS_ATTR) or {}
    return {a: lk.name for a, lk in guards.items()}


# ------------------------------------------------------------ reporting

def cycles() -> List[dict]:
    """Lock-order inversions observed so far (deduped by the set of
    base lock names in the cycle)."""
    with _graph_lock:
        return [dict(c) for c in _cycles]


def violations() -> List[dict]:
    """Guarded-state writes observed without their declared lock."""
    with _graph_lock:
        return [dict(v) for v in _violations]


def report() -> dict:
    """One snapshot of everything the sanitizer knows — the soak and
    obs_smoke gates assert on this."""
    with _graph_lock:
        return {
            "enabled": enabled(),
            "lock_acquires": _acquires,
            "locks_tracked": len(_names),
            "order_edges": sum(len(v) for v in _edges.values()),
            "cycles": [dict(c) for c in _cycles],
            "violations": [dict(v) for v in _violations],
        }


#: package-level alias — ``analysis.sanitizer_report()`` reads better
#: than a bare ``report()`` next to the other checkers' entry points
sanitizer_report = report


def reset():
    """Drop the order graph, cycle/violation records and counters
    (test isolation; existing SanitizedLock objects keep working and
    re-register edges as they are used)."""
    global _acquires
    with _graph_lock:
        _edges.clear()
        _cycles.clear()
        _cycle_keys.clear()
        _violations.clear()
        _acquires = 0
