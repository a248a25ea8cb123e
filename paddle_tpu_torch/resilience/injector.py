"""Deterministic fault injection at named sites; a copy of
``paddle_tpu/resilience/injector.py``, so a spec parses and fires the
same in both packages (the site table lists the reference's sites,
those the port has not wired yet included).

A *fault spec* is a ``;``-separated list of rules::

    site:kind[@trigger]

    ps.rpc.call:drop@0.05        # drop 5% of PS calls (seeded RNG)
    exec.step:nan@17             # the 17th training step yields NaN
    ckpt.save:corrupt@2          # the 3rd save writes a corrupt archive
    fs.write:error               # every fs write op raises

The spec comes from ``FLAGS_fault_spec`` (so ``FLAGS_fault_spec=...`` in
the environment works like every other flag) or, if that is unset, the
``PADDLE_TPU_FAULT_SPEC`` environment variable. With neither set every
``fault_point`` call is a cheap no-op.

Triggers (all deterministic):

- absent        — fire on every call of the site
- ``@N`` (int)  — fire exactly on the N-th call of the site (0-based,
  counted per process since the spec was installed)
- ``@N+``       — fire on every call from the N-th on
- ``@p`` (float in (0, 1), written with a dot) — fire with probability
  p from a PRNG seeded by (``FLAGS_fault_seed``, site, rule index):
  the same spec + seed always drops the same calls in the same order.
- ``@t>Ns`` — fire exactly once, on the first evaluation after N
  seconds of injector time have elapsed (``@t>Ns+`` fires on every
  evaluation after). Injector time is read from the clock installed
  via :func:`set_time_source` — ``tools/soak.py`` installs its
  ``VirtualClock`` so a kill schedule like
  ``serving.replica:error@t>2400s`` replays byte-identically from a
  seed, hours of simulated fleet time in seconds. The epoch is
  snapshotted when the injector is built (``fault_scope`` entry), so
  triggers measure time *into the scenario*, not process uptime.

Kinds:

- ``drop``     — raise :class:`InjectedDrop` (a ``ConnectionResetError``),
  the connection-loss twin the PS retry layer must absorb
- ``error``    — raise :class:`InjectedIOError` (an ``OSError``)
- ``preempt``  — raise :class:`InjectedPreemption` (a ``SystemExit`` with
  a non-zero code: the in-process analog of a TPU preemption SIGTERM)
- ``kill``     — ``os._exit(FAULT_EXIT_CODE)``: hard process death, for
  ElasticManager restart tests (no unwinding, like a real preemption)
- ``nan``, ``corrupt``, ``skip`` — *returned* to the caller as a string;
  the site decides what a NaN batch / corrupt archive / skipped item
  means locally

Every fired fault increments ``STAT_fault_<site>`` via
:func:`paddle_tpu_torch.monitor.stat_add`.
"""

from __future__ import annotations

import os
import random
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from .. import flags as _flags
from .. import monitor as _monitor

# the sites wired through the tree (kept here so tests and the README
# generator enumerate the real surface, not a stale hand-written list)
FAULT_SITE_DOCS: Dict[str, str] = {
    "ps.rpc.call": "PSClient._call — one parameter-server RPC round "
                   "trip (idempotent ops retry through RetryPolicy)",
    "ps.server.start": "make_server native-toolchain probe (an "
                       "injected error forces the Python fallback)",
    "fs.write": "LocalFS/HDFSClient mutating operations (mkdirs, "
                "delete, rename, upload, ...)",
    "ckpt.save": "CheckpointSaver.save — `error` exercises the save "
                 "retry, `corrupt` publishes a broken archive for "
                 "load-fallback tests",
    "exec.step": "Executor.run — `nan` makes the step surface "
                 "NanInfError for TrainGuardian to absorb",
    "collective.allreduce": "distributed.collective.all_reduce — a "
                            "`drop` stands in for a transport hiccup",
    "dataloader.worker": "io.DataLoader background worker, per item "
                         "(injected faults retried; real errors "
                         "fail fast)",
    "serving.submit": "ServingEngine.submit admission — a raising kind "
                      "rejects that submission before it is queued "
                      "(the backpressure path); in-flight requests are "
                      "untouched",
    "serving.step": "ServingEngine scheduler, once per prefill attempt "
                    "and per decode attempt — drop/error are retried "
                    "via RetryPolicy (exhaustion sheds the affected "
                    "requests), `skip` sheds the request being "
                    "prefilled or skips one decode iteration",
    "serving.alloc": "BlockKVCache admission (paged serving), once per "
                     "block-table acquisition attempt — drop/error are "
                     "retried via RetryPolicy (exhaustion sheds that "
                     "request; blocks already taken are unwound, never "
                     "leaked), `skip` sheds the request as a simulated "
                     "allocator failure",
    "serving.route": "ReplicaRouter.submit, once per routing attempt — "
                     "drop/error are retried via RetryPolicy "
                     "(exhaustion sheds that submission as "
                     "QueueFullError backpressure), `skip` sheds it "
                     "immediately; requests already placed on a "
                     "replica are untouched",
    "serving.handoff": "DecodeEngine adoption of one prefill->decode "
                       "KV handoff record (disaggregated serving) — "
                       "drop/error are retried via RetryPolicy, "
                       "`skip` and retry exhaustion shed that request "
                       "with every block reference released (the "
                       "leak-free teardown the chaos suite asserts)",
    "serving.replica": "ReplicaRouter fleet supervisor, once per "
                       "router step — `error`/`drop` crash one replica "
                       "(round-robin victim) and restart it through "
                       "kill_replica/restart_replica with in-flight "
                       "work re-homed; `skip` kills without the "
                       "restart (permanent capacity loss). Pair with "
                       "@t>Ns virtual-time triggers for seeded soak "
                       "kill schedules",
    "serving.migrate": "TierManager device<->host block migration "
                       "(serving/kv_tier.py), once per demote/promote "
                       "attempt — drop/error are retried via "
                       "RetryPolicy, `skip` and retry exhaustion skip "
                       "that migration cleanly (a skipped demotion "
                       "leaves the chain on device, a skipped "
                       "promotion falls back to re-prefill; blocks "
                       "taken mid-attempt are unwound, never leaked)",
}
FAULT_SITES: Tuple[str, ...] = tuple(FAULT_SITE_DOCS)

FAULT_EXIT_CODE = 173  # what `kill` exits with (distinctive in waitpid)

_RAISING_KINDS = ("drop", "error", "preempt", "kill")
_RETURNED_KINDS = ("nan", "corrupt", "skip")


class InjectedFault(Exception):
    """Base of every injector-raised fault (lets retry layers opt in to
    'injected faults are always transient' without touching real
    error-class policy)."""


class InjectedDrop(InjectedFault, ConnectionResetError):
    """Injected connection loss — an OSError/ConnectionError, so it
    walks the exact except-clauses real drops walk."""


class InjectedIOError(InjectedFault, OSError):
    """Injected IO failure (fs write, checkpoint archive)."""


class InjectedPreemption(SystemExit):
    """Injected preemption: unwinds like SIGTERM-triggered SystemExit;
    a spawned worker dies with a non-zero exitcode."""

    def __init__(self, site: str):
        super().__init__(FAULT_EXIT_CODE)
        self.site = site


class _Rule:
    __slots__ = ("site", "kind", "trigger", "count", "rng", "time_fired")

    def __init__(self, site: str, kind: str, trigger, index: int,
                 seed: int):
        self.site = site
        self.kind = kind
        # None | int | (int, "+") | float | ("t>", seconds, ""|"+")
        self.trigger = trigger
        self.count = 0
        self.time_fired = False
        # per-rule stream: determinism survives rule reordering of
        # OTHER sites and doesn't couple unrelated probability draws
        self.rng = random.Random(f"{seed}:{site}:{index}:{kind}")

    def fires(self, elapsed: float = 0.0) -> bool:
        n = self.count
        self.count += 1
        t = self.trigger
        if t is None:
            return True
        if isinstance(t, float):
            return self.rng.random() < t
        if isinstance(t, tuple):
            if t[0] == "t>":
                if elapsed <= t[1]:
                    return False
                if t[2] == "+":
                    return True
                if self.time_fired:
                    return False
                self.time_fired = True
                return True
            return n >= t[0]
        return n == t


def _parse_trigger(text: str):
    if text.startswith("t>"):
        body = text[2:]
        plus = body.endswith("+")
        if plus:
            body = body[:-1]
        if not body.endswith("s") or len(body) < 2:
            raise ValueError(
                f"virtual-time trigger must look like t>300s or "
                f"t>300s+, got {text!r}")
        secs = float(body[:-1])
        if secs < 0:
            raise ValueError(
                f"virtual-time trigger must be >= 0 seconds, got "
                f"{text!r}")
        return ("t>", secs, "+" if plus else "")
    if text.endswith("+"):
        return (int(text[:-1]), "+")
    if "." in text:
        p = float(text)
        if not 0.0 < p < 1.0:
            raise ValueError(
                f"probability trigger must be in (0, 1), got {text!r}")
        return p
    return int(text)


def parse_spec(spec: str, seed: int = 0) -> Dict[str, List[_Rule]]:
    """Parse a fault spec into {site: [rules]} (grammar in the module
    docstring). Malformed rules fail loudly — a typo'd chaos spec that
    silently injects nothing would green-light broken recovery paths."""
    rules: Dict[str, List[_Rule]] = {}
    index = 0
    for clause in spec.split(";"):
        clause = clause.strip()
        if not clause:
            continue
        try:
            site, rest = clause.rsplit(":", 1)
            if "@" in rest:
                kind, trig = rest.split("@", 1)
                trigger = _parse_trigger(trig)
            else:
                kind, trigger = rest, None
        except ValueError as e:
            raise ValueError(
                f"malformed fault rule {clause!r} "
                f"(want site:kind[@trigger]): {e}") from None
        kind = kind.strip()
        if kind not in _RAISING_KINDS + _RETURNED_KINDS:
            raise ValueError(
                f"unknown fault kind {kind!r} in rule {clause!r} "
                f"(known: {sorted(_RAISING_KINDS + _RETURNED_KINDS)})")
        rules.setdefault(site.strip(), []).append(
            _Rule(site.strip(), kind, trigger, index, seed))
        index += 1
    return rules


# Clock behind @t>Ns triggers. Module-level (not per-injector) so a
# virtual clock installed by a harness survives the flag-version
# rebuilds of the process-wide injector. None = time.monotonic.
_time_source: Optional[Callable[[], float]] = None


def set_time_source(fn: Optional[Callable[[], float]]):
    """Install the clock @t>Ns triggers read (None restores
    time.monotonic). Install *before* entering fault_scope / calling
    reset() — the epoch is snapshotted when the injector is built."""
    global _time_source
    _time_source = fn


class FaultInjector:
    """Holds the parsed spec + per-site call counters. One process-wide
    instance behind :func:`fault_point`; tests construct their own or
    use :func:`fault_scope`."""

    def __init__(self, spec: str = "", seed: int = 0):
        self.spec = spec
        self.rules = parse_spec(spec, seed)
        self._lock = threading.Lock()
        self._now = _time_source or time.monotonic
        self._t0 = self._now()

    @property
    def active(self) -> bool:
        return bool(self.rules)

    def check(self, site: str) -> Optional[str]:
        """Evaluate the site; raise for raising kinds, return the kind
        string for caller-handled kinds, None when nothing fires."""
        site_rules = self.rules.get(site)
        if not site_rules:
            return None
        elapsed = self._now() - self._t0
        with self._lock:
            fired = [r.kind for r in site_rules if r.fires(elapsed)]
        from ..observability import runlog as _runlog
        for k in fired:
            _monitor.stat_add(f"STAT_fault_{site}")
            _runlog.log_event("fault_injected", site=site, fault_kind=k)
        if not fired:
            return None
        kind = fired[0]  # spec order breaks same-call ties
        if kind == "drop":
            raise InjectedDrop(f"injected connection drop at {site!r}")
        if kind == "error":
            raise InjectedIOError(f"injected IO error at {site!r}")
        if kind == "preempt":
            raise InjectedPreemption(site)
        if kind == "kill":
            os._exit(FAULT_EXIT_CODE)
        return kind  # nan / corrupt / skip


# -- process-wide injector, rebuilt when the flag plane changes ----------
_lock = threading.Lock()
_current: Optional[FaultInjector] = None
_current_key = None


def _spec_from_env() -> Tuple[str, int]:
    spec = _flags.get_flag("fault_spec") or \
        os.environ.get("PADDLE_TPU_FAULT_SPEC", "")
    return spec, int(_flags.get_flag("fault_seed"))


def _injector() -> FaultInjector:
    global _current, _current_key
    key = _flags.version()
    with _lock:
        if _current is None or _current_key != key:
            spec, seed = _spec_from_env()
            if _current is None or (spec, seed) != (
                    _current.spec, getattr(_current, "_seed", None)):
                _current = FaultInjector(spec, seed)
                _current._seed = seed  # type: ignore[attr-defined]
            _current_key = key
        return _current


def injector_active() -> bool:
    """Cheap predicate for hot paths that want to skip building retry
    scaffolding entirely when no spec is installed."""
    return _injector().active


def fault_point(site: str) -> Optional[str]:
    """The ONE hook call sites use. No-op (returns None) without a
    spec; otherwise evaluates the site's rules — raising kinds raise,
    ``nan``/``corrupt``/``skip`` come back as strings for the caller."""
    inj = _injector()
    if not inj.active:
        return None
    return inj.check(site)


def reset():
    """Drop the cached injector (tests; site counters restart at 0)."""
    global _current, _current_key
    with _lock:
        _current = None
        _current_key = None


class fault_scope:
    """``with fault_scope("exec.step:nan@3", seed=7): ...`` — install a
    spec for the duration of a test, restoring (and resetting counters)
    on exit. ``time_source`` optionally installs the clock @t>Ns
    triggers read for the scope (a soak passes its VirtualClock.now),
    restored alongside the spec."""

    def __init__(self, spec: str, seed: int = 0, time_source=None):
        self.spec = spec
        self.seed = seed
        self.time_source = time_source

    def __enter__(self):
        self._saved = {
            "fault_spec": _flags.get_flag("fault_spec"),
            "fault_seed": _flags.get_flag("fault_seed"),
        }
        self._saved_source = _time_source
        if self.time_source is not None:
            set_time_source(self.time_source)
        _flags.set_flags({"fault_spec": self.spec,
                          "fault_seed": self.seed})
        reset()
        return _injector()

    def __exit__(self, *exc):
        _flags.set_flags(self._saved)
        set_time_source(self._saved_source)
        reset()
        return False
