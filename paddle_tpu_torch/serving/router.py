"""ReplicaRouter — data parallelism across serving-engine replicas, the
counterpart of ``paddle_tpu/serving/router.py``.

N :class:`~paddle_tpu_torch.serving.engine.ServingEngine` replicas behind
one ``submit()`` front door (``FLAGS_serving_replicas``), each an
independent scheduler with its own KV pool and queue. The replicas share
one model object and therefore its step cache
(:func:`~paddle_tpu_torch.models.generation.step_entry`): one entry per
step kind for the fleet. On the card an entry keeps one CUDA graph per
replica, since a graph holds its replica's pools by address (the
reference compiles once for the fleet: a deliberate divergence); on the
CPU the entries count input signatures, one for the fleet, as the
reference's compiles.

Routing is least-loaded: a request lands on the replica minimizing
(health rank, queued + active requests, then the most free KV blocks,
then the lowest index). A replica whose queue is full is skipped; when
every replica is full the router sheds the submission with
:class:`~paddle_tpu_torch.serving.engine.QueueFullError`. Every routing
attempt passes the ``serving.route`` fault site through
``RetryPolicy.from_flags("serving.route")``. ``drain()`` stops admissions
and runs every replica to idle.

Supervision, as the reference's: a step that raises, or makes no
progress while its replica holds work, is a strike; one strike marks the
replica suspect, ``FLAGS_serving_replica_strikes`` dead, and a dead
replica is restarted (``FLAGS_serving_auto_restart``) or killed at the
step boundary. A per-replica circuit breaker trips on the failure rate
over ``FLAGS_serving_breaker_window`` steps. ``kill_replica`` re-homes
queued and in-flight requests onto live peers (in-flight ones with their
committed tokens and their sampling keys: the adopting peer re-prefills
``request.context``), then frees the killed replica's device memory: its
pools and the graphs captured over them. ``restart_replica`` puts a
same-geometry replacement in first. The ``serving.replica`` fault site
crashes one replica per router step. Autoscaling
(``FLAGS_serving_autoscale`` = "MIN:MAX" or an :class:`AutoscalePolicy`)
grows or retires replicas on the same load signals.

Threaded dispatch (``FLAGS_serving_dispatch_threads`` > 0): ``step()``
fans the replicas' steps over a bounded worker pool; every fleet-level
transition (reaping, autoscaling) stays on the caller's thread at the
step boundary. The workers step with the caller's capture mode (inside
``jit.no_capture()`` they capture nothing either). Every replica
enqueues its work on the one default stream, so their graphs, which
share the model's memory pool, never run at once; what overlaps is one
replica's host work with another's device work.

Not ported yet (ROADMAP queue A2): hedged prefill (``hedge_ms != 0``
raises NotImplementedError), ``cancel``, SLO attainment (no engine has
an SLO, so it reads None), LoRA tenants and the host KV tier (their
engine keywords raise NotImplementedError), tracing marks.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
from collections import deque
from typing import List, Optional, Sequence

from .. import flags as _flags
from .. import jit as _jit
from .. import monitor as _monitor
from .. import observability as _obs
from ..observability import runlog as _runlog
from ..resilience.injector import InjectedFault, fault_point
from ..resilience.retry import RetryError, RetryPolicy
from .engine import QueueFullError, Request, ServingEngine

#: per-replica health states (the serving_replica_state gauge family)
HEALTH_STATES = ("healthy", "suspect", "dead", "recovering")

#: routing preference per state: healthy/recovering route normally,
#: suspect only when nothing healthier has room, dead never
_HEALTH_RANK = {"healthy": 0, "recovering": 0, "suspect": 1, "dead": 2}

#: the reference's fleet-shared engine keywords (LoRA tenants, the host
#: KV tier), which the port does not have yet
_UNPORTED_KWARGS = ("lora_rank", "lora_pool", "kv_tier")


def _parse_autoscale(text: str):
    """'MIN:MAX' -> (min, max) replica bounds, None when empty."""
    text = str(text).strip()
    if not text:
        return None
    try:
        lo, hi = (int(p) for p in text.split(":"))
    except Exception:
        raise ValueError(
            f"serving_autoscale must be 'MIN:MAX', got {text!r}")
    if lo < 1 or hi < lo:
        raise ValueError(
            f"serving_autoscale bounds need 1 <= MIN <= MAX, got {text!r}")
    return lo, hi


class AutoscalePolicy:
    """Replica-count policy over the router's live load signals.

    ``decide(router)`` returns the target replica count, one step up
    or down at a time inside [min_replicas, max_replicas]:

    - scale UP when the mean (queued + active) per replica exceeds
      ``queue_high``, when the tightest replica's free KV-block
      fraction drops under ``kv_free_low``, or when aggregate SLO
      attainment falls under ``attainment_low`` while there is queued
      work;
    - scale DOWN when the mean depth sits under ``queue_low`` and
      attainment (if measured) is healthy.

    The router applies decisions at most once per ``cooldown_steps``
    scheduler iterations, and drains a retiring replica before
    dropping it: scale-down never sheds in-flight work.
    """

    def __init__(self, min_replicas: int = 1, max_replicas: int = 4,
                 queue_high: float = 4.0, queue_low: float = 1.0,
                 kv_free_low: float = 0.1,
                 attainment_low: float = 0.95,
                 cooldown_steps: int = 20):
        if min_replicas < 1 or max_replicas < min_replicas:
            raise ValueError(
                "AutoscalePolicy needs 1 <= min_replicas <= "
                f"max_replicas, got {min_replicas}..{max_replicas}")
        if queue_low > queue_high:
            raise ValueError("queue_low must be <= queue_high")
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.queue_high = float(queue_high)
        self.queue_low = float(queue_low)
        self.kv_free_low = float(kv_free_low)
        self.attainment_low = float(attainment_low)
        self.cooldown_steps = int(cooldown_steps)

    def decide(self, router: "ReplicaRouter") -> int:
        n = len(router.engines)
        depths = [router._depth(e) for e in router.engines]
        mean_depth = sum(depths) / n
        free_frac = min(
            (router._blocks_free(e) / max(1, e.cache.num_blocks)
             if e.paged else
             router._blocks_free(e) / max(1, e.max_slots))
            for e in router.engines)
        att = router._slo_attainment()
        pressured = (mean_depth > self.queue_high or
                     free_frac < self.kv_free_low or
                     (att is not None and att < self.attainment_low
                      and mean_depth > self.queue_low))
        if pressured and n < self.max_replicas:
            return n + 1
        if (mean_depth < self.queue_low and n > self.min_replicas and
                (att is None or att >= self.attainment_low)):
            return n - 1
        return n


def _in_mode(eager: bool, fn, *args):
    """``fn(*args)`` in a worker thread, with the submitting thread's
    capture mode (``jit.no_capture`` is per thread)."""
    with _jit.no_capture() if eager else contextlib.nullcontext():
        return fn(*args)


class ReplicaRouter:
    """Spread ``submit()`` over N data-parallel
    :class:`~paddle_tpu_torch.serving.engine.ServingEngine` replicas.

    Either pass prebuilt ``engines``, or a ``model`` plus ``n_replicas``
    (default ``FLAGS_serving_replicas``) and any ServingEngine
    constructor keywords, which every replica shares (``device`` among
    them: None means CUDA). The replicas share the model, and with it the
    step cache.
    """

    _router_ids = itertools.count()

    def __init__(self, model=None, n_replicas: Optional[int] = None,
                 engines: Optional[Sequence[ServingEngine]] = None,
                 autoscale=None, hedge_ms: Optional[float] = None,
                 hedge_budget: Optional[float] = None,
                 dispatch_threads: Optional[int] = None,
                 **engine_kwargs):
        g = _flags.get_flags(["serving_replicas", "serving_autoscale",
                              "serving_replica_strikes",
                              "serving_auto_restart",
                              "serving_hedge_ms",
                              "serving_hedge_budget",
                              "serving_breaker_window",
                              "serving_breaker_threshold",
                              "serving_breaker_cooldown_s",
                              "serving_dispatch_threads"])
        self._strike_limit = max(1, int(g["serving_replica_strikes"]))
        self._auto_restart = bool(g["serving_auto_restart"])
        self._hedge_ms = float(hedge_ms if hedge_ms is not None
                               else g["serving_hedge_ms"])
        hedge_budget = float(hedge_budget if hedge_budget is not None
                             else g["serving_hedge_budget"])
        if hedge_budget < 0:
            raise ValueError(
                f"serving_hedge_budget must be >= 0, got {hedge_budget}")
        if self._hedge_ms != 0.0:
            raise NotImplementedError(
                "hedged prefill (FLAGS_serving_hedge_ms != 0) is not "
                "ported yet")
        unported = [k for k in _UNPORTED_KWARGS
                    if engine_kwargs.get(k) not in (None, 0)]
        if unported:
            raise NotImplementedError(
                f"engine keywords {unported} (LoRA tenants, the host KV "
                "tier) are not ported yet")
        # per-replica circuit breaker config (0 window disables)
        self._brk_window_n = max(0, int(g["serving_breaker_window"]))
        self._brk_threshold = float(g["serving_breaker_threshold"])
        self._brk_cooldown = float(g["serving_breaker_cooldown_s"])
        # threaded replica dispatch (0 = the serial loop): per-replica
        # health and breaker state is only touched by the one worker
        # stepping that replica; reaping and autoscaling stay on the
        # caller's thread at the step boundary
        self._dispatch_threads = int(
            dispatch_threads if dispatch_threads is not None
            else g["serving_dispatch_threads"])
        if self._dispatch_threads < 0:
            raise ValueError(
                "dispatch_threads must be >= 0, got "
                f"{self._dispatch_threads}")
        self._step_pool = None   # lazily-built ThreadPoolExecutor
        if autoscale is None:
            bounds = _parse_autoscale(g["serving_autoscale"])
            if bounds is not None:
                autoscale = AutoscalePolicy(min_replicas=bounds[0],
                                            max_replicas=bounds[1])
        self._autoscale: Optional[AutoscalePolicy] = autoscale
        self._model = model
        self._engine_kwargs = dict(engine_kwargs)
        if engines is not None:
            if model is not None or engine_kwargs:
                raise ValueError(
                    "pass either prebuilt engines= or model= + engine "
                    "kwargs, not both")
            if autoscale is not None:
                raise ValueError(
                    "autoscaling needs model= construction (the router "
                    "builds scale-up replicas itself); prebuilt "
                    "engines= cannot autoscale")
            self.engines: List[ServingEngine] = list(engines)
            if not self.engines:
                raise ValueError("engines must be non-empty")
        else:
            if model is None:
                raise ValueError("ReplicaRouter needs model= or engines=")
            n = int(n_replicas if n_replicas is not None
                    else g["serving_replicas"])
            if n < 1:
                raise ValueError(f"n_replicas must be >= 1, got {n}")
            if autoscale is not None:
                n = min(max(n, autoscale.min_replicas),
                        autoscale.max_replicas)
            self.engines = [ServingEngine(model, **self._engine_kwargs)
                            for _ in range(n)]
        self._draining = False              # guarded-by: _lock
        self._lock = threading.Lock()
        self._retiring: List[ServingEngine] = []  # guarded-by: _lock
        self._scale_ups = 0                 # guarded-by: _lock
        self._scale_downs = 0               # guarded-by: _lock
        self._steps_since_scale = 0         # guarded-by: _lock
        self._kills = 0                     # guarded-by: _lock
        self._restarts = 0                  # guarded-by: _lock
        self._rehomed = 0                   # guarded-by: _lock
        self._victim_rr = 0                 # guarded-by: _lock
        rid = str(next(ReplicaRouter._router_ids))
        self._rid = rid
        for eng in self.engines:
            self._init_health(eng)
        self._rehomed_counter = _obs.counter(
            "serving_rehomed_total",
            "requests recovered off a killed replica onto a live peer"
            ).labels(router=rid)
        self._replicas_gauge = _obs.gauge(
            "serving_replicas",
            "data-parallel engine replicas behind this ReplicaRouter"
            ).labels(router=rid)
        self._replicas_gauge.set(len(self.engines))
        self._depth_gauges = []
        self._update_depth_gauges()
        self._update_state_gauges()

    # ------------------------------------------------------------ health
    def _init_health(self, eng: ServingEngine):
        eng._health = "healthy"
        eng._strikes = 0
        # circuit-breaker state rides the engine like _health/_strikes:
        # a rolling window of step outcomes, tripping on error RATE
        eng._brk_window = deque(maxlen=max(1, self._brk_window_n))
        eng._brk_state = "closed"
        eng._brk_opened_at = 0.0

    def _update_state_gauges(self):
        for i, eng in enumerate(self.engines):
            for state in HEALTH_STATES:
                _obs.gauge(
                    "serving_replica_state",
                    "1 on a replica's current health-state series "
                    "(healthy | suspect | dead | recovering)"
                    ).labels(router=self._rid, replica=str(i),
                             state=state).set(
                        1 if eng._health == state else 0)
            if self._brk_window_n > 0:
                _obs.gauge(
                    "serving_breaker_state",
                    "per-replica circuit breaker: 0 closed, 1 open "
                    "(error rate tripped; replica skipped by routing), "
                    "0.5 half-open (one probe admitted)"
                    ).labels(router=self._rid, replica=str(i)).set(
                        {"closed": 0.0, "open": 1.0,
                         "half-open": 0.5}[eng._brk_state])

    def _step_replica(self, eng: ServingEngine) -> bool:
        """One supervised step: an exception, or no progress while the
        replica holds work, is a strike; strikes mark it suspect and, at
        FLAGS_serving_replica_strikes, dead. A productive step clears
        the strikes (and graduates a recovering replacement to
        healthy)."""
        try:
            worked = eng.step()
        except Exception:
            worked = False
            eng._strikes += 1
            self._note_breaker(eng, False)
        else:
            if worked:
                eng._strikes = 0
                if eng._health in ("suspect", "recovering"):
                    eng._health = "healthy"
                self._note_breaker(eng, True)
            elif self._depth(eng) > 0:
                eng._strikes += 1
                self._note_breaker(eng, False)
        if eng._strikes >= self._strike_limit:
            eng._health = "dead"
        elif eng._strikes >= 1 and eng._health == "healthy":
            eng._health = "suspect"
        return worked

    def _note_breaker(self, eng: ServingEngine, ok: bool):
        """Feed one step outcome into the replica's breaker window.
        Closed: trips open when the windowed failure rate reaches
        FLAGS_serving_breaker_threshold with at least half the window
        observed. Open: cools down FLAGS_serving_breaker_cooldown_s of
        engine-clock time, then half-opens. Half-open: one probe;
        success closes (window reset), failure re-opens."""
        if self._brk_window_n <= 0:
            return
        now = eng._clock()
        if eng._brk_state == "open":
            if now - eng._brk_opened_at >= self._brk_cooldown:
                eng._brk_state = "half-open"
            return
        if eng._brk_state == "half-open":
            if ok:
                eng._brk_state = "closed"
                eng._brk_window.clear()
            else:
                eng._brk_state = "open"
                eng._brk_opened_at = now
            return
        w = eng._brk_window
        w.append(bool(ok))
        if len(w) >= max(1, self._brk_window_n // 2):
            rate = 1.0 - sum(w) / len(w)
            if rate >= self._brk_threshold:
                eng._brk_state = "open"
                eng._brk_opened_at = now

    def _reap_dead(self):
        """Tear down replicas the watchdog declared dead: restart them
        under FLAGS_serving_auto_restart (model= construction), kill
        them outright otherwise. The last replica is never torn down
        without a replacement."""
        for eng in [e for e in list(self.engines)
                    if e._health == "dead"]:
            if eng not in self.engines:
                continue
            idx = self.engines.index(eng)
            if self._auto_restart and self._model is not None:
                self.restart_replica(idx, cause="strikes")
            elif len(self.engines) > 1:
                self.kill_replica(idx, cause="strikes")
            else:
                # can't restart (prebuilt engines) and can't lose the
                # last replica: put it back on probation
                eng._strikes = 0
                eng._health = "suspect"

    def _check_replica_fault(self):
        """The serving.replica fault site, once per router step:
        `error`/`drop` crash one replica (round-robin victim) and
        recover it per the auto-restart policy; `skip` kills without
        restart (permanent capacity loss, bounded at one replica)."""
        action = None
        try:
            if fault_point("serving.replica") == "skip":
                action = "kill"
        except InjectedFault:
            action = "crash"
        if action is None:
            return
        with self._lock:
            victim = self._victim_rr % len(self.engines)
            self._victim_rr += 1
        if action == "crash" and self._auto_restart and \
                self._model is not None:
            self.restart_replica(victim, cause="fault")
        elif len(self.engines) > 1:
            self.kill_replica(victim, cause="fault")

    # ----------------------------------------------------------- routing
    def _depth(self, eng: ServingEngine) -> int:
        with eng._lock:
            return len(eng._queue) + len(eng._active)

    def _blocks_free(self, eng: ServingEngine) -> int:
        return (eng.cache.blocks_free if eng.paged
                else eng.cache.num_free)

    def _shed_total(self, eng: ServingEngine) -> int:
        with eng._lock:
            return sum(eng._shed_by_reason.values())

    def _slo_attainment(self) -> Optional[float]:
        """Aggregate goodput fraction over replicas running with a
        TTFT SLO: sum(slo_met) / sum(completed). None when no replica
        has an SLO (always, until SLO admission is ported) or nothing
        completed yet."""
        met = done = 0
        for eng in self.engines + self._retiring:
            if not eng.slo_ttft_ms:
                continue
            with eng._lock:
                met += eng._slo_met
                done += eng._completed
        return (met / done) if done else None

    def _update_depth_gauges(self):
        while len(self._depth_gauges) < len(self.engines):
            self._depth_gauges.append(_obs.gauge(
                "serving_queue_depth",
                "requests queued + active on one routed engine replica"
                ).labels(router=self._rid,
                         replica=str(len(self._depth_gauges))))
        for g, eng in zip(self._depth_gauges, self.engines):
            g.set(self._depth(eng))
        for g in self._depth_gauges[len(self.engines):]:
            g.set(0)

    def _route_attempt(self, prompt, max_new_tokens, eos_token_id,
                       priority, _log_request=True,
                       **decode_kwargs) -> Request:
        kind = fault_point("serving.route")
        if kind == "skip":
            _monitor.stat_add("STAT_serving_route_shed")
            raise QueueFullError(
                "submission shed by injected fault at serving.route",
                reason="fault")
        # least-loaded among the healthiest: health rank first (suspect
        # replicas only catch overflow, dead ones are skipped below),
        # then queue depth, free KV blocks as the tiebreak, lowest index
        # last for determinism
        order = sorted(
            range(len(self.engines)),
            key=lambda i: (_HEALTH_RANK[self.engines[i]._health],
                           self._depth(self.engines[i]),
                           -self._blocks_free(self.engines[i]), i))
        last_err: Optional[QueueFullError] = None
        for i in order:
            eng = self.engines[i]
            if eng._health == "dead":
                last_err = QueueFullError(
                    f"replica {i} is dead", reason="fault")
                continue
            if eng.draining:
                # skipping a draining replica re-routes the request to a
                # peer with capacity instead of dropping it
                last_err = QueueFullError(
                    f"replica {i} is draining", reason="drain")
                continue
            if eng._brk_state == "open":
                # breaker tripped on error rate: skipped until the
                # cooldown half-opens it (half-open admits this request
                # as the probe)
                last_err = QueueFullError(
                    f"replica {i} breaker is open", reason="fault")
                continue
            try:
                req = eng.submit(prompt, max_new_tokens=max_new_tokens,
                                 eos_token_id=eos_token_id,
                                 priority=priority,
                                 _log_request=_log_request,
                                 **decode_kwargs)
            except QueueFullError as e:
                last_err = e
                continue
            req._routed_to = eng
            _monitor.stat_add("STAT_serving_routed")
            _runlog.log_event("serving_route", request=req.id,
                              replica=i, depth=self._depth(eng),
                              kv_blocks_free=self._blocks_free(eng))
            self._depth_gauges[i].set(self._depth(eng))
            return req
        _monitor.stat_add("STAT_serving_route_shed")
        raise last_err if last_err is not None else QueueFullError(
            "every replica queue is full")

    def submit(self, prompt: Sequence[int],
               max_new_tokens: Optional[int] = None,
               eos_token_id: Optional[int] = None,
               priority: Optional[int] = None,
               _log_request: bool = True, **decode_kwargs) -> Request:
        """Route one request to the least-loaded replica; returns its
        :class:`Request` handle. The per-request decoding fields
        (``temperature``/``top_k``/``top_p``/``stop``/``seed``) pass
        through to the chosen engine's ``submit``; ``priority`` too, which
        raises NotImplementedError there until priorities are ported.
        Raises QueueFullError when every replica sheds (or the router is
        draining) and ValueError for geometry no replica can hold."""
        with self._lock:
            if self._draining:
                raise QueueFullError("router is draining: submissions "
                                     "are shed for rolling shutdown",
                                     reason="drain")
        try:
            return RetryPolicy.from_flags("serving.route").call(
                self._route_attempt, prompt, max_new_tokens,
                eos_token_id, priority, _log_request, **decode_kwargs)
        except RetryError as e:
            _monitor.stat_add("STAT_serving_route_shed")
            raise QueueFullError(
                f"routing retries exhausted: {e}", reason="fault") from e

    # -------------------------------------------------------- autoscale
    def _add_replica(self):  # holds: _lock
        eng = ServingEngine(self._model, **self._engine_kwargs)
        self._init_health(eng)
        self.engines.append(eng)

    def _maybe_autoscale(self):
        """Apply one cooldown-limited policy decision: grow the set on
        pressure, or move the emptiest replica to the retiring list
        (it keeps stepping, receives no routes, and drops once idle:
        in-flight work is never shed by scale-down)."""
        with self._lock:
            for eng in list(self._retiring):
                if eng.idle:
                    self._retiring.remove(eng)
            self._steps_since_scale += 1
            if self._steps_since_scale < self._autoscale.cooldown_steps:
                return
            n = len(self.engines)
            target = self._autoscale.decide(self)
            if target == n:
                return
            if target > n:
                for _ in range(target - n):
                    self._add_replica()
                self._scale_ups += 1
                _monitor.stat_add("STAT_serving_autoscale_up")
            else:
                idx = min(range(n),
                          key=lambda i: (self._depth(self.engines[i]), i))
                self._retiring.append(self.engines.pop(idx))
                self._scale_downs += 1
                _monitor.stat_add("STAT_serving_autoscale_down")
            self._steps_since_scale = 0
            replicas_to = len(self.engines)
            retiring = len(self._retiring)
        self._replicas_gauge.set(replicas_to)
        _runlog.log_event("serving_autoscale", replicas_from=n,
                          replicas_to=replicas_to,
                          retiring=retiring)

    # ---------------------------------------------------------- stepping
    def _dispatch_pool(self):
        """The persistent bounded worker pool for threaded dispatch,
        built on first use and shut down by :meth:`stop`."""
        if self._step_pool is None:
            from concurrent.futures import ThreadPoolExecutor
            self._step_pool = ThreadPoolExecutor(
                max_workers=self._dispatch_threads,
                thread_name_prefix=f"router{self._rid}-dispatch")
        return self._step_pool

    def step(self) -> bool:
        """One scheduler iteration on every replica (retiring ones
        included, so scale-down drains rather than sheds) under the
        strike watchdog, then one autoscale decision. Returns whether
        any replica worked.

        With ``FLAGS_serving_dispatch_threads`` > 0 (or the
        ``dispatch_threads=`` constructor override) the per-replica
        steps run concurrently from a bounded worker pool, in the
        caller's capture mode; the barrier at the end of the fan-out
        keeps every fleet-level transition at the step boundary, where
        the serial loop applies them."""
        self._check_replica_fault()
        worked = False
        if self._dispatch_threads > 0:
            pool = self._dispatch_pool()
            eager = not _jit.capture_enabled()
            futs = [pool.submit(_in_mode, eager, self._step_replica, eng)
                    for eng in list(self.engines)]
            futs += [pool.submit(_in_mode, eager, eng.step)
                     for eng in list(self._retiring)]
            err = None
            for f in futs:
                try:
                    worked = bool(f.result()) or worked
                except Exception as e:   # match serial: first raiser
                    err = err or e       # propagates after the barrier
            self._reap_dead()
            if err is not None:
                raise err
        else:
            for eng in list(self.engines):
                if eng in self.engines:  # not torn down this iteration
                    worked = self._step_replica(eng) or worked
            self._reap_dead()
            for eng in list(self._retiring):
                worked = eng.step() or worked
        if self._autoscale is not None:
            self._maybe_autoscale()
        self._update_depth_gauges()
        self._update_state_gauges()
        return worked

    @property
    def idle(self) -> bool:
        return all(eng.idle
                   for eng in list(self.engines) + list(self._retiring))

    def run_until_idle(self, max_steps: int = 10_000) -> int:
        steps = 0
        while not self.idle:
            self.step()
            steps += 1
            if steps >= max_steps:
                raise RuntimeError(
                    f"router not idle after {max_steps} steps")
        self._update_depth_gauges()
        return steps

    def drain(self, max_steps: int = 10_000) -> int:
        """Stop admissions and run every replica to idle (rolling
        deploy / shutdown). Later ``submit()`` calls shed with
        QueueFullError; already-queued requests finish unless their own
        admission sheds them on the way down. Returns how many requests
        were shed while draining (also ``STAT_serving_drain_shed``)."""
        with self._lock:
            self._draining = True
        engines = list(self.engines) + list(self._retiring)
        before = sum(self._shed_total(e) for e in engines)
        _runlog.log_event("serving_drain",
                          replicas=len(self.engines),
                          queued=[self._depth(e) for e in engines])
        self.run_until_idle(max_steps)
        _monitor.stat_add("STAT_serving_drained")
        shed = sum(self._shed_total(e) for e in engines) - before
        if shed:
            _monitor.stat_add("STAT_serving_drain_shed", shed)
        _runlog.log_event("serving_drain_done", shed=shed)
        return shed

    def _rehome_queued(self, src: ServingEngine,
                       peers: Sequence[ServingEngine]) -> int:
        """Move ``src``'s still-queued requests onto the least-loaded
        live peers via ``adopt_request``; requests no peer can take are
        shed (reason "drain") through ``src``. Returns how many were
        re-homed."""
        moved = 0
        for req in src.take_queued():
            placed = False
            for peer in sorted(
                    (p for p in peers if not p.draining),
                    key=lambda p: (self._depth(p),
                                   -self._blocks_free(p))):
                if peer.adopt_request(req):
                    placed = True
                    moved += 1
                    _monitor.stat_add("STAT_serving_rerouted")
                    break
            if not placed:
                src._shed(req, QueueFullError(
                    "no live replica could adopt the request during "
                    "drain", reason="drain"), reason="drain")
        return moved

    def drain_replica(self, index: int) -> int:
        """Drain ONE replica out of the set: it stops receiving routes
        and submissions, its queued requests are re-routed onto live
        peers (shed, reason "drain", only when no peer can take them),
        and it moves to the retiring list where it keeps stepping until
        its in-flight work finishes. Returns how many queued requests
        were re-homed."""
        with self._lock:
            if not 0 <= index < len(self.engines):
                raise IndexError(
                    f"replica index {index} out of range "
                    f"(have {len(self.engines)})")
            if len(self.engines) == 1:
                raise ValueError(
                    "cannot drain the last replica; use drain() for "
                    "full shutdown")
            eng = self.engines.pop(index)
            eng.draining = True
            self._retiring.append(eng)
        moved = self._rehome_queued(eng, self.engines)
        self._replicas_gauge.set(len(self.engines))
        self._update_depth_gauges()
        _runlog.log_event("serving_drain_replica", replica=index,
                          rerouted=moved,
                          replicas_left=len(self.engines))
        return moved

    def kill_replica(self, index: int, cause: str = "kill") -> dict:
        """Crash ONE replica: unlike :meth:`drain_replica` it does not
        finish its in-flight work. Under its step lock its rows are
        released, its in-flight requests requeued with their committed
        tokens and sampling keys and its queue taken; each then re-homes
        onto the least-loaded live peer, which re-prefills
        ``request.context`` and continues token-identically (greedy) or
        from the same key (sampled), or is shed when no peer can adopt
        it. Every recovered request is marked ``rehomed``. Then the
        replica's device memory is freed (its pools and the step graphs
        captured over them); its host book-keeping stays in the retiring
        list. Returns ``{"rehomed", "shed", "replicas_left"}``."""
        with self._lock:
            if not 0 <= index < len(self.engines):
                raise IndexError(
                    f"replica index {index} out of range "
                    f"(have {len(self.engines)})")
            if len(self.engines) == 1:
                raise ValueError(
                    "cannot kill the last replica; restart_replica "
                    "replaces one in place")
            eng = self.engines.pop(index)
            eng.draining = True
            eng._health = "dead"
            self._retiring.append(eng)
        displaced: List[Request] = []
        with eng._step_lock:
            for row, req in sorted(eng._active.items(),
                                   key=lambda kv: kv[1].id):
                del eng._active[row]
                eng.cache.release(row)
                req.state = "queued"
                req.slot = None
                displaced.append(req)
            # taken under the step lock too, so a background thread
            # stepping this engine admits nothing after the strip
            queued = eng.take_queued()
        rehomed = shed = 0
        for req in sorted(displaced + queued, key=lambda r: r.id):
            placed = False
            for peer in sorted(
                    (p for p in self.engines
                     if not p.draining and p._health != "dead"),
                    key=lambda p: (self._depth(p),
                                   -self._blocks_free(p))):
                if peer.adopt_request(req):
                    placed = True
                    break
            if placed:
                req.rehomed = True
                rehomed += 1
                _monitor.stat_add("STAT_serving_rehomed")
                self._rehomed_counter.inc()
            else:
                eng._shed(req, QueueFullError(
                    "no live replica could adopt the request after "
                    f"replica {index} was killed", reason="drain"),
                    reason="drain")
                shed += 1
        # the dead replica's prefix cache holds block refs on its pool;
        # drop them, then the pool itself and every graph over it
        with eng._step_lock:
            if eng.paged:
                eng.cache.flush_prefix_cache()
            eng._release_device()
        with self._lock:
            self._kills += 1
            self._rehomed += rehomed
        _monitor.stat_add("STAT_serving_replica_killed")
        self._replicas_gauge.set(len(self.engines))
        self._update_depth_gauges()
        self._update_state_gauges()
        _runlog.log_event("serving_replica_kill", replica=index,
                          cause=cause, t=round(eng._clock(), 6),
                          rehomed=rehomed, shed=shed,
                          replicas_left=len(self.engines))
        return {"rehomed": rehomed, "shed": shed,
                "replicas_left": len(self.engines)}

    def restart_replica(self, index: int, cause: str = "restart"
                        ) -> dict:
        """Replace replica ``index`` with a fresh same-geometry engine:
        the replacement (state ``recovering``, healthy on its first
        productive step) joins the set *before* the old replica is
        killed, so re-homed work can land on it immediately and even a
        sole replica can be restarted. Returns :meth:`kill_replica`'s
        accounting dict."""
        if self._model is None:
            raise ValueError(
                "restart_replica needs model= construction (prebuilt "
                "engines= routers cannot build replacements)")
        replacement = ServingEngine(self._model, **self._engine_kwargs)
        self._init_health(replacement)
        replacement._health = "recovering"
        with self._lock:
            if not 0 <= index < len(self.engines):
                raise IndexError(
                    f"replica index {index} out of range "
                    f"(have {len(self.engines)})")
            self.engines.insert(index + 1, replacement)
        info = self.kill_replica(index, cause=cause)
        with self._lock:
            self._restarts += 1
            restarts = self._restarts
        _monitor.stat_add("STAT_serving_replica_restarted")
        _runlog.log_event("serving_replica_recover", replica=index,
                          t=round(replacement._clock(), 6),
                          restarts=restarts)
        return info

    def swap_weights(self, state, *, reset_costs: bool = True
                     ) -> List[int]:
        """Rolling weight hot-swap across the fleet: every replica
        (retiring ones included) swaps in turn via
        ``ServingEngine.swap_weights``, each under its own step lock,
        with the others serving throughout. The replicas share one
        model, so the first swap already gives every replica's next
        replay the new weights; each later one copies the same values
        and bumps that replica's version. Returns the per-replica
        versions after the swap."""
        with self._lock:
            engines = list(self.engines) + list(self._retiring)
        return [eng.swap_weights(state, reset_costs=reset_costs)
                for eng in engines]

    def results(self, reqs=None, timeout: Optional[float] = None
                ) -> List[Request]:
        """Wait for requests across all replicas, submission order."""
        if reqs is not None:
            out = list(reqs)
        else:
            # a re-homed request lives in both the drained source's and
            # the adopting peer's book-keeping: dedupe by request id
            seen: dict = {}
            for eng in self.engines + self._retiring:
                for r in eng.results(timeout=timeout):
                    seen.setdefault(r.id, r)
            return sorted(seen.values(), key=lambda r: r.id)
        for r in out:
            if not r.wait(timeout):
                raise TimeoutError(
                    f"request {r.id} not finished within {timeout}s")
        return out

    def start(self):
        """Every replica on its own background thread (``ServingEngine
        .start``), in the caller's capture mode."""
        for eng in self.engines:
            eng.start()

    def stop(self):
        for eng in self.engines + self._retiring:
            eng.stop()
        if self._step_pool is not None:
            self._step_pool.shutdown(wait=True)
            self._step_pool = None

    def stats(self) -> dict:
        """Router-level view: replica count, per-replica queue depths
        and free KV blocks, health, kill/restart/re-home counts,
        aggregate goodput and shed counters across replicas, the
        autoscale posture when enabled, and each replica's ``stats()``
        under ``per_replica``. ``mesh_shape`` is None: the port's
        engines run on one device."""
        with self._lock:
            live = list(self.engines)
            retiring = list(self._retiring)
            draining = self._draining
            kills = self._kills
            restarts = self._restarts
            rehomed = self._rehomed
            scale_ups = self._scale_ups
            scale_downs = self._scale_downs
        engines = live + retiring
        depths = [self._depth(e) for e in live]
        shed: dict = {}
        canceled: dict = {}
        completed = slo_met = 0
        tenants: dict = {}
        for e in engines:
            with e._lock:
                completed += e._completed
                slo_met += e._slo_met
                for k, v in e._shed_by_reason.items():
                    shed[k] = shed.get(k, 0) + v
                for k, v in e._canceled_by_reason.items():
                    canceled[k] = canceled.get(k, 0) + v
                for name, (c, el, m) in e._tenant_stats.items():
                    t = tenants.setdefault(name, [0, 0, 0])
                    t[0] += c
                    t[1] += el
                    t[2] += m
        out = {
            "replicas": len(live),
            "draining": draining,
            "mesh_shape": None,
            "queue_depths": depths,
            "kv_blocks_free": [self._blocks_free(e) for e in live],
            "health": [e._health for e in live],
            "kills": kills,
            "restarts": restarts,
            "rehomed": rehomed,
            "completed": completed,
            "slo_met": slo_met,
            "slo_attainment": self._slo_attainment(),
            "shed": shed,
            "shed_total": sum(shed.values()),
            "canceled": canceled,
            "canceled_total": sum(canceled.values()),
            "per_replica": [e.stats() for e in live],
        }
        if self._dispatch_threads > 0:
            out["dispatch_threads"] = self._dispatch_threads
        if self._brk_window_n > 0:
            out["breaker"] = [e._brk_state for e in live]
        if tenants:
            out["tenants"] = {
                name: {"completed": c,
                       "slo_met": m,
                       "slo_attainment": (round(m / e, 4) if e
                                          else None)}
                for name, (c, e, m) in sorted(tenants.items())}
        if self._autoscale is not None:
            out["autoscale"] = {
                "min_replicas": self._autoscale.min_replicas,
                "max_replicas": self._autoscale.max_replicas,
                "scale_ups": scale_ups,
                "scale_downs": scale_downs,
                "retiring": len(retiring),
            }
        return out
