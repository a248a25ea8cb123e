"""Disaggregated prefill/decode serving — a fleet of single-role engines
behind one ``submit()`` front door; the counterpart of
``paddle_tpu/serving/disagg.py``.

- :class:`PrefillEngine` only admits: it runs the bucketed batched
  prompt pass, takes the first generated token as the symmetric engine
  does, then exports the request: the row's block table and its
  committed KV blocks leave the cache as an ownership-transfer record
  (``BlockKVCache.export_row``) and enter the fleet's bounded
  :class:`HandoffQueue`.
- :class:`DecodeEngine` only decodes: each step it adopts what the
  queue holds. A record whose blocks live in its own
  :class:`~paddle_tpu_torch.serving.kv_cache.BlockPool` (co-located
  roles) splices in as host book-keeping (``import_row``: no reference
  or byte moves); a record from another pool has its committed blocks
  copied into this pool's own tensors (``adopt_row``, in place, so every
  graph captured over the pool reads them), after which the source
  references drop. ``BlockAllocator.leaked()`` stays exact either way.
- :class:`DisaggRouter` owns the fleet: P prefill workers feed D decode
  workers through the queue, whose bound backpressures admission.

Routing is prefix-affine (``FLAGS_serving_prefix_affinity``): a
fleet-wide index of the rolling-hash chain keys
(``kv_cache.prefix_chain_keys``) maps each prefix to the prefill worker
that last prefilled it; a request walks its chain deepest-first and
routes to the indexed worker (a hit when that worker's cache still
holds the prefix), else least-loaded. ``serving_prefix_affinity_{hits,
misses}`` count the decisions.

The roles call the symmetric engine's steps through the model's one
step cache, keyed on geometry, never on role: on the CPU, where the
entries count input signatures, a disaggregated fleet at a symmetric
fleet's geometry adds none, as the reference adds no compile. On the
card a graph holds the pools it was captured over by address, so a
fleet with new pools captures its own graphs (one per bucket on each
prefill pool, the decode graph on each decode pool; decode workers
sharing one pool share its greedy decode graph, and each keeps its own
sampled graph, which holds its sampling mask).

Chaos: ``kill_prefill_worker`` re-routes a killed prefill worker's
queued requests and sheds its in-flight prefills and undelivered
records with every block reference released; ``kill_decode_worker``
exports every in-flight row of a killed decode worker and re-homes it on
a survivor (``import_row`` when they share a pool, ``adopt_row``
otherwise), so generation continues token for token. A killed worker's
device memory is freed as the replica router frees a killed replica's
(``ServingEngine._release_device``), but its pool only when no live
worker shares it: otherwise only its own tensors (its sampling mask) and
the graphs holding them go. The ``serving.handoff`` fault site injects
at adoption time, retried through ``RetryPolicy.from_flags``, and a
record that outlives its TTFT deadline in the queue is shed with its
references released.

Threads: ``step()`` runs every worker in turn, or with
``FLAGS_serving_dispatch_threads`` > 0 in the reference's three phases
(prefill workers in parallel, then the adoption sweeps serially, since a
cross-pool adoption derefs the source pool, then the decode halves
grouped by pool, one thread per pool), each in the caller's capture
mode. ``start()`` runs one scheduler thread for the whole fleet.

Fleet-shared planes, as the replica router's: one
:class:`~paddle_tpu_torch.serving.lora.LoRAPool` and one host KV tier
across both roles. A tenant's page pin is engine-local: the prefill
worker releases it on export and the decode worker re-acquires it by
tenant name on adoption (a kill moves it the same way). Both roles run
the demotion sweep after their steps. A killed prefill worker's affinity
entries whose chains the host tier holds become a host-tier marker,
which routes to the least-loaded live worker (any worker can promote the
chain) instead of being dropped.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
from collections import OrderedDict, deque
from typing import Dict, List, Optional, Sequence, Tuple

from .. import flags as _flags
from .. import jit as _jit
from .. import monitor as _monitor
from .. import observability as _obs
from ..analysis import concurrency as _ccz
from ..observability import runlog as _runlog
from ..observability import tracing as _tracing
from ..resilience.injector import fault_point
from ..resilience.retry import RetryError, RetryPolicy
from .engine import QueueFullError, Request, ServingEngine, _Shed
from .kv_cache import prefix_chain_keys
from .router import _in_mode, _one_per_pool, _shared_planes


class _HostTierAffinity:
    """Marker value in the fleet prefix index: the worker that last
    prefilled this chain is dead, but the chain is resident in the
    fleet-shared host KV tier, which any live prefill worker can promote
    from. Routing resolves it to the least-loaded live worker; the next
    publish replaces it."""

    def __repr__(self):
        return "<host-tier>"


_HOST_TIER = _HostTierAffinity()


def parse_disagg(text: str) -> Optional[Tuple[int, int]]:
    """'PxD' -> (n_prefill, n_decode), None when empty."""
    text = str(text).strip()
    if not text:
        return None
    try:
        p, d = (int(s) for s in text.lower().split("x"))
    except Exception:
        raise ValueError(
            f"serving_disagg must be 'PxD' (e.g. '1x2'), got {text!r}")
    if p < 1 or d < 1:
        raise ValueError(
            f"serving_disagg needs at least 1 worker per role, "
            f"got {text!r}")
    return p, d


class _Handoff:
    """One finished prefill in flight between the roles: the request, the
    exported block record (which owns the blocks' references until
    adopted or released) and the prefill worker that produced it (a
    killed worker's undelivered records are found by ``src``)."""

    __slots__ = ("req", "rec", "src")

    def __init__(self, req: Request, rec: dict, src: "PrefillEngine"):
        self.req = req
        self.rec = rec
        self.src = src


class HandoffQueue:
    """Bounded FIFO between the prefill and decode roles. When full,
    prefill workers stop admitting (finished but undelivered prefills
    would pin KV blocks without bound otherwise). Decode workers
    ``take`` the oldest record, optionally filtered, so a co-located
    worker takes the records it can splice for free first."""

    def __init__(self, bound: int):
        if bound < 1:
            raise ValueError(f"handoff bound must be >= 1, got {bound}")
        self.bound = int(bound)
        self._items: deque = deque()     # guarded-by: _lock
        self._lock = _ccz.make_lock("handoff._lock")
        _ccz.declare_guarded(self, {"_items": "_lock"})

    def __len__(self) -> int:
        with self._lock:
            return len(self._items)

    @property
    def room(self) -> int:
        with self._lock:
            return self.bound - len(self._items)

    def put(self, item: _Handoff) -> bool:
        with self._lock:
            if len(self._items) >= self.bound:
                return False
            self._items.append(item)
            return True

    def take(self, match=None) -> Optional[_Handoff]:
        """Remove and return the oldest item (matching ``match`` when
        given), or None."""
        with self._lock:
            for i, item in enumerate(self._items):
                if match is None or match(item):
                    del self._items[i]
                    return item
            return None

    def take_by_id(self, rid: int) -> Optional[_Handoff]:
        """Remove and return the record of request ``rid`` (None when it
        is not queued here): the cancel path, whose caller then owns the
        record's block references."""
        with self._lock:
            for i, item in enumerate(self._items):
                if item.req.id == rid:
                    del self._items[i]
                    return item
            return None

    def put_back(self, item: _Handoff):
        """Return an item taken but not adoptable now to the front, so
        the next attempt keeps FIFO order."""
        with self._lock:
            self._items.appendleft(item)

    def evict_from(self, src: "PrefillEngine") -> List[_Handoff]:
        """Remove every undelivered record a (killed) prefill worker
        produced; the caller sheds them and releases their blocks."""
        with self._lock:
            mine = [it for it in self._items if it.src is src]
            self._items = deque(
                it for it in self._items if it.src is not src)
            return mine


def _paged_only(kwargs: dict) -> dict:
    if kwargs.get("paged") is False:
        raise ValueError(
            "disaggregated serving requires the paged KV cache "
            "(the handoff is a block-table splice)")
    return dict(kwargs, paged=True)


class PrefillEngine(ServingEngine):
    """The admit-only role: bucketed batched prefill, then export.

    ``step()`` admits (one prefill dispatch per bucket, the symmetric
    engine's steps) and at once exports every running row into the
    handoff queue; a row frees as soon as its record exists, so the row
    count bounds a step's admission batch, not the worker's concurrency.
    A request that ends on its prefill token (``max_new_tokens == 1`` or
    an EOS first token) completes here and never hands off. No admission
    happens while the queue is full or earlier exports still wait to
    enqueue (``_pending``)."""

    trace_role = "prefill"

    def __init__(self, model, handoff: HandoffQueue, **kwargs):
        super().__init__(model, **_paged_only(kwargs))
        self._handoff = handoff
        self._pending: deque = deque()  # guarded-by: _step_lock

    def _flush_pending(self) -> int:  # holds: _step_lock
        moved = 0
        while self._pending:
            if not self._handoff.put(self._pending[0]):
                break
            self._pending.popleft()
            moved += 1
        return moved

    def _stage_running(self) -> int:  # holds: _step_lock
        """Export every running row into ``_pending``, in request-id
        order, so seeded runs replay exactly."""
        staged = 0
        for row in sorted(self._active,
                          key=lambda r: self._active[r].id):
            req = self._active.pop(row)
            rec = self.cache.export_row(row)
            req.slot = None          # in flight between the roles
            # the adapter pin is engine-local (page ids never travel):
            # the decode side re-acquires it by tenant name
            self._release_pin(req)
            self._pending.append(_Handoff(req, rec, self))
            _tracing.mark(req.id, "export", self._clock(),
                          self.trace_track)
            staged += 1
            if _runlog.enabled():
                _runlog.log_event(
                    "serving_handoff", request=req.id, stage="export",
                    engine=self._eid, blocks=len(rec["blocks"]),
                    length=rec["length"])
        return staged

    def step(self) -> bool:
        with self._step_lock:
            _monitor.stat_add("STAT_serving_steps")
            worked = self._flush_pending() > 0
            if not self._pending and self._handoff.room > 0:
                worked = bool(self._admit()) or worked
                worked = self._stage_running() > 0 or worked
                worked = self._flush_pending() > 0 or worked
            if self.kv_tier is not None:
                self._demote_sweep()
            self._blocks_used_g.set(self.cache.blocks_used)
            self._blocks_free_g.set(self.cache.blocks_free)
            return worked

    @property
    def idle(self) -> bool:
        with self._lock:
            queued = bool(self._queue)
        return not queued and not self._active and not self._pending

    def shed_pending(self, reason: str = "fault") -> int:  # holds: _step_lock
        """Shed every exported but undelivered record, releasing its
        block references (the killed worker's cleanup)."""
        shed = 0
        while self._pending:
            item = self._pending.popleft()
            item.rec["pool"].release_blocks(item.rec["blocks"])
            self._shed(item.req, _Shed(
                "prefill worker torn down before handoff"),
                reason=reason)
            shed += 1
        return shed

    def cancel_pending(self, rid: int,
                       reason: str = "client") -> Optional[dict]:
        """Cancel one staged but undelivered export: the record owns its
        block references until it reaches the queue, so they are
        released here."""
        with self._step_lock:
            for i, item in enumerate(self._pending):
                if item.req.id == rid:
                    del self._pending[i]
                    item.rec["pool"].release_blocks(
                        item.rec["blocks"])
                    self._finalize_cancel(item.req, "handoff", reason)
                    return {"id": rid, "stage": "handoff",
                            "reason": reason}
        return None


class DecodeEngine(ServingEngine):
    """The decode-only role: adopt handoffs, then one batched decode (or
    a megastep, or a speculative draft-verify), the symmetric engine's
    steps at the same geometry.

    Adoption prefers records whose blocks already live in this worker's
    pool (``import_row``, a free splice) and falls back to cross-pool
    copies (``adopt_row``). A record that does not fit now (no free row,
    a dry pool) stays queued with its references: the backpressure."""

    trace_role = "decode"

    def __init__(self, model, handoff: HandoffQueue, **kwargs):
        super().__init__(model, **_paged_only(kwargs))
        self._handoff = handoff
        self.adopted = 0          # guarded-by: _step_lock
        self.adopted_copies = 0   # guarded-by: _step_lock
        _ccz.declare_guarded(self, {"adopted": "_step_lock",
                                    "adopted_copies": "_step_lock"})

    def submit(self, *a, **k):
        raise RuntimeError(
            "DecodeEngine does not accept submissions; submit through "
            "the DisaggRouter (prefill workers feed this engine)")

    def _handoff_attempt(self, item: _Handoff) -> Optional[int]:  # holds: _step_lock
        """Adopt one record; None when there is no room (it stays
        queued). The ``serving.handoff`` fault site: ``skip`` sheds the
        request, drop and error retry through the RetryPolicy."""
        kind = fault_point("serving.handoff")
        if kind == "skip":
            raise _Shed("injected shed at serving.handoff")
        same_pool = item.rec["pool"] is self.cache.pool
        row = (self.cache.import_row(item.rec) if same_pool
               else self.cache.adopt_row(item.rec))
        if row is None:
            return None
        if not same_pool:
            # the copy is queued; drop the record's source references
            item.rec["pool"].release_blocks(item.rec["blocks"])
            self.adopted_copies += 1
        return row

    def _adopt_handoffs(self) -> int:  # holds: _step_lock
        """Drain what fits: same-pool records first (free splices), then
        cross-pool copies, oldest first within each class."""
        adopted = 0
        for match in (lambda it: it.rec["pool"] is self.cache.pool,
                      None):
            while self.cache.num_free > 0:
                item = self._handoff.take(match)
                if item is None:
                    break
                if item.req.hard_deadline is not None and \
                        self._clock() > item.req.hard_deadline:
                    # the client's patience ran out in the queue: a
                    # cancel, its references released here
                    item.rec["pool"].release_blocks(
                        item.rec["blocks"])
                    self._finalize_cancel(item.req, "handoff",
                                          "deadline")
                    continue
                if item.req.deadline is not None and \
                        self._clock() > item.req.deadline:
                    # a record that outlived its TTFT deadline in the
                    # queue is shed, not decoded, its references released
                    item.rec["pool"].release_blocks(item.rec["blocks"])
                    self._shed(item.req, _Shed(
                        "handoff outlived its TTFT deadline in the "
                        "queue"), reason="deadline")
                    continue
                try:
                    row = RetryPolicy.from_flags(
                        "serving.handoff").call(
                            self._handoff_attempt, item)
                except (_Shed, RetryError) as e:
                    item.rec["pool"].release_blocks(
                        item.rec["blocks"])
                    self._shed(item.req, e)
                    continue
                if row is None:      # no room: keep the refs, retry later
                    self._handoff.put_back(item)
                    break
                if not self._pin(item.req, row):
                    continue
                item.req.slot = row
                self._active[row] = item.req
                self.adopted += 1
                adopted += 1
                _tracing.mark(item.req.id, "adopt", self._clock(),
                              self.trace_track)
                _monitor.stat_add("STAT_serving_handoffs")
                if _runlog.enabled():
                    _runlog.log_event(
                        "serving_handoff", request=item.req.id,
                        stage="adopt", engine=self._eid, slot=row,
                        copied=not (item.rec["pool"]
                                    is self.cache.pool))
        return adopted

    def _pin(self, req: Request, row: int) -> bool:
        """Re-pin an adopted request's tenant page in this engine's pool;
        an adapter evicted mid-handoff sheds it, its row released."""
        if req.tenant and self.lora_pool is not None:
            try:
                self.lora_pool.acquire(req.tenant)
                req._lora_held = True
            except ValueError as e:
                self.cache.release_row(row)
                self._shed(req, _Shed(str(e)))
                return False
        return True

    def adopt_step(self) -> bool:
        """The admission half of :meth:`step`: cancel rows whose hard
        deadline passed (their rows take this step's adoptions), then
        adopt what fits. Separate so the threaded router runs it
        serially: a cross-pool adoption derefs the source prefill
        worker's pool, which must not race that worker's allocations."""
        with self._step_lock:
            _monitor.stat_add("STAT_serving_steps")
            reaped = self._reap_expired()
            worked = self._adopt_handoffs() > 0
            return bool(worked or reaped)

    def decode_step(self) -> bool:
        """The compute half of :meth:`step`: one decode dispatch (a
        megastep or a verify when configured) and the pool gauges. Only
        this engine's pool and internally locked planes are touched, so
        the threaded router runs decode halves of workers on different
        pools at once."""
        with self._step_lock:
            produced = (self._spec_decode() if self.spec_tokens
                        else self._decode_any())
            if self.kv_tier is not None:
                self._demote_sweep()
            self._blocks_used_g.set(self.cache.blocks_used)
            self._blocks_free_g.set(self.cache.blocks_free)
            return bool(produced)

    def step(self) -> bool:
        worked = self.adopt_step()
        return self.decode_step() or worked


class DisaggRouter:
    """One ``submit()`` front door over a disaggregated fleet: P
    :class:`PrefillEngine` workers feed D :class:`DecodeEngine` workers
    through a bounded :class:`HandoffQueue`.

    ``colocate=True`` (default) gives decode worker ``j`` prefill worker
    ``j % P``'s :class:`BlockPool`, so a handoff is a block-table splice.
    ``colocate=False`` gives every worker its own pool, and handoffs copy
    the committed blocks. The engine keywords (``device`` among them:
    None means CUDA) go to every worker.

    The interface mirrors :class:`~paddle_tpu_torch.serving.router.
    ReplicaRouter` (``submit`` / ``step`` / ``run_until_idle`` /
    ``drain`` / ``cancel`` / ``results`` / ``stats`` / ``start`` /
    ``stop``), so the load generator and the HTTP server drive either.
    """

    _router_ids = itertools.count()

    #: fleet-wide affinity index bound: (int key -> engine) pairs,
    #: evicted LRU
    AFFINITY_CAP = 8192

    def __init__(self, model, n_prefill: Optional[int] = None,
                 n_decode: Optional[int] = None,
                 prefix_affinity: Optional[bool] = None,
                 handoff_queue: Optional[int] = None,
                 colocate: bool = True,
                 dispatch_threads: Optional[int] = None,
                 **engine_kwargs):
        g = _flags.get_flags(["serving_disagg",
                              "serving_prefix_affinity",
                              "serving_handoff_queue",
                              "serving_dispatch_threads"])
        if n_prefill is None or n_decode is None:
            dims = parse_disagg(g["serving_disagg"])
            if dims is None:
                dims = (1, 1)
            n_prefill = int(n_prefill if n_prefill is not None
                            else dims[0])
            n_decode = int(n_decode if n_decode is not None
                           else dims[1])
        if n_prefill < 1 or n_decode < 1:
            raise ValueError(
                f"need at least 1 worker per role, got "
                f"{n_prefill} prefill x {n_decode} decode")
        self.prefix_affinity = bool(
            prefix_affinity if prefix_affinity is not None
            else g["serving_prefix_affinity"])
        bound = int(handoff_queue if handoff_queue is not None
                    else g["serving_handoff_queue"])
        self._handoff = HandoffQueue(bound)
        self._model = model
        engine_kwargs = dict(engine_kwargs)
        _shared_planes(model, engine_kwargs)
        self.kv_tier = engine_kwargs.get("kv_tier")
        self.prefills: List[PrefillEngine] = [
            PrefillEngine(model, self._handoff, **engine_kwargs)
            for _ in range(n_prefill)]
        self.decodes: List[DecodeEngine] = []
        for j in range(n_decode):
            kw = dict(engine_kwargs)
            if colocate:
                kw["kv_pool"] = \
                    self.prefills[j % n_prefill].cache.pool
            self.decodes.append(
                DecodeEngine(model, self._handoff, **kw))
        self.colocate = bool(colocate)
        # threaded fleet dispatch (0 = the serial loop, the same
        # scheduling): see step()
        self._dispatch_threads = int(
            dispatch_threads if dispatch_threads is not None
            else g["serving_dispatch_threads"])
        if self._dispatch_threads < 0:
            raise ValueError(
                "dispatch_threads must be >= 0, got "
                f"{self._dispatch_threads}")
        self._step_pool = None   # lazily-built ThreadPoolExecutor
        self._killed: List[ServingEngine] = []  # guarded-by: _lock
        self._rehomed = 0                       # guarded-by: _lock
        self._draining = False                  # guarded-by: _lock
        self._lock = _ccz.make_lock("disagg._lock")
        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # chain key -> PrefillEngine that last prefilled that prefix
        self._affinity: "OrderedDict[int, PrefillEngine]" = \
            OrderedDict()                       # guarded-by: _lock
        rid = str(next(DisaggRouter._router_ids))
        self._rid = rid
        self._aff_hits = _obs.counter(
            "serving_prefix_affinity_hits",
            "requests routed to the prefill worker already holding "
            "their longest cached prefix (fleet prefix index)"
            ).labels(router=rid)
        self._aff_misses = _obs.counter(
            "serving_prefix_affinity_misses",
            "requests routed least-loaded because no live worker held "
            "any of their prefix (or the index was stale)"
            ).labels(router=rid)
        self._handoff_gauge = _obs.gauge(
            "serving_handoff_queue_depth",
            "finished prefills waiting for a decode worker to adopt "
            "their KV blocks (bounded; full = prefill backpressure)"
            ).labels(router=rid)
        self._handoff_gauge.set(0)
        self._rehomed_counter = _obs.counter(
            "serving_rehomed_total",
            "requests recovered off a killed replica/worker onto a "
            "live peer").labels(router=rid)
        _obs.gauge(
            "serving_disagg_workers",
            "single-role workers in this disaggregated fleet, by role"
            ).labels(router=rid, role="prefill").set(n_prefill)
        _obs.gauge(
            "serving_disagg_workers",
            "single-role workers in this disaggregated fleet, by role"
            ).labels(router=rid, role="decode").set(n_decode)
        _ccz.declare_guarded(self, {
            "_rehomed": "_lock", "_draining": "_lock",
            "_killed": "_lock", "_affinity": "_lock"})

    # ----------------------------------------------------------- routing
    @property
    def engines(self) -> List[ServingEngine]:
        """Every live worker, prefill first: the surface the load
        generator and the leak checks walk."""
        return list(self.prefills) + list(self.decodes)

    @property
    def _retiring(self) -> List[ServingEngine]:
        # ReplicaRouter's name for the workers taken out (loadgen walks it)
        return list(self._killed)

    def _depth(self, eng: ServingEngine) -> int:
        with eng._lock:
            return len(eng._queue) + len(eng._active)

    def _blocks_free(self, eng: ServingEngine) -> int:
        return eng.cache.blocks_free

    def _least_loaded(self) -> List[int]:
        return sorted(
            (i for i, e in enumerate(self.prefills)
             if not e.draining),
            key=lambda i: (self._depth(self.prefills[i]),
                           -self._blocks_free(self.prefills[i]), i))

    def _affinity_pick(self, prompt: Sequence[int],
                       keys: Sequence[int]) -> Optional[int]:
        """The deepest indexed chain key whose worker is alive, checked
        against that worker's cache (a stale hit still routes there:
        queued same-prefix requests coalesce and publish again)."""
        for key in reversed(keys):
            # reads, LRU bumps and publishes all take the router lock:
            # submitting threads and the kill path share the index
            with self._lock:
                eng = self._affinity.get(key)
                if eng is _HOST_TIER:
                    if self.kv_tier is None or \
                            not self.kv_tier.has_chain(key):
                        continue
                    self._affinity.move_to_end(key)
                    idx = None  # resolved to a live worker below
                elif eng is None or eng.draining or \
                        eng not in self.prefills:
                    continue
                else:
                    self._affinity.move_to_end(key)
                    idx = self.prefills.index(eng)
            if idx is None:
                # the host-tier marker: any live worker can promote the
                # chain, so the least-loaded one takes it
                order = self._least_loaded()
                if not order:
                    return None
                self._aff_hits.add(1)
                _monitor.stat_add("STAT_serving_affinity_hits")
                return order[0]
            if eng.cache.match_prefix_blocks(prompt) > 0:
                self._aff_hits.add(1)
                _monitor.stat_add("STAT_serving_affinity_hits")
            else:
                self._aff_misses.add(1)
                _monitor.stat_add("STAT_serving_affinity_misses")
            return idx
        return None

    def _publish_affinity(self, keys: Sequence[int],
                          eng: PrefillEngine):
        with self._lock:
            for key in keys:
                self._affinity[key] = eng
                self._affinity.move_to_end(key)
            while len(self._affinity) > self.AFFINITY_CAP:
                self._affinity.popitem(last=False)

    def _route_attempt(self, prompt, max_new_tokens, eos_token_id,
                       priority, **decode_kwargs) -> Request:
        kind = fault_point("serving.route")
        if kind == "skip":
            _monitor.stat_add("STAT_serving_route_shed")
            raise QueueFullError(
                "submission shed by injected fault at serving.route",
                reason="fault")
        keys: List[int] = []
        order = self._least_loaded()
        if not order:
            raise QueueFullError("no live prefill worker", reason="drain")
        if self.prefix_affinity:
            bs = self.prefills[0].cache.block_size
            keys = prefix_chain_keys(prompt, bs)
            pick = self._affinity_pick(prompt, keys) if keys else None
            if pick is None and keys:
                self._aff_misses.add(1)
                _monitor.stat_add("STAT_serving_affinity_misses")
            if pick is not None:
                order = [pick] + [i for i in order if i != pick]
        last_err: Optional[QueueFullError] = None
        for i in order:
            eng = self.prefills[i]
            try:
                req = eng.submit(prompt, max_new_tokens=max_new_tokens,
                                 eos_token_id=eos_token_id,
                                 priority=priority, _log_request=False,
                                 **decode_kwargs)
            except QueueFullError as e:
                last_err = e
                continue
            _monitor.stat_add("STAT_serving_routed")
            _runlog.log_event("serving_route", request=req.id,
                              replica=i, depth=self._depth(eng),
                              kv_blocks_free=self._blocks_free(eng),
                              role="prefill")
            if self.prefix_affinity and keys:
                self._publish_affinity(keys, eng)
            return req
        _monitor.stat_add("STAT_serving_route_shed")
        raise last_err if last_err is not None else QueueFullError(
            "every prefill worker queue is full")

    def submit(self, prompt: Sequence[int],
               max_new_tokens: Optional[int] = None,
               eos_token_id: Optional[int] = None,
               priority: Optional[int] = None,
               _log_request: bool = True, **decode_kwargs) -> Request:
        """Route one request to a prefill worker: prefix-affine when the
        fleet index knows its prefix, least-loaded otherwise. Decode
        capacity is reached through the handoff queue only. The
        per-request decoding fields (``temperature`` / ``top_k`` /
        ``top_p`` / ``stop`` / ``seed`` / ``json_mode``), ``tenant``,
        ``session`` and ``deadline_ms`` pass through to the prefill worker
        and travel with the handoff: the sampling key, the grammar cursor
        and the tenant name live on the Request, so a sampled or
        constrained stream continues bit for bit across the role
        boundary."""
        with self._lock:
            if self._draining:
                raise QueueFullError("router is draining: submissions "
                                     "are shed for rolling shutdown",
                                     reason="drain")
        if _log_request and _runlog.enabled():
            prompt = [int(t) for t in prompt]
            extra = {}
            for k in ("temperature", "top_k", "top_p", "seed",
                      "json_mode", "tenant"):
                v = decode_kwargs.get(k)
                if v:
                    extra[k] = v
            if decode_kwargs.get("stop"):
                extra["stop"] = [list(s)
                                 for s in decode_kwargs["stop"]]
            _runlog.log_event(
                "serving_request",
                t=round(self.prefills[0]._clock(), 6), prompt=prompt,
                max_new_tokens=int(
                    max_new_tokens if max_new_tokens is not None
                    else self.prefills[0].default_max_new_tokens),
                priority=int(priority if priority is not None else 1),
                router=self._rid, **extra)
        try:
            return RetryPolicy.from_flags("serving.route").call(
                self._route_attempt, prompt, max_new_tokens,
                eos_token_id, priority, **decode_kwargs)
        except RetryError as e:
            _monitor.stat_add("STAT_serving_route_shed")
            raise QueueFullError(
                f"routing retries exhausted: {e}", reason="fault") from e

    # ----------------------------------------------------- LoRA adapters
    def load_adapter(self, name: str, state) -> int:
        """Load a tenant adapter once per distinct pool (the default
        fleet shares one). Returns the page on the last pool."""
        return [eng.load_adapter(name, state) for eng in _one_per_pool(
            self.engines, True, "fleet has no LoRA pool; construct with "
            "lora_rank > 0 (FLAGS_serving_lora_rank)")][-1]

    def evict_adapter(self, name: str) -> int:
        """Evict a tenant adapter from every distinct pool; refuses
        (ValueError) while in-flight work anywhere pins it."""
        return [eng.evict_adapter(name) for eng in _one_per_pool(
            self.engines, False, "fleet has no LoRA pool")][-1]

    # ------------------------------------------------------ cancellation
    def cancel(self, rid: int, reason: str = "client"
               ) -> Optional[dict]:
        """Cancel request ``rid`` wherever it lives in the fleet: queued
        or mid-prefill on a prefill worker, staged for export, in the
        handoff queue (the record's references released here) or
        mid-decode on a decode worker. One Request object is shared by
        every engine's book-keeping, so exactly one stage holds its
        resources: the first hit wins. Returns ``{"id", "stage",
        "reason"}``, or None for an unknown or ended request. Host work
        only: nothing is captured."""
        rid = int(rid)
        with self._lock:
            engines = (list(self.prefills) + list(self.decodes)
                       + list(self._killed))
        req = None
        for eng in engines:
            with eng._lock:
                req = next((r for r in eng._all if r.id == rid), None)
            if req is not None:
                break
        if req is None or req.state in ("done", "shed", "canceled"):
            return None
        out = None
        # queued / mid-prefill / mid-decode: whichever engine holds the
        # queue entry or the row
        for eng in engines:
            out = eng._cancel_request(req, reason)
            if out is not None:
                break
        if out is None:
            # staged exports (a finished prefill waiting for queue room)
            for eng in engines:
                if isinstance(eng, PrefillEngine):
                    out = eng.cancel_pending(rid, reason)
                    if out is not None:
                        break
        if out is None:
            # in flight between the roles
            item = self._handoff.take_by_id(rid)
            if item is not None:
                item.rec["pool"].release_blocks(item.rec["blocks"])
                item.src._finalize_cancel(item.req, "handoff", reason)
                out = {"id": rid, "stage": "handoff", "reason": reason}
        if out is not None:
            self._purge_affinity(req.prompt)
        return out

    def _purge_affinity(self, prompt: Sequence[int]) -> int:
        """Drop the index entries of a canceled prompt's chain whose
        worker is gone or holds none of the prefix any more (entries
        whose worker still holds it stay: other requests share it)."""
        if not self.prefix_affinity or not self.prefills:
            return 0
        bs = self.prefills[0].cache.block_size
        keys = prefix_chain_keys(prompt, bs)
        purged = 0
        with self._lock:
            for key in keys:
                eng = self._affinity.get(key)
                if eng is None:
                    continue
                if eng is _HOST_TIER:
                    # a marker stays while the host tier holds the chain
                    if self.kv_tier is None or \
                            not self.kv_tier.has_chain(key):
                        del self._affinity[key]
                        purged += 1
                    continue
                if eng not in self.prefills or \
                        eng.cache.match_prefix_blocks(prompt) == 0:
                    del self._affinity[key]
                    purged += 1
        return purged

    # ---------------------------------------------------------- stepping
    def _dispatch_pool(self):
        """The bounded worker pool of threaded dispatch, built at first
        use and shut down by :meth:`stop`."""
        if self._step_pool is None:
            from concurrent.futures import ThreadPoolExecutor
            self._step_pool = ThreadPoolExecutor(
                max_workers=self._dispatch_threads,
                thread_name_prefix=f"disagg{self._rid}-dispatch")
        return self._step_pool

    @staticmethod
    def _await_all(futs) -> bool:
        worked = False
        err = None
        for f in futs:
            try:
                worked = bool(f.result()) or worked
            except Exception as e:     # barrier first, raise after
                err = err or e
        if err is not None:
            raise err
        return worked

    def step(self) -> bool:
        """One fleet iteration: every prefill worker (admission and
        export), then every decode worker (adoption and decode), in a
        fixed order.

        With ``FLAGS_serving_dispatch_threads`` > 0 (or
        ``dispatch_threads=``) the workers' steps run on a bounded pool
        in three phases, each worker in the caller's capture mode: the
        prefill steps in parallel (each on its own pool); after that
        barrier the adoption sweeps serially on the calling thread (a
        cross-pool adoption releases blocks of the source pool); then
        the decode halves in parallel, grouped by pool, one thread per
        pool (co-located decode workers share a pool and its
        allocator)."""
        if self._dispatch_threads > 0:
            pool = self._dispatch_pool()
            eager = not _jit.capture_enabled()
            worked = self._await_all(
                [pool.submit(_in_mode, eager, eng.step)
                 for eng in list(self.prefills)])
            decodes = list(self.decodes)
            for eng in decodes:
                worked = eng.adopt_step() or worked
            groups: dict = {}
            for eng in decodes:
                groups.setdefault(id(eng.cache.pool), []).append(eng)

            def _run_group(group):
                w = False
                for eng in group:
                    w = eng.decode_step() or w
                return w

            worked = self._await_all(
                [pool.submit(_in_mode, eager, _run_group, grp)
                 for grp in groups.values()]) or worked
        else:
            worked = False
            for eng in list(self.prefills):
                worked = eng.step() or worked
            for eng in list(self.decodes):
                worked = eng.step() or worked
        self._handoff_gauge.set(len(self._handoff))
        return worked

    @property
    def idle(self) -> bool:
        return (len(self._handoff) == 0 and
                all(e.idle for e in self.prefills) and
                all(e.idle for e in self.decodes))

    def run_until_idle(self, max_steps: int = 10_000) -> int:
        steps = 0
        while not self.idle:
            self.step()
            steps += 1
            if steps >= max_steps:
                raise RuntimeError(
                    f"disagg fleet not idle after {max_steps} steps "
                    f"({len(self._handoff)} handoffs queued)")
        return steps

    def drain(self, max_steps: int = 10_000) -> int:
        """Stop admissions and run the fleet to idle; returns how many
        requests were shed on the way down."""
        with self._lock:
            self._draining = True
        engines = self.engines + self._retiring

        def _shed_total(e):
            with e._lock:
                return sum(e._shed_by_reason.values())
        before = sum(_shed_total(e) for e in engines)
        _runlog.log_event("serving_drain",
                          replicas=len(engines),
                          queued=[self._depth(e) for e in engines])
        self.run_until_idle(max_steps)
        _monitor.stat_add("STAT_serving_drained")
        shed = sum(_shed_total(e) for e in engines) - before
        if shed:
            _monitor.stat_add("STAT_serving_drain_shed", shed)
        _runlog.log_event("serving_drain_done", shed=shed)
        return shed

    # ------------------------------------------------------------- chaos
    def _release_dead(self, eng: ServingEngine):
        """Free a killed worker's device memory: its pool and every graph
        over it when no live worker shares the pool, else only its own
        tensors and the graphs holding them. A pool no live worker
        shares first drops its prefix cache's references, which would
        read as leaks of the dead worker."""
        alone = not any(e.cache.pool is eng.cache.pool
                        for e in self.prefills + self.decodes)
        with eng._step_lock:
            if alone:
                eng.cache.flush_prefix_cache()
            eng._release_device(pool=alone)

    def kill_prefill_worker(self, index: int) -> dict:
        """Tear one prefill worker down mid-flight (chaos): its queued
        requests re-route to surviving prefill workers with room, its
        in-flight prefills and undelivered records shed with every block
        reference released, and the fleet index forgets it; then its
        device memory is freed. Returns the cleanup accounting."""
        with self._lock:
            if not 0 <= index < len(self.prefills):
                raise IndexError(
                    f"prefill worker {index} out of range "
                    f"(have {len(self.prefills)})")
            eng = self.prefills.pop(index)
            eng.draining = True
            self._killed.append(eng)
        # forget the worker in the affinity index, except the chains the
        # fleet-shared host tier holds: any survivor can promote those,
        # so their entries become the host-tier marker
        kept = 0
        with self._lock:
            for key in [k for k, v in self._affinity.items()
                        if v is eng]:
                if self.kv_tier is not None and \
                        self.kv_tier.has_chain(key):
                    self._affinity[key] = _HOST_TIER
                    kept += 1
                else:
                    del self._affinity[key]
        # undelivered handoff records: shed, their refs released
        shed = 0
        for item in self._handoff.evict_from(eng):
            item.rec["pool"].release_blocks(item.rec["blocks"])
            eng._shed(item.req, _Shed(
                "prefill worker killed before handoff delivery"))
            shed += 1
        with eng._step_lock:
            shed += eng.shed_pending()
            # mid-prefill rows: row and blocks released the usual way
            for row, req in list(eng._active.items()):
                del eng._active[row]
                eng.cache.release(row)
                eng._shed(req, _Shed("prefill worker killed"))
                shed += 1
        # still-queued requests re-home onto survivors
        rerouted = 0
        t_kill = eng._clock()
        for req in eng.take_queued():
            _tracing.mark(req.id, "kill", t_kill, eng.trace_track)
            placed = False
            for i in self._least_loaded():
                if self.prefills[i].adopt_request(req):
                    placed = True
                    rerouted += 1
                    _monitor.stat_add("STAT_serving_rerouted")
                    break
            if not placed:
                eng._shed(req, QueueFullError(
                    "no surviving prefill worker could adopt the "
                    "request", reason="drain"), reason="drain")
                shed += 1
        self._release_dead(eng)
        _monitor.stat_add("STAT_serving_worker_killed")
        _runlog.log_event("serving_worker_kill", role="prefill",
                          worker=index, shed=shed, rerouted=rerouted,
                          affinity_kept=kept,
                          t=round(eng._clock(), 6),
                          prefills_left=len(self.prefills))
        return {"shed": shed, "rerouted": rerouted,
                "affinity_kept": kept,
                "prefills_left": len(self.prefills)}

    def kill_decode_worker(self, index: int) -> dict:
        """Tear one decode worker down mid-decode (chaos): every
        in-flight row leaves it as an ownership-transfer record
        (``export_row``) and re-homes on a surviving decode worker, a
        free splice when they share a :class:`BlockPool`, else a copy of
        its committed blocks into the survivor's pool after which the
        source references drop. The request then decodes on, token for
        token (its sampling key and committed tokens travel on the
        Request). A row no survivor has room for sheds with every
        reference released. Then the worker's device memory is freed.
        The last decode worker cannot be killed: the handoff queue would
        never drain. Returns the cleanup accounting."""
        with self._lock:
            if not 0 <= index < len(self.decodes):
                raise IndexError(
                    f"decode worker {index} out of range "
                    f"(have {len(self.decodes)})")
            if len(self.decodes) == 1:
                raise ValueError(
                    "cannot kill the last decode worker; the handoff "
                    "queue would never drain")
            eng = self.decodes.pop(index)
            eng.draining = True
            eng._health = "dead"
            self._killed.append(eng)
        rehomed = shed = 0
        with eng._step_lock:
            for row in sorted(eng._active,
                              key=lambda r: eng._active[r].id):
                req = eng._active.pop(row)
                _tracing.mark(req.id, "kill", eng._clock(),
                              eng.trace_track)
                eng._release_pin(req)
                rec = eng.cache.export_row(row)
                req.slot = None
                # same-pool survivors first (free splices); within a
                # class, least-loaded
                order = sorted(
                    self.decodes,
                    key=lambda p: (
                        0 if rec["pool"] is p.cache.pool else 1,
                        self._depth(p), -self._blocks_free(p)))
                for peer in order:
                    same_pool = rec["pool"] is peer.cache.pool
                    with peer._step_lock:
                        row2 = (peer.cache.import_row(rec) if same_pool
                                else peer.cache.adopt_row(rec))
                        if row2 is None:
                            continue
                        if not same_pool:
                            # the copy is queued; drop the source refs
                            rec["pool"].release_blocks(rec["blocks"])
                        if req.tenant and peer.lora_pool is not None:
                            # peer._pin inlined, so the release of row2
                            # on its failure path is in this function
                            try:
                                peer.lora_pool.acquire(req.tenant)
                                req._lora_held = True
                            except ValueError as e:
                                peer.cache.release_row(row2)
                                peer._shed(req, _Shed(str(e)))
                                shed += 1
                                break
                        req.slot = row2
                        peer._active[row2] = req
                    req.rehomed = True
                    _tracing.mark(req.id, "adopt", peer._clock(),
                                  peer.trace_track)
                    rehomed += 1
                    _monitor.stat_add("STAT_serving_rehomed")
                    self._rehomed_counter.inc()
                    if _runlog.enabled():
                        _runlog.log_event(
                            "serving_handoff", request=req.id,
                            stage="adopt", engine=peer._eid,
                            slot=row2, copied=not same_pool)
                    break
                else:
                    # no survivor had room (each import/adopt returned
                    # None, the record's references intact): shed
                    rec["pool"].release_blocks(rec["blocks"])
                    eng._shed(req, QueueFullError(
                        "no surviving decode worker could adopt the "
                        "row", reason="drain"), reason="drain")
                    shed += 1
        self._release_dead(eng)
        with self._lock:
            self._rehomed += rehomed
        _monitor.stat_add("STAT_serving_worker_killed")
        _runlog.log_event("serving_worker_kill", role="decode",
                          worker=index, shed=shed, rerouted=rehomed,
                          t=round(eng._clock(), 6),
                          decodes_left=len(self.decodes))
        return {"rehomed": rehomed, "shed": shed,
                "decodes_left": len(self.decodes)}

    # ---------------------------------------------------------- plumbing
    def swap_weights(self, state, *, reset_costs: bool = True
                     ) -> List[int]:
        """Rolling weight hot-swap across both roles (the contract of
        ``ReplicaRouter.swap_weights``)."""
        with self._lock:
            engines = self.engines + self._retiring
        return [eng.swap_weights(state, reset_costs=reset_costs)
                for eng in engines]

    def results(self, reqs=None, timeout: Optional[float] = None
                ) -> List[Request]:
        """Wait for requests, in submission order. Requests live in the
        prefill workers' ``_all`` (adoption moves the KV, not the
        book-keeping), deduplicated by id, since a re-routed request is
        in two workers' lists."""
        if reqs is None:
            seen: Dict[int, Request] = {}
            for eng in self.prefills + self._killed:
                with eng._lock:
                    for r in eng._all:
                        seen.setdefault(r.id, r)
            out = sorted(seen.values(), key=lambda r: r.id)
        else:
            out = list(reqs)
        for r in out:
            if not r.wait(timeout):
                raise TimeoutError(
                    f"request {r.id} not finished within {timeout}s")
        return out

    def start(self):
        """One scheduler thread for the whole fleet (co-located roles
        share pool state, so one stepper keeps every host-side mutation
        on one thread), stepping in the caller's capture mode: started
        inside ``jit.no_capture()`` it captures nothing either."""
        if self._thread is not None:
            return
        self._stop_evt.clear()
        eager = not _jit.capture_enabled()

        def _loop():
            idle_wait = self.prefills[0].idle_wait
            with _jit.no_capture() if eager else contextlib.nullcontext():
                while not self._stop_evt.is_set():
                    if not self.step():
                        self._stop_evt.wait(idle_wait)

        self._thread = threading.Thread(target=_loop, daemon=True,
                                        name="serving-disagg")
        self._thread.start()

    def stop(self):
        self._stop_evt.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        if self._step_pool is not None:
            self._step_pool.shutdown(wait=True)
            self._step_pool = None

    def stats(self) -> dict:
        """The fleet's view: workers per role and their queue depths,
        the handoff queue, the affinity counters, and the pool-level
        prefix hit rate over unique pools (co-located roles share one)."""
        engines = self.engines + self._retiring
        shed: dict = {}
        canceled: dict = {}
        completed = 0
        for e in engines:
            with e._lock:
                completed += e._completed
                for k, v in e._shed_by_reason.items():
                    shed[k] = shed.get(k, 0) + v
                for k, v in e._canceled_by_reason.items():
                    canceled[k] = canceled.get(k, 0) + v
        pools = {}
        for e in engines:
            pools[id(e.cache.pool)] = e.cache.pool
        hits = sum(p.prefix_hits for p in pools.values())
        misses = sum(p.prefix_misses for p in pools.values())
        dead_decodes = [e for e in self._killed
                        if isinstance(e, DecodeEngine)]
        adopted = sum(d.adopted for d in self.decodes + dead_decodes)
        copies = sum(d.adopted_copies
                     for d in self.decodes + dead_decodes)
        tenants: dict = {}
        for e in engines:
            with e._lock:
                for name, (c, el, m) in e._tenant_stats.items():
                    t = tenants.setdefault(name, [0, 0, 0])
                    t[0] += c
                    t[1] += el
                    t[2] += m
        # the router's own state under its lock: the HTTP thread scrapes
        # stats() while kills and re-homes run
        with self._lock:
            draining = self._draining
            rehomed = self._rehomed
            affinity_entries = len(self._affinity)
        out = {
            "prefill_workers": len(self.prefills),
            "decode_workers": len(self.decodes),
            "colocated": self.colocate,
            "draining": draining,
            "handoff_queued": len(self._handoff),
            "handoff_bound": self._handoff.bound,
            "handoffs_adopted": adopted,
            "handoffs_copied": copies,
            "prefix_affinity": self.prefix_affinity,
            "affinity_hits": int(self._aff_hits.value),
            "affinity_misses": int(self._aff_misses.value),
            "affinity_index_entries": affinity_entries,
            "fleet_prefix_hits": hits,
            "fleet_prefix_misses": misses,
            "fleet_prefix_hit_rate": (
                round(hits / (hits + misses), 4)
                if hits + misses else None),
            "completed": completed,
            "rehomed": rehomed,
            "shed": shed,
            "shed_total": sum(shed.values()),
            "canceled": canceled,
            "canceled_total": sum(canceled.values()),
            "dispatch_threads": self._dispatch_threads,
            "queue_depths": [self._depth(e) for e in self.prefills],
            "kv_blocks_free": [self._blocks_free(e)
                               for e in self.prefills],
            "per_prefill": [e.stats() for e in self.prefills],
            "per_decode": [e.stats() for e in self.decodes],
        }
        if tenants:
            # a request completes on exactly one engine (the decode
            # side), so summing across roles never counts one twice
            out["tenants"] = {
                name: {"completed": c,
                       "slo_met": m,
                       "slo_attainment": (round(m / e, 4) if e
                                          else None)}
                for name, (c, e, m) in sorted(tenants.items())}
        return out
