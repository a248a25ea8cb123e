"""ServingEngine — continuous-batching inference on a block-paged or a
dense slotted KV cache; the counterpart of the core of
``paddle_tpu/serving/engine.py``: greedy and sampled decoding
(temperature, top-k, top-p, a per-request seed), stop sequences, decode
megasteps (paged) and speculative decoding with n-gram drafts.

KV memory comes from one of two managers (``paged``, default
``FLAGS_serving_paged``): the paged
:class:`~paddle_tpu_torch.serving.kv_cache.BlockKVCache` (a request pays
the blocks it needs, shared prompt prefixes are stored once), or the
dense :class:`~paddle_tpu_torch.serving.kv_cache.SlotKVCache` (one
``max_len`` row per request, f32 only, no megasteps), the baseline
``bench.py`` measures the paged cache against.

Iteration-level scheduling: each :meth:`ServingEngine.step` first
admits queued requests into free rows — acquiring a block table per
request (prefix-cache reuse first) or a free slot, grouping them by the
bucket of their unshared prompt suffix and running ONE batched prefill
per group — then runs ONE batched decode over every occupied row. A
request that finishes releases its row at once, and the next queued
request takes it on the following step.

Every prefill and decode dispatch goes through an entry of the model's
step cache (:mod:`~paddle_tpu_torch.models.generation`): one per prefill
bucket, the decode step, and with ``megastep`` N > 1 the N-iteration
decode megastep, and with ``spec_tokens`` K > 0 the verify step of
K+1 positions. On the card each dispatch is the replay of a CUDA
graph, captured at the key's first call; the caches and the weights are
read in place, so :meth:`ServingEngine.swap_weights` captures nothing.
On the paged cache each layer's attention runs through
:func:`~paddle_tpu_torch.ops.cuda.paged_attention.paged_attention` when
``attn_impl == "kernel"`` (the default), or the composed oracle for
``"composed"``; on the dense cache it is always composed, as the
reference's masked attention is. The engine runs on its model's
device.

A sampled request draws from its own threefry key (``request_key(seed)``),
split once per step it samples in and kept on the request between steps,
so its tokens depend on its seed alone, not on its slot or on the rest of
the batch: the JAX engine's restart identity, and the JAX engine's
tokens. A step in which no row samples replays the greedy graph of its
entry (no sort, no threefry; the reference computes both branches every
step), and only sampled rows' keys are written back.

Threads, as the reference's: ``_lock`` guards the queue, ``_all`` and
the accounting, ``_step_lock`` one scheduler iteration (``step``, a
weight swap, a router's kill), so one engine can be submitted to from
any thread while ``start()``'s background thread or a router's worker
steps it; ``results()`` blocks until its requests finish. The locks are
plain ``threading.Lock`` objects (the reference's ``make_lock`` with its
sanitizer off; the sanitizer is not ported).

Resilience and metrics, as the reference's: the ``serving.submit``,
``serving.step`` and ``serving.alloc`` fault sites
(:mod:`~paddle_tpu_torch.resilience`), the step and allocation retried
through ``RetryPolicy.from_flags``; a shed request ends in state
``shed`` with its reason, and every path writes the reference's
``STAT_serving_*`` counters (:mod:`~paddle_tpu_torch.monitor`), metric
families and run-log events (:mod:`~paddle_tpu_torch.observability`).

Not ported yet (each one is queued in ROADMAP.md): SLO admission and
priorities (``submit(priority=)`` raises NotImplementedError),
deadlines, cancel, dispatch-ahead (``dispatch_ahead=True`` raises),
mesh/TP, LoRA, the host KV tier, the JSON grammar, devprof and tracing,
and the disagg/HTTP front ends.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import flags as _flags
from .. import jit as _jit
from .. import monitor as _monitor
from .. import observability as _obs
from ..device import resolve_device
from ..models import generation as _gen
from ..models.gpt import ATTN_IMPLS
from ..observability import runlog as _runlog
from ..resilience.injector import fault_point
from ..resilience.retry import RetryError, RetryPolicy
from .decoding import (STOP_MAX_LEN, STOP_MAX_SEQS, DecodeParams,
                       StopMatcher, request_key, sample_first,
                       stop_table_rows, stops_fit)
from .kv_cache import BlockKVCache, SlotKVCache


class QueueFullError(RuntimeError):
    """Admission control shed this submission. ``reason`` says which gate
    fired: "queue_full" (depth backpressure), "drain" (a draining engine
    or router), or "fault" (an injected ``serving.submit`` /
    ``serving.route`` fault, or exhausted routing retries).
    ``retry_after_s`` is the reference's backoff hint, derived from its
    TTFT predictor; the predictor waits for SLO admission, so the port
    leaves it None."""

    def __init__(self, msg: str, reason: str = "queue_full",
                 retry_after_s: Optional[int] = None):
        super().__init__(msg)
        self.reason = reason
        self.retry_after_s = retry_after_s


class _Shed(Exception):
    """Internal: this request is dropped by fault policy (injected
    `skip`, or retry exhaustion). Not an OSError on purpose: it must not
    be retried."""


class _SkipStep(Exception):
    """Internal: skip one decode iteration (injected `skip` at
    serving.step during decode); requests stay live."""


class Request:
    """One generation request's lifecycle record: queued -> running ->
    done, with shed as the fault exit (queued/running -> shed, the
    reason in ``shed_reason``, the error in ``error``).
    ``output_ids`` is prompt + generated tokens (EOS included when hit).
    ``rehomed`` marks a request a router recovered off a killed replica;
    ``wait()`` blocks until the request ends."""

    _ids = itertools.count()

    def __init__(self, prompt: Sequence[int], max_new_tokens: int,
                 eos_token_id: Optional[int], priority: int = 1,
                 now: Optional[float] = None,
                 decode: Optional[DecodeParams] = None):
        self.id = next(Request._ids)
        self.prompt: List[int] = [int(t) for t in prompt]
        self.max_new_tokens = int(max_new_tokens)
        self.eos_token_id = eos_token_id
        self.priority = int(priority)
        self.decode = decode if decode is not None else DecodeParams()
        # the request's threefry key ([2] uint32), advanced by every step
        # it samples in
        self._key = request_key(self.decode.seed)
        self._stop = (StopMatcher(self.decode.stop_sequences)
                      if self.decode.stop_sequences else None)
        # whether the stops fit the device stop tables (megastep
        # eligibility, computed once)
        self._stops_fit = stops_fit(self.decode.stop_sequences)
        self.rehomed = False       # recovered from a killed replica
        self.tokens: List[int] = []
        self.state = "queued"
        self.slot: Optional[int] = None
        self.error: Optional[BaseException] = None
        self.shed_reason: Optional[str] = None
        self.submitted_at = (time.perf_counter() if now is None
                             else float(now))
        self.first_token_at: Optional[float] = None
        self.finished_at: Optional[float] = None
        self._done = threading.Event()

    @property
    def output_ids(self) -> List[int]:
        return self.prompt + self.tokens

    @property
    def context(self) -> List[int]:
        """The committed context, prompt plus generated-so-far: the
        admission path prefills over this."""
        return self.prompt + self.tokens

    @property
    def done(self) -> bool:
        """Whether the request ended (done or shed)."""
        return self._done.is_set()

    @property
    def latency(self) -> Optional[float]:
        """Submit-to-finish seconds (None while in flight)."""
        if self.finished_at is None:
            return None
        return self.finished_at - self.submitted_at

    @property
    def ttft(self) -> Optional[float]:
        """Time to first token: submit to first generated token, s."""
        if self.first_token_at is None:
            return None
        return self.first_token_at - self.submitted_at

    @property
    def tpot(self) -> Optional[float]:
        """Time per output token after the first (None until finished
        with >= 2 tokens), s."""
        if self.finished_at is None or self.first_token_at is None or \
                len(self.tokens) < 2:
            return None
        return (self.finished_at - self.first_token_at) / \
            (len(self.tokens) - 1)

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._done.wait(timeout)

    def __repr__(self):
        return (f"Request(id={self.id}, state={self.state!r}, "
                f"prompt={len(self.prompt)} toks, "
                f"generated={len(self.tokens)})")


def _parse_buckets(text: str, max_len: int) -> List[int]:
    """Flag string -> sorted bucket lengths, clipped to the capacity,
    with max_len itself as the terminal bucket."""
    buckets = sorted({int(tok) for tok in str(text).split(",") if
                      tok.strip()})
    buckets = [b for b in buckets if 0 < b <= max_len]
    if not buckets or buckets[-1] != max_len:
        buckets.append(max_len)
    return buckets


class ServingEngine:
    """Front door: ``submit()`` returns a :class:`Request` handle,
    ``results()`` collects them; call ``start()`` for a background
    scheduler thread or drive ``step()`` / ``run_until_idle()`` yourself.

    Geometry and admission knobs come from the ``FLAGS_serving_*``
    flags; constructor arguments override per instance. ``device`` must
    be the model's device; ``None`` means CUDA and raises without one.
    ``clock`` replaces ``time.perf_counter`` for the request timestamps
    and a router's breaker cooldown.
    """

    _engine_ids = itertools.count()

    def __init__(self, model, max_slots: Optional[int] = None,
                 max_len: Optional[int] = None,
                 buckets: Optional[Sequence[int]] = None,
                 max_queue: Optional[int] = None,
                 eos_token_id: Optional[int] = None,
                 block_size: Optional[int] = None,
                 num_blocks: Optional[int] = None,
                 prefix_cache: Optional[bool] = None,
                 kv_dtype: Optional[str] = None,
                 attn_impl: Optional[str] = None,
                 megastep: Optional[int] = None,
                 spec_tokens: Optional[int] = None,
                 spec_ngram: Optional[int] = None,
                 paged: Optional[bool] = None,
                 dispatch_ahead: Optional[bool] = None,
                 clock=None, device=None):
        g = _flags.get_flags(["serving_max_slots", "serving_max_len",
                              "serving_max_queue",
                              "serving_prefill_buckets",
                              "serving_max_new_tokens", "serving_paged",
                              "serving_idle_wait", "serving_dispatch_ahead",
                              "serving_block_size", "serving_num_blocks",
                              "serving_prefix_cache", "serving_kv_dtype",
                              "serving_attn_impl", "serving_megastep",
                              "serving_spec_tokens",
                              "serving_spec_ngram"])
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model lives on {model.device}, engine "
                             f"asked for {self.device}")
        self.model = model
        cfg = model.gpt.cfg
        self.max_slots = int(max_slots if max_slots is not None
                             else g["serving_max_slots"])
        self.max_len = int(max_len if max_len is not None
                           else g["serving_max_len"])
        if self.max_len > cfg.max_position_embeddings:
            raise ValueError(
                f"serving max_len {self.max_len} exceeds the model's "
                f"max_position_embeddings={cfg.max_position_embeddings}")
        self.max_queue = int(max_queue if max_queue is not None
                             else g["serving_max_queue"])
        self.default_max_new_tokens = int(g["serving_max_new_tokens"])
        self.default_eos_token_id = eos_token_id
        self.idle_wait = float(g["serving_idle_wait"])
        # device-resident decode megasteps: N decode iterations per
        # dispatch, one host commit per megastep
        self.megastep = int(megastep if megastep is not None
                            else g["serving_megastep"])
        self.spec_tokens = int(spec_tokens if spec_tokens is not None
                               else g["serving_spec_tokens"])
        self.spec_ngram = int(spec_ngram if spec_ngram is not None
                              else g["serving_spec_ngram"])
        if self.spec_tokens < 0:
            raise ValueError(
                f"spec_tokens must be >= 0, got {self.spec_tokens}")
        if self.spec_tokens >= self.max_len:
            raise ValueError(
                f"spec_tokens {self.spec_tokens} leaves no room in "
                f"max_len={self.max_len} slots")
        if self.megastep < 1:
            raise ValueError(
                f"megastep must be >= 1, got {self.megastep}")
        if self.megastep > 1 and self.spec_tokens > 0:
            raise ValueError(
                "megastep > 1 cannot combine with speculative decoding "
                "(FLAGS_serving_spec_tokens > 0): the draft-verify "
                "round-trip is inherently per-host-step")
        self.dispatch_ahead = bool(
            dispatch_ahead if dispatch_ahead is not None
            else g["serving_dispatch_ahead"])
        if self.dispatch_ahead and self.megastep <= 1:
            raise ValueError(
                "dispatch_ahead requires megastep > 1 "
                "(FLAGS_serving_megastep); there is no megastep "
                "pipeline to fill at N=1")
        if self.dispatch_ahead:
            raise NotImplementedError(
                "dispatch-ahead megasteps (FLAGS_serving_dispatch_ahead) "
                "are not ported yet")
        self.buckets = _parse_buckets(
            g["serving_prefill_buckets"] if buckets is None
            else ",".join(map(str, buckets)), self.max_len)
        self.paged = bool(paged if paged is not None
                          else g["serving_paged"])
        if self.megastep > 1 and not self.paged:
            raise ValueError(
                "megastep > 1 requires the paged KV cache "
                "(FLAGS_serving_paged); the dense decode step has no "
                "device-resident scan sibling")
        self.kv_dtype = str(kv_dtype if kv_dtype is not None
                            else g["serving_kv_dtype"])
        self.attn_impl = str(attn_impl if attn_impl is not None
                             else g["serving_attn_impl"])
        if self.attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, got "
                             f"{self.attn_impl!r}")
        if self.paged:
            self.cache = BlockKVCache(
                cfg.num_layers, cfg.num_heads, cfg.head_dim,
                self.max_slots, self.max_len,
                block_size=int(block_size if block_size is not None
                               else g["serving_block_size"]),
                num_blocks=int(num_blocks if num_blocks is not None
                               else g["serving_num_blocks"]),
                prefix_cache=bool(prefix_cache if prefix_cache is not None
                                  else g["serving_prefix_cache"]),
                kv_dtype=self.kv_dtype, device=self.device)
        else:
            if self.kv_dtype != "f32":
                raise ValueError(
                    f"serving_kv_dtype={self.kv_dtype!r} requires the "
                    "paged KV cache (FLAGS_serving_paged); the dense "
                    "SlotKVCache is f32-only")
            self.cache = SlotKVCache(cfg.num_layers, cfg.num_heads,
                                     cfg.head_dim, self.max_slots,
                                     self.max_len, device=self.device)
            # the bucketed prefill's rows, the engine's own (the
            # reference allocates them per prefill): a graph holds them
            # by address, and no other engine or generate call writes them
            self._prefill_rows = model.gpt.gen_fixed_cache(self.max_slots,
                                                           self.max_len)
        self._vocab = int(cfg.vocab_size)
        self._clock = clock if clock is not None else time.perf_counter
        self._queue: deque = deque()          # guarded-by: _lock
        self._active: Dict[int, Request] = {}  # guarded-by: _step_lock
        self._all: List[Request] = []         # guarded-by: _lock
        # a draining engine refuses new submissions (reason "drain"); a
        # router skips it and may re-home its queue through
        # take_queued()/adopt_request(). A bool flipped by the router and
        # read racily by submit, as in the reference.
        self.draining = False
        self._lock = threading.Lock()         # queue, _all, accounting
        self._step_lock = threading.Lock()    # one scheduler at a time
        self._wake = threading.Event()
        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # SLO admission is not ported: no engine has a TTFT SLO, so the
        # router's attainment reads None, as the reference's does for
        # engines without one
        self.slo_ttft_ms = 0.0
        self._completed = 0                         # guarded-by: _lock
        self._slo_met = 0                           # guarded-by: _lock
        self._shed_by_reason: Dict[str, int] = {}   # guarded-by: _lock
        self._canceled_by_reason: Dict[str, int] = {}  # guarded-by: _lock
        self._tenant_stats: Dict[str, List[int]] = {}  # guarded-by: _lock
        eid = str(next(ServingEngine._engine_ids))
        self._eid = eid
        self._ttft_hist = _obs.histogram(
            "serving_ttft_seconds",
            "time to first token of completed requests (s)"
            ).labels(engine=eid)
        self._tpot_hist = _obs.histogram(
            "serving_tpot_seconds",
            "mean time per output token of completed requests (s)"
            ).labels(engine=eid)
        self._shed_ctr = _obs.counter(
            "serving_shed_total",
            "requests shed, by reason (queue_full|slo|deadline|"
            "preempted|fault|drain) and priority class")
        if self.paged:
            self._blocks_used_g = _obs.gauge(
                "serving_kv_blocks_used",
                "physical KV blocks currently referenced (paged "
                "serving; includes the trash block and prefix-cache "
                "holds)").labels(engine=eid, tier="device")
            self._blocks_free_g = _obs.gauge(
                "serving_kv_blocks_free",
                "physical KV blocks on the free list (paged serving)"
                ).labels(engine=eid, tier="device")
            self._blocks_used_g.set(self.cache.blocks_used)
            self._blocks_free_g.set(self.cache.blocks_free)
        _obs.gauge(
            "serving_attn_impl",
            "active serving attention implementation (1 on the "
            "impl/kv_dtype series this engine traced with)"
            ).labels(engine=eid, impl=self.attn_impl,
                     kv_dtype=self.kv_dtype).set(1)
        self._weight_version_g = _obs.gauge(
            "serving_weight_version",
            "live weight hot-swaps applied to this engine's model "
            "(0 = the weights it was built with)").labels(engine=eid)
        self._weight_version_g.set(0)
        self._qerr_gauge = None
        if self.kv_dtype == "int8":
            self._qerr_gauge = _obs.gauge(
                "serving_kv_dequant_max_abs_err",
                "max abs int8 KV dequantization error observed over "
                "rows written by this engine's compiled steps"
                ).labels(engine=eid)
            self._qerr_gauge.set(0.0)
        self._prefix_hit_reqs = 0
        self._prefix_miss_reqs = 0
        self._qerr_max = 0.0
        self._spec_proposed = 0
        self._spec_accepted = 0
        self._mask = None       # the sampled steps' zero [slots, V] mask
        self._prefill_fns: Dict[int, dict] = {}   # bucket len -> entry
        self._weight_version = 0
        self.prefill_dispatches = 0
        self.decode_steps = 0           # single-step decode dispatches
        self.megastep_dispatches = 0    # N-iteration decode dispatches

    # ------------------------------------------------------------ submit
    def submit(self, prompt: Sequence[int],
               max_new_tokens: Optional[int] = None,
               eos_token_id: Optional[int] = None,
               priority: Optional[int] = None,
               temperature: Optional[float] = None,
               top_k: Optional[int] = None,
               top_p: Optional[float] = None,
               stop: Optional[Sequence[Sequence[int]]] = None,
               seed: Optional[int] = None,
               decode: Optional[DecodeParams] = None,
               _log_request: bool = True) -> Request:
        """Queue a generation request; returns its handle. Temperature
        0 (the default) is greedy; above 0 the request samples, after
        top-k (0: off) and top-p (0 or 1: off), from the stream of
        ``seed``.

        Raises ValueError for geometry the cache cannot hold (prompt +
        ``max_new_tokens`` + ``spec_tokens`` rows) or token ids outside
        the vocabulary; QueueFullError when admission sheds the
        submission (a full queue, a draining engine, an injected
        ``serving.submit`` skip); NotImplementedError for JSON-constrained
        requests and for a ``priority`` (priority classes wait for SLO
        admission). ``_log_request`` False leaves out the run log's
        ``serving_request`` arrival record (a router logs its own)."""
        if priority is not None:
            raise NotImplementedError(
                "priority classes (submit(priority=)) are not ported yet")
        mnt = int(max_new_tokens if max_new_tokens is not None
                  else self.default_max_new_tokens)
        eos = (eos_token_id if eos_token_id is not None
               else self.default_eos_token_id)
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError("empty prompt")
        if any(t < 0 or t >= self._vocab for t in prompt):
            raise ValueError(f"prompt token ids must be in [0, "
                             f"{self._vocab})")
        if mnt < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {mnt}")
        if decode is not None:
            if any(v is not None for v in (temperature, top_k, top_p,
                                           stop, seed)):
                raise ValueError(
                    "pass either decode= or individual sampling "
                    "fields, not both")
            params = decode
        else:
            try:
                stops = tuple(tuple(int(t) for t in s)
                              for s in (stop or ()))
            except TypeError:
                raise ValueError(
                    "stop must be a list of token-id sequences, e.g. "
                    "[[5, 6]], not a flat list of ids")
            params = DecodeParams(
                temperature=float(temperature) if temperature is not None
                else 0.0,
                top_k=int(top_k) if top_k is not None else 0,
                top_p=float(top_p) if top_p is not None else 0.0,
                stop_sequences=stops,
                seed=int(seed) if seed is not None else 0)
        if params.json_mode:
            raise NotImplementedError(
                "JSON-constrained decoding is not ported yet")
        if len(prompt) + mnt + self.spec_tokens > self.max_len:
            # speculative decoding reserves spec_tokens rows of slot
            # headroom: the verify step writes K+1 rows at the offset
            spec = (f" + spec_tokens ({self.spec_tokens})"
                    if self.spec_tokens else "")
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens ({mnt})"
                f"{spec} exceeds slot capacity max_len={self.max_len}")
        if self.paged:
            need = self.cache.blocks_needed(len(prompt) + mnt +
                                            self.spec_tokens)
            if need > self.cache.num_blocks - 1:  # minus trash block
                raise ValueError(
                    f"request needs {need} KV blocks but the pool only "
                    f"has {self.cache.num_blocks - 1} usable; raise "
                    "FLAGS_serving_num_blocks or shorten the request")
        pr = 1
        now = self._clock()
        if _log_request and _runlog.enabled():
            # the replayable arrival record, as the reference writes it
            extra = {}
            if not params.is_default:
                extra.update(temperature=params.temperature,
                             top_k=params.top_k, top_p=params.top_p,
                             seed=params.seed)
                if params.stop_sequences:
                    extra["stop"] = [list(s)
                                     for s in params.stop_sequences]
            _runlog.log_event("serving_request", t=round(now, 6),
                              prompt=prompt, max_new_tokens=mnt,
                              priority=pr, engine=self._eid, **extra)
        if self.draining:
            _monitor.stat_add("STAT_serving_rejected")
            self._count_shed("drain", pr)
            raise QueueFullError("engine is draining; resubmit to a "
                                 "live replica", reason="drain")
        # raising kinds reject this submission pre-queue; `skip` sheds
        # it through the same backpressure exit as a full queue
        kind = fault_point("serving.submit")
        if kind == "skip":
            _monitor.stat_add("STAT_serving_rejected")
            self._count_shed("fault", pr)
            raise QueueFullError("submission shed by injected fault at "
                                 "serving.submit", reason="fault")
        req = Request(prompt, mnt, eos, priority=pr, now=now, decode=params)
        with self._lock:
            full = len(self._queue) >= self.max_queue
            if not full:
                self._queue.append(req)
                self._all.append(req)
        if full:
            _monitor.stat_add("STAT_serving_rejected")
            self._count_shed("queue_full", pr)
            raise QueueFullError(
                f"serving queue full ({self.max_queue} waiting); retry "
                "later or raise FLAGS_serving_max_queue")
        _monitor.stat_add("STAT_serving_submitted")
        self._wake.set()
        return req

    def take_queued(self) -> List[Request]:
        """Pop every still-queued (not yet admitted) request, the
        drain/re-route path: a router moves these onto live peers via
        :meth:`adopt_request`. They stay in ``_all`` here so their
        handles keep resolving."""
        with self._lock:
            out = list(self._queue)
            self._queue.clear()
        return out

    def adopt_request(self, req: Request) -> bool:
        """Enqueue an already-validated request re-routed from a draining
        or killed peer. Depth backpressure only; returns False when this
        engine cannot take it (draining, another geometry, a committed
        context past the largest bucket, a full queue) so the router can
        try the next peer."""
        if self.draining:
            return False
        if len(req.prompt) + req.max_new_tokens + self.spec_tokens > \
                self.max_len:
            return False  # peer geometry differs; not adoptable here
        if req.tokens and len(req.context) > self.buckets[-1]:
            # a re-homed mid-decode request re-prefills its committed
            # context; one that outgrew the largest bucket would need a
            # prefill entry no engine of this geometry has
            return False
        with self._lock:
            if len(self._queue) >= self.max_queue:
                return False
            self._queue.append(req)
            self._all.append(req)
        self._wake.set()
        return True

    # ----------------------------------------------------------- prefill
    def _bucket_for(self, length: int) -> int:
        for b in self.buckets:
            if length <= b:
                return b
        return self.max_len  # unreachable: submit() validated length

    def _prefill_entry(self, bucket: int) -> dict:
        """The step-cache entry of one bucket's batched dense prefill at
        this engine's geometry, keyed as the reference's
        ``_prefill_entry``: bucket, max_slots, max_len."""
        ent = _gen.prefill_step(self.model, bucket, self.max_slots,
                                self.max_len)
        self._prefill_fns[bucket] = ent
        return ent

    def _prefill_group_attempt(self, bucket: int, group):
        """One batched dense prefill attempt for every same-bucket
        admission. The ``serving.step`` fault site fires once per request
        (a `skip` sheds that request); the survivors share one dispatch,
        rows past them are padding. Returns ``(live, shed, (logits
        [max_slots, V], rows) | None)``, ``rows`` the per-layer
        prefilled (k, v) tensors."""
        live, shed = [], []
        for req in group:
            kind = fault_point("serving.step")
            if kind == "skip":
                shed.append((req, _Shed("injected skip during prefill "
                                        f"of request {req.id}")))
            else:
                live.append(req)
        if not live:
            return live, shed, None
        ids = np.zeros((self.max_slots, bucket), np.int32)
        last = np.zeros(self.max_slots, np.int32)
        for i, req in enumerate(live):
            ctx = req.context
            ids[i, :len(ctx)] = ctx
            last[i] = len(ctx) - 1
        out = self._prefill_entry(bucket)["fn"](ids, last,
                                                self._prefill_rows)
        self.prefill_dispatches += 1
        return live, shed, out

    def _pop_candidates(self, limit: int) -> List[Request]:
        """Pop up to ``limit`` queued requests in FIFO order."""
        out: List[Request] = []
        with self._lock:
            while len(out) < limit and self._queue:
                out.append(self._queue.popleft())
        return out

    def _admit_round_dense(self):
        """One dense admission pass: pop up to ``num_free`` queued
        requests, group them by prefill bucket, one batched prefill per
        group (retried through ``RetryPolicy``), whose rows are copied
        into freshly allocated slots. Returns (consumed, admitted)."""
        candidates = self._pop_candidates(self.cache.num_free)
        groups: Dict[int, List[Request]] = {}
        for req in candidates:
            groups.setdefault(self._bucket_for(len(req.context)),
                              []).append(req)
        admitted = 0
        for bucket in sorted(groups):
            group = groups[bucket]
            try:
                with _monitor.stat_time("STAT_serving_prefill"):
                    live, shed, out = RetryPolicy.from_flags(
                        "serving.step").call(self._prefill_group_attempt,
                                             bucket, group)
            except RetryError as e:
                for req in group:
                    self._shed(req, e)
                continue
            for req, err in shed:
                self._shed(req, err)
            if not live:
                continue
            lg, rows = out
            slots = [self.cache.alloc() for _ in live]
            self.cache.write_prefill_batch(
                slots, rows, [len(r.context) for r in live])
            first = torch.argmax(lg, dim=-1).cpu().numpy()
            for i, (req, slot) in enumerate(zip(live, slots)):
                req.slot = slot
                req.state = "running"
                self._active[slot] = req
                admitted += 1
                _monitor.stat_add("STAT_serving_prefills")
                _runlog.log_event("serving_admit", request=req.id,
                                  bucket=bucket, slot=slot,
                                  prompt_tokens=len(req.prompt))
                # the first generated token comes from the prefill logits
                # (the argmax greedy_search takes after its own prefill)
                self._append_token(req, self._take_first(req, first, lg, i))
        return len(candidates), admitted

    def _prefill_entry_paged(self, bucket: int) -> dict:
        """The step-cache entry of one bucket's batched prefill at this
        engine's geometry (``max_slots`` rows), keyed as the reference's
        ``_prefill_entry_paged``: bucket, max_slots, max_len, block
        size, block count, KV dtype, attention implementation."""
        c = self.cache
        ent = _gen.prefill_step_paged(
            self.model, bucket,
            (self.max_slots, self.max_len, c.block_size, c.num_blocks),
            self.kv_dtype, self.attn_impl)
        self._prefill_fns[bucket] = ent
        return ent

    def _alloc_attempt(self, req: Request, need: int):
        """One block-table acquisition attempt (the ``serving.alloc``
        fault site): ``(row, shared) | None`` from the cache; an injected
        `skip` (a simulated allocator failure) raises _Shed."""
        kind = fault_point("serving.alloc")
        if kind == "skip":
            raise _Shed("injected allocator failure for request "
                        f"{req.id}")
        return self.cache.acquire(req.context, need)

    def _prefill_group_attempt_paged(self, bucket: int, group):
        """One batched paged-prefill attempt for every same-bucket
        admission; ``group`` rows are ``(req, row, shared)``, with the
        dense path's per-request fault semantics. Batch rows past the
        survivors are padding: trash tables, position 0. Returns
        ``(live, shed, (logits [max_slots, V], pools, max_qerr) |
        None)``."""
        live, shed = [], []
        for rec in group:
            kind = fault_point("serving.step")
            if kind == "skip":
                shed.append((rec, _Shed("injected skip during prefill "
                                        f"of request {rec[0].id}")))
            else:
                live.append(rec)
        if not live:
            return live, shed, None
        T = self.cache.blocks_per_row
        ids = np.zeros((self.max_slots, bucket), np.int32)
        last = np.zeros(self.max_slots, np.int32)
        pos = np.zeros(self.max_slots, np.int32)
        tables = np.full((self.max_slots, T), BlockKVCache.TRASH, np.int32)
        for i, (req, row, shared) in enumerate(live):
            suffix = req.context[shared:]
            ids[i, :len(suffix)] = suffix
            last[i] = len(suffix) - 1
            pos[i] = shared
            tables[i] = self.cache.tables[row]
        fn = self._prefill_entry_paged(bucket)["fn"]
        out = fn(ids, last, pos, tables, self.cache.arrays())
        self.prefill_dispatches += 1
        return live, shed, out

    def _admit_round_paged(self):
        """One paged admission pass: pop up to ``num_free`` queued
        requests in FIFO order, acquire a block table for each (retried
        through ``RetryPolicy`` at ``serving.alloc``), group by the
        unshared suffix's bucket, one batched prefill per group (retried
        at ``serving.step``). A dry pool requeues the head-of-line
        request and all behind it. Returns (consumed, admitted)."""
        candidates = self._pop_candidates(self.cache.num_free)
        if not candidates:
            return 0, 0
        acquired = []   # (req, row, shared)
        back: List[Request] = []
        for req in candidates:
            if back:          # head-of-line blocked: keep FIFO order
                back.append(req)
                continue
            need = len(req.prompt) + req.max_new_tokens + self.spec_tokens
            try:
                res = RetryPolicy.from_flags("serving.alloc").call(
                    self._alloc_attempt, req, need)
            except (_Shed, RetryError) as e:
                self._shed(req, e)
                continue
            if res is None:
                back.append(req)   # pool dry: wait for retirements
                continue
            acquired.append((req, res[0], res[1]))
        if back:
            with self._lock:
                self._queue.extendleft(reversed(back))
        if not acquired:
            return len(candidates) - len(back), 0
        groups: Dict[int, List] = {}
        for rec in acquired:
            req, row, shared = rec
            groups.setdefault(self._bucket_for(len(req.context) - shared),
                              []).append(rec)
        admitted = 0
        for bucket in sorted(groups):
            group = groups[bucket]
            try:
                with _monitor.stat_time("STAT_serving_prefill"):
                    live, shed, out = RetryPolicy.from_flags(
                        "serving.step").call(
                            self._prefill_group_attempt_paged, bucket, group)
            except RetryError as e:
                for req, row, _ in group:
                    self.cache.release_row(row)
                    self._shed(req, e)
                continue
            for (req, row, _), err in shed:
                self.cache.release_row(row)
                self._shed(req, err)
            if not live:
                continue
            lg, pools, qerr = out
            self.cache.set_arrays(pools)
            self._note_qerr(qerr, sum(len(req.context) - shared
                                      for req, _, shared in live))
            first = torch.argmax(lg, dim=-1).cpu().numpy()
            for i, (req, row, shared) in enumerate(live):
                ctx = req.context
                self.cache.commit_prefill(row, len(ctx))
                self.cache.insert_prefix(row, ctx)
                req.slot = row
                req.state = "running"
                self._active[row] = req
                admitted += 1
                if shared:
                    self._prefix_hit_reqs += 1
                    _monitor.stat_add("STAT_serving_prefix_hits")
                else:
                    self._prefix_miss_reqs += 1
                    _monitor.stat_add("STAT_serving_prefix_misses")
                _monitor.stat_add("STAT_serving_prefills")
                _runlog.log_event("serving_admit", request=req.id,
                                  bucket=bucket, slot=row,
                                  prompt_tokens=len(req.prompt),
                                  shared_tokens=shared)
                self._append_token(req, self._take_first(req, first, lg, i))
        return len(candidates) - len(back), admitted

    def _take_first(self, req: Request, first: np.ndarray, lg,
                    i: int) -> int:
        """The request's first generated token from its prefill-logits
        row: the batch argmax for greedy rows, a :func:`sample_first`
        draw with the request's key for sampled ones (the law the steps
        apply, so a restart replays it)."""
        if req.decode.is_greedy:
            return int(first[i])
        tok, req._key = sample_first(lg[i], req.decode, req._key)
        return tok

    def _admit(self) -> int:
        """Fill free rows from the queue; keeps going while progress
        frees more rows (a request that finishes on its prefill token).
        Returns how many requests were admitted."""
        admitted = 0
        while True:
            popped, n = (self._admit_round_paged() if self.paged
                          else self._admit_round_dense())
            admitted += n
            if not popped:
                return admitted

    # ------------------------------------------------------------ decode
    def _note_qerr(self, qerr, rows: int):
        """Surface an int8 step's max abs dequantization error: bump the
        quant write counters and ratchet the drift gauge (a device sync,
        taken for int8 pools only)."""
        if self.kv_dtype != "int8" or qerr is None:
            return
        _monitor.stat_add("STAT_serving_kv_quant_writes")
        _monitor.stat_add("STAT_serving_kv_quant_rows", int(rows))
        e = float(qerr)
        if e > self._qerr_max:
            self._qerr_max = e
            self._qerr_gauge.set(e)
            if _runlog.enabled():
                _runlog.log_event("serving_kv_quant",
                                  max_abs_err=round(e, 6), rows=int(rows))

    def _build_samp(self):
        """The sampled steps' per-slot inputs, rebuilt from the active
        requests every step: ``(temperature [b] f32, top_k [b] i32, top_p
        [b] f32, keys [b, 2] int64, mask [b, V])``, empty rows at the
        greedy neutral values, the mask the engine's one zero device
        buffer. None when no active row samples: the step then replays
        its greedy graph."""
        if all(req.decode.is_greedy for req in self._active.values()):
            return None
        b = self.max_slots
        temp = np.zeros(b, np.float32)
        tk = np.zeros(b, np.int32)
        tp = np.zeros(b, np.float32)
        keys = np.zeros((b, 2), np.int64)
        for slot, req in self._active.items():
            p = req.decode
            temp[slot], tk[slot], tp[slot] = p.temperature, p.top_k, p.top_p
            keys[slot] = req._key
        if self._mask is None:
            self._mask = torch.zeros(b, self._vocab, dtype=torch.float32,
                                     device=self.device)
        return temp, tk, tp, keys, self._mask

    def _writeback_keys(self, new_keys, rows=None):
        """Keep each sampled row's advanced key on its request (``rows``:
        the slots to keep, default every active one); greedy rows' keys
        never feed a draw and stay as they were."""
        if new_keys is None:
            return
        arr = new_keys.cpu().numpy()
        for slot, req in self._active.items():
            if not req.decode.is_greedy and (rows is None or slot in rows):
                req._key = arr[slot].astype(np.uint32)

    def _decode_attempt(self, tokens: np.ndarray):
        """One decode dispatch attempt (the ``serving.step`` fault site;
        an injected `skip` skips the iteration)."""
        kind = fault_point("serving.step")
        if kind == "skip":
            raise _SkipStep("injected skip of one decode iteration")
        if self.paged:
            fn = _gen.decode_step_paged(self.model, self.kv_dtype,
                                        self.attn_impl)["fn"]
            return fn(tokens, self.cache.lengths, self.cache.tables,
                      self.cache.arrays(), self._build_samp())
        fn = _gen.decode_step(self.model)["fn"]
        return fn(tokens, self.cache.lengths, self.cache.arrays(),
                  self._build_samp())

    def _shed_active(self, err: BaseException):
        """The step itself is unrecoverable (retries exhausted): shed
        every active request, keep the engine alive for new ones."""
        for slot, req in list(self._active.items()):
            del self._active[slot]
            self.cache.release(slot)
            self._shed(req, err)

    def _decode(self) -> int:
        """One batched decode over every occupied row, retried through
        ``RetryPolicy`` at ``serving.step``. Returns how many tokens were
        produced (0 when skipped or shed)."""
        if not self._active:
            return 0
        tokens = np.zeros(self.max_slots, np.int32)
        for slot, req in self._active.items():
            tokens[slot] = req.tokens[-1]
        try:
            with _monitor.stat_time("STAT_serving_decode"):
                out = RetryPolicy.from_flags("serving.step").call(
                    self._decode_attempt, tokens)
        except _SkipStep:
            return 0
        except RetryError as e:
            self._shed_active(e)
            return 0
        if self.paged:
            nxt, _, arrays, qerr, new_keys = out
            self._note_qerr(qerr, len(self._active))
        else:
            nxt, _, arrays, new_keys = out
        self.decode_steps += 1
        self.cache.set_arrays(arrays)
        self._writeback_keys(new_keys)
        nxt = nxt.cpu().numpy()
        produced = 0
        for slot, req in list(self._active.items()):
            self.cache.advance(slot, 1)
            self._append_token(req, int(nxt[slot]))
            produced += 1
        return produced

    # ------------------------------------------------ decode megasteps
    def _choose_megastep(self) -> int:
        """The N this decode runs at: the configured ``megastep`` unless
        a row's stops do not fit the device tables, which takes the whole
        batch back to single steps (never to an intermediate N: the
        engine has two decode entries, the megastep and the single
        step). Grammar rows and deadlines, the reference's other
        fallbacks, are not ported."""
        n = self.megastep
        if n <= 1 or not self._active:
            return 1
        if any(not req._stops_fit for req in self._active.values()):
            return 1
        return n

    def _megastep_inputs(self):
        """The megastep's inputs after the pools' place: tokens, lengths,
        tables, then the sampling tuple (None for a greedy batch), live,
        budget, eos and the stop tables ``(pat, plen, fail, state)``, as
        numpy arrays. Empty rows are
        frozen from iteration 0 (``live`` False) and write their strays
        into the trash block as the single step does."""
        b = self.max_slots
        tokens = np.zeros(b, np.int32)
        live = np.zeros(b, bool)
        budget = np.ones(b, np.int32)
        eos = np.full(b, -1, np.int32)
        J, L = STOP_MAX_SEQS, STOP_MAX_LEN
        pat = np.full((b, J, L), -1, np.int32)
        plen = np.zeros((b, J), np.int32)
        fail = np.zeros((b, J, L + 1), np.int32)
        state = np.zeros((b, J), np.int32)
        for slot, req in self._active.items():
            tokens[slot] = req.tokens[-1]
            live[slot] = True
            budget[slot] = req.max_new_tokens - len(req.tokens)
            if req.eos_token_id is not None:
                eos[slot] = int(req.eos_token_id)
            if req._stop is not None:
                (pat[slot], plen[slot], fail[slot],
                 state[slot]) = stop_table_rows(req._stop)
        return (tokens, self.cache.lengths, self.cache.tables,
                self._build_samp(), live, budget, eos,
                (pat, plen, fail, state))

    def _megastep_attempt(self, n: int):
        """One megastep dispatch attempt (the ``serving.step`` fault
        site)."""
        kind = fault_point("serving.step")
        if kind == "skip":
            raise _SkipStep("injected skip of one decode megastep")
        fn = _gen.decode_megastep_paged(self.model, n, self.kv_dtype,
                                        self.attn_impl)["fn"]
        tokens, lengths, tables, samp, live, budget, eos, stop = \
            self._megastep_inputs()
        return fn(tokens, lengths, tables, self.cache.arrays(), samp, live,
                  budget, eos, stop)

    def _decode_megastep(self, n: int) -> int:
        """One megastep over every occupied row: ``n`` decode iterations
        in one dispatch (retried at ``serving.step``), then one host
        commit, each row's tokens replayed through :meth:`_append_token`
        (finish reasons re-derived on the host; the device's early exits
        are the same conditions). A row finishing at iteration f
        committed f + 1 tokens, a live row all ``n``. Returns how many
        tokens were produced."""
        if not self._active:
            return 0
        n_active = len(self._active)
        try:
            with _monitor.stat_time("STAT_serving_decode"):
                out = RetryPolicy.from_flags("serving.step").call(
                    self._megastep_attempt, n)
        except _SkipStep:
            return 0
        except RetryError as e:
            self._shed_active(e)
            return 0
        (toks, finish, _tok_f, _pos_f, pools, keys_f, _live_f, _rem_f,
         _st_f, qerr) = out
        self.megastep_dispatches += 1
        self.cache.set_arrays(pools)
        toks = toks.cpu().numpy()
        finish = finish.cpu().numpy()
        self._note_qerr(qerr, n * n_active)
        # a row still live after the n iterations keeps its key, split n
        # times; a finished row's key is never read again
        self._writeback_keys(keys_f, {s for s in self._active
                                      if int(finish[s]) < 0})
        produced = 0
        for slot, req in list(self._active.items()):
            f = int(finish[slot])
            ncommit = (f + 1) if f >= 0 else n
            # iteration i wrote its token's KV at pos0 + i: lengths stay
            # prompt + generated - 1, as the single step keeps them
            self.cache.advance(slot, ncommit)
            for i in range(ncommit):
                self._append_token(req, int(toks[i, slot]))
                produced += 1
                if req.state != "running":
                    break
        if _runlog.enabled():
            _runlog.log_event("serving_megastep", n=n, active=n_active,
                              produced=produced)
        return produced

    # ------------------------------------------------- speculative decode
    def _verify_attempt(self, tokens: np.ndarray):
        """One verify dispatch attempt (the ``serving.step`` fault
        site)."""
        kind = fault_point("serving.step")
        if kind == "skip":
            raise _SkipStep("injected skip of one verify iteration")
        K = self.spec_tokens
        if self.paged:
            fn = _gen.verify_step_paged(self.model, K, self.kv_dtype,
                                        self.attn_impl)["fn"]
            return fn(tokens, self.cache.lengths, self.cache.tables,
                      self.cache.arrays(), self._build_samp())
        fn = _gen.verify_step(self.model, K)["fn"]
        return fn(tokens, self.cache.lengths, self.cache.arrays(),
                  self._build_samp())

    def _spec_decode(self) -> int:
        """One speculative draft-verify step over every occupied row:
        draft K tokens per row from its own context (:func:`~paddle_tpu_
        torch.models.generation.draft_ngram`), score all K+1 positions in
        one dispatch, commit the accepted prefix and the model's one
        next token, and roll the rejected tail's length back. Returns
        how many tokens were produced (1 to K+1 per row)."""
        if not self._active:
            return 0
        K = self.spec_tokens
        tokens = np.zeros((self.max_slots, K + 1), np.int32)
        for slot, req in self._active.items():
            tokens[slot, 0] = req.tokens[-1]
            tokens[slot, 1:] = _gen.draft_ngram(req.prompt + req.tokens, K,
                                                self.spec_ngram)
        try:
            with _monitor.stat_time("STAT_serving_verify"):
                out = RetryPolicy.from_flags("serving.step").call(
                    self._verify_attempt, tokens)
        except _SkipStep:
            return 0
        except RetryError as e:
            self._shed_active(e)
            return 0
        if self.paged:
            nxt, _, arrays, qerr, accept, new_keys = out
            self._note_qerr(qerr, (K + 1) * len(self._active))
        else:
            nxt, _, arrays, accept, new_keys = out
        self.decode_steps += 1
        self.cache.set_arrays(arrays)
        self._writeback_keys(new_keys)
        nxt = nxt.cpu().numpy()
        accept = accept.cpu().numpy()
        produced = 0
        for slot, req in list(self._active.items()):
            # the verify wrote K+1 rows at this row's offset: commit them,
            # then trim to what was accepted
            self.cache.advance(slot, K + 1)
            committed = accepted = 0
            for i in range(K + 1):
                self._append_token(req, int(nxt[slot, i]))
                committed += 1
                produced += 1
                if req.state != "running":
                    break        # finished (eos, stop, budget) mid-verify
                if i == K or not bool(accept[slot, i]):
                    break        # out of drafts, or the first rejection
                accepted += 1
            self._spec_proposed += K
            self._spec_accepted += accepted
            _monitor.stat_add("STAT_serving_spec_proposed", K)
            _monitor.stat_add("STAT_serving_spec_accepted", accepted)
            if _runlog.enabled():
                _runlog.log_event("serving_spec", request=req.id,
                                  proposed=K, accepted=accepted)
            if req.state == "running":
                self.cache.rollback(slot, K + 1 - committed)
        return produced

    def _decode_any(self) -> int:
        """One decode round: the megastep when :meth:`_choose_megastep`
        allows it, else the single step."""
        n = self._choose_megastep()
        if n > 1:
            return self._decode_megastep(n)
        return self._decode()

    def _append_token(self, req: Request, token: int):
        req.tokens.append(token)
        if req.first_token_at is None:
            req.first_token_at = self._clock()
        _monitor.stat_add("STAT_serving_tokens")
        if req._stop is not None:
            req._stop.feed(token)
        if (req.eos_token_id is not None and
                token == req.eos_token_id) or \
                len(req.tokens) >= req.max_new_tokens or \
                self._hit_stop(req):
            self._finish(req)

    def _hit_stop(self, req: Request) -> bool:
        """Whether a stop sequence is now a suffix of the generated
        tokens (the request's incremental matcher latched)."""
        return req._stop is not None and req._stop.hit

    def _finish(self, req: Request):
        if req.slot is not None:
            self._active.pop(req.slot, None)
            self.cache.release(req.slot)
            req.slot = None
        req.state = "done"
        req.finished_at = self._clock()
        ttft, tpot = req.ttft, req.tpot
        if ttft is not None:
            self._ttft_hist.observe(ttft)
        if tpot is not None:
            self._tpot_hist.observe(tpot)
        with self._lock:
            self._completed += 1
            # [completed, slo-eligible, slo-met] per tenant, as the
            # reference counts them; without LoRA every request is "base"
            self._tenant_stats.setdefault("base", [0, 0, 0])[0] += 1
        _monitor.stat_add("STAT_serving_completed")
        _runlog.log_event(
            "serving_finish", request=req.id, tokens=len(req.tokens),
            ttft_ms=None if ttft is None else round(ttft * 1e3, 3),
            tpot_ms=None if tpot is None else round(tpot * 1e3, 3),
            deadline_met=None)
        req._done.set()

    def _count_shed(self, reason: str, priority: int):
        with self._lock:
            self._shed_by_reason[reason] = \
                self._shed_by_reason.get(reason, 0) + 1
        self._shed_ctr.labels(engine=self._eid, reason=reason,
                              priority=str(priority)).inc()

    def _shed(self, req: Request, err: BaseException,
              reason: str = "fault"):
        """End ``req`` as shed (its blocks or slot already released by
        the caller): the fault exit of the lifecycle."""
        req.slot = None
        req.state = "shed"
        req.error = err
        req.shed_reason = reason
        req.finished_at = self._clock()
        _monitor.stat_add("STAT_serving_shed")
        self._count_shed(reason, req.priority)
        _runlog.log_event("serving_shed", request=req.id,
                          reason=reason, priority=req.priority,
                          error=str(err))
        req._done.set()

    # ------------------------------------------------- weight hot-swap
    def swap_weights(self, state, *, reset_costs: bool = True) -> int:
        """Swap the live model weights between steps, with no drain and
        no restart: the counterpart of ``paddle_tpu/serving/engine.py
        :787``.

        ``state`` maps every ``named_parameters()`` name to an array
        (numpy, torch, or anything ``numpy.asarray`` takes) of that
        parameter's exact shape; a missing, unknown or misshapen name
        raises before anything is written. Each value is copied into the
        parameter's own storage, never rebound: the captured steps read
        the parameters where they lie, so the next replay computes with
        the new weights and nothing is captured anew (the reference's
        weights ride into its compiled steps as data for the same end).
        The copies are queued on the current stream, after the steps
        before them and before the steps after. KV entries written under
        the old weights are kept (the reference's contract). SLO
        admission's learned costs, which ``reset_costs`` drops in the
        reference, are not ported: there is nothing to reset yet.
        Returns the new weight version."""
        named = list(self.model.named_parameters())
        known = {name for name, _ in named}
        unknown = sorted(set(state) - known)
        missing = sorted(known - set(state))
        if unknown or missing:
            raise ValueError(
                f"swap_weights state does not match the live model: "
                f"missing {missing[:3]}{'...' if len(missing) > 3 else ''}, "
                f"unknown {unknown[:3]}{'...' if len(unknown) > 3 else ''}")
        staged = []
        for name, p in named:
            v = state[name]
            if not isinstance(v, torch.Tensor):
                v = torch.from_numpy(np.array(v, dtype=np.float32))
            if tuple(v.shape) != tuple(p.shape):
                raise ValueError(
                    f"swap_weights: {name!r} has shape "
                    f"{tuple(v.shape)}, live model expects "
                    f"{tuple(p.shape)} — a different architecture "
                    "needs a new engine, not a swap")
            staged.append((p, v))
        # the step lock makes a clean cut between this engine's steps;
        # the model's trace lock one between any replica's replays, which
        # read these parameters too
        with self._step_lock, _gen.model_trace_lock(self.model), \
                torch.no_grad():
            for p, v in staged:
                p.copy_(v)
            self._weight_version += 1
            version = self._weight_version
        self._weight_version_g.set(version)
        _runlog.log_event("serving_weight_swap", engine=self._eid,
                          version=version, params=len(staged),
                          reset_costs=bool(reset_costs))
        _monitor.stat_add("STAT_serving_weight_swaps")
        return version

    def _release_device(self):
        """Free what this engine holds on the device, for good: drop the
        step graphs captured over its pools, its sampling mask and its
        prefill rows (``HeldStep.forget``, with the memory they keep),
        then the tensors themselves. The router's kill path calls it on a
        replica it has stripped of every request, so a restart loop holds
        the memory of the live replicas only; the engine's host
        book-keeping (its requests, counters, block refcounts) stays."""
        held = [a for layer in self.cache.arrays() for a in layer]
        if self._mask is not None:
            held.append(self._mask)
        if not self.paged:
            held += [a for layer in self._prefill_rows for a in layer]
            self._prefill_rows = []
        _gen.forget_held(self.model, [a.data_ptr() for a in held])
        self._mask = None
        self.cache.drop_arrays()

    @property
    def weight_version(self) -> int:
        """Hot-swaps applied so far (0 = construction weights)."""
        return self._weight_version

    # --------------------------------------------------------- stepping
    def step(self) -> bool:
        """One scheduler iteration: admit into free rows (batched
        per-bucket prefill), then one batched decode, or with speculation
        on one draft-verify step. Returns whether any work happened."""
        with self._step_lock:
            _monitor.stat_add("STAT_serving_steps")
            admitted = self._admit()
            produced = (self._spec_decode() if self.spec_tokens
                        else self._decode_any())
            if self.paged:
                self._blocks_used_g.set(self.cache.blocks_used)
                self._blocks_free_g.set(self.cache.blocks_free)
            return bool(admitted or produced)

    @property
    def idle(self) -> bool:
        with self._lock:
            queued = bool(self._queue)
        return not queued and not self._active

    def run_until_idle(self, max_steps: int = 10_000) -> int:
        """Drive the scheduler until queue and rows drain."""
        steps = 0
        while not self.idle:
            self.step()
            steps += 1
            if steps >= max_steps:
                raise RuntimeError(
                    f"serving engine not idle after {max_steps} steps "
                    f"({len(self._active)} active, "
                    f"{len(self._queue)} queued)")
        return steps

    def results(self, reqs: Optional[Sequence[Request]] = None,
                timeout: Optional[float] = None) -> List[Request]:
        """Wait for the given requests (default: every request ever
        submitted) and return them in submission order; TimeoutError
        when one is still running after ``timeout`` seconds."""
        with self._lock:
            reqs = list(self._all) if reqs is None else list(reqs)
        for r in reqs:
            if not r.wait(timeout):
                raise TimeoutError(
                    f"request {r.id} not finished within {timeout}s")
        return reqs

    # ------------------------------------------------- background thread
    def start(self):
        """Run the scheduler on a daemon thread; idle waits are bounded
        by ``FLAGS_serving_idle_wait``. The thread steps with the
        caller's capture mode: started inside ``jit.no_capture()``, it
        captures nothing either."""
        if self._thread is not None:
            return
        self._stop_evt.clear()
        eager = not _jit.capture_enabled()

        def _loop():
            with _jit.no_capture() if eager else contextlib.nullcontext():
                while not self._stop_evt.is_set():
                    if not self.step():
                        self._wake.wait(self.idle_wait)
                        self._wake.clear()

        self._thread = threading.Thread(target=_loop, daemon=True,
                                        name="serving-engine")
        self._thread.start()

    def stop(self):
        self._stop_evt.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None

    def stats(self) -> dict:
        """Per-engine serving metrics: latency percentiles of finished
        requests (ms), the attention path, the KV dtype and its int8
        error, prefix-cache reuse and block use, and the dispatch
        counts."""
        with self._lock:
            done = [r for r in self._all if r.state == "done"]
            shed = dict(self._shed_by_reason)

        def pct(vals, q):
            vals = [v for v in vals if v is not None]
            return (None if not vals
                    else round(float(np.percentile(vals, q)) * 1e3, 3))

        out = {
            "ttft_p50_ms": pct([r.ttft for r in done], 50),
            "ttft_p99_ms": pct([r.ttft for r in done], 99),
            "tpot_p50_ms": pct([r.tpot for r in done], 50),
            "tpot_p99_ms": pct([r.tpot for r in done], 99),
            "completed": len(done),
            "queue_depth": len(self._queue),
            "active": len(self._active),
            "paged": self.paged,
            "attn_impl": self.attn_impl,
            "kv_dtype": self.kv_dtype,
            "prefill_dispatches": self.prefill_dispatches,
            "decode_steps": self.decode_steps,
            "spec_tokens": self.spec_tokens,
            "shed": shed,
            "shed_total": sum(shed.values()),
        }
        if self.paged:
            c = self.cache
            hit_t, miss_t = c.prefix_hits, c.prefix_misses
            out.update({
                "block_size": c.block_size,
                "num_blocks": c.num_blocks,
                "kv_blocks_used": c.blocks_used,
                "kv_blocks_free": c.blocks_free,
                "prefix_cache": c.prefix_cache_enabled,
                "prefix_entries": c.prefix_entries,
                "prefix_hit_requests": self._prefix_hit_reqs,
                "prefix_miss_requests": self._prefix_miss_reqs,
                "prefix_hit_tokens": hit_t,
                "prefix_miss_tokens": miss_t,
                "prefix_hit_rate": (round(hit_t / (hit_t + miss_t), 4)
                                    if hit_t + miss_t else None),
            })
        if self.spec_tokens:
            out["spec_proposed"] = self._spec_proposed
            out["spec_accepted"] = self._spec_accepted
            out["spec_acceptance_rate"] = (
                round(self._spec_accepted / self._spec_proposed, 4)
                if self._spec_proposed else None)
        if self.megastep > 1:
            out["megastep"] = self.megastep
            out["megastep_dispatches"] = self.megastep_dispatches
        if self.kv_dtype == "int8":
            out["kv_quant_max_abs_err"] = round(self._qerr_max, 6)
        return out
