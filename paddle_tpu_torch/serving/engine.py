"""ServingEngine — continuous-batching inference on a block-paged or a
dense slotted KV cache; the counterpart of the core of
``paddle_tpu/serving/engine.py``: greedy and sampled decoding
(temperature, top-k, top-p, a per-request seed), stop sequences,
JSON-constrained decoding, decode megasteps (paged) and speculative
decoding with n-gram drafts.

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
steps it; ``results()`` blocks until its requests finish. Both locks
come from :func:`~paddle_tpu_torch.analysis.concurrency.make_lock` under
the reference's names: plain ``threading.Lock`` objects, or under
``FLAGS_sanitize_locks`` instrumented ones in the lock-order graph, and
the ``# guarded-by`` attributes are then checked on every rebinding
write (``declare_guarded``); ``python3 -m
paddle_tpu_torch.tools.lint_serving`` checks the same declarations
statically.

Resilience and metrics, as the reference's: the ``serving.submit``,
``serving.step`` and ``serving.alloc`` fault sites
(:mod:`~paddle_tpu_torch.resilience`), the step and allocation retried
through ``RetryPolicy.from_flags``; a shed request ends in state
``shed`` with its reason, and every path writes the reference's
``STAT_serving_*`` counters (:mod:`~paddle_tpu_torch.monitor`), metric
families and run-log events (:mod:`~paddle_tpu_torch.observability`).

Admission, as the reference's (``slo_ttft_ms`` > 0): ``submit()``
predicts the newcomer's TTFT from host state (the queue ahead of it,
free rows, the per-bucket prefill cost and the decode pace, pinned
through ``slo_prefill_ms`` / ``slo_tpot_ms`` or learned as EWMAs over
measured dispatches) and sheds it with reason "slo" when the prediction
exceeds the SLO; every shed carries the predictor's ``retry_after_s``.
Priority classes (lower is more urgent, FIFO within a class) may
preempt queued lower-priority work (reason "preempted"); a queued
request whose TTFT deadline passed is shed before prefill (reason
"deadline"). ``cancel()`` ends a request at any stage and frees its
row at once; a ``deadline_ms`` hard deadline cancels it within one
step. The cost windows close after the host has read the step's
tokens, so on the card they measure the replay's device time too, not
only its enqueue. Every request carries a trace
(:mod:`~paddle_tpu_torch.observability.tracing`) keyed by its id.

``kv_pool`` shares another engine's
:class:`~paddle_tpu_torch.serving.kv_cache.BlockPool` (the co-located
roles of :mod:`~paddle_tpu_torch.serving.disagg`): geometry and KV dtype
come from the pool.

Multi-tenant LoRA (``lora_rank`` > 0 or a shared ``lora_pool``, paged
only): ``submit(tenant=)`` names a loaded adapter of the engine's
:class:`~paddle_tpu_torch.serving.lora.LoRAPool`; the request pins its
page from admission to its exit, and every paged step gathers each row's
page (the steps' LoRA variants). ``load_adapter`` / ``evict_adapter``
write the pool in place between steps: nothing is captured.

The host KV tier (``FLAGS_serving_host_tier`` or a shared ``kv_tier``,
paged only): admission promotes a prompt's host-resident chain before
acquiring its blocks, a sweep after each decode demotes cold prefix
chains (``FLAGS_serving_demote_idle_ms``), and ``submit(session=)``
prepends a conversation's stored context, saved back when the request
finishes (:mod:`~paddle_tpu_torch.serving.kv_tier`).

JSON-constrained decoding (``grammar=`` a
:class:`~paddle_tpu_torch.serving.decoding.JsonGrammar`,
``submit(json_mode=True)``): the request's cursor, set at submission and
advanced over each committed token, gives its additive mask row for the
next token; the first token is drawn through it, and a batch with a
constrained row replays the sampled graph (a greedy row takes
``argmax(logits + mask)`` there) in single steps, never a megastep. The
rows are written into the engine's ``[slots, V]`` mask buffer, which the
sampled graphs hold by address, before each replay.

The device-cost observatory (``devprof=``, ``devprof_sample=``;
:mod:`~paddle_tpu_torch.observability.devprof`): a sampled dispatch's
device time comes from CUDA events around its graph's replay, its host
time is the rest of the step, and the sampled device share splits each
finished trace's decode time.

Dispatch-ahead megasteps (``dispatch_ahead=True``, megastep > 1): once
megastep k is enqueued, its host outputs are copied into pinned buffers
behind it and an event is recorded; megastep k+1 is then enqueued from
k's device carry (tokens, positions, live rows, budgets, stop states and
keys copied on the device into the same graph's static inputs, k's
tables and constants reused), and only then does the host wait, on the
event, not on the stream, and commit k while the card runs k+1. The
next decode consumes k+1 if the scheduler state it assumed still holds:
the same N, the same (slot, request, length) rows, the same weight and
flag versions, and the same pool write version and LoRA load version
(the port's counterparts of the reference's identity checks on arrays
it rebinds, which the port writes in place). A discarded speculation has
already written its KV in place: past each row's committed length,
which nothing reads before it is rewritten, and for int8 pools into
blocks whose committed rows a louder row re-encodes, so those blocks are
saved before it is enqueued and restored on a miss, or before any other
write to the pool (:class:`~paddle_tpu_torch.serving.kv_cache.
TailSnapshot`). With a host tier the blocks are saved for every kv
dtype: the demotion after the step copies whole blocks, which the
speculation may already have written, and reads the saved ones.

Not ported yet (queued in ROADMAP.md): mesh/TP (``mesh=`` raises).
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
from ..analysis import concurrency as _ccz
from ..device import resolve_device
from ..models import generation as _gen
from ..models.gpt import ATTN_IMPLS
from ..observability import devprof as _devprof
from ..observability import runlog as _runlog
from ..observability import tracing as _tracing
from ..resilience.injector import fault_point
from ..resilience.retry import RetryError, RetryPolicy
from . import kv_cache as _kvc
from .decoding import (STOP_MAX_LEN, STOP_MAX_SEQS, DecodeParams,
                       StopMatcher, request_key, sample_first,
                       stop_table_rows, stops_fit)
from .kv_cache import BlockKVCache, BlockPool, SlotKVCache
from .kv_tier import HostBlockStore, TierManager
from .lora import LoRAPool


class QueueFullError(RuntimeError):
    """Admission control shed this submission. ``reason`` says which gate
    fired: "queue_full" (depth backpressure), "slo" (predicted TTFT
    beyond the engine's ``slo_ttft_ms``), "drain" (a draining engine or
    router), or "fault" (an injected ``serving.submit`` /
    ``serving.route`` fault, or exhausted routing retries).
    ``retry_after_s`` is the engine's backoff hint in whole seconds (>=
    1), derived from its TTFT predictor."""

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
    reason in ``shed_reason``, the error in ``error``) and canceled as
    the client exit (queued/running -> canceled, the reason in
    ``shed_reason``: a client cancel, an expired hard deadline, a lost
    hedge race). ``output_ids`` is prompt + generated tokens (EOS
    included when hit). ``priority`` is an integer class, lower is more
    urgent. With a TTFT SLO ``deadline`` is the engine-clock time the
    first token must land by; ``hard_deadline`` the time after which
    the request is canceled wherever it is. ``rehomed`` marks a request
    a router recovered off a killed replica; ``tenant`` names its LoRA
    adapter ("" = base weights) and ``session`` its host-tier
    conversation; ``wait()`` blocks until the request ends."""

    _ids = itertools.count()

    def __init__(self, prompt: Sequence[int], max_new_tokens: int,
                 eos_token_id: Optional[int], priority: int = 1,
                 now: Optional[float] = None,
                 decode: Optional[DecodeParams] = None,
                 tenant: str = ""):
        self.id = next(Request._ids)
        self.tenant = str(tenant)
        self._lora_held = False    # this request pins its tenant's page
        # host-tier conversation id (submit(session=...)): the finish
        # saves the context back; _session_counted while the resident
        # gauge holds it
        self.session: Optional[str] = None
        self._session_counted = False
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
        # the JSON grammar's cursor of a json_mode request (set at submit,
        # advanced over every committed token; it travels with the
        # request across a handoff or a re-home)
        self._cursor = None
        # whether the stops fit the device stop tables (megastep
        # eligibility, computed once)
        self._stops_fit = stops_fit(self.decode.stop_sequences)
        self.rehomed = False       # recovered from a killed replica
        # a router's hedge copy: never surfaced in results() or reports
        self._hedge_clone = False
        # engine-clock time after which the request is canceled wherever
        # it is (client patience); None: run to completion
        self.hard_deadline: Optional[float] = None
        self.tokens: List[int] = []
        self.state = "queued"
        self.slot: Optional[int] = None
        self.error: Optional[BaseException] = None
        self.shed_reason: Optional[str] = None
        self.submitted_at = (time.perf_counter() if now is None
                             else float(now))
        self.deadline: Optional[float] = None
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

    @property
    def deadline_met(self) -> Optional[bool]:
        """Whether the first token landed inside the TTFT deadline: None
        without an SLO or while the verdict is open, False for a shed
        request (its first token never arrives)."""
        if self.deadline is None:
            return None
        if self.first_token_at is None:
            return False if self.state == "shed" else None
        return self.first_token_at <= self.deadline

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
    ``clock`` replaces ``time.perf_counter`` for the request timestamps,
    deadlines, traces and a router's breaker cooldown.
    """

    _engine_ids = itertools.count()

    #: track-label prefix in exported traces
    trace_role = "engine"

    @property
    def trace_track(self) -> str:
        return f"{self.trace_role}{self._eid}"

    def __init__(self, model, max_slots: Optional[int] = None,
                 max_len: Optional[int] = None,
                 buckets: Optional[Sequence[int]] = None,
                 max_queue: Optional[int] = None,
                 eos_token_id: Optional[int] = None,
                 spec_tokens: Optional[int] = None,
                 paged: Optional[bool] = None,
                 block_size: Optional[int] = None,
                 num_blocks: Optional[int] = None,
                 prefix_cache: Optional[bool] = None,
                 kv_dtype: Optional[str] = None,
                 mesh=None,
                 slo_ttft_ms: Optional[float] = None,
                 slo_prefill_ms: Optional[float] = None,
                 slo_tpot_ms: Optional[float] = None,
                 priority_preempt: Optional[bool] = None,
                 clock=None, kv_pool: Optional[BlockPool] = None,
                 lora_rank: Optional[int] = None,
                 lora_max_adapters: Optional[int] = None,
                 lora_pool: Optional[LoRAPool] = None, grammar=None,
                 kv_tier: Optional[TierManager] = None,
                 megastep: Optional[int] = None,
                 dispatch_ahead: Optional[bool] = None,
                 devprof: Optional[bool] = None,
                 devprof_sample: Optional[float] = None, *,
                 attn_impl: Optional[str] = None,
                 spec_ngram: Optional[int] = None, device=None):
        g = _flags.get_flags(["serving_max_slots", "serving_max_len",
                              "serving_max_queue",
                              "serving_prefill_buckets",
                              "serving_max_new_tokens", "serving_paged",
                              "serving_idle_wait", "serving_dispatch_ahead",
                              "serving_block_size", "serving_num_blocks",
                              "serving_prefix_cache", "serving_kv_dtype",
                              "serving_attn_impl", "serving_megastep",
                              "serving_spec_tokens",
                              "serving_spec_ngram",
                              "serving_slo_ttft_ms",
                              "serving_slo_prefill_ms",
                              "serving_slo_tpot_ms",
                              "serving_priority_preempt",
                              "serving_lora_rank",
                              "serving_lora_max_adapters",
                              "serving_host_tier", "serving_host_blocks",
                              "serving_devprof", "serving_devprof_sample"])
        if mesh is not None:
            raise NotImplementedError(
                "mesh= (tensor-parallel serving) is not ported yet "
                "(ROADMAP A5: sharding)")
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
        # SLO-aware admission: 0 disables (depth-only backpressure); the
        # knobs are read once, at construction
        self.slo_ttft_ms = float(slo_ttft_ms if slo_ttft_ms is not None
                                 else g["serving_slo_ttft_ms"])
        if self.slo_ttft_ms < 0:
            raise ValueError(
                f"slo_ttft_ms must be >= 0, got {self.slo_ttft_ms}")
        self._prefill_ms_pin = float(
            slo_prefill_ms if slo_prefill_ms is not None
            else g["serving_slo_prefill_ms"])
        self._tpot_ms_pin = float(slo_tpot_ms if slo_tpot_ms is not None
                                  else g["serving_slo_tpot_ms"])
        if self._prefill_ms_pin < 0 or self._tpot_ms_pin < 0:
            raise ValueError("pinned predictor costs must be >= 0")
        self.priority_preempt = bool(
            priority_preempt if priority_preempt is not None
            else g["serving_priority_preempt"])
        # measured costs feeding predict_ttft_ms when no pin is set:
        # prefill ms per bucket and overall, decode ms per output token
        self._prefill_ewma: Dict[int, float] = {}
        self._prefill_ewma_all: Optional[float] = None
        self._tpot_ewma: Optional[float] = None
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
        if kv_pool is not None:
            # co-located disaggregated roles share one pool: geometry and
            # KV dtype come from the pool, so the sharing cache cannot
            # drift from what the blocks are
            if not self.paged:
                raise ValueError(
                    "kv_pool sharing requires the paged KV cache "
                    "(FLAGS_serving_paged)")
            if kv_pool.device != self.device:
                raise ValueError(f"kv_pool lives on {kv_pool.device}, "
                                 f"engine on {self.device}")
            if kv_dtype is None:
                self.kv_dtype = kv_pool.kv_dtype
            self.cache = BlockKVCache(
                cfg.num_layers, cfg.num_heads, cfg.head_dim,
                self.max_slots, self.max_len,
                block_size=kv_pool.block_size,
                prefix_cache=bool(prefix_cache if prefix_cache is not None
                                  else g["serving_prefix_cache"]),
                kv_dtype=self.kv_dtype, pool=kv_pool)
        elif self.paged:
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
        # multi-tenant paged LoRA: the pool's geometry joins the step
        # keys, loads and evicts are data. A shared lora_pool= serves a
        # fleet; tenants resolve by name per step.
        rank = int(lora_rank if lora_rank is not None
                   else g["serving_lora_rank"])
        if lora_pool is not None:
            if lora_pool.device != self.device:
                raise ValueError(f"lora_pool lives on {lora_pool.device}, "
                                 f"engine on {self.device}")
            self.lora_pool = lora_pool
        elif rank > 0:
            self.lora_pool = LoRAPool(
                cfg, rank,
                int(lora_max_adapters if lora_max_adapters is not None
                    else g["serving_lora_max_adapters"]),
                device=self.device)
        else:
            self.lora_pool = None
        if self.lora_pool is not None and not self.paged:
            raise ValueError(
                "multi-tenant LoRA requires the paged KV cache "
                "(FLAGS_serving_paged); the dense steps carry no "
                "adapter-page input")
        self._lora_shape = (None if self.lora_pool is None
                            else self.lora_pool.shape_key)
        # the host KV tier: a shared kv_tier= serves a fleet,
        # FLAGS_serving_host_tier builds one for this engine
        self.kv_tier = kv_tier
        if (kv_tier is not None or g["serving_host_tier"]) and \
                not self.paged:
            raise ValueError(
                "the host KV tier requires the paged KV cache "
                "(FLAGS_serving_paged); dense slots have no "
                "block-granular migration")
        if kv_tier is None and g["serving_host_tier"]:
            self.kv_tier = TierManager(HostBlockStore(
                cfg.num_layers, cfg.num_heads, cfg.head_dim,
                block_size=self.cache.block_size,
                num_blocks=int(g["serving_host_blocks"]),
                pin_memory=self.device.type == "cuda"))
        if self.kv_tier is not None:
            self.kv_tier.attach(self.cache)
        # first-seen-cold times of prefix entries, for the demotion
        # sweep's idle window (step-lock owned)
        self._cold_since: Dict[int, float] = {}
        # JSON-constrained decoding: a JsonGrammar whose request cursors
        # give the additive [vocab] mask rows; json_mode submissions
        # without one are refused
        self.grammar = grammar
        if self.grammar is not None and \
                self.grammar.vocab_size != cfg.vocab_size:
            raise ValueError(
                f"grammar vocab {self.grammar.vocab_size} != model "
                f"vocab {cfg.vocab_size}")
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
        self._lock = _ccz.make_lock("engine._lock")  # queue + _all
        self._step_lock = _ccz.make_lock(
            "engine._step_lock")             # one scheduler at a time
        self._wake = threading.Event()
        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._completed = 0                         # guarded-by: _lock
        self._slo_met = 0                           # guarded-by: _lock
        self._shed_by_reason: Dict[str, int] = {}   # guarded-by: _lock
        self._canceled_by_reason: Dict[str, int] = {}  # guarded-by: _lock
        self._tenant_stats: Dict[str, List[int]] = {}  # guarded-by: _lock
        eid = str(next(ServingEngine._engine_ids))
        self._eid = eid
        self._lora_gauge = None
        if self.lora_pool is not None:
            self._lora_gauge = _obs.gauge(
                "serving_lora_adapters_loaded",
                "LoRA adapters resident in this engine's paged "
                "adapter pool (base page excluded)").labels(engine=eid)
            self._lora_gauge.set(len(self.lora_pool.loaded))
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
        self._cancel_ctr = _obs.counter(
            "serving_canceled_total",
            "requests canceled mid-lifecycle, by reason (client|"
            "disconnect|deadline|hedge_lose|duplicate); every cancel "
            "reclaims its KV blocks and LoRA pin at whatever stage it "
            "caught the request")
        self._slo_gauge = None
        if self.slo_ttft_ms:
            self._slo_gauge = _obs.gauge(
                "serving_slo_attainment",
                "fraction of completed requests whose first token met "
                "the TTFT SLO (FLAGS_serving_slo_ttft_ms)"
                ).labels(engine=eid)
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
        # the device-cost observatory: a sampled timer around the step
        # dispatches (observability/devprof.py), read once here like the
        # SLO knobs; sampling hashes the dispatch counter, so a skipped
        # dispatch runs exactly as with devprof off
        self._devprof = None
        if bool(devprof if devprof is not None else g["serving_devprof"]):
            self._devprof = _devprof.DevProfiler(
                sample=(devprof_sample if devprof_sample is not None
                        else float(g["serving_devprof_sample"])),
                gauge_labels={"engine": eid}, device=self.device,
                dtype=next(model.parameters()).dtype)
        self._prefix_hit_reqs = 0   # guarded-by: _step_lock
        self._prefix_miss_reqs = 0  # guarded-by: _step_lock
        self._qerr_max = 0.0        # guarded-by: _step_lock
        self._spec_proposed = 0     # guarded-by: _step_lock
        self._spec_accepted = 0     # guarded-by: _step_lock
        # the sampled steps' [slots, V] mask, held by their graphs by
        # address: zero but for the rows of grammar-constrained requests,
        # whose slots _mask_rows names
        self._mask = None                 # guarded-by: _step_lock
        self._mask_rows: set = set()      # guarded-by: _step_lock
        self._prefill_fns: Dict[int, dict] = {}   # bucket len -> entry
        self._weight_version = 0          # guarded-by: _step_lock
        self.prefill_dispatches = 0       # guarded-by: _step_lock
        # single-step and N-iteration decode dispatches (megasteps counted
        # as enqueued: a dispatch-ahead speculation is one, hit or not)
        self.decode_steps = 0             # guarded-by: _step_lock
        self.megastep_dispatches = 0      # guarded-by: _step_lock
        # dispatch-ahead speculation: megastep k+1's device outputs,
        # enqueued while k's commit ran; consumed by the next decode only
        # when the scheduler state it assumed is unchanged
        self._ahead = None                # guarded-by: _step_lock
        self._ahead_hits = 0              # guarded-by: _step_lock
        self._ahead_misses = 0            # guarded-by: _step_lock
        # pinned host buffers a megastep's outputs are copied into while
        # the next one is enqueued (CUDA with dispatch-ahead)
        self._pinned: Dict[tuple, torch.Tensor] = {}  # guarded-by: _step_lock
        # dynamic half of the `# guarded-by:` declarations above: under
        # FLAGS_sanitize_locks a rebinding write to any of these without
        # the named lock held raises GuardedStateError. Construction
        # writes precede this call and are exempt by design. The
        # reference's set, then the port's own (the mask and the
        # dispatch counts, written by the scheduler only)
        _ccz.declare_guarded(self, {
            "_queue": "_lock", "_all": "_lock", "_completed": "_lock",
            "_slo_met": "_lock", "_shed_by_reason": "_lock",
            "_canceled_by_reason": "_lock",
            "_tenant_stats": "_lock",
            "_active": "_step_lock", "_spec_proposed": "_step_lock",
            "_spec_accepted": "_step_lock",
            "_prefix_hit_reqs": "_step_lock",
            "_prefix_miss_reqs": "_step_lock",
            "_weight_version": "_step_lock",
            "_qerr_max": "_step_lock",
            "_ahead": "_step_lock",
            "_ahead_hits": "_step_lock",
            "_ahead_misses": "_step_lock",
            "_mask": "_step_lock", "_mask_rows": "_step_lock",
            "_pinned": "_step_lock",
            "prefill_dispatches": "_step_lock",
            "decode_steps": "_step_lock",
            "megastep_dispatches": "_step_lock",
        })

    # --------------------------------------------------- TTFT prediction
    _EWMA_ALPHA = 0.3

    def _ewma(self, old: Optional[float], new: float) -> float:
        if old is None:
            return new
        return (1.0 - self._EWMA_ALPHA) * old + self._EWMA_ALPHA * new

    def _note_prefill_ms(self, bucket: int, ms: float):
        self._prefill_ewma[bucket] = self._ewma(
            self._prefill_ewma.get(bucket), ms)
        self._prefill_ewma_all = self._ewma(self._prefill_ewma_all, ms)

    def _note_tpot_ms(self, ms: float):
        self._tpot_ewma = self._ewma(self._tpot_ewma, ms)

    def _prefill_cost_ms(self, bucket: int) -> float:
        """Estimated cost of one prefill dispatch of this bucket: the pin
        when set, else the measured EWMA (the overall one before this
        bucket's first dispatch; 0 before any)."""
        if self._prefill_ms_pin:
            return self._prefill_ms_pin
        v = self._prefill_ewma.get(bucket, self._prefill_ewma_all)
        return 0.0 if v is None else v

    def _tpot_cost_ms(self) -> float:
        if self._tpot_ms_pin:
            return self._tpot_ms_pin
        return self._tpot_ewma if self._tpot_ewma is not None else 0.0

    def reset_cost_estimates(self):
        """Drop the learned EWMA costs (pins stay): call after a warm-up
        that paid the captures, so predictions reflect steady-state
        dispatch costs."""
        self._prefill_ewma.clear()
        self._prefill_ewma_all = None
        self._tpot_ewma = None

    def predict_ttft_ms(self, prompt_len: int = 1,
                        queue_ahead: Optional[int] = None) -> float:
        """First-order TTFT prediction for a would-be submission, in ms,
        from host state only, monotone non-decreasing in queue depth.
        Requests ahead prefill in waves of ``max_slots`` (``ceil(q /
        max_slots)`` dispatches before ours), and the newcomer waits
        ``ceil(max(0, q + 1 - free) / max_slots)`` generation rounds for
        a row, each one mean new-token budget at the current TPOT. With
        neither pins nor measurements the prediction is 0."""
        if queue_ahead is None:
            with self._lock:
                queue_ahead = len(self._queue)
        return self._predict_ttft_ms(int(queue_ahead), int(prompt_len))

    def _predict_ttft_ms(self, q: int, prompt_len: int) -> float:
        bucket = self._bucket_for(max(1, min(prompt_len, self.max_len)))
        prefill = self._prefill_cost_ms(bucket)
        tpot = self._tpot_cost_ms()
        live = list(self._active.values())
        budgets = [r.max_new_tokens for r in live]
        budgets += [r.max_new_tokens for r in list(self._queue)[:q]]
        mean_budget = (sum(budgets) / len(budgets) if budgets
                       else self.default_max_new_tokens)
        free = max(0, self.max_slots - len(live))
        waves_ahead = -(-q // self.max_slots)
        rounds = -(-max(0, q + 1 - free) // self.max_slots)
        return (waves_ahead + 1) * prefill + rounds * mean_budget * tpot

    def _retry_after_s(self, pred_ms: float) -> int:
        """Whole-second backoff hint for a shed submission: the predicted
        TTFT when the model has estimates, else the idle wait; >= 1."""
        if pred_ms > 0:
            return max(1, int(-(-pred_ms // 1e3)))
        return max(1, int(-(-self.idle_wait // 1)))

    def _pick_victims(self, priority: int, n: int,
                      exclude: Sequence[Request] = ()) -> List[Request]:
        """(holding ``_lock``) Queued requests a priority-``priority``
        submission may preempt: strictly lower-priority (numerically
        greater) classes only, worst class first, newest first within a
        class."""
        pool = [r for r in self._queue
                if r.priority > priority and r not in exclude]
        pool.sort(key=lambda r: (-r.priority, -r.id))
        return pool[:max(0, n)]

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
               json_mode: Optional[bool] = None,
               tenant: Optional[str] = None,
               decode: Optional[DecodeParams] = None,
               deadline_ms: Optional[float] = None,
               session: Optional[str] = None,
               _log_request: bool = True) -> Request:
        """Queue a generation request; returns its handle. Temperature
        0 (the default) is greedy; above 0 the request samples, after
        top-k (0: off) and top-p (0 or 1: off), from the stream of
        ``seed``. ``json_mode`` masks decoding to the engine's JSON
        ``grammar``, so the completion is valid JSON by construction.
        ``priority`` is an integer class, lower is more urgent
        (default 1), FIFO within a class. ``deadline_ms`` is a hard
        deadline in engine-clock ms from submission after which the
        request is canceled wherever it is (reason "deadline").
        ``tenant`` names a loaded LoRA adapter whose page the steps
        gather for this row. ``session`` names a conversation in the host
        KV tier: a stored context is prepended to ``prompt``, and the
        finished request's context is saved back.

        Raises ValueError for geometry the cache cannot hold (prompt +
        ``max_new_tokens`` + ``spec_tokens`` rows), token ids outside
        the vocabulary or a ``deadline_ms`` <= 0; QueueFullError when
        admission sheds the submission (a full queue, a predicted TTFT
        past the SLO, a draining engine, an injected ``serving.submit``
        skip), with ``reason`` and ``retry_after_s``; with preemption on,
        a submission that would be shed may shed queued lower-priority
        work instead. ValueError for ``json_mode`` without a grammar or
        with speculative decoding.
        ``_log_request`` False leaves out the run log's
        ``serving_request`` arrival record (a router logs its own)."""
        if deadline_ms is not None and float(deadline_ms) <= 0:
            raise ValueError(
                f"deadline_ms must be > 0, got {deadline_ms}")
        mnt = int(max_new_tokens if max_new_tokens is not None
                  else self.default_max_new_tokens)
        eos = (eos_token_id if eos_token_id is not None
               else self.default_eos_token_id)
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError("empty prompt")
        sid = str(session) if session is not None else None
        stored_ctx = None
        if sid is not None:
            if not sid:
                raise ValueError("session id must be non-empty")
            if self.kv_tier is None:
                raise ValueError(
                    "submit(session=...) requires the host KV tier: "
                    "set FLAGS_serving_host_tier or construct the "
                    "engine with kv_tier=")
            stored_ctx = self.kv_tier.session_context(sid)
            if stored_ctx:
                # resume: the stored conversation goes first, so the
                # rolling-hash chain matches what the last turn published
                prompt = stored_ctx + prompt
        if any(t < 0 or t >= self._vocab for t in prompt):
            raise ValueError(f"prompt token ids must be in [0, "
                             f"{self._vocab})")
        if mnt < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {mnt}")
        if decode is not None:
            if any(v is not None for v in (temperature, top_k, top_p,
                                           stop, seed, json_mode)):
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
                seed=int(seed) if seed is not None else 0,
                json_mode=bool(json_mode) if json_mode is not None
                else False)
        tenant = str(tenant) if tenant is not None else ""
        if params.json_mode:
            if self.grammar is None:
                raise ValueError(
                    "json_mode requires an engine constructed with a "
                    "grammar= (see serving.decoding.JsonGrammar)")
            if self.spec_tokens > 0:
                raise ValueError(
                    "json_mode cannot combine with speculative decoding "
                    "(FLAGS_serving_spec_tokens > 0): the delta draft "
                    "proposes unmasked tokens")
        if tenant:
            if self.lora_pool is None:
                raise ValueError(
                    "tenant= requires a LoRA pool; construct the engine "
                    "with lora_rank > 0 (FLAGS_serving_lora_rank)")
            self.lora_pool.page_of(tenant)  # unknown adapter -> ValueError
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
        pr = int(priority if priority is not None else 1)
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
                if params.json_mode:
                    extra["json_mode"] = True
            if tenant:
                extra["tenant"] = tenant
            if sid is not None:
                extra["session"] = sid
            _runlog.log_event("serving_request", t=round(now, 6),
                              prompt=prompt, max_new_tokens=mnt,
                              priority=pr, engine=self._eid, **extra)
        if self.draining:
            _monitor.stat_add("STAT_serving_rejected")
            self._count_shed("drain", pr)
            raise QueueFullError("engine is draining; resubmit to a "
                                 "live replica", reason="drain",
                                 retry_after_s=self._retry_after_s(0.0))
        # raising kinds reject this submission pre-queue; `skip` sheds
        # it through the same backpressure exit as a full queue
        kind = fault_point("serving.submit")
        if kind == "skip":
            _monitor.stat_add("STAT_serving_rejected")
            self._count_shed("fault", pr)
            raise QueueFullError("submission shed by injected fault at "
                                 "serving.submit", reason="fault",
                                 retry_after_s=self._retry_after_s(0.0))
        req = Request(prompt, mnt, eos, priority=pr, now=now, decode=params,
                      tenant=tenant)
        req.session = sid
        if params.json_mode:
            req._cursor = self.grammar.start()
        if self.slo_ttft_ms:
            req.deadline = now + self.slo_ttft_ms / 1e3
        if deadline_ms is not None:
            req.hard_deadline = now + float(deadline_ms) / 1e3
        reject = None          # (reason, predicted ms) when shedding
        victims: List[Request] = []
        with self._lock:
            q = len(self._queue)
            if q >= self.max_queue:
                if self.priority_preempt:
                    victims = self._pick_victims(
                        pr, q - self.max_queue + 1)
                if q - len(victims) >= self.max_queue:
                    reject = ("queue_full",
                              self._predict_ttft_ms(q, len(prompt)))
            if reject is None and self.slo_ttft_ms:
                pred = self._predict_ttft_ms(q - len(victims),
                                             len(prompt))
                while pred > self.slo_ttft_ms and self.priority_preempt:
                    more = self._pick_victims(pr, 1, exclude=victims)
                    if not more:
                        break
                    victims.extend(more)
                    pred = self._predict_ttft_ms(q - len(victims),
                                                 len(prompt))
                if pred > self.slo_ttft_ms:
                    reject = ("slo", pred)
            if reject is None:
                for v in victims:
                    self._queue.remove(v)
                self._queue.append(req)
                self._all.append(req)
            else:
                victims = []   # rejected anyway: preempt nothing
        for v in victims:
            self._shed(v, _Shed(f"preempted by priority-{pr} request "
                                f"{req.id}"), reason="preempted")
        if reject is not None:
            reason, pred = reject
            _monitor.stat_add("STAT_serving_rejected")
            self._count_shed(reason, pr)
            if reason == "queue_full":
                msg = (f"serving queue full ({self.max_queue} waiting); "
                       "retry later or raise FLAGS_serving_max_queue")
            else:
                msg = (f"predicted TTFT {pred:.0f}ms exceeds SLO "
                       f"{self.slo_ttft_ms:.0f}ms; retry later or shed")
            raise QueueFullError(msg, reason=reason,
                                 retry_after_s=self._retry_after_s(pred))
        _monitor.stat_add("STAT_serving_submitted")
        if sid is not None:
            req._session_counted = True
            self.kv_tier.session_started(sid)
            if stored_ctx:
                self.kv_tier.session_resumed(
                    sid, len(stored_ctx), len(prompt) - len(stored_ctx))
        _tracing.begin(req.id, req.submitted_at, self.trace_track,
                       prompt_tokens=len(req.prompt),
                       max_new_tokens=req.max_new_tokens,
                       priority=req.priority, tenant=req.tenant)
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

    def _prefill_group_attempt(self, bucket: int, group):  # holds: _step_lock
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

    def _pop_candidates(self, limit: int):
        """Pop up to ``limit`` queued requests in admission order,
        (priority class, submission id), which is FIFO when every
        request has the default class, shedding those whose TTFT
        deadline passed (reason "deadline") and canceling those whose
        hard deadline passed. Returns ``(candidates, n_expired)``."""
        out: List[Request] = []
        expired: List[Request] = []
        hard_expired: List[Request] = []
        now = self._clock()
        with self._lock:
            if len(self._queue) > 1 and \
                    any(r.priority != self._queue[0].priority
                        for r in self._queue):
                self._queue = deque(sorted(
                    self._queue, key=lambda r: (r.priority, r.id)))
            while len(out) < limit and self._queue:
                req = self._queue.popleft()
                if req.hard_deadline is not None and \
                        now > req.hard_deadline:
                    hard_expired.append(req)
                elif req.deadline is not None and now > req.deadline:
                    expired.append(req)
                else:
                    out.append(req)
        for req in expired:
            self._shed(req, _Shed("TTFT deadline expired in queue for "
                                  f"request {req.id}"),
                       reason="deadline")
        for req in hard_expired:
            self._finalize_cancel(req, "queued", "deadline")
        return out, len(expired) + len(hard_expired)

    def _mark_admit(self, reqs):
        t_adm = self._clock()
        for req in reqs:
            _tracing.mark(req.id, "admit", t_adm, self.trace_track)

    def _admit_round_dense(self):  # holds: _step_lock
        """One dense admission pass: pop up to ``num_free`` queued
        requests, group them by prefill bucket, one batched prefill per
        group (retried through ``RetryPolicy``), whose rows are copied
        into freshly allocated slots. Returns (consumed, admitted)."""
        candidates, expired = self._pop_candidates(self.cache.num_free)
        groups: Dict[int, List[Request]] = {}
        for req in candidates:
            groups.setdefault(self._bucket_for(len(req.context)),
                              []).append(req)
        admitted = 0
        for bucket in sorted(groups):
            group = groups[bucket]
            self._mark_admit(group)
            timer = self._devprof_timer(
                f"serving_prefill{{bucket={bucket}}}")
            t0 = time.perf_counter()
            try:
                with _monitor.stat_time("STAT_serving_prefill"), \
                        _jit.timed_replays(timer):
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
            # the window closes after the host read the tokens, so it
            # holds the replay's device time too
            self._note_prefill_ms(bucket, (time.perf_counter() - t0) * 1e3)
            if timer is not None:
                timer.device_done(out)
            for i, (req, slot) in enumerate(zip(live, slots)):
                req.slot = slot
                req.state = "running"
                self._active[slot] = req
                admitted += 1
                _monitor.stat_add("STAT_serving_prefills")
                _runlog.log_event("serving_admit", request=req.id,
                                  bucket=bucket, slot=slot,
                                  prompt_tokens=len(req.prompt))
                self._mark_resume(req)
                # the first generated token comes from the prefill logits
                # (the argmax greedy_search takes after its own prefill)
                self._append_token(req, self._take_first(req, first, lg, i))
            if timer is not None:
                timer.finish()
        return expired + len(candidates), admitted

    def _mark_resume(self, req: Request):
        """A re-homed request re-prefilled its committed context: its
        trace resumes decoding here instead of stamping a first token."""
        if req.first_token_at is not None:
            _tracing.mark(req.id, "resume", self._clock(),
                          self.trace_track)

    def _prefill_entry_paged(self, bucket: int) -> dict:
        """The step-cache entry of one bucket's batched prefill at this
        engine's geometry (``max_slots`` rows), keyed as the reference's
        ``_prefill_entry_paged``: bucket, max_slots, max_len, block
        size, block count, KV dtype, attention implementation."""
        c = self.cache
        ent = _gen.prefill_step_paged(
            self.model, bucket,
            (self.max_slots, self.max_len, c.block_size, c.num_blocks),
            self.kv_dtype, self.attn_impl, self._lora_shape)
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
        if self.kv_tier is not None:
            # promotion on demand: the host-resident continuation of the
            # context's chain comes back first and republishes as device
            # prefix entries, which acquire() then shares. Idempotent
            # under retry; a failed promotion only means a longer prefill
            self.kv_tier.promote(self.cache, req.context)
        return self.cache.acquire(req.context, need)

    def _prefill_group_attempt_paged(self, bucket: int, group):  # holds: _step_lock
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
        pages = np.zeros(self.max_slots, np.int32)
        for i, (req, row, shared) in enumerate(live):
            suffix = req.context[shared:]
            ids[i, :len(suffix)] = suffix
            last[i] = len(suffix) - 1
            pos[i] = shared
            tables[i] = self.cache.tables[row]
            if self.lora_pool is not None and req.tenant:
                pages[i] = self.lora_pool.page_of(req.tenant)
        fn = self._prefill_entry_paged(bucket)["fn"]
        lora = (None if self.lora_pool is None
                else (pages, self.lora_pool.arrays))
        self.cache.pool.note_write()
        out = fn(ids, last, pos, tables, self.cache.arrays(), lora=lora)
        self.prefill_dispatches += 1
        return live, shed, out

    def _admit_round_paged(self):  # holds: _step_lock
        """One paged admission pass: pop up to ``num_free`` queued
        requests in FIFO order, acquire a block table for each (retried
        through ``RetryPolicy`` at ``serving.alloc``), group by the
        unshared suffix's bucket, one batched prefill per group (retried
        at ``serving.step``). A dry pool requeues the head-of-line
        request and all behind it. Returns (consumed, admitted)."""
        candidates, expired = self._pop_candidates(self.cache.num_free)
        if not candidates:
            return expired, 0
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
            if req.tenant and self.lora_pool is not None:
                # pin the tenant's page for the request's lifetime
                # (released at its exit); an adapter evicted between
                # submit and admission sheds here
                try:
                    self.lora_pool.acquire(req.tenant)
                    req._lora_held = True
                except ValueError as e:
                    self.cache.release_row(res[0])
                    self._shed(req, _Shed(str(e)))
                    continue
            acquired.append((req, res[0], res[1]))
        if back:
            with self._lock:
                self._queue.extendleft(reversed(back))
        if not acquired:
            return expired + len(candidates) - len(back), 0
        groups: Dict[int, List] = {}
        for rec in acquired:
            req, row, shared = rec
            groups.setdefault(self._bucket_for(len(req.context) - shared),
                              []).append(rec)
        admitted = 0
        for bucket in sorted(groups):
            group = groups[bucket]
            self._mark_admit([rec[0] for rec in group])
            timer = self._devprof_timer(
                f"serving_prefill_paged{{bucket={bucket}}}")
            t0 = time.perf_counter()
            try:
                with _monitor.stat_time("STAT_serving_prefill"), \
                        _jit.timed_replays(timer):
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
            first = torch.argmax(lg, dim=-1).cpu().numpy()
            self._note_prefill_ms(bucket, (time.perf_counter() - t0) * 1e3)
            if timer is not None:
                timer.device_done(out)
            self._note_qerr(qerr, sum(len(req.context) - shared
                                      for req, _, shared in live))
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
                self._mark_resume(req)
                self._append_token(req, self._take_first(req, first, lg, i))
            if timer is not None:
                timer.finish()
        return expired + len(candidates) - len(back), admitted

    def _take_first(self, req: Request, first: np.ndarray, lg,
                    i: int) -> int:
        """The request's first generated token from its prefill-logits
        row: the batch argmax for plain greedy rows, a
        :func:`sample_first` draw with the request's key (and its grammar
        mask row) for sampled or constrained ones (the law the steps
        apply, so a restart replays it)."""
        if req.decode.is_greedy and req._cursor is None:
            return int(first[i])
        mask_row = None
        if req._cursor is not None:
            mask_row = req._cursor.mask_row(
                req.max_new_tokens - len(req.tokens))
        tok, req._key = sample_first(lg[i], req.decode, req._key, mask_row)
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
    def _note_qerr(self, qerr, rows: int):  # holds: _step_lock
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

    def _build_samp(self):  # holds: _step_lock
        """The sampled steps' per-slot inputs, rebuilt from the active
        requests every step: ``(temperature [b] f32, top_k [b] i32, top_p
        [b] f32, keys [b, 2] int64, mask [b, V])``, empty rows at the
        greedy neutral values, the mask the engine's one device buffer
        (:meth:`_write_mask`). None when no active row samples or has a
        grammar cursor: the step then replays its greedy graph, which
        never reads the mask. A greedy constrained row needs
        ``argmax(logits + mask)``, which only the sampled graph computes
        (temperature 0 rows take it there)."""
        if all(req.decode.is_greedy and req._cursor is None
               for req in self._active.values()):
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
        self._write_mask()
        return temp, tk, tp, keys, self._mask

    def _write_mask(self):  # holds: _step_lock
        """Bring the mask buffer to this step's rows before the replay
        that reads it: each constrained row gets its cursor's mask row
        for the next position (budget-aware, so the document closes in
        time), and every row a constrained request left (finish, cancel,
        shed, kill, handoff) is zeroed. The rows are built on the host
        and copied in place on the current stream, the stream the replay
        runs on, from a host buffer the copy has finished reading when
        ``to()`` returns (a blocking copy); the graphs hold the buffer by
        address, so nothing is captured."""
        want = {slot: req for slot, req in self._active.items()
                if req._cursor is not None}
        stale = sorted(self._mask_rows - set(want))
        if stale:
            self._mask.index_fill_(
                0, torch.tensor(stale, device=self.device), 0.0)
        if want:
            slots = sorted(want)
            rows = np.empty((len(slots), self._vocab), np.float32)
            for i, slot in enumerate(slots):
                req = want[slot]
                req._cursor.mask_row(req.max_new_tokens - len(req.tokens),
                                     out=rows[i])
            self._mask.index_copy_(
                0, torch.tensor(slots, device=self.device),
                torch.from_numpy(rows).to(self.device))
        self._mask_rows = set(want)

    def _writeback_keys(self, new_keys, rows=None):
        """Keep each sampled row's advanced key on its request (``rows``:
        the slots to keep, default every active one); greedy rows' keys
        never feed a draw and stay as they were."""
        if new_keys is None:
            return
        arr = (new_keys if isinstance(new_keys, np.ndarray)
               else new_keys.cpu().numpy())
        for slot, req in self._active.items():
            if not req.decode.is_greedy and (rows is None or slot in rows):
                req._key = arr[slot].astype(np.uint32)

    def _lora_args(self):
        """The steps' LoRA input ``(page_ids [b] i32, pool tensors)``:
        each active row's tenant resolved by name to its current page
        (in-flight requests pin it), empty and base rows on page 0; None
        without a pool."""
        if self.lora_pool is None:
            return None
        pages = np.zeros(self.max_slots, np.int32)
        for slot, req in self._active.items():
            if req.tenant:
                pages[slot] = self.lora_pool.page_of(req.tenant)
        return pages, self.lora_pool.arrays

    def _decode_attempt(self, tokens: np.ndarray):
        """One decode dispatch attempt (the ``serving.step`` fault site;
        an injected `skip` skips the iteration)."""
        kind = fault_point("serving.step")
        if kind == "skip":
            raise _SkipStep("injected skip of one decode iteration")
        if self.paged:
            fn = _gen.decode_step_paged(
                self.model, kv_dtype=self.kv_dtype,
                lora_shape=self._lora_shape, attn_impl=self.attn_impl)["fn"]
            self.cache.pool.note_write()
            return fn(tokens, self.cache.lengths, self.cache.tables,
                      self.cache.arrays(), self._build_samp(),
                      lora=self._lora_args())
        fn = _gen.decode_step(self.model)["fn"]
        return fn(tokens, self.cache.lengths, self.cache.arrays(),
                  self._build_samp())

    def _shed_active(self, err: BaseException):  # holds: _step_lock
        """The step itself is unrecoverable (retries exhausted): shed
        every active request, keep the engine alive for new ones."""
        for slot, req in list(self._active.items()):
            del self._active[slot]
            self.cache.release(slot)
            self._shed(req, err)

    def _devprof_timer(self, entry: str):  # holds: _step_lock
        """A StepTimer when devprof is on and this dispatch hashed into
        the sample, else None. The tick consumes one counter increment
        either way, so two same-seed runs sample the same dispatches.
        On the card with the real clock the timer reads CUDA events
        around the dispatch; on any other clock (a virtual one) it stamps
        that clock, so virtual-clock replays stay deterministic."""
        dp = self._devprof
        if dp is None or not dp.tick():
            return None
        events = (self.device.type == "cuda" and
                  self._clock is time.perf_counter)
        return _devprof.StepTimer(dp, entry, self._clock,
                                  device=self.device if events else None)

    def _decode(self) -> int:  # holds: _step_lock
        """One batched decode over every occupied row, retried through
        ``RetryPolicy`` at ``serving.step``. Returns how many tokens were
        produced (0 when skipped or shed)."""
        if not self._active:
            return 0
        tokens = np.zeros(self.max_slots, np.int32)
        for slot, req in self._active.items():
            tokens[slot] = req.tokens[-1]
        timer = self._devprof_timer(
            "decode_step_paged" if self.paged else "decode_step")
        t0 = time.perf_counter()
        try:
            with _monitor.stat_time("STAT_serving_decode"), \
                    _jit.timed_replays(timer):
                out = RetryPolicy.from_flags("serving.step").call(
                    self._decode_attempt, tokens)
        except _SkipStep:
            return 0
        except RetryError as e:
            self._shed_active(e)
            return 0
        if self.paged:
            nxt, _, arrays, qerr, new_keys = out
        else:
            nxt, _, arrays, new_keys = out
        self.decode_steps += 1
        self.cache.set_arrays(arrays)
        nxt = nxt.cpu().numpy()
        # one token per active row: the step's wall, closed once the host
        # has the tokens, is already a per-token sample
        self._note_tpot_ms((time.perf_counter() - t0) * 1e3)
        if timer is not None:
            timer.device_done(out)
        if self.paged:
            self._note_qerr(qerr, len(self._active))
        self._writeback_keys(new_keys)
        produced = 0
        for slot, req in list(self._active.items()):
            self.cache.advance(slot, 1)
            self._append_token(req, int(nxt[slot]))
            produced += 1
        if timer is not None:
            timer.finish()      # host time: the commit loop above
        return produced

    # ------------------------------------------------ decode megasteps
    def _choose_megastep(self) -> int:  # holds: _step_lock
        """The N this decode runs at: the configured ``megastep`` unless
        the batch needs the per-token host loop, which takes the whole
        batch back to single steps (never to an intermediate N: the
        engine has two decode entries, the megastep and the single
        step): a grammar-constrained row (its mask is recomputed on the
        host every token), stops that do not fit the device tables, or a
        hard deadline that ends sooner than ``n`` tokens at the current
        TPOT."""
        n = self.megastep
        if n <= 1 or not self._active:
            return 1
        tpot = self._tpot_cost_ms()
        now = None
        for req in self._active.values():
            if req._cursor is not None or not req._stops_fit:
                return 1
            if req.hard_deadline is not None and tpot > 0:
                # a deadline too tight to absorb a whole megastep: the
                # dying client is reaped within one step, not a megastep
                if now is None:
                    now = self._clock()
                if (req.hard_deadline - now) * 1e3 < n * tpot:
                    return 1
        return n

    def _megastep_inputs(self):  # holds: _step_lock
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

    def _megastep_ctx(self, tables, samp, eos, stops, lora):  # holds: _step_lock
        """The inputs a megastep and every speculation chained on it
        share: the tables, the sampling constants, eos, the stop tables
        and the LoRA page ids, as they were when it was dispatched. With
        dispatch-ahead they are copied to the device once (from pinned
        copies, so the host's later edits of its arrays never race the
        copy), and a speculation's step copies them device to device."""
        ctx = {"tables": tables, "samp": samp, "eos": eos, "stops": stops,
               "lora": lora}
        if not self.dispatch_ahead:
            return ctx

        def dev(a):
            t = torch.from_numpy(np.array(a, copy=True))
            if self.device.type == "cuda":
                t = t.pin_memory()
            return t.to(self.device, non_blocking=True)

        ctx["tables"] = dev(tables)
        ctx["eos"] = dev(eos)
        ctx["stops"] = tuple(dev(a) for a in stops)
        if samp is not None:
            temp, tk, tp, keys, mask = samp
            ctx["samp"] = (dev(temp), dev(tk), dev(tp), keys, mask)
        if lora is not None:
            ctx["lora"] = (dev(lora[0]), lora[1])
        return ctx

    def _megastep_attempt(self, n: int):  # holds: _step_lock
        """One megastep dispatch attempt (the ``serving.step`` fault
        site). The fault fires before the speculation is consumed, so an
        injected skip leaves the stored dispatch valid for the next
        attempt. Returns ``(out, ctx)``."""
        kind = fault_point("serving.step")
        if kind == "skip":
            raise _SkipStep("injected skip of one decode megastep")
        taken = self._take_ahead(n)
        if taken is not None:
            return taken
        fn = _gen.decode_megastep_paged(
            self.model, n, kv_dtype=self.kv_dtype,
            lora_shape=self._lora_shape, attn_impl=self.attn_impl)["fn"]
        tokens, lengths, tables, samp, live, budget, eos, stop = \
            self._megastep_inputs()
        ctx = self._megastep_ctx(tables, samp, eos, stop[:3],
                                 self._lora_args())
        ctx["fn"] = fn
        self.cache.pool.note_write()
        out = fn(tokens, lengths, ctx["tables"], self.cache.arrays(),
                 ctx["samp"], live, budget, ctx["eos"],
                 (*ctx["stops"], stop[3]), lora=ctx["lora"])
        self.megastep_dispatches += 1
        return out, ctx

    def _ahead_snapshot(self, n: int, extra_tokens: int = 0):  # holds: _step_lock
        """The scheduler state a speculative dispatch assumes: N, the
        weight, flag, pool-write and LoRA-load versions, and each active
        row's (slot, request id, committed length), with
        ``extra_tokens`` added per row for the post-commit state a
        pre-commit dispatch runs against."""
        return (n, self._weight_version, _flags.version(),
                self.cache.pool.write_version,
                None if self.lora_pool is None
                else self.lora_pool.load_version,
                tuple(sorted((slot, req.id, len(req.tokens) + extra_tokens)
                             for slot, req in self._active.items())))

    def _dispatch_ahead(self, n: int, out, ctx):  # holds: _step_lock
        """Enqueue megastep k+1 from k's device carry, before the host
        waits for k: the same graph, its small inputs copied on the
        device (no new key, no capture). It assumes k commits with no
        finish, no admission, no reap and no change of weights, flags,
        pools or adapters; :meth:`_take_ahead` checks all of that. The
        blocks it may write are saved first where a re-encoding (an int8
        pool) or a demotion (a host tier) would otherwise see its writes
        before it is taken."""
        (_toks, _finish, tok_f, pos_f, _pools, keys_f, live_f, rem_f,
         st_f, _qerr) = out
        samp = ctx["samp"]
        if samp is not None:
            samp = (*samp[:3], keys_f.to(torch.int64), samp[4])
        snap = None
        if self.kv_dtype == "int8" or self.kv_tier is not None:
            snap = _kvc.TailSnapshot(self.cache.pool, ctx["tables"],
                                     pos_f, n)
        spec = ctx["fn"](
            tok_f.to(torch.int32), pos_f.to(torch.int32), ctx["tables"],
            self.cache.arrays(), samp, live_f.to(torch.bool),
            rem_f.to(torch.int32), ctx["eos"],
            (*ctx["stops"], st_f.to(torch.int32)), lora=ctx["lora"])
        self.megastep_dispatches += 1
        self._ahead = {
            "n": n,
            "snap": self._ahead_snapshot(n, extra_tokens=n),
            "undo": snap,
            "out": spec,
            "ctx": ctx,
        }

    def _take_ahead(self, n: int):  # holds: _step_lock
        """Consume the stored speculation iff the live scheduler state is
        the one it assumed; a miss restores what it wrote to an int8
        pool. Single-shot: hit or miss, the slot clears."""
        ah, self._ahead = self._ahead, None
        if ah is None:
            return None
        ok = (ah["n"] == n and ah["snap"] == self._ahead_snapshot(n))
        ok = self.cache.pool.retire(ah["undo"], restore=not ok) and ok
        if not ok:
            self._ahead_misses += 1
            _monitor.stat_add("STAT_serving_ahead_misses")
            return None
        self._ahead_hits += 1
        _monitor.stat_add("STAT_serving_ahead_hits")
        return ah["out"], ah["ctx"]

    def _drop_ahead(self):  # holds: _step_lock
        """Discard a stored speculation uncounted (a single-step round,
        a kill), restoring the blocks its snapshot saved."""
        ah, self._ahead = self._ahead, None
        if ah is not None:
            self.cache.pool.retire(ah["undo"], restore=True)

    def _host_copy(self, out):  # holds: _step_lock
        """Start reading a megastep's host outputs (tokens, finishes,
        keys, the int8 error): on CUDA with dispatch-ahead, copies into
        pinned buffers behind it on the stream and an event after them,
        so a speculation can be enqueued before the host waits. Returns
        a function that waits and gives the numpy arrays (the error as a
        float or None)."""
        toks, finish, keys, qerr = out[0], out[1], out[5], out[9]
        if self.kv_dtype != "int8":
            qerr = None
        srcs = [toks, finish, keys, qerr]
        if not (self.dispatch_ahead and self.device.type == "cuda"):
            def now():
                return [None if t is None else t.cpu().numpy()
                        for t in srcs]
            return now
        dsts = []
        for i, t in enumerate(srcs):
            if t is None:
                dsts.append(None)
                continue
            key = (i, tuple(t.shape), t.dtype)
            buf = self._pinned.get(key)
            if buf is None:
                buf = self._pinned[key] = torch.empty(
                    t.shape, dtype=t.dtype, pin_memory=True)
            buf.copy_(t, non_blocking=True)
            dsts.append(buf)
        ev = torch.cuda.Event()
        ev.record()

        def wait():
            ev.synchronize()
            return [None if t is None else t.numpy() for t in dsts]
        return wait

    def _decode_megastep(self, n: int) -> int:  # holds: _step_lock
        """One megastep over every occupied row: ``n`` decode iterations
        in one dispatch (retried at ``serving.step``; consumed from a
        valid speculation with dispatch-ahead), then one host commit,
        each row's tokens replayed through :meth:`_append_token` (finish
        reasons re-derived on the host; the device's early exits are the
        same conditions). A row finishing at iteration f committed f + 1
        tokens, a live row all ``n``. With dispatch-ahead, megastep k+1
        is enqueued before the host waits for k; a devprof-sampled
        megastep waits for k first, so its device time is k's alone.
        Returns how many tokens were produced."""
        if not self._active:
            return 0
        n_active = len(self._active)
        timer = self._devprof_timer(f"decode_megastep_paged{{n={n}}}")
        t0 = time.perf_counter()
        try:
            with _monitor.stat_time("STAT_serving_decode"), \
                    _jit.timed_replays(timer):
                out, ctx = RetryPolicy.from_flags("serving.step").call(
                    self._megastep_attempt, n)
        except _SkipStep:
            return 0
        except RetryError as e:
            self._shed_active(e)
            return 0
        self.cache.set_arrays(out[4])
        wait = self._host_copy(out)
        if timer is not None:
            host = wait()
            timer.device_done(out)
        if self.dispatch_ahead:
            self._dispatch_ahead(n, out, ctx)
        if timer is None:
            host = wait()
        toks, finish, keys, qerr = host
        self._note_qerr(qerr, n * n_active)
        # a row still live after the n iterations keeps its key, split n
        # times; a finished row's key is never read again
        self._writeback_keys(keys, {s for s in self._active
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
        if produced:
            # per-token pace: the megastep's wall over the tokens each
            # row committed
            self._note_tpot_ms((time.perf_counter() - t0) * 1e3 *
                               n_active / produced)
        if timer is not None:
            timer.finish()
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
            fn = _gen.verify_step_paged(
                self.model, K, kv_dtype=self.kv_dtype,
                lora_shape=self._lora_shape, attn_impl=self.attn_impl)["fn"]
            self.cache.pool.note_write()
            return fn(tokens, self.cache.lengths, self.cache.tables,
                      self.cache.arrays(), self._build_samp(),
                      lora=self._lora_args())
        fn = _gen.verify_step(self.model, K)["fn"]
        return fn(tokens, self.cache.lengths, self.cache.arrays(),
                  self._build_samp())

    def _spec_decode(self) -> int:  # holds: _step_lock
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
        n_active = len(self._active)
        timer = self._devprof_timer(
            f"verify_step_paged{{k={K}}}" if self.paged
            else f"verify_step{{k={K}}}")
        t0 = time.perf_counter()
        try:
            with _monitor.stat_time("STAT_serving_verify"), \
                    _jit.timed_replays(timer):
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
        if timer is not None:
            timer.device_done(out)
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
        if produced:
            # per-token pace: the step's wall over the tokens each row
            # committed
            self._note_tpot_ms((time.perf_counter() - t0) * 1e3 *
                               n_active / produced)
        if timer is not None:
            timer.finish()
        return produced

    def _decode_any(self) -> int:  # holds: _step_lock
        """One decode round: the megastep when :meth:`_choose_megastep`
        allows it, else the single step."""
        n = self._choose_megastep()
        if n > 1:
            return self._decode_megastep(n)
        # a single-step round drops any stored speculation: its snapshot
        # could never match a state the single step advanced
        self._drop_ahead()
        return self._decode()

    def _append_token(self, req: Request, token: int):
        req.tokens.append(token)
        if req.first_token_at is None:
            req.first_token_at = self._clock()
            # the mark reuses the stamp, so the blame prefix up to the
            # first token equals the measured TTFT exactly
            _tracing.mark(req.id, "first_token", req.first_token_at,
                          self.trace_track)
        _monitor.stat_add("STAT_serving_tokens")
        if req._stop is not None:
            req._stop.feed(token)
        if req._cursor is not None:
            # the grammar's pushdown over the committed token; a complete
            # document ends the request (the budget-aware mask makes it
            # land in time)
            req._cursor.advance(token)
            if req._cursor.at_end:
                self._finish(req)
                return
        if (req.eos_token_id is not None and
                token == req.eos_token_id) or \
                len(req.tokens) >= req.max_new_tokens or \
                self._hit_stop(req):
            self._finish(req)

    def _hit_stop(self, req: Request) -> bool:
        """Whether a stop sequence is now a suffix of the generated
        tokens (the request's incremental matcher latched)."""
        return req._stop is not None and req._stop.hit

    def _release_pin(self, req: Request):
        """Drop the request's pin on its tenant's adapter page."""
        if req._lora_held:
            self.lora_pool.release(req.tenant)
            req._lora_held = False

    def _session_left(self, req: Request):
        """The request of a host-tier session left this engine: the
        resident-session gauge drops."""
        if req._session_counted and self.kv_tier is not None:
            req._session_counted = False
            self.kv_tier.session_released(req.session)

    def _finish(self, req: Request):  # holds: _step_lock
        if req.slot is not None:
            self._active.pop(req.slot, None)
            if req.session is not None and self.kv_tier is not None:
                # publish the finished conversation's full blocks before
                # the row's refs drop: the sweep demotes the now-cold
                # chain, and the next turn resumes off it
                self.cache.insert_prefix(req.slot, req.context)
            self.cache.release(req.slot)
            req.slot = None
        self._release_pin(req)
        req.state = "done"
        req.finished_at = self._clock()
        ttft, tpot = req.ttft, req.tpot
        if ttft is not None:
            self._ttft_hist.observe(ttft)
        if tpot is not None:
            self._tpot_hist.observe(tpot)
        met = req.deadline_met
        with self._lock:
            self._completed += 1
            if met:
                self._slo_met += 1
            completed, slo_met = self._completed, self._slo_met
            # [completed, slo-eligible, slo-met] per tenant ("base" for
            # requests without an adapter), as the reference counts them
            ts = self._tenant_stats.setdefault(req.tenant or "base",
                                               [0, 0, 0])
            ts[0] += 1
            if met is not None:
                ts[1] += 1
                if met:
                    ts[2] += 1
        if self._slo_gauge is not None and completed:
            self._slo_gauge.set(slo_met / completed)
        _monitor.stat_add("STAT_serving_completed")
        _runlog.log_event(
            "serving_finish", request=req.id, tokens=len(req.tokens),
            ttft_ms=None if ttft is None else round(ttft * 1e3, 3),
            tpot_ms=None if tpot is None else round(tpot * 1e3, 3),
            deadline_met=met)
        if req.session is not None and self.kv_tier is not None:
            self.kv_tier.session_save(req.session, req.context)
            self._session_left(req)
        if self._devprof is not None:
            # the sampled device share, so blame() splits this trace's
            # decode into decode_device + decode_host; None (no sample
            # yet, or zero-width virtual-clock samples) leaves the trace
            # and its exported bytes as without devprof
            frac = self._devprof.device_frac()
            if frac is not None:
                _tracing.annotate(req.id, decode_device_frac=frac)
        _tracing.finish(req.id, req.finished_at, self.trace_track, "done")
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
        self._release_pin(req)
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
        self._session_left(req)
        _tracing.finish(req.id, req.finished_at, self.trace_track,
                        "shed", reason=reason)
        req._done.set()

    # ------------------------------------------------------ cancellation
    def cancel(self, rid: int, reason: str = "client",
               _finalize: bool = True) -> Optional[dict]:
        """End request ``rid`` at whatever stage it reached, queued or
        in a row (before or after its first token), releasing its row
        and blocks at once: a table row is reset to the trash block
        before the next step builds its inputs. Host work only; nothing
        is captured. Returns ``{"id", "stage", "reason"}``, or None for
        an unknown or already-ended request (a second cancel is a
        no-op).

        ``_finalize=False`` is the router's detached mode for a hedge
        primary whose clone won: the resources are reclaimed and the
        cancel counted, but the handle stays open until the winner's
        tokens are mirrored onto it."""
        rid = int(rid)
        with self._lock:
            req = next((r for r in self._all if r.id == rid), None)
        if req is None or req.state in ("done", "shed", "canceled"):
            return None
        return self._cancel_request(req, reason, _finalize=_finalize)

    def _cancel_request(self, req: Request, reason: str,
                        _finalize: bool = True) -> Optional[dict]:
        """Pull the request out of the queue (stage ``queued``) or its
        row (``prefill`` before its first token, ``decode`` after), under
        the step lock so no replay is being built over the row, then
        account the cancel."""
        stage = None
        with self._lock:
            try:
                self._queue.remove(req)
                stage = "queued"
            except ValueError:
                pass       # admitted, or inside a step's admission
        if stage is None:
            with self._step_lock:
                slot = req.slot
                if slot is not None and self._active.get(slot) is req:
                    del self._active[slot]
                    self.cache.release(slot)
                    req.slot = None
                    stage = ("decode" if req.first_token_at is not None
                             else "prefill")
        if stage is None:
            # ended already, or popped by a concurrent step's admission
            # (it runs to completion): nothing is held here
            return None
        self._finalize_cancel(req, stage, reason, _finalize)
        return {"id": req.id, "stage": stage, "reason": reason}

    def _finalize_cancel(self, req: Request, stage: str, reason: str,
                         finalize: bool = True):
        """Account a canceled request whose row the caller released: its
        adapter pin, counters, metric, run log and trace, and (unless
        detached) the terminal state."""
        self._release_pin(req)
        with self._lock:
            self._canceled_by_reason[reason] = \
                self._canceled_by_reason.get(reason, 0) + 1
        self._cancel_ctr.labels(engine=self._eid, reason=reason).inc()
        _monitor.stat_add("STAT_serving_canceled")
        now = self._clock()
        _runlog.log_event("serving_cancel", request=req.id,
                          stage=stage, reason=reason,
                          tokens=len(req.tokens))
        _tracing.mark(req.id, "cancel", now, self.trace_track)
        _tracing.finish(req.id, now, self.trace_track, "canceled",
                        reason=reason)
        self._session_left(req)
        if finalize:
            req.state = "canceled"
            req.shed_reason = reason
            req.finished_at = now
            req._done.set()

    def _reap_expired(self) -> int:  # holds: _step_lock
        """(holding ``_step_lock``) Cancel every active row whose hard
        deadline passed, before admission, so the freed rows take new
        requests in the same step. Returns how many were canceled."""
        now = self._clock()
        n = 0
        for slot, req in list(self._active.items()):
            hd = req.hard_deadline
            if hd is not None and now > hd:
                del self._active[slot]
                self.cache.release(slot)
                req.slot = None
                stage = ("decode" if req.first_token_at is not None
                         else "prefill")
                self._finalize_cancel(req, stage, "deadline")
                n += 1
        return n

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
        the old weights are kept (the reference's contract).
        ``reset_costs`` drops the learned prefill and TPOT EWMAs
        afterwards (pins stay), so the new weights' costs are learned
        afresh. Returns the new weight version."""
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
        if reset_costs:
            self.reset_cost_estimates()
        return version

    def _release_device(self, pool: bool = True):  # holds: _step_lock
        """Free what this engine holds on the device, for good: drop the
        step graphs captured over its pools, its sampling mask and its
        prefill rows (``HeldStep.forget``, with the memory they keep),
        then the tensors themselves. The router's kill path calls it on a
        replica it has stripped of every request, so a restart loop holds
        the memory of the live replicas only; the engine's host
        book-keeping (its requests, counters, block refcounts) stays.
        ``pool=False`` keeps the KV pool and the graphs over it alone, for
        a pool a live engine still shares (a disaggregated fleet's
        co-located roles): only the engine's own tensors go. A LoRA pool
        lives with the fleet and is never freed here (graphs holding it
        also hold this engine's KV pool or mask, and go with those)."""
        self._drop_ahead()
        self._pinned = {}
        held = ([a for layer in self.cache.arrays() for a in layer]
                if pool else [])
        if self._mask is not None:
            held.append(self._mask)
        if not self.paged:
            held += [a for layer in self._prefill_rows for a in layer]
            self._prefill_rows = []
        _gen.forget_held(self.model, [a.data_ptr() for a in held])
        self._mask = None
        self._mask_rows = set()
        if pool:
            self.cache.drop_arrays()

    @property
    def weight_version(self) -> int:
        """Hot-swaps applied so far (0 = construction weights)."""
        return self._weight_version

    # ------------------------------------------------- LoRA adapters
    def load_adapter(self, name: str, state) -> int:
        """Load (or hot-reload) a tenant's LoRA adapter into the pool,
        ``paddle_tpu/serving/engine.py:865``'s counterpart: the factors
        are copied into the pool's own tensors (:meth:`LoRAPool.load`),
        which the graphs hold by address, so nothing is captured and the
        next replay computes with them. Under the step lock (a clean cut
        between this engine's steps) and the model's trace lock (one
        between any replica's replays, as ``swap_weights``). Returns the
        adapter's page (engine-local; requests carry the tenant name)."""
        if self.lora_pool is None:
            raise ValueError(
                "engine has no LoRA pool; construct with lora_rank > 0 "
                "(FLAGS_serving_lora_rank) or pass lora_pool=")
        with self._step_lock, _gen.model_trace_lock(self.model):
            page = self.lora_pool.load(name, state)
        self._lora_gauge.set(len(self.lora_pool.loaded))
        _runlog.log_event("serving_lora_load", engine=self._eid,
                          adapter=name, page=page)
        _monitor.stat_add("STAT_serving_lora_loads")
        return page

    def evict_adapter(self, name: str) -> int:
        """Evict a tenant's adapter, freeing (and zeroing) its page.
        Refuses (ValueError) while in-flight requests still pin it."""
        if self.lora_pool is None:
            raise ValueError("engine has no LoRA pool")
        with self._step_lock, _gen.model_trace_lock(self.model):
            page = self.lora_pool.evict(name)
        self._lora_gauge.set(len(self.lora_pool.loaded))
        _runlog.log_event("serving_lora_load", engine=self._eid,
                          adapter=name, page=page, evicted=True)
        _monitor.stat_add("STAT_serving_lora_evictions")
        return page

    # --------------------------------------------------------- stepping
    def step(self) -> bool:
        """One scheduler iteration: cancel rows whose hard deadline
        passed, admit into free rows (batched per-bucket prefill), then
        one batched decode, or with speculation on one draft-verify
        step. Returns whether any work happened."""
        with self._step_lock:
            _monitor.stat_add("STAT_serving_steps")
            reaped = self._reap_expired()
            admitted = self._admit()
            produced = (self._spec_decode() if self.spec_tokens
                        else self._decode_any())
            if self.kv_tier is not None:
                self._demote_sweep()
            if self.paged:
                self._blocks_used_g.set(self.cache.blocks_used)
                self._blocks_free_g.set(self.cache.blocks_free)
            return bool(admitted or produced or reaped)

    def _demote_sweep(self):  # holds: _step_lock
        """Between-steps host-tier demotion: prefix entries cold
        (refcount 1) across a whole ``FLAGS_serving_demote_idle_ms``
        window move to the host store; 0 demotes cold entries at every
        step. Runs after the decode, on its stream, so it copies what
        the step wrote."""
        pool = self.cache.pool
        idle_ms = self.kv_tier.demote_idle_ms
        eligible = None
        if idle_ms > 0:
            now = self._clock()
            cold = {k for k, e in pool._prefix.items()
                    if pool.allocator.refcount[e.block] == 1}
            for k in list(self._cold_since):
                if k not in cold:
                    del self._cold_since[k]
            for k in cold:
                self._cold_since.setdefault(k, now)
            eligible = {k for k, t0 in self._cold_since.items()
                        if (now - t0) * 1e3 >= idle_ms}
            if not eligible:
                return
        entries, _blocks = self.kv_tier.demote(self.cache, keys=eligible)
        if entries and eligible is not None:
            for k in eligible:
                self._cold_since.pop(k, None)

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
        requests (ms), completions, sheds and cancels by reason, SLO
        attainment and the predicted TTFT (with an SLO), per-tenant
        outcomes, the attention path, the KV dtype and its int8 error,
        prefix-cache reuse and block use, and the dispatch counts."""
        with self._lock:
            done = [r for r in self._all if r.state == "done"]
            completed = self._completed
            slo_met = self._slo_met
            shed = dict(self._shed_by_reason)
            canceled = dict(self._canceled_by_reason)
            tenants = {k: list(v) for k, v in self._tenant_stats.items()}

        def pct(vals, q):
            vals = [v for v in vals if v is not None]
            return (None if not vals
                    else round(float(np.percentile(vals, q)) * 1e3, 3))

        out = {
            "ttft_p50_ms": pct([r.ttft for r in done], 50),
            "ttft_p99_ms": pct([r.ttft for r in done], 99),
            "tpot_p50_ms": pct([r.tpot for r in done], 50),
            "tpot_p99_ms": pct([r.tpot for r in done], 99),
            "latency_samples": completed,
            "completed": completed,
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
            "canceled": canceled,
            "canceled_total": sum(canceled.values()),
        }
        if self.slo_ttft_ms:
            out["slo_ttft_ms"] = self.slo_ttft_ms
            out["slo_met"] = slo_met
            out["slo_attainment"] = (round(slo_met / completed, 4)
                                     if completed else None)
            out["predicted_ttft_ms"] = round(self.predict_ttft_ms(), 3)
        if tenants:
            out["tenants"] = {
                name: {"completed": c,
                       "slo_met": m,
                       "slo_attainment": (round(m / e, 4) if e
                                          else None)}
                for name, (c, e, m) in sorted(tenants.items())}
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
            out["dispatch_ahead"] = self.dispatch_ahead
            if self.dispatch_ahead:
                out["ahead_hits"] = self._ahead_hits
                out["ahead_misses"] = self._ahead_misses
        if self.kv_dtype == "int8":
            out["kv_quant_max_abs_err"] = round(self._qerr_max, 6)
        if self.lora_pool is not None:
            out["lora"] = {
                "rank": self.lora_pool.rank,
                "max_adapters": self.lora_pool.max_adapters,
                "loaded": self.lora_pool.loaded,
                "leaked_pages": self.lora_pool.leaked(),
            }
        if self.grammar is not None:
            out["json_grammar"] = True
        if self.kv_tier is not None:
            # a shared tier's numbers: every attached engine reports the
            # same store and session totals
            out["kv_tier"] = self.kv_tier.stats()
        if self._devprof is not None:
            # the sampled roofline view (device/host split, per-entry MFU
            # and HBM share, verdicts), served at GET /v1/stats
            out["devprof"] = self._devprof.stats()
        return out
