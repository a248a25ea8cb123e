"""Global flags registry of the PyTorch port — the counterpart of
``paddle_tpu/flags.py``, holding only the flags the ported modules read.

Flags are typed, documented at definition, overridable from the
environment (``FLAGS_<name>``, read at first access), and settable at
runtime via :func:`set_flags`. Unknown names raise ValueError. Every
name and default equals the JAX package's, except the values of
``serving_attn_impl`` (see its help text).
"""

from __future__ import annotations

import difflib
import os
import threading
from typing import Any, Dict

_lock = threading.Lock()
_defs: Dict[str, dict] = {}
_values: Dict[str, Any] = {}
# bumped on every set_flags, so a cache keyed on it can tell that a
# flag changed since its entry was built
_version = 0


def version() -> int:
    with _lock:
        return _version


def _coerce(value, typ):
    if typ is bool:
        if isinstance(value, str):
            return value.lower() in ("1", "true", "yes", "on")
        return bool(value)
    return typ(value)


def define_flag(name: str, default, help_str: str = ""):
    """Register a flag (framework-internal)."""
    with _lock:
        if name in _defs:
            return
        _defs[name] = {"default": default, "type": type(default),
                       "help": help_str}


def _unknown_flag_error(names) -> ValueError:
    with _lock:
        known = sorted(_defs)
    hints = []
    for n in names:
        close = difflib.get_close_matches(n, known, n=1)
        if close:
            hints.append(f"did you mean {close[0]!r}?")
    hint = (" " + " ".join(hints)) if hints else ""
    return ValueError(
        f"unknown flag(s) {sorted(names)!r}.{hint} "
        f"({len(known)} flags registered; "
        f"paddle_tpu_torch.flags.list_flags() enumerates them)")


def get_flags(names):
    """Return {name: value} for a flag name or list of names."""
    if isinstance(names, str):
        names = [names]
    out = {}
    for name in names:
        if name not in _defs:
            raise _unknown_flag_error([name])
        with _lock:
            if name in _values:
                out[name] = _values[name]
                continue
            env = os.environ.get("FLAGS_" + name)
            d = _defs[name]
            val = _coerce(env, d["type"]) if env is not None else d["default"]
            _values[name] = val
            out[name] = val
    return out


def set_flags(flags: Dict[str, Any]):
    """Set flags at runtime. Atomic: every entry applies or none does."""
    global _version
    unknown = [n for n in flags if n not in _defs]
    if unknown:
        raise _unknown_flag_error(unknown)
    coerced = {n: _coerce(v, _defs[n]["type"]) for n, v in flags.items()}
    with _lock:
        _values.update(coerced)
        _version += 1


def get_flag(name: str):
    return get_flags(name)[name]


def list_flags() -> Dict[str, dict]:
    """All registered flags with metadata (help/default/current)."""
    with _lock:
        return {n: {**d, "current": _values.get(n, d["default"])}
                for n, d in _defs.items()}


# Serving plane: engine geometry + admission control. Constructor
# arguments override; the flags are the deployment-config surface.
define_flag("serving_max_slots", 8,
            "ServingEngine: KV-cache rows = max in-flight requests "
            "decoded per step (the fixed decode batch axis).")
define_flag("serving_max_len", 256,
            "ServingEngine: per-request KV capacity (prompt + "
            "generated); must not exceed the model's "
            "max_position_embeddings.")
define_flag("serving_max_queue", 64,
            "ServingEngine admission control: waiting requests beyond "
            "this are rejected with QueueFullError (backpressure).")
define_flag("serving_prefill_buckets", "16,32,64,128",
            "Comma-separated prompt-length buckets: prefill pads each "
            "prompt suffix to the smallest bucket >= its length, so one "
            "batched prefill dispatch serves every same-bucket "
            "admission.")
define_flag("serving_max_new_tokens", 32,
            "ServingEngine: default per-request new-token budget when "
            "submit() does not specify one.")
define_flag("serving_paged", True,
            "ServingEngine KV memory manager: True = block-paged "
            "BlockKVCache (per-request block tables over a fixed pool "
            "of serving_block_size-row KV blocks, ref-counted with "
            "shared-prefix reuse — each request pays only the blocks "
            "it needs); False = the dense SlotKVCache (every request "
            "pays a full max_len row). Output is token-identical "
            "either way.")
define_flag("serving_block_size", 16,
            "Paged serving: KV rows per block.")
define_flag("serving_num_blocks", 0,
            "Paged serving: physical KV blocks in the pool per layer "
            "(block 0 is reserved as the trash block for "
            "padding/overflow writes). 0 = auto-size to "
            "max_slots * ceil(max_len/block_size) + 1.")
define_flag("serving_prefix_cache", True,
            "Paged serving: cache full prompt blocks under a rolling "
            "token-prefix hash so a repeated prompt prefix prefills "
            "once and later requests reference its blocks "
            "(copy-on-write at a partially shared boundary block).")
define_flag("serving_kv_dtype", "f32",
            "Paged serving KV pool element type: 'f32', 'bf16' (half "
            "the bytes, plain cast), or 'int8' (per-block-per-head "
            "absmax scales beside the code pools, quantized on write, "
            "dequantized inside the attention read).")
define_flag("serving_attn_impl", "kernel",
            "Paged decode/prefill attention implementation. 'kernel' "
            "(default) runs the hand-written CUDA paged-attention "
            "kernel (ops/cuda/paged_attention.py), which walks each "
            "request's block table inside the kernel; on CPU tensors "
            "its plain PyTorch version runs instead. 'composed' "
            "gathers the blocks and applies a masked softmax in plain "
            "PyTorch, the reference oracle. These replace the JAX "
            "package's values 'pallas' (the kernel) and 'xla' (the "
            "oracle); the JAX default is the oracle, the port's is the "
            "kernel.")
define_flag("serving_spec_tokens", 0,
            "Speculative decoding: draft tokens K proposed per slot "
            "per step by the n-gram self-drafter; the verify step "
            "scores all K+1 positions in one fixed-shape forward and "
            "commits the accepted prefix (greedy output stays "
            "token-identical to K=0). 0 disables speculation (one "
            "token per decode step). Each request reserves K rows of "
            "slot headroom, so prompt + max_new_tokens + K must fit "
            "in serving_max_len.")
define_flag("serving_spec_ngram", 3,
            "Speculative decoding: longest suffix n-gram the "
            "self-drafter matches against the request's own "
            "prompt+generated context when proposing draft tokens "
            "(falls back to shorter n-grams, then to repeating the "
            "last token).")

define_flag("serving_megastep", 1,
            "Device-resident decode megasteps: decode iterations run "
            "inside one compiled lax.scan entry per step() call, with "
            "EOS / budget / stop-sequence early-exit carried as "
            "per-slot data (finished slots freeze behind a live-mask) "
            "and one host commit per megastep instead of per token. "
            "Output is byte-identical to megastep=1; requires "
            "serving_paged and is incompatible with "
            "serving_spec_tokens > 0. Requests the device stop tables "
            "cannot hold (decoding.STOP_MAX_SEQS/STOP_MAX_LEN) or "
            "that decode under a JSON grammar fall back to single "
            "steps, as does a step whose tightest hard deadline could "
            "not absorb a whole megastep. 1 (default) keeps the "
            "per-token host loop.")

# Attention kernel selection (the training path's causal attention).
define_flag("use_pallas_attention", True,
            "Route fused_attention_qkv to the flash-attention kernel when "
            "the shapes allow it. In the port that kernel is the "
            "hand-written CUDA flash attention (ops/cuda/"
            "flash_attention.py); on CPU tensors its plain PyTorch version "
            "runs instead. The name is the JAX package's.")
define_flag("use_pallas_layer_norm", False,
            "Route layer_norm over one last axis with Scale and Bias and "
            "h % 128 == 0 to the fused LayerNorm kernels (default off, as "
            "in the JAX package). In the port those are the hand-written "
            "CUDA kernels (ops/cuda/layer_norm.py); on CPU tensors their "
            "plain PyTorch versions run instead. The name is the JAX "
            "package's.")
define_flag("pallas_min_seq", 1024,
            "Minimum sequence length before attention switches from the "
            "composed form to the CUDA flash kernel.")
define_flag("pallas_flash_block_q", 512,
            "Flash-attention q-block size: the sequence must have a "
            "power-of-two divisor in [16, this] for the flash route. In "
            "the port it only decides whether the route is taken; the "
            "CUDA kernel tiles 64 rows at a time whatever its value.")
define_flag("pallas_flash_block_k", 512,
            "Flash-attention k-block size; the same rule as "
            "pallas_flash_block_q, for the key sequence.")

# The concurrency sanitizer (analysis/concurrency.py): the reference's
# name, default and help.
define_flag("sanitize_locks", False,
            "Swap the serving/observability locks for instrumented "
            "wrappers (analysis/concurrency.py): record the per-thread "
            "lock-acquisition-order graph, report lock-order inversions "
            "(potential deadlock cycles) with held-lock witnesses, and "
            "enforce the declared guarded-state registry — a write to "
            "a '# guarded-by' attribute without its lock raises "
            "GuardedStateError. Pure host-side instrumentation: zero "
            "overhead when off (plain threading locks), zero effect on "
            "compiled steps when on.")

# The serving engine's background thread and the router's dispatch
# (ServingEngine.start, ReplicaRouter.step).
define_flag("serving_idle_wait", 0.05,
            "ServingEngine background loop: seconds to wait for new "
            "submissions when no request is queued or in flight.")
define_flag("serving_dispatch_ahead", False,
            "Megastep pipelining: after committing megastep k, "
            "dispatch k+1 from k's device-carry outputs before "
            "syncing, so host commit work overlaps device execution "
            "(jax.block_until_ready only at commit). The speculative "
            "dispatch is consumed only if the scheduler state it "
            "assumed is unchanged (no finishes, no admissions, no "
            "weight/flag changes); otherwise it is discarded — pools "
            "are pure functional values, so a discard has no side "
            "effects. Requires serving_megastep > 1.")
define_flag("serving_dispatch_threads", 0,
            "Router dispatch concurrency: ReplicaRouter / DisaggRouter "
            "step their replicas from a bounded thread pool of this "
            "size instead of the serial per-engine loop (engines are "
            "stepped concurrently; health strikes, hedging and "
            "deadline reaping stay at step boundaries with identical "
            "semantics). 0 (default) = serial stepping, byte-identical "
            "scheduling order.")

# The replica fleet (serving/router.py): routing, autoscaling,
# supervision, hedging and the per-replica circuit breaker.
define_flag("serving_replicas", 1,
            "Data-parallel serving replicas fronted by ReplicaRouter: "
            "submit() routes each request to the least-loaded replica "
            "(predicted TTFT from queue depth + free KV blocks), with "
            "shed/drain semantics riding the resilience plane's "
            "RetryPolicy at the serving.route fault site. 1 (default) "
            "means a single engine with no router in front.")
define_flag("serving_slo_ttft_ms", 0.0,
            "SLO-aware admission: target time-to-first-token in ms. "
            "When > 0, submit() predicts the newcomer's TTFT from live "
            "queue depth, measured per-bucket prefill cost, and the "
            "decode batch's TPOT (EWMA), and sheds the submission when "
            "the prediction exceeds this budget (QueueFullError with "
            "reason='slo' and a predicted-TTFT-derived retry_after_s); "
            "queued requests whose deadline already passed are shed "
            "before prefill instead of wasting a dispatch. 0 (default) "
            "keeps the blunt depth-only backpressure. Admission is "
            "pure host arithmetic: no new compiled surface either way.")
define_flag("serving_slo_prefill_ms", 0.0,
            "TTFT predictor: pinned per-bucket prefill cost in ms. 0 "
            "(default) learns an EWMA from this engine's measured "
            "prefill dispatches; pin it for deterministic admission "
            "decisions (loadgen replay, tests).")
define_flag("serving_slo_tpot_ms", 0.0,
            "TTFT predictor: pinned per-output-token decode cost in "
            "ms. 0 (default) learns an EWMA from measured decode/"
            "verify steps; pin it for deterministic admission.")
define_flag("serving_priority_preempt", True,
            "Priority classes (submit(priority=), lower = more "
            "urgent): allow an urgent submission that would otherwise "
            "be shed (queue full / predicted SLO miss) to preempt-shed "
            "queued strictly-lower-priority work instead. Requests "
            "within a class keep FIFO order either way.")
define_flag("serving_autoscale", "",
            "ReplicaRouter autoscaling bounds as 'MIN:MAX' replicas "
            "(e.g. '1:4'). When set, the router consults an "
            "AutoscalePolicy each step — scale up on queue-depth / "
            "free-KV-block / SLO-attainment pressure, scale down by "
            "draining the emptiest replica when load subsides. "
            "Replicas share one placed model, so scaling reuses the "
            "compiled steps instead of retracing. Empty (default) "
            "disables autoscaling.")
define_flag("serving_replica_strikes", 3,
            "ReplicaRouter failure detection: consecutive unproductive "
            "steps (a step() that raised, or did no work while the "
            "replica held queued/active requests) before a replica is "
            "declared dead. One strike marks it suspect (deprioritized "
            "in routing); reaching the limit marks it dead — excluded "
            "from routing and, under serving_auto_restart, replaced. "
            "A productive step clears the strikes.")
define_flag("serving_auto_restart", True,
            "ReplicaRouter recovery policy: when a replica is declared "
            "dead (strike watchdog or a serving.replica `error`/`drop` "
            "fault), spawn a same-geometry replacement before tearing "
            "the dead one down — queued work re-homes onto live peers, "
            "in-flight decodes re-prefill from their committed tokens, "
            "and the replacement reuses the compiled steps (zero new "
            "XLA compiles). False leaves the fleet one replica "
            "smaller (kill without restart).")
define_flag("serving_hedge_ms", 0.0,
            "ReplicaRouter hedged prefill (the Dean & Barroso "
            "tail-at-scale move): when a submission's assigned "
            "replica predicts a TTFT beyond this many ms, dispatch a "
            "hedge copy to the second-best healthy replica after the "
            "same delay — first first-token wins, the loser is "
            "canceled with every KV block and LoRA pin reclaimed. "
            "0 (default) disables hedging; a negative value derives "
            "the threshold live from the traced fleet's TTFT p95 "
            "(observability.tracing), so the hedge line tracks the "
            "tail it is trimming. Pure host-side queue surgery: "
            "predict_serving_compiles(hedge=N) is a validated no-op.")
define_flag("serving_hedge_budget", 0.05,
            "ReplicaRouter hedged prefill: token-bucket bound on "
            "duplicated work — each offered submission deposits this "
            "many hedge tokens and each dispatched hedge spends one, "
            "so hedges never exceed budget * offered (+1 initial "
            "allowance). 0 refuses all hedges even when "
            "serving_hedge_ms arms them.")
define_flag("serving_breaker_window", 20,
            "ReplicaRouter per-replica circuit breaker: recent step "
            "outcomes (ok / raised) remembered per replica. The "
            "breaker complements the strike watchdog: strikes need "
            "consecutive failures, the breaker trips on failure RATE "
            "over this window, so a replica flapping between ok and "
            "error stops receiving traffic before it ever reaches "
            "the strike limit. 0 disables the breaker.")
define_flag("serving_disagg", "",
            "Disaggregated serving fleet topology as 'PxD' (e.g. "
            "'1x2'): P prefill-only workers feed D decode-only workers "
            "through a bounded handoff queue (DisaggRouter in "
            "serving/disagg.py). Prefill and decode stop sharing a "
            "batch, so TTFT no longer inherits decode-batch jitter; "
            "the KV handoff is a host-side block-table splice on "
            "co-located pools. Empty (default) keeps symmetric "
            "replicas.")
define_flag("serving_prefix_affinity", True,
            "DisaggRouter: route each request to the prefill worker "
            "whose KV pool already holds its longest cached prefix "
            "(fleet-wide rolling-hash prefix index), falling back to "
            "least-loaded on a miss. Off = pure least-loaded routing; "
            "hit rates then stop compounding across workers.")
define_flag("serving_handoff_queue", 16,
            "DisaggRouter: bound on the prefill->decode handoff queue. "
            "A full queue backpressures prefill workers (they stop "
            "admitting) instead of buffering unbounded finished "
            "prefills whose KV blocks are pinned until adoption.")
define_flag("serving_lora_rank", 0,
            "Multi-tenant paged LoRA: rank of the per-tenant low-rank "
            "adapters (serving/lora.py LoRAPool). > 0 builds the "
            "engine with an adapter pool whose stacked factors are "
            "plain inputs to the compiled steps — per-row adapter "
            "pages are gathered inside the step (the BlockKVCache "
            "block-table trick applied to weights), so base and "
            "per-tenant rows mix in one batch of one executable and "
            "loading/evicting adapters never recompiles. 0 disables "
            "(no pool, no lora step input). Requires the paged KV "
            "cache. Constructor state read once, like the SLO knobs.")
define_flag("serving_lora_max_adapters", 4,
            "Multi-tenant paged LoRA: adapter pages in the pool "
            "(tenants resident at once; +1 all-zero base page is "
            "added internally). A load into a full pool raises until "
            "an adapter is evicted; eviction refuses while in-flight "
            "requests still pin the page (the KV-block refcount "
            "discipline applied to weights).")
define_flag("serving_host_tier", False,
            "Host-RAM KV block tier (serving/kv_tier.py): attach a "
            "TierManager over a pinned numpy HostBlockStore so cold "
            "prefix chains and finished-session rows demote out of "
            "the device pool (int8-at-rest) and promote back on "
            "demand, and submit(session=...) resumes a demoted "
            "conversation token-identically. Routers build ONE "
            "fleet-shared store across replicas and roles. Migration "
            "is host-side block-table surgery over eager pool writes "
            "— predict_serving_compiles(host_tier=True) is a "
            "validated no-op.")
define_flag("serving_host_blocks", 256,
            "Host-RAM KV tier capacity in blocks (per fleet-shared "
            "HostBlockStore). Blocks are stored as int8 codes + "
            "per-block-per-head f32 absmax scales regardless of the "
            "device pool's kv_dtype, so a host gigabyte holds ~4x "
            "the f32 sessions; the store evicts idle chains LRU "
            "(leaf-first) under pressure.")
define_flag("serving_demote_idle_ms", 0.0,
            "Host-tier demotion sweep cadence (engine clock ms): a "
            "device prefix entry must sit cold (cache-only, no live "
            "request references) across a full window of this length "
            "before the between-steps sweep demotes it to the host "
            "store — 0 demotes cold entries at every step (the "
            "maximum-capacity setting loadgen's returning-users gate "
            "runs with). Only read when a kv_tier is attached.")
define_flag("serving_breaker_threshold", 0.5,
            "ReplicaRouter per-replica circuit breaker: failure "
            "fraction over the outcome window (with at least half "
            "the window observed) that opens the breaker — an open "
            "replica is skipped by routing like a draining one.")
define_flag("serving_breaker_cooldown_s", 5.0,
            "ReplicaRouter per-replica circuit breaker: seconds "
            "(engine clock) an open breaker holds before going "
            "half-open — one probe routes through; success closes "
            "the breaker, failure re-opens it for another cooldown.")

# Resilience plane (resilience/): fault injection and retry. All
# deterministic so chaos runs replay exactly.
define_flag("fault_spec", "",
            "Deterministic fault-injection spec, "
            "'site:kind[@trigger];...' (grammar in "
            "resilience/injector.py). Empty = every fault_point is a "
            "no-op. PADDLE_TPU_FAULT_SPEC is honored when the flag is "
            "unset.")
define_flag("fault_seed", 0,
            "Seed for probabilistic fault triggers and retry jitter — "
            "same spec + seed replays the same faults.")
define_flag("retry_max_attempts", 5,
            "RetryPolicy: attempts before giving up (first try "
            "included).")
define_flag("retry_base_delay", 0.05,
            "RetryPolicy: first backoff delay in seconds (doubles per "
            "retry).")
define_flag("retry_max_delay", 2.0,
            "RetryPolicy: per-retry backoff cap in seconds.")
define_flag("retry_deadline", 30.0,
            "RetryPolicy: wall-clock budget in seconds across all "
            "attempts of one call.")
define_flag("retry_budget_ratio", 0.1,
            "Fleet-wide RetryBudget: retry tokens earned per "
            "successful call (the classic 'retries may add at most "
            "this fraction of extra load'). Budgeted sites "
            "(serving.route / serving.handoff / serving.replica) "
            "withdraw one token per retry attempt; an empty bucket "
            "turns the retry into an immediate RetryError, so "
            "correlated failures shed as backpressure instead of "
            "amplifying into a retry storm.")
define_flag("retry_budget_reserve", 10.0,
            "Fleet-wide RetryBudget: tokens the shared bucket starts "
            "with (and its refill cap is 10x this floor), so isolated "
            "early failures still retry before any successes have "
            "funded the budget.")

# Observability plane (observability/): the compile tracker and the
# structured run log.
define_flag("warn_recompiles", 0,
            "XLA compile tracker: when > 0, emit a structured "
            "RecompileWarning (with the offending abstract shape/dtype "
            "signature) whenever a tracked_jit function compiles more "
            "than this many times — catches the recompile-per-token "
            "class of bug at the first occurrence. 0 disables.")
define_flag("runlog_dir", "",
            "Directory for the structured JSONL run log "
            "(observability.log_event); one runlog-<pid>.jsonl per "
            "process. Empty (default) keeps events in memory only.")
define_flag("runlog_max_mb", 64.0,
            "Size cap in MB for the active run-log file; on overflow "
            "it rotates to <name>.1 (replacing the previous one), so a "
            "process writes at most two caps of disk.")

# Request tracing (observability/tracing.py).
define_flag("serving_trace", 1.0,
            "Per-request distributed tracing sampling fraction "
            "(observability/tracing.py): each admitted request is "
            "sampled in/out by a deterministic hash of its request id "
            "— 1.0 (default) traces everything, 0 disables. Traced "
            "requests record host-side span marks (submit/admit/"
            "first_token/export/adopt/kill/finish) on the engine "
            "clock; blame attribution, Perfetto export and the "
            "/v1/requests/<id> endpoint read them. Pure host "
            "bookkeeping: zero compiled surface either way "
            "(predict_serving_compiles(tracing=...) is a validated "
            "no-op).")
define_flag("serving_trace_keep", 512,
            "Finished-trace retention ring (like the runlog's "
            "rotation): the most recent N completed/shed traces stay "
            "queryable via GET /v1/requests/<id> and the exporters; "
            "older ids 404. Active (in-flight) traces are never "
            "evicted.")

# The device-cost observatory (observability/devprof.py).
define_flag("serving_devprof", False,
            "Device-cost observatory (observability/devprof.py): on "
            "every tracked_jit compile, capture the lowered entry's "
            "XLA cost_analysis() (flops, HBM bytes, output bytes) "
            "into devprof.cost_table() and the xla_cost{fn,metric} "
            "gauges, and arm the engine's sampled device timer "
            "(FLAGS_serving_devprof_sample). Cost capture lowers the "
            "raw step function out-of-band, so the tracked compile "
            "counters never move — predict_serving_compiles("
            "devprof=True) is a validated no-op.")
define_flag("serving_devprof_sample", 0.1,
            "Device-timing sampling fraction under "
            "FLAGS_serving_devprof: a deterministic hash of the "
            "engine's dispatch counter picks which step dispatches "
            "get a block_until_ready timer (device ms histograms, "
            "roofline MFU/HBM-utilization gauges, host/device blame "
            "split). Skipped dispatches keep the PR 19 async/"
            "dispatch-ahead path untouched; 0 samples nothing (bit-"
            "identical to devprof off on the step path).")
define_flag("devprof_peak_flops", 0.0,
            "Roofline peak compute (FLOP/s) the MFU gauge divides by. "
            "0 (default) picks a nominal: on an H100 the data sheet's "
            "dense rate for the dtype the entry's matmuls run in "
            "(989e12 bf16/fp16, 495e12 TF32, 67e12 f32), on the CPU "
            "1e11; any other card raises until this flag is pinned.")
define_flag("devprof_peak_hbm_gbps", 0.0,
            "Roofline peak memory bandwidth (GB/s) the HBM-"
            "utilization gauge divides by. 0 (default) picks a "
            "nominal: 3350 on an H100, 50 on the CPU; any other card "
            "raises until this flag is pinned.")

# Static-graph executor (framework/executor.py): the reference's checks
# under its names and defaults.
define_flag("check_nan_inf", False,
            "Scan every op output for NaN/Inf during execution "
            "(ref platform/flags.cc:44). The port's executor then runs "
            "every step eagerly (a replayed CUDA graph cannot read the "
            "host between ops) and raises NanInfError naming the op and "
            "the variable.")
define_flag("check_program", False,
            "Run the static Program verifier once per program at its "
            "first executor run, as the reference does. The verifier "
            "(framework/analysis.py) is not ported yet: with the flag "
            "on, the executor raises NotImplementedError naming ROADMAP "
            "A7.3.")
define_flag("check_shapes", False,
            "Add static shape/dtype inference to the verifier suite "
            "wherever it runs, as the reference does. It waits with the "
            "verifier (ROADMAP A7.3): with the flag on, the executor "
            "raises NotImplementedError naming that item.")
