"""Static recompile prediction for the serving steps; the serving half
of ``paddle_tpu/analysis/recompile.py``, the port's own copy (the port
imports nothing of the JAX package).

The compile tracker (:mod:`~paddle_tpu_torch.observability.compile_tracker`)
*observes* the serving steps' compiles after the fact; this module
*predicts* them before any step runs, by mirroring the engine's
geometry-keyed entries (one prefill compile per length bucket, one
decode/verify compile total, the megastep's second decode entry)
including the paged prefix cache's effect on which bucket a prompt's
unshared suffix lands in (:func:`predict_serving_compiles`). The soak
(``python3 -m paddle_tpu_torch.tools.soak``) proves with it that kills,
restarts, re-homes, cancels and hedges predict the same counts as none.

The executor's predictor (``ExecutorCompilePredictor``) keys on a
static Program; the executor came with ROADMAP A7.1, the predictor
waits with the compiler and the analyses (ROADMAP A7.3).
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Sequence, Set, Tuple

__all__ = [
    "ATTN_IMPL_VALUES", "RecompilePredictor", "feed_signature",
    "merge_compile_counts", "predict_serving_compiles",
]

#: ``attn_impl`` values: the reference's (``FLAGS_serving_attn_impl`` in
#: the JAX package) and the port's; none changes a count
ATTN_IMPL_VALUES = ("xla", "pallas", "composed", "kernel")


def feed_signature(feeds: Dict[str, Any]) -> Tuple:
    """Normalize a feed dict to the executor's cache signature: sorted
    ``(name, shape, dtype)`` triples. Values may be arrays or
    ``(shape, dtype)`` pairs."""
    sig = []
    for k, v in feeds.items():
        shape = getattr(v, "shape", None)
        dtype = getattr(v, "dtype", None)
        if shape is None and isinstance(v, (tuple, list)) and len(v) == 2:
            shape, dtype = v
        sig.append((k, tuple(int(d) for d in (shape or ())), str(dtype)))
    return tuple(sorted(sig))


class RecompilePredictor:
    """Generic site-keyed signature tracker: ``observe(site, sig)``
    returns True when that (site, signature) pair would trace fresh,
    mirroring how the compile tracker attributes compiles to sites."""

    def __init__(self):
        self._seen: Dict[str, Set[Tuple]] = {}
        self._counts: Dict[str, int] = {}

    def observe(self, site: str, signature: Tuple) -> bool:
        sigs = self._seen.setdefault(site, set())
        if signature in sigs:
            return False
        sigs.add(signature)
        self._counts[site] = self._counts.get(site, 0) + 1
        return True

    def predicted_counts(self) -> Dict[str, int]:
        return dict(self._counts)


# ---------------------------------------------------------------------------
# serving engine
# ---------------------------------------------------------------------------


def _parse_buckets(buckets: Sequence[int], max_len: int) -> List[int]:
    # mirror of the engine's bucket parsing
    bs = sorted({int(b) for b in buckets})
    bs = [b for b in bs if 0 < b <= max_len]
    if not bs or bs[-1] != max_len:
        bs.append(max_len)
    return bs


def _bucket_for(buckets: Sequence[int], length: int) -> int:
    for b in buckets:
        if length <= b:
            return b
    return buckets[-1]


def predict_serving_compiles(
        request_rounds: Iterable[Sequence[Tuple[Sequence[int], int]]], *,
        buckets: Sequence[int], max_len: int, paged: bool = True,
        block_size: int = 16, prefix_cache: bool = True,
        spec_tokens: int = 0, attn_impl: str = "xla",
        kv_dtype: str = "f32",
        mesh_shape: Optional[Tuple[int, int]] = None,
        n_replicas: int = 1,
        slo_ttft_ms: float = 0.0,
        priority_classes: Optional[Sequence[int]] = None,
        autoscale: Optional[Tuple[int, int]] = None,
        weight_swaps: int = 0,
        replica_kills: int = 0,
        restarts: int = 0,
        rehomed: int = 0,
        cancel: int = 0,
        hedge: int = 0,
        disagg: Optional[Tuple[int, int]] = None,
        sampling: Optional[Sequence[Tuple[float, int, float]]] = None,
        lora: Optional[Tuple[int, int]] = None,
        tracing: Optional[float] = None,
        devprof: Optional[float] = None,
        sanitize: bool = False,
        host_tier: bool = False,
        sessions: int = 0,
        megastep: int = 1) -> Dict[str, int]:
    """Predict the serving steps' compile counts for a workload, before
    running it: the reference's counts (``xla_compiles`` per site), which
    are the port's step-cache signatures on the CPU
    (:mod:`~paddle_tpu_torch.observability.compile_tracker`).

    ``request_rounds`` is a list of admission rounds; each round is a
    list of ``(prompt_token_ids, max_new_tokens)`` pairs admitted
    together. Rounds matter because the paged prefix cache only
    publishes a prompt's blocks *after* its prefill completes — two
    identical prompts in one round share nothing, the same pair split
    across rounds shares every full block.

    Model (mirrors ``serving/engine.py`` + ``serving/kv_cache.py``):

    - prefill compiles once per length bucket hit; the paged path
      buckets the *unshared suffix* ``len(prompt) - shared`` where
      ``shared = min(matched_blocks * block_size, len(prompt) - 1)``
      (the last prompt token is always recomputed to emit the first
      output token);
    - decode (``decode_step[_paged]``) compiles once iff any request
      needs tokens beyond the one its prefill emits
      (``max_new_tokens > 1``) — with ``spec_tokens`` K > 0 the engine
      takes the verify path exclusively, so the compile lands on
      ``verify_step[_paged]{k=K}`` instead; with ``megastep`` N > 1 the
      decode plane has exactly two entries, ``decode_megastep_paged{n=N}``
      and the single-step fallback ``decode_step_paged``.

    Every other keyword is validated exactly as the reference validates
    it and is a no-op on the counts, for the reference's reasons:
    ``attn_impl``, ``kv_dtype``, ``mesh_shape``, ``lora`` and a flag
    change key a new *phase* of entries (predict each phase and sum with
    :func:`merge_compile_counts`); ``n_replicas``, ``disagg``,
    ``autoscale``, ``replica_kills``, ``restarts``, ``rehomed``,
    ``cancel``, ``hedge``, ``slo_ttft_ms``, ``priority_classes``,
    ``weight_swaps``, ``sampling``, ``tracing``, ``devprof``,
    ``sanitize``, ``host_tier`` and ``sessions`` decide which requests
    reach the steps, or time them, or move KV state in place, never what
    a step is keyed on. ``attn_impl`` takes the reference's values
    (``xla``, ``pallas``) and the port's (``composed``, ``kernel``).

    What the counts mean in the port (ROADMAP C): on the CPU a site's
    count is its entry's new input signatures, so a greedy workload
    observes exactly this prediction, fleet-wide (the replicas share one
    step cache). The port keeps a greedy and a sampled graph per decode
    entry (decode, megastep, verify), so a workload whose rows sample
    observes one more per such site that replayed both; the prediction
    stays the reference's. On the card a compile is a captured CUDA
    graph, held over one engine's pools, so each engine (a replica, a
    restarted or autoscaled replacement) captures its own; a
    replacement's captures are bounded by a warmed engine's graph count,
    not by this prediction.
    """
    for val, ok, flag in ((attn_impl, ATTN_IMPL_VALUES,
                           "attn_impl"),
                          (kv_dtype, ("f32", "bf16", "int8"),
                           "kv_dtype")):
        if val not in ok:
            raise ValueError(f"{flag} must be one of {ok}, got {val!r}")
    if kv_dtype != "f32" and not paged:
        raise ValueError(
            f"kv_dtype={kv_dtype!r} requires paged=True (the engine "
            "rejects non-f32 dense caches)")
    if mesh_shape is not None:
        dims = tuple(int(d) for d in mesh_shape)
        if len(dims) != 2 or any(d < 1 for d in dims):
            raise ValueError(
                f"mesh_shape must be a (data, model) pair of positive "
                f"ints, got {mesh_shape!r}")
        if not paged:
            raise ValueError(
                "mesh_shape requires paged=True (mesh-sharded serving "
                "runs on the paged KV cache)")
    if int(n_replicas) < 1:
        raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
    if float(slo_ttft_ms) < 0:
        raise ValueError(
            f"slo_ttft_ms must be >= 0, got {slo_ttft_ms}")
    if priority_classes is not None:
        pris = [int(p) for p in priority_classes]
        if not pris or any(p < 0 for p in pris):
            raise ValueError(
                f"priority_classes must be a non-empty sequence of "
                f"ints >= 0, got {priority_classes!r}")
    if autoscale is not None:
        lo, hi = (int(b) for b in autoscale)
        if not (1 <= lo <= hi):
            raise ValueError(
                f"autoscale bounds must satisfy 1 <= min <= max, got "
                f"{autoscale!r}")
    if int(weight_swaps) < 0:
        raise ValueError(
            f"weight_swaps must be >= 0, got {weight_swaps}")
    for val, name in ((replica_kills, "replica_kills"),
                      (restarts, "restarts"), (rehomed, "rehomed"),
                      (cancel, "cancel"), (hedge, "hedge")):
        if int(val) < 0:
            raise ValueError(f"{name} must be >= 0, got {val}")
    if disagg is not None:
        p, d = (int(n) for n in disagg)
        if p < 1 or d < 1:
            raise ValueError(
                f"disagg must be (n_prefill >= 1, n_decode >= 1), got "
                f"{disagg!r}")
        if not paged:
            raise ValueError(
                "disagg requires paged=True (the prefill->decode KV "
                "handoff is a block-table splice)")
    if sampling is not None:
        from ..serving.decoding import DecodeParams
        for rec in sampling:
            t, k, p = rec
            DecodeParams(temperature=float(t), top_k=int(k),
                         top_p=float(p))   # range-validates, else raises
    if lora is not None:
        rank, max_adapters = (int(n) for n in lora)
        if rank < 1 or max_adapters < 1:
            raise ValueError(
                f"lora must be (rank >= 1, max_adapters >= 1), got "
                f"{lora!r}")
        if not paged:
            raise ValueError(
                "lora requires paged=True (the adapter pool is paged "
                "like the KV cache)")
    if tracing is not None:
        frac = 1.0 if tracing is True else float(tracing)
        if not (0.0 <= frac <= 1.0):
            raise ValueError(
                f"tracing must be a sampling fraction in [0, 1] (or "
                f"True = 1.0), got {tracing!r}")
    if devprof is not None:
        frac = (1.0 if devprof is True else
                0.0 if devprof is False else float(devprof))
        if not (0.0 <= frac <= 1.0):
            raise ValueError(
                f"devprof must be a sampling fraction in [0, 1] (or "
                f"a bool for FLAGS_serving_devprof on/off), got "
                f"{devprof!r}")
    if sanitize not in (True, False):
        raise ValueError(
            f"sanitize must be a bool (FLAGS_sanitize_locks is "
            f"on/off), got {sanitize!r}")
    if host_tier not in (True, False):
        raise ValueError(
            f"host_tier must be a bool (FLAGS_serving_host_tier is "
            f"on/off), got {host_tier!r}")
    if int(sessions) < 0:
        raise ValueError(f"sessions must be >= 0, got {sessions}")
    megastep = int(megastep)
    if megastep < 1:
        raise ValueError(f"megastep must be >= 1, got {megastep}")
    if megastep > 1 and not paged:
        raise ValueError(
            "megastep > 1 requires paged=True (the device-resident "
            "decode loop carries the paged KV pool)")
    if megastep > 1 and spec_tokens > 0:
        raise ValueError(
            "megastep > 1 is mutually exclusive with spec_tokens > 0 "
            "(the engine rejects the combination)")
    if sessions and not host_tier:
        raise ValueError(
            "sessions requires host_tier=True (submit(session=...) "
            "needs the host KV tier to park a conversation)")
    if host_tier and not paged:
        raise ValueError(
            "host_tier requires paged=True (the tier migrates paged "
            "KV blocks)")
    bks = _parse_buckets(buckets, max_len)
    suffix = "_paged" if paged else ""
    counts: Dict[str, int] = {}
    seen_buckets: Set[int] = set()
    published: Set[Tuple] = set()   # rolling chains of full-block chunks
    needs_decode = False

    for round_reqs in request_rounds:
        round_published: List[Tuple[int, ...]] = []
        for prompt, max_new_tokens in round_reqs:
            prompt = tuple(int(t) for t in prompt)
            shared = 0
            if paged and prefix_cache:
                matched, chain = 0, ()
                for i in range(len(prompt) // block_size):
                    chain = (chain,
                             prompt[i * block_size:(i + 1) * block_size])
                    if chain not in published:
                        break
                    matched += 1
                shared = min(matched * block_size, len(prompt) - 1)
                round_published.append(prompt)
            length = len(prompt) - shared if paged else len(prompt)
            b = _bucket_for(bks, length)
            if b not in seen_buckets:
                seen_buckets.add(b)
                counts[f"serving_prefill{suffix}{{bucket={b}}}"] = \
                    counts.get(f"serving_prefill{suffix}{{bucket={b}}}",
                               0) + 1
            if max_new_tokens > 1:
                needs_decode = True
        # prefix publication happens post-prefill, i.e. between rounds
        for prompt in round_published:
            chain: Tuple = ()
            for i in range(len(prompt) // block_size):
                chain = (chain, prompt[i * block_size:(i + 1) * block_size])
                published.add(chain)

    if needs_decode:
        if spec_tokens > 0:
            counts[f"verify_step{suffix}{{k={spec_tokens}}}"] = 1
        else:
            counts[f"decode_step{suffix}"] = 1
            if megastep > 1:
                counts[f"decode_megastep_paged{{n={megastep}}}"] = 1
    return counts


def merge_compile_counts(*phase_counts: Dict[str, int]) -> Dict[str, int]:
    """Sum per-site compile counts across settings phases (e.g. a
    composed/f32 warm-up followed by a kernel/int8 run after
    ``set_flags`` bumped the flags version): the compile tracker keeps
    one counter per site name across a step cache's rebuilds, so the
    observed count at each site is the sum of the per-phase
    predictions."""
    merged: Dict[str, int] = {}
    for counts in phase_counts:
        for site, n in counts.items():
            merged[site] = merged.get(site, 0) + int(n)
    return merged
