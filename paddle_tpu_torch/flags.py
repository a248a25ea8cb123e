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
            "BlockKVCache. The dense slotted cache (False) is not "
            "ported yet; the engine raises NotImplementedError for it.")
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
