"""The paged serving steps — counterparts of ``step_entry``,
``decode_step_paged``, ``decode_megastep_paged`` and ``_unwrap_pools`` in
``paddle_tpu/models/generation.py``.

Every step is an entry of one cache per model, :func:`step_entry`
(``model._step_compile_cache``), as in the reference. An entry's ``fn``
is a :class:`~paddle_tpu_torch.jit.HeldStep`: on the card each call
replays a CUDA graph captured for its key, on the CPU (and inside
``jit.no_capture()``) the same body runs eagerly. Where the reference
threads the parameters through its jit as data (``_inject_params``), a
graph reads them where they lie: a weight swap writes the new values
into the same tensors (``ServingEngine.swap_weights``), which is what
the next replay reads. The KV pools are held the same way, updated in
place by the forward and returned, the same tensors, for symmetry with
the JAX steps. JAX's ``_wrap_pools`` has no counterpart: pools are plain
tensors here.

Not ported yet: the per-row sampling tuple (``samp``) and the RNG keys
it carries (every request is greedy until sampling is ported), LoRA,
the mesh steps, the dense ``decode_step`` and ``verify_step``.
"""

from __future__ import annotations

import torch

from .. import flags as _flags
from ..jit import HeldStep
from ..serving.decoding import sample_tokens, stops_advance, stops_matched


def step_entry(model, key, build):
    """The one cache of every per-model step (``model._step_compile_cache``,
    as ``paddle_tpu/models/generation.py:135``): an entry's identity is
    its full key (step kind, geometry such as the bucket or N, KV dtype,
    attention implementation). ``build(traces)`` makes the entry, a dict
    with ``fn`` and ``traces``, the dict given (``{"count": n}``: the
    specialisations ``fn`` made, graphs captured on the card, input
    signatures on the CPU). Entries are checked against
    ``flags.version()``: a ``set_flags`` retires every entry and its
    graphs, and the next call builds the entry anew, whose first call
    captures (on the CPU: traces) again. The new entry counts on in the
    old one's ``traces``, so the count of a key only rises.

    The reference's per-model trace lock (``model_trace_lock``) and mesh
    keys wait for the threaded router and mesh serving; this cache is
    used from one thread."""
    cache = model.__dict__.setdefault("_step_compile_cache", {})
    ent = cache.get(key)
    if ent is not None and ent["flags_version"] == _flags.version():
        return ent
    new = build(ent["traces"] if ent is not None else {"count": 0})
    new["flags_version"] = _flags.version()
    cache[key] = new
    return new


def _graph_pool(model):
    """The memory pool every step graph of ``model`` captures into. One
    pool is safe: replays run one at a time, in the caller's stream
    order, and each replay's outputs are cloned before the next."""
    pool = model.__dict__.get("_step_graph_pool")
    if pool is None:
        pool = model._step_graph_pool = torch.cuda.graph_pool_handle()
    return pool


def _held(model, body, traces, what):
    pool = _graph_pool(model) if model.device.type == "cuda" else None
    return HeldStep(body, model.parameters(), traces, pool, what)


def _unwrap_pools(newp):
    """Split off the quantization-error scalar that int8 layers append
    (5th element): returns ``(pools, max_qerr)``, ``max_qerr`` being the
    max over layers (an exact 0.0 for float pools)."""
    qerr = None
    pools = []
    for layer in newp:
        if len(layer) == 5:
            qerr = layer[4] if qerr is None else torch.maximum(qerr, layer[4])
            layer = layer[:4]
        pools.append(tuple(layer))
    if qerr is None:
        qerr = torch.zeros((), dtype=torch.float32, device=pools[0][0].device)
    return pools, qerr


def _decode_body(model, attn_impl):
    """One greedy decode iteration: ``(tokens [b], pos [b], tables, pools)
    -> (next_tokens [b] i32, last_logits [b, V], pools, max_qerr)``."""
    def step(tokens, pos, tables, pools):
        logits, newp = model(tokens[:, None].long(), cache=pools,
                             cache_pos=pos, block_tables=tables,
                             attn_impl=attn_impl)
        lg = logits[:, -1]
        pools, qerr = _unwrap_pools(newp)
        return sample_tokens(lg), lg, pools, qerr
    return step


def decode_step_paged(model, kv_dtype: str = "f32", attn_impl=None):
    """The paged decode step's entry, ``paddle_tpu/models/generation.py
    :310``'s counterpart. Its ``fn(tokens, pos, tables, pools)`` takes
    ``tokens [b] i32``, ``pos [b] i32`` (each row's committed length,
    where its token is written), ``tables [b, T] i32`` (tensors or numpy
    arrays) and the per-layer pools, and returns ``(next_tokens [b] i32,
    last_logits [b, V], pools, max_qerr)``, the pools being the tensors
    given, written in place. Block remapping (admission, prefix sharing,
    copy-on-write) is data: one graph serves every step of one engine.
    ``attn_impl`` None reads ``FLAGS_serving_attn_impl``."""
    attn_impl = attn_impl or _flags.get_flag("serving_attn_impl")
    step = _decode_body(model, attn_impl)

    def build(traces):
        @torch.no_grad()
        def body(tokens, pos, tables, pools):
            nxt, lg, pools, qerr = step(tokens, pos, tables, pools)
            return (nxt, lg, qerr), pools
        held = _held(model, body, traces, "decode_step_paged")

        def fn(tokens, pos, tables, pools):
            nxt, lg, qerr = held([tokens, pos, tables], pools)
            return nxt, lg, pools, qerr

        return {"fn": fn, "traces": traces}

    return step_entry(model, ("decode_paged", kv_dtype, attn_impl), build)


def prefill_step_paged(model, bucket: int, geometry, kv_dtype: str = "f32",
                       attn_impl=None):
    """One bucket's paged prefill entry, the body of the reference
    engine's ``_prefill_entry_paged`` (``serving/engine.py:1364``), keyed
    as it is (``("prefill_paged", bucket, *geometry, kv_dtype,
    attn_impl)``, ``geometry`` being ``(max_slots, max_len, block_size,
    num_blocks)``). Its ``fn(ids [b, bucket], last [b], pos [b], tables,
    pools)`` returns ``(logits at last [b, V], pools, max_qerr)``:
    ``last`` is each row's true last token index, ``pos`` its write
    offset (its shared prefix length). The full ``[b, bucket, V]``
    logits are computed, as the reference's ``take_along_axis`` over
    them does."""
    attn_impl = attn_impl or _flags.get_flag("serving_attn_impl")

    def build(traces):
        @torch.no_grad()
        def body(ids, last, pos, tables, pools):
            logits, newp = model(ids.long(), cache=pools, cache_pos=pos,
                                 block_tables=tables, attn_impl=attn_impl)
            lg = logits[torch.arange(logits.shape[0],
                                     device=logits.device), last.long()]
            pools, qerr = _unwrap_pools(newp)
            return (lg, qerr), pools
        held = _held(model, body, traces, f"prefill_paged[{bucket}]")

        def fn(ids, last, pos, tables, pools):
            lg, qerr = held([ids, last, pos, tables], pools)
            return lg, pools, qerr

        return {"fn": fn, "traces": traces}

    key = ("prefill_paged", int(bucket), *geometry, kv_dtype, attn_impl)
    return step_entry(model, key, build)


def decode_megastep_paged(model, n: int, kv_dtype: str = "f32",
                          attn_impl=None):
    """``n`` paged decode iterations in one dispatch, the counterpart of
    ``paddle_tpu/models/generation.py:393``: on the card one graph of the
    ``n`` iterations unrolled, on the CPU a loop over the same body.

    ``fn(tokens, pos, tables, pools, live [b] bool, budget [b] i32,
    eos [b] i32, stop)`` with ``stop = (pat [b, J, L], plen [b, J],
    fail [b, J, L+1], state [b, J])`` (:func:`~paddle_tpu_torch.serving.
    decoding.stop_table_rows`) returns ``(toks [n, b] i32, finish [b]
    i32, tok_f, pos_f, pools, live_f, rem_f, st_f, max_qerr)``: the
    reference's outputs without its RNG keys, which wait for sampling.

    Per slot and iteration, as in the reference: a live slot feeds its
    carried token at its carried position, takes the argmax, spends one
    of its budget, advances its stop states, and finishes (leaves
    ``live``) on its ``eos`` (-1: none), a matched stop sequence or an
    empty budget. A finished or empty slot freezes: it feeds its last
    token at its frozen position again, a write past its committed
    length into its own reserved blocks (or the trash block), which no
    position mask shows. ``finish[s]`` is the first iteration whose
    token finished slot ``s``, or -1 (still live after ``n``)."""
    n = int(n)
    if n < 2:
        raise ValueError(
            f"decode_megastep_paged needs n >= 2, got {n}; use "
            "decode_step_paged for single steps")
    attn_impl = attn_impl or _flags.get_flag("serving_attn_impl")
    step = _decode_body(model, attn_impl)

    def build(traces):
        @torch.no_grad()
        def body(tokens, pos, tables, live, budget, eos, pat, plen, fail,
                 state, pools):
            tok, p, lv, rem, st = tokens, pos, live.bool(), budget, state
            qerr = torch.zeros((), dtype=torch.float32, device=tok.device)
            toks, fins = [], []
            for _ in range(n):
                nxt, _lg, pools, q = step(tok, p, tables, pools)
                nxt = torch.where(lv, nxt, tok)
                ns = stops_advance(nxt, pat, plen, fail, st)
                ns = torch.where(lv[:, None], ns, st)
                rem = torch.where(lv, rem - 1, rem)
                fin = lv & (((eos >= 0) & (nxt == eos))
                            | stops_matched(ns, plen) | (rem <= 0))
                tok, p, lv, st = nxt, torch.where(lv, p + 1, p), \
                    lv & ~fin, ns
                qerr = torch.maximum(qerr, q)
                toks.append(nxt)
                fins.append(fin)
            toks, fins = torch.stack(toks), torch.stack(fins)
            idx = torch.arange(n, dtype=torch.int32,
                               device=tok.device)[:, None]
            first = torch.amin(torch.where(fins, idx, n), dim=0)
            finish = torch.where(first >= n, -1, first).to(torch.int32)
            return (toks, finish, tok, p, lv, rem, st, qerr), pools
        held = _held(model, body, traces, f"decode_megastep_paged[{n}]")

        def fn(tokens, pos, tables, pools, live, budget, eos, stop):
            (toks, finish, tok_f, pos_f, live_f, rem_f, st_f,
             qerr) = held([tokens, pos, tables, live, budget, eos, *stop],
                          pools)
            return (toks, finish, tok_f, pos_f, pools, live_f, rem_f,
                    st_f, qerr)

        return {"fn": fn, "traces": traces}

    return step_entry(model, ("decode_mega", n, kv_dtype, attn_impl), build)
