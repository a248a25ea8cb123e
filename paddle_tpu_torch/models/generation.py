"""The serving steps and offline generation — counterparts of
``step_entry``, ``decode_step``, ``verify_step``, ``decode_step_paged``,
``decode_megastep_paged``, ``verify_step_paged``, ``draft_ngram``,
``_unwrap_pools``, ``greedy_search``, ``sample`` and ``beam_search`` in
``paddle_tpu/models/generation.py``, and of the dense engine's bucketed
prefill (``ServingEngine._prefill_entry``).

Every step is an entry of one cache per model, :func:`step_entry`
(``model._step_compile_cache``), as in the reference. An entry's ``fn``
runs :class:`~paddle_tpu_torch.jit.HeldStep` objects: on the card each call
replays a CUDA graph captured for its key, on the CPU (and inside
``jit.no_capture()``) the same body runs eagerly. Where the reference
threads the parameters through its jit as data (``_inject_params``), a
graph reads them where they lie: a weight swap writes the new values
into the same tensors (``ServingEngine.swap_weights``), which is what
the next replay reads. The KV pools are held the same way, updated in
place by the forward and returned, the same tensors, for symmetry with
the JAX steps. JAX's ``_wrap_pools`` has no counterpart: pools are plain
tensors here.

Each decode, megastep and verify entry holds two graphs. Called with
``samp=None`` it replays the "greedy" one: the argmax, no sort and no
threefry. Called with the sampling tuple ``samp = (temperature [b],
top_k [b], top_p [b], keys [b, 2], mask [b, V])`` it replays the
"sampled" one, which is the reference's step: every row's key is split
and sampled rows draw (``serving/decoding.py``). The reference computes
both branches in one step for every batch; the engine here passes
``samp`` only when some row samples, so a greedy batch costs what it
did before sampling was ported. The mask is held like the pools, by
address (an all-zero device buffer: no grammar writes it), so a replay
copies only the four small vectors.

The dense steps (:func:`decode_step`, :func:`verify_step`,
:func:`prefill_step`) run the model's fixed-capacity cache branch: the
held tensors are ``[b, h, capacity, d]`` (k, v) pairs, a dense engine's
slot rows or prefill rows, or the model's own fixed caches
(:func:`fixed_cache`), which offline generation (:func:`greedy_search`,
:func:`sample`, :func:`beam_search`) reuses from call to call, so a
second call of the same batch and capacity replays the graphs the first
one captured. Offline generation on one model is therefore not
re-entrant: a call overwrites the cache of the call before it. The
model keeps one such cache per batch, of the last capacity asked for.

Not ported yet: LoRA and the mesh steps.
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np
import torch

from .. import flags as _flags
from .. import prng
from ..jit import HeldStep
from ..serving.decoding import (DecodeParams, greedy_tokens, sample_tokens,
                                stops_advance, stops_matched, verify_tokens)


_TRACE_LOCK_GUARD = threading.Lock()


def model_trace_lock(model) -> threading.RLock:
    """The per-model lock every step of ``model`` and every write of its
    weights share, ``paddle_tpu/models/generation.py:39``'s counterpart.
    The reference holds it while a trace borrows the parameters; here a
    step holds it while it enqueues its graph's replay (or runs its
    eager body, or captures), and ``ServingEngine.swap_weights`` while it
    copies the new values in, so a replica stepped from another thread
    reads either the old weights or the new ones, never a mix. It also
    guards the step cache's dict. Reentrant, as the reference's."""
    lk = model.__dict__.get("_step_trace_lock")
    if lk is None:
        with _TRACE_LOCK_GUARD:
            lk = model.__dict__.get("_step_trace_lock")
            if lk is None:
                lk = model._step_trace_lock = threading.RLock()
    return lk


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
    old one's ``traces``, so the count of a key only rises. The cache is
    read and filled under :func:`model_trace_lock`; mesh keys wait for
    mesh serving."""
    with model_trace_lock(model):
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
    pool is safe: replays run one at a time, in stream order on the one
    stream every caller uses (the default stream, also in the router's
    worker threads), and each replay's outputs are cloned, under the
    model's trace lock, before the next replay is enqueued. A caller
    replaying on a stream of its own would break this."""
    pool = model.__dict__.get("_step_graph_pool")
    if pool is None:
        pool = model._step_graph_pool = torch.cuda.graph_pool_handle()
    return pool


def _held(model, body, traces, what):
    pool = _graph_pool(model) if model.device.type == "cuda" else None
    return HeldStep(body, model.parameters(), traces, pool, what,
                    lock=model_trace_lock(model))


def forget_held(model, ptrs):
    """Drop every graph of ``model``'s step cache that holds a tensor at
    one of the addresses ``ptrs`` (held tensors about to be freed: a
    killed replica's pools, an offline cache of another capacity), with
    the memory the graph keeps."""
    for ent in list(getattr(model, "_step_compile_cache", {}).values()):
        for step in ent.get("graphs", {}).values():
            step.forget(ptrs)


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


def _two_graphs(model, traces, what, body):
    """The entry's "greedy" and "sampled" :class:`HeldStep` objects of one
    ``body(small..., held)``; the sampled one receives the mask as the
    last held tensor and hands it back."""
    return {mode: _held(model, body, traces, f"{what}[{mode}]")
            for mode in ("greedy", "sampled")}


def _run(graphs, small, pools, samp):
    """Replay the greedy graph (``samp`` None) or the sampled one, whose
    small inputs gain ``temp, top_k, top_p, keys`` (keys as int64: a
    uint32 array, the reference's type, is widened on the host) and
    whose held tensors gain the mask."""
    if samp is None:
        return graphs["greedy"](small, pools)
    temp, top_k, top_p, keys, mask = samp
    if isinstance(keys, np.ndarray):
        keys = keys.astype(np.int64)
    mask = torch.as_tensor(mask).to(pools[0][0].device)
    return graphs["sampled"](small + [temp, top_k, top_p, keys],
                             [*pools, (mask,)])


def _split_held(n_small, args):
    """``args`` of a body: its fixed small inputs, then the sampling
    vectors (if any), then the held list; returns ``(small, samp or
    None, pools)``."""
    *small, held = args
    if len(small) == n_small:
        return small, None, held
    temp, top_k, top_p, keys = small[n_small:]
    return small[:n_small], (temp, top_k, top_p, keys, held[-1][0]), \
        held[:-1]


def fixed_cache(model, batch: int, capacity: int):
    """The fixed-capacity cache of ``batch`` rows and ``capacity``
    positions (:meth:`GPTModel.gen_fixed_cache`) that offline generation
    decodes in, made at its first use and kept on the model. Reusing the
    tensors keeps their addresses, hence the graphs captured over them;
    each call zeroes or overwrites what it reads. The model keeps one
    cache per batch, of the last capacity asked for: another capacity
    frees the old cache and drops the graphs captured over it, so calls
    at ever new prompt lengths (``cache_len=None``) hold one cache and
    its graphs per batch, not one per length."""
    caches = model.__dict__.setdefault("_fixed_caches", {})
    b, cap = int(batch), int(capacity)
    old = caches.get(b)
    if old is not None and old[0] == cap:
        return old[1]
    if old is not None:
        forget_held(model, [a.data_ptr() for layer in old[1] for a in layer])
    caches[b] = (cap, model.gpt.gen_fixed_cache(b, cap))
    return caches[b][1]


def _zero_mask(model, rows: int):
    """A zero ``[rows, vocab]`` sampling mask kept on the model, so the
    sampled graphs, which hold it by address, replay across calls."""
    masks = model.__dict__.setdefault("_zero_masks", {})
    if rows not in masks:
        masks[rows] = torch.zeros(rows, model.cfg.vocab_size,
                                  device=model.device)
    return masks[rows]


def decode_step(model):
    """The dense decode step's entry, ``paddle_tpu/models/generation.py
    :186``'s counterpart. Its ``fn(tokens, pos, caches, samp=None)``
    takes ``tokens [b] i32``, ``pos [b] i32`` (each row's write offset)
    and the per-layer (k, v) caches ``[b, h, capacity, d]``, and returns
    ``(next_tokens [b] i32, last_logits [b, V], caches, new_keys)``: the
    caches are the tensors given, written in place, and ``new_keys`` is
    None without ``samp`` (the greedy graph). One entry serves every
    dense cache; each cache's tensors get their own graphs."""
    def build(traces):
        @torch.no_grad()
        def body(*args):
            (tokens, pos), samp, caches = _split_held(2, args)
            logits, _ = model(tokens[:, None].long(), cache=caches,
                              cache_pos=pos)
            lg = logits[:, -1]
            if samp is None:
                return (greedy_tokens(lg), lg), args[-1]
            nxt, keys = sample_tokens(lg, samp)
            return (nxt, lg, keys), args[-1]
        graphs = _two_graphs(model, traces, "decode_step", body)

        def fn(tokens, pos, caches, samp=None):
            out = _run(graphs, [tokens, pos], caches, samp)
            keys = out[2] if samp is not None else None
            return out[0], out[1], caches, keys

        return {"fn": fn, "traces": traces, "graphs": graphs}

    return step_entry(model, ("decode",), build)


def verify_step(model, spec_tokens: int):
    """The dense speculative verify step, ``paddle_tpu/models/
    generation.py:231``'s counterpart: one forward of ``tokens [b, K+1]``
    (each row's last committed token and its K drafts) written at each
    row's offset, then the argmax and ``accept = argmax == draft`` (greedy
    graph) or :func:`~paddle_tpu_torch.serving.decoding.verify_tokens`
    (with ``samp``). ``fn(tokens, pos, caches, samp=None)`` returns
    ``(chosen [b, K+1] i32, logits [b, K+1, V], caches, accept [b, K]
    bool, new_keys)``; rows written past the accepted prefix are rolled
    back by the caller and hidden by the position mask."""
    k = int(spec_tokens)
    if k < 1:
        raise ValueError(f"verify_step needs spec_tokens >= 1, got {k}")

    def build(traces):
        @torch.no_grad()
        def body(*args):
            (tokens, pos), samp, caches = _split_held(2, args)
            logits, _ = model(tokens.long(), cache=caches, cache_pos=pos)
            if samp is None:
                chosen = greedy_tokens(logits)
                return (chosen, logits, chosen[:, :k] == tokens[:, 1:]), \
                    args[-1]
            chosen, accept, keys = verify_tokens(logits, tokens[:, 1:], samp)
            return (chosen, logits, accept, keys), args[-1]
        graphs = _two_graphs(model, traces, f"verify_step[{k}]", body)

        def fn(tokens, pos, caches, samp=None):
            out = _run(graphs, [tokens, pos], caches, samp)
            keys = out[3] if samp is not None else None
            return out[0], out[1], caches, out[2], keys

        return {"fn": fn, "traces": traces, "graphs": graphs}

    return step_entry(model, ("verify", k), build)


def prefill_step(model, bucket: int, max_slots: int, max_len: int):
    """One bucket's dense prefill entry, the body of the reference
    engine's ``_prefill_entry`` (``serving/engine.py:1297``), keyed as it
    is (``("prefill", bucket, max_slots, max_len)``). Its ``fn(ids
    [max_slots, bucket], last [max_slots], rows)`` zeroes ``rows``, the
    caller's own ``[max_slots, h, max_len, d]`` (k, v) tensors per layer
    (held by address like a slot cache; the reference allocates a fresh
    cache per call), prefills every row from position 0 and returns
    ``(logits at last [max_slots, V], rows)``: ``last`` is each row's
    true last token index; the caller copies the rows into its slots
    before its next prefill overwrites them. Rows past the caller's
    group are padding."""
    def build(traces):
        @torch.no_grad()
        def body(ids, last, pos, rows):
            for layer in rows:
                for a in layer:
                    a.zero_()
            logits, _ = model(ids.long(), cache=rows, cache_pos=pos)
            lg = logits[torch.arange(logits.shape[0],
                                     device=logits.device), last.long()]
            return (lg,), rows
        held = _held(model, body, traces, f"prefill[{bucket}]")
        pos = np.zeros(max_slots, np.int32)

        def fn(ids, last, rows):
            (lg,) = held([ids, last, pos], rows)
            return lg, rows

        return {"fn": fn, "traces": traces,
                "graphs": {"prefill": held}}

    key = ("prefill", int(bucket), int(max_slots), int(max_len))
    return step_entry(model, key, build)


def _decode_body(model, attn_impl):
    """One decode iteration: ``(tokens [b], pos [b], tables, pools, samp)
    -> (next_tokens [b] i32, last_logits [b, V], pools, max_qerr,
    new_keys)``; with ``samp`` None the argmax and no keys."""
    def step(tokens, pos, tables, pools, samp):
        logits, newp = model(tokens[:, None].long(), cache=pools,
                             cache_pos=pos, block_tables=tables,
                             attn_impl=attn_impl)
        lg = logits[:, -1]
        pools, qerr = _unwrap_pools(newp)
        if samp is None:
            return greedy_tokens(lg), lg, pools, qerr, None
        nxt, keys = sample_tokens(lg, samp)
        return nxt, lg, pools, qerr, keys
    return step


def decode_step_paged(model, kv_dtype: str = "f32", attn_impl=None):
    """The paged decode step's entry, ``paddle_tpu/models/generation.py
    :310``'s counterpart. Its ``fn(tokens, pos, tables, pools, samp=None)``
    takes ``tokens [b] i32``, ``pos [b] i32`` (each row's committed
    length, where its token is written), ``tables [b, T] i32`` (tensors
    or numpy arrays), the per-layer pools and the sampling tuple, and
    returns ``(next_tokens [b] i32, last_logits [b, V], pools, max_qerr,
    new_keys [b, 2] int64)``, the pools being the tensors given, written
    in place, and ``new_keys`` None without ``samp``. Block remapping
    (admission, prefix sharing, copy-on-write) and the sampling
    parameters are data: one graph of each kind serves every step of one
    engine. ``attn_impl`` None reads ``FLAGS_serving_attn_impl``."""
    attn_impl = attn_impl or _flags.get_flag("serving_attn_impl")
    step = _decode_body(model, attn_impl)

    def build(traces):
        @torch.no_grad()
        def body(*args):
            (tokens, pos, tables), samp, pools = _split_held(3, args)
            nxt, lg, pools, qerr, keys = step(tokens, pos, tables, pools,
                                              samp)
            out = (nxt, lg, qerr) if samp is None else (nxt, lg, qerr, keys)
            return out, args[-1]
        graphs = _two_graphs(model, traces, "decode_step_paged", body)

        def fn(tokens, pos, tables, pools, samp=None):
            out = _run(graphs, [tokens, pos, tables], pools, samp)
            keys = out[3] if samp is not None else None
            return out[0], out[1], pools, out[2], keys

        return {"fn": fn, "traces": traces, "graphs": graphs}

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

        return {"fn": fn, "traces": traces,
                "graphs": {"prefill": held}}

    key = ("prefill_paged", int(bucket), *geometry, kv_dtype, attn_impl)
    return step_entry(model, key, build)


def decode_megastep_paged(model, n: int, kv_dtype: str = "f32",
                          attn_impl=None):
    """``n`` paged decode iterations in one dispatch, the counterpart of
    ``paddle_tpu/models/generation.py:393``: on the card one graph of the
    ``n`` iterations unrolled, on the CPU a loop over the same body.

    ``fn(tokens, pos, tables, pools, samp, live [b] bool, budget [b] i32,
    eos [b] i32, stop)`` with ``stop = (pat [b, J, L], plen [b, J],
    fail [b, J, L+1], state [b, J])`` (:func:`~paddle_tpu_torch.serving.
    decoding.stop_table_rows`) returns the reference's ``(toks [n, b]
    i32, finish [b] i32, tok_f, pos_f, pools, keys_f, live_f, rem_f,
    st_f, max_qerr)``; ``samp`` None replays the greedy graph, whose
    ``keys_f`` is None.

    Per slot and iteration, as in the reference: a live slot feeds its
    carried token at its carried position, takes its next token (the
    argmax, or a draw with its own key), spends one of its budget,
    advances its stop states, and finishes (leaves ``live``) on its
    ``eos`` (-1: none), a matched stop sequence or an empty budget. A
    finished or empty slot freezes: it feeds its last token at its
    frozen position again, a write past its committed length into its
    own reserved blocks (or the trash block), which no position mask
    shows. Keys advance for every row every iteration (the engine keeps
    only live sampled rows'). ``finish[s]`` is the first iteration whose
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
        def body(*args):
            (tokens, pos, tables, live, budget, eos, pat, plen, fail,
             state), samp, pools = _split_held(10, args)
            tok, p, lv, rem, st = tokens, pos, live.bool(), budget, state
            keys = None if samp is None else samp[3]
            qerr = torch.zeros((), dtype=torch.float32, device=tok.device)
            toks, fins = [], []
            for _ in range(n):
                it = None if samp is None else (*samp[:3], keys, samp[4])
                nxt, _lg, pools, q, keys = step(tok, p, tables, pools, it)
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
            out = (toks, finish, tok, p, lv, rem, st, qerr)
            return (out if samp is None else (*out, keys)), args[-1]
        graphs = _two_graphs(model, traces, f"decode_megastep_paged[{n}]",
                             body)

        def fn(tokens, pos, tables, pools, samp, live, budget, eos, stop):
            out = _run(graphs, [tokens, pos, tables, live, budget, eos,
                                *stop], pools, samp)
            (toks, finish, tok_f, pos_f, live_f, rem_f, st_f,
             qerr) = out[:8]
            keys_f = out[8] if samp is not None else None
            return (toks, finish, tok_f, pos_f, pools, keys_f, live_f,
                    rem_f, st_f, qerr)

        return {"fn": fn, "traces": traces, "graphs": graphs}

    return step_entry(model, ("decode_mega", n, kv_dtype, attn_impl), build)


def verify_step_paged(model, spec_tokens: int, kv_dtype: str = "f32",
                      attn_impl=None):
    """The speculative verify step, ``paddle_tpu/models/generation.py
    :539``'s counterpart: one forward of ``tokens [b, K+1]`` (each row's
    last committed token and its K drafts) at each row's committed length
    through its block table, the attention at q_len K+1 through the paged
    kernel, then :func:`~paddle_tpu_torch.serving.decoding.verify_tokens`
    (with ``samp``) or, for a greedy batch (``samp`` None), the argmax at
    every position and ``accept = argmax == draft``, the reference's
    greedy rows. ``fn(tokens, pos, tables, pools, samp=None)`` returns
    ``(chosen [b, K+1] i32, logits [b, K+1, V], pools, max_qerr, accept
    [b, K] bool, new_keys)``. The K+1 rows written past a row's accepted
    prefix are stale pool contents behind the position mask; the engine
    rolls the row's length back over them (blocks stay reserved)."""
    k = int(spec_tokens)
    if k < 1:
        raise ValueError(
            f"verify_step_paged needs spec_tokens >= 1, got {k}")
    attn_impl = attn_impl or _flags.get_flag("serving_attn_impl")

    def build(traces):
        @torch.no_grad()
        def body(*args):
            (tokens, pos, tables), samp, pools = _split_held(3, args)
            logits, newp = model(tokens.long(), cache=pools, cache_pos=pos,
                                 block_tables=tables, attn_impl=attn_impl)
            pools, qerr = _unwrap_pools(newp)
            if samp is None:
                chosen = greedy_tokens(logits)
                out = (chosen, logits, qerr, chosen[:, :k] == tokens[:, 1:])
            else:
                chosen, accept, keys = verify_tokens(logits, tokens[:, 1:],
                                                     samp)
                out = (chosen, logits, qerr, accept, keys)
            return out, args[-1]
        graphs = _two_graphs(model, traces, f"verify_step_paged[{k}]", body)

        def fn(tokens, pos, tables, pools, samp=None):
            out = _run(graphs, [tokens, pos, tables], pools, samp)
            keys = out[4] if samp is not None else None
            return out[0], out[1], pools, out[2], out[3], keys

        return {"fn": fn, "traces": traces, "graphs": graphs}

    return step_entry(model, ("verify_paged", k, kv_dtype, attn_impl), build)


def draft_ngram(context, k: int, max_ngram: int = 3):
    """N-gram self-drafting (prompt-lookup decoding), ``paddle_tpu/models/
    generation.py:608``: propose ``k`` draft tokens by matching the
    longest suffix n-gram of ``context`` (prompt + generated so far)
    against its own earlier occurrences and copying what followed. Tries
    n-grams from ``max_ngram`` down to 1, the most recent match first; a
    short continuation is cycled up to ``k``; with no match the last
    token is repeated. Host-side list work."""
    ctx = [int(t) for t in context]
    n_ctx = len(ctx)
    for n in range(min(int(max_ngram), n_ctx - 1), 0, -1):
        pat = ctx[n_ctx - n:]
        for j in range(n_ctx - n - 1, -1, -1):
            if ctx[j:j + n] == pat:
                cont = ctx[j + n:j + n + k]
                if cont:
                    while len(cont) < k:
                        cont = cont + cont
                    return cont[:k]
    return [ctx[-1]] * k


def _capacity(s0: int, max_new_tokens: int, cache_len) -> int:
    cap = int(cache_len if cache_len is not None else s0 + max_new_tokens)
    if cap < s0 + max_new_tokens:
        raise ValueError(
            f"cache_len {cap} < prompt {s0} + max_new_tokens "
            f"{max_new_tokens}")
    return cap


def _prefill(model, ids: np.ndarray, capacity: int):
    """Eager prompt pass into the model's fixed cache of this batch and
    capacity, zeroed first (the reference allocates a fresh one).
    Returns ``(last_logits [b, V], caches)``."""
    cfg = model.cfg
    if capacity > cfg.max_position_embeddings:
        raise ValueError(
            f"cache capacity {capacity} exceeds max_position_embeddings="
            f"{cfg.max_position_embeddings}; raise it in the GPTConfig "
            "or shorten prompt/max_new_tokens")
    b, s0 = ids.shape
    if s0 > capacity:
        raise ValueError(f"prompt length {s0} exceeds cache capacity "
                         f"{capacity}")
    cache = fixed_cache(model, b, capacity)
    for layer in cache:
        for a in layer:
            a.zero_()
    ids_t = torch.as_tensor(ids, dtype=torch.int64).to(model.device)
    logits, cache = model(ids_t, cache=cache, cache_pos=0)
    return logits[:, -1], cache


@torch.no_grad()
def greedy_search(model, input_ids, max_new_tokens: int = 16,
                  eos_token_id: Optional[int] = None,
                  cache_len: Optional[int] = None):
    """Greedy decode on the fixed-capacity cache, the counterpart of
    ``paddle_tpu/models/generation.py:654``; returns ``[b, s + new]`` ids
    (numpy). ``cache_len`` pins the capacity (default prompt + new
    tokens): the serving tests pass the engine's ``max_len`` so both
    sides compute over the same capacity. The decode steps replay the
    greedy graph of :func:`decode_step`."""
    ids = np.asarray(input_ids)
    b, s0 = ids.shape
    cap = _capacity(s0, max_new_tokens, cache_len)
    logits, caches = _prefill(model, ids, cap)
    step = decode_step(model)["fn"]
    out = [ids]
    done = np.zeros(b, bool)
    cur = torch.argmax(logits, dim=-1).cpu().numpy().reshape(b, 1)
    pos = np.full((b,), s0, np.int32)
    for t in range(max_new_tokens):
        if eos_token_id is not None:
            cur = np.where(done[:, None], eos_token_id, cur)
            done |= (cur[:, 0] == eos_token_id)
        out.append(cur.astype(ids.dtype))
        if eos_token_id is not None and done.all():
            break
        if t == max_new_tokens - 1:
            break
        nxt, _, caches, _ = step(cur[:, 0].astype(np.int32), pos, caches)
        pos = pos + 1
        cur = nxt.cpu().numpy().reshape(b, 1)
    return np.concatenate(out, axis=1)


@torch.no_grad()
def sample(model, input_ids, max_new_tokens: int = 16,
           temperature: float = 1.0, top_k: int = 0, top_p: float = 0.0,
           seed: int = 0, cache_len: Optional[int] = None):
    """Temperature / top-k / top-p sampling on the fixed-capacity cache,
    the counterpart of ``paddle_tpu/models/generation.py:694``: the
    first token is drawn from the prefill logits by
    :func:`~paddle_tpu_torch.serving.decoding.sample_tokens`, the rest by
    the sampled graph of :func:`decode_step`, every row from its key of
    ``split(PRNGKey(seed), b)``; returns ``[b, s + new]`` ids (numpy)."""
    params = DecodeParams(temperature=float(temperature), top_k=int(top_k),
                          top_p=float(top_p), seed=int(seed))
    ids = np.asarray(input_ids)
    b, s0 = ids.shape
    cap = _capacity(s0, max_new_tokens, cache_len)
    lg, caches = _prefill(model, ids, cap)
    step = decode_step(model)["fn"]
    dev = model.device
    temp = torch.full((b,), params.temperature, device=dev)
    tk = torch.full((b,), params.top_k, dtype=torch.int32, device=dev)
    tp = torch.full((b,), params.top_p, device=dev)
    mask = _zero_mask(model, b)
    keys = prng.split(prng.PRNGKey(params.seed, device=dev), b)
    nxt, keys = sample_tokens(lg, (temp, tk, tp, keys, mask))
    cur = nxt.cpu().numpy().reshape(b, 1)
    out = [ids]
    pos = np.full((b,), s0, np.int32)
    for t in range(max_new_tokens):
        out.append(cur.astype(ids.dtype))
        if t == max_new_tokens - 1:
            break
        nxt, _, caches, keys = step(cur[:, 0].astype(np.int32), pos, caches,
                                    (temp, tk, tp, keys, mask))
        pos = pos + 1
        cur = nxt.cpu().numpy().reshape(b, 1)
    return np.concatenate(out, axis=1)


@torch.no_grad()
def beam_search(model, input_ids, beam_size: int = 4,
                max_new_tokens: int = 16, length_penalty: float = 1.0,
                eos_token_id: Optional[int] = None,
                cache_len: Optional[int] = None):
    """Beam search decode, the counterpart of ``paddle_tpu/models/
    generation.py:743``; returns ``(ids [b, s + new], scores [b])``.

    The beam is a dense ``b * beam`` batch axis: after the prompt the
    prefill cache's rows are copied ``beam`` times each into the model's
    fixed cache of ``b * beam`` rows; each step scores on the host with
    the reference's numpy code (its ``argsort``, so ties break alike),
    then every cache tensor's beam axis is reordered by parent in place
    (``copy_`` of an ``index_select``) where the reference rebinds it."""
    ids = np.asarray(input_ids)
    b, s0 = ids.shape
    k = beam_size
    cap = _capacity(s0, max_new_tokens, cache_len)
    logits, caches = _prefill(model, ids, cap)
    step = decode_step(model)["fn"]
    dev = model.device
    lp = torch.log_softmax(logits, dim=-1).cpu().numpy()
    vocab = lp.shape[-1]
    # seed beams with the top-k first tokens
    top = np.argsort(-lp, axis=-1)[:, :k]                   # [b, k]
    scores = np.take_along_axis(lp, top, -1)                # [b, k]
    tokens = top.reshape(b * k, 1)
    # expand the caches along the beam axis (rows are independent)
    beams = fixed_cache(model, b * k, cap)
    rep = torch.as_tensor(np.repeat(np.arange(b), k)).to(dev)
    for dst, src in zip(beams, caches):
        for d, a in zip(dst, src):
            d.copy_(a.index_select(0, rep))
    seqs = np.concatenate([np.repeat(ids, k, axis=0), tokens], axis=1)
    done = np.zeros((b, k), bool)
    pos = np.full((b * k,), s0, np.int32)

    for t in range(1, max_new_tokens):
        _, lg, beams, _ = step(tokens[:, 0].astype(np.int32), pos, beams)
        pos = pos + 1
        lg = lg.cpu().numpy()                               # [b*k, V]
        lg = lg - lg.max(-1, keepdims=True)
        lp = lg - np.log(np.exp(lg).sum(-1, keepdims=True))
        lp = lp.reshape(b, k, vocab)
        if eos_token_id is not None:
            # finished beams only extend with EOS at no cost
            frozen = np.full((vocab,), -1e9, lp.dtype)
            frozen[eos_token_id] = 0.0
            lp = np.where(done[..., None], frozen, lp)
        total = scores[..., None] + lp                      # [b, k, V]
        flat = total.reshape(b, k * vocab)
        best = np.argsort(-flat, axis=-1)[:, :k]            # [b, k]
        scores = np.take_along_axis(flat, best, -1)
        parent = best // vocab                              # [b, k]
        tok = (best % vocab).astype(ids.dtype)
        # reorder beam-major state by parent
        gidx = (np.arange(b)[:, None] * k + parent).reshape(-1)
        seqs = np.concatenate([seqs[gidx], tok.reshape(b * k, 1)], 1)
        g = torch.as_tensor(gidx).to(dev)
        for layer in beams:
            for a in layer:
                a.copy_(a.index_select(0, g))
        if eos_token_id is not None:
            done = np.take_along_axis(done, parent, 1) | \
                (tok == eos_token_id)
            if done.all():
                break
        tokens = tok.reshape(b * k, 1)

    lengths = seqs.shape[1] - s0
    final = scores / (lengths ** length_penalty)
    best_beam = final.argmax(-1)                            # [b]
    pick = np.arange(b) * k + best_beam
    return seqs[pick], final[np.arange(b), best_beam]
