"""The port's decode megasteps on the CPU, against the JAX package's:
``decode_megastep_paged`` from identical inputs (every integer output
equal, pools and int8 scales within the GPT tests' f32 bound, int8
codes bit-equal), and the engine at megastep 2 and 4 against the JAX engine at
the same megastep, f32 and int8 pools, prefix cache on and off, with an
eos, a stop sequence and a budget that each end a request in the middle
of a megastep (``tests/test_serving_megastep.py:126,141,172``); stops the
device tables cannot hold fall back to single steps without building the
megastep (``:194``); the validation errors (``:312``). A sampled
megastep (rows at temperature > 0 with their own keys) gives JAX's
tokens, finishes and ``keys_f``, and the tokens and keys of ``n`` single
sampled steps; the JAX side of that test runs with 64-bit types off, as
in ``tests/test_torch_sampling.py``.
"""

import torch_threads  # noqa: F401  (one worker's share of the cores)
import contextlib
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.models.generation import decode_megastep_paged as jmega
from paddle_tpu.models.gpt import GPTConfig as JGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JGPT
from paddle_tpu.resilience import fault_scope as jfault_scope
from paddle_tpu.resilience import reset_default_budget as jreset_budget
from paddle_tpu.serving import HostBlockStore as JHostBlockStore
from paddle_tpu.serving import ServingEngine as JServingEngine
from paddle_tpu.serving import TierManager as JTierManager
from paddle_tpu.serving import decoding as jdec
from paddle_tpu.serving import make_adapter as jmake_adapter
from paddle_tpu.serving.decoding import neutral_samp
from paddle_tpu_torch.models import generation as gen
from paddle_tpu_torch.models.convert import gpt_state_from_numpy
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.resilience import fault_scope as tfault_scope
from paddle_tpu_torch.resilience import reset_default_budget as treset_budget
from paddle_tpu_torch.serving import (HostBlockStore, ServingEngine,
                                      TierManager, make_adapter)
from paddle_tpu_torch.serving import decoding as tdec
from paddle_tpu_torch.serving import kv_cache as tdkv
from test_torch_serving import ENGINE, GEOM

ATOL = 1e-5     # the f32 bound of tests/test_torch_gpt.py


@pytest.fixture(scope="module")
def models():
    pt.seed(7)
    jm = JGPT(JGPTConfig(**GEOM))
    jm.eval()
    arrays = {n: np.asarray(p.value) for n, p in jm.named_parameters()}
    return jm, arrays


def _port(arrays):
    tm = GPTForCausalLM(GPTConfig(**GEOM), device="cpu")
    tm.load_state_dict(gpt_state_from_numpy(arrays, "cpu"), strict=True)
    return tm.eval()


@pytest.fixture(scope="module")
def port(models):
    return _port(models[1])


def _prompts(sizes, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, 97, size=n).tolist() for n in sizes]


# ------------------------------------------------- the megastep itself
B, NB, BS, T, N = 4, 12, 4, 4, 4
TABLES = np.asarray([[1, 2, 3, 4], [5, 6, 7, 0], [8, 9, 10, 0],
                     [0, 0, 0, 0]], np.int32)
POS = np.asarray([5, 3, 6, 0], np.int32)


def _prefilled_pools(jm, kv, seed=0):
    """Pools holding each row's random prompt of ``POS`` tokens, written
    by a JAX prefill (padding rows past a prompt are overwritten by the
    decode writes, or never seen): the same numpy arrays start both
    sides."""
    from paddle_tpu.dygraph.tape import no_grad
    from paddle_tpu.dygraph.tensor import Tensor
    from paddle_tpu.models.generation import _unwrap_pools, _wrap_pools
    ids = np.random.RandomState(seed).randint(1, 97, size=(B, 8))
    pools = [tuple(t.value for t in layer)
             for layer in jm.gpt.gen_block_pool(NB, BS, kv)]
    with no_grad():
        _, newp = jm(Tensor(ids.astype(np.int32), stop_gradient=True),
                     cache=_wrap_pools(pools),
                     cache_pos=jnp.zeros(B, jnp.int32),
                     block_tables=jnp.asarray(TABLES))
    pools, _ = _unwrap_pools(newp)
    return [tuple(np.array(a) for a in layer) for layer in pools]


def _stop_tables(matchers):
    rows = [tdec.stop_table_rows(m) for m in matchers]
    return tuple(np.stack([r[i] for r in rows]) for i in range(4))


def _mega_both(jm, tm, kv, live, budget, eos, stop, tokens):
    pt.set_flags({"serving_attn_impl": "xla"})
    pools = _prefilled_pools(jm, kv)
    samp = tuple(jnp.asarray(a) for a in neutral_samp(B, GEOM["vocab_size"]))
    jout = jmega(jm, N, kv_dtype=kv)["fn"](
        jnp.asarray(tokens), jnp.asarray(POS), jnp.asarray(TABLES),
        [tuple(jnp.asarray(a) for a in layer) for layer in pools], samp,
        jnp.asarray(live), jnp.asarray(budget), jnp.asarray(eos),
        tuple(jnp.asarray(a) for a in stop))
    tpools = [tuple(torch.from_numpy(a.copy()) for a in layer)
              for layer in pools]
    tout = gen.decode_megastep_paged(tm, N, kv_dtype=kv,
                                     attn_impl="kernel")["fn"](
        tokens, POS, TABLES, tpools, None, live, budget, eos, stop)
    return jout, tout, tpools


@pytest.mark.parametrize("kv", ["f32", "int8"])
def test_decode_megastep_matches_jax(models, port, kv):
    """Row 0 finishes on its eos, row 1 on a stop sequence (fed a token
    of history, so it starts mid-pattern), row 2 on its budget, each
    inside the megastep; row 3 is an empty slot. Every integer output
    equals JAX's; float pools and int8 scales agree within ATOL (a scale
    is the absmax of K/V rows the two models compute, which agree to
    rounding; test_torch_paged_attention.py holds scales bit-equal for
    equal rows), int8 codes bit for bit."""
    jm, _ = models
    tokens = np.asarray([7, 11, 13, 0], np.int32)
    live = np.asarray([True, True, True, False])
    inert = _stop_tables([None] * B)
    eos = np.full(B, -1, np.int32)
    budget = np.asarray([50, 50, 2, 1], np.int32)
    _, free, _ = _mega_both(jm, port, kv, live, budget, eos, inert, tokens)
    toks = free[0].numpy()
    k0 = next(k for k in range(1, N - 1) if toks[k, 0] not in toks[:k, 0])
    eos[0] = toks[k0, 0]
    m = tdec.StopMatcher([[int(toks[0, 1]), int(toks[1, 1]),
                           int(toks[2, 1])], [96, 95]])
    m.feed(int(toks[0, 1]))           # history: the pattern's first token
    stop = _stop_tables([None, m, None, None])
    m1 = tdec.StopMatcher(m.patterns)
    m1.feed(int(toks[0, 1]))
    f1 = next(i for i in range(N) if m1.feed(int(toks[i, 1])))
    jout, tout, tpools = _mega_both(jm, port, kv, live, budget, eos, stop,
                                    tokens)
    (jtoks, jfin, jtok, jpos, jpools, _keys, jlive, jrem, jst, jq) = jout
    (ttoks, tfin, ttok, tpos, tp, tkeys, tlive, trem, tst, tq) = tout
    assert tp is tpools and tkeys is None     # the greedy graph
    assert tfin.tolist() == [k0, f1, 1, -1]
    for a, b in ((ttoks, jtoks), (tfin, jfin), (ttok, jtok), (tpos, jpos),
                 (tlive, jlive), (trem, jrem), (tst, jst)):
        assert a.dtype in (torch.int32, torch.bool)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for tl, jl in zip(tp, jpools):
        for a, b in zip(tl, jl):
            if a.dtype == torch.float32:
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           atol=ATOL, rtol=0)
            else:
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_allclose(float(tq), float(jq), rtol=1e-5)
    assert (float(tq) > 0) == (kv == "int8")


def test_sampled_megastep_matches_jax_and_single_steps(models, port):
    """Rows 0 and 2 sample (row 2 without top-k/top-p), row 1 is greedy,
    row 3 an empty slot; row 2 finishes on its budget inside the
    megastep. Tokens, finishes and carried keys equal JAX's; ``n``
    single sampled steps from the same state give the same tokens and,
    for the rows live throughout, the same keys."""
    import jax
    jm, _ = models
    kv, v = "f32", GEOM["vocab_size"]
    tokens = np.asarray([7, 11, 13, 0], np.int32)
    live = np.asarray([True, True, True, False])
    budget = np.asarray([50, 50, 2, 1], np.int32)
    eos = np.full(B, -1, np.int32)
    stop = _stop_tables([None] * B)
    samp = (np.asarray([0.9, 0.0, 1.0, 0.0], np.float32),
            np.asarray([20, 0, 0, 0], np.int32),
            np.asarray([0.9, 0, 0, 0], np.float32),
            np.stack([tdec.request_key(s) for s in (5, 6, 7, 8)]),
            np.zeros((B, v), np.float32))
    pt.set_flags({"serving_attn_impl": "xla"})
    pools = _prefilled_pools(jm, kv)
    with jax.enable_x64(False):
        jout = jmega(jm, N, kv_dtype=kv)["fn"](
            jnp.asarray(tokens), jnp.asarray(POS), jnp.asarray(TABLES),
            [tuple(jnp.asarray(a) for a in layer) for layer in pools],
            tuple(jnp.asarray(a) for a in samp), jnp.asarray(live),
            jnp.asarray(budget), jnp.asarray(eos),
            tuple(jnp.asarray(a) for a in stop))
    tpools = [tuple(torch.from_numpy(a.copy()) for a in layer)
              for layer in pools]
    tout = gen.decode_megastep_paged(port, N, kv_dtype=kv,
                                     attn_impl="kernel")["fn"](
        tokens, POS, TABLES, tpools, samp, live, budget, eos, stop)
    assert tout[1].tolist() == [-1, -1, 1, -1]
    for i in (0, 1, 2, 3, 5, 6, 7, 8):
        np.testing.assert_array_equal(tout[i].numpy(), np.asarray(jout[i]))
    # n single sampled steps from the same pools and keys
    spools = [tuple(torch.from_numpy(a.copy()) for a in layer)
              for layer in pools]
    step = gen.decode_step_paged(port, kv_dtype=kv, attn_impl="kernel")["fn"]
    tok, pos, keys = tokens.copy(), POS.copy(), samp[3].astype(np.int64)
    toks = []
    for it in range(N):
        nxt, _, _, _, new_keys = step(tok, pos, TABLES, spools,
                                      (*samp[:3], keys, samp[4]))
        nxt = nxt.numpy()
        lv = tout[1].numpy()
        lv = (lv < 0) | (lv >= it)
        lv &= live
        tok = np.where(lv, nxt, tok).astype(np.int32)
        pos = np.where(lv, pos + 1, pos).astype(np.int32)
        keys = new_keys.numpy()
        toks.append(tok)
    np.testing.assert_array_equal(np.stack(toks), tout[0].numpy())
    np.testing.assert_array_equal(keys[[0, 1]], tout[5].numpy()[[0, 1]])


def test_megastep_needs_two_iterations(models, port):
    jm, _ = models
    for n in (1, 0):
        with pytest.raises(ValueError) as want:
            jmega(jm, n)
        with pytest.raises(ValueError) as got:
            gen.decode_megastep_paged(port, n)
        assert str(got.value) == str(want.value)


# ---------------------------------------------------------- the engine
def _run(eng, specs):
    reqs = [eng.submit(p, **kw) for p, kw in specs]
    eng.run_until_idle()
    assert all(r.state == "done" for r in reqs)
    return [r.output_ids for r in reqs]


def _first_odd(keys):
    """The first odd k (1..9) at which ``keys[k]`` appears for the first
    time: an eos or a stop completing there ends a request after k
    decode tokens, mid-megastep at N 2 and 4."""
    for k in range(1, min(10, len(keys)), 2):
        if keys[k] not in keys[:k]:
            return k
    return None


def _specs(jm, kv, prefix_cache):
    """Requests whose eos, stop sequence and budget each end them after
    an odd number of decode tokens, chosen from a JAX megastep-1 run at
    the same settings; a plain one; a repeated prompt (a prefix hit in
    the second round when the cache is on)."""
    prompts = _prompts((5, 9, 7, 11, 6, 4), seed=2)
    base = _run(JServingEngine(jm, kv_dtype=kv, prefix_cache=prefix_cache,
                               **ENGINE),
                [(p, {"max_new_tokens": 10}) for p in prompts])
    gens = [out[len(p):] for p, out in zip(prompts, base)]
    eos = stop = None
    for p, g in zip(prompts, gens):
        k = _first_odd(g)
        if eos is None and k is not None:
            eos = (p, {"max_new_tokens": 10, "eos_token_id": g[k]})
            continue
        k = _first_odd([None] + [tuple(g[j - 1:j + 1])
                                 for j in range(1, len(g))])
        if stop is None and k is not None:
            stop = (p, {"max_new_tokens": 10, "stop": [g[k - 1:k + 1]]})
    assert eos is not None and stop is not None
    return [eos, stop, (prompts[2], {"max_new_tokens": 6}),
            (prompts[3], {"max_new_tokens": 9}), eos]


@pytest.mark.parametrize("prefix_cache", [True, False])
@pytest.mark.parametrize("kv", ["f32", "int8"])
@pytest.mark.parametrize("n", [2, 4])
def test_engine_megastep_matches_jax(models, port, n, kv, prefix_cache):
    jm, _ = models
    pt.set_flags({"serving_attn_impl": "xla"})
    specs = _specs(jm, kv, prefix_cache)
    ref = _run(JServingEngine(jm, kv_dtype=kv, prefix_cache=prefix_cache,
                              megastep=n, **ENGINE), specs)
    eng = ServingEngine(port, kv_dtype=kv, prefix_cache=prefix_cache,
                        megastep=n, device="cpu", **ENGINE)
    assert _run(eng, specs) == ref
    st = eng.stats()
    assert st["megastep"] == n and st["megastep_dispatches"] > 0
    assert st["decode_steps"] == 0
    assert (st["prefix_hit_requests"] > 0) == prefix_cache
    decoded = [len(out) - len(p) - 1 for (p, _), out in zip(specs, ref)]
    assert [d % 2 for d in decoded[:3]] == [1, 1, 1], decoded
    assert decoded[0] < 9 and ref[0][-1] == specs[0][1]["eos_token_id"]
    assert decoded[1] < 9 and ref[1][-2:] == specs[1][1]["stop"][0]
    assert decoded[2] == 5


def test_oversized_stops_fall_back_without_a_megastep(models):
    """Stops beyond the device tables (too many, or one too long) take
    the whole batch to single steps: tokens as at megastep 1 (and as
    JAX's), and no megastep entry is ever built."""
    jm, arrays = models
    tm = _port(arrays)
    prompts = _prompts((5, 7), seed=5)
    many = [[90 + j] for j in range(tdec.STOP_MAX_SEQS + 1)]
    long = [list(range(1, tdec.STOP_MAX_LEN + 2))]
    pt.set_flags({"serving_attn_impl": "xla"})
    for bad in (many, long):
        assert not tdec.stops_fit(bad)
        specs = [(p, {"max_new_tokens": 6, "stop": bad}) for p in prompts]
        eng = ServingEngine(tm, megastep=4, device="cpu", **ENGINE)
        out = _run(eng, specs)
        assert eng.megastep_dispatches == 0 and eng.decode_steps > 0
        assert not any(k[0] == "decode_mega" for k in tm._step_compile_cache)
        assert out == _run(ServingEngine(tm, device="cpu", **ENGINE), specs)
        assert out == _run(JServingEngine(jm, **ENGINE), specs)


def test_megastep_validation_errors(models, port):
    jm, _ = models
    for bad in (0, -3):
        with pytest.raises(ValueError) as want:
            JServingEngine(jm, megastep=bad, **ENGINE)
        with pytest.raises(ValueError) as got:
            ServingEngine(port, megastep=bad, device="cpu", **ENGINE)
        assert str(got.value) == str(want.value)
    assert "megastep" not in ServingEngine(port, device="cpu",
                                           **ENGINE).stats()


# ------------------------------------------------------- dispatch-ahead
def _ahead_engine(side, model, kv, ahead=True, **kw):
    kw = {**ENGINE, "kv_dtype": kv, "megastep": 4, "clock": lambda: 0.0,
          **kw}
    if ahead:
        kw["dispatch_ahead"] = True
    if side == "jax":
        return JServingEngine(model, **kw)
    return ServingEngine(model, device="cpu", **kw)


def _committed_kv(eng, order):
    """Each active request's committed KV, keyed by its submission index
    (request ids differ between the packages): per layer, the K and V
    rows at positions below the row's length and the scales of the
    blocks holding them (int8), as numpy arrays. A stored speculation's
    writes are left out of the port's pools as its restore would."""
    cache = eng.cache
    bs = cache.block_size
    pools = cache.arrays()
    snap = (eng._ahead or {}).get("undo")
    if isinstance(snap, tdkv.TailSnapshot):
        # the port's pools already hold a stored speculation's writes,
        # which the reference keeps apart until it commits them: read
        # them as the snapshot's restore would leave them
        pools = [tuple(a.clone().index_copy_(0, snap.idx, sv)
                       for a, sv in zip(layer, saved))
                 for layer, saved in zip(pools, snap.saved)]
    out = {}
    for req in list(eng._active.values()):
        slot, n = req.slot, int(cache.lengths[req.slot])
        blocks = [int(b) for b in cache.tables[slot, :-(-n // bs)]]
        layers = []
        for layer in pools:
            arrs = [np.asarray(a.float().numpy() if isinstance(a, torch.Tensor)
                               and a.dtype == torch.bfloat16 else a)
                    for a in layer]
            kv = []
            for a in arrs[:2]:
                rows = a[blocks]                       # [nb, h, bs, d]
                rows = np.swapaxes(rows, 0, 1).reshape(
                    rows.shape[1], -1, rows.shape[3])[:, :n]
                kv.append(np.asarray(rows))
            kv += [np.asarray(a[blocks]) for a in arrs[2:]]
            layers.append(kv)
        out[order[req]] = (n, layers)
    return out


def _lockstep(side, model, kv, ahead, plan, steps=40, **kw):
    """Step one engine, running ``plan[i](eng, side)`` before step ``i``
    (it may submit, cancel, swap or load), and record each step's
    committed KV; returns ``(tokens, hits, misses, whether no
    speculation is left stored, kv per step, stats)``."""
    eng = _ahead_engine(side, model, kv, ahead, **kw)
    reqs, order, trace = [], {}, []
    for i in range(steps):
        if i in plan:
            for r in plan[i](eng, side) or []:
                order[r] = len(reqs)
                reqs.append(r)
        eng.step()
        trace.append(_committed_kv(eng, order))
        if i > max(plan) and eng.idle:
            break
    assert eng.idle and all(r.done for r in reqs)
    st = eng.stats()
    eng.cache.flush_prefix_cache()
    assert eng.cache.allocator.leaked() == 1
    # a speculation dispatched by the last commit stays stored, unconsumed
    return ([r.output_ids for r in reqs], st.get("ahead_hits"),
            st.get("ahead_misses"), eng._ahead is None, trace, st)


def _same_kv(a, b, exact):
    assert len(a) == len(b)
    for sa, sb in zip(a, b):
        assert sorted(sa) == sorted(sb)
        for k in sa:
            (na, la), (nb, lb) = sa[k], sb[k]
            assert na == nb
            for xa, xb in zip(la, lb):
                for u, v in zip(xa, xb):
                    if exact or u.dtype == np.int8:
                        np.testing.assert_array_equal(u, v)
                    else:
                        np.testing.assert_allclose(
                            np.asarray(u, np.float64),
                            np.asarray(v, np.float64), rtol=0, atol=ATOL)


@pytest.mark.parametrize("kv", ["f32", "bf16", "int8"])
def test_dispatch_ahead_hits_and_identity(models, port, kv):
    """The reference's ``test_dispatch_ahead_hits_and_identity``
    (``tests/test_serving_megastep.py:335``) against the JAX engine:
    the same hits and misses, hits on the steady batch, the same tokens,
    and the tokens of megastep 1; no speculation or snapshot left, no
    leak."""
    jm, _ = models
    pt.set_flags({"serving_attn_impl": "xla"})
    prompts = _prompts((4, 6), seed=6)
    out = []
    for side, model in (("jax", jm), ("port", port)):
        eng = _ahead_engine(side, model, kv)
        reqs = [eng.submit(p, max_new_tokens=20) for p in prompts]
        eng.run_until_idle()
        st = eng.stats()
        assert st["megastep"] == 4 and st["dispatch_ahead"] is True
        assert st["ahead_hits"] >= 1, st
        out.append(([r.output_ids for r in reqs], st["ahead_hits"],
                    st["ahead_misses"]))
        eng.cache.flush_prefix_cache()
        assert eng.cache.allocator.leaked() == 1
    assert out[1] == out[0]
    one = ServingEngine(port, kv_dtype=kv, device="cpu", **ENGINE)
    assert out[1][0] == _run(one, [(p, {"max_new_tokens": 20})
                                   for p in prompts])


def _submit(*specs, **kw):
    def act(eng, side):
        return [eng.submit(p, max_new_tokens=m, **kw) for p, m in specs]
    return act


_PA, _PB, _PS1, _PS2 = _prompts((5, 3, 12, 4), seed=12)
PKG = {
    "jax": SimpleNamespace(adapter=jmake_adapter, Tier=JTierManager,
                           Store=JHostBlockStore, dec=jdec,
                           fault_scope=jfault_scope,
                           reset_budget=jreset_budget),
    "port": SimpleNamespace(adapter=make_adapter, Tier=TierManager,
                            Store=HostBlockStore, dec=tdec,
                            fault_scope=tfault_scope,
                            reset_budget=treset_budget),
}


def _new_state(arrays):
    rng = np.random.RandomState(11)
    return {n: (a + 0.05 * rng.randn(*a.shape)).astype(np.float32)
            for n, a in arrays.items()}


def _miss_case(case, arrays):
    """A forced miss: ``(plan, engine keywords of a side, the context a
    side runs in)``. Every plan keeps requests decoding long enough that
    a speculation is in flight when the event comes (before step 2 or
    4): an admission, a cancel, a weight swap, an adapter load, a
    session resumed through a host-tier promotion, a grammar row that
    takes the batch to single steps (a drop, counted by neither
    package), or an injected ``serving.step`` skip, which fires before
    the speculation is taken and leaves it valid."""
    def cancel(eng, side):
        eng.cancel(max(eng._active.values(), key=lambda r: r.slot).id)

    def swap(eng, side):
        eng.swap_weights(_new_state(arrays))

    def load(eng, side):
        eng.load_adapter("acme", PKG[side].adapter(GPTConfig(**GEOM), 2,
                                                   seed=1, scale=0.5))

    def drain(eng, side):
        eng.cache.flush_prefix_cache()

    two = _submit((_PA, 18), (_PB, 18))
    none = lambda side: contextlib.nullcontext()    # noqa: E731
    cases = {
        "admission": ({0: _submit((_PA, 18)), 2: _submit((_PB, 12))},
                      {}, none),
        "cancel": ({0: two, 2: cancel}, {}, none),
        "swap_weights": ({0: two, 2: swap}, {}, none),
        "lora_load": ({0: two, 2: load},
                      {"lora_rank": 2, "lora_max_adapters": 2}, none),
        "promotion": ({0: lambda e, s: (_submit((_PA, 18))(e, s) +
                                        _submit((_PS1, 2),
                                                session="u1")(e, s)),
                       3: drain,
                       4: _submit((_PS2, 4), session="u1")},
                      {"kv_tier": "tier"}, none),
        "grammar": ({0: two, 2: _submit((_PS2, 6), json_mode=True)},
                    {"max_slots": 3, "grammar": "json"},
                    lambda side: jax.enable_x64(False)),
        "skip": ({0: two}, {},
                 lambda side: PKG[side].fault_scope("serving.step:skip@4",
                                                    seed=0)),
    }
    return cases[case]


def _side_kw(side, kw):
    kw = dict(kw)
    pkg = PKG[side]
    if kw.get("kv_tier") == "tier":
        kw["kv_tier"] = pkg.Tier(pkg.Store(GEOM["num_layers"],
                                           GEOM["num_heads"],
                                           GEOM["hidden_size"] //
                                           GEOM["num_heads"],
                                           block_size=ENGINE["block_size"],
                                           num_blocks=64),
                                 demote_idle_ms=0.0)
    if kw.get("grammar") == "json":
        kw["grammar"] = pkg.dec.JsonGrammar(
            pkg.dec.json_token_strings(GEOM["vocab_size"]))
    return kw


def _forced(side, model, kv, ahead, case, arrays):
    plan, kw, scope = _miss_case(case, arrays)
    PKG[side].reset_budget()
    with scope(side):
        return _lockstep(side, model, kv, ahead, plan, **_side_kw(side, kw))


@pytest.mark.parametrize("kv", ["f32", "int8"])
@pytest.mark.parametrize("case", ["admission", "cancel", "swap_weights",
                                  "lora_load", "promotion", "grammar",
                                  "skip"])
def test_dispatch_ahead_forced_miss_matches_jax(models, kv, case):
    """An event between a speculation's dispatch and its take
    (:func:`_miss_case`) is a miss, a drop or, for the skip, a later hit
    in both packages alike: equal hits, misses and tokens, each step's
    committed KV
    (positions below each length; int8 codes equal, scales and float
    rows within the f32 bound) equal to the JAX engine's, and bit-equal
    to the port's own run with dispatch-ahead off, whose writes a
    discarded speculation must not have disturbed."""
    jm, arrays = models
    pt.set_flags({"serving_attn_impl": "xla"})
    try:
        ref = _forced("jax", jm, kv, True, case, arrays)
    finally:
        for n, p in jm.named_parameters():
            p.value = jnp.asarray(arrays[n])
    got = _forced("port", _port(arrays), kv, True, case, arrays)
    off = _forced("port", _port(arrays), kv, False, case, arrays)
    assert got[:4] == ref[:4]
    assert got[0] == off[0] and got[1] >= 1
    assert (got[2] >= 1) == (case not in ("grammar", "skip")), got[1:4]
    st = got[5]
    if case == "promotion":
        assert st["kv_tier"]["migrated_promote_blocks"] > 0
    if case == "grammar":
        assert st["decode_steps"] > 0
    if case == "skip":      # a round of the run produced nothing
        plan, _, _ = _miss_case(case, arrays)
        noskip = _lockstep("port", _port(arrays), kv, True, plan)
        assert len(got[4]) == len(noskip[4]) + 1 and got[1:4] == noskip[1:4]
    if case == "lora_load":
        assert st["lora"]["loaded"] == ["acme"]
    _same_kv(got[4], ref[4], exact=False)
    _same_kv(got[4], off[4], exact=True)


def _oracle(jm, prompts, n):
    from paddle_tpu.models.generation import greedy_search as jgreedy
    return [jgreedy(jm, np.asarray([p]), max_new_tokens=n,
                    cache_len=32)[0].tolist() for p in prompts]


@pytest.mark.parametrize("fleet", ["replicas", "disagg", "start"])
def test_threaded_dispatch_ahead_equals_the_greedy_oracle(models, port,
                                                          fleet):
    """The reference's threaded router tests
    (``tests/test_serving_megastep.py:349,371``) with dispatch-ahead on:
    two replicas stepped from a pool of two threads, a prefill worker and
    a decode worker likewise, and one engine on its own background
    thread (``start``): every request equals JAX's greedy oracle, the
    decode engines hit, and nothing leaks."""
    from paddle_tpu_torch.serving import DisaggRouter, ReplicaRouter
    jm, _ = models
    pt.set_flags({"serving_attn_impl": "xla"})
    prompts = _prompts((3, 7, 5, 9, 4, 6), seed=7)
    kw = dict(max_slots=2, max_len=32, buckets=[8, 16], max_queue=32,
              block_size=4, megastep=4, dispatch_ahead=True, device="cpu")
    if fleet == "replicas":
        rt = ReplicaRouter(port, n_replicas=2, dispatch_threads=2, **kw)
        decode = rt.engines
    elif fleet == "disagg":
        rt = DisaggRouter(port, n_prefill=1, n_decode=1, dispatch_threads=2,
                          **kw)
        decode = rt.engines[1:]
    else:
        rt = ServingEngine(port, **kw)
        decode = [rt]
        rt.start()
    try:
        reqs = [rt.submit(p, max_new_tokens=14) for p in prompts]
        if fleet == "start":
            done = rt.results(reqs, timeout=120)
        else:
            rt.run_until_idle()
            done = reqs
    finally:
        rt.stop()
    assert [r.output_ids for r in done] == _oracle(jm, prompts, 14)
    assert sum(e.stats()["ahead_hits"] for e in decode) >= 1
    for e in decode:
        e.cache.flush_prefix_cache()
        assert e.cache.allocator.leaked() == 1


def _host_blocks(tier, layers):
    """The host store's demoted blocks, keyed by their token chain (keys
    are hashes the packages share; tokens identify a block alike): per
    layer the K and V codes and scales."""
    st = tier.store
    return {tuple(e.tokens): [tuple(np.array(a[li][e.block]) for a in (
        st.k_codes, st.v_codes, st.k_scale, st.v_scale))
        for li in range(layers)] for e in st._chains.values()}


#: a session of 11 prompt tokens and 5 new ones: its last token's
#: position (15) fills its block (block size 4)
_PS3 = _prompts((11,), seed=13)[0]


def _demote_run(side, model, kv, ahead):
    """A session whose last token fills its block (11 prompt tokens, 5
    new, block size 4) finishes in a megastep while a longer request
    keeps decoding, so a speculation dispatched before the finish is
    known holds the row frozen, writing at its length into that block;
    the host tier demotes the session's blocks in the same step."""
    kw = _side_kw(side, {"kv_tier": "tier"})
    tier = kw["kv_tier"]
    plan = {0: lambda e, s: (_submit((_PA, 18))(e, s) +
                             _submit((_PS3, 5), session="u1")(e, s))}
    PKG[side].reset_budget()
    got = _lockstep(side, model, kv, ahead, plan, **kw)
    return got, _host_blocks(tier, GEOM["num_layers"])


@pytest.mark.parametrize("kv", ["f32", "int8"])
def test_dispatch_ahead_demotion_keeps_the_committed_codes(models, kv):
    """ROADMAP C1: the host tier's demotion runs after the step while
    the next megastep is already enqueued. The demoted codes and scales
    of a session's blocks (int8 pools hand theirs over, f32 ones are
    quantized at the copy) are the JAX engine's (codes equal,
    scales within the f32 bound) and the port's own with dispatch-ahead
    off, bit for bit: a pending speculation's write into a demoted block
    is left out of the copy, as the reference demotes the committed
    arrays."""
    jm, arrays = models
    pt.set_flags({"serving_attn_impl": "xla"})
    ref, jhost = _demote_run("jax", jm, kv, True)
    got, thost = _demote_run("port", _port(arrays), kv, True)
    off, ohost = _demote_run("port", _port(arrays), kv, False)
    assert got[:4] == ref[:4] and got[0] == off[0]
    assert got[1] >= 1 and got[5]["kv_tier"]["migrated_demote_blocks"] > 0
    assert sorted(thost) == sorted(jhost) == sorted(ohost) and thost
    for key in jhost:
        for (tk, tv, tks, tvs), (jk, jv, jks, jvs), (ok, ov, oks, ovs) in \
                zip(thost[key], jhost[key], ohost[key]):
            np.testing.assert_array_equal(tk, jk)
            np.testing.assert_array_equal(tv, jv)
            np.testing.assert_allclose(tks, jks, rtol=0, atol=ATOL)
            np.testing.assert_allclose(tvs, jvs, rtol=0, atol=ATOL)
            for a, b in ((tk, ok), (tv, ov), (tks, oks), (tvs, ovs)):
                np.testing.assert_array_equal(a, b)
    _same_kv(got[4], ref[4], exact=False)
