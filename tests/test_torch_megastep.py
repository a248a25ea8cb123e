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

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.models.generation import decode_megastep_paged as jmega
from paddle_tpu.models.gpt import GPTConfig as JGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JGPT
from paddle_tpu.serving import ServingEngine as JServingEngine
from paddle_tpu.serving.decoding import neutral_samp
from paddle_tpu_torch.models import generation as gen
from paddle_tpu_torch.models.convert import gpt_state_from_numpy
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.serving import ServingEngine
from paddle_tpu_torch.serving import decoding as tdec
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
