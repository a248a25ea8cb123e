"""JSON-constrained decoding in the port (``paddle_tpu_torch/serving/
decoding.py``'s grammar, the engine's mask rows and its single-step
fallback, both routers and HTTP) against the JAX package on the CPU.

- the reference's ``test_json_mode_valid_by_construction`` and
  ``test_json_mode_rejections`` (``tests/test_serving_decoding.py:186,
  199``) against the port;
- seeded cursor walks at every budget: ``allowed_chars`` equal and
  ``mask_row`` bit-equal to the reference's at every position, and the
  document accepted when the budget runs out;
- ``sample_first``'s mask row: the same first token and key;
- ``json_mode`` completions token-equal to the JAX engine's, greedy and
  sampled, mixed with plain requests, at megastep 1 and 8, through a
  ``ReplicaRouter``, a 1 x 2 ``DisaggRouter`` (the cursor crosses the
  handoff, and a ``kill_decode_worker`` re-homes it mid-request) and
  HTTP; every completion passes ``json.loads``;
- the port's mask rows: a greedy constrained row replays the sampled
  graph, and a row a constrained request left is zeroed before the next
  replay reads the mask.

The reference's grammar admits numbers with leading zeros (``00``,
``-01.5``), which ``json.loads`` refuses; the port keeps the reference's
grammar, so a completion holding one fails ``json.loads`` in both
packages alike (ROADMAP C, faults of the reference the port reproduces;
``test_both_grammars_admit_leading_zeros``). Every other completion
must pass ``json.loads`` as it is, and one holding leading zeros must
pass it once they are dropped (``_valid``).

The reference's two tests run on its own model (the small GPT of
``tests/test_serving_decoding.py``, vocab 97, default ``init_std``);
the rest on the same GPT drawn at ``init_std`` 0.2, whose tokens vary
more. The JAX side runs with 64-bit types off."""

import torch_threads  # noqa: F401  (one worker's share of the cores)
import json
import re
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import monitor as jmonitor
from paddle_tpu.models.gpt import GPTConfig as JGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JGPT
from paddle_tpu.observability import tracing as jtracing
from paddle_tpu.serving import DisaggRouter as JDisaggRouter
from paddle_tpu.serving import ReplicaRouter as JReplicaRouter
from paddle_tpu.serving import ServingEngine as JServingEngine
from paddle_tpu.serving import ServingHTTPServer as JServer
from paddle_tpu.serving import decoding as jd
from paddle_tpu_torch import monitor as tmonitor
from paddle_tpu_torch.models.convert import gpt_state_from_numpy
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.observability import tracing as ttracing
from paddle_tpu_torch.serving import (DisaggRouter, ReplicaRouter,
                                      ServingEngine, ServingHTTPServer)
from paddle_tpu_torch.serving import decoding as td

VOCAB = 97
GEOM = dict(vocab_size=VOCAB, max_position_embeddings=64, hidden_size=32,
            num_layers=2, num_heads=4, ffn_hidden_size=64, init_std=0.2)
SHAPE = dict(max_slots=2, max_len=32, buckets=[8, 16], max_queue=16,
             block_size=4)
SAMPLED = dict(temperature=0.8, top_k=8, top_p=0.95)


@pytest.fixture(autouse=True)
def jax_without_x64():
    with jax.enable_x64(False):
        yield


def _pair(geom):
    pt.seed(7)
    jm = JGPT(JGPTConfig(**geom))
    jm.eval()
    arrays = {n: np.asarray(p.value) for n, p in jm.named_parameters()}
    tm = GPTForCausalLM(GPTConfig(**geom), device="cpu")
    tm.load_state_dict(gpt_state_from_numpy(arrays, "cpu"), strict=True)
    tm.eval()
    return (SimpleNamespace(
                name="jax", model=jm, Engine=JServingEngine,
                Router=JReplicaRouter, Disagg=JDisaggRouter, Server=JServer,
                dec=jd, monitor=jmonitor, tracing=jtracing,
                grammar=jd.JsonGrammar(jd.json_token_strings(VOCAB)), kw={}),
            SimpleNamespace(
                name="port", model=tm, Engine=ServingEngine,
                Router=ReplicaRouter, Disagg=DisaggRouter,
                Server=ServingHTTPServer, dec=td, monitor=tmonitor,
                tracing=ttracing,
                grammar=td.JsonGrammar(td.json_token_strings(VOCAB)),
                kw={"device": "cpu"}))


@pytest.fixture(scope="module")
def pkgs():
    return _pair(GEOM)


@pytest.fixture(scope="module")
def ref_pkgs():
    """The reference test's model: ``init_std`` at its default."""
    return _pair({k: v for k, v in GEOM.items() if k != "init_std"})


def _prompts(sizes, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, VOCAB, size=n).tolist() for n in sizes]


def _engine(pkg, **kw):
    return pkg.Engine(pkg.model, **{**SHAPE, "clock": lambda: 0.0, **kw},
                      **pkg.kw)


def _both(pkgs, run):
    out = [run(pkg) for pkg in pkgs]
    assert out[1] == out[0]
    return out[0]


_LEADING_ZEROS = re.compile(r"(?<![0-9.])(-?)0+(?=[0-9])")


def _json_ok(text):
    """``text`` is JSON: as it is, or, when it holds a number with
    leading zeros (the reference grammar's fault), once they are
    dropped."""
    try:
        json.loads(text)
    except json.JSONDecodeError:
        assert _LEADING_ZEROS.search(text), text
        json.loads(_LEADING_ZEROS.sub(r"\1", text))


def _valid(grammar, reqs):
    for r in reqs:
        assert r.state == "done", (r.state, r.error)
        _json_ok(grammar.decode(r.tokens))


# ------------------------------------------------ the reference's tests
def test_json_mode_valid_by_construction(ref_pkgs):
    """The reference's test, on its model, in both packages: the same
    completions, each passing ``json.loads``."""
    def run(pkg):
        grammar = pkg.grammar
        eng = pkg.Engine(pkg.model, max_slots=2, max_len=32, buckets=[8, 16],
                         max_queue=16, block_size=4, grammar=grammar,
                         **pkg.kw)
        greedy = eng.submit(_prompts((4,))[0], max_new_tokens=8,
                            json_mode=True)
        sampled = eng.submit(_prompts((5,))[0], max_new_tokens=8,
                             json_mode=True, seed=4, **SAMPLED)
        eng.run_until_idle()
        for r in (greedy, sampled):
            assert r.state == "done", (r.state, r.error)
            json.loads(grammar.decode(r.tokens))   # or it isn't JSON
        return [greedy.tokens, sampled.tokens], eng.stats()["json_grammar"]

    assert _both(ref_pkgs, run)[1] is True


def test_both_grammars_admit_leading_zeros():
    """The reference grammar's fault, reproduced: after a leading ``0``
    (or ``-0``) it allows more digits, so ``00`` and ``-01.5`` are
    accepted documents that ``json.loads`` refuses."""
    for mod in (jd, td):
        g = mod.JsonGrammar(mod.json_token_strings(VOCAB))
        for text in ("00", "-01.5", "[007]"):
            cur = g.start()
            for ch in text:
                assert ch in cur.allowed_chars(len(text) + 1)
                cur.advance(int(g._char_ids[ch][0]))
            if text[0] == "[":
                assert cur.at_end
            else:
                assert cur.accepting
            with pytest.raises(json.JSONDecodeError):
                json.loads(text)


def test_json_mode_rejections(pkgs):
    def run(pkg):
        out = []
        eng = _engine(pkg)   # no grammar
        with pytest.raises(ValueError, match="grammar") as e:
            eng.submit([1, 2, 3], json_mode=True)
        out.append(str(e.value))
        spec = _engine(pkg, spec_tokens=2, grammar=pkg.grammar)
        with pytest.raises(ValueError, match="spec") as e:
            spec.submit([1, 2, 3], json_mode=True)
        out.append(str(e.value))
        with pytest.raises(ValueError, match="vocab") as e:
            _engine(pkg, grammar=pkg.dec.JsonGrammar(
                pkg.dec.json_token_strings(VOCAB + 1)))
        out.append(str(e.value))
        return out

    msgs = _both(pkgs, run)
    assert "grammar" in msgs[0] and "speculative" in msgs[1]


def test_grammar_tables_and_errors_equal_the_reference():
    assert td.json_token_strings(VOCAB) == jd.json_token_strings(VOCAB)
    for mod in (jd, td):
        with pytest.raises(ValueError, match="cannot cover"):
            mod.json_token_strings(20)
        with pytest.raises(ValueError, match="cannot express"):
            mod.JsonGrammar([""] + list("{}[]"))
    t = td.JsonGrammar(td.json_token_strings(VOCAB))
    j = jd.JsonGrammar(jd.json_token_strings(VOCAB))
    assert {c: a.tolist() for c, a in t._char_ids.items()} == \
        {c: a.tolist() for c, a in j._char_ids.items()}
    ids = [1, 7, 20, 5, 3]
    assert t.decode(ids) == j.decode(ids)


# ------------------------------------------------------ cursor walks
@pytest.mark.parametrize("budget", range(1, 17))
def test_cursor_walks_match_the_reference(budget):
    """A seeded walk (three seeds per budget) that takes a random legal
    char, then a random token of it, at every step: the port's cursor
    allows the same chars and gives a bit-equal mask row at every
    position, tracks ``accepting`` / ``at_end`` alike, and lands on a
    complete document when the budget runs out."""
    tg = td.JsonGrammar(td.json_token_strings(VOCAB))
    jg = jd.JsonGrammar(jd.json_token_strings(VOCAB))
    for seed in range(3):
        rng = np.random.RandomState(1000 * budget + seed)
        tc, jc = tg.start(), jg.start()
        toks = []
        buf = np.empty(VOCAB, np.float32)
        for remaining in range(budget, 0, -1):
            allowed = tc.allowed_chars(remaining)
            assert allowed == jc.allowed_chars(remaining)
            row = tc.mask_row(remaining)
            ref = jc.mask_row(remaining)
            assert row.dtype == ref.dtype == np.float32
            assert row.tobytes() == ref.tobytes()
            assert tc.mask_row(remaining, out=buf) is buf
            assert buf.tobytes() == ref.tobytes()
            ch = allowed[rng.randint(len(allowed))]
            tid = int(rng.choice(tg._char_ids[ch]))
            tc.advance(tid)
            jc.advance(tid)
            toks.append(tid)
            assert (tc.accepting, tc.at_end) == (jc.accepting, jc.at_end)
            if tc.at_end:
                break
        assert tc.accepting
        _json_ok(tg.decode(toks))
        with pytest.raises(ValueError, match="not a grammar char"):
            tc.advance(0)


def test_sample_first_mask_row_matches_the_reference():
    tg = td.JsonGrammar(td.json_token_strings(VOCAB))
    rng = np.random.RandomState(2)
    for params in (td.DecodeParams(json_mode=True),
                   td.DecodeParams(json_mode=True, seed=9, **SAMPLED)):
        jparams = jd.DecodeParams(**params.__dict__)
        for _ in range(4):
            row = rng.randn(VOCAB).astype(np.float32) * 3
            mask = tg.start().mask_row(5)
            key = td.request_key(params.seed)
            t = td.sample_first(torch.from_numpy(row), params, key, mask)
            j = jd.sample_first(row, jparams, key, mask)
            assert t[0] == j[0] and t[1].tolist() == j[1].tolist()
            assert mask[t[0]] == 0.0      # a legal first char


# ---------------------------------------------------------- the engine
@pytest.mark.parametrize("megastep", [1, 8])
def test_json_mode_engine_matches_the_reference(pkgs, megastep):
    """Greedy and sampled constrained requests beside plain ones, in one
    batch: token-equal to the JAX engine, valid JSON. At megastep 8 the
    batch falls back to single steps while a cursor is active."""
    prompts = _prompts((4, 6, 3, 5), seed=3)

    def run(pkg):
        eng = _engine(pkg, grammar=pkg.grammar, megastep=megastep,
                      max_slots=4)
        reqs = [eng.submit(prompts[0], max_new_tokens=10, json_mode=True),
                eng.submit(prompts[1], max_new_tokens=12, json_mode=True,
                           seed=5, **SAMPLED),
                eng.submit(prompts[2], max_new_tokens=4),
                eng.submit(prompts[3], max_new_tokens=4, seed=6, **SAMPLED)]
        eng.run_until_idle()
        _valid(pkg.grammar, reqs[:2])
        if pkg.name == "port" and megastep > 1:
            assert eng.decode_steps > 0
        return [r.output_ids for r in reqs], eng.stats()["json_grammar"]

    outs, flag = _both(pkgs, run)
    assert flag is True


def test_json_mode_through_the_replica_router(pkgs):
    prompts = _prompts((3, 5, 7, 4), seed=8)

    def run(pkg):
        rt = pkg.Router(pkg.model, n_replicas=2, grammar=pkg.grammar,
                        **{**SHAPE, "clock": lambda: 0.0}, **pkg.kw)
        reqs = [rt.submit(p, max_new_tokens=9, json_mode=True,
                          **(dict(seed=i, **SAMPLED) if i % 2 else {}))
                for i, p in enumerate(prompts)]
        rt.run_until_idle()
        _valid(pkg.grammar, reqs)
        return [r.output_ids for r in reqs]

    _both(pkgs, run)


@pytest.mark.parametrize("kill", [False, True], ids=["handoff", "rehome"])
def test_json_mode_through_the_disaggregated_fleet(pkgs, kill):
    """The cursor lives on the request, so it crosses the handoff; a
    decode worker killed mid-request re-homes it and it continues
    token-equal."""
    prompts = _prompts((3, 7), seed=40)

    def run(pkg):
        rt = pkg.Disagg(pkg.model, n_prefill=1, n_decode=2,
                        grammar=pkg.grammar, prefix_cache=False,
                        **{**SHAPE, "clock": lambda: 0.0}, **pkg.kw)
        reqs = [rt.submit(prompts[0], max_new_tokens=10, json_mode=True),
                rt.submit(prompts[1], max_new_tokens=10, json_mode=True,
                          seed=3, **SAMPLED)]
        info = None
        if kill:
            rt.step()
            rt.step()
            info = rt.kill_decode_worker(0)
        rt.run_until_idle()
        _valid(pkg.grammar, reqs)
        return [r.output_ids for r in reqs], info, \
            [r.rehomed for r in reqs]

    outs, info, rehomed = _both(pkgs, run)
    if kill:
        assert info["rehomed"] >= 1 and any(rehomed)


def test_json_mode_over_http(pkgs):
    from test_torch_http import _served

    prompts = _prompts((4, 6), seed=12)

    def run(pkg):
        def script(c, target):
            return [c("POST", "/v1/generate",
                      {"ids": prompts[0], "max_new_tokens": 8,
                       "json_mode": True}),
                    c("POST", "/v1/generate",
                      {"ids": prompts[1], "max_new_tokens": 8,
                       "json_mode": True, "seed": 2, **SAMPLED})]

        _, out = _served(pkg, _engine(pkg, grammar=pkg.grammar), script)
        for (status, body), prompt in zip(out, prompts):
            assert status == 200 and body["state"] == "done"
            _json_ok(pkg.grammar.decode(body["output_ids"][len(prompt):]))
        return [body["output_ids"] for _, body in out]

    _both(pkgs, run)


# ------------------------------------------------- the port's mask rows
def test_greedy_constrained_row_replays_the_sampled_graph(pkgs):
    """A greedy constrained row needs ``argmax(logits + mask)``, which
    only the sampled graph computes: a batch of greedy constrained rows
    runs it, never the greedy graph."""
    from paddle_tpu_torch.models import generation as gen

    _, port = pkgs
    model = GPTForCausalLM(GPTConfig(**GEOM), device="cpu")
    model.load_state_dict(port.model.state_dict())
    eng = ServingEngine(model.eval(), grammar=port.grammar, device="cpu",
                        **SHAPE)
    eng.submit([1, 2, 3], max_new_tokens=6, json_mode=True)
    eng.run_until_idle()
    graphs = gen.decode_step_paged(model, kv_dtype="f32",
                                   attn_impl="kernel")["graphs"]
    assert graphs["sampled"].signatures and not graphs["greedy"].signatures


def test_mask_rows_are_zeroed_when_their_request_leaves(pkgs):
    _, port = pkgs
    eng = _engine(port, grammar=port.grammar, max_slots=3)
    plain = eng.submit([5, 6, 7], max_new_tokens=12, seed=1, **SAMPLED)
    short = eng.submit([1, 2, 3], max_new_tokens=4, json_mode=True)
    gone = eng.submit([4, 2, 3], max_new_tokens=12, json_mode=True)
    eng.step()
    assert eng._mask_rows == {short.slot, gone.slot}
    assert bool((eng._mask[gone.slot] != 0).any())
    eng.cancel(gone.id)
    while short.state != "done":
        eng.step()
    eng.step()                      # a sampled replay after both left
    assert plain.state == "running" and eng._mask_rows == set()
    assert float(eng._mask.abs().sum()) == 0.0
    eng.run_until_idle()
    json.loads(port.grammar.decode(short.tokens))
