"""The port's request tracing (``paddle_tpu_torch/observability/
tracing.py``) and the engine's and router's marks against
``paddle_tpu.observability.tracing`` on the CPU. Each scenario runs once
per package on the same weights (carried across by
``gpt_state_from_numpy``), prompts and clock: the exported chrome trace
and spans JSONL are byte-identical (request ids and track names are
normalized at export), ``blame_summary()`` and ``ttft_p95_ms()`` are
equal, and every finished trace keeps the telescoping identity (its
components sum to its latency, their prefix to the first token is the
engine's TTFT), on a plain engine, a seeded load-generator run, a kill
that re-homes requests onto a survivor, and a hedge race with a cancel.
The store itself: outcomes, the finished ring, the id-hash sampling and
``window_snapshots`` equal the reference's. The model is the small GPT
of ``tests/test_tracing.py`` (vocab 97, h 32, 2 layers, 4 heads) drawn
at ``init_std`` 0.2. The JAX side runs with 64-bit types off."""

import torch_threads  # noqa: F401  (one worker's share of the cores)
import json
from types import SimpleNamespace

import jax
import numpy as np
import pytest

import paddle_tpu as pt
from paddle_tpu.models.gpt import GPTConfig as JGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JGPT
from paddle_tpu.observability import tracing as jtracing
from paddle_tpu.serving import ReplicaRouter as JReplicaRouter
from paddle_tpu.serving import ServingEngine as JServingEngine
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch.models.convert import gpt_state_from_numpy
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.observability import tracing as ttracing
from paddle_tpu_torch.serving import ReplicaRouter, ServingEngine
from paddle_tpu_torch.tools import loadgen as tloadgen
from tools import loadgen as jloadgen

GEOM = dict(vocab_size=97, max_position_embeddings=64, hidden_size=32,
            num_layers=2, num_heads=4, ffn_hidden_size=64, init_std=0.2)
SHAPE = dict(max_slots=3, max_len=32, buckets=[8, 16], max_queue=16,
             block_size=4)


@pytest.fixture(autouse=True)
def jax_without_x64():
    with jax.enable_x64(False):
        yield


@pytest.fixture(scope="module")
def pkgs():
    pt.seed(7)
    jm = JGPT(JGPTConfig(**GEOM))
    jm.eval()
    arrays = {n: np.asarray(p.value) for n, p in jm.named_parameters()}
    tm = GPTForCausalLM(GPTConfig(**GEOM), device="cpu")
    tm.load_state_dict(gpt_state_from_numpy(arrays, "cpu"), strict=True)
    tm.eval()
    return (SimpleNamespace(name="jax", model=jm, Engine=JServingEngine,
                            Router=JReplicaRouter, tracing=jtracing,
                            lg=jloadgen, kw={}),
            SimpleNamespace(name="port", model=tm, Engine=ServingEngine,
                            Router=ReplicaRouter, tracing=ttracing,
                            lg=tloadgen, kw={"device": "cpu"}))


class _Clock:
    def __init__(self):
        self.t = 0.0

    def now(self):
        return self.t


def _prompts(sizes, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, 97, size=n).tolist() for n in sizes]


def _identity(tracing, req):
    """The accounting identity on one request's debug payload."""
    info = tracing.get(req.id)
    assert info is not None, req
    assert sum(info["blame_ms"].values()) == \
        pytest.approx(info["e2e_ms"], abs=1e-6), info
    assert set(info["blame_ms"]) <= set(tracing.COMPONENTS), info
    if info["outcome"] == "done":
        assert info["ttft_ms"] == pytest.approx(req.ttft * 1e3, abs=1e-6)
    return info


def _exports(pkg):
    """Everything a trace store exports, normalized by the store."""
    tr = pkg.tracing
    return {"chrome": json.dumps(tr.export_chrome_trace(), sort_keys=True),
            "spans": tr.export_spans_jsonl(),
            "blame": tr.blame_summary(), "ttft_p95": tr.ttft_p95_ms(),
            "windows": tr.store().window_snapshots(
                4, 1.0, slo_ttft_ms=30.0)}


def _both(pkgs, scenario):
    out = []
    for pkg in pkgs:
        pkg.tracing.reset()
        res = scenario(pkg)
        out.append((res, _exports(pkg)))
    assert out[1] == out[0]
    return out[0]


def _drive(target, clk, step_s=0.004):
    while not target.idle:
        target.step()
        clk.t += step_s


def test_plain_engine_traces_like_the_reference(pkgs):
    def run(pkg):
        clk = _Clock()
        eng = pkg.Engine(pkg.model, **SHAPE, clock=clk.now, **pkg.kw)
        reqs = [eng.submit(p, max_new_tokens=4)
                for p in _prompts((3, 5, 7, 4, 6), seed=1)]
        _drive(eng, clk)
        infos = [_identity(pkg.tracing, r) for r in reqs]
        return [([m["kind"] for m in i["marks"]], i["blame_ms"],
                 i["ttft_ms"], i["e2e_ms"], i["outcome"]) for i in infos]

    res, ex = _both(pkgs, run)
    assert all(k[0] == "submit" and k[-1] == "finish" and
               "first_token" in k for k, *_ in res)
    assert ex["blame"]["requests"] == 5
    assert sum(c["share"] for c in ex["blame"]["components"].values()) == \
        pytest.approx(1.0, abs=1e-4)


def test_loadgen_run_exports_the_reference_bytes(pkgs):
    """A seeded virtual-clock run with SLO sheds, deadline sheds and
    priorities: byte-identical exports and equal blame."""
    def run(pkg):
        vc = pkg.lg.VirtualClock()
        eng = pkg.Engine(pkg.model, max_slots=2, max_len=32,
                         buckets=[8, 16], max_queue=4, slo_ttft_ms=60.0,
                         slo_prefill_ms=4.0, slo_tpot_ms=1.5, clock=vc.now,
                         **pkg.kw)
        rep = pkg.lg.LoadGen(mode="bursty", seed=9, rate=60.0,
                             duration=0.6, vocab_size=97,
                             prompt_tokens=(3, 9), new_tokens=(2, 5),
                             priority_mix={0: 0.2, 1: 0.6, 2: 0.2}).run(
            eng, clock=vc, step_cost_ms=4.0)
        for r in eng._all:
            _identity(pkg.tracing, r)
        return rep["decisions"]

    decisions, ex = _both(pkgs, run)
    assert any(d[0] == "shed" for d in decisions)
    assert ex["blame"]["tail_dominant"] in ttracing.COMPONENTS


def test_kill_rehome_stitches_one_trace_like_the_reference(pkgs):
    def run(pkg):
        clk = _Clock()
        rt = pkg.Router(pkg.model, n_replicas=2, **SHAPE, clock=clk.now,
                        **pkg.kw)
        reqs = [rt.engines[0].submit(p, max_new_tokens=4)
                for p in _prompts((3, 5, 7), seed=2)]
        for _ in range(2):
            rt.engines[0].step()
            clk.t += 0.004
        rt.kill_replica(0)
        clk.t += 0.004
        _drive(rt, clk)
        out = []
        for r in reqs:
            info = _identity(pkg.tracing, r)
            out.append(([m["kind"] for m in info["marks"]],
                        info["blame_ms"]))
        return out

    res, _ = _both(pkgs, run)
    for kinds, blame in res:
        assert "kill" in kinds and "resume" in kinds
        assert blame["rehome"] > 0.0


def test_cancel_and_hedge_marks_like_the_reference(pkgs):
    """A hedge that fires and wins, and a cancel: their marks annotate
    the timelines without changing the blame identity."""
    def run(pkg):
        clk = _Clock()
        rt = pkg.Router(pkg.model, n_replicas=2, **SHAPE, clock=clk.now,
                        hedge_ms=5.0, **pkg.kw)
        slow = rt.engines[0]
        slow._prefill_ms_pin = 500.0
        orig, n = slow.step, {"k": 0}

        def lazy():
            n["k"] += 1
            return False if n["k"] <= 6 else orig()
        slow.step = lazy
        hedged = rt.submit(_prompts((4,), seed=3)[0], max_new_tokens=4)
        doomed = rt.engines[1].submit(_prompts((5,), seed=4)[0],
                                      max_new_tokens=8)
        clk.t += 0.01
        rt.step()
        clk.t += 0.004
        rt.cancel(doomed.id)
        _drive(rt, clk)
        return [[m["kind"] for m in pkg.tracing.get(r.id)["marks"]]
                for r in (hedged, doomed)]

    (hedged, doomed), _ = _both(pkgs, run)
    assert "hedge" in hedged and doomed[-2:] == ["cancel", "finish"]


def test_store_like_the_reference():
    """Outcomes, the finished ring and its eviction, the id-hash
    sampling and the burn-rate windows, on both stores."""
    def drive(mod):
        st = mod.TraceStore()
        out = [st.begin(5, 0.0, "engine0"), st.get(5)["outcome"]]
        st.finish(5, 1.0, "engine0", "shed", reason="queue_full")
        out += [st.get(5), st.blame_summary()]
        for i in range(6):
            st.begin(100 + i, 0.1 * i, "engine3")
            st.mark(100 + i, "admit", 0.1 * i + 0.01, "engine3")
            st.mark(100 + i, "first_token", 0.1 * i + 0.02 * (i + 1),
                    "engine3")
            st.finish(100 + i, 0.1 * i + 0.2, "engine3", "done")
        out += [st.blame_summary(), st.ttft_p95_ms(),
                st.window_snapshots(3, 0.6, slo_ttft_ms=60.0),
                st.export_spans_jsonl()]
        out.append([st.sampled(i, f) for f in (0.0, 0.3, 0.5, 1.0)
                    for i in range(400)])
        return out

    assert drive(ttracing) == drive(jtracing)
    st = ttracing.TraceStore()
    saved = tflags.get_flags(["serving_trace_keep"])
    tflags.set_flags({"serving_trace_keep": 2})
    try:
        for i in range(4):
            st.begin(i, 0.0, "engine0")
            st.finish(i, 1.0, "engine0", "done")
    finally:
        tflags.set_flags(saved)
    assert st.get(0) is None and st.get(3) is not None and st.dropped == 2
    assert st.discard(3) and st.get(3) is None and not st.discard(3)


def test_sampling_off_means_no_trace(pkgs):
    _, port = pkgs
    ttracing.reset()
    saved = tflags.get_flags(["serving_trace"])
    tflags.set_flags({"serving_trace": 0.0})
    try:
        eng = ServingEngine(port.model, **SHAPE, device="cpu")
        r = eng.submit(_prompts((4,))[0], max_new_tokens=2)
        eng.run_until_idle()
    finally:
        tflags.set_flags(saved)
    assert r.state == "done" and ttracing.get(r.id) is None
    assert ttracing.blame_summary()["requests"] == 0
