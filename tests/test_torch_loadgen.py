"""The port's load generator (``paddle_tpu_torch/tools/loadgen.py``)
against the reference's (``tools/loadgen.py``) on the CPU: the same seed
gives the same ``trace_bytes()`` in every mode, and on a virtual clock
with pinned predictor costs the same seeded run drives the JAX engine
and the port's (weights carried across by ``gpt_state_from_numpy``) to
the same decisions, shed counts by reason, completions, tokens and
virtual-clock TTFTs, compared as equal floats: the depth-only against
the SLO-aware pair of ``tests/test_loadgen.py``, a chaos run under
``fault_scope``, closed-loop clients that abandon, a chaos schedule of
kills and restarts, an autoscaling router, and a disaggregated fleet
(co-located and across pools, under its ``kill_prefill`` and
``kill_decode`` chaos kinds, and through each CLI's ``--disagg``), whose
report's ``disagg`` section must be equal too. The model is the small
GPT of ``tests/test_loadgen.py`` (vocab 97, h 32, 2 layers, 4 heads)
drawn at ``init_std`` 0.2, so its greedy tokens vary. The JAX side runs
with 64-bit types off."""

import torch_threads  # noqa: F401  (one worker's share of the cores)
import json
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
from paddle_tpu.resilience import fault_scope as jfault_scope
from paddle_tpu.resilience import reset_default_budget as jreset_budget
from paddle_tpu.serving import AutoscalePolicy as JAutoscalePolicy
from paddle_tpu.serving import DisaggRouter as JDisaggRouter
from paddle_tpu.serving import ReplicaRouter as JReplicaRouter
from paddle_tpu.serving import ServingEngine as JServingEngine
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch import monitor as tmonitor
from paddle_tpu_torch.models.convert import gpt_state_from_numpy
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.observability import tracing as ttracing
from paddle_tpu_torch.resilience import fault_scope as tfault_scope
from paddle_tpu_torch.resilience import reset_default_budget as treset_budget
from paddle_tpu_torch.serving import (AutoscalePolicy, DisaggRouter,
                                      ReplicaRouter, ServingEngine)
from paddle_tpu_torch.tools import loadgen as tloadgen
from tools import loadgen as jloadgen

GEOM = dict(vocab_size=97, max_position_embeddings=64, hidden_size=32,
            num_layers=2, num_heads=4, ffn_hidden_size=64, init_std=0.2)
LG_KW = dict(rate=30.0, duration=0.6, vocab_size=97, prompt_tokens=(3, 9),
             new_tokens=(2, 5), priority_mix={0: 0.2, 1: 0.6, 2: 0.2})
ENGINE = dict(max_slots=2, max_len=32, buckets=[8, 16], max_queue=4,
              slo_ttft_ms=60.0, slo_prefill_ms=4.0, slo_tpot_ms=1.5)


@pytest.fixture(autouse=True)
def jax_without_x64():
    with jax.enable_x64(False):
        yield


@pytest.fixture(scope="module")
def pkgs():
    pt.seed(13)
    jm = JGPT(JGPTConfig(**GEOM))
    jm.eval()
    arrays = {n: np.asarray(p.value) for n, p in jm.named_parameters()}
    tm = GPTForCausalLM(GPTConfig(**GEOM), device="cpu")
    tm.load_state_dict(gpt_state_from_numpy(arrays, "cpu"), strict=True)
    tm.eval()
    jax_side = SimpleNamespace(
        name="jax", model=jm, Engine=JServingEngine, Router=JReplicaRouter,
        Disagg=JDisaggRouter, Policy=JAutoscalePolicy, lg=jloadgen, fault_scope=jfault_scope,
        tracing=jtracing, monitor=jmonitor, reset_budget=jreset_budget,
        kw={})
    port = SimpleNamespace(
        name="port", model=tm, Engine=ServingEngine, Router=ReplicaRouter,
        Disagg=DisaggRouter, Policy=AutoscalePolicy, lg=tloadgen, fault_scope=tfault_scope,
        tracing=ttracing, monitor=tmonitor, reset_budget=treset_budget,
        kw={"device": "cpu"})
    return jax_side, port


def _engine(pkg, clock, **kw):
    return pkg.Engine(pkg.model, **{**ENGINE, **kw}, clock=clock, **pkg.kw)


def _both(pkgs, scenario):
    """``scenario(pkg)`` once per package from reset monitors, retry
    budgets and trace stores; what it observes must be equal."""
    out = []
    for pkg in pkgs:
        pkg.monitor.reset()
        pkg.reset_budget()
        pkg.tracing.reset()
        out.append(scenario(pkg))
    assert out[1] == out[0]
    return out[0]


def _observe(report, engines):
    """A run's observable outcome: the report without its wall-free
    keys' formatting aside, and every request's state, reason, tokens
    and virtual-clock TTFT (exact floats), in submission order."""
    reqs = sorted({r.id: r for e in engines for r in e._all}.values(),
                  key=lambda r: r.id)
    return {"report": report,
            "requests": [(r.state, r.shed_reason, list(r.tokens), r.ttft,
                          r.deadline_met) for r in reqs]}


@pytest.mark.parametrize("seed", [5, 42])
@pytest.mark.parametrize("mode", ["poisson", "bursty", "diurnal"])
def test_trace_bytes_equal_the_reference(mode, seed):
    a = tloadgen.LoadGen(mode=mode, seed=seed, **LG_KW)
    b = jloadgen.LoadGen(mode=mode, seed=seed, **LG_KW)
    assert a.trace_bytes() == b.trace_bytes()
    assert [tuple(x) for x in a.schedule()] == \
        [tuple(x) for x in b.schedule()]
    rt = tloadgen.LoadGen.from_trace(json.loads(b.trace_bytes()))
    assert rt.trace_bytes() == b.trace_bytes()
    mixed = dict(LG_KW, closed_loop=2, think_time_ms=(2.0, 8.0),
                 abandon_frac=0.3, sample_frac=0.5)
    assert tloadgen.LoadGen(mode=mode, seed=seed, **mixed).trace_bytes() \
        == jloadgen.LoadGen(mode=mode, seed=seed, **mixed).trace_bytes()


@pytest.mark.parametrize("mode", ["poisson", "bursty", "diurnal"])
def test_same_decisions_as_the_reference(pkgs, mode):
    def run(pkg):
        vc = pkg.lg.VirtualClock()
        eng = _engine(pkg, vc.now)
        rep = pkg.lg.LoadGen(mode=mode, seed=5, **LG_KW).run(
            eng, clock=vc, step_cost_ms=4.0)
        return _observe(rep, [eng])

    out = _both(pkgs, run)
    assert out["report"]["offered"] > 0
    assert out["report"]["exceptions"] == 0
    assert out["report"]["leaked_kv_blocks"] == 0


def test_slo_admission_against_depth_only_like_the_reference(pkgs):
    """``tests/test_loadgen.py``'s pair over capacity: both packages'
    depth-only and SLO-aware runs equal, and SLO-aware admission buys
    at least 1.2x the goodput."""
    lg_kw = dict(LG_KW, rate=80.0, duration=0.6)

    def run(pkg):
        out = {}
        for name, slo in (("depth_only", 0.0), ("slo_aware", 40.0)):
            vc = pkg.lg.VirtualClock()
            eng = _engine(pkg, vc.now, slo_ttft_ms=slo, max_queue=32)
            rep = pkg.lg.LoadGen(mode="bursty", seed=9, **lg_kw).run(
                eng, clock=vc, step_cost_ms=4.0, slo_ttft_ms=40.0)
            out[name] = _observe(rep, [eng])
        return out

    out = _both(pkgs, run)
    base = out["depth_only"]["report"]["goodput_per_s"]
    aware = out["slo_aware"]["report"]["goodput_per_s"]
    assert base is not None and aware >= 1.2 * base, (base, aware)
    assert out["slo_aware"]["report"]["shed"].get("slo", 0) > 0


def test_chaos_run_like_the_reference(pkgs):
    """Submit and allocation faults: the same sheds, the same survivors,
    every request accounted for, nothing leaked."""
    def run(pkg):
        vc = pkg.lg.VirtualClock()
        with pkg.fault_scope("serving.submit:skip@0.25;"
                             "serving.alloc:skip@0.15", seed=2):
            eng = _engine(pkg, vc.now)
            rep = pkg.lg.LoadGen(mode="poisson", seed=11, **LG_KW).run(
                eng, clock=vc, step_cost_ms=4.0)
        return _observe(rep, [eng])

    rep = _both(pkgs, run)["report"]
    assert rep["shed"].get("fault", 0) > 0 and rep["exceptions"] == 0
    assert rep["completed"] + rep["shed_total"] + sum(
        1 for d in rep["decisions"] if d[0] == "invalid") == rep["offered"]


def test_closed_loop_abandonment_like_the_reference(pkgs):
    """Closed-loop clients that hang up mid-decode: the same cancels
    (reason "disconnect"), decisions and tokens, no leaked block."""
    def run(pkg):
        vc = pkg.lg.VirtualClock()
        eng = _engine(pkg, vc.now, max_queue=8)
        rep = pkg.lg.LoadGen(mode="poisson", seed=1, closed_loop=4,
                             think_time_ms=(2.0, 8.0), abandon_frac=0.2,
                             **LG_KW).run(eng, clock=vc, step_cost_ms=4.0)
        return _observe(rep, [eng])

    rep = _both(pkgs, run)["report"]
    assert rep["abandoned"] >= 1
    assert rep["canceled"] == {"disconnect": rep["abandoned"]}
    assert rep["leaked_kv_blocks"] == 0


def test_chaos_schedule_on_a_router_like_the_reference(pkgs):
    """A restart and a kill fired on the virtual clock through a warmed
    2-replica router: the same decisions, re-homes and tokens."""
    def run(pkg):
        vc = pkg.lg.VirtualClock()
        rt = pkg.Router(pkg.model, n_replicas=2, max_slots=2, max_len=32,
                        buckets=[8, 16], max_queue=16, block_size=4,
                        clock=vc.now, **pkg.kw)
        pkg.lg.warmup(rt)
        lg = pkg.lg.LoadGen(mode="poisson", seed=42, **LG_KW)
        lg.chaos = [{"t": 0.2, "kind": "restart", "index": 0},
                    {"t": 0.4, "kind": "kill", "index": 1}]
        rep = lg.run(rt, clock=vc, step_cost_ms=4.0)
        st = rt.stats()
        return {**_observe(rep, rt.engines + rt._retiring),
                "kills": st["kills"], "restarts": st["restarts"]}

    out = _both(pkgs, run)
    rep = out["report"]
    assert rep["chaos_applied"] == 2 and out["kills"] == 2
    assert rep["completed"] + rep["rehomed"] + rep["shed_total"] == \
        rep["offered"]
    assert rep["leaked_kv_blocks"] == 0 and rep["exceptions"] == 0


def test_autoscaling_router_like_the_reference(pkgs):
    """Bursty load over an autoscaling SLO fleet (warmed): the same
    scale-ups and -downs, decisions and tokens."""
    def run(pkg):
        vc = pkg.lg.VirtualClock()
        policy = pkg.Policy(min_replicas=1, max_replicas=3,
                            queue_high=1.5, queue_low=0.5,
                            cooldown_steps=2)
        rt = pkg.Router(pkg.model, n_replicas=1, autoscale=policy,
                        **{**ENGINE, "max_queue": 8}, clock=vc.now,
                        **pkg.kw)
        pkg.lg.warmup(rt)
        rep = pkg.lg.LoadGen(mode="bursty", seed=3,
                             **dict(LG_KW, rate=120.0)).run(
            rt, clock=vc, step_cost_ms=4.0)
        st = rt.stats()
        return {**_observe(rep, rt.engines + rt._retiring),
                "autoscale": st["autoscale"], "replicas": st["replicas"]}

    out = _both(pkgs, run)
    assert out["autoscale"]["scale_ups"] >= 2
    assert out["autoscale"]["scale_downs"] >= 1


def test_warmup_warms_every_replica_and_leaves_no_record(pkgs):
    """The port's warm-up gives every replica each bucket's prefill and
    the decode step; the requests beyond the reference's leave the
    books, the trace store and the costs as the reference's warm-up
    leaves them."""
    _, port = pkgs
    rt = ReplicaRouter(port.model, n_replicas=3, max_slots=2, max_len=32,
                       buckets=[8, 16], max_queue=8, slo_ttft_ms=50.0,
                       slo_prefill_ms=1.0, slo_tpot_ms=1.0,
                       clock=lambda: 0.0, device="cpu")
    ttracing.reset()
    seen = []
    for eng in rt.engines:
        def spy(bucket, *a, _orig=eng._prefill_group_attempt_paged, _e=eng,
                **k):
            seen.append((_e, bucket))
            return _orig(bucket, *a, **k)
        eng._prefill_group_attempt_paged = spy
    tloadgen.warmup(rt)
    assert {(id(e), b) for e, b in seen} == \
        {(id(e), b) for e in rt.engines for b in e.buckets}
    assert sum(len(e._all) for e in rt.engines) == len(rt.engines[0].buckets)
    assert sum(e.stats()["completed"] for e in rt.engines) == 3
    assert len(ttracing.store().finished()) == 3
    for eng in rt.engines:
        assert eng.decode_steps >= 1
        assert eng._prefill_ewma == {} and eng._tpot_ewma is None
        st = eng.stats()
        assert eng.idle and st["completed"] == 1
        assert st["slo_attainment"] == 1.0 and st["shed"] == {}


def test_refuses_what_is_not_ported(tmp_path, capsys):
    """The CLI's devprof and ledger options, refused until the device-cost
    observatory was ported, now run: ``--devprof --devprof-sample 1``
    samples every dispatch (zero-width on the virtual clock, so no device
    fraction) and ``--ledger`` appends the report's row, which passes
    ``perf_regress`` against a baseline written from itself;
    ``--devprof-sample`` alone fails as the reference's does. (Tenant
    mixes and returning users run: tests/test_torch_lora.py and
    tests/test_torch_kv_tier.py; the disaggregated fleet's chaos kinds
    and the CLI's ``--disagg``: the parity tests below.)"""
    from paddle_tpu_torch import observability as tobs
    from paddle_tpu_torch.tools import perf_ledger, perf_regress

    ledger, base = tmp_path / "ledger.jsonl", tmp_path / "base.json"
    try:
        rc = tloadgen.main([
            "--device", "cpu", "--model", "gpt2-tiny", "--mode", "bursty",
            "--rate", "12", "--duration", "0.5", "--slots", "2",
            "--max-len", "32", "--buckets", "8,16", "--prompt-tokens",
            "4:9", "--new-tokens", "2:4", "--slo-ttft-ms", "200",
            "--slo-prefill-ms", "4", "--slo-tpot-ms", "1",
            "--virtual-step-ms", "4", "--json", "--devprof",
            "--devprof-sample", "1.0", "--ledger", str(ledger)])
        rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert rc == 0, rep
        dp = rep["devprof"]
        assert dp["sample"] == 1.0 and dp["samples"] == dp["dispatches"] > 0
        assert dp["device_frac"] is None
        row = perf_ledger.latest(str(ledger))
        assert row == rep["ledger_row"] and row["run"] == "loadgen"
        assert row["goodput_per_s"] == rep["goodput_per_s"]
        assert len(row["cost_digest"]) == 16
        perf_regress.write_baseline(str(base), row)
        assert perf_regress.main([str(ledger), "--baseline",
                                  str(base)]) == 0
        assert tloadgen.main(["--device", "cpu", "--devprof-sample",
                              "0.5"]) == 1
    finally:
        tflags.set_flags({"serving_devprof": False,
                          "serving_devprof_sample": 0.1})
        tobs.devprof.reset()
    row = [0.1, [1, 2, 3], 2, 1, 0.0, 0, 1.0, 0, "acme"]
    lg = tloadgen.LoadGen.from_trace(
        {"arrivals": [row, row[:8] + ["", 0.0, "s1"]]})
    assert [(a.tenant, a.session) for a in lg.schedule()] == \
        [("acme", ""), ("", "s1")]


def test_cli_runs_on_the_cpu_and_raises_without_cuda(monkeypatch, capsys):
    """``python3 -m paddle_tpu_torch.tools.loadgen --device cpu``: a
    virtual-clock run of the tiny model prints its report with no leak,
    no exception and nothing captured after the warm-up; with no device
    named and no CUDA it raises."""
    rc = tloadgen.main(["--device", "cpu", "--model", "gpt2-tiny",
                        "--mode", "bursty", "--rate", "12", "--duration",
                        "0.5", "--slots", "2", "--max-len", "32",
                        "--buckets", "8,16", "--prompt-tokens", "4:9",
                        "--new-tokens", "2:4", "--slo-ttft-ms", "200",
                        "--slo-prefill-ms", "4", "--slo-tpot-ms", "1",
                        "--virtual-step-ms", "4", "--json",
                        "--expect-zero-leaks", "--expect-zero-new-compiles"])
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0, rep
    assert rep["offered"] > 0 and rep["new_compiles_after_warmup"] == 0
    assert rep["blame"]["requests"] >= rep["completed"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tloadgen.main(["--model", "gpt2-tiny"])


def _fleet(pkg, vc, **kw):
    return pkg.Disagg(pkg.model, **{**ENGINE, "max_queue": 8,
                                    "block_size": 4, **kw},
                      clock=vc.now, **pkg.kw)


@pytest.mark.parametrize("colocate", [True, False],
                         ids=["colocated", "cross-pool"])
def test_disagg_run_like_the_reference(pkgs, colocate):
    """A warmed 1 x 2 fleet under a seeded bursty SLO run: the same
    decisions, sheds, tokens, virtual-clock TTFTs and ``disagg`` section
    (handoffs adopted and copied, affinity counters, fleet hit rate)."""
    def run(pkg):
        vc = pkg.lg.VirtualClock()
        rt = _fleet(pkg, vc, n_prefill=1, n_decode=2, colocate=colocate)
        pkg.lg.warmup(rt)
        rep = pkg.lg.LoadGen(mode="bursty", seed=7, **LG_KW).run(
            rt, clock=vc, step_cost_ms=4.0)
        return _observe(rep, rt.engines + rt._retiring)

    rep = _both(pkgs, run)["report"]
    assert rep["disagg"]["handoffs_adopted"] > 0
    assert (rep["disagg"]["handoffs_copied"] > 0) is not colocate
    assert rep["leaked_kv_blocks"] == 0 and rep["exceptions"] == 0


def test_disagg_chaos_kills_like_the_reference(pkgs):
    """``kill_prefill`` and ``kill_decode`` fired on the virtual clock
    through a warmed 2 x 2 fleet across pools: the same decisions,
    re-routes, re-homes, sheds and tokens, every request accounted for
    and nothing leaked."""
    def run(pkg):
        vc = pkg.lg.VirtualClock()
        rt = _fleet(pkg, vc, n_prefill=2, n_decode=2, colocate=False)
        pkg.lg.warmup(rt)
        lg = pkg.lg.LoadGen(mode="poisson", seed=42,
                            **dict(LG_KW, rate=60.0))
        lg.chaos = [{"t": 0.15, "kind": "kill_prefill", "index": 0},
                    {"t": 0.3, "kind": "kill_decode", "index": 1}]
        rep = lg.run(rt, clock=vc, step_cost_ms=4.0)
        st = rt.stats()
        return {**_observe(rep, rt.engines + rt._retiring),
                "workers": (st["prefill_workers"], st["decode_workers"]),
                "rehomed": st["rehomed"]}

    out = _both(pkgs, run)
    rep = out["report"]
    assert rep["chaos_applied"] == 2 and out["workers"] == (1, 1)
    assert rep["completed"] + rep["rehomed"] + rep["shed_total"] + \
        rep["canceled_total"] == rep["offered"]
    assert rep["leaked_kv_blocks"] == 0 and rep["exceptions"] == 0


def test_disagg_cli_like_the_reference(capsys):
    """``--disagg 2x2`` with a ``kill_prefill`` and a ``kill_decode`` on a
    virtual clock with pinned costs, through each package's CLI: the
    same report, decisions and ``disagg`` section (the CLIs draw their
    own random weights, and a run without EOS schedules the same
    whatever the tokens), no leak, nothing captured after the warm-up."""
    args = ["--model", "gpt2-tiny", "--mode", "bursty", "--rate", "40",
            "--duration", "0.5", "--slots", "2", "--max-len", "32",
            "--buckets", "8,16", "--prompt-tokens", "4:9",
            "--new-tokens", "2:4", "--slo-ttft-ms", "200",
            "--slo-prefill-ms", "4", "--slo-tpot-ms", "1",
            "--virtual-step-ms", "4", "--disagg", "2x2",
            "--chaos", "0.1:kill_prefill:1,0.2:kill_decode:0", "--json",
            "--expect-zero-leaks", "--expect-zero-new-compiles"]
    names = ["serving_disagg", "serving_prefix_affinity"]
    saved = (pt.get_flags(names), tflags.get_flags(names))
    reps = []
    try:
        for main, extra in ((jloadgen.main, []),
                            (tloadgen.main, ["--device", "cpu"])):
            rc = main(args + extra)
            out = capsys.readouterr().out.strip().splitlines()[-1]
            reps.append((rc, json.loads(out)))
    finally:
        pt.set_flags(saved[0])
        tflags.set_flags(saved[1])
    (jrc, jrep), (trc, trep) = reps
    assert jrc == trc == 0
    assert trep == jrep
    assert trep["chaos_applied"] == 2 and trep["disagg"]["prefill_workers"] == 1
    assert trep["new_compiles_after_warmup"] == 0


def test_dispatch_ahead_cli_like_the_reference(capsys):
    """``--megastep 2 --dispatch-ahead`` through each package's CLI on a
    virtual clock: the same report, no leak, nothing captured after the
    warm-up; ``--dispatch-ahead``
    at ``--megastep 1`` fails in both, as the reference's rule says."""
    args = ["--model", "gpt2-tiny", "--mode", "bursty", "--rate", "12",
            "--duration", "0.5", "--slots", "2", "--max-len", "32",
            "--buckets", "8,16", "--prompt-tokens", "4:9",
            "--new-tokens", "6:12", "--slo-ttft-ms", "200",
            "--slo-prefill-ms", "4", "--slo-tpot-ms", "1",
            "--virtual-step-ms", "4", "--json", "--expect-zero-leaks",
            "--expect-zero-new-compiles"]
    names = ["serving_megastep", "serving_dispatch_ahead",
             "serving_dispatch_threads"]
    saved = (pt.get_flags(names), tflags.get_flags(names))
    reps = []
    try:
        for main, extra in ((jloadgen.main, []),
                            (tloadgen.main, ["--device", "cpu"])):
            assert main(args + extra + ["--dispatch-ahead"]) == 1
            assert "--dispatch-ahead needs --megastep > 1" in \
                capsys.readouterr().err
            rc = main(args + extra + ["--megastep", "2",
                                      "--dispatch-ahead"])
            out = capsys.readouterr().out.strip().splitlines()[-1]
            reps.append((rc, json.loads(out)))
    finally:
        pt.set_flags(saved[0])
        tflags.set_flags(saved[1])
    (jrc, jrep), (trc, trep) = reps
    assert jrc == trc == 0
    assert trep == jrep
    assert trep["completed"] > 0 and trep["new_compiles_after_warmup"] == 0
