"""The port's device-cost observatory (``paddle_tpu_torch/observability/
devprof.py``), its compile tracker (``observability/compile_tracker.py``)
and its perf ledger (``paddle_tpu_torch/tools/perf_ledger.py``,
``perf_regress.py``) against the JAX package on the CPU: every test of
``tests/test_devprof.py`` that applies to the port.

- cost capture per serving site: the counted costs land in
  ``cost_table()``, the ``xla_cost`` gauges and the snapshot, with a
  stable digest, and add no specialisation: the compile records equal
  the JAX engine's for the same run, with devprof on and off;
- the counted matmul FLOPs of a decode, prefill, megastep and verify
  step equal ``torch.utils.flop_counter.FlopCounterMode``'s count over
  the plain CPU step exactly: both count the same products (the
  linears, the two attention products over every position the block
  tables name, the logits over the padded vocabulary), and the count
  adds no other term;
- the sampler picks the reference's dispatches for the same fraction;
- virtual-clock runs are deterministic and equal to devprof off;
- the blame split keeps the exact identity (plain, megastep, disagg);
- the MFU and roofline hand math;
- ``sample=0`` is bit-identical to devprof off (exports included);
- the ledger round trip and the regress gate;
- the compile tracker's signature format, records and
  ``RecompileWarning``.

The reference's ``predict_serving_compiles`` checks run on the port's
predictor (``devprof=`` a validated no-op, equal to the reference's, and
equal to the compiles of the port's engine profiling every dispatch).
The reference's ``_normalize_cost`` test does not apply: the port counts
costs itself (no XLA cost analysis).
"""

import torch_threads  # noqa: F401  (one worker's share of the cores)
import json
import warnings

import jax
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import paddle_tpu as pt
from paddle_tpu import observability as jobs
from paddle_tpu.analysis import predict_serving_compiles as jpredict
from paddle_tpu.models.gpt import GPTConfig as JGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JGPT
from paddle_tpu.observability import devprof as jdevprof
from paddle_tpu.serving import ServingEngine as JServingEngine
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch import observability as tobs
from paddle_tpu_torch.analysis import predict_serving_compiles
from paddle_tpu_torch.models import generation as gen
from paddle_tpu_torch.models.convert import gpt_state_from_numpy
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.observability import compile_tracker as tct
from paddle_tpu_torch.observability import devprof, tracing
from paddle_tpu_torch.serving import DisaggRouter, ServingEngine
from paddle_tpu_torch.tools import perf_ledger, perf_regress
from paddle_tpu_torch.tools.loadgen import LoadGen, VirtualClock

GEOM = dict(vocab_size=97, max_position_embeddings=64, hidden_size=32,
            num_layers=2, num_heads=4, ffn_hidden_size=64)
_GEOM = dict(max_slots=3, max_len=32, buckets=[8, 16], max_queue=16,
             block_size=4)


@pytest.fixture(autouse=True)
def jax_without_x64():
    with jax.enable_x64(False):
        yield


@pytest.fixture(scope="module")
def models():
    pt.seed(7)
    jm = JGPT(JGPTConfig(**GEOM))
    jm.eval()
    arrays = {n: np.asarray(p.value) for n, p in jm.named_parameters()}

    def port_model():
        tm = GPTForCausalLM(GPTConfig(**GEOM), device="cpu")
        tm.load_state_dict(gpt_state_from_numpy(arrays, "cpu"), strict=True)
        return tm.eval()

    return jm, port_model


def _reset():
    tflags.set_flags({"serving_devprof": False,
                      "serving_devprof_sample": 0.1,
                      "warn_recompiles": 0})
    pt.set_flags({"serving_devprof": False, "serving_devprof_sample": 0.1})
    devprof.reset()
    jdevprof.reset()
    tobs.reset_compiles()
    jobs.reset_compiles()
    tracing.reset()


@pytest.fixture(autouse=True)
def _clean():
    """Every test starts from an empty observatory, no compile records,
    no traces and the default flags (other files in the process compile
    too), and leaves them so."""
    _reset()
    yield
    _reset()


def _prompts(sizes, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, 97, size=n).tolist() for n in sizes]


def _run_engine(model, engine=ServingEngine, **kw):
    if engine is ServingEngine:
        kw.setdefault("device", "cpu")
    eng = engine(model, **_GEOM, **kw)
    reqs = [eng.submit(p, max_new_tokens=4)
            for p in _prompts((3, 5, 7), seed=1)]
    eng.run_until_idle()
    return eng, reqs


def _counts(compiles):
    return {q: rec["count"] for q, rec in compiles.items()}


# ------------------------------------------------- cost capture
def test_cost_capture_per_site_adds_no_compile(models):
    """With devprof on, each serving site's counted cost lands in the
    table, the gauges and the snapshot, with a stable digest; the
    compile records equal the JAX engine's for the same run, and equal
    the port's own with devprof off (the capture specialises
    nothing)."""
    jm, port_model = models
    _run_engine(jm, engine=JServingEngine)
    want = _counts(jobs.compiles())
    tobs.reset_compiles()
    off, _ = _run_engine(port_model())
    assert _counts(tobs.compiles()) == want
    assert devprof.cost_table() == {}
    off_traces = {k: e["traces"]["count"]
                  for k, e in off.model._step_compile_cache.items()}
    tobs.reset_compiles()
    tflags.set_flags({"serving_devprof": True})
    eng, reqs = _run_engine(port_model(), devprof_sample=1.0)
    assert all(r.state == "done" for r in reqs)
    assert _counts(tobs.compiles()) == want
    assert {k: e["traces"]["count"]
            for k, e in eng.model._step_compile_cache.items()} == off_traces
    tbl = devprof.cost_table()
    assert "decode_step_paged" in tbl, sorted(tbl)
    assert any(k.startswith("serving_prefill_paged{bucket=") for k in tbl)
    for qual, rec in tbl.items():
        assert rec["captures"] >= 1 and rec["signature"], qual
        assert rec["flops"] > 0 and rec["hbm_bytes"] > rec["out_bytes"] > 0
    d1, d2 = devprof.cost_digest(), devprof.cost_digest()
    assert d1 == d2 and len(d1) == 16
    int(d1, 16)
    text = tobs.prometheus_text()
    assert 'xla_cost{fn="decode_step_paged"' in text
    assert 'xla_compiles{fn="decode_step_paged"}' in text
    snap = tobs.snapshot()
    assert snap["device_costs"] == tbl
    assert _counts(snap["compiles"]) == want


def test_predictor_devprof_is_validated_noop(models):
    """``devprof=`` joins the no-op family in the port's predictor, as
    in the reference's; a port engine that profiles every dispatch makes
    the predicted compiles, no more (the cost capture specialises
    nothing)."""
    wl = [[([1, 2, 3], 4), ([5, 6, 7, 8, 9], 3)]]
    kw = dict(buckets=[8, 16], max_len=32, block_size=4)
    plain = predict_serving_compiles(wl, **kw)
    assert plain == jpredict(wl, **kw)
    for dp in (True, 0.25):
        assert predict_serving_compiles(wl, devprof=dp, **kw) == plain \
            == jpredict(wl, devprof=dp, **kw)
    with pytest.raises(ValueError, match="devprof"):
        predict_serving_compiles(wl, devprof=1.5, **kw)
    _, port_model = models
    tobs.reset_compiles()
    tflags.set_flags({"serving_devprof": True})
    eng, reqs = _run_engine(port_model(), devprof_sample=1.0)
    assert all(r.state == "done" for r in reqs)
    wl = [[(p, 4) for p in _prompts((3, 5, 7), seed=1)]]
    assert _counts(tobs.compiles()) == predict_serving_compiles(
        wl, devprof=1.0, **kw)


def test_cost_capture_off_without_flag():
    assert not devprof.enabled()
    assert devprof.note_cost("x", {}, "sig", {"flops": 1.0,
                                              "hbm_bytes": 1.0,
                                              "out_bytes": 1.0}) is None
    assert devprof.cost_table() == {}
    assert devprof.cost_digest() is None


@pytest.mark.parametrize("kind", ["decode", "prefill", "megastep",
                                  "verify"])
def test_counted_matmul_flops_equal_flop_counter(models, kind):
    """The counted FLOPs of one plain CPU step equal FlopCounterMode's
    count of the same call, exactly (tolerance 0): both count only the
    matmuls, and the count's terms are those matmuls (q/k/v, output and
    MLP linears, both attention products over every position of the
    block tables, the tied logits over the padded vocabulary)."""
    _, port_model = models
    model = port_model()
    tflags.set_flags({"serving_devprof": True})
    eng = ServingEngine(model, **_GEOM, device="cpu",
                        megastep=4 if kind == "megastep" else 1,
                        spec_tokens=2 if kind == "verify" else 0)
    reqs = [eng.submit(p, max_new_tokens=6)
            for p in _prompts((3, 5), seed=2)]
    seen = {}
    real = eng._decode_attempt if kind != "megastep" else \
        eng._megastep_attempt
    if kind == "verify":
        real = eng._verify_attempt
    if kind == "prefill":
        real = eng._prefill_group_attempt_paged

    def counted(*a):
        with FlopCounterMode(display=False) as fc:
            out = real(*a)
        seen.setdefault("flops", fc.get_total_flops())
        return out

    name = {"decode": "_decode_attempt", "megastep": "_megastep_attempt",
            "verify": "_verify_attempt",
            "prefill": "_prefill_group_attempt_paged"}[kind]
    setattr(eng, name, counted)
    eng.run_until_idle()
    assert all(r.state == "done" for r in reqs)
    site = {"decode": "decode_step_paged",
            "megastep": "decode_megastep_paged{n=4}",
            "verify": "verify_step_paged{k=2}"}.get(kind)
    if site is None:
        site = next(k for k in devprof.cost_table()
                    if k.startswith("serving_prefill_paged"))
    assert devprof.cost_table()[site]["flops"] == seen["flops"]


def test_cost_count_by_hand():
    """The decode step's count for one geometry, by hand: 3 rows, 2
    layers, h 32, ffn 64, tables of 8 blocks of 4 positions, a padded
    vocabulary of 128."""
    model = GPTForCausalLM(GPTConfig(**GEOM, vocab_pad_to=128),
                           device="cpu")
    L, h, f, b, P, Vp = 2, 32, 64, 3, 32, 128
    pools = [(torch.zeros(25, 4, 4, 8), torch.zeros(25, 4, 4, 8))
             for _ in range(L)]
    small = [torch.zeros(b, dtype=torch.int32),
             torch.zeros(b, dtype=torch.int32),
             torch.zeros(b, 8, dtype=torch.int32)]
    cost = gen._entry_cost(model, "decode", small, pools)
    want = (L * b * 2 * h * (4 * h + 2 * f) + L * 4 * b * P * h
            + 2 * b * h * Vp)
    assert cost["flops"] == want
    params = sum(p.numel() * 4 for p in model.parameters())
    kv = L * b * 8 * (2 * 4 * 4 * 8 * 4)
    out = b * 4 + b * 97 * 4 + L * b * 2 * h * 4
    small_bytes = 3 * 4 * 2 + 3 * 8 * 4
    assert cost["out_bytes"] == out
    assert cost["hbm_bytes"] == params + kv + small_bytes + out


# ------------------------------------------------- sampling machinery
def test_sampler_picks_the_reference_dispatches():
    for sample in (0.1, 0.25, 0.5, 0.9):
        p = devprof.DevProfiler(sample=sample, peak_flops=1.0,
                                peak_bytes_per_s=1.0)
        j = jdevprof.DevProfiler(sample=sample, peak_flops=1.0,
                                 peak_bytes_per_s=1.0)
        picks = [p.tick() for _ in range(2000)]
        assert picks == [j.tick() for _ in range(2000)]
    frac = sum(picks) / len(picks)
    assert 0.83 < frac < 0.97, frac
    off = devprof.DevProfiler(sample=0.0, peak_flops=1.0,
                              peak_bytes_per_s=1.0)
    assert not any(off.tick() for _ in range(100))
    assert off.stats()["dispatches"] == 100
    with pytest.raises(ValueError, match="sample"):
        devprof.DevProfiler(sample=1.5)


def test_peaks():
    """Pinned flags win; else the CPU's nominals (the reference's);
    a card that is not an H100 raises naming the two flags."""
    assert devprof.peaks("cpu") == {"peak_flops": 1e11,
                                    "peak_bytes_per_s": 50e9}
    assert devprof.peaks("cpu") == jdevprof._peaks()
    tflags.set_flags({"devprof_peak_flops": 5.0,
                      "devprof_peak_hbm_gbps": 2.0})
    try:
        assert devprof.peaks("cpu") == {"peak_flops": 5.0,
                                        "peak_bytes_per_s": 2e9}
    finally:
        tflags.set_flags({"devprof_peak_flops": 0.0,
                          "devprof_peak_hbm_gbps": 0.0})
    with pytest.raises(RuntimeError, match="FLAGS_devprof_peak_flops"):
        devprof.peaks("meta")


def _seeded_burst(model, *, devprof_on, sample=1.0, seed=11):
    tracing.reset()
    vc = VirtualClock()
    kw = dict(devprof=True, devprof_sample=sample) if devprof_on else {}
    eng = ServingEngine(model, clock=vc.now, slo_ttft_ms=60.0,
                        slo_prefill_ms=4.0, slo_tpot_ms=1.5, device="cpu",
                        **_GEOM, **kw)
    lg = LoadGen(mode="bursty", rate=30.0, duration=0.5, seed=seed,
                 vocab_size=97, prompt_tokens=(3, 7), new_tokens=(2, 4))
    report = lg.run(eng, clock=vc, step_cost_ms=4.0)
    assert report["completed"] > 0
    return report, eng.stats()


_REPORT_KEYS = ("completed", "shed_total", "ttft_ms_p50", "ttft_ms_p95",
                "goodput_per_s", "slo_attainment")


@pytest.mark.parametrize("sample", [0.25, 0.5])
def test_engine_samples_the_reference_dispatches(models, sample):
    """The same seeded virtual-clock burst through both engines: the same
    decisions, the same dispatches counted and the same ones sampled
    (zero-width on the virtual clock, so neither splits a trace)."""
    from tools.loadgen import LoadGen as JLoadGen
    from tools.loadgen import VirtualClock as JVirtualClock
    jm, port_model = models
    out = []
    for eng_cls, lg_cls, vc_cls, model, kw in (
            (JServingEngine, JLoadGen, JVirtualClock, jm, {}),
            (ServingEngine, LoadGen, VirtualClock, port_model(),
             {"device": "cpu"})):
        vc = vc_cls()
        eng = eng_cls(model, clock=vc.now, slo_ttft_ms=60.0,
                      slo_prefill_ms=4.0, slo_tpot_ms=1.5, devprof=True,
                      devprof_sample=sample, **_GEOM, **kw)
        rep = lg_cls(mode="bursty", rate=30.0, duration=0.5, seed=11,
                     vocab_size=97, prompt_tokens=(3, 7),
                     new_tokens=(2, 4)).run(eng, clock=vc, step_cost_ms=4.0)
        dp = eng.stats()["devprof"]
        out.append(({k: rep.get(k) for k in _REPORT_KEYS},
                    rep["decisions"], dp["dispatches"], dp["samples"],
                    dp["device_frac"]))
    assert out[0] == out[1]
    assert 0 < out[0][3] < out[0][2] and out[0][4] is None


def test_virtual_clock_determinism_and_no_admission_perturbation(models):
    _, port_model = models
    model = port_model()
    base, _ = _seeded_burst(model, devprof_on=False)
    runs = [_seeded_burst(model, devprof_on=True) for _ in range(2)]
    for rep, st in runs:
        for k in _REPORT_KEYS:
            assert rep.get(k) == base.get(k), (k, rep.get(k), base.get(k))
        dp = st["devprof"]
        assert dp["sample"] == 1.0
        assert dp["dispatches"] > 0 and dp["samples"] == dp["dispatches"]
    assert runs[0][1]["devprof"]["dispatches"] == \
        runs[1][1]["devprof"]["dispatches"]
    assert runs[0][1]["devprof"]["device_frac"] is None


# ------------------------------------------------- blame device split
def _split_identity(info):
    bl = info["blame_ms"]
    assert "decode" not in bl, bl
    assert {"decode_device", "decode_host"} <= set(bl), bl
    assert bl["decode_device"] >= 0.0 and bl["decode_host"] >= 0.0
    assert sum(bl.values()) == pytest.approx(info["e2e_ms"], abs=1e-6)


@pytest.mark.parametrize("megastep", [1, 4])
def test_blame_split_identity_engine(models, megastep):
    _, port_model = models
    tracing.reset()
    eng, reqs = _run_engine(port_model(), megastep=megastep, devprof=True,
                            devprof_sample=1.0)
    dp = eng.stats()["devprof"]
    assert dp["device_frac"] is not None and 0.0 <= dp["device_frac"] <= 1
    if megastep > 1:
        assert any(e["entry"] == "decode_megastep_paged{n=4}"
                   for e in dp["entries"]), dp["entries"]
    for r in reqs:
        info = tracing.get(r.id)
        assert info is not None and info["outcome"] == "done"
        _split_identity(info)
        assert info["ttft_ms"] == pytest.approx(r.ttft * 1e3, abs=1e-3)


def test_blame_split_identity_disagg_handoff(models):
    _, port_model = models
    tracing.reset()
    tflags.set_flags({"serving_devprof": True,
                      "serving_devprof_sample": 1.0})
    rt = DisaggRouter(port_model(), n_prefill=1, n_decode=2,
                      prefix_cache=False, device="cpu", **_GEOM)
    reqs = [rt.submit(p, max_new_tokens=6)
            for p in _prompts((3, 7), seed=3)]
    rt.run_until_idle()
    for r in reqs:
        assert r.state == "done"
        info = tracing.get(r.id)
        assert info is not None and info["outcome"] == "done"
        assert "handoff" in info["blame_ms"], info["blame_ms"]
        _split_identity(info)


# ------------------------------------------------- MFU / roofline math
def _inject_cost(mod, entry, flops, hbm_bytes):
    with mod._lock:
        mod._COSTS[entry] = {
            "flops": flops, "hbm_bytes": hbm_bytes, "out_bytes": 1.0,
            "signature": "syn", "supported": True, "captures": 1}


def test_mfu_and_roofline_hand_math():
    """Every derived number follows by hand from injected samples
    against a synthetic cost, and equals the reference's."""
    out = []
    for mod, obs in ((devprof, tobs), (jdevprof, jobs)):
        _inject_cost(mod, "syn", flops=2e6, hbm_bytes=4e6)
        p = mod.DevProfiler(sample=1.0, peak_flops=1e10,
                            peak_bytes_per_s=1e10)
        p.note_step("syn", device_s=0.001, host_s=0.0005)
        roof = p.roofline("syn")
        assert roof["mfu"] == pytest.approx(0.2)
        assert roof["hbm_util"] == pytest.approx(0.4)
        assert roof["verdict"] == "hbm-bound"
        assert roof["device_ms_mean"] == pytest.approx(1.0)
        assert p.device_frac() == pytest.approx(0.001 / 0.0015)
        assert p.mfu() == pytest.approx(0.2)
        p.note_step("syn", device_s=0.0, host_s=0.004)
        roof2 = p.roofline("syn")
        assert roof2["samples"] == 2 and roof2["verdict"] == "host-bound"
        assert roof2["mfu"] == pytest.approx(0.4)
        assert p.host_share() == pytest.approx(0.0045 / 0.0055)
        snap = obs.snapshot()["gauges"]
        assert snap["serving_mfu"] == pytest.approx(roof2["mfu"])
        assert snap["serving_host_overhead_share"] == \
            pytest.approx(p.host_share())
        q = mod.DevProfiler(sample=1.0, peak_flops=1e9,
                            peak_bytes_per_s=1e9)
        q.note_step("uncaptured", device_s=0.001, host_s=0.0)
        assert q.roofline("uncaptured")["verdict"] == "unattributed"
        assert q.mfu() is None
        out.append((roof, roof2, p.stats(), mod.roofline_entries()))
    assert out[0] == out[1]


def test_real_capture_feeds_live_mfu(models):
    _, port_model = models
    tflags.set_flags({"serving_devprof": True})
    eng, _ = _run_engine(port_model(), devprof_sample=1.0)
    dp = eng.stats()["devprof"]
    assert dp["samples"] > 0
    assert dp["mfu"] is not None and dp["mfu"] > 0.0
    dec = {e["entry"]: e for e in dp["entries"]}["decode_step_paged"]
    want = dec["flops"] / (dec["device_ms_mean"] * 1e-3 *
                           eng._devprof.peak_flops)
    assert dec["mfu"] == pytest.approx(want, abs=5.1e-7)
    text = tobs.prometheus_text()
    assert "serving_mfu" in text and "serving_device_step_ms" in text
    tobs.validate_prometheus_text(text)


# ------------------------------------------------- sampling=0 identity
def test_sampling_zero_bit_identical_to_off(models, tmp_path):
    _, port_model = models
    model = port_model()
    artifacts = []
    for mode in ("off", "zero"):
        if mode == "zero":
            tflags.set_flags({"serving_devprof": True})
        rep, st = _seeded_burst(model, devprof_on=(mode == "zero"),
                                sample=0.0)
        chrome = tmp_path / f"trace_{mode}.json"
        spans = tmp_path / f"spans_{mode}.jsonl"
        tracing.export_chrome_trace(str(chrome))
        tracing.export_spans_jsonl(str(spans))
        artifacts.append((chrome.read_bytes(), spans.read_bytes(),
                          {k: rep.get(k) for k in _REPORT_KEYS},
                          rep.get("decisions")))
        if mode == "zero":
            dp = st["devprof"]
            assert dp["samples"] == 0 and dp["dispatches"] > 0
            assert dp["device_frac"] is None
        else:
            assert "devprof" not in st
    assert artifacts[0] == artifacts[1]


def test_greedy_tokens_at_sample_zero_equal_devprof_off(models):
    _, port_model = models
    outs = []
    for kw in ({}, dict(devprof=True, devprof_sample=0.0),
               dict(devprof=True, devprof_sample=1.0)):
        _, reqs = _run_engine(port_model(), megastep=4, **kw)
        outs.append([r.output_ids for r in reqs])
    assert outs[0] == outs[1] == outs[2]


# ------------------------------------------------- perf ledger / gate
_REPORT = {
    "goodput_per_s": 52.13, "ttft_ms_p95": 6.4, "tpot_ms_p95": 3.71,
    "slo_attainment": 1.0, "completed": 25, "offered": 25,
    "shed_total": 0, "new_compiles_after_warmup": 0,
    "devprof": {"sample": 1.0, "dispatches": 113, "samples": 113,
                "device_frac": 0.4, "host_overhead_share": 0.6,
                "mfu": 0.12, "cost_digest": "ab" * 8},
}


def test_ledger_append_read_roundtrip(tmp_path):
    path = tmp_path / "ledger.jsonl"
    row = perf_ledger.append_report(str(path), dict(_REPORT),
                                    run="loadgen", label="t")
    assert row["schema"] == perf_ledger.SCHEMA
    assert row["goodput_per_s"] == 52.13 and row["mfu"] == 0.12
    assert row["cost_digest"] == "ab" * 8 and row["run"] == "loadgen"
    perf_ledger.append_report(str(path), dict(_REPORT), run="soak")
    rows = perf_ledger.read_rows(str(path))
    assert len(rows) == 2 and rows[0] == row
    assert perf_ledger.latest(str(path))["run"] == "soak"
    with open(path, "a") as f:
        f.write("not json\n")
    with pytest.raises(ValueError, match=r":3: bad ledger line"):
        perf_ledger.read_rows(str(path))


def test_regress_gate_baseline_and_injection(tmp_path):
    path = tmp_path / "ledger.jsonl"
    base = tmp_path / "baseline.json"
    row = perf_ledger.append_report(str(path), dict(_REPORT),
                                    run="loadgen")
    perf_regress.write_baseline(str(base), row)
    doc = json.loads(base.read_text())
    assert doc["metrics"]["goodput_per_s"] == 52.13
    assert doc["cost_digest"] == "ab" * 8
    assert perf_regress.compare(row, doc, tolerance=0.10)[0] == []
    bad = dict(row)
    bad["goodput_per_s"] = row["goodput_per_s"] / 2
    failures, _ = perf_regress.compare(bad, doc, tolerance=0.10)
    assert any("goodput_per_s" in f for f in failures), failures
    slow = dict(row)
    slow["tpot_ms_p95"] = row["tpot_ms_p95"] * 2
    failures, _ = perf_regress.compare(slow, doc, tolerance=0.10)
    assert any("tpot_ms_p95" in f for f in failures), failures
    drift = dict(row)
    drift["goodput_per_s"] = row["goodput_per_s"] * 0.95
    assert perf_regress.compare(drift, doc, tolerance=0.10)[0] == []
    gone = dict(row)
    gone["ttft_ms_p95"] = None
    failures, _ = perf_regress.compare(gone, doc, tolerance=0.10)
    assert any("ttft_ms_p95" in f for f in failures), failures
    # the CLI: the latest row against its own baseline passes, a worse
    # row appended after it fails
    assert perf_regress.main([str(path), "--baseline", str(base)]) == 0
    perf_ledger.append_row(str(path), bad)
    assert perf_regress.main([str(path), "--baseline", str(base)]) == 1


def test_regress_digest_and_slack_rules(tmp_path):
    row = perf_ledger.make_row(dict(_REPORT), run="loadgen")
    zrow = dict(row)
    zrow["ttft_ms_p95"] = 0.0
    doc = {"schema": 1, "cost_digest": row["cost_digest"], "metrics": {}}
    perf_regress.write_baseline(str(tmp_path / "b.json"), zrow)
    zdoc = json.loads((tmp_path / "b.json").read_text())
    assert zdoc["metrics"]["ttft_ms_p95"] == {"value": 0.0, "slack": 1.0}
    probe = dict(zrow)
    probe["ttft_ms_p95"] = 0.9
    assert perf_regress.compare(probe, zdoc)[0] == []
    probe["ttft_ms_p95"] = 1.2
    assert perf_regress.compare(probe, zdoc)[0] != []
    doc["metrics"] = {"goodput_per_s": row["goodput_per_s"]}
    doc["cost_digest"] = "f" * 16
    failures, notes = perf_regress.compare(row, doc)
    assert failures == [] and any("digest" in n for n in notes)
    failures, _ = perf_regress.compare(row, doc, strict_digest=True)
    assert any("digest" in f for f in failures)
    with pytest.raises(SystemExit, match="empty baseline"):
        perf_regress.write_baseline(str(tmp_path / "e.json"), row,
                                    metrics=["no_such_metric"])


# ------------------------------------------------- the compile tracker
def test_abstract_signature_equals_the_reference():
    from paddle_tpu.observability import compile_tracker as jct
    args = (np.zeros((4, 32), np.float32), np.zeros(4, np.int32), 3,
            [np.zeros((2, 2), np.int64)])
    assert tct.abstract_signature(args, {}) == \
        jct.abstract_signature(args, {}) == \
        "float32[4,32],int32[4],int,int64[2,2]"
    t = tct.abstract_signature((torch.zeros(2, 3, dtype=torch.bfloat16),
                                None), {})
    assert t == "bfloat16[2,3]"


def test_recompile_warning_names_the_signature():
    tflags.set_flags({"warn_recompiles": 2})
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for shape in ((1,), (2,), (3,)):
            tct.note_compile("decode_step", {}, [np.zeros(shape)], 1.0)
    msgs = [str(w.message) for w in caught
            if issubclass(w.category, tct.RecompileWarning)]
    assert len(msgs) == 1 and "compiled 3 times" in msgs[0]
    assert "float64[3]" in msgs[0] and "float64[2]" in msgs[0]
    rec = tobs.compiles()["decode_step"]
    assert rec["count"] == 3 and rec["last_signature"] == "float64[3]"
    assert [s["signature"] for s in rec["signatures"]] == \
        ["float64[1]", "float64[2]", "float64[3]"]
