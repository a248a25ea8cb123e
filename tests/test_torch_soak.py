"""The port's chaos soak (``paddle_tpu_torch/tools/soak.py``) against the
reference's (``tools/soak.py``) on the CPU.

- ``kill_spec`` and ``_windows`` equal the reference's (the counterpart
  of ``tests/test_loadgen.py::test_soak_kill_spec_and_windows_units``);
- one seeded arm (``--hours 0.5 --kills 1 --replicas 2 --seed 0
  --windows 4``, with a ``--sweep`` arm) through both packages' ``main``
  on gpt2-tiny with the same weights (carried across by
  ``gpt_state_from_numpy``) gives the same record field for field:
  report, windows, burn rates, blame, frontier, ``predictor_noop`` and
  the sanitizer's block. The port's report adds three fields the
  reference has no counterpart for (``PORT_ONLY``): where each compile
  happened, by engine, which the card's per-engine graphs need;
- the ``--trace-out`` exports of that arm are equal, byte for byte;
- the sanitized arm (``FLAGS_sanitize_locks=1`` in the environment,
  threaded dispatch) is clean, with every port lock in its graph;
- the abandonment arm's disconnects all land as cancels;
- the CLI's ``--expect-*`` gates give the reference's exit codes.
"""

import torch_threads  # noqa: F401  (one worker's share of the cores)
import contextlib
import io
import json
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu.models.gpt as jgpt
import paddle_tpu_torch.models.gpt as tgpt
from paddle_tpu.observability import devprof as jdevprof
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch.observability import devprof as tdevprof
from paddle_tpu_torch.models.convert import gpt_state_from_numpy
from paddle_tpu_torch.tools import soak as tsoak
from tools import soak as jsoak

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARM = ["--hours", "0.5", "--rate", "0.02", "--kills", "1", "--replicas",
       "2", "--seed", "0", "--windows", "4"]
#: the port's report fields the reference has no counterpart for: the
#: compiles by engines present at warm-up, by each replacement, and the
#: most an engine compiled in the warm-up (on the card each engine
#: captures graphs over its own pools)
PORT_ONLY = {"captures_warm_engines", "captures_replacements",
             "warm_engine_graphs"}


@pytest.fixture(autouse=True)
def jax_without_x64():
    with jax.enable_x64(False):
        yield


@pytest.fixture(autouse=True)
def clean_planes():
    """Both packages' devprof tables empty and devprof off: a cost table
    left by another test file in the process would add the decode blame
    split to one package's traces only."""
    for fl, dp in ((tflags, tdevprof), (pt, jdevprof)):
        fl.set_flags({"serving_devprof": False})
        dp.reset()
    yield


def _same_record(port, ref):
    """``port`` equals ``ref`` field for field, but for the sanitizer
    block's ``locks_tracked``: it counts every sanitized lock the process
    has made so far (``reset`` keeps their names, in both packages), and
    the port makes more of them (its trace, capture and launch-count
    locks), so it is a property of the process's history, not of the
    arm."""
    port, ref = dict(port), dict(ref)
    tl = dict(port.pop("sanitizer"))
    jl = dict(ref.pop("sanitizer"))
    tl.pop("locks_tracked")
    jl.pop("locks_tracked")
    assert tl == jl
    assert port == ref


@pytest.fixture(scope="module")
def models():
    with jax.enable_x64(False):
        pt.seed(0)
        jm = jgpt.GPTForCausalLM(jgpt.GPT_CONFIGS["gpt2-tiny"])
        jm.eval()
        arrays = {n: np.asarray(p.value) for n, p in jm.named_parameters()}
    tm = tgpt.GPTForCausalLM(tgpt.GPT_CONFIGS["gpt2-tiny"], device="cpu")
    tm.load_state_dict(gpt_state_from_numpy(arrays, "cpu"), strict=True)
    return jm, tm.eval()


def _main(monkeypatch, pkg, model, argv):
    """``pkg``'s soak ``main(argv)`` over ``model`` (its model factory
    patched to hand it back): (exit code, the JSON record or None)."""
    mod, soak = (jgpt, jsoak) if pkg == "jax" else (tgpt, tsoak)
    if pkg == "port":
        argv = argv + ["--device", "cpu"]
    monkeypatch.setattr(mod, "GPTForCausalLM", lambda *a, **k: model)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = soak.main(argv)
    monkeypatch.undo()
    lines = buf.getvalue().strip().splitlines()
    rec = json.loads(lines[-1]) if lines and "--json" in argv else None
    return rc, rec


def test_kill_spec_and_windows_equal_the_reference():
    assert tsoak.kill_spec(7200.0, 2) == \
        "serving.replica:error@t>2400s;serving.replica:error@t>4800s"
    assert tsoak.kill_spec(100.0, 0) == ""
    for dur, k, site in ((7200.0, 2, "serving.replica"),
                         (1800.0, 3, "serving.replica"),
                         (999.5, 5, "serving.decode")):
        assert tsoak.kill_spec(dur, k, site) == jsoak.kill_spec(dur, k, site)
    report = {"makespan_s": 10.0, "trace": [
        {"t": 1.0, "outcome": "done", "done_t": 2.0},
        {"t": 6.0, "outcome": "done", "done_t": 9.5},
        {"t": 6.2, "outcome": "shed", "done_t": None},
    ]}
    w = tsoak._windows(report, 2)
    assert [x["offered"] for x in w] == [1, 2]
    assert [x["completed"] for x in w] == [1, 1]
    assert w[1]["goodput_per_s"] == 0.2
    rng = np.random.RandomState(0)
    trace = [{"t": float(t), "outcome": str(o),
              "done_t": float(t + d) if o == "done" else None}
             for t, o, d in zip(rng.uniform(0, 100, 50),
                                rng.choice(["done", "shed"], 50),
                                rng.uniform(0, 20, 50))]
    for n in (1, 3, 8):
        rep = {"makespan_s": 120.0, "trace": trace}
        assert tsoak._windows(rep, n) == jsoak._windows(rep, n)


def test_seeded_arm_gives_the_reference_record(models, monkeypatch,
                                               tmp_path):
    jm, tm = models
    trace = str(tmp_path / "spans.json")
    argv = ARM + ["--sweep", "1:2", "--json", "--trace-out", trace]
    rc_j, ref = _main(monkeypatch, "jax", jm, argv)
    ref_trace = open(trace, "rb").read()
    os.remove(trace)
    rc_t, port = _main(monkeypatch, "port", tm, argv)
    assert rc_j == rc_t == 0
    assert open(trace, "rb").read() == ref_trace
    assert set(port["report"]) - set(ref["report"]) == PORT_ONLY
    assert port["report"]["captures_warm_engines"] == 0
    assert port["report"]["captures_replacements"] == [0]
    only = {k: port["report"].pop(k) for k in PORT_ONLY}
    _same_record(port, ref)
    rep = port["report"]
    assert rep["kills"] == rep["restarts"] == 1
    assert port["identity_ok"] and port["predictor_noop"]
    assert rep["leaked_kv_blocks"] == rep["exceptions"] == 0
    assert rep["new_compiles_after_warmup"] == 0
    assert len(port["frontier"]) == 2
    assert all(w["completed"] > 0 for w in port["windows"]
               if w["offered"])
    assert only["warm_engine_graphs"] >= 1


def test_out_writes_only_where_it_is_told(models, monkeypatch, tmp_path):
    _, tm = models
    out = tmp_path / "soak.json"
    before = set(os.listdir(ROOT))
    rc, _ = _main(monkeypatch, "port", tm,
                  ["--hours", "0.1", "--kills", "0", "--windows", "2",
                   "--out", str(out)])
    assert rc == 0
    assert set(os.listdir(ROOT)) == before
    rec = json.load(open(out))
    assert rec["bench"] == "soak_fleet_fault_tolerance"
    assert rec["report"]["offered"] > 0


def test_sanitized_arm_is_clean_with_every_port_lock_in_its_graph():
    """ci.sh's sanitized arm, with threaded dispatch: the flag in the
    environment, so the locks made at import are sanitized too."""
    code = textwrap.dedent("""
        import json, sys
        from paddle_tpu_torch.analysis import concurrency as ccz
        from paddle_tpu_torch.tools import soak
        rc = soak.main(sys.argv[1:])
        print(json.dumps({"rc": rc, "locks": sorted(
            {n.split("#")[0] for n in ccz._names.values()})}))
        """)
    argv = ARM + ["--device", "cpu", "--dispatch-threads", "2", "--json",
                  "--expect-kills-min", "1", "--expect-zero-leaks",
                  "--expect-zero-new-compiles", "--expect-identity",
                  "--expect-sanitizer-clean"]
    env = {**os.environ, "FLAGS_sanitize_locks": "1",
           "JAX_PLATFORMS": "cpu"}
    out = subprocess.run([sys.executable, "-c", code, *argv], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.strip().splitlines()
    rec, tail = json.loads(lines[-2]), json.loads(lines[-1])
    assert tail["rc"] == 0
    san = rec["sanitizer"]
    assert san["enabled"] and san["lock_acquires"] > 0
    assert san["cycles"] == [] and san["violations"] == []
    assert {"engine._lock", "engine._step_lock", "router._lock",
            "model_trace_lock", "jit._capture_lock", "metrics.registry",
            "launches.lock"} <= set(tail["locks"]), tail["locks"]
    assert rec["report"]["kills"] >= 1 and rec["identity_ok"]


def test_abandonment_arm_cancels_every_disconnect(models, monkeypatch):
    """ci.sh's abandonment arm: closed-loop clients, 15% of them hang
    up, hedging armed; equal to the reference's record."""
    jm, tm = models
    argv = ["--hours", "0.5", "--rate", "0.02", "--kills", "0",
            "--replicas", "2", "--seed", "3", "--windows", "4",
            "--closed-loop", "4", "--abandon-frac", "0.15", "--hedge-ms",
            "50", "--hedge-budget", "0.3", "--json", "--expect-zero-leaks",
            "--expect-zero-new-compiles", "--expect-identity",
            "--expect-hedge-budget-respected"]
    rc_j, ref = _main(monkeypatch, "jax", jm, argv)
    rc_t, port = _main(monkeypatch, "port", tm, argv)
    assert rc_j == rc_t == 0
    for k in PORT_ONLY:
        port["report"].pop(k)
    _same_record(port, ref)
    rep = port["report"]
    assert port["identity_ok"] and port["hedge_budget_ok"]
    assert rep["abandoned"] >= 1
    assert rep["canceled"].get("disconnect", 0) == rep["abandoned"]


@pytest.mark.parametrize("gates,rc", [
    (["--expect-kills-min", "1", "--expect-goodput-every-window",
      "--expect-zero-leaks", "--expect-zero-new-compiles",
      "--expect-identity"], 0),
    (["--expect-kills-min", "3"], 1),
    (["--expect-sanitizer-clean"], 1),
    (["--expect-hedge-budget-respected"], 1),
], ids=["pass", "kills", "sanitizer-off", "no-hedging"])
def test_cli_gates_give_the_reference_exit_codes(models, monkeypatch,
                                                 gates, rc):
    jm, tm = models
    argv = ["--hours", "0.1", "--rate", "0.02", "--kills", "1",
            "--replicas", "2", "--seed", "0", "--windows", "2"] + gates
    rc_j, _ = _main(monkeypatch, "jax", jm, argv)
    rc_t, _ = _main(monkeypatch, "port", tm, argv)
    assert rc_t == rc_j == rc


@pytest.mark.parametrize("bad", [["--megastep", "0"],
                                 ["--dispatch-threads", "-1"]])
def test_cli_refusals_give_the_reference_exit_codes(models, monkeypatch,
                                                    bad):
    jm, tm = models
    assert _main(monkeypatch, "port", tm, bad)[0] == \
        _main(monkeypatch, "jax", jm, bad)[0] == 1


def test_compile_gate_on_the_card_counts_per_engine():
    """On the card a replacement captures over its own pools: the gate
    holds engines present at warm-up to 0 and each replacement to a
    warmed engine's graphs; on the CPU the total must be 0 too."""
    rep = {"captures_warm_engines": 0, "captures_replacements": [4, 3],
           "warm_engine_graphs": 4, "new_compiles_after_warmup": 7}
    assert tsoak.compiles_ok(rep, "cuda")
    assert not tsoak.compiles_ok(rep, "cpu")
    assert not tsoak.compiles_ok({**rep, "captures_warm_engines": 1,
                                  "new_compiles_after_warmup": 8}, "cuda")
    assert not tsoak.compiles_ok({**rep, "captures_replacements": [5, 2]},
                                 "cuda")
    # a compile no engine's pool explains fails the gate too
    assert not tsoak.compiles_ok({**rep, "new_compiles_after_warmup": 8},
                                 "cuda")


def test_soak_runs_as_a_module_and_refuses_without_a_device():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.tools.soak", "--hours",
         "0.1"], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=120)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
