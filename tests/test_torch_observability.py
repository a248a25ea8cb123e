"""The port's metric plane against ``paddle_tpu``'s: the labelled
Counter / Gauge / Histogram registry (quantiles from the same buckets),
the ``monitor`` STAT shim (``stat_add`` / ``stat_set`` / ``stat_time`` /
``stats_with_prefix`` / ``reset``), the run log (``log_event``,
``recent``, a file per process with size-capped rotation), and, after the
same router run in both packages (int8 pools, spec K 2, sampled
requests, every serving fault site, a replica crash, a kill, a drain, a
weight swap), the same STAT counters with the same values and the same
run-log events in the same order."""

import torch_threads  # noqa: F401  (one worker's share of the cores)
import collections
import json

import jax
import numpy as np
import pytest

import paddle_tpu as pt
from paddle_tpu import monitor as jmonitor
from paddle_tpu.models.gpt import GPTConfig as JGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JGPT
from paddle_tpu.observability import metrics as jmetrics
from paddle_tpu.observability import runlog as jrunlog
from paddle_tpu.resilience import fault_scope as jfault_scope
from paddle_tpu.resilience import reset_default_budget as jreset_budget
from paddle_tpu.serving import ReplicaRouter as JReplicaRouter
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch import monitor as tmonitor
from paddle_tpu_torch import observability as tobs
from paddle_tpu_torch.models.convert import gpt_state_from_numpy
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.observability import metrics as tmetrics
from paddle_tpu_torch.observability import runlog as trunlog
from paddle_tpu_torch.resilience import fault_scope as tfault_scope
from paddle_tpu_torch.resilience import reset_default_budget as treset_budget
from paddle_tpu_torch.serving import ReplicaRouter

GEOM = dict(vocab_size=97, max_position_embeddings=64, hidden_size=32,
            num_layers=2, num_heads=4, ffn_hidden_size=64, init_std=0.2)
SPEC = ("serving.route:skip@2;serving.step:skip@0.1;"
        "serving.alloc:skip@1;serving.submit:skip@3;"
        "serving.replica:error@5")
#: STAT names the reference writes on paths the port does not have yet
#: (ROADMAP A2/A3): cancels, hedges, LoRA, dispatch-ahead, the host tier
UNPORTED_STATS = {
    "STAT_serving_canceled", "STAT_serving_hedges",
    "STAT_serving_lora_loads", "STAT_serving_lora_evictions",
    "STAT_serving_ahead_hits", "STAT_serving_ahead_misses",
    "STAT_fault_serving.handoff", "STAT_fault_serving.migrate",
}


@pytest.mark.parametrize("mod", [jmetrics, tmetrics], ids=["jax", "port"])
def test_registry_instruments_with_labels(mod):
    reg = mod.MetricsRegistry()
    c = reg.counter("reqs_total", "requests")
    c.labels(engine="0").inc()
    c.labels(engine="0").add(4)
    c.labels(engine="1").inc()
    assert c.labels(engine="0").value == 5 and c.value == 0
    g = reg.gauge("depth")
    g.labels(replica="0").set(3)
    g.labels(replica="0").set(1)
    assert g.labels(replica="0").value == 1
    with pytest.raises(TypeError):
        reg.gauge("reqs_total")                  # one kind per name
    with pytest.raises(TypeError):
        c.observe(1.0)
    assert reg.counter("reqs_total") is c
    assert sorted(reg.instruments()) == ["depth", "reqs_total"]
    reg.unregister("depth")
    assert reg.get("depth") is None


def test_histogram_quantiles_match_jax():
    rng = np.random.RandomState(0)
    vals = np.exp(rng.normal(-3, 1.5, 500))
    out = []
    for mod in (jmetrics, tmetrics):
        h = mod.MetricsRegistry().histogram("ttft").labels(engine="0")
        for v in vals:
            h.observe(float(v))
        out.append([h.count, h.sum] +
                   [h.quantile(q) for q in (0.0, 0.5, 0.95, 0.99, 1.0)])
    assert out[1] == out[0]
    assert tmetrics.DEFAULT_BUCKETS == jmetrics.DEFAULT_BUCKETS
    assert tobs.histogram("unused_h").quantile(0.5) is None


def test_monitor_shim():
    tmonitor.reset()
    tmonitor.stat_add("STAT_a")
    tmonitor.stat_add("STAT_a", 2)
    tmonitor.stat_set("STAT_b", 7)
    with tmonitor.stat_time("STAT_t"):
        pass
    with tmonitor.stat_time("STAT_t"):
        pass
    st = tmonitor.stats()
    assert st["STAT_a"] == 3 and st["STAT_b"] == 7
    assert st["STAT_t_calls"] == 2 and st["STAT_t_ms"] >= 0.0
    assert tmonitor.stat_get("STAT_t_calls") == 2
    assert tmonitor.stat_get("STAT_missing") == 0
    assert tmonitor.stats_with_prefix("STAT_a") == {"STAT_a": 3}
    # the shim reports into the shared registry
    assert tobs.metrics.DEFAULT.get("STAT_a").value == 3
    tmonitor.reset()
    assert tmonitor.stats() == {} and tobs.metrics.DEFAULT.get("STAT_a") is None


def test_runlog_recent_file_and_rotation(tmp_path):
    ev = trunlog.log_event("unit_test", x=1)
    assert ev["kind"] == "unit_test" and ev["x"] == 1
    assert trunlog.recent(1) == [ev] and not trunlog.enabled()
    saved = tflags.get_flags(["runlog_dir", "runlog_max_mb"])
    tflags.set_flags({"runlog_dir": str(tmp_path),
                      "runlog_max_mb": 0.0002})      # 200 bytes
    try:
        assert trunlog.enabled()
        for i in range(6):
            trunlog.log_event("unit_test", i=i, pad="x" * 40)
        path = trunlog.current_path()
        assert path is not None and path.startswith(str(tmp_path))
    finally:
        trunlog.close()
        tflags.set_flags(saved)
    rotated = [json.loads(line) for line in open(path + ".1")]
    assert rotated and all(e["kind"] == "unit_test" for e in rotated)
    seqs = [e["seq"] for e in trunlog.recent(7)]
    assert seqs == sorted(seqs) and seqs[0] == ev["seq"]


@pytest.fixture(scope="module")
def models():
    with jax.enable_x64(False):
        pt.seed(7)
        jm = JGPT(JGPTConfig(**GEOM))
        jm.eval()
    arrays = {n: np.asarray(p.value) for n, p in jm.named_parameters()}
    tm = GPTForCausalLM(GPTConfig(**GEOM), device="cpu")
    tm.load_state_dict(gpt_state_from_numpy(arrays, "cpu"), strict=True)
    return jm, tm.eval(), arrays


def _run(Router, model, fault_scope, monitor, reset_budget, runlog, state,
         **kw):
    """One router run touching every ported STAT and run-log path;
    returns ``(stats, run-log kinds, tokens)``."""
    monitor.reset()
    reset_budget()
    seq0 = runlog.recent(1)[-1]["seq"] if runlog.recent(1) else 0
    rng = np.random.RandomState(1)
    prompts = [rng.randint(1, 97, size=n).tolist()
               for n in (3, 7, 5, 11, 4, 9, 6, 8)]
    rt = Router(model, n_replicas=2, max_slots=2, max_len=32,
                buckets=[8, 16], max_queue=16, block_size=4,
                kv_dtype="int8", spec_tokens=2, clock=lambda: 0.0, **kw)
    reqs = []
    with fault_scope(SPEC, seed=3):
        for i, p in enumerate(prompts):
            try:
                reqs.append(rt.submit(p, max_new_tokens=6, **(
                    {"temperature": 0.7, "seed": i} if i % 2 else {})))
            except Exception as e:
                reqs.append(type(e).__name__)
        for _ in range(8):
            rt.step()
    rt.kill_replica(0)
    rt.swap_weights(state)
    rt.drain()
    kinds = [e["kind"] for e in runlog.recent(512) if e["seq"] > seq0]
    toks = [r if isinstance(r, str) else (r.state, r.output_ids)
            for r in reqs]
    return monitor.stats(), kinds, toks


def test_router_run_writes_the_same_stats_and_events_as_jax(models):
    jm, tm, arrays = models
    with jax.enable_x64(False):
        j_stats, j_kinds, j_toks = _run(
            JReplicaRouter, jm, jfault_scope, jmonitor, jreset_budget,
            jrunlog, arrays)
    t_stats, t_kinds, t_toks = _run(
        ReplicaRouter, tm, tfault_scope, tmonitor, treset_budget, trunlog,
        gpt_state_from_numpy(arrays, "cpu"), device="cpu")
    assert t_toks == j_toks
    # every name the port writes, with the reference's value (wall-clock
    # totals aside); every name the reference wrote, but for unported
    # features
    assert set(t_stats) <= set(j_stats)
    assert not set(j_stats) - set(t_stats) - UNPORTED_STATS
    assert {k: v for k, v in t_stats.items() if not k.endswith("_ms")} == \
        {k: j_stats[k] for k in t_stats if not k.endswith("_ms")}
    for name in ("STAT_serving_routed", "STAT_serving_route_shed",
                 "STAT_serving_shed", "STAT_serving_rejected",
                 "STAT_serving_rehomed", "STAT_serving_replica_killed",
                 "STAT_serving_replica_restarted",
                 "STAT_serving_weight_swaps", "STAT_serving_drained",
                 "STAT_serving_kv_quant_writes", "STAT_serving_spec_proposed",
                 "STAT_fault_serving.step", "STAT_fault_serving.alloc",
                 "STAT_fault_serving.submit", "STAT_fault_serving.route",
                 "STAT_fault_serving.replica", "STAT_serving_verify_calls"):
        assert t_stats.get(name, 0) > 0, name
    assert t_kinds == j_kinds
    # the rolling swap reaches every replica, the two retired ones (the
    # crashed and the killed replica) included
    assert collections.Counter(t_kinds)["serving_weight_swap"] == 3
    rehomed = tobs.counter("serving_rehomed_total")
    assert sum(s.value for _, s in rehomed.series()) >= \
        t_stats["STAT_serving_rehomed"]
