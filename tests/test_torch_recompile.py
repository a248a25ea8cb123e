"""The port's compile predictor (``paddle_tpu_torch/analysis/recompile.py``:
``predict_serving_compiles``, ``RecompilePredictor``, ``feed_signature``,
``merge_compile_counts``) against ``paddle_tpu.analysis.recompile`` on
the CPU, and against what the port's compile tracker observes.

- Over a seeded grid of arguments covering every keyword, valid and
  not, the port's prediction equals the reference's (or both raise
  ValueError); the port's own ``attn_impl`` values predict what the
  reference's do.
- For greedy workloads that mirror ``tools/obs_smoke.py``'s phases
  (plain with a prefix hit, speculative, megastep 4 with its single-step
  fallback, a disaggregated fleet, the host tier with sessions, devprof,
  LoRA tenants, two replicas), the prediction equals the port's
  ``observability.compiles()`` on fresh models: on the CPU a compile is
  a new input signature of the shared step cache.
- The port keeps a greedy and a sampled graph per decode entry: a
  workload whose rows sample observes the prediction plus one per decode
  site that replayed both graphs, exactly.
"""

import torch_threads  # noqa: F401  (one worker's share of the cores)
import inspect

import jax
import numpy as np
import pytest

import paddle_tpu as pt
from paddle_tpu.analysis import recompile as jrec
from paddle_tpu.models.gpt import GPTConfig as JGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JGPT
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch import observability as tobs
from paddle_tpu_torch.analysis import recompile as trec
from paddle_tpu_torch.models.convert import gpt_state_from_numpy
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.observability import devprof
from paddle_tpu_torch.serving import (DisaggRouter, HostBlockStore,
                                      ReplicaRouter, ServingEngine,
                                      TierManager, make_adapter)
from paddle_tpu_torch.serving.decoding import STOP_MAX_SEQS

GEOM = dict(vocab_size=97, max_position_embeddings=64, hidden_size=32,
            num_layers=2, num_heads=4, ffn_hidden_size=64)
SHAPE = dict(max_slots=3, max_len=32, buckets=[8, 16], max_queue=16,
             block_size=4)
PRED = dict(buckets=[8, 16], max_len=32, block_size=4)
SITES = ("serving_", "decode_", "verify_")
_EMPTY = inspect.Parameter.empty


@pytest.fixture(autouse=True)
def jax_without_x64():
    with jax.enable_x64(False):
        yield


@pytest.fixture(scope="module")
def arrays():
    pt.seed(7)
    jm = JGPT(JGPTConfig(**GEOM))
    return {n: np.asarray(p.value) for n, p in jm.named_parameters()}


@pytest.fixture
def fresh(arrays):
    """A fresh port model (an empty step cache) with the reference's
    weights, and the compile records reset."""
    def make():
        tm = GPTForCausalLM(GPTConfig(**GEOM), device="cpu")
        tm.load_state_dict(gpt_state_from_numpy(arrays, "cpu"), strict=True)
        return tm.eval()
    tobs.reset_compiles()
    yield make
    tobs.reset_compiles()


def _prompts(sizes, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, 97, size=n).tolist() for n in sizes]


def _observed():
    return {site: c["count"] for site, c in tobs.compiles().items()
            if site.startswith(SITES)}


def _rounds(target, rounds, **submit_kw):
    """Each round submitted together, then run to idle (the rounds of
    ``predict_serving_compiles``)."""
    reqs = []
    for rnd in rounds:
        reqs += [target.submit(p, max_new_tokens=n, **submit_kw)
                 for p, n in rnd]
        target.run_until_idle()
    assert all(r.state == "done" for r in reqs), reqs
    return reqs


# --------------------------------------------------- the argument grid
def _grid_case(rng):
    max_len = int(rng.choice([16, 32, 64]))
    n_b = int(rng.randint(1, 4))
    buckets = [int(b) for b in rng.randint(2, max_len + 8, size=n_b)]
    block_size = int(rng.choice([2, 4, 8]))
    base = rng.randint(1, 97, size=max_len).tolist()
    rounds = []
    for _ in range(int(rng.randint(1, 4))):
        rnd = []
        for _ in range(int(rng.randint(1, 4))):
            n = int(rng.randint(1, max_len))
            # a shared prefix now and then, so prefix hits move buckets
            prompt = (base[:n] if rng.rand() < 0.5 else
                      rng.randint(1, 97, size=n).tolist())
            rnd.append((prompt, int(rng.randint(1, 6))))
        rounds.append(rnd)

    kw = dict(buckets=buckets, max_len=max_len, block_size=block_size)
    # a few keywords off their defaults per case, each mostly to a valid
    # value, now and then to an invalid one (the last of each list)
    keys = sorted(OPTIONS)
    for i in rng.choice(len(keys), size=int(rng.randint(1, 6)),
                        replace=False):
        vals = OPTIONS[keys[i]]
        kw[keys[i]] = vals[int(rng.randint(len(vals)))]
    return rounds, kw


#: per keyword: values other than the default, the last one invalid
OPTIONS = {
    "paged": [False, False], "prefix_cache": [False, False],
    "spec_tokens": [2, 4, 2], "attn_impl": ["pallas", "pallas", "bad"],
    "kv_dtype": ["bf16", "int8", "fp8"],
    "mesh_shape": [(1, 1), (2, 2), (0, 1)], "n_replicas": [2, 3, 0],
    "slo_ttft_ms": [40.0, 5.0, -1.0],
    "priority_classes": [[0, 1, 2], [3], [-1]],
    "autoscale": [(1, 2), (2, 4), (3, 1)], "weight_swaps": [2, 5, -1],
    "replica_kills": [3, 1, -1], "restarts": [2, 1, -2],
    "rehomed": [5, 1, -1], "cancel": [4, 1, -1], "hedge": [2, 1, -1],
    "disagg": [(1, 2), (4, 4), (0, 2)],
    "sampling": [[(0.0, 0, 0.0), (0.8, 8, 0.9)], [(1.0, 0, 0.5)],
                 [(-1.0, 0, 0.0)]],
    "lora": [(4, 2), (8, 1), (0, 2)], "tracing": [True, 0.5, 1.5],
    "devprof": [True, False, 0.25, 1.5], "sanitize": [True, True, "yes"],
    "host_tier": [True, True], "sessions": [3, 1, -1],
    "megastep": [4, 8, 0],
}


def _predict(mod, rounds, kw):
    try:
        return mod.predict_serving_compiles(rounds, **kw)
    except ValueError:
        return ValueError


def test_predictions_equal_the_reference_over_a_seeded_grid():
    """1,200 seeded cases, valid and not: equal predictions, or
    ValueError from both; every keyword takes a value other than its
    default in some valid case."""
    params = inspect.signature(trec.predict_serving_compiles).parameters
    valid, moved = 0, set()
    for seed in range(4):
        rng = np.random.RandomState(seed)
        for _ in range(300):
            rounds, kw = _grid_case(rng)
            want = _predict(jrec, rounds, kw)
            assert _predict(trec, rounds, kw) == want, kw
            if want is not ValueError:
                valid += 1
                moved |= {k for k, v in kw.items()
                          if params[k].default is not _EMPTY and
                          v != params[k].default}
    assert valid >= 100
    assert moved == {k for k, p in params.items()
                     if p.kind is inspect.Parameter.KEYWORD_ONLY and
                     p.default is not _EMPTY}, moved


@pytest.mark.parametrize("impl", ["kernel", "composed"])
def test_port_attn_impls_predict_what_the_reference_values_do(impl):
    rounds = [[(list(range(1, 9)), 4), (list(range(1, 5)), 1)]]
    assert trec.predict_serving_compiles(rounds, attn_impl=impl, **PRED) \
        == jrec.predict_serving_compiles(rounds, attn_impl="xla", **PRED)
    with pytest.raises(ValueError, match="attn_impl"):
        trec.predict_serving_compiles(rounds, attn_impl="cuda", **PRED)


def test_each_noop_keyword_alone_equals_the_plain_prediction():
    rounds = [[(list(range(1, 13)), 4)], [(list(range(1, 13)), 4)]]
    plain = trec.predict_serving_compiles(rounds, **PRED)
    for kw in (dict(n_replicas=3), dict(slo_ttft_ms=40.0),
               dict(priority_classes=[0, 2]), dict(autoscale=(1, 3)),
               dict(weight_swaps=4), dict(replica_kills=3, restarts=3,
                                          rehomed=7),
               dict(cancel=5, hedge=2), dict(disagg=(1, 2)),
               dict(sampling=[(0.7, 5, 0.9)]), dict(tracing=True),
               dict(devprof=0.25), dict(sanitize=True),
               dict(host_tier=True, sessions=1000), dict(lora=(4, 2)),
               dict(attn_impl="pallas", kv_dtype="int8"),
               dict(mesh_shape=(1, 1))):
        assert trec.predict_serving_compiles(rounds, **kw, **PRED) == \
            plain == jrec.predict_serving_compiles(rounds, **kw, **PRED), kw


def test_helpers_equal_the_reference():
    feeds = {"b": np.zeros((2, 3), np.float32), "a": ((4,), "int32")}
    assert trec.feed_signature(feeds) == jrec.feed_signature(feeds)
    tp, jp = trec.RecompilePredictor(), jrec.RecompilePredictor()
    for site, sig in [("a", (1,)), ("a", (1,)), ("a", (2,)), ("b", ())]:
        assert tp.observe(site, sig) == jp.observe(site, sig)
    assert tp.predicted_counts() == jp.predicted_counts() == {"a": 2, "b": 1}
    phases = ({"x": 1, "y": 2}, {"x": 3}, {})
    assert trec.merge_compile_counts(*phases) == \
        jrec.merge_compile_counts(*phases) == {"x": 4, "y": 2}


# ------------------------------------------------ predicted == observed
WORKLOAD_SIZES = (3, 5, 7)


def test_plain_engine_with_a_prefix_hit(fresh):
    """obs_smoke's first phase: three prompts together, then the third
    again (its full-block prefix published by then)."""
    ps = _prompts(WORKLOAD_SIZES, seed=1)
    rounds = [[(p, 4) for p in ps], [(ps[2], 4)]]
    _rounds(ServingEngine(fresh(), device="cpu", **SHAPE), rounds)
    pred = trec.predict_serving_compiles(rounds, **PRED)
    assert pred == _observed() == {"serving_prefill_paged{bucket=8}": 1,
                                   "decode_step_paged": 1}


@pytest.mark.parametrize("replicas", [2])
def test_replicas_share_one_step_cache(fresh, replicas):
    ps = _prompts(WORKLOAD_SIZES, seed=1)
    rounds = [[(p, 4) for p in ps], [(ps[2], 4)]]
    _rounds(ReplicaRouter(fresh(), n_replicas=replicas, device="cpu",
                          **SHAPE), rounds)
    assert _observed() == trec.predict_serving_compiles(
        rounds, n_replicas=replicas, **PRED)


def test_speculative_engine_verifies(fresh):
    ps = _prompts(WORKLOAD_SIZES, seed=1)
    rounds = [[(p, 4) for p in ps]]
    _rounds(ServingEngine(fresh(), device="cpu", spec_tokens=2, **SHAPE),
            rounds)
    pred = trec.predict_serving_compiles(rounds, spec_tokens=2, **PRED)
    assert "verify_step_paged{k=2}" in pred
    assert _observed() == pred


def test_megastep_and_its_single_step_fallback(fresh):
    """obs_smoke's megastep phase: a request whose stop list exceeds the
    device tables' caps keeps the batch on single steps, the others run
    megasteps: both entries compile once."""
    ps = _prompts(WORKLOAD_SIZES, seed=1)
    big_stops = [[90 + j] for j in range(STOP_MAX_SEQS + 1)]
    eng = ServingEngine(fresh(), device="cpu", megastep=4, **SHAPE)
    reqs = [eng.submit(p, max_new_tokens=8) for p in ps]
    eng.run_until_idle()
    reqs.append(eng.submit(ps[0], max_new_tokens=8, stop=big_stops))
    eng.run_until_idle()
    assert all(r.state == "done" for r in reqs)
    rounds = [[(p, 8) for p in ps], [(ps[0], 8)]]
    pred = trec.predict_serving_compiles(rounds, megastep=4, **PRED)
    assert set(pred) >= {"decode_megastep_paged{n=4}", "decode_step_paged"}
    assert _observed() == pred


def test_disaggregated_fleet(fresh):
    ps = _prompts(WORKLOAD_SIZES, seed=1)
    rounds = [[(p, 4) for p in ps], [(ps[2], 4)]]
    fleet = DisaggRouter(fresh(), n_prefill=1, n_decode=2, device="cpu",
                         **SHAPE)
    _rounds(fleet, rounds)
    assert fleet.stats()["handoffs_adopted"] >= len(ps)
    assert _observed() == trec.predict_serving_compiles(
        rounds, disagg=(1, 2), **PRED) == \
        trec.predict_serving_compiles(rounds, **PRED)


def test_host_tier_sessions(fresh):
    """Sessions demoted to the host tier and resumed re-prefill only
    their unshared suffix, in buckets already compiled."""
    model = fresh()
    cfg = model.cfg
    tier = TierManager(HostBlockStore(cfg.num_layers, cfg.num_heads,
                                      cfg.head_dim, block_size=4,
                                      num_blocks=64), demote_idle_ms=0.0)
    eng = ServingEngine(model, kv_tier=tier, device="cpu", **SHAPE)
    p = _prompts((12,), seed=9)[0]
    reqs = []
    for _ in range(2):
        reqs.append(eng.submit(p, max_new_tokens=4, session="u"))
        eng.run_until_idle()
        eng.cache.flush_prefix_cache()
    assert tier.stats()["migrated_promote_blocks"] > 0
    # the second turn's prompt is the stored conversation, then p
    rounds = [[(r.prompt, 4)] for r in reqs]
    assert len(rounds[1][0][0]) == 12 + 4 + 12
    pred = trec.predict_serving_compiles(rounds, host_tier=True,
                                         sessions=1, **PRED)
    assert pred == trec.predict_serving_compiles(rounds, **PRED)
    assert _observed() == pred


def test_devprof_on_every_dispatch(fresh):
    tflags.set_flags({"serving_devprof": True})
    try:
        ps = _prompts(WORKLOAD_SIZES, seed=1)
        rounds = [[(p, 4) for p in ps]]
        eng = ServingEngine(fresh(), device="cpu", devprof_sample=1.0,
                            **SHAPE)
        _rounds(eng, rounds)
        assert eng.stats()["devprof"]["samples"] > 0
    finally:
        tflags.set_flags({"serving_devprof": False})
        devprof.reset()
    assert _observed() == trec.predict_serving_compiles(
        rounds, devprof=1.0, **PRED)


def test_lora_tenants(fresh):
    model = fresh()
    eng = ServingEngine(model, device="cpu", lora_rank=4,
                        lora_max_adapters=2, **SHAPE)
    eng.load_adapter("acme", make_adapter(model.cfg, 4, seed=1))
    ps = _prompts(WORKLOAD_SIZES, seed=1)
    rounds = [[(p, 4) for p in ps]]
    reqs = [eng.submit(p, max_new_tokens=4, tenant=t)
            for p, t in zip(ps, ["acme", "", "acme"])]
    eng.run_until_idle()
    assert all(r.state == "done" for r in reqs)
    assert _observed() == trec.predict_serving_compiles(
        rounds, lora=(4, 2), **PRED)


@pytest.mark.parametrize("kw,sites", [
    (dict(), ("decode_step_paged",)),
    (dict(spec_tokens=2), ("verify_step_paged{k=2}",)),
    (dict(megastep=4), ("decode_megastep_paged{n=4}",)),
], ids=["decode", "verify", "megastep"])
def test_sampled_rows_add_one_per_decode_site_that_replayed_both(
        fresh, kw, sites):
    """The port's documented divergence: a decode entry keeps a greedy
    and a sampled graph, so a workload whose batches replayed both
    counts one more at that site than the prediction (the reference's
    count); prefill entries keep one."""
    ps = _prompts(WORKLOAD_SIZES, seed=1)
    eng = ServingEngine(fresh(), device="cpu", **kw, **SHAPE)
    reqs = [eng.submit(ps[0], max_new_tokens=8)]
    eng.run_until_idle()
    reqs.append(eng.submit(ps[1], max_new_tokens=8, temperature=0.8,
                           top_k=8, seed=3))
    eng.run_until_idle()
    rounds = [[(ps[0], 8)], [(ps[1], 8)]]
    if "megastep" in kw:
        # a greedy request on the single-step fallback, whose entry the
        # prediction counts (as in obs_smoke's megastep phase)
        big_stops = [[90 + j] for j in range(STOP_MAX_SEQS + 1)]
        reqs.append(eng.submit(ps[2], max_new_tokens=8, stop=big_stops))
        eng.run_until_idle()
        rounds.append([(ps[2], 8)])
    assert all(r.state == "done" for r in reqs)
    pred = trec.predict_serving_compiles(
        rounds, sampling=[(0.0, 0, 0.0), (0.8, 8, 0.0)], **kw, **PRED)
    extra = {s: 1 for s in sites}
    assert _observed() == trec.merge_compile_counts(pred, extra)
