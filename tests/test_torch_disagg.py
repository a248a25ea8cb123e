"""The port's disaggregated fleet (``paddle_tpu_torch/serving/disagg.py``)
and its KV handoff (``BlockKVCache.export_row`` / ``import_row`` /
``adopt_row``) against ``paddle_tpu.serving.DisaggRouter`` on the CPU.
Each scenario runs once per package on the same weights (carried across
by ``gpt_state_from_numpy``) and prompts, from reset monitors, retry
budgets and trace stores; what it observes must be equal: tokens,
placements, ``stats()`` (each worker's cut to the keys both engines
compute alike, ``ENGINE_KEYS``), STAT
counters, ``leaked()`` per unique pool, the handoff queue's order and
backpressure, the affinity counters, the kill accounting (shed,
rerouted, rehomed) and the ``serving.handoff`` skip and drop runs.
Every test of ``tests/test_serving_disagg.py`` has a counterpart here,
with its parametrizations: the reference's
``predict_serving_compiles(disagg=...)`` check runs on the port's
predictor (equal to the reference's, and to the compiles a port fleet
makes on the CPU), beside the equality of the step cache's input
signatures between a symmetric and a disaggregated fleet. Beside them: the handoff
itself block for block against the reference (f32, bf16 and int8 pools,
the int8 scales zeroed then copied, the errors), one trace across a
decode-worker kill (``tests/test_tracing.py:140``), sampled requests
across the role boundary, cancel at every stage, and the threaded fleet
token-equal to the serial one. The model is the small GPT of
``tests/test_serving_disagg.py`` (vocab 97, h 32, 2 layers, 4 heads)
drawn at ``init_std`` 0.2, whose greedy tokens vary; engines run on a
frozen clock unless a test needs time to pass. The JAX side runs with
64-bit types off."""

import torch_threads  # noqa: F401  (one worker's share of the cores)
import contextlib
import json
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import monitor as jmonitor
from paddle_tpu import observability as jobs
from paddle_tpu.models.generation import greedy_search as jgreedy
from paddle_tpu.models.gpt import GPTConfig as JGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JGPT
from paddle_tpu.analysis import predict_serving_compiles as jpredict
from paddle_tpu.observability import tracing as jtracing
from paddle_tpu.resilience import fault_scope as jfault_scope
from paddle_tpu.resilience import reset_default_budget as jreset_budget
from paddle_tpu.serving import DecodeEngine as JDecodeEngine
from paddle_tpu.serving import DisaggRouter as JDisaggRouter
from paddle_tpu.serving import HandoffQueue as JHandoffQueue
from paddle_tpu.serving import QueueFullError as JQueueFullError
from paddle_tpu.serving import ReplicaRouter as JReplicaRouter
from paddle_tpu.serving import ServingEngine as JServingEngine
from paddle_tpu.serving.disagg import parse_disagg as jparse_disagg
from paddle_tpu.serving.kv_cache import BlockKVCache as JBlockKVCache
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch import monitor as tmonitor
from paddle_tpu_torch import observability as tobs
from paddle_tpu_torch.analysis import predict_serving_compiles
from paddle_tpu_torch.models.convert import gpt_state_from_numpy
from paddle_tpu_torch.models.generation import greedy_search as tgreedy
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.observability import tracing as ttracing
from paddle_tpu_torch.resilience import fault_scope as tfault_scope
from paddle_tpu_torch.resilience import reset_default_budget as treset_budget
from paddle_tpu_torch.serving import (BlockKVCache, DecodeEngine,
                                      DisaggRouter, HandoffQueue,
                                      QueueFullError, ReplicaRouter,
                                      ServingEngine)
from paddle_tpu_torch.serving.disagg import parse_disagg
from tools.loadgen import VirtualClock

GEOM = dict(vocab_size=97, max_position_embeddings=64, hidden_size=32,
            num_layers=2, num_heads=4, ffn_hidden_size=64, init_std=0.2)
SHAPE = dict(max_slots=2, max_len=32, buckets=[8, 16], max_queue=16,
             block_size=4)
SAMPLED = dict(temperature=0.8, top_k=8, top_p=0.95)
STATS = ("STAT_serving_routed", "STAT_serving_handoffs",
         "STAT_serving_completed", "STAT_serving_tokens",
         "STAT_serving_shed", "STAT_serving_rehomed",
         "STAT_serving_rerouted", "STAT_serving_worker_killed",
         "STAT_serving_affinity_hits", "STAT_serving_affinity_misses",
         "STAT_serving_canceled", "STAT_fault_serving.handoff",
         "STAT_retry_serving.handoff")


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

    def port_model():
        tm = GPTForCausalLM(GPTConfig(**GEOM), device="cpu")
        tm.load_state_dict(gpt_state_from_numpy(arrays, "cpu"), strict=True)
        return tm.eval()

    jax_side = SimpleNamespace(
        name="jax", model=jm, Disagg=JDisaggRouter, Router=JReplicaRouter,
        Engine=JServingEngine, Queue=JHandoffQueue,
        DecodeEngine=JDecodeEngine, QueueFullError=JQueueFullError,
        parse=jparse_disagg, greedy=jgreedy, monitor=jmonitor, obs=jobs,
        tracing=jtracing, flags=pt, fault_scope=jfault_scope,
        reset_budget=jreset_budget, kw={})
    port = SimpleNamespace(
        name="port", model=port_model(), Disagg=DisaggRouter,
        Router=ReplicaRouter, Engine=ServingEngine, Queue=HandoffQueue,
        DecodeEngine=DecodeEngine, QueueFullError=QueueFullError,
        parse=parse_disagg, greedy=tgreedy, monitor=tmonitor, obs=tobs,
        tracing=ttracing, flags=tflags, fault_scope=tfault_scope,
        reset_budget=treset_budget, kw={"device": "cpu"},
        fresh_model=port_model)
    return jax_side, port


def _prompts(sizes, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, 97, size=n).tolist() for n in sizes]


def _fleet(pkg, p=1, d=2, **kw):
    base = dict(SHAPE, clock=lambda: 0.0)
    base.update(kw)
    return pkg.Disagg(pkg.model, n_prefill=p, n_decode=d, **base, **pkg.kw)


def _ref(pkg, prompt, n):
    return [int(t) for t in pkg.greedy(pkg.model, np.asarray([prompt]),
                                       max_new_tokens=n, cache_len=32)[0]]


def _leaked_per_pool(rt):
    """leaked() per unique pool (co-located roles share one), each pool's
    prefix cache flushed first."""
    pools = {}
    for eng in rt.engines + rt._retiring:
        pools[id(eng.cache.pool)] = eng.cache
    out = []
    for cache in pools.values():
        cache.flush_prefix_cache()
        out.append(cache.allocator.leaked())
    return out


#: the per-worker ``stats()`` keys both packages compute the same way
#: (the port's engine takes latency percentiles over its own requests,
#: the reference's over histogram series, and its attention label names
#: the kernel where the reference names XLA)
ENGINE_KEYS = ("completed", "queue_depth", "active", "shed", "shed_total",
               "canceled", "canceled_total", "paged", "kv_dtype",
               "spec_tokens", "block_size", "num_blocks", "kv_blocks_used",
               "kv_blocks_free", "prefix_cache", "prefix_entries",
               "prefix_hit_requests", "prefix_miss_requests",
               "prefix_hit_tokens", "prefix_miss_tokens", "prefix_hit_rate",
               "spec_proposed", "spec_accepted", "spec_acceptance_rate",
               "megastep", "tenants")


def _norm(st):
    """A fleet's ``stats()`` with each worker's cut to ``ENGINE_KEYS``."""
    out = dict(st)
    for role in ("per_prefill", "per_decode"):
        out[role] = [{k: e[k] for k in ENGINE_KEYS if k in e}
                     for e in st[role]]
    return out


def _stats(pkg, names=STATS):
    return {n: pkg.monitor.stat_get(n) for n in names}


@contextlib.contextmanager
def _flags(pkg, values):
    saved = pkg.flags.get_flags(list(values))
    pkg.flags.set_flags(values)
    try:
        yield
    finally:
        pkg.flags.set_flags(saved)


def _both(pkgs, scenario):
    """``scenario(pkg)`` once per package from reset monitors, retry
    budgets and trace stores; its observations must be equal."""
    out = []
    for pkg in pkgs:
        pkg.monitor.reset()
        pkg.reset_budget()
        pkg.tracing.reset()
        out.append(scenario(pkg))
    assert out[1] == out[0]
    return out[0]


# ----------------------------------------------------- token identity
@pytest.mark.parametrize("kw", [
    dict(prefix_cache=True),
    dict(prefix_cache=False),
    dict(prefix_cache=True, spec_tokens=2),
    dict(prefix_cache=True, kv_dtype="int8"),
], ids=["prefix", "no-prefix", "spec2", "int8"])
@pytest.mark.parametrize("colocate", [True, False],
                         ids=["colocated", "cross-pool"])
def test_disagg_matches_symmetric_router_like_the_reference(pkgs, kw,
                                                            colocate):
    """The same prompts through a symmetric 2-replica router and a 1 x 2
    fleet give the same tokens (and greedy_search's, f32 and bf16), in
    each package and across them, with the same stats and counters."""
    prompts = _prompts((3, 7, 5, 11, 4, 9), seed=1)
    n = 5

    def run(pkg):
        sym = pkg.Router(pkg.model, n_replicas=2, **SHAPE, **kw, **pkg.kw)
        sym_reqs = [sym.submit(p, max_new_tokens=n) for p in prompts]
        sym.run_until_idle()
        rt = _fleet(pkg, p=1, d=2, colocate=colocate, **kw)
        reqs = [rt.submit(p, max_new_tokens=n) for p in prompts]
        rt.run_until_idle()
        assert all(r.state == "done" for r in sym_reqs + reqs)
        assert [r.output_ids for r in reqs] == \
            [r.output_ids for r in sym_reqs]
        if "kv_dtype" not in kw:
            assert [r.output_ids for r in reqs] == \
                [_ref(pkg, p, n) for p in prompts]
        return {"tokens": [r.output_ids for r in reqs],
                "leaked": _leaked_per_pool(rt), "stats": _norm(rt.stats()),
                "counters": _stats(pkg)}

    obs = _both(pkgs, run)
    assert all(lk == 1 for lk in obs["leaked"])
    st = obs["stats"]
    assert st["completed"] == st["handoffs_adopted"] == len(prompts)
    assert st["handoffs_copied"] == (0 if colocate else len(prompts))
    assert len(set(map(tuple, obs["tokens"]))) > 1


def _signatures(model):
    return {k: v["traces"]["count"]
            for k, v in model._step_compile_cache.items()}


def test_disagg_adds_zero_compiles_over_symmetric_like_the_reference(pkgs):
    """After a symmetric run paid for a geometry, a 2 x 2 fleet at that
    geometry adds no compile (the reference's XLA compiles; the port's
    step-cache input signatures, its compiles on the CPU)."""
    prompts = _prompts((3, 7, 5, 9), seed=2)

    def run(pkg):
        sym = pkg.Router(pkg.model, n_replicas=2, **SHAPE, **pkg.kw)
        for p in prompts:
            sym.submit(p, max_new_tokens=4)
        sym.run_until_idle()
        if pkg.name == "jax":
            def snap():
                return {k: v["count"]
                        for k, v in pkg.obs.compiles().items()
                        if k.startswith(("serving_", "decode_", "verify_"))}
        else:
            def snap():
                return _signatures(pkg.model)
        before = snap()
        rt = _fleet(pkg, p=2, d=2)
        reqs = [rt.submit(p, max_new_tokens=4) for p in prompts]
        rt.run_until_idle()
        return {"done": [r.state for r in reqs],
                "unchanged": snap() == before,
                "tokens": [r.output_ids for r in reqs]}

    obs = _both(pkgs, run)
    assert obs["unchanged"] and obs["done"] == ["done"] * 4


@pytest.mark.parametrize("dims", [(1, 2), (4, 4)], ids=["1x2", "4x4"])
def test_disagg_step_signatures_equal_the_symmetric_fleets(pkgs, dims):
    """The counterpart of the reference's
    ``predict_serving_compiles(disagg=...)`` no-op: on fresh models with
    the same weights, a symmetric fleet and a disaggregated one over the
    same rounds make the same step-cache entries with the same input
    signatures; no worker per role, or a dense cache, is refused."""
    _, port = pkgs
    rounds = [[(list(range(1, 9)), 4), (list(range(1, 5)), 1)],
              [(list(range(1, 9)), 4)]]

    def run(target, model):
        for rnd in rounds:
            for prompt, n in rnd:
                target.submit(prompt, max_new_tokens=n)
            target.run_until_idle()
        return _signatures(model)

    sym_model, dis_model = port.fresh_model(), port.fresh_model()
    plain = run(ReplicaRouter(sym_model, n_replicas=2, **SHAPE,
                              device="cpu"), sym_model)
    assert plain
    fleet = DisaggRouter(dis_model, n_prefill=dims[0], n_decode=dims[1],
                         **SHAPE, device="cpu")
    assert run(fleet, dis_model) == plain
    with pytest.raises(ValueError, match="worker"):
        DisaggRouter(dis_model, n_prefill=0, n_decode=2, **SHAPE,
                     device="cpu")
    with pytest.raises(ValueError, match="paged"):
        DisaggRouter(dis_model, n_prefill=1, n_decode=2, paged=False,
                     max_slots=2, max_len=32, buckets=[8, 16],
                     device="cpu")


def test_predict_serving_compiles_disagg_is_noop(pkgs):
    """The reference's static twin of the test above, on the port's
    predictor: ``disagg`` is a validated no-op, the predictions equal the
    reference's, and a port fleet's compiles on the CPU (its step-cache
    signatures, counted by the compile tracker) equal them."""
    _, port = pkgs
    rounds = [[(list(range(1, 9)), 4), (list(range(1, 5)), 1)],
              [(list(range(1, 9)), 4)]]
    kw = dict(buckets=[8, 16], max_len=32, block_size=4)
    plain = predict_serving_compiles(rounds, **kw)
    assert plain and plain == jpredict(rounds, **kw)
    for dims in ((1, 2), (4, 4)):
        assert predict_serving_compiles(rounds, disagg=dims, **kw) == \
            plain == jpredict(rounds, disagg=dims, **kw)
    with pytest.raises(ValueError, match="disagg"):
        predict_serving_compiles(rounds, disagg=(0, 2), **kw)
    with pytest.raises(ValueError, match="paged"):
        predict_serving_compiles(rounds, disagg=(1, 2), paged=False,
                                 buckets=[8, 16], max_len=32)
    tobs.reset_compiles()
    model = port.fresh_model()
    fleet = DisaggRouter(model, n_prefill=1, n_decode=2, **SHAPE,
                         device="cpu")
    for rnd in rounds:
        for prompt, n in rnd:
            fleet.submit(prompt, max_new_tokens=n)
        fleet.run_until_idle()
    observed = {q: c["count"] for q, c in tobs.compiles().items()}
    tobs.reset_compiles()
    assert observed == predict_serving_compiles(rounds, disagg=(1, 2),
                                                **kw)


# --------------------------------------------------- prefix affinity
def _shared_prefix_workload(n_prefixes=4, per_prefix=6, seed=3):
    """per_prefix requests over each of n_prefixes 8-token system prompts
    (2 full blocks at block_size 4) plus unique suffixes, shuffled
    within each wave."""
    rng = np.random.RandomState(seed)
    systems = [rng.randint(1, 97, size=8).tolist()
               for _ in range(n_prefixes)]
    out = []
    for i in range(per_prefix):
        for j in rng.permutation(n_prefixes):
            out.append(systems[j] + rng.randint(1, 97, size=3).tolist())
    return out


def _run_waves(rt, prompts, wave=4):
    reqs = []
    for i in range(0, len(prompts), wave):
        for p in prompts[i:i + wave]:
            reqs.append(rt.submit(p, max_new_tokens=2))
        rt.run_until_idle()
    return reqs


def test_prefix_affinity_beats_least_loaded_like_the_reference(pkgs):
    """Over 2 prefill workers the fleet prefix hit rate is higher with
    affinity on than least-loaded, the same in both packages, with no
    leaked block either way."""
    prompts = _shared_prefix_workload()

    def run(pkg):
        out = {}
        for affinity in (True, False):
            rt = _fleet(pkg, p=2, d=2, prefix_affinity=affinity,
                        num_blocks=96)
            reqs = _run_waves(rt, prompts)
            assert all(r.state == "done" for r in reqs)
            out[affinity] = {"stats": _norm(rt.stats()),
                             "leaked": _leaked_per_pool(rt),
                             "tokens": [r.output_ids for r in reqs]}
        return out

    obs = _both(pkgs, run)
    aff, base = obs[True]["stats"], obs[False]["stats"]
    assert all(lk == 1 for o in obs.values() for lk in o["leaked"])
    assert aff["affinity_hits"] > 0
    assert base["affinity_hits"] == 0 and base["affinity_misses"] == 0
    assert aff["fleet_prefix_hits"] > base["fleet_prefix_hits"]
    assert aff["fleet_prefix_hit_rate"] > base["fleet_prefix_hit_rate"]


def test_affinity_counters_published_to_metrics_like_the_reference(pkgs):
    def run(pkg):
        rt = _fleet(pkg, p=2, d=2, prefix_affinity=True, num_blocks=96)
        _run_waves(rt, _shared_prefix_workload(n_prefixes=2, per_prefix=3))
        text = pkg.obs.prometheus_text()
        pkg.obs.validate_prometheus_text(text)
        rid = rt._rid
        return {name: [ln.split(" ")[-1] for ln in text.splitlines()
                       if ln.startswith(name + "{")
                       and f'router="{rid}"' in ln]
                for name in ("serving_prefix_affinity_hits",
                             "serving_prefix_affinity_misses",
                             "serving_handoff_queue_depth",
                             "serving_disagg_workers")}

    obs = _both(pkgs, run)
    assert all(obs.values()), obs


# ------------------------------------------------- handoff mechanics
def test_handoff_queue_bound_gives_backpressure_like_the_reference(pkgs):
    """Bound 1: the prefill worker stalls until the decode worker adopts,
    everything finishes and nothing leaks; per step the queue depth and
    each worker's rows follow the reference's."""
    prompts = _prompts((3, 6, 4, 8, 5), seed=4)

    def run(pkg):
        rt = _fleet(pkg, p=1, d=1, handoff_queue=1)
        reqs = [rt.submit(p, max_new_tokens=3) for p in prompts]
        trace = []
        while not rt.idle:
            rt.step()
            trace.append((len(rt._handoff), len(rt.prefills[0]._pending),
                          len(rt.prefills[0]._queue),
                          len(rt.decodes[0]._active)))
        assert [r.output_ids for r in reqs] == \
            [_ref(pkg, p, 3) for p in prompts]
        return {"trace": trace, "states": [r.state for r in reqs],
                "leaked": _leaked_per_pool(rt), "stats": _norm(rt.stats())}

    obs = _both(pkgs, run)
    assert obs["states"] == ["done"] * len(prompts)
    assert all(lk == 1 for lk in obs["leaked"])
    assert obs["stats"]["handoff_queued"] == 0
    # exports waited behind the full queue
    assert max(t[1] for t in obs["trace"]) >= 1


def test_handoff_queue_validates_and_orders_like_the_reference(pkgs):
    def run(pkg):
        q = pkg.Queue(2)
        seen = [q.room, len(q), q.put("a"), q.put("b"), q.put("c"),
                q.take()]
        q.put_back("a")
        seen += [q.take(), q.take(), q.take(), q.room]
        q.put("x")
        q.put("y")
        seen += [q.take(lambda it: it == "y"), q.take()]
        with pytest.raises(ValueError):
            pkg.Queue(0)
        return seen

    assert _both(pkgs, run) == [2, 0, True, True, False, "a", "a", "b",
                                None, 2, "y", "x"]


def test_decode_engine_rejects_direct_submissions_like_the_reference(pkgs):
    def run(pkg):
        rt = _fleet(pkg, p=1, d=1)
        with pytest.raises(RuntimeError, match="DisaggRouter"):
            rt.decodes[0].submit([1, 2, 3], max_new_tokens=2)
        return isinstance(rt.decodes[0], pkg.DecodeEngine)

    assert _both(pkgs, run)


def test_disagg_flag_parsing_and_validation_like_the_reference(pkgs):
    def run(pkg):
        out = [pkg.parse("2x3"), pkg.parse(""), pkg.parse(" 1X2 ")]
        for bad in ("2x", "0x1", "axb"):
            with pytest.raises(ValueError):
                pkg.parse(bad)
        with pytest.raises(ValueError):
            _fleet(pkg, p=0, d=1)
        with _flags(pkg, {"serving_disagg": "3x2"}):
            rt = pkg.Disagg(pkg.model, **SHAPE, **pkg.kw)
            out.append((len(rt.prefills), len(rt.decodes)))
        rt = pkg.Disagg(pkg.model, **SHAPE, **pkg.kw)
        out.append((len(rt.prefills), len(rt.decodes),
                    rt.prefix_affinity, rt._handoff.bound))
        return out

    assert _both(pkgs, run) == [(2, 3), None, (1, 2), (3, 2),
                                (1, 1, True, 16)]


def test_disagg_background_thread_and_results_like_the_reference(pkgs):
    prompts = _prompts((3, 5, 4, 6), seed=5)

    def run(pkg):
        rt = _fleet(pkg, p=1, d=2)
        rt.start()
        try:
            reqs = [rt.submit(p, max_new_tokens=3) for p in prompts]
            done = rt.results(reqs, timeout=60)
            every = rt.results(timeout=60)
        finally:
            rt.stop()
        return {"states": [r.state for r in done],
                "tokens": [r.output_ids for r in done],
                "ids": [r.id for r in every] == [r.id for r in reqs],
                "leaked": _leaked_per_pool(rt)}

    obs = _both(pkgs, run)
    assert obs["states"] == ["done"] * 4 and obs["ids"]
    assert all(len(t) == len(p) + 3 for t, p in zip(obs["tokens"], prompts))


def test_disagg_drain_sheds_new_finishes_queued_like_the_reference(pkgs):
    def run(pkg):
        rt = _fleet(pkg, p=1, d=1)
        reqs = [rt.submit(p, max_new_tokens=3)
                for p in _prompts((3, 6, 4), seed=6)]
        shed = rt.drain()
        with pytest.raises(pkg.QueueFullError) as e:
            rt.submit([1, 2], max_new_tokens=2)
        return {"states": [r.state for r in reqs], "shed": shed,
                "reason": e.value.reason,
                "draining": rt.stats()["draining"],
                "counters": _stats(pkg, ["STAT_serving_drained"])}

    obs = _both(pkgs, run)
    assert obs["states"] == ["done"] * 3 and obs["draining"] is True
    assert obs["reason"] == "drain"


# --------------------------------------------------------------- chaos
def test_chaos_kill_prefill_worker_mid_handoff_like_the_reference(pkgs):
    """A prefill worker killed with work queued, admitted and exported:
    the same survivors, sheds and re-routes, every block reference
    released on every pool (the dead worker's included), completed +
    shed == offered."""
    prompts = _prompts((3, 7, 5, 11, 4, 9, 6, 8, 10, 5), seed=7)

    def run(pkg):
        rt = _fleet(pkg, p=2, d=2, colocate=False, max_queue=8)
        reqs = [rt.submit(p, max_new_tokens=4) for p in prompts]
        rt.step()
        info = rt.kill_prefill_worker(0)
        rt.run_until_idle()
        done = [r for r in reqs if r.state == "done"]
        for r in done:
            assert r.output_ids == _ref(pkg, prompts[reqs.index(r)], 4)
        ids = [r.id for r in rt.results()]
        return {"info": info, "states": [r.state for r in reqs],
                "reasons": [r.shed_reason for r in reqs],
                "leaked": _leaked_per_pool(rt), "stats": _norm(rt.stats()),
                "unique_results": len(ids) == len(set(ids)) == len(prompts),
                "counters": _stats(pkg)}

    obs = _both(pkgs, run)
    states = obs["states"]
    assert obs["info"]["prefills_left"] == 1 and "done" in states
    assert states.count("done") + states.count("shed") == len(prompts)
    assert all(lk == 1 for lk in obs["leaked"]) and obs["unique_results"]
    assert obs["stats"]["completed"] == states.count("done")
    assert obs["stats"]["shed_total"] == states.count("shed")
    assert obs["counters"]["STAT_serving_worker_killed"] == 1


def test_chaos_handoff_fault_skip_sheds_cleanly_like_the_reference(pkgs):
    """``serving.handoff:skip``: the same requests shed (reason "fault")
    with their blocks released, the rest token-identical."""
    prompts = _prompts((3, 7, 5, 11, 4, 9, 6, 8), seed=8)

    def run(pkg):
        rt = _fleet(pkg, p=1, d=2, colocate=False, prefix_cache=False)
        with pkg.fault_scope("serving.handoff:skip@0.4", seed=9):
            reqs = [rt.submit(p, max_new_tokens=4) for p in prompts]
            rt.run_until_idle()
        for r in reqs:
            if r.state == "done":
                assert r.output_ids == _ref(pkg, prompts[reqs.index(r)], 4)
        return {"states": [r.state for r in reqs],
                "reasons": [r.shed_reason for r in reqs],
                "leaked": _leaked_per_pool(rt), "counters": _stats(pkg)}

    obs = _both(pkgs, run)
    shed = obs["states"].count("shed")
    assert 0 < shed < len(prompts)
    assert set(obs["reasons"]) == {None, "fault"}
    assert obs["counters"]["STAT_fault_serving.handoff"] >= shed
    assert all(lk == 1 for lk in obs["leaked"])


def test_chaos_handoff_drop_is_retried_like_the_reference(pkgs):
    def run(pkg):
        with _flags(pkg, {"retry_max_attempts": 4,
                          "retry_base_delay": 0.001,
                          "retry_max_delay": 0.01}):
            rt = _fleet(pkg, p=1, d=1, prefix_cache=False)
            with pkg.fault_scope("serving.handoff:drop@0.5", seed=10):
                reqs = [rt.submit(p, max_new_tokens=3)
                        for p in _prompts((3, 6, 4, 7), seed=11)]
                rt.run_until_idle()
        return {"states": [r.state for r in reqs],
                "tokens": [r.output_ids for r in reqs],
                "leaked": _leaked_per_pool(rt), "counters": _stats(pkg)}

    obs = _both(pkgs, run)
    assert obs["states"] == ["done"] * 4
    assert obs["counters"]["STAT_fault_serving.handoff"] > 0
    assert obs["counters"]["STAT_retry_serving.handoff"] > 0
    assert all(lk == 1 for lk in obs["leaked"])


@pytest.mark.parametrize("colocate", [True, False],
                         ids=["colocated", "split-pools"])
def test_chaos_kill_decode_worker_rehomes_inflight_like_the_reference(
        pkgs, colocate):
    """A decode worker killed holding adopted rows: every row re-homes
    (a splice co-located, an ``adopt_row`` copy across pools) and
    finishes token-identical to the unkilled run."""
    prompts = _prompts((3, 7), seed=40)

    def run(pkg):
        rt = _fleet(pkg, p=1, d=2, colocate=colocate, prefix_cache=False)
        reqs = [rt.submit(p, max_new_tokens=6) for p in prompts]
        rt.step()
        rt.step()
        active = len(rt.decodes[0]._active)
        info = rt.kill_decode_worker(0)
        rt.run_until_idle()
        assert [r.output_ids for r in reqs] == \
            [_ref(pkg, p, 6) for p in prompts]
        ids = [r.id for r in rt.results()]
        return {"active": active, "info": info,
                "rehomed": [r.rehomed for r in reqs],
                "states": [r.state for r in reqs],
                "leaked": _leaked_per_pool(rt), "stats": _norm(rt.stats()),
                "unique_results": len(ids) == len(set(ids)) == len(prompts),
                "counters": _stats(pkg)}

    obs = _both(pkgs, run)
    assert obs["active"] == 2 and obs["info"] == {
        "rehomed": 2, "shed": 0, "decodes_left": 1}
    assert obs["rehomed"] == [True, True]
    assert all(lk == 1 for lk in obs["leaked"]) and obs["unique_results"]
    assert obs["stats"]["rehomed"] == 2
    assert obs["counters"]["STAT_serving_rehomed"] == 2
    if not colocate:
        assert obs["stats"]["handoffs_copied"] >= 2


def test_kill_decode_worker_validates_like_the_reference(pkgs):
    def run(pkg):
        rt = _fleet(pkg, p=1, d=2)
        with pytest.raises(IndexError):
            rt.kill_decode_worker(7)
        with pytest.raises(IndexError):
            rt.kill_prefill_worker(3)
        info = rt.kill_decode_worker(1)
        with pytest.raises(ValueError):
            rt.kill_decode_worker(0)
        req = rt.submit([1, 2, 3], max_new_tokens=2)
        rt.run_until_idle()
        return info, req.output_ids, _leaked_per_pool(rt)

    info, _, leaked = _both(pkgs, run)
    assert info == {"rehomed": 0, "shed": 0, "decodes_left": 1}
    assert leaked == [1]


def test_handoff_expired_deadline_shed_not_adopted_like_the_reference(pkgs):
    """A record that outlives its TTFT deadline in the queue is shed at
    adoption (reason "deadline"), its references released."""
    def run(pkg):
        vc = VirtualClock()
        rt = _fleet(pkg, p=1, d=1, colocate=False, clock=vc.now,
                    prefix_cache=False, slo_ttft_ms=50.0,
                    slo_prefill_ms=1.0, slo_tpot_ms=1.0)
        req = rt.submit(_prompts((5,), seed=41)[0], max_new_tokens=4)
        for _ in range(20):
            if rt.prefills[0].step() and len(rt._handoff) > 0:
                break
        queued = len(rt._handoff)
        vc.advance(1.0)
        rt.run_until_idle()
        return {"queued": queued, "state": req.state,
                "reason": req.shed_reason, "shed": rt.stats()["shed"],
                "leaked": _leaked_per_pool(rt)}

    obs = _both(pkgs, run)
    assert obs["queued"] == 1 and obs["state"] == "shed"
    assert obs["reason"] == "deadline" and obs["shed"] == {"deadline": 1}
    assert obs["leaked"] == [1, 1]


# ------------------------------------------- the handoff, block by block
def _jax_layers(arrays, kv):
    dt = {"f32": jnp.float32, "bf16": jnp.bfloat16, "int8": jnp.int8}[kv]
    out = []
    for layer in arrays:
        k, v = (jnp.asarray(a).astype(dt) for a in layer[:2])
        out.append((k, v) + tuple(jnp.asarray(a) for a in layer[2:]))
    return out


def _port_fill(cache, arrays):
    with torch.no_grad():
        for dst_layer, layer in zip(cache.layers, arrays):
            for dst, a in zip(dst_layer, layer):
                dst.copy_(torch.from_numpy(a).to(dst.dtype))


def _as_f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


@pytest.mark.parametrize("kv", ["f32", "bf16", "int8"])
def test_handoff_rows_like_the_reference(kv):
    """``export_row`` / ``import_row`` / ``adopt_row`` in both packages on
    pools holding the same values: the same tables, lengths, refcounts,
    free lists and records; the committed blocks copied bit for bit (the
    int8 codes and scales too; a reclaimed block's stale scale zeroed
    first) and nothing else of the destination pool moved."""
    rng = np.random.RandomState({"f32": 1, "bf16": 2, "int8": 3}[kv])
    geo = dict(num_layers=2, num_heads=2, head_dim=3, max_slots=2,
               max_len=16, block_size=4, num_blocks=9, kv_dtype=kv)

    def values():
        out = []
        for _ in range(2):
            if kv == "int8":
                out.append((rng.randint(-127, 128, (9, 2, 4, 3)).astype(
                    np.int8), rng.randint(-127, 128, (9, 2, 4, 3)).astype(
                    np.int8), rng.rand(9, 2).astype(np.float32),
                    rng.rand(9, 2).astype(np.float32)))
            else:
                out.append(tuple(rng.randn(9, 2, 4, 3).astype(np.float32)
                                 for _ in range(2)))
        return out

    src_vals, dst_vals = values(), values()
    seen = []
    for side in ("jax", "port"):
        Cache = JBlockKVCache if side == "jax" else BlockKVCache
        src, dst = Cache(**geo), Cache(**geo)
        if side == "jax":
            src.layers = _jax_layers(src_vals, kv)
            dst.layers = _jax_layers(dst_vals, kv)
        else:
            _port_fill(src, src_vals)
            _port_fill(dst, dst_vals)
        row, _ = src.acquire([5, 6, 7, 8, 9, 10], need=10)
        src.commit_prefill(row, 6)
        # a block taken and freed on the destination, so adopt_row
        # reclaims it (its stale int8 scale must not survive)
        other, _ = dst.acquire([1, 2, 3], need=4)
        dst.release_row(other)
        rec = src.export_row(row)
        out = {"rec": (rec["blocks"], rec["length"]),
               "src_rows": list(src._free_rows),
               "src_ref": src.allocator.refcount.tolist()}
        dst_row = dst.adopt_row(rec)
        rec["pool"].release_blocks(rec["blocks"])
        out.update(dst_row=dst_row, table=dst.tables[dst_row].tolist(),
                   length=int(dst.lengths[dst_row]),
                   dst_ref=dst.allocator.refcount.tolist(),
                   src_ref_after=src.allocator.refcount.tolist(),
                   src_leaked=src.allocator.leaked(),
                   dst_pool=[[_as_f32(a).tolist() for a in layer]
                             for layer in dst.layers])
        blocks = dst.tables[dst_row, :2].tolist()
        for layer, src_layer in zip(dst.layers, src.layers):
            for a, sa in zip(layer, src_layer):
                for d, s in zip(blocks, rec["blocks"][:2]):
                    assert np.array_equal(_as_f32(a)[d], _as_f32(sa)[s])
            if kv == "int8":
                third = int(dst.tables[dst_row, 2])
                assert not _as_f32(layer[2])[third].any()
        # a same-pool record splices back without moving a reference
        rec2 = dst.export_row(dst_row)
        ref_before = dst.allocator.refcount.tolist()
        row3 = dst.import_row(rec2)
        out.update(spliced=(row3, dst.tables[row3].tolist(),
                            int(dst.lengths[row3])),
                   splice_refs=dst.allocator.refcount.tolist() == ref_before)
        seen.append(out)
    assert seen[1] == seen[0]
    assert seen[0]["rec"] == ([1, 2, 3], 6) and seen[0]["splice_refs"]
    assert seen[0]["src_leaked"] == 1


def test_handoff_errors_like_the_reference():
    """The refusals and the all-or-nothing paths in both packages: a
    foreign record through ``import_row``, a same-pool one through
    ``adopt_row``, another geometry or KV dtype, too many blocks for a
    row; no free row or too few blocks give None with the record's and
    the destination's references untouched; a shared pool's geometry."""
    geo = dict(num_layers=1, num_heads=2, head_dim=3, max_slots=1,
               max_len=8, block_size=4, num_blocks=3)
    seen = []
    for Cache in (JBlockKVCache, BlockKVCache):
        a, b = Cache(**geo), Cache(**geo)
        row, _ = a.acquire([1, 2, 3, 4, 5], need=8)
        a.commit_prefill(row, 5)
        rec = a.export_row(row)
        out = []
        with pytest.raises(ValueError, match="same BlockPool"):
            b.import_row(rec)
        with pytest.raises(ValueError, match="cross-pool"):
            a.adopt_row(rec)
        for other in (dict(geo, kv_dtype="bf16"), dict(geo, head_dim=4)):
            with pytest.raises(ValueError, match="geometry"):
                Cache(**other).adopt_row(rec)
        small = Cache(**dict(geo, max_len=4, num_blocks=4))
        with pytest.raises(ValueError, match="blocks_per_row"):
            small.adopt_row(rec)
        b.acquire([7], need=1)                 # b's only row taken
        out.append(b.adopt_row(rec))
        full = Cache(**dict(geo, max_slots=2, num_blocks=3))
        full.acquire([7], need=4)              # 1 of 2 usable blocks left
        out.append(full.adopt_row(rec))
        out += [a.allocator.refcount.tolist(),
                full.allocator.refcount.tolist(), list(full._free_rows)]
        a.import_row(rec)
        with pytest.raises(ValueError, match="block_size"):
            Cache(**dict(geo, block_size=2), pool=a.pool)
        with pytest.raises(ValueError, match="heads"):
            Cache(**dict(geo, num_heads=1), pool=a.pool)
        shared = Cache(**dict(geo, num_blocks=0), pool=a.pool)
        out.append((shared.pool is a.pool, shared.blocks_per_row,
                    shared.match_prefix_blocks([1, 2, 3, 4, 5])))
        seen.append(out)
    assert seen[1] == seen[0]
    assert seen[0][:2] == [None, None]


def test_engine_shares_a_pool_like_the_reference(pkgs):
    """``ServingEngine(kv_pool=)``: the geometry and KV dtype come from
    the pool; with the dense cache it is refused."""
    def run(pkg):
        owner = pkg.Engine(pkg.model, **SHAPE, kv_dtype="int8", **pkg.kw)
        eng = pkg.Engine(pkg.model, max_slots=3, max_len=32,
                         buckets=[8, 16], kv_pool=owner.cache.pool,
                         **pkg.kw)
        with pytest.raises(ValueError, match="paged"):
            pkg.Engine(pkg.model, max_slots=2, max_len=32, buckets=[8, 16],
                       paged=False, kv_pool=owner.cache.pool, **pkg.kw)
        req = eng.submit([3, 4, 5, 6, 7], max_new_tokens=3)
        eng.run_until_idle()
        return (eng.cache.pool is owner.cache.pool, eng.kv_dtype,
                eng.cache.block_size, eng.cache.num_free,
                owner.cache.blocks_used, req.output_ids)

    obs = _both(pkgs, run)
    assert obs[:3] == (True, "int8", 4)


# ------------------------------------------------ traces, sampling, cancel
def test_one_trace_across_a_decode_worker_kill_like_the_reference(pkgs):
    """The export and adopt marks, then the kill and the re-adoption, on
    one trace per request with handoff and re-home blame; the exports
    equal the reference's byte for byte."""
    prompts = _prompts((3, 7), seed=3)

    def run(pkg):
        clk = {"t": 0.0}
        rt = _fleet(pkg, p=1, d=2, prefix_cache=False,
                    clock=lambda: clk["t"])
        reqs = [rt.submit(p, max_new_tokens=6) for p in prompts]
        for _ in range(2):
            rt.step()
            clk["t"] += 0.004
        assert rt.kill_decode_worker(0)["rehomed"] == 2
        while not rt.idle:
            rt.step()
            clk["t"] += 0.004
        out = []
        for r in reqs:
            info = pkg.tracing.get(r.id)
            kinds = [m["kind"] for m in info["marks"]]
            assert {"export", "adopt", "kill"} <= set(kinds), kinds
            assert {"handoff", "rehome"} <= set(info["blame_ms"])
            assert sum(info["blame_ms"].values()) == \
                pytest.approx(info["e2e_ms"], abs=1e-6)
            out.append((kinds, info["blame_ms"], info["outcome"]))
        tr = pkg.tracing
        return {"traces": out, "chrome": json.dumps(
            tr.export_chrome_trace(), sort_keys=True),
            "spans": tr.export_spans_jsonl(),
            "blame": tr.blame_summary()}

    _both(pkgs, run)


@pytest.mark.parametrize("colocate", [True, False],
                         ids=["colocated", "cross-pool"])
def test_sampled_requests_cross_the_roles_like_the_reference(pkgs, colocate):
    """Seeded sampled requests through a 1 x 2 fleet decode the same
    bytes as one engine and as the reference's fleet: the key travels on
    the request."""
    prompts = _prompts((4, 6, 5, 7), seed=3)

    def run(pkg):
        eng = pkg.Engine(pkg.model, **SHAPE, **pkg.kw)
        rt = _fleet(pkg, p=1, d=2, colocate=colocate)
        out = []
        for target in (eng, rt):
            reqs = [target.submit(p, max_new_tokens=5, seed=21, **SAMPLED)
                    for p in prompts]
            target.run_until_idle()
            out.append([r.output_ids for r in reqs])
        assert out[0] == out[1]
        return out[1], _leaked_per_pool(rt)

    toks, leaked = _both(pkgs, run)
    assert leaked == ([1] if colocate else [1, 1, 1])


def test_cancel_at_every_stage_like_the_reference(pkgs):
    """A fleet-wide cancel finds the request queued on a prefill worker,
    staged for export behind a full queue, in the handoff queue, and
    mid-decode: the same stages and outcomes, every reference released,
    a second cancel a no-op."""
    prompts = _prompts((3, 5, 4, 6, 7), seed=12)

    def run(pkg):
        rt = _fleet(pkg, p=1, d=1, handoff_queue=1)
        reqs = [rt.submit(p, max_new_tokens=4) for p in prompts]
        stages = []
        # reqs[0] and reqs[1] admitted; reqs[0] exported into the queue,
        # reqs[1] staged behind it (the queue holds 1)
        rt.prefills[0].step()
        stages.append(rt.cancel(reqs[0].id))     # in the handoff queue
        stages.append(rt.cancel(reqs[1].id))     # staged for export
        stages.append(rt.cancel(reqs[4].id))     # queued
        rt.step()
        rt.step()
        stages.append(rt.cancel(reqs[2].id))     # mid-decode or staged
        stages.append(rt.cancel(reqs[2].id))     # a no-op
        rt.run_until_idle()
        index = {r.id: i for i, r in enumerate(reqs)}
        stages = [s and {**s, "id": index[s["id"]]} for s in stages]
        return {"stages": stages,
                "states": [(r.state, r.shed_reason) for r in reqs],
                "leaked": _leaked_per_pool(rt),
                "canceled": rt.stats()["canceled"],
                "counters": _stats(pkg)}

    obs = _both(pkgs, run)
    assert [s and s["stage"] for s in obs["stages"][:3]] == \
        ["handoff", "handoff", "queued"]
    assert obs["stages"][4] is None and obs["leaked"] == [1]
    assert obs["canceled"] == {"client": 4}


@pytest.mark.parametrize("megastep", [1, 4])
def test_threaded_fleet_equals_serial_like_the_reference(pkgs, megastep):
    """Threaded dispatch (prefill in parallel, adoption serially, decode
    grouped by pool) gives the serial fleet's tokens, colocated and
    across pools, with megastep decode workers too."""
    prompts = _prompts((3, 7, 5, 9, 4, 6), seed=8)

    def run(pkg):
        out = {}
        for colocate in (True, False):
            for threads in (0, 2):
                rt = _fleet(pkg, p=2, d=2, colocate=colocate,
                            dispatch_threads=threads, megastep=megastep,
                            max_queue=32)
                try:
                    reqs = [rt.submit(p, max_new_tokens=6) for p in prompts]
                    rt.run_until_idle()
                finally:
                    rt.stop()
                assert all(r.state == "done" for r in reqs)
                assert all(lk == 1 for lk in _leaked_per_pool(rt))
                out[(colocate, threads)] = [r.output_ids for r in reqs]
        assert len({json.dumps(v) for v in out.values()}) == 1
        return out[(True, 0)]

    _both(pkgs, run)


def test_kill_frees_a_private_pool_and_keeps_a_shared_one(pkgs):
    """The port's kill paths free a dead worker's device memory: its pool
    and the graphs over it when no live worker shares the pool, else only
    its sampling mask (the reference keeps every dead pool alive)."""
    _, port = pkgs
    prompts = _prompts((3, 7), seed=40)
    for colocate in (True, False):
        rt = _fleet(port, p=1, d=2, colocate=colocate, prefix_cache=False)
        reqs = [rt.submit(p, max_new_tokens=6, seed=3, **SAMPLED)
                for p in prompts]
        rt.step()
        rt.step()
        dead = rt.decodes[0]
        assert dead._mask is not None
        rt.kill_decode_worker(0)
        assert dead._mask is None
        assert (dead.cache.layers == []) is (not colocate)
        assert all(e.cache.layers for e in rt.engines)
        rt.run_until_idle()
        assert all(r.state == "done" for r in reqs)
        assert all(lk == 1 for lk in _leaked_per_pool(rt))


def test_refuses_lora_and_the_host_tier():
    """What a fleet refuses of LoRA and the host KV tier, as the
    reference does: adapter calls on a fleet without a pool, an unknown
    adapter, a tier of another geometry, a grammar row; and dispatch-ahead
    decode workers, which it takes now (tests/test_torch_megastep.py
    runs them). (LoRA tenants and the host tier themselves:
    tests/test_torch_lora.py, tests/test_torch_kv_tier.py.)"""
    from paddle_tpu_torch.serving import HostBlockStore, TierManager
    model = GPTForCausalLM(GPTConfig(**GEOM), device="cpu").eval()
    rt = DisaggRouter(model, n_prefill=1, n_decode=1, **SHAPE, device="cpu")
    for call in (lambda: rt.load_adapter("acme", {}),
                 lambda: rt.evict_adapter("acme")):
        with pytest.raises(ValueError, match="no LoRA pool"):
            call()
    lrt = DisaggRouter(model, n_prefill=1, n_decode=1, lora_rank=2, **SHAPE,
                       device="cpu")
    assert lrt.prefills[0].lora_pool is lrt.decodes[0].lora_pool
    with pytest.raises(ValueError, match="unknown lora adapter"):
        lrt.evict_adapter("acme")
    with pytest.raises(ValueError, match="tenant"):
        rt.submit([1, 2, 3], tenant="acme")
    cfg = model.cfg
    other = TierManager(HostBlockStore(cfg.num_layers, cfg.num_heads,
                                       cfg.head_dim, block_size=8,
                                       num_blocks=4))
    with pytest.raises(ValueError, match="geometry"):
        DisaggRouter(model, n_prefill=1, n_decode=1, kv_tier=other,
                     **SHAPE, device="cpu")
    from paddle_tpu_torch.serving import DecodeParams
    with pytest.raises(ValueError, match="grammar"):
        rt.submit([1, 2, 3], decode=DecodeParams(json_mode=True))
    ahead = DisaggRouter(model, n_prefill=1, n_decode=1, megastep=2,
                         dispatch_ahead=True, **SHAPE, device="cpu")
    assert all(e.dispatch_ahead for e in ahead.engines)
