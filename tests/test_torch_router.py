"""The port's ReplicaRouter against ``paddle_tpu.serving.ReplicaRouter`` on
the CPU: each scenario runs once per package on the same weights (carried
across by ``gpt_state_from_numpy``) and prompts, and what it observes
(tokens, placements, health and breaker states per step, replica counts,
accounting, STAT counters) must be equal:

- routing, least-loaded placement, shedding when every replica is full,
  ``drain`` and ``drain_replica`` re-homing;
- ``kill_replica`` with greedy and seeded sampled requests in flight
  (f32; int8 with spec K 2; megastep 4): the threefry stream is bit-equal,
  so sampled tokens match too; ``restart_replica`` on a sole replica;
- the strike watchdog and the breaker under injected ``serving.step``
  skips, and a replica whose step raises;
- ``AutoscalePolicy`` decisions; rolling ``swap_weights``; ``stats()``
  keys;
- the chaos runs of ``tests/test_serving_router.py`` (``serving.route``
  skip, drop, exhaustion; ``serving.replica`` crash and skip);
- the port's threaded dispatch and ``start``/``results(timeout=)``,
  token-equal to the serial fleet.

Every pool ends holding only its trash block once its prefix cache is
flushed (``leaked() == 1``). The model is the small GPT of
``tests/test_serving_router.py`` (vocab 97, h 32, 2 layers, 4 heads)
drawn at ``init_std`` 0.2, whose greedy tokens vary; engines run on a
frozen clock, so a breaker's cooldown never depends on how long a step
took. The JAX side runs with 64-bit types off.
"""

import torch_threads  # noqa: F401  (one worker's share of the cores)
import contextlib
from types import SimpleNamespace

import jax
import numpy as np
import pytest

import paddle_tpu as pt
from paddle_tpu import monitor as jmonitor
from paddle_tpu.models.gpt import GPTConfig as JGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JGPT
from paddle_tpu.resilience import fault_scope as jfault_scope
from paddle_tpu.resilience import reset_default_budget as jreset_budget
from paddle_tpu.serving import AutoscalePolicy as JAutoscalePolicy
from paddle_tpu.serving import QueueFullError as JQueueFullError
from paddle_tpu.serving import ReplicaRouter as JReplicaRouter
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch import monitor as tmonitor
from paddle_tpu_torch.models.convert import gpt_state_from_numpy
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.resilience import fault_scope as tfault_scope
from paddle_tpu_torch.resilience import reset_default_budget as treset_budget
from paddle_tpu_torch.serving import (AutoscalePolicy, QueueFullError,
                                      ReplicaRouter)

GEOM = dict(vocab_size=97, max_position_embeddings=64, hidden_size=32,
            num_layers=2, num_heads=4, ffn_hidden_size=64, init_std=0.2)
SAMPLED = dict(temperature=0.8, top_k=20, top_p=0.9)
FAST_RETRY = {"retry_base_delay": 0.001, "retry_max_delay": 0.01}


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
    common = dict(arrays=arrays)
    jax_side = SimpleNamespace(
        name="jax", model=jm, Router=JReplicaRouter, Policy=JAutoscalePolicy,
        QueueFullError=JQueueFullError, fault_scope=jfault_scope,
        monitor=jmonitor, flags=pt, reset_budget=jreset_budget,
        kw={}, **common)
    port = SimpleNamespace(
        name="port", model=tm, Router=ReplicaRouter, Policy=AutoscalePolicy,
        QueueFullError=QueueFullError, fault_scope=tfault_scope,
        monitor=tmonitor, flags=tflags, reset_budget=treset_budget,
        kw={"device": "cpu"}, **common)
    return jax_side, port


def _prompts(sizes, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, 97, size=n).tolist() for n in sizes]


def _router(pkg, n=2, **kw):
    for k, v in dict(max_slots=2, max_len=32, buckets=[8, 16], max_queue=16,
                     block_size=4, clock=lambda: 0.0).items():
        kw.setdefault(k, v)
    return pkg.Router(pkg.model, n_replicas=n, **kw, **pkg.kw)


@contextlib.contextmanager
def _flags(pkg, values):
    saved = pkg.flags.get_flags(list(values))
    pkg.flags.set_flags(values)
    try:
        yield
    finally:
        pkg.flags.set_flags(saved)


def _no_leaks(rt):
    """Every pool, the retiring ones included, holds only its trash
    block once its prefix cache is flushed."""
    for eng in rt.engines + rt._retiring:
        eng.cache.flush_prefix_cache()
        assert eng.cache.allocator.leaked() == 1


def _both(pkgs, scenario):
    """Run ``scenario(pkg)`` on each package from a reset monitor and
    retry budget; its observations must be equal."""
    out = []
    for pkg in pkgs:
        pkg.monitor.reset()
        pkg.reset_budget()
        out.append(scenario(pkg))
    assert out[1] == out[0]
    return out[0]


def _stats(pkg, names):
    return {n: pkg.monitor.stat_get(n) for n in names}


def test_routes_like_jax(pkgs):
    """6 requests over 2 replicas: the same placement and tokens."""
    prompts = _prompts((3, 7, 5, 11, 4, 9), seed=1)

    def run(pkg):
        rt = _router(pkg)
        reqs = [rt.submit(p, max_new_tokens=5) for p in prompts]
        rt.run_until_idle()
        _no_leaks(rt)
        return {"placement": [len(e._all) for e in rt.engines],
                "tokens": [r.output_ids for r in reqs],
                "states": [r.state for r in reqs],
                "stats": _stats(pkg, ["STAT_serving_routed",
                                      "STAT_serving_tokens",
                                      "STAT_serving_completed"])}

    obs = _both(pkgs, run)
    assert all(n > 0 for n in obs["placement"])
    assert len(set(map(tuple, obs["tokens"]))) > 1


def test_least_loaded_and_health_rank(pkgs):
    def run(pkg):
        rt = _router(pkg)
        for p in _prompts((3, 5), seed=2):
            rt.engines[0].submit(p, max_new_tokens=2)
        a = rt.submit(_prompts((4,), seed=3)[0], max_new_tokens=2)
        rt.engines[1]._health = "suspect"
        b = rt.submit(_prompts((6,), seed=4)[0], max_new_tokens=2)
        rt.engines[1]._health = "healthy"
        rt.engines[0].draining = True
        c = rt.submit(_prompts((5,), seed=5)[0], max_new_tokens=2)
        rt.engines[0].draining = False
        rt.run_until_idle()
        _no_leaks(rt)
        return [[r in e._all for e in rt.engines] for r in (a, b, c)]

    assert _both(pkgs, run) == [[False, True], [True, False],
                                [False, True]]


def test_sheds_when_every_replica_is_full_and_drains(pkgs):
    def run(pkg):
        rt = _router(pkg, max_slots=1, max_queue=1)
        for p in _prompts((3, 4), seed=5):
            rt.submit(p, max_new_tokens=2)
        with pytest.raises(pkg.QueueFullError) as full:
            rt.submit([1, 2, 3], max_new_tokens=2)
        shed = rt.drain()
        with pytest.raises(pkg.QueueFullError) as drained:
            rt.submit([1, 2], max_new_tokens=2)
        st = rt.stats()
        _no_leaks(rt)
        return {"reasons": (full.value.reason, drained.value.reason),
                "shed": shed, "draining": st["draining"],
                "completed": st["completed"], "engine_shed": st["shed"],
                "stats": _stats(pkg, ["STAT_serving_route_shed",
                                      "STAT_serving_routed",
                                      "STAT_serving_drained",
                                      "STAT_serving_rejected"])}

    obs = _both(pkgs, run)
    assert obs["reasons"] == ("queue_full", "drain")
    assert obs["stats"]["STAT_serving_route_shed"] == 1


def test_drain_replica_rehomes_queued_requests(pkgs):
    prompts = _prompts((3, 6, 4, 7), seed=20)

    def run(pkg):
        rt = _router(pkg)
        reqs = [rt.engines[0].submit(p, max_new_tokens=3) for p in prompts]
        moved = rt.drain_replica(0)
        rt.run_until_idle()
        ids = [r.id for r in rt.results()]
        with pytest.raises(ValueError):
            rt.drain_replica(0)
        with pytest.raises(IndexError):
            rt.drain_replica(5)
        _no_leaks(rt)
        return {"moved": moved, "tokens": [r.output_ids for r in reqs],
                "unique": len(ids) == len(set(ids)) == len(prompts),
                "rerouted": pkg.monitor.stat_get("STAT_serving_rerouted")}

    obs = _both(pkgs, run)
    assert obs["moved"] == 4 and obs["unique"]


@pytest.mark.parametrize("geometry", [
    {}, {"kv_dtype": "int8", "spec_tokens": 2}, {"megastep": 4}],
    ids=["f32", "int8-spec2", "megastep4"])
def test_kill_replica_rehomes_inflight_greedy_and_sampled(pkgs, geometry):
    """Kill the replica holding every request mid-decode: greedy and
    seeded sampled requests re-home with their committed tokens and keys
    and finish with the JAX router's tokens."""
    prompts = _prompts((3, 7, 5, 6), seed=30)

    def run(pkg):
        rt = _router(pkg, prefix_cache=False, **geometry)
        reqs = [rt.engines[0].submit(p, max_new_tokens=8,
                                     **(dict(SAMPLED, seed=40 + i)
                                        if i % 2 else {}))
                for i, p in enumerate(prompts)]
        for _ in range(1 if geometry.get("megastep") else 2):
            rt.engines[0].step()
        inflight = [len(r.tokens) for r in reqs]
        info = rt.kill_replica(0)
        rt.run_until_idle()
        ids = [r.id for r in rt.results()]
        _no_leaks(rt)
        st = rt.stats()
        return {"info": info, "inflight": inflight,
                "tokens": [r.output_ids for r in reqs],
                "rehomed": [r.rehomed for r in reqs],
                "unique": len(ids) == len(set(ids)) == len(prompts),
                "kills": st["kills"], "st_rehomed": st["rehomed"],
                "stats": _stats(pkg, ["STAT_serving_rehomed",
                                      "STAT_serving_replica_killed"])}

    obs = _both(pkgs, run)
    assert obs["info"]["rehomed"] == sum(n < 8 for n in obs["inflight"])
    assert obs["unique"] and any(0 < n < 8 for n in obs["inflight"])


def test_restart_replica_on_sole_replica(pkgs):
    prompts = _prompts((3, 6), seed=31)

    def run(pkg):
        rt = _router(pkg, n=1)
        reqs = [rt.submit(p, max_new_tokens=3) for p in prompts]
        info = rt.restart_replica(0)
        health = [rt.engines[0]._health]
        rt.run_until_idle()
        health.append(rt.engines[0]._health)
        st = rt.stats()
        _no_leaks(rt)
        return {"info": info, "health": health,
                "tokens": [r.output_ids for r in reqs],
                "counts": (st["kills"], st["restarts"], st["rehomed"]),
                "kill_validation": _kill_validation(pkg)}

    obs = _both(pkgs, run)
    assert obs["health"] == ["recovering", "healthy"]
    assert obs["counts"] == (1, 1, 2)


def _kill_validation(pkg):
    rt = _router(pkg, n=2)
    with pytest.raises(IndexError):
        rt.kill_replica(5)
    rt.kill_replica(0)
    with pytest.raises(ValueError):
        rt.kill_replica(0)
    rt.run_until_idle()
    _no_leaks(rt)
    return len(rt.engines)


@pytest.mark.parametrize("kind", ["skip", "error"])
def test_watchdog_and_breaker_under_injected_step_faults(pkgs, kind):
    """Injected ``serving.step`` faults: a skip stalls a decode, an error
    that outlasts the retries sheds the step's requests; a step that
    makes no progress while its replica holds work is a strike and a
    breaker failure. The health and breaker states of every replica
    after every router step equal JAX's, through the watchdog's
    restart, and so do the requests' ends."""
    spec = ";".join(f"serving.step:{kind}@{n}" for n in range(6, 16))
    prompts = _prompts((3, 5, 4, 6, 7, 5), seed=32)

    def run(pkg):
        with _flags(pkg, {"serving_replica_strikes": 3,
                          "serving_breaker_window": 4,
                          "retry_max_attempts": 2, **FAST_RETRY}):
            rt = _router(pkg, prefix_cache=False)
            reqs = [rt.submit(p, max_new_tokens=6) for p in prompts]
            seq = []
            with pkg.fault_scope(spec, seed=3):
                for _ in range(12):
                    rt.step()
                    seq.append([(e._health, e._brk_state, e._strikes)
                                for e in rt.engines])
            rt.run_until_idle()
            st = rt.stats()
            _no_leaks(rt)
        return {"seq": seq, "tokens": [r.output_ids for r in reqs],
                "states": [(r.state, r.shed_reason) for r in reqs],
                "counts": (st["kills"], st["restarts"], st["replicas"]),
                "breaker": st["breaker"], "shed": st["shed"],
                "faults": pkg.monitor.stat_get("STAT_fault_serving.step"),
                "retries": pkg.monitor.stat_get("STAT_retry_serving.step")}

    obs = _both(pkgs, run)
    flat = [h for step in obs["seq"] for h, _, _ in step]
    assert "suspect" in flat
    assert any(b == "open" for step in obs["seq"] for _, b, _ in step)
    if kind == "skip":
        assert obs["faults"] == 10 and obs["counts"][1] >= 1
    else:
        assert obs["shed"].get("fault", 0) > 0 and obs["retries"] > 0


def test_watchdog_restarts_a_replica_whose_step_raises(pkgs):
    def run(pkg):
        with _flags(pkg, {"serving_replica_strikes": 2}):
            rt = _router(pkg)
            sick = rt.engines[0]

            def boom():
                if sick in rt.engines:
                    raise RuntimeError("simulated wedged replica")
                return False

            sick.step = boom
            r = rt.submit(_prompts((4,), seed=32)[0], max_new_tokens=2)
            health = []
            for _ in range(2):
                rt.step()
                health.append([e._health for e in rt.engines])
            rt.run_until_idle()
            st = rt.stats()
            _no_leaks(rt)
        return {"health": health, "in_fleet": sick in rt.engines,
                "state": r.state, "tokens": r.output_ids,
                "counts": (st["restarts"], st["replicas"]),
                "health_after": st["health"]}

    obs = _both(pkgs, run)
    assert obs["health"][0][0] == "suspect" and not obs["in_fleet"]
    assert obs["counts"] == (1, 2)


def test_autoscale_decisions_match_jax(pkgs):
    prompts = _prompts((3, 5, 4, 6, 7, 3, 5, 4), seed=33)

    def run(pkg):
        policy = pkg.Policy(min_replicas=1, max_replicas=3, queue_high=2.0,
                            queue_low=1.0, cooldown_steps=1)
        rt = _router(pkg, n=1, autoscale=policy)
        reqs = [rt.submit(p, max_new_tokens=4) for p in prompts]
        sizes = []
        while not rt.idle:
            rt.step()
            sizes.append((len(rt.engines), len(rt._retiring)))
        st = rt.stats()["autoscale"]
        _no_leaks(rt)
        return {"sizes": sizes, "autoscale": st,
                "tokens": [r.output_ids for r in reqs]}

    obs = _both(pkgs, run)
    assert obs["autoscale"]["scale_ups"] >= 1
    with pytest.raises(ValueError):
        AutoscalePolicy(min_replicas=2, max_replicas=1)


def test_rolling_swap_weights_matches_a_fresh_fleet(pkgs):
    """Swap new weights into a serving fleet: versions per replica, and
    tokens afterwards equal to JAX's on the new weights."""
    prompts = _prompts((3, 6, 5), seed=34)
    rng = np.random.RandomState(35)
    new = {n: (a + rng.normal(0, 0.05, a.shape)).astype(np.float32)
           for n, a in pkgs[0].arrays.items()}

    def run(pkg):
        state = new if pkg.name == "jax" else {
            k: v for k, v in gpt_state_from_numpy(new, "cpu").items()}
        old = (pkg.arrays if pkg.name == "jax" else
               gpt_state_from_numpy(pkg.arrays, "cpu"))
        rt = _router(pkg)
        warm = rt.submit(prompts[0], max_new_tokens=2)
        rt.run_until_idle()
        versions = rt.swap_weights(state)
        reqs = [rt.submit(p, max_new_tokens=5) for p in prompts]
        rt.run_until_idle()
        rt.swap_weights(old)
        _no_leaks(rt)
        return {"versions": versions, "warm": warm.output_ids,
                "tokens": [r.output_ids for r in reqs]}

    obs = _both(pkgs, run)
    assert obs["versions"] == [1, 1]


def test_stats_keys_match_jax(pkgs):
    def run(pkg):
        with _flags(pkg, {"serving_dispatch_threads": 0}):
            rt = _router(pkg)
            rt.submit(_prompts((5,), seed=8)[0], max_new_tokens=2)
            before = rt.stats()
            rt.run_until_idle()
            st = rt.stats()
            _no_leaks(rt)
        return {"keys": sorted(k for k in st if k != "per_replica"),
                "depths": (before["queue_depths"], st["queue_depths"]),
                "values": {k: st[k] for k in (
                    "replicas", "draining", "mesh_shape", "health", "kills",
                    "completed", "shed", "canceled", "slo_attainment",
                    "breaker", "tenants")}}

    obs = _both(pkgs, run)
    assert "breaker" in obs["keys"] and sum(obs["depths"][0]) == 1


@pytest.mark.chaos
def test_chaos_route_skip_sheds_cleanly(pkgs):
    prompts = _prompts((3, 7, 5, 11, 4, 9, 6, 8), seed=10)

    def run(pkg):
        rt = _router(pkg, prefix_cache=False)
        out = []
        with pkg.fault_scope("serving.route:skip@0.4", seed=11):
            for p in prompts:
                try:
                    out.append(rt.submit(p, max_new_tokens=4))
                except pkg.QueueFullError as e:
                    out.append(e.reason)
        rt.run_until_idle()
        _no_leaks(rt)
        return {"out": [o if isinstance(o, str) else o.output_ids
                        for o in out],
                "stats": _stats(pkg, ["STAT_serving_route_shed",
                                      "STAT_fault_serving.route"])}

    obs = _both(pkgs, run)
    assert 0 < obs["out"].count("fault") < len(prompts)


@pytest.mark.chaos
@pytest.mark.parametrize("spec,attempts", [("serving.route:drop@0.5", 4),
                                           ("serving.route:drop", 2)],
                         ids=["retried", "exhausted"])
def test_chaos_route_drop_retries_or_sheds(pkgs, spec, attempts):
    prompts = _prompts((3, 6, 4, 7), seed=13)

    def run(pkg):
        with _flags(pkg, {"retry_max_attempts": attempts, **FAST_RETRY}):
            rt = _router(pkg, prefix_cache=False)
            out = []
            with pkg.fault_scope(spec, seed=12):
                for p in prompts:
                    try:
                        out.append(rt.submit(p, max_new_tokens=3))
                    except pkg.QueueFullError as e:
                        out.append(e.reason)
            rt.run_until_idle()
        _no_leaks(rt)
        return {"out": [o if isinstance(o, str) else o.output_ids
                        for o in out],
                "stats": _stats(pkg, ["STAT_serving_route_shed",
                                      "STAT_fault_serving.route",
                                      "STAT_retry_serving.route"])}

    obs = _both(pkgs, run)
    if attempts == 2:
        assert obs["out"] == ["fault"] * 4
    else:
        assert "fault" not in obs["out"]
        assert obs["stats"]["STAT_retry_serving.route"] > 0


@pytest.mark.chaos
@pytest.mark.parametrize("kind", ["error", "skip"])
def test_chaos_serving_replica_crash_and_skip(pkgs, kind):
    """``error`` at serving.replica crashes the round-robin victim and
    restarts it; ``skip`` kills without restart and never the last
    replica. In-flight work completes, with JAX's tokens."""
    spec = ("serving.replica:error@0" if kind == "error"
            else "serving.replica:skip")
    prompts = _prompts((3, 6, 4), seed=34)

    def run(pkg):
        rt = _router(pkg)
        reqs = [rt.submit(p, max_new_tokens=3) for p in prompts]
        with pkg.fault_scope(spec, seed=35):
            rt.step()
            rt.step()
        rt.run_until_idle()
        st = rt.stats()
        _no_leaks(rt)
        return {"tokens": [r.output_ids for r in reqs],
                "states": [r.state for r in reqs],
                "counts": (st["kills"], st["restarts"], st["replicas"]),
                "faults": pkg.monitor.stat_get("STAT_fault_serving.replica")}

    obs = _both(pkgs, run)
    assert obs["counts"] == ((1, 1, 2) if kind == "error" else (1, 0, 1))


@pytest.mark.chaos
def test_chaos_submit_and_alloc_skips_shed_like_jax(pkgs):
    """Engine fault sites through the router: ``serving.submit`` skips
    shed at admission (the router tries the next replica), and
    ``serving.alloc`` skips shed a request at block acquisition."""
    prompts = _prompts((3, 6, 4, 7, 5, 8), seed=36)
    spec = "serving.submit:skip@0.3;serving.alloc:skip@0.3"

    def run(pkg):
        rt = _router(pkg, prefix_cache=False)
        out = []
        with pkg.fault_scope(spec, seed=37):
            for p in prompts:
                try:
                    out.append(rt.submit(p, max_new_tokens=3))
                except pkg.QueueFullError as e:
                    out.append(e.reason)
            rt.run_until_idle()
        _no_leaks(rt)
        return {"out": [o if isinstance(o, str) else
                        (o.state, o.shed_reason, o.output_ids) for o in out],
                "shed": rt.stats()["shed"],
                "stats": _stats(pkg, ["STAT_serving_shed",
                                      "STAT_serving_rejected",
                                      "STAT_fault_serving.submit",
                                      "STAT_fault_serving.alloc"])}

    obs = _both(pkgs, run)
    assert obs["stats"]["STAT_fault_serving.alloc"] > 0
    assert obs["stats"]["STAT_fault_serving.submit"] > 0


def test_threaded_dispatch_and_background_threads_equal_serial(pkgs):
    """The port's router stepped from 2 worker threads, and every replica
    on its own background thread (``start`` / ``results(timeout=)``),
    give the serial JAX fleet's tokens."""
    jax_side, port = pkgs
    prompts = _prompts((3, 7, 5, 11, 4, 9), seed=1)

    def serve(pkg, **kw):
        rt = _router(pkg, **kw)
        reqs = [rt.submit(p, max_new_tokens=5, **(
            dict(SAMPLED, seed=50 + i) if i % 3 == 0 else {}))
            for i, p in enumerate(prompts)]
        rt.run_until_idle()
        rt.stop()
        _no_leaks(rt)
        return [r.output_ids for r in reqs]

    ref = serve(jax_side)
    assert serve(port, dispatch_threads=2) == ref
    rt = _router(port)
    rt.start()
    try:
        reqs = [rt.submit(p, max_new_tokens=5, **(
            dict(SAMPLED, seed=50 + i) if i % 3 == 0 else {}))
            for i, p in enumerate(prompts)]
        done = rt.results(reqs, timeout=120)
        assert [r.output_ids for r in rt.results(timeout=120)] == ref
    finally:
        rt.stop()
    assert [r.output_ids for r in done] == ref
    _no_leaks(rt)
    eng = rt.engines[0]
    pending = eng.submit([1, 2, 3], max_new_tokens=2)
    with pytest.raises(TimeoutError):
        eng.results([pending], timeout=0.01)
    eng.run_until_idle()
    assert eng.results([pending], timeout=0)[0].done


def test_refuses_what_is_not_ported(pkgs):
    _, port = pkgs
    # dispatch-ahead megasteps are ported: every replica takes them
    # (tests/test_torch_megastep.py runs them; LoRA tenants and the host
    # KV tier: tests/test_torch_lora.py and tests/test_torch_kv_tier.py)
    ahead = _router(port, megastep=2, dispatch_ahead=True)
    assert all(e.dispatch_ahead and e.stats()["ahead_hits"] == 0
               for e in ahead.engines)
    with pytest.raises(ValueError):
        _router(port, hedge_ms=50.0, hedge_budget=-1.0)
    rt = _router(port)
    with pytest.raises(ValueError):
        ReplicaRouter()
    with pytest.raises(ValueError):
        _router(port, n=0)
    with pytest.raises(ValueError):
        ReplicaRouter(engines=[])
    with pytest.raises(ValueError):
        ReplicaRouter(port.model, engines=rt.engines)
    assert ReplicaRouter(engines=rt.engines).engines == rt.engines


def test_dispatch_flags_validate_like_jax(pkgs):
    from paddle_tpu_torch.serving import ServingEngine
    _, port = pkgs
    with pytest.raises(ValueError):
        _router(port, dispatch_threads=-1)
    with pytest.raises(ValueError):       # the reference's rule
        ServingEngine(port.model, max_len=32, dispatch_ahead=True,
                      device="cpu")
    st = ServingEngine(port.model, max_len=32, megastep=2,
                       dispatch_ahead=True, device="cpu").stats()
    assert st["dispatch_ahead"] is True and st["ahead_misses"] == 0
    with _flags(port, {"serving_autoscale": "3:1"}):
        with pytest.raises(ValueError):
            _router(port)


def test_launch_counts_are_thread_safe_and_captures_record_their_own(
        monkeypatch):
    """Replicas stepped from threads count every launch; a capture's
    recording takes only the launches onto the capturing stream (here:
    the recording thread's), which the module counts never see."""
    import threading
    import torch
    from paddle_tpu_torch import jit
    from paddle_tpu_torch.ops.cuda import _launches
    from paddle_tpu_torch.ops.cuda import paged_attention as pa
    before = jit.launch_counts()
    recorded = {}
    capturing = threading.local()
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: getattr(capturing, "on", False))
    started = threading.Barrier(4)

    def launch(n, record):
        if record:
            with _launches.recording() as rec:
                capturing.on = True
                started.wait()
                for _ in range(n):
                    _launches.count(pa, None, "split")
            recorded.update(rec)
        else:
            started.wait()
            for _ in range(n):
                _launches.count(pa, None, "single")

    threads = [threading.Thread(target=launch, args=(2000, i == 0))
               for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    now = jit.launch_counts()
    key = ("paged_attention", None, None)
    single = ("paged_attention", "paged_attention", "single")
    assert now[key] - before[key] == 6000
    assert now[single] - before[single] == 6000
    assert recorded == {key: 2000,
                        ("paged_attention", "paged_attention", "split"): 2000}
    jit._add_launch_counts(recorded)
    assert jit.launch_counts()[key] - before[key] == 8000
    jit._set_launch_counts(before)
