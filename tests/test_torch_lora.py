"""Multi-tenant paged LoRA in the port (``paddle_tpu_torch/serving/lora.py``,
the LoRA delta in ``models/gpt.py``, the LoRA variants of the paged steps
in ``models/generation.py`` and the tenant paths of the engine, both
routers, HTTP and the load generator) against ``paddle_tpu.serving`` on
the CPU. Each scenario runs once per package on the same weights (carried
across by ``gpt_state_from_numpy``), adapters (each package's
``make_adapter``, asserted equal) and prompts, from reset monitors,
retry budgets and trace stores; what it observes must be equal: tokens,
``stats()["lora"]`` and ``["tenants"]``, STAT counters, the
``serving_lora_load`` run-log events and ``lora_pool.leaked()``.

The counterparts of ``tests/test_serving_decoding.py:226-237`` (tenant
validation), ``:242`` and ``:264`` (tenants diverge over one pool; chaos
leaves no page pinned; a pinned page refuses eviction),
``tests/test_serving_megastep.py:407``, ``tests/test_serving_cancel.py
:110``, ``tests/test_serving_router.py:304-340`` and
``tests/test_loadgen.py:286-345``; beside them the pool alone against the
reference's, the in-place contract (a load or an evict keeps every pool
tensor's ``data_ptr()`` and adds no step signature, the port's "zero new
compiles"), a hot reload seen by the very next step, the disaggregated
handoff moving the pin, the HTTP ``tenant`` field, and the reference's
tenant-blind prefix keys reproduced (a warm acme request reuses a base
request's KV block; ROADMAP C). The model is the small GPT of
``tests/test_serving_decoding.py`` (vocab 97, h 32, 2 layers, 4 heads)
drawn at ``init_std`` 0.2. The JAX side runs with 64-bit types off."""

import torch_threads  # noqa: F401  (one worker's share of the cores)
import json
from types import SimpleNamespace

import jax
import numpy as np
import pytest

import paddle_tpu as pt
from paddle_tpu import monitor as jmonitor
from paddle_tpu.models.gpt import GPTConfig as JGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JGPT
from paddle_tpu.observability import runlog as jrunlog
from paddle_tpu.observability import tracing as jtracing
from paddle_tpu.resilience import fault_scope as jfault_scope
from paddle_tpu.resilience import reset_default_budget as jreset_budget
from paddle_tpu.serving import DisaggRouter as JDisaggRouter
from paddle_tpu.serving import LoRAPool as JLoRAPool
from paddle_tpu.serving import QueueFullError as JQueueFull
from paddle_tpu.serving import ReplicaRouter as JReplicaRouter
from paddle_tpu.serving import ServingEngine as JServingEngine
from paddle_tpu.serving import ServingHTTPServer as JServer
from paddle_tpu.serving import make_adapter as jmake_adapter
from paddle_tpu_torch import monitor as tmonitor
from paddle_tpu_torch.models import generation as tgen
from paddle_tpu_torch.models.convert import gpt_state_from_numpy
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.observability import runlog as trunlog
from paddle_tpu_torch.observability import tracing as ttracing
from paddle_tpu_torch.resilience import fault_scope as tfault_scope
from paddle_tpu_torch.resilience import reset_default_budget as treset_budget
from paddle_tpu_torch.serving import (DisaggRouter, LoRAPool, QueueFullError,
                                      ReplicaRouter, ServingEngine,
                                      ServingHTTPServer, make_adapter)
from paddle_tpu_torch.tools import loadgen as tloadgen
from tools import loadgen as jloadgen

GEOM = dict(vocab_size=97, max_position_embeddings=64, hidden_size=32,
            num_layers=2, num_heads=4, ffn_hidden_size=64, init_std=0.2)
ENGINE = dict(max_slots=2, max_len=32, buckets=[8, 16], max_queue=16,
              block_size=4)
SAMPLED = dict(temperature=0.8, top_k=8, top_p=0.95)
STATS = ("STAT_serving_lora_loads", "STAT_serving_lora_evictions",
         "STAT_serving_completed", "STAT_serving_shed",
         "STAT_serving_canceled", "STAT_serving_prefills",
         "STAT_serving_rehomed", "STAT_serving_handoffs")


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
    common = dict(cfg=tm.cfg)
    return (SimpleNamespace(
                name="jax", model=jm, Engine=JServingEngine,
                Router=JReplicaRouter, Disagg=JDisaggRouter, Pool=JLoRAPool,
                adapter=jmake_adapter, monitor=jmonitor, runlog=jrunlog,
                tracing=jtracing, reset_budget=jreset_budget,
                fault_scope=jfault_scope, QueueFull=JQueueFull,
                lg=jloadgen, Server=JServer, kw={}, pool_kw={}, **common),
            SimpleNamespace(
                name="port", model=tm, Engine=ServingEngine,
                Router=ReplicaRouter, Disagg=DisaggRouter, Pool=LoRAPool,
                adapter=make_adapter, monitor=tmonitor, runlog=trunlog,
                tracing=ttracing, reset_budget=treset_budget,
                fault_scope=tfault_scope, QueueFull=QueueFullError,
                lg=tloadgen, Server=ServingHTTPServer,
                kw={"device": "cpu"}, pool_kw={"device": "cpu"}, **common))


def _prompts(sizes, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, 97, size=n).tolist() for n in sizes]


def _engine(pkg, **kw):
    return pkg.Engine(pkg.model, **{**ENGINE, "clock": lambda: 0.0, **kw},
                      **pkg.kw)


def _load(target, pkg, names=("acme", "zeta"), rank=2, scale=0.5):
    for i, name in enumerate(names):
        target.load_adapter(name, pkg.adapter(pkg.cfg, rank, seed=i + 1,
                                              scale=scale))


def _lora_events(pkg, seq0):
    return [{k: v for k, v in e.items() if k in ("adapter", "page",
                                                    "evicted")}
            for e in pkg.runlog.recent(512)
            if e["seq"] > seq0 and e["kind"] == "serving_lora_load"]


def _seq(pkg):
    last = pkg.runlog.recent(1)
    return last[-1]["seq"] if last else 0


def _leaked(eng):
    eng.cache.flush_prefix_cache()
    return eng.cache.allocator.leaked()


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


@pytest.mark.parametrize("seed,scale,rank", [(1, 0.05, 2), (2, 0.5, 8),
                                             (7, 0.05, 4)])
def test_make_adapter_equals_the_reference(pkgs, seed, scale, rank):
    jax_side, port = pkgs
    a = port.adapter(port.cfg, rank, seed=seed, scale=scale)
    b = jax_side.adapter(jax_side.model.gpt.cfg, rank, seed=seed,
                         scale=scale)
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype == np.float32
        assert np.array_equal(a[k], b[k]), k


def test_pool_alone_like_the_reference(pkgs):
    """Load, hot reload, a full pool, pins, eviction refused while
    pinned, evict and reload: the same pages, rosters, refcounts, errors
    and factor values in both pools; the port's tensors keep their
    storage throughout."""
    def run(pkg):
        pool = pkg.Pool(pkg.cfg, 2, 2, **pkg.pool_kw)
        ptrs = ([a.data_ptr() for a in pool.arrays]
                if pkg.name == "port" else None)
        log = []

        def op(name, fn):
            try:
                log.append((name, fn()))
            except ValueError as e:
                log.append((name, "ValueError", str(e)))
            log.append((name, pool.loaded, pool.leaked(),
                        pool.in_use("acme"), pool.in_use("zeta"),
                        [np.asarray(a).tolist() for a in pool.arrays]))

        ad = [pkg.adapter(pkg.cfg, 2, seed=s, scale=0.5) for s in (1, 2, 3)]
        op("load acme", lambda: pool.load("acme", ad[0]))
        op("load zeta", lambda: pool.load("zeta", ad[1]))
        op("full", lambda: pool.load("third", ad[2]))
        op("reload acme", lambda: pool.load("acme", ad[2]))
        op("acquire", lambda: pool.acquire("acme"))
        op("acquire base", lambda: pool.acquire(""))
        op("evict pinned", lambda: pool.evict("acme"))
        op("release", lambda: pool.release("acme"))
        op("evict", lambda: pool.evict("acme"))
        op("evict again", lambda: pool.evict("acme"))
        op("unknown", lambda: pool.page_of("ghost"))
        op("load third", lambda: pool.load("third", ad[2]))
        op("bad shape", lambda: pool.load("x", {**ad[0], "fc1.A":
                                                ad[0]["fc1.A"][:, :3]}))
        op("missing", lambda: pool.load("x", {"fc1.A": ad[0]["fc1.A"]}))
        op("empty name", lambda: pool.load("", ad[0]))
        if ptrs is not None:
            assert [a.data_ptr() for a in pool.arrays] == ptrs
        return pool.shape_key, pool.adapter_shapes(), log

    _both(pkgs, run)


def test_tenant_validation_like_the_reference(pkgs):
    """``tests/test_serving_decoding.py:226-237``'s tenant cases: a
    tenant without a pool, an unknown adapter and a dense engine with a
    pool raise ValueError with the reference's messages."""
    def run(pkg):
        out = []
        eng = _engine(pkg)
        lora = _engine(pkg, lora_rank=2)
        for call in (lambda: eng.submit([1, 2], tenant="acme"),
                     lambda: lora.submit([1, 2], tenant="ghost"),
                     lambda: _engine(pkg, lora_rank=2, paged=False),
                     lambda: eng.load_adapter("acme", {}),
                     lambda: eng.evict_adapter("acme")):
            with pytest.raises(ValueError) as e:
                call()
            out.append(str(e.value))
        return out

    _both(pkgs, run)


@pytest.mark.parametrize("kw", [dict(), dict(megastep=4),
                                dict(spec_tokens=2), dict(kv_dtype="int8")],
                         ids=["f32", "megastep4", "spec2", "int8"])
def test_tenants_diverge_share_one_pool_like_the_reference(pkgs, kw):
    """``tests/test_serving_decoding.py:242``: one prompt for base, acme
    and zeta (and a sampled acme row) in one engine, mixed in the same
    batches: three different greedy outputs, the same as the
    reference's, ``stats()["lora"]`` / ``["tenants"]``, the counters and
    the load events equal, no page or block leaked."""
    p = _prompts((5,))[0]

    def run(pkg):
        seq0 = _seq(pkg)
        eng = _engine(pkg, lora_rank=2, lora_max_adapters=2, **kw)
        _load(eng, pkg)
        reqs = [eng.submit(p, max_new_tokens=5, tenant=t)
                for t in ("", "acme", "zeta")]
        reqs.append(eng.submit(p, max_new_tokens=5, tenant="acme", seed=3,
                               **SAMPLED))
        eng.run_until_idle()
        outs = [r.output_ids for r in reqs]
        assert len({tuple(o) for o in outs[:3]}) == 3, outs
        st = eng.stats()
        assert eng.lora_pool.leaked() == 0 and _leaked(eng) == 1
        return (outs, st["lora"], st["tenants"],
                {n: pkg.monitor.stat_get(n) for n in STATS},
                _lora_events(pkg, seq0), [r.tenant for r in reqs])

    _both(pkgs, run)


def test_zero_leaks_under_chaos_like_the_reference(pkgs):
    """``tests/test_serving_decoding.py:264``: tenant traffic under
    submit and allocation faults releases every page and block it took,
    the same requests shed and finish, and a pinned page refuses
    eviction."""
    prompts = _prompts((4, 6, 5, 7, 4, 6), seed=5)

    def run(pkg):
        eng = _engine(pkg, lora_rank=2, lora_max_adapters=2)
        _load(eng, pkg, names=("acme",))
        reqs = []
        with pkg.fault_scope("serving.submit:skip@0.3;serving.alloc:skip@0.3",
                             seed=13):
            for i, q in enumerate(prompts):
                try:
                    reqs.append(eng.submit(q, max_new_tokens=4,
                                           tenant="acme" if i % 2 else ""))
                except pkg.QueueFull:
                    reqs.append(None)
                eng.step()
            eng.run_until_idle()
        out = [None if r is None else (r.state, r.output_ids)
               for r in reqs]
        assert eng.lora_pool.leaked() == 0 and _leaked(eng) == 1
        eng.lora_pool.acquire("acme")
        with pytest.raises(ValueError, match="pinned"):
            eng.evict_adapter("acme")
        eng.lora_pool.release("acme")
        page = eng.evict_adapter("acme")
        return out, page, eng.stats()["tenants"], \
            {n: pkg.monitor.stat_get(n) for n in STATS}

    out = _both(pkgs, run)
    assert any(r is None or r[0] == "shed" for r in out[0])


def test_megastep_identity_and_zero_page_leaks_like_the_reference(pkgs):
    """``tests/test_serving_megastep.py:407``: tenant traffic at
    megastep 4 equals megastep 1 token for token, as the reference's."""
    prompts = _prompts((4, 6), seed=10)

    def run(pkg):
        outs = []
        for n in (1, 4):
            eng = _engine(pkg, megastep=n, lora_rank=2, lora_max_adapters=2)
            _load(eng, pkg, names=("acme",))
            reqs = [eng.submit(q, max_new_tokens=8, tenant="acme")
                    for q in prompts]
            eng.run_until_idle()
            outs.append([r.output_ids for r in reqs])
            assert eng.lora_pool.leaked() == 0 and _leaked(eng) == 1
        assert outs[0] == outs[1]
        return outs[0]

    _both(pkgs, run)


def test_cancel_spec_int8_pinned_tenant_like_the_reference(pkgs):
    """``tests/test_serving_cancel.py:110``: a tenant request canceled
    mid-decode on an int8 pool with spec K 2 releases its row and its
    pin; the next tenant request takes the row, tokens as the
    reference's."""
    p1, p2 = _prompts((4, 5), seed=3)

    def run(pkg):
        eng = _engine(pkg, max_slots=1, buckets=[8], max_queue=8,
                      spec_tokens=2, kv_dtype="int8", lora_rank=2)
        eng.load_adapter("acme", pkg.adapter(pkg.cfg, 2, seed=1))
        r1 = eng.submit(p1, max_new_tokens=12, tenant="acme")
        r2 = eng.submit(p2, max_new_tokens=4, tenant="acme")
        eng.step()
        assert r1.first_token_at is not None and r1._lora_held
        out = eng.cancel(r1.id)
        assert not r1._lora_held and eng.lora_pool.leaked() == 0
        eng.run_until_idle()
        assert eng.lora_pool.leaked() == 0 and _leaked(eng) == 1
        return (out["stage"], r1.tokens, r2.state, r2.output_ids,
                eng.stats()["canceled"], eng.stats()["tenants"])

    _both(pkgs, run)


@pytest.mark.parametrize("threads", [0, 2], ids=["serial", "threaded"])
def test_router_kill_rehomes_tenant_like_the_reference(pkgs, threads):
    """``tests/test_serving_router.py:304-340``: a replica holding
    in-flight spec K 2 int8 decodes, one pinning a tenant, is killed;
    every request re-homes and finishes as the reference's does, the
    fleet's one pool ends with no page pinned and every pool with its
    trash block only. The fleet-shared pool loads once."""
    prompts = _prompts((3, 7, 5, 6), seed=30)

    def run(pkg):
        rt = pkg.Router(pkg.model, n_replicas=2, spec_tokens=2,
                        kv_dtype="int8", prefix_cache=False, lora_rank=2,
                        lora_max_adapters=2, dispatch_threads=threads,
                        **{**ENGINE, "clock": lambda: 0.0}, **pkg.kw)
        assert rt.engines[0].lora_pool is rt.engines[1].lora_pool
        rt.load_adapter("acme", pkg.adapter(pkg.cfg, 2, seed=1))
        reqs = [rt.engines[0].submit(q, max_new_tokens=8,
                                     tenant="acme" if i == 1 else "")
                for i, q in enumerate(prompts)]
        rt.engines[0].step()
        assert any(r.tokens for r in reqs)
        info = rt.kill_replica(0)
        assert rt.engines[0].lora_pool.leaked() == 0
        rt.run_until_idle()
        rt.stop()
        for eng in rt.engines + rt._retiring:
            assert eng.cache.allocator.leaked() == 1
        assert rt.engines[0].lora_pool.leaked() == 0
        page = rt.evict_adapter("acme")
        return (info, [(r.state, r.rehomed, r.output_ids) for r in reqs],
                rt.stats()["tenants"], page,
                {n: pkg.monitor.stat_get(n) for n in STATS})

    _both(pkgs, run)


@pytest.mark.parametrize("colocate", [True, False],
                         ids=["colocated", "cross-pool"])
def test_disagg_handoff_moves_the_pin_like_the_reference(pkgs, colocate):
    """A 1 x 2 fleet with one shared pool: the prefill worker releases a
    tenant's pin on export, the decode worker re-acquires it on
    adoption; a decode worker killed mid-decode moves it to the
    survivor. Tokens, tenants, kill accounting and counters as the
    reference's; no page or block leaked."""
    prompts = _prompts((5, 7, 6), seed=4)

    def run(pkg):
        rt = pkg.Disagg(pkg.model, n_prefill=1, n_decode=2,
                        colocate=colocate, lora_rank=2, lora_max_adapters=2,
                        **{**ENGINE, "clock": lambda: 0.0}, **pkg.kw)
        assert all(e.lora_pool is rt.prefills[0].lora_pool
                   for e in rt.engines)
        _load(rt, pkg)
        reqs = [rt.submit(q, max_new_tokens=8, tenant=t)
                for q, t in zip(prompts, ("acme", "zeta", ""))]
        for _ in range(2):
            rt.step()
        held = sorted(r.id for r in reqs if r._lora_held)
        info = rt.kill_decode_worker(0)
        rt.run_until_idle()
        pool = rt.prefills[0].lora_pool
        assert pool.leaked() == 0
        for e in rt.engines:
            e.cache.flush_prefix_cache()
            assert e.cache.allocator.leaked() == 1
        st = rt.stats()
        return ([(r.state, r.output_ids) for r in reqs],
                [i - reqs[0].id for i in held], info, st["tenants"],
                {n: pkg.monitor.stat_get(n) for n in STATS})

    _both(pkgs, run)


def test_load_and_evict_write_in_place_and_add_no_signature(pkgs):
    """The port's in-place contract: after a warm engine ran its steps, a
    hot reload, an evict and a load of another tenant keep every pool
    tensor's ``data_ptr()`` and add no step signature (the CPU's count
    of captures), and the very next requests compute with the new
    factors, as an engine loaded with them from the start."""
    _, port = pkgs
    p = _prompts((6,), seed=8)[0]
    # no prefix cache: its keys ignore the tenant and the adapter's
    # version (the reference's fault), so a cached block computed under
    # the old factors would be reused
    eng = _engine(port, lora_rank=2, lora_max_adapters=2, megastep=2,
                  prefix_cache=False)
    _load(eng, port)
    for sampled in ({}, dict(seed=1, **SAMPLED)):   # both graphs
        for t in ("", "acme", "zeta"):
            eng.submit(p, max_new_tokens=4, tenant=t, **sampled)
        eng.run_until_idle()
    ptrs = [a.data_ptr() for a in eng.lora_pool.arrays]
    count = sum(e["traces"]["count"]
                for e in port.model._step_compile_cache.values())
    new = port.adapter(port.cfg, 2, seed=5, scale=0.5)
    eng.load_adapter("acme", new)
    eng.evict_adapter("zeta")
    eng.load_adapter("third", port.adapter(port.cfg, 2, seed=6, scale=0.5))
    reqs = [eng.submit(p, max_new_tokens=4, tenant=t)
            for t in ("acme", "third", "")]
    eng.run_until_idle()
    assert [a.data_ptr() for a in eng.lora_pool.arrays] == ptrs
    assert sum(e["traces"]["count"]
               for e in port.model._step_compile_cache.values()) == count
    fresh = _engine(port, lora_rank=2, lora_max_adapters=2, megastep=2,
                    prefix_cache=False)
    fresh.load_adapter("acme", new)
    fresh.load_adapter("third", port.adapter(port.cfg, 2, seed=6,
                                             scale=0.5))
    ref = [fresh.submit(p, max_new_tokens=4, tenant=t)
           for t in ("acme", "third", "")]
    fresh.run_until_idle()
    assert [r.output_ids for r in reqs] == [r.output_ids for r in ref]
    assert eng.stats()["lora"]["loaded"] == ["acme", "third"]
    # the step keys carry the pool's geometry, as the reference's
    keys = [k for k in port.model._step_compile_cache if "lora" in k]
    assert all(k[-2] == "lora" for k in keys)
    assert ("decode_mega", 2, "f32", "kernel", "lora", (2, 3)) in keys
    assert tgen._lora_key(("decode_paged",), None) == ("decode_paged",)


def test_tenant_blind_prefix_keys_in_both_packages(pkgs):
    """The reference's prefix cache keys blocks by tokens alone: an acme
    request arriving after a base request with the same prompt reuses the
    base request's KV block, computed without acme's qkv delta, so it
    differs from a cold acme engine's output. The port reproduces this
    (ROADMAP C), and equals the reference in each case."""
    prompt = _prompts((20,), seed=11)[0]

    def run(pkg):
        cold = _engine(pkg, max_len=64, buckets=[8, 16, 32], block_size=8,
                       lora_rank=2)
        _load(cold, pkg, names=("acme",))
        c = cold.submit(prompt, max_new_tokens=6, tenant="acme")
        cold.run_until_idle()
        warm = _engine(pkg, max_len=64, buckets=[8, 16, 32], block_size=8,
                       lora_rank=2)
        _load(warm, pkg, names=("acme",))
        warm.submit(prompt, max_new_tokens=6)
        warm.run_until_idle()
        w = warm.submit(prompt, max_new_tokens=6, tenant="acme")
        warm.run_until_idle()
        assert warm.stats()["prefix_hit_requests"] == 1
        assert w.tokens != c.tokens, "the prefix cache took the tenant " \
            "into account: the reference's fault is gone"
        return c.tokens, w.tokens

    _both(pkgs, run)


def test_loadgen_tenant_mix_like_the_reference(pkgs):
    """``tests/test_loadgen.py:286-345``: a tenant mix leaves plain seeds'
    traces untouched and round-trips through ``from_trace``, byte-equal to
    the reference's; a two-tenant sampled burst on a virtual clock gives
    the reference's report (``per_tenant``, ``leaked_lora_pages``),
    decisions and tokens, and the engine's tenant view agrees."""
    lg_kw = dict(rate=30.0, duration=0.6, vocab_size=97,
                 prompt_tokens=(3, 9), new_tokens=(2, 5),
                 priority_mix={0: 0.2, 1: 0.6, 2: 0.2})
    mix = dict(sample_frac=0.5,
               tenant_mix={"base": 0.4, "acme": 0.3, "zeta": 0.3})
    a = tloadgen.LoadGen(mode="bursty", seed=42, **lg_kw, **mix)
    b = jloadgen.LoadGen(mode="bursty", seed=42, **lg_kw, **mix)
    assert a.trace_bytes() == b.trace_bytes()
    assert any(x.tenant for x in a.schedule())
    assert any(not x.tenant for x in a.schedule())
    rt = tloadgen.LoadGen.from_trace(json.loads(a.trace_bytes()))
    assert rt.trace_bytes() == a.trace_bytes()

    def run(pkg):
        vc = pkg.lg.VirtualClock()
        eng = pkg.Engine(pkg.model, max_slots=2, max_len=32, buckets=[8, 16],
                         max_queue=16, slo_ttft_ms=200.0, slo_prefill_ms=4.0,
                         slo_tpot_ms=1.5, lora_rank=2, lora_max_adapters=2,
                         clock=vc.now, **pkg.kw)
        eng.load_adapter("acme", pkg.adapter(pkg.cfg, 2, seed=1))
        eng.load_adapter("zeta", pkg.adapter(pkg.cfg, 2, seed=2))
        pkg.lg.warmup(eng)
        rep = pkg.lg.LoadGen(mode="poisson", seed=6, **lg_kw, **mix).run(
            eng, clock=vc, step_cost_ms=4.0)
        assert rep["exceptions"] == 0 and rep["leaked_kv_blocks"] == 0
        assert rep["leaked_lora_pages"] == 0
        pt_rep = rep["per_tenant"]
        assert sum(t["completed"] for t in pt_rep.values()) == \
            rep["completed"]
        reqs = sorted(eng._all, key=lambda r: r.id)
        return rep, [(r.tenant, r.state, list(r.tokens)) for r in reqs], \
            eng.stats()["tenants"]

    rep, _, tenants = _both(pkgs, run)
    assert {"acme", "zeta"} <= set(rep["per_tenant"])
    for name in ("acme", "zeta"):
        assert tenants[name]["completed"] == \
            rep["per_tenant"][name]["completed"]


def test_http_tenant_like_the_reference(pkgs):
    """``tenant`` over HTTP: 200 with the tenant echoed and the
    reference's tokens, 400 with its body for an unknown adapter."""
    import http.client

    p = _prompts((5,), seed=2)[0]

    def run(pkg):
        eng = _engine(pkg, lora_rank=2)
        _load(eng, pkg, names=("acme",))
        srv = pkg.Server(eng, port=0)
        srv.start()
        out = []
        try:
            for body in ({"ids": p, "max_new_tokens": 4, "tenant": "acme"},
                         {"ids": p, "max_new_tokens": 4},
                         {"ids": p, "tenant": "ghost"}):
                c = http.client.HTTPConnection("127.0.0.1", srv.port,
                                               timeout=60)
                c.request("POST", "/v1/generate", json.dumps(body),
                          {"Content-Type": "application/json"})
                r = c.getresponse()
                payload = json.loads(r.read())
                payload.pop("id", None)
                out.append((r.status, payload))
                c.close()
        finally:
            srv.stop()
        assert eng.lora_pool.leaked() == 0
        return out

    out = _both(pkgs, run)
    assert out[0][0] == 200 and out[0][1]["tenant"] == "acme"
    assert "tenant" not in out[1][1] and out[2][0] == 400
    assert out[0][1]["output_ids"] != out[1][1]["output_ids"]
