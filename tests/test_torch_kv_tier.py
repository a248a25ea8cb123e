"""The host KV tier in the port (``paddle_tpu_torch/serving/kv_tier.py``:
``HostBlockStore``, ``SessionStore``, ``TierManager``; the engine's
``submit(session=)``, promotion at admission and the demotion sweep; the
routers' fleet-shared tier) against ``paddle_tpu.serving.kv_tier`` on
the CPU. Each scenario runs once per package on the same weights
(carried across by ``gpt_state_from_numpy``) and prompts; what it
observes must be equal: tokens, ``TierManager.stats()``, both tiers'
leaks, kill and affinity accounting.

Every test of ``tests/test_kv_tier.py`` has a counterpart here, with its
parametrizations (greedy, spec 2, int8): resume after demotion (each
package also equal to its own never-demoted greedy pass), the LoRA pin
across a resume, validation, all-or-nothing promotion, LRU leaf-first
eviction, fleet dedup, the session store, the chaos faults and the
killed prefill worker's host-tier affinity, and the reference's
lifecycle linter test over ``kv_tier.py``, on the port's linter (both
checkers agree there). Beside them, the codec:
the port's ``_np_quantize`` / ``_np_dequantize`` equal the reference's
bit for bit on random blocks with .5 ties, and a demotion of the same
block values gives the reference's host codes and scales bit for bit
(f32, bf16, int8 pools), a promotion numpy's ``dequantize(quantize(
block))`` cast to the pool's dtype (int8: the codes and scales
verbatim). Its ``predict_serving_compiles(host_tier=True)`` check runs
on the port's predictor (equal to the reference's), beside equal step
signatures with and without a tier. Then the load
generator's returning-users run and its trace replay against
``tools/loadgen.py``'s, ``report["sessions"]`` included. The model is
the small GPT of ``tests/test_kv_tier.py`` (vocab 97, h 32, 2 layers, 4
heads) drawn at ``init_std`` 0.2. The JAX side runs with 64-bit types
off."""

import torch_threads  # noqa: F401  (one worker's share of the cores)
import json
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.models.generation import greedy_search as jgreedy
from paddle_tpu.analysis import lifecycle as jlifecycle
from paddle_tpu.analysis import predict_serving_compiles as jpredict
from paddle_tpu.models.gpt import GPTConfig as JGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JGPT
from paddle_tpu.resilience import fault_scope as jfault_scope
from paddle_tpu.resilience import reset_default_budget as jreset_budget
from paddle_tpu.serving import DisaggRouter as JDisaggRouter
from paddle_tpu.serving import HostBlockStore as JHostBlockStore
from paddle_tpu.serving import ReplicaRouter as JReplicaRouter
from paddle_tpu.serving import ServingEngine as JServingEngine
from paddle_tpu.serving import SessionStore as JSessionStore
from paddle_tpu.serving import TierManager as JTierManager
from paddle_tpu.serving import kv_tier as jkv_tier
from paddle_tpu.serving import make_adapter as jmake_adapter
from paddle_tpu.serving.disagg import _HOST_TIER as J_HOST_TIER
from paddle_tpu.serving.kv_cache import BlockKVCache as JBlockKVCache
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch.analysis import lifecycle, predict_serving_compiles
from paddle_tpu_torch.models.convert import gpt_state_from_numpy
from paddle_tpu_torch.models.generation import greedy_search as tgreedy
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.resilience import fault_scope as tfault_scope
from paddle_tpu_torch.resilience import reset_default_budget as treset_budget
from paddle_tpu_torch.serving import (DisaggRouter, HostBlockStore,
                                      ReplicaRouter, ServingEngine,
                                      SessionStore, TierManager, kv_tier,
                                      make_adapter)
from paddle_tpu_torch.serving.disagg import _HOST_TIER as T_HOST_TIER
from paddle_tpu_torch.serving.kv_cache import BlockKVCache
from paddle_tpu_torch.tools import loadgen as tloadgen
from tools import loadgen as jloadgen

GEOM = dict(vocab_size=97, max_position_embeddings=64, hidden_size=32,
            num_layers=2, num_heads=4, ffn_hidden_size=64, init_std=0.2)
ENGINE = dict(max_slots=2, max_len=64, buckets=[8, 16, 32], max_queue=16,
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
    return (SimpleNamespace(
                name="jax", model=jm, Engine=JServingEngine,
                Router=JReplicaRouter, Disagg=JDisaggRouter,
                Store=JHostBlockStore, Tier=JTierManager,
                Sessions=JSessionStore, mod=jkv_tier, greedy=jgreedy,
                adapter=jmake_adapter, HOST_TIER=J_HOST_TIER,
                fault_scope=jfault_scope, reset_budget=jreset_budget,
                lg=jloadgen, cfg=tm.cfg, kw={}),
            SimpleNamespace(
                name="port", model=tm, Engine=ServingEngine,
                Router=ReplicaRouter, Disagg=DisaggRouter,
                Store=HostBlockStore, Tier=TierManager,
                Sessions=SessionStore, mod=kv_tier, greedy=tgreedy,
                adapter=make_adapter, HOST_TIER=T_HOST_TIER,
                fault_scope=tfault_scope, reset_budget=treset_budget,
                lg=tloadgen, cfg=tm.cfg, kw={"device": "cpu"}))


def _prompts(sizes, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, 97, size=n).tolist() for n in sizes]


def _tier(pkg, blocks=64, block_size=4, idle_ms=0.0):
    cfg = pkg.cfg
    return pkg.Tier(pkg.Store(cfg.num_layers, cfg.num_heads, cfg.head_dim,
                              block_size=block_size, num_blocks=blocks),
                    demote_idle_ms=idle_ms)


def _engine(pkg, tier=None, **kw):
    kw = {**ENGINE, "clock": lambda: 0.0, **kw}
    if tier is not None:
        kw["kv_tier"] = tier
    return pkg.Engine(pkg.model, **kw, **pkg.kw)


def _ref(pkg, prompt, n, cache_len=64):
    return pkg.greedy(pkg.model, np.asarray([prompt]), max_new_tokens=n,
                      cache_len=cache_len)[0].tolist()


def _drain_device(eng, tier):
    """Flush the device prefix cache (the sweep demoted its chains
    already), so the next turn can only resume through the host tier."""
    eng.cache.flush_prefix_cache()
    assert eng.cache.allocator.leaked() == 1
    assert tier.stats()["host_chain_entries"] > 0


def _both(pkgs, scenario):
    out = []
    for pkg in pkgs:
        pkg.reset_budget()
        out.append(scenario(pkg))
    assert out[1] == out[0]
    return out[0]


# ------------------------------------------------ resume token identity
@pytest.mark.parametrize("kw", [dict(), dict(spec_tokens=2),
                                dict(kv_dtype="int8")],
                         ids=["greedy", "spec2", "int8"])
def test_session_resumes_token_identical_after_demotion(pkgs, kw):
    """Turn 2 of a session whose turn-1 context was demoted and flushed
    off the device equals a never-demoted greedy pass over the whole
    conversation, in each package, and the packages agree on tokens
    and tier stats."""
    t1, t2 = _prompts((12, 6), seed=1)

    def run(pkg):
        tier = _tier(pkg)
        eng = _engine(pkg, tier, **kw)
        r1 = eng.submit(t1, max_new_tokens=6, session="u1")
        eng.run_until_idle()
        assert r1.state == "done" and r1.output_ids == _ref(pkg, t1, 6)
        _drain_device(eng, tier)
        r2 = eng.submit(t2, max_new_tokens=6, session="u1")
        eng.run_until_idle()
        assert r2.state == "done"
        assert r2.output_ids == _ref(pkg, r1.output_ids + t2, 6)
        st = tier.stats()
        assert st["sessions_resumed"] == 1
        assert st["migrated_promote_blocks"] > 0
        eng.cache.flush_prefix_cache()
        tier.flush()
        assert eng.cache.allocator.leaked() == 1 and tier.leaked() == 0
        return r1.output_ids, r2.output_ids, st, eng.stats()["kv_tier"]

    _both(pkgs, run)


def test_session_resume_keeps_lora_tenant_pin(pkgs):
    """A tenant conversation survives demotion: turn 2 resumes with the
    adapter applied (== a one-shot full-context submit of that tenant on
    a tier-free engine) and the adapter pool leaks nothing."""
    t1, t2 = _prompts((10, 5), seed=2)

    def run(pkg):
        tier = _tier(pkg)
        eng = _engine(pkg, tier, lora_rank=2, lora_max_adapters=2)
        ad = pkg.adapter(pkg.cfg, 2, seed=1, scale=0.5)
        eng.load_adapter("acme", ad)
        r1 = eng.submit(t1, max_new_tokens=5, session="s", tenant="acme")
        eng.run_until_idle()
        _drain_device(eng, tier)
        r2 = eng.submit(t2, max_new_tokens=5, session="s", tenant="acme")
        eng.run_until_idle()
        assert r2.state == "done" and eng.lora_pool.leaked() == 0
        ref_eng = _engine(pkg, lora_rank=2, lora_max_adapters=2)
        ref_eng.load_adapter("acme", ad)
        ref = ref_eng.submit(r1.output_ids + t2, max_new_tokens=5,
                             tenant="acme")
        ref_eng.run_until_idle()
        assert r2.output_ids == ref.output_ids
        return r1.output_ids, r2.output_ids, eng.stats()["tenants"]

    _both(pkgs, run)


def test_session_requires_tier_and_validates(pkgs):
    def run(pkg):
        out = []
        for eng, sid in ((_engine(pkg), "u1"), (_engine(pkg, _tier(pkg)),
                                                "")):
            with pytest.raises(ValueError) as e:
                eng.submit([1, 2, 3], session=sid)
            out.append(str(e.value))
        with pytest.raises(ValueError) as e:
            _engine(pkg, _tier(pkg, block_size=8))
        out.append(str(e.value))
        return out

    _both(pkgs, run)


# ---------------------------------------------------- migration machinery
def test_promotion_is_all_or_nothing_under_pool_pressure(pkgs):
    """A promotion that cannot take every device block it needs takes
    none, and the host chain stays for a roomier attempt."""
    prompt = _prompts((20,), seed=3)[0]

    def run(pkg):
        tier = _tier(pkg)
        eng = _engine(pkg, tier, max_slots=1)
        r = eng.submit(prompt, max_new_tokens=2, session="u1")
        eng.run_until_idle()
        _drain_device(eng, tier)
        chain = tier.stats()["host_chain_entries"]
        assert chain >= 3
        pool, alloc = eng.cache.pool, eng.cache.allocator
        squeeze = []
        while alloc.num_free > chain - 1:
            squeeze.append(pool.alloc_block())
        used = alloc.num_used
        assert tier.promote(eng.cache, prompt) == 0
        assert alloc.num_used == used
        assert tier.stats()["host_chain_entries"] == chain
        pool.release_blocks(squeeze)
        n = tier.promote(eng.cache, prompt)
        assert n == chain
        eng.cache.flush_prefix_cache()
        tier.flush()
        assert alloc.leaked() == 1 and tier.leaked() == 0
        return r.output_ids, chain, n, tier.stats()

    _both(pkgs, run)


def test_host_store_evicts_lru_leaf_first(pkgs):
    """The least recently touched unpinned entry goes first; a resident
    child pins its parent."""
    def run(pkg):
        store = pkg.Store(num_layers=1, num_heads=2, head_dim=4,
                          block_size=4, num_blocks=3)
        blks = [store.acquire() for _ in range(3)]
        E = pkg.mod._HostEntry
        store.put(E("k1", None, blks[0], (1, 2, 3, 4)))
        store.put(E("k2", None, blks[1], (5, 6, 7, 8)))
        store.put(E("k3", "k1", blks[2], (9, 10, 11, 12)))
        store.touch("k2")
        nb = store.acquire()
        out = (blks, nb, [store.has_key(k) for k in ("k1", "k2", "k3")],
               store.evictions, store.stats())
        store.release(nb)
        store.flush()
        assert store.leaked() == 0
        return out

    out = _both(pkgs, run)
    assert out[2] == [True, True, False]


def test_fleet_dedup_two_engines_share_one_host_chain(pkgs):
    """Two engines over one tier demote the same prompt: the second
    finds the chain host-resident and drops its device copy without a
    second host copy."""
    prompt = _prompts((16,), seed=4)[0]

    def run(pkg):
        tier = _tier(pkg)
        engines = [_engine(pkg, tier), _engine(pkg, tier)]
        outs = []
        for eng in engines:
            r = eng.submit(prompt, max_new_tokens=2)
            eng.run_until_idle()
            outs.append(r.output_ids)
        st = tier.stats()
        assert st["demote_dedup_entries"] > 0
        assert st["host_blocks_used"] == st["host_chain_entries"]
        for eng in engines:
            eng.cache.flush_prefix_cache()
        tier.flush()
        assert tier.leaked() == 0
        return outs, st

    _both(pkgs, run)


def test_session_store_roundtrip(pkgs):
    def run(pkg):
        ss = pkg.Sessions()
        out = [ss.get("a"), len(ss)]
        ss.save("a", [1, 2, 3])
        ss.save("b", [4])
        out += [ss.get("a"), len(ss), sorted(ss.session_ids())]
        ss.drop("a")
        out += [ss.get("a"), len(ss)]
        return out

    _both(pkgs, run)


# ------------------------------------------------------------------ chaos
def test_chaos_kill_and_migrate_faults_leak_nothing(pkgs):
    """Replica crashes (``serving.replica``) racing migration faults
    (``serving.migrate``, retried) over session traffic: the same
    outcomes as the reference's, no block leaked on either tier."""
    prompts = _prompts((6, 10, 8, 12, 7, 9), seed=5)

    def run(pkg):
        tier = _tier(pkg)
        rt = pkg.Router(pkg.model, n_replicas=2, kv_tier=tier,
                        **{**ENGINE, "clock": lambda: 0.0}, **pkg.kw)
        reqs = []
        with pkg.fault_scope("serving.replica:error@0.2;"
                             "serving.migrate:error@0.3", seed=6):
            for i, p in enumerate(prompts):
                reqs.append(rt.submit(p, max_new_tokens=3,
                                      session=f"c{i % 3}"))
                rt.step()
            rt.run_until_idle()
        assert any(r.state == "done" for r in reqs)
        for eng in rt.engines + rt._retiring:
            eng.cache.flush_prefix_cache()
            assert eng.cache.allocator.leaked() == 1
        st = tier.stats()
        tier.flush()
        assert tier.leaked() == 0
        return [(r.state, r.output_ids) for r in reqs], st, \
            rt.stats()["kills"], rt.stats()["restarts"]

    _both(pkgs, run)


# -------------------------------------------- fleet prefix index (regression)
def test_killed_prefill_worker_keeps_host_reachable_affinity(pkgs):
    """A killed prefill worker's affinity entries whose chains the host
    tier holds become the host-tier marker, route as hits, and the
    survivor promotes the chain instead of re-prefilling; tokens equal."""
    prompt = _prompts((12,), seed=7)[0]

    def run(pkg):
        tier = _tier(pkg)
        rt = pkg.Disagg(pkg.model, n_prefill=2, n_decode=1,
                        prefix_affinity=True, kv_tier=tier,
                        **{**ENGINE, "clock": lambda: 0.0}, **pkg.kw)
        r1 = rt.submit(prompt, max_new_tokens=4)
        rt.run_until_idle()
        assert tier.stats()["host_chain_entries"] > 0
        out = rt.kill_prefill_worker(0)
        kept = out["affinity_kept"]
        assert kept > 0
        assert sum(1 for v in rt._affinity.values()
                   if v is pkg.HOST_TIER) == kept
        r2 = rt.submit(prompt, max_new_tokens=4)
        rt.run_until_idle()
        assert r2.state == "done" and r2.output_ids == r1.output_ids
        assert tier.stats()["migrated_promote_blocks"] > 0
        assert not any(v is pkg.HOST_TIER for v in rt._affinity.values())
        for eng in rt.engines:
            eng.cache.flush_prefix_cache()
        tier.flush()
        assert tier.leaked() == 0
        return out, r1.output_ids, rt.stats()["affinity_hits"], \
            tier.stats()

    _both(pkgs, run)


# --------------------------------------------------------------- the codec
def test_host_codec_equals_the_reference_bit_for_bit(pkgs):
    """``_np_quantize`` / ``_np_dequantize`` against the reference's on
    random blocks, values landing exactly on .5 code boundaries
    included (round half to even), and all-zero heads (the 1e-9
    floor)."""
    jax_side, port = pkgs
    rng = np.random.RandomState(0)
    x = rng.randn(3, 4, 8, 16).astype(np.float32)
    s = np.max(np.abs(x), axis=(2, 3))[..., None, None]
    # exact ties: k + 0.5 codes of a scale of 127 (x / s * 127 = k + .5)
    x[0, 0, 0, :8] = (np.arange(8) + 0.5).astype(np.float32)
    x[0, 0, 1, :] = 0.0
    s[0, 0] = 127.0
    x[1, 2] = 0.0
    s[1, 2] = 0.0
    for a, b in ((port.mod._np_quantize(x, s), jax_side.mod._np_quantize(x,
                                                                      s)),):
        assert a.dtype == b.dtype == np.int8 and np.array_equal(a, b)
    codes = port.mod._np_quantize(x, s)
    assert list(codes[0, 0, 0, :8]) == [0, 2, 2, 4, 4, 6, 6, 8]
    d1 = port.mod._np_dequantize(codes, s)
    d2 = jax_side.mod._np_dequantize(codes, s)
    assert d1.dtype == d2.dtype == np.float32
    assert np.array_equal(d1.view(np.int32), d2.view(np.int32))


@pytest.mark.parametrize("kv", ["f32", "bf16", "int8"])
def test_demote_and_promote_blocks_bit_for_bit(pkgs, kv):
    """A two-block chain of the same values in a cache of each package,
    demoted: the host codes and scales are the reference's bit for bit.
    Promoted into a flushed pool: an int8 pool gets its codes and scales
    back verbatim; a f32/bf16 pool numpy's ``dequantize(quantize(block))``
    cast to its dtype, the reference's values, bit for bit."""
    jax_side, port = pkgs
    cfg = port.cfg
    L, H, D, bs = cfg.num_layers, cfg.num_heads, cfg.head_dim, 4
    rng = np.random.RandomState(3)
    prompt = rng.randint(1, 97, size=9).tolist()
    shape = (6, H, bs, D)
    vals = [[rng.randn(*shape).astype(np.float32) * 3 for _ in range(2)]
            for _ in range(L)]
    codes = [[rng.randint(-127, 128, size=shape).astype(np.int8)
              for _ in range(2)] for _ in range(L)]
    scales = [[np.abs(rng.randn(6, H)).astype(np.float32)
               for _ in range(2)] for _ in range(L)]

    def fill(pkg, cache):
        import jax.numpy as jnp
        layers = []
        for li, layer in enumerate(cache.pool.layers):
            if kv == "int8":
                new = (codes[li][0], codes[li][1], scales[li][0],
                       scales[li][1])
            else:
                new = tuple(v for v in vals[li])
            if pkg.name == "port":
                for t, v in zip(layer, new):
                    t.copy_(torch.from_numpy(np.asarray(v)).to(t.dtype))
            else:
                dt = {"f32": jnp.float32, "bf16": jnp.bfloat16,
                      "int8": None}[kv]
                layers.append(tuple(
                    jnp.asarray(v) if (kv == "int8") else
                    jnp.asarray(v).astype(dt) for v in new))
        if pkg.name == "jax":
            cache.pool.layers = layers

    def dev_values(pkg, cache, blocks):
        out = []
        for layer in cache.pool.layers:
            for a in layer:
                if pkg.name == "port":
                    v = a[torch.as_tensor(blocks)]
                    v = v.numpy() if v.dtype == torch.int8 else \
                        v.float().numpy()
                else:
                    v = np.asarray(a[np.asarray(blocks)])
                    v = v if v.dtype == np.int8 else v.astype(np.float32)
                out.append(v)
        return out

    def run(pkg):
        Cache = BlockKVCache if pkg.name == "port" else JBlockKVCache
        kw = {"device": "cpu"} if pkg.name == "port" else {}
        cache = Cache(L, H, D, 1, 12, block_size=bs, num_blocks=6,
                      kv_dtype=kv, **kw)
        row, _ = cache.acquire(prompt, 12)
        fill(pkg, cache)
        cache.commit_prefill(row, len(prompt))
        cache.insert_prefix(row, prompt)
        cache.release(row)
        tier = _tier(pkg, blocks=8, block_size=bs)
        assert tier.demote(cache) == (2, 2)
        host = [[np.asarray(x).copy() for layer in tier.store.read(b)
                 for x in layer] for b in (0, 1)]
        assert tier.promote(cache, prompt + [5]) == 2
        ents = list(cache.pool._prefix.values())
        dev = dev_values(pkg, cache, [e.block for e in ents])
        if pkg.name == "port":
            # the promoted blocks against the host rows they came from
            for ent in ents:
                rows = tier.store.read(tier.store.get(ent.key).block)
                for layer, (kc, vc, ks, vs) in zip(cache.pool.layers, rows):
                    if kv == "int8":
                        want = (kc, vc, ks, vs)
                    else:
                        want = [torch.from_numpy(kv_tier._np_dequantize(
                            c, sc[:, None, None])).to(layer[0].dtype)
                            for c, sc in ((kc, ks), (vc, vs))]
                    for t, w in zip(layer, want):
                        assert torch.equal(t[ent.block], torch.as_tensor(w))
        cache.flush_prefix_cache()
        tier.flush()
        assert tier.leaked() == 0 and cache.allocator.leaked() == 1
        return host, dev

    (jh, jd), (th, td) = run(jax_side), run(port)
    for a, b in zip(jh, th):
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and np.array_equal(x, y)
    for x, y in zip(jd, td):
        assert x.dtype == y.dtype
        if x.dtype == np.int8:
            assert np.array_equal(x, y)
        else:
            assert np.array_equal(x.view(np.int32), y.view(np.int32))


def test_step_signatures_equal_with_and_without_a_tier(pkgs):
    """The counterpart of the reference's
    ``predict_serving_compiles(host_tier=True)`` check: sessions through
    a tiered engine (demoted, promoted, resumed) add no step signature
    beyond a tier-free engine's over the same requests."""
    _, port = pkgs
    rounds = [_prompts((12,), seed=9)[0], _prompts((12,), seed=9)[0]]

    def signatures(tier):
        model = GPTForCausalLM(GPTConfig(**GEOM), device="cpu").eval()
        model.load_state_dict(port.model.state_dict())
        eng = ServingEngine(model, **ENGINE, kv_tier=tier, device="cpu")
        for p in rounds:
            eng.submit(p, max_new_tokens=4,
                       **({"session": "u"} if tier is not None else {}))
            eng.run_until_idle()
            eng.cache.flush_prefix_cache()
        return {k: e["traces"]["count"]
                for k, e in model._step_compile_cache.items()}

    tier = _tier(port)
    assert signatures(tier) == signatures(None)
    assert tier.stats()["migrated_promote_blocks"] > 0


def test_predict_serving_compiles_host_tier_is_validated_noop():
    """The reference's predictor check, on the port's predictor: the
    host tier and its sessions are a validated no-op, equal to the
    reference's predictions and refusals."""
    rounds = [[(list(range(1, 13)), 4)], [(list(range(1, 13)), 4)]]
    kw = dict(buckets=[8, 16], max_len=64, block_size=4)
    base = predict_serving_compiles(rounds, **kw)
    tiered = predict_serving_compiles(rounds, host_tier=True,
                                      sessions=1000, **kw)
    assert tiered == base == jpredict(rounds, host_tier=True,
                                      sessions=1000, **kw)
    with pytest.raises(ValueError, match="host_tier"):
        predict_serving_compiles(rounds, buckets=[8], max_len=64,
                                 sessions=5)
    with pytest.raises(ValueError, match="paged"):
        predict_serving_compiles(rounds, buckets=[8], max_len=64,
                                 paged=False, host_tier=True)


def test_lifecycle_linter_clean_on_kv_tier():
    """The reference's linter test over the host tier, on the port's
    ``kv_tier.py``: clean, and the reference's checker agrees."""
    import dataclasses
    import os
    path = os.path.join(os.path.dirname(kv_tier.__file__), "kv_tier.py")
    r = lifecycle.lint_files([path])
    assert not r.diagnostics, [str(d) for d in r.diagnostics]
    assert [dataclasses.asdict(d) for d in
            jlifecycle.lint_files([path]).diagnostics] == []


# ------------------------------------------------------------ load generator
def test_loadgen_returning_users_like_the_reference(pkgs):
    """tools/ci.sh's returning-users leg (slots 1, buckets 8/16/32,
    4-8-token prompts, 2-4 new tokens, returning 0.9 at 2-3 turns, 64
    host blocks demoting at every step, a virtual clock at 5 ms a step,
    Poisson from seed 3): the trace bytes equal the reference's, and the
    run and its byte-identical replay give the reference's report
    (``sessions`` included), decisions and tokens; the capacity, resume
    and zero-leak gates hold."""
    kw = dict(mode="poisson", rate=12.0, duration=1.0, seed=3,
              vocab_size=97, prompt_tokens=(4, 8), new_tokens=(2, 4),
              returning_frac=0.9, turns_per_session=(2, 3))
    a, b = tloadgen.LoadGen(**kw), jloadgen.LoadGen(**kw)
    assert a.trace_bytes() == b.trace_bytes()
    assert any(x.session for x in a.schedule())
    trace = json.loads(a.trace_bytes())

    def run(pkg, lg):
        vc = pkg.lg.VirtualClock()
        tier = _tier(pkg, blocks=64, block_size=16)
        eng = pkg.Engine(pkg.model, max_slots=1, max_len=64,
                         buckets=[8, 16, 32], max_queue=32, kv_tier=tier,
                         clock=vc.now, **pkg.kw)
        pkg.lg.warmup(eng)
        rep = lg.run(eng, clock=vc, step_cost_ms=5.0)
        reqs = sorted(eng._all, key=lambda r: r.id)
        return rep, [(r.session, r.state, list(r.tokens)) for r in reqs]

    out = _both(pkgs, lambda pkg: run(pkg, pkg.lg.LoadGen(**kw)))
    replay = _both(pkgs, lambda pkg: run(pkg,
                                         pkg.lg.LoadGen.from_trace(trace)))
    # a replayed session trace's rows carry the decode columns, so its
    # report also counts tenants (base only), in both packages
    assert replay[0].pop("per_tenant")["base"]["completed"] == \
        out[0]["completed"]
    assert replay[0].pop("leaked_lora_pages") == 0
    assert replay == out
    rep = out[0]
    s = rep["sessions"]
    assert rep["exceptions"] == 0 and rep["leaked_kv_blocks"] == 0
    assert s["sessions_resumed"] >= 1
    assert s["sessions_peak"] > s["device_blocks"]
    assert s["migrated_demote_blocks"] >= s["migrated_promote_blocks"] >= 1
    assert s["leaked_host_blocks"] == 0


def test_loadgen_cli_returning_users_gates(capsys):
    """The port's CLI on the CPU with the returning-users leg's options:
    every gate passes (resumed, capacity beyond the device pool, no
    leak on either tier, nothing captured after the warm-up)."""
    names = ["serving_host_tier", "serving_host_blocks",
             "serving_demote_idle_ms"]
    saved = tflags.get_flags(names)
    try:
        rc = tloadgen.main([
            "--device", "cpu", "--model", "gpt2-tiny", "--mode", "poisson",
            "--rate", "12", "--duration", "1", "--seed", "3", "--slots", "1",
            "--max-len", "64", "--buckets", "8,16,32", "--prompt-tokens",
            "4:8", "--new-tokens", "2:4", "--returning-frac", "0.9",
            "--turns-per-session", "2:3", "--host-blocks", "64",
            "--demote-idle-ms", "0", "--virtual-step-ms", "5", "--json",
            "--expect-resumed-min", "1", "--expect-zero-leaks",
            "--expect-zero-new-compiles", "--expect-capacity-gt-device"])
    finally:
        tflags.set_flags(saved)
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0, rep
    assert rep["sessions"]["sessions_resumed"] >= 1
