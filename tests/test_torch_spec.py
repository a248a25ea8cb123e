"""Speculative decoding in the port against the JAX package on the CPU:
the n-gram drafter, the paged verify step, the cache's rollback and the
engine at K = 2 (``tests/test_serving_decoding.py:77,132``).

- ``draft_ngram`` on random and periodic contexts: the same drafts;
- ``verify_step_paged`` from identical inputs (K+1 = 3 query rows per
  slot through the paged attention's plain version), greedy and sampled,
  f32 and int8 pools: the same chosen tokens, accept flags and keys,
  logits and pools within the GPT tests' f32 bound (1e-5), int8 codes
  bit-equal;
- ``BlockKVCache.rollback`` across a block boundary frees nothing, and
  refuses what the reference's refuses;
- the engine at K = 2: greedy tokens equal K = 0's and the JAX engine's;
  sampled tokens equal the JAX engine's at K = 2 and replay
  byte-identically in another order; the acceptance counters;
- the constructor's refusals (megastep > 1 with K > 0, K >= max_len)
  with the JAX engine's messages.

The JAX side runs with 64-bit types off, as in
``tests/test_torch_sampling.py``.
"""

import torch_threads  # noqa: F401  (one worker's share of the cores)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.models.generation import draft_ngram as jdraft
from paddle_tpu.models.generation import verify_step_paged as jverify
from paddle_tpu.models.gpt import GPTConfig as JGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JGPT
from paddle_tpu.serving import ServingEngine as JServingEngine
from paddle_tpu.serving import decoding as jd
from paddle_tpu.serving.kv_cache import BlockKVCache as JBlockKVCache
from paddle_tpu_torch.models import generation as gen
from paddle_tpu_torch.models.convert import gpt_state_from_numpy
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.ops.cuda import paged_attention as pa
from paddle_tpu_torch.serving import ServingEngine
from paddle_tpu_torch.serving import decoding as td
from paddle_tpu_torch.serving.kv_cache import BlockKVCache
from test_torch_megastep import POS, TABLES, _prefilled_pools
from test_torch_serving import ENGINE, GEOM

ATOL = 1e-5     # the f32 bound of tests/test_torch_gpt.py
K = 2
SAMPLED = dict(temperature=0.8, top_k=20, top_p=0.9)


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
    tm = GPTForCausalLM(GPTConfig(**GEOM), device="cpu")
    tm.load_state_dict(gpt_state_from_numpy(arrays, "cpu"), strict=True)
    return jm, tm.eval()


def _prompts(sizes, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, 97, size=n).tolist() for n in sizes]


# ------------------------------------------------------------ the drafter
def test_draft_ngram_matches_jax():
    rng = np.random.RandomState(0)
    contexts = [rng.randint(0, 6, size=n).tolist() for n in (1, 2, 5, 30)]
    contexts += [rng.randint(0, 97, size=40).tolist()]
    contexts += [[3, 1, 4] * 5, [3, 1, 4] * 5 + [1], [7] * 9, [1, 2] * 3 + [9]]
    for ctx in contexts:
        for k in (1, 2, 4, 7):
            for n in (1, 2, 3, 4):
                assert gen.draft_ngram(ctx, k, n) == jdraft(ctx, k, n), \
                    (ctx, k, n)
    assert gen.draft_ngram([3, 1, 4] * 5, 4) == [3, 1, 4, 3]


# -------------------------------------------------------- the verify step
@pytest.mark.parametrize("sampled", [False, True])
@pytest.mark.parametrize("kv", ["f32", "int8"])
def test_verify_step_matches_jax(models, kv, sampled):
    jm, tm = models
    pt.set_flags({"serving_attn_impl": "xla"})
    b, v = TABLES.shape[0], GEOM["vocab_size"]
    rng = np.random.RandomState(1)
    tokens = rng.randint(1, v, size=(b, K + 1)).astype(np.int32)
    temp = np.asarray([0.8, 0.0, 1.0, 0.0] if sampled else [0.0] * b,
                      np.float32)
    samp = (temp, np.asarray([20, 0, 0, 0], np.int32),
            np.asarray([0.9, 0, 0, 0], np.float32),
            np.stack([td.request_key(40 + i) for i in range(b)]),
            np.zeros((b, v), np.float32))
    pools = _prefilled_pools(jm, kv)
    want = jverify(jm, K, kv_dtype=kv)["fn"](
        jnp.asarray(tokens), jnp.asarray(POS), jnp.asarray(TABLES),
        [tuple(jnp.asarray(a) for a in layer) for layer in pools],
        tuple(jnp.asarray(a) for a in samp))
    (jchosen, jlogits, jpools, jq, jaccept, jkeys) = want
    tpools = [tuple(torch.from_numpy(a.copy()) for a in layer)
              for layer in pools]
    before = pa.launches
    got = gen.verify_step_paged(tm, K, kv_dtype=kv, attn_impl="kernel")["fn"](
        tokens, POS, TABLES, tpools, samp if sampled else None)
    (chosen, logits, newp, q, accept, keys) = got
    assert pa.launches == before and newp is tpools
    assert chosen.dtype == torch.int32 and accept.dtype == torch.bool
    np.testing.assert_array_equal(chosen.numpy(), np.asarray(jchosen))
    np.testing.assert_array_equal(accept.numpy(), np.asarray(jaccept))
    if sampled:
        np.testing.assert_array_equal(keys.numpy(), np.asarray(jkeys))
    else:
        assert keys is None
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=ATOL, rtol=0)
    for tl, jl in zip(newp, jpools):
        for a, w in zip(tl, jl):
            if a.dtype == torch.float32:
                np.testing.assert_allclose(a.numpy(), np.asarray(w),
                                           atol=ATOL, rtol=0)
            else:
                np.testing.assert_array_equal(a.numpy(), np.asarray(w))
    np.testing.assert_allclose(float(q), float(jq), rtol=1e-5)


def test_verify_needs_a_draft(models):
    jm, tm = models
    with pytest.raises(ValueError) as want:
        jverify(jm, 0)
    with pytest.raises(ValueError) as got:
        gen.verify_step_paged(tm, 0)
    assert str(got.value) == str(want.value)


# -------------------------------------------------------------- rollback
def test_rollback_across_a_block_boundary():
    """Row of block size 4 at length 3, advanced by K+1 = 4 (into its
    second block) and rolled back by 3: the length is 4 again, no block
    came back to the pool, on both sides; the refusals match."""
    sides = [JBlockKVCache(1, 1, 4, 2, 16, block_size=4),
             BlockKVCache(1, 1, 4, 2, 16, block_size=4)]
    for c in sides:
        row, shared = c.acquire([1, 2, 3], 3 + 5 + 2)
        assert shared == 0
        c.commit_prefill(row, 3)
        free = c.blocks_free
        c.advance(row, 4)
        c.rollback(row, 3)
        assert int(c.lengths[row]) == 4 and c.blocks_free == free
        c.rollback(row, 4)
        assert int(c.lengths[row]) == 0
    for n in (-1, 1):
        msgs = []
        for c in sides:
            with pytest.raises(ValueError) as e:
                c.rollback(0, n)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


# ------------------------------------------------------------ the engine
def _run(eng, specs):
    reqs = [eng.submit(p, **kw) for p, kw in specs]
    eng.run_until_idle()
    assert all(r.done for r in reqs)
    return [r.output_ids for r in reqs]


def _repetitive(n, seed=0):
    """Prompts with a repeated tail, where n-gram drafts get accepted."""
    rng = np.random.RandomState(seed)
    return [(rng.randint(1, 97, size=3).tolist() * 3)[:7 + i % 3]
            for i in range(n)]


@pytest.mark.parametrize("kv", ["f32", "int8"])
def test_greedy_spec_matches_k0_and_jax(models, kv):
    jm, tm = models
    pt.set_flags({"serving_attn_impl": "xla"})
    specs = [(p, {"max_new_tokens": 8})
             for p in _prompts((3, 7, 5)) + _repetitive(3)]
    base = _run(ServingEngine(tm, kv_dtype=kv, device="cpu", **ENGINE),
                specs)
    eng = ServingEngine(tm, kv_dtype=kv, spec_tokens=K, device="cpu",
                        **ENGINE)
    assert _run(eng, specs) == base
    assert _run(JServingEngine(jm, kv_dtype=kv, spec_tokens=K, **ENGINE),
                specs) == base
    st = eng.stats()
    assert st["spec_tokens"] == K and st["spec_proposed"] > 0
    assert 0 < st["spec_accepted"] <= st["spec_proposed"]
    assert st["spec_acceptance_rate"] == round(
        st["spec_accepted"] / st["spec_proposed"], 4)
    assert st["kv_blocks_used"] == 1 + st["prefix_entries"]
    ent = tm._step_compile_cache[("verify_paged", K, kv, "kernel")]
    assert ent["graphs"]["greedy"].signatures


def test_sampled_spec_matches_jax_and_replays(models):
    jm, tm = models
    pt.set_flags({"serving_attn_impl": "xla"})
    specs = [(p, dict(SAMPLED, seed=9 + i, max_new_tokens=8))
             for i, p in enumerate(_repetitive(3, seed=1) + _prompts((4, 6)))]
    specs[1] = (specs[1][0], {"max_new_tokens": 8})       # one greedy row
    want = _run(JServingEngine(jm, spec_tokens=K, **ENGINE), specs)
    eng = ServingEngine(tm, spec_tokens=K, device="cpu", **ENGINE)
    assert _run(eng, specs) == want
    assert eng.stats()["spec_accepted"] > 0
    again = _run(ServingEngine(tm, spec_tokens=K, device="cpu", **ENGINE),
                 specs[::-1])[::-1]
    assert again == want


def test_spec_refusals_match_jax(models):
    jm, tm = models
    for bad in (dict(spec_tokens=2, megastep=2), dict(spec_tokens=-1),
                dict(spec_tokens=ENGINE["max_len"])):
        with pytest.raises(ValueError) as want:
            JServingEngine(jm, **{**ENGINE, **bad})
        with pytest.raises(ValueError) as got:
            ServingEngine(tm, device="cpu", **{**ENGINE, **bad})
        assert str(got.value) == str(want.value), bad
    # spec_tokens rows of headroom are reserved per request
    jeng = JServingEngine(jm, spec_tokens=K, **ENGINE)
    eng = ServingEngine(tm, spec_tokens=K, device="cpu", **ENGINE)
    prompt = list(range(1, 21))
    with pytest.raises(ValueError) as want:
        jeng.submit(prompt, max_new_tokens=11)
    with pytest.raises(ValueError) as got:
        eng.submit(prompt, max_new_tokens=11)
    assert str(got.value) == str(want.value)
    eng.submit(prompt, max_new_tokens=10)
