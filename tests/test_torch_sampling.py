"""The port's sampling chain (``paddle_tpu_torch/serving/decoding.py``)
and sampled serving against the JAX package on the CPU.

The JAX side runs with 64-bit types off (``jax.enable_x64(False)``),
as the JAX package runs outside this test harness, whose conftest turns
them on: its seeds then wrap to 32 bits and its accept draws are
float32, which is what the port reproduces (``paddle_tpu_torch/prng.py``).

- ``process_logits`` on the same logits over a grid of temperature,
  top-k and top-p (the disabling values 0, 1 and k >= V included) within
  1e-6 relative, the filtered set equal;
- ``sample_tokens``, ``verify_tokens`` (K 0, 1, 3) and ``sample_first``:
  the same tokens, accept flags and keys;
- ``DecodeParams`` validation (``tests/test_serving_decoding.py:226``);
- the engine against the JAX engine on the tiny GPT of
  ``tests/test_torch_serving.py``: sampled requests (mixed with greedy
  ones) give the same tokens, exactly, at megastep 1 and 2, f32 and int8
  pools; resubmitted in another order into a fresh engine they give the
  same bytes per seed, and another seed moves them
  (``test_sampled_restart_byte_identity``);
- a greedy-only batch sorts nothing and draws nothing (its graph is the
  greedy one), a batch with one sampled row does both.
"""

import torch_threads  # noqa: F401  (one worker's share of the cores)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.models.gpt import GPTConfig as JGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JGPT
from paddle_tpu.serving import ServingEngine as JServingEngine
from paddle_tpu.serving import decoding as jd
from paddle_tpu_torch import prng
from paddle_tpu_torch.models import generation as gen
from paddle_tpu_torch.models.convert import gpt_state_from_numpy
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.serving import DecodeParams, ServingEngine
from paddle_tpu_torch.serving import decoding as td
from test_torch_serving import ENGINE, GEOM

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


def _samp(rows, vocab, temp, top_k, top_p, seed=0):
    keys = np.stack([td.request_key(seed + i) for i in range(rows)])
    np_samp = (np.asarray(temp, np.float32), np.asarray(top_k, np.int32),
               np.asarray(top_p, np.float32), keys,
               np.zeros((rows, vocab), np.float32))
    jsamp = tuple(jnp.asarray(a) for a in np_samp)
    tsamp = tuple(torch.from_numpy(a.astype(np.int64) if a is keys else a)
                  for a in np_samp)
    return jsamp, tsamp


# ------------------------------------------------------ the processors
GRID = [(t, k, p) for t in (0.0, 0.7, 1.0, 1.5) for k in (0, 1, 5, 97, 500)
        for p in (0.0, 0.3, 0.9, 1.0)]


def test_process_logits_matches_jax():
    rng = np.random.RandomState(0)
    v = 97
    temp, top_k, top_p = (np.asarray(c) for c in zip(*GRID))
    logits = (rng.randn(len(GRID), v) * 3).astype(np.float32)
    logits[::7, :4] = logits[::7, 4:5]        # ties across the cut
    want = np.asarray(jd.process_logits(
        jnp.asarray(logits), jnp.asarray(temp, jnp.float32),
        jnp.asarray(top_k, jnp.int32), jnp.asarray(top_p, jnp.float32)))
    got = td.process_logits(
        torch.from_numpy(logits), torch.from_numpy(temp.astype(np.float32)),
        torch.from_numpy(top_k.astype(np.int32)),
        torch.from_numpy(top_p.astype(np.float32))).numpy()
    np.testing.assert_array_equal(got == td.NEG_MASK, want == jd.NEG_MASK)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    kept = (got != td.NEG_MASK).sum(-1)
    assert kept.min() == 1 and kept.max() == v    # both extremes reached


def test_sample_tokens_match_jax():
    rng = np.random.RandomState(1)
    rows, v = len(GRID), 97
    logits = (rng.randn(rows, v) * 2).astype(np.float32)
    jsamp, tsamp = _samp(rows, v, *zip(*GRID), seed=100)
    jt, jk = jd.sample_tokens(jnp.asarray(logits), jsamp)
    tt, tk = td.sample_tokens(torch.from_numpy(logits), tsamp)
    assert tt.dtype == torch.int32 and tk.dtype == torch.int64
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    # greedy rows take the argmax
    greedy = np.asarray([t == 0 for t, _, _ in GRID])
    np.testing.assert_array_equal(tt.numpy()[greedy],
                                  logits.argmax(-1)[greedy])


@pytest.mark.parametrize("k", [0, 1, 3])
def test_verify_tokens_match_jax(k):
    rng = np.random.RandomState(2 + k)
    rows, v = len(GRID), 97
    logits = (rng.randn(rows, k + 1, v) * 2).astype(np.float32)
    drafts = rng.randint(0, v, size=(rows, k)).astype(np.int32)
    if k:
        # half the first drafts are the argmax (accepted by greedy rows)
        drafts[::2, 0] = logits[::2, 0].argmax(-1)
    jsamp, tsamp = _samp(rows, v, *zip(*GRID), seed=200)
    want = jd.verify_tokens(jnp.asarray(logits), jnp.asarray(drafts), jsamp)
    got = td.verify_tokens(torch.from_numpy(logits), torch.from_numpy(drafts),
                           tsamp)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[1].dtype == torch.bool and tuple(got[1].shape) == (rows, k)
    if k:
        assert got[1].any() and not got[1].all()


def test_sample_first_matches_jax():
    rng = np.random.RandomState(3)
    row = (rng.randn(97) * 2).astype(np.float32)
    for seed, (t, k, p) in enumerate(GRID[::3]):
        jp = jd.DecodeParams(temperature=t, top_k=k, top_p=p, seed=seed)
        tp = DecodeParams(temperature=t, top_k=k, top_p=p, seed=seed)
        jtok, jkey = jd.sample_first(row, jp, jd.request_key(seed))
        ttok, tkey = td.sample_first(torch.from_numpy(row), tp,
                                     td.request_key(seed))
        assert ttok == jtok
        assert tkey.dtype == np.uint32
        np.testing.assert_array_equal(tkey, jkey)


def test_request_key_and_neutral_samp_match_jax():
    for seed in (0, 7, 2 ** 32 + 5, -3):
        np.testing.assert_array_equal(td.request_key(seed),
                                      jd.request_key(seed))
        assert td.request_key(seed).dtype == np.uint32
    for a, b in zip(td.neutral_samp(3, 11), jd.neutral_samp(3, 11)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert td.NEG_MASK == jd.NEG_MASK


def test_decode_params_validation(models):
    _, tm = models
    for bad in (dict(temperature=-0.1), dict(top_k=-1),
                dict(top_p=1.5), dict(top_p=-0.2)):
        with pytest.raises(ValueError):
            DecodeParams(**bad)
    eng = ServingEngine(tm, device="cpu", **ENGINE)
    with pytest.raises(ValueError):
        eng.submit([1, 2], temperature=-1.0)
    with pytest.raises(ValueError):
        eng.submit([1, 2], decode=DecodeParams(temperature=0.5),
                   temperature=0.7)   # decode= excludes the fields
    # json_mode on an engine without a grammar: the reference's
    # ValueError (tests/test_serving_decoding.py:199)
    with pytest.raises(ValueError, match="grammar"):
        eng.submit([1, 2], decode=DecodeParams(json_mode=True))
    with pytest.raises(ValueError, match="grammar"):
        eng.submit([1, 2], json_mode=True)


# ------------------------------------------------------------ the engine
def _prompts(sizes, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, 97, size=n).tolist() for n in sizes]


def _specs(prompts, seed=11):
    """Sampled requests with distinct seeds (one with top-k and top-p
    off), and a greedy one among them."""
    specs = []
    for i, p in enumerate(prompts):
        kw = dict(SAMPLED, seed=seed + i)
        if i == 1:
            kw = dict(temperature=1.0, seed=seed + i)
        if i == 2:
            kw = {}
        specs.append((p, dict(kw, max_new_tokens=7)))
    return specs


def _run(eng, specs):
    reqs = [eng.submit(p, **kw) for p, kw in specs]
    eng.run_until_idle()
    assert all(r.done for r in reqs)
    return [r.output_ids for r in reqs]


@pytest.mark.parametrize("kv", ["f32", "int8"])
@pytest.mark.parametrize("megastep", [1, 2])
def test_sampled_engine_matches_jax(models, kv, megastep):
    jm, tm = models
    pt.set_flags({"serving_attn_impl": "xla"})
    specs = _specs(_prompts((3, 7, 5, 11, 6)))
    want = _run(JServingEngine(jm, kv_dtype=kv, megastep=megastep, **ENGINE),
                specs)
    eng = ServingEngine(tm, kv_dtype=kv, megastep=megastep, device="cpu",
                        **ENGINE)
    assert _run(eng, specs) == want
    # the sampled graph served; the greedy one too where no row sampled
    ent = tm._step_compile_cache[
        ("decode_mega", megastep, kv, "kernel") if megastep > 1
        else ("decode_paged", kv, "kernel")]
    assert ent["graphs"]["sampled"].signatures


def test_sampled_restart_byte_identity(models):
    """Sampled output is a function of (request, seed): a fresh engine
    fed the same requests in reverse order (other slots, other batch
    mates) gives every request the same bytes; another seed moves
    them."""
    _, tm = models
    specs = _specs(_prompts((4, 6, 5, 9), seed=3))
    a = _run(ServingEngine(tm, device="cpu", **ENGINE), specs)
    b = _run(ServingEngine(tm, device="cpu", **ENGINE), specs[::-1])[::-1]
    assert a == b
    c = _run(ServingEngine(tm, device="cpu", **ENGINE),
             _specs(_prompts((4, 6, 5, 9), seed=3), seed=12))
    assert a != c, "a seed change moved no sampled token"


def test_greedy_batch_sorts_and_draws_nothing(models, monkeypatch):
    """A batch with no sampled row runs the greedy body: no sort and no
    threefry hash, and its keys are not touched; one sampled row makes
    the step sort and draw."""
    _, tm = models
    calls = {"sort": 0, "hash": 0}
    sort, hash_ = torch.sort, prng.threefry2x32

    def counted_sort(*a, **kw):
        calls["sort"] += 1
        return sort(*a, **kw)

    def counted_hash(*a, **kw):
        calls["hash"] += 1
        return hash_(*a, **kw)

    monkeypatch.setattr(torch, "sort", counted_sort)
    monkeypatch.setattr(prng, "threefry2x32", counted_hash)
    eng = ServingEngine(tm, device="cpu", **ENGINE)
    greedy = [eng.submit(p, max_new_tokens=5) for p in _prompts((3, 6))]
    keys = [r._key.copy() for r in greedy]
    eng.run_until_idle()
    assert calls == {"sort": 0, "hash": 0}
    assert all((r._key == k).all() for r, k in zip(greedy, keys))
    assert eng._mask is None
    dec = gen.decode_step_paged(tm, kv_dtype="f32", attn_impl="kernel")
    assert dec["graphs"]["greedy"].signatures
    eng.submit([5, 6, 7], max_new_tokens=4, **SAMPLED, seed=1)
    eng.submit([8, 9], max_new_tokens=4)
    eng.run_until_idle()
    assert calls["sort"] > 0 and calls["hash"] > 0
