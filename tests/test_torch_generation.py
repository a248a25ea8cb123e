"""The port's offline generation (``greedy_search``, ``sample``,
``beam_search``) against the JAX package's on the CPU, with the weights
carried across by ``gpt_state_from_numpy``: ids equal, beam scores
within 1e-5 relative; the model's fixed cache reused from call to call
(the same tensors, no new input signature); the reference's refusals.

The model is ``tests/test_torch_dense_serving.py``'s tiny GPT (2 layers,
h 128, ``init_std`` 0.2). The JAX side runs with 64-bit types off, JAX's
default and what the port's threefry reproduces
(``tests/test_torch_sampling.py``).
"""

import torch_threads  # noqa: F401  (one worker's share of the cores)
import jax
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.models import generation as jgen
from paddle_tpu.models.gpt import GPTConfig as JGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JGPT
from paddle_tpu_torch.models import generation as gen
from paddle_tpu_torch.ops.cuda import paged_attention as pa
from test_torch_dense_serving import GEOM, _port


@pytest.fixture(autouse=True)
def jax_without_x64():
    with jax.enable_x64(False):
        yield


@pytest.fixture(scope="module")
def models():
    pt.seed(3)
    jm = JGPT(JGPTConfig(**GEOM))
    jm.eval()
    arrays = {n: np.asarray(p.value) for n, p in jm.named_parameters()}
    return jm, _port(arrays)


def _ids(b, s, seed=0):
    return np.random.RandomState(seed).randint(1, 97, size=(b, s))


@pytest.mark.parametrize("eos", [False, True])
@pytest.mark.parametrize("cache_len", [None, 32])
def test_greedy_search_matches_jax(models, eos, cache_len):
    """Two prompts of 5 tokens, 10 new tokens; with an eos that one row
    produces early (its later tokens are the eos, the other row goes on);
    no kernel launches on the CPU."""
    jm, tm = models
    ids = _ids(2, 5)
    eos_id = None
    if eos:
        free = jgen.greedy_search(jm, ids, max_new_tokens=10)
        eos_id = int(free[0, 7])
    before = pa.launches
    want = jgen.greedy_search(jm, ids, max_new_tokens=10,
                              eos_token_id=eos_id, cache_len=cache_len)
    got = gen.greedy_search(tm, ids, max_new_tokens=10, eos_token_id=eos_id,
                            cache_len=cache_len)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert pa.launches == before
    if eos:
        assert (got[0, 8:] == eos_id).all()


@pytest.mark.parametrize("recipe", [
    dict(temperature=0.8, top_k=20, top_p=0.9, seed=3),
    dict(temperature=1.0, seed=11),
    dict(temperature=0.5, top_p=0.7, seed=2 ** 32 + 5)])
def test_sample_matches_jax(models, recipe):
    """Three rows, 9 new tokens: the first from the prefill logits, the
    rest from the sampled decode graph, every row from its key of
    ``split(PRNGKey(seed), 3)``."""
    jm, tm = models
    ids = _ids(3, 4, seed=1)
    want = jgen.sample(jm, ids, max_new_tokens=9, **recipe)
    got = gen.sample(tm, ids, max_new_tokens=9, **recipe)
    np.testing.assert_array_equal(got, want)
    assert len({tuple(r) for r in got[:, 4:]}) > 1


@pytest.mark.parametrize("beam, penalty, eos", [
    (3, 1.0, False), (4, 0.6, True), (1, 1.0, False)])
def test_beam_search_matches_jax(models, beam, penalty, eos):
    """Two prompts, 8 new tokens: ids equal, scores within 1e-5
    relative (the first step's log-softmax is torch's against
    ``jax.nn.log_softmax``; later steps score with the same numpy)."""
    jm, tm = models
    ids = _ids(2, 6, seed=2)
    eos_id = None
    if eos:
        eos_id = int(jgen.greedy_search(jm, ids, max_new_tokens=8)[1, 9])
    want_ids, want_scores = jgen.beam_search(
        jm, ids, beam_size=beam, max_new_tokens=8, length_penalty=penalty,
        eos_token_id=eos_id)
    got_ids, got_scores = gen.beam_search(
        tm, ids, beam_size=beam, max_new_tokens=8, length_penalty=penalty,
        eos_token_id=eos_id)
    np.testing.assert_array_equal(got_ids, want_ids)
    np.testing.assert_allclose(got_scores, want_scores, rtol=1e-5, atol=0)
    if beam == 1:
        np.testing.assert_array_equal(
            got_ids, gen.greedy_search(tm, ids, max_new_tokens=8))


def test_offline_cache_is_reused_across_calls(models):
    """A second call of the same batch and capacity decodes in the same
    tensors (on the card: the graphs the first call captured) and adds no
    signature; a call at another batch gets a cache of its own; results
    do not depend on what the cache held before."""
    _, tm = models
    ids = _ids(2, 5, seed=4)
    first = gen.greedy_search(tm, ids, max_new_tokens=6, cache_len=24)
    cache = gen.fixed_cache(tm, 2, 24)
    ptrs = [a.data_ptr() for layer in cache for a in layer]
    count = gen.decode_step(tm)["traces"]["count"]
    gen.sample(tm, ids[::-1].copy(), max_new_tokens=6, cache_len=24, seed=1)
    again = gen.greedy_search(tm, ids, max_new_tokens=6, cache_len=24)
    np.testing.assert_array_equal(again, first)
    assert gen.fixed_cache(tm, 2, 24) is cache
    assert [a.data_ptr() for layer in cache for a in layer] == ptrs
    # the sampled graph is a signature of its own; greedy added none
    assert gen.decode_step(tm)["traces"]["count"] == count + 1
    one = gen.greedy_search(tm, ids[:1], max_new_tokens=6, cache_len=24)
    np.testing.assert_array_equal(one, first[:1])
    assert gen.fixed_cache(tm, 1, 24) is not cache


def test_offline_cache_keeps_one_capacity_per_batch(models):
    """Calls at new prompt lengths (``cache_len=None``, so a new capacity
    each) keep one cache per batch, of the last capacity, and drop the
    graphs held over the cache they free (a graph entered by hand here:
    the CPU captures none); graphs over other tensors stay. Each call's
    ids equal JAX's."""
    jm, tm = models
    greedy = gen.decode_step(tm)["graphs"]["greedy"]
    for s0 in (4, 6, 9):
        ids = _ids(2, s0, seed=s0)
        got = gen.greedy_search(tm, ids, max_new_tokens=5)
        np.testing.assert_array_equal(
            got, jgen.greedy_search(jm, ids, max_new_tokens=5))
        cache = gen.fixed_cache(tm, 2, s0 + 5)
        assert tm._fixed_caches[2] == (s0 + 5, cache)
        over = tuple((a.data_ptr(), "tensor", tuple(a.shape), a.dtype)
                     for layer in cache for a in layer)
        other = ((-1, "tensor", (1,), torch.float32),)
        greedy.graphs[((), over, ())] = object()
        greedy.graphs[((), other, ())] = object()
    assert set(greedy.graphs) == {((), over, ()), ((), other, ())}
    gen.greedy_search(tm, _ids(1, 3), max_new_tokens=2)
    assert tm._fixed_caches[2][0] == 14 and tm._fixed_caches[1][0] == 5
    assert set(greedy.graphs) == {((), over, ()), ((), other, ())}
    gen.greedy_search(tm, _ids(2, 3), max_new_tokens=2)
    assert set(greedy.graphs) == {((), other, ())}
    greedy.graphs.clear()


def test_generation_refusals_match_jax(models):
    jm, tm = models
    ids = _ids(1, 6)
    cases = [
        (lambda m, g: g.greedy_search(m, ids, max_new_tokens=8,
                                      cache_len=10)),
        (lambda m, g: g.beam_search(m, ids, max_new_tokens=8, cache_len=12)),
        (lambda m, g: g.sample(m, ids, max_new_tokens=70)),
        (lambda m, g: g.sample(m, ids, max_new_tokens=4, temperature=-1.0)),
        (lambda m, g: g.sample(m, ids, max_new_tokens=4, top_p=1.5)),
    ]
    for i, call in enumerate(cases):
        with pytest.raises(ValueError) as want:
            call(jm, jgen)
        with pytest.raises(ValueError) as got:
            call(tm, gen)
        assert str(got.value) == str(want.value), i
    with pytest.raises(ValueError) as want:
        jgen.verify_step(jm, 0)
    with pytest.raises(ValueError) as got:
        gen.verify_step(tm, 0)
    assert str(got.value) == str(want.value)
    assert torch.is_grad_enabled()
