"""The port's serving step cache and its device stop tables on the CPU,
against the JAX package: the stop tables (``stop_table_rows``,
``stops_fit``, ``stops_advance``, ``stops_matched``) equal JAX's on
seeded token streams, the step-cache contract (decode specialised once,
each prefill bucket once, a ``set_flags`` retiring every entry),
``swap_weights`` (JAX's errors, parameters written in place, no new
entry, tokens equal to the JAX engine's after its own swap), and the
in-place pools the captured steps rely on.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.models.gpt import GPTConfig as JGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JGPT
from paddle_tpu.serving import ServingEngine as JServingEngine
from paddle_tpu.serving import decoding as jdec
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch import jit
from paddle_tpu_torch.models import generation as gen
from paddle_tpu_torch.models.convert import gpt_state_from_numpy
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.serving import ServingEngine
from paddle_tpu_torch.serving import decoding as tdec
from test_torch_serving import ENGINE, GEOM


@pytest.fixture(scope="module")
def models():
    pt.seed(7)
    jm = JGPT(JGPTConfig(**GEOM))
    jm.eval()
    arrays = {n: np.asarray(p.value) for n, p in jm.named_parameters()}
    return jm, arrays


def _port(arrays):
    tm = GPTForCausalLM(GPTConfig(**GEOM), device="cpu")
    tm.load_state_dict(gpt_state_from_numpy(arrays, "cpu"), strict=True)
    return tm.eval()


def _prompts(sizes, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, 97, size=n).tolist() for n in sizes]


# ------------------------------------------------------- the stop tables
#: self-overlapping patterns (the fail-chase matters) and plain ones
PATTERNS = [[[1, 1, 2], [2, 1, 2, 1]], [[3, 3, 3]], [[1, 2, 1, 2, 3]],
            [[0, 0], [2, 0, 2]], None, [[1, 2, 1, 1, 2, 1, 2, 2]]]


def _tables(rows):
    packs = [[], [], [], []]
    for r in rows:
        for i, a in enumerate(r):
            packs[i].append(a)
    return [np.stack(p) for p in packs]


def test_stop_table_rows_and_fit_match_jax():
    rng = np.random.RandomState(3)
    for pats in PATTERNS:
        tm = tdec.StopMatcher(pats) if pats else None
        jm = jdec.StopMatcher(pats) if pats else None
        for tok in rng.randint(0, 4, size=5):
            if pats:
                tm.feed(tok)
                jm.feed(tok)
        for a, b in zip(tdec.stop_table_rows(tm), jdec.stop_table_rows(jm)):
            assert a.dtype == b.dtype == np.int32
            np.testing.assert_array_equal(a, b)
    for stops in ([[1] * tdec.STOP_MAX_LEN] * tdec.STOP_MAX_SEQS,
                  [[1]] * (tdec.STOP_MAX_SEQS + 1),
                  [[1] * (tdec.STOP_MAX_LEN + 1)], []):
        assert tdec.stops_fit(stops) == jdec.stops_fit(stops)
    assert (tdec.STOP_MAX_SEQS, tdec.STOP_MAX_LEN) == \
        (jdec.STOP_MAX_SEQS, jdec.STOP_MAX_LEN)
    with pytest.raises(ValueError, match="stops_fit"):
        tdec.stop_table_rows(tdec.StopMatcher([[1] * 9]))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_stops_advance_and_matched_match_jax(seed):
    """Every slot's states after every token equal JAX's exactly and the
    port's own host matcher's; a padded slot (no stops) never fires. A
    slot that fires starts again from zero states on both sides, as a
    new request in that row would (the megastep freezes a finished row,
    so no state past a match is ever used)."""
    rng = np.random.RandomState(seed)
    matchers = [tdec.StopMatcher(p) if p else None for p in PATTERNS]
    pat, plen, fail, state = _tables(
        [tdec.stop_table_rows(m) for m in matchers])
    t_state = torch.from_numpy(state)
    j_state = jnp.asarray(state)
    tabs = [torch.from_numpy(a) for a in (pat, plen, fail)]
    jtabs = [jnp.asarray(a) for a in (pat, plen, fail)]
    fired = 0
    for _ in range(80):
        toks = rng.randint(0, 4, size=len(PATTERNS)).astype(np.int32)
        t_state = tdec.stops_advance(torch.from_numpy(toks), *tabs, t_state)
        j_state = jdec.stops_advance(jnp.asarray(toks), *jtabs, j_state)
        assert t_state.dtype == torch.int32
        np.testing.assert_array_equal(t_state.numpy(), np.asarray(j_state))
        hit = tdec.stops_matched(t_state, tabs[1]).numpy()
        np.testing.assert_array_equal(
            hit, np.asarray(jdec.stops_matched(j_state, jtabs[1])))
        for i, m in enumerate(matchers):
            if m is None:
                assert not hit[i]
                continue
            assert m.feed(int(toks[i])) == bool(hit[i])
            assert t_state[i, :len(m.patterns)].tolist() == m.states
            if hit[i]:
                fired += 1
                matchers[i] = tdec.StopMatcher(m.patterns)
                t_state[i] = 0
                j_state = j_state.at[i].set(0)
    assert fired >= 10


# ------------------------------------------------------- the step cache
def test_decode_specialises_once_prefill_once_per_bucket(models):
    """The step-cache contract of ``tests/test_serving.py:62``: across
    many requests of many lengths the decode entry specialises once and
    each prefill bucket once (block remapping, prefix sharing and
    copy-on-write are data); a ``set_flags`` retires every entry, and
    the next call raises the count."""
    _, arrays = models
    tm = _port(arrays)
    eng = ServingEngine(tm, max_slots=3, max_len=32, buckets=[4, 8, 16],
                        max_queue=32, block_size=4, device="cpu")
    for p in _prompts((2, 3, 4, 6, 7, 9, 13, 15), seed=1):
        eng.submit(p, max_new_tokens=4)
    eng.run_until_idle()
    dec = gen.decode_step_paged(tm, "f32", "kernel")
    assert dec["traces"]["count"] == 1
    used = {b: e["traces"]["count"] for b, e in eng._prefill_fns.items()}
    assert used == {4: 1, 8: 1, 16: 1}
    keys = set(tm._step_compile_cache)
    assert ("decode_paged", "f32", "kernel") in keys
    assert ("prefill_paged", 8, 3, 32, 4, eng.cache.num_blocks, "f32",
            "kernel") in keys
    tflags.set_flags({"serving_max_queue": 64})
    eng.submit([5, 6, 7], max_new_tokens=3)
    eng.run_until_idle()
    assert gen.decode_step_paged(tm, "f32", "kernel")["traces"]["count"] \
        == 2
    assert eng._prefill_fns[4]["traces"]["count"] == 2
    assert gen.decode_step_paged(tm, "f32", "kernel") is not dec


def test_pools_stay_the_same_tensors(models):
    """``cache.arrays()`` hands out the same tensor objects before and
    after prefill, decode and megastep dispatches (what a graph holding
    them by address relies on); ``set_arrays`` refuses any other."""
    _, arrays = models
    tm = _port(arrays)
    for kv in ("f32", "int8"):
        eng = ServingEngine(tm, kv_dtype=kv, megastep=2, device="cpu",
                            **ENGINE)
        before = [list(layer) for layer in eng.cache.arrays()]
        big = [[90 + j] for j in range(tdec.STOP_MAX_SEQS + 1)]
        reqs = [eng.submit(p, max_new_tokens=5) for p in _prompts((3, 9))]
        reqs.append(eng.submit([4, 5], max_new_tokens=3, stop=big))
        eng.run_until_idle()
        assert eng.stats()["megastep_dispatches"] > 0
        assert eng.decode_steps > 0 and eng.prefill_dispatches > 0
        after = eng.cache.arrays()
        assert all(a is b for la, lb in zip(before, after)
                   for a, b in zip(la, lb))
        with pytest.raises(ValueError, match="in place"):
            eng.cache.set_arrays([tuple(a.clone() for a in layer)
                                  for layer in after])


def test_a_step_that_rebinds_its_pools_raises(models):
    _, arrays = models
    tm = _port(arrays)
    pools = tm.gpt.gen_block_pool(3, 4)

    def body(x, held):
        return (x + 1,), [tuple(a.clone() for a in layer) for layer in held]

    step = jit.HeldStep(body, tm.parameters(), {"count": 0}, None, "probe")
    with pytest.raises(RuntimeError, match="in place"):
        step([np.zeros(2, np.int32)], pools)


def test_no_capture_nests():
    assert jit.capture_enabled()
    with jit.no_capture():
        with jit.no_capture():
            assert not jit.capture_enabled()
        assert not jit.capture_enabled()
    assert jit.capture_enabled()


# ------------------------------------------------------------ swap_weights
def _second_state(arrays, seed=11):
    rng = np.random.RandomState(seed)
    return {n: (a + 0.05 * rng.randn(*a.shape)).astype(np.float32)
            for n, a in arrays.items()}


def test_swap_weights_errors_match_jax(models):
    jm, arrays = models
    tm = _port(arrays)
    jeng = JServingEngine(jm, **ENGINE)
    eng = ServingEngine(tm, device="cpu", **ENGINE)
    name = sorted(arrays)[0]
    bad = {"missing": {n: a for n, a in arrays.items() if n != name},
           "unknown": {**arrays, "gpt.extra.weight": arrays[name]},
           "shape": {**arrays, name: np.zeros((3, 3), np.float32)}}
    for what, state in bad.items():
        with pytest.raises(ValueError) as want:
            jeng.swap_weights(state)
        with pytest.raises(ValueError) as got:
            eng.swap_weights(state)
        assert str(got.value) == str(want.value), what
    assert eng.weight_version == 0


@pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
def test_swap_weights_mid_run_matches_jax(models, kv_dtype):
    """Swap to a second state between steps, with requests in flight:
    every parameter keeps its address, no entry is built and nothing
    specialises anew, and the tokens (old KV kept, as in the reference)
    equal the JAX engine's after its own swap of the same arrays."""
    jm, arrays = models
    tm = _port(arrays)
    new = _second_state(arrays)
    prompts = _prompts((3, 7, 5, 11), seed=4)
    geom = {**ENGINE, "max_slots": 4}
    pt.set_flags({"serving_attn_impl": "xla"})
    out = []
    for side in ("jax", "port"):
        if side == "jax":
            for n, p in jm.named_parameters():
                p.value = jnp.asarray(arrays[n])
            eng = JServingEngine(jm, kv_dtype=kv_dtype, megastep=2, **geom)
        else:
            eng = ServingEngine(tm, kv_dtype=kv_dtype, megastep=2,
                                device="cpu", **geom)
        reqs = [eng.submit(p, max_new_tokens=7) for p in prompts]
        eng.step()
        assert all(r.state == "running" for r in reqs)
        if side == "port":
            ptrs = [p.data_ptr() for p in tm.parameters()]
            entries = set(tm._step_compile_cache)
            counts = {k: e["traces"]["count"]
                      for k, e in tm._step_compile_cache.items()}
        assert eng.swap_weights(new) == 1 and eng.weight_version == 1
        eng.run_until_idle()
        out.append([r.output_ids for r in reqs])
    assert [p.data_ptr() for p in tm.parameters()] == ptrs
    for n, p in tm.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), new[n])
    assert set(tm._step_compile_cache) == entries
    assert {k: e["traces"]["count"]
            for k, e in tm._step_compile_cache.items()} == counts
    assert out[1] == out[0]
    for n, p in jm.named_parameters():
        p.value = jnp.asarray(arrays[n])
