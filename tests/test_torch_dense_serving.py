"""The port's fixed-capacity (slotted) KV cache and its dense serving
engine against the JAX package on the CPU, with the weights carried
across by ``gpt_state_from_numpy``:

- ``cache_scatter_write`` bit-equal to JAX's, a start clamped to
  ``capacity - s`` (and a negative one counted from the end) included;
- the slotted and the concat branches of ``GPTAttention``: logits and
  caches within the GPT tests' f32 bound (1e-5);
- ``SlotKVCache`` bookkeeping (``tests/test_serving.py:185,313,352``);
- ``ServingEngine(paged=False)``: tokens equal to the JAX dense engine's
  and to the port's ``greedy_search``, at spec K 0 and 3, with slot reuse
  after rollback; sampled requests equal the JAX engine's; one input
  signature per decode, verify and prefill key; a weight swap with
  nothing specialised anew; the refusals with the reference's messages.

The model is a tiny GPT (2 layers, h 128) drawn at ``init_std`` 0.2,
whose greedy tokens vary (at GPT-2's 0.02 they repeat after a few
steps). The JAX side runs with 64-bit types off, as in
``tests/test_torch_sampling.py``.
"""

import torch_threads  # noqa: F401  (one worker's share of the cores)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.dygraph.tape import no_grad
from paddle_tpu.dygraph.tensor import Tensor
from paddle_tpu.models.generation import greedy_search as jgreedy
from paddle_tpu.models.gpt import GPTConfig as JGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JGPT
from paddle_tpu.ops.attention_ops import \
    cache_scatter_write as jcache_scatter_write
from paddle_tpu.serving import ServingEngine as JServingEngine
from paddle_tpu.serving import SlotKVCache as JSlotKVCache
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch.models import generation as gen
from paddle_tpu_torch.models.convert import gpt_state_from_numpy
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.ops.attention_ops import cache_scatter_write
from paddle_tpu_torch.ops.cuda import paged_attention as pa
from paddle_tpu_torch.serving import ServingEngine
from paddle_tpu_torch.serving import SlotKVCache

GEOM = dict(vocab_size=97, max_position_embeddings=64, hidden_size=128,
            num_layers=2, num_heads=4, ffn_hidden_size=256, init_std=0.2)
ENGINE = dict(max_slots=2, max_len=32, buckets=[4, 8, 16], max_queue=16)
ATOL = 1e-5     # the f32 bound of tests/test_torch_gpt.py
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
    return jm, _port(arrays), arrays


def _port(arrays):
    tm = GPTForCausalLM(GPTConfig(**GEOM), device="cpu")
    tm.load_state_dict(gpt_state_from_numpy(arrays, "cpu"), strict=True)
    return tm.eval()


def _prompts(sizes, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, 97, size=n).tolist() for n in sizes]


def _run(eng, specs):
    reqs = [eng.submit(p, **kw) for p, kw in specs]
    eng.run_until_idle()
    assert all(r.done for r in reqs)
    return [r.output_ids for r in reqs]


# ---------------------------------------------------- cache_scatter_write
#: (pos, s) at capacity 8: vector and scalar offsets, a start of 7 and
#: of 6 with s 3 (clamped back to 5), a negative start (counted from the
#: end, then clamped)
WRITES = [([0, 5, 3], 1), ([2, 0, 5], 3), ([7, 6, 1], 3), (4, 2),
          ([-2, 0, 1], 2), ([-7, 3, 0], 1)]


@pytest.mark.parametrize("pos, s", WRITES)
def test_cache_scatter_write_matches_jax(pos, s):
    rng = np.random.RandomState(len(str(pos)) + s)
    buf = rng.randn(3, 2, 8, 4).astype(np.float32)
    new = rng.randn(3, 2, s, 4).astype(np.float32)
    want = jcache_scatter_write(jnp.asarray(buf), jnp.asarray(new),
                                jnp.asarray(pos, jnp.int32))
    tbuf = torch.from_numpy(buf.copy())
    out = cache_scatter_write(tbuf, torch.from_numpy(new),
                              torch.as_tensor(pos, dtype=torch.int32))
    assert out is tbuf
    np.testing.assert_array_equal(tbuf.numpy(), np.asarray(want))


def test_cache_scatter_write_clamps_at_the_end():
    """A row at ``pos = C - 1`` with s 3 lands on ``C-3 .. C-1``, over
    committed rows: XLA's clamp, reproduced (callers reserve headroom)."""
    buf = torch.zeros(1, 1, 8, 1)
    new = torch.tensor([1.0, 2.0, 3.0]).reshape(1, 1, 3, 1)
    cache_scatter_write(buf, new, torch.tensor([7]))
    assert buf.flatten().tolist() == [0, 0, 0, 0, 0, 1, 2, 3]


# ------------------------------------------- the slotted and concat branches
def _jax_forward(jm, ids, caches, **kw):
    with no_grad():
        logits, newc = jm(Tensor(ids.astype(np.int32), stop_gradient=True),
                          cache=[(Tensor(jnp.asarray(k), stop_gradient=True),
                                  Tensor(jnp.asarray(v), stop_gradient=True))
                                 for k, v in caches], **kw)
    return logits.numpy(), [(np.asarray(c[0].value), np.asarray(c[1].value))
                            for c in newc]


def _close_caches(got, want):
    assert len(got) == len(want)
    for (tk, tv), (jk, jv) in zip(got, want):
        np.testing.assert_allclose(tk.numpy(), jk, atol=ATOL, rtol=0)
        np.testing.assert_allclose(tv.numpy(), jv, atol=ATOL, rtol=0)


def test_slotted_prefill_decode_and_verify_match_jax(models):
    """A bucketed prefill of two prompts (lengths 6 and 3, padded to 8)
    into a 16-position cache at offset 0, one decode step at each row's
    length, then a 3-row verify-shaped step: logits and every cache row
    within 1e-5, the port's caches written in place."""
    jm, tm, _ = models
    rng = np.random.RandomState(1)
    lens = [6, 3]
    ids = np.zeros((2, 8), np.int64)
    for i, n in enumerate(lens):
        ids[i, :n] = rng.randint(1, 97, size=n)
    caches = tm.gpt.gen_fixed_cache(2, 16)
    assert all(a.shape == (2, 4, 16, 32) and a.dtype == torch.float32
               for layer in caches for a in layer)
    jcaches = [(np.zeros((2, 4, 16, 32), np.float32),) * 2
               for _ in caches]
    steps = [(ids, 0), (rng.randint(1, 97, size=(2, 1)), np.asarray(lens)),
             (rng.randint(1, 97, size=(2, 3)), np.asarray(lens) + 1)]
    for step_ids, pos in steps:
        jpos = pos if isinstance(pos, int) else jnp.asarray(pos, jnp.int32)
        want, jcaches = _jax_forward(jm, step_ids, jcaches, cache_pos=jpos)
        tpos = pos if isinstance(pos, int) else torch.from_numpy(pos)
        with torch.no_grad():
            got, newc = tm(torch.from_numpy(step_ids), cache=caches,
                           cache_pos=tpos)
        assert all(a is b for n, o in zip(newc, caches)
                   for a, b in zip(n, o))
        if isinstance(pos, int):
            for i, n in enumerate(lens):       # the real positions
                np.testing.assert_allclose(got[i, :n].numpy(),
                                           want[i, :n], atol=ATOL, rtol=0)
        else:
            np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
        _close_caches(caches, jcaches)


def test_concat_cache_matches_jax(models):
    """The concat branch: a 5-token prompt into ``gen_cache``'s empty
    cache, then one token at offset 5 and two at offset 6: the cache
    grows by the new rows and the attention is causal over it."""
    jm, tm, _ = models
    rng = np.random.RandomState(2)
    caches = tm.gpt.gen_cache(2)
    assert all(a.shape == (2, 4, 0, 32) for layer in caches for a in layer)
    jcaches = [(np.zeros((2, 4, 0, 32), np.float32),) * 2 for _ in caches]
    offset = 0
    for n in (5, 1, 2):
        ids = rng.randint(1, 97, size=(2, n))
        want, jcaches = _jax_forward(jm, ids, jcaches,
                                     position_offset=offset)
        with torch.no_grad():
            got, caches = tm(torch.from_numpy(ids), cache=caches,
                             position_offset=offset)
        offset += n
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
        assert caches[0][0].shape == (2, 4, offset, 32)
        _close_caches(caches, jcaches)


def test_fixed_cache_position_guard_matches_jax(models):
    jm, tm, _ = models
    ids = np.ones((1, 4), np.int64)
    with pytest.raises(ValueError) as want:
        _jax_forward(jm, ids, [(np.zeros((1, 4, 64, 32), np.float32),) * 2
                               for _ in range(2)], cache_pos=62)
    with pytest.raises(ValueError) as got:
        with torch.no_grad():
            tm(torch.from_numpy(ids), cache=tm.gpt.gen_fixed_cache(1, 64),
               cache_pos=62)
    assert str(got.value) == str(want.value)


# ------------------------------------------------------------ SlotKVCache
def test_slot_kv_cache_bookkeeping_matches_jax():
    """``tests/test_serving.py:185``: the lowest free slot first, release
    zeroes the length and returns the slot in order."""
    sides = [SlotKVCache(num_layers=1, num_heads=2, head_dim=4,
                         max_slots=2, max_len=8),
             JSlotKVCache(num_layers=1, num_heads=2, head_dim=4,
                          max_slots=2, max_len=8)]
    for c in sides:
        a, b = c.alloc(), c.alloc()
        assert (a, b) == (0, 1) and c.alloc() is None
        assert c.num_free == 0 and c.num_used == 2
        c.lengths[a] = 5
        c.release(a)
        assert c.lengths[a] == 0 and c.num_free == 1
        assert c.alloc() == 0
    layer = sides[0].arrays()[0]
    assert layer[0] is not layer[1] and layer[0].shape == (2, 2, 8, 4)


def test_slot_kv_advance_rollback_guards_match_jax():
    """``tests/test_serving.py:313``: advance and rollback, and their
    refusals with the reference's messages, leaving the state alone."""
    sides = [SlotKVCache(1, 2, 4, 2, 8), JSlotKVCache(1, 2, 4, 2, 8)]
    msgs = []
    for c in sides:
        s = c.alloc()
        c.lengths[s] = 3
        c.advance(s, 4)
        assert c.lengths[s] == 7
        c.rollback(s, 2)
        assert c.lengths[s] == 5
        errs = []
        for bad in (lambda: c.advance(s, 4), lambda: c.rollback(s, 6),
                    lambda: c.rollback(s, -1)):
            with pytest.raises(ValueError) as e:
                bad()
            errs.append(str(e.value))
        msgs.append(errs)
        assert c.lengths[s] == 5
    assert msgs[0] == msgs[1]


def test_write_prefill_batch_matches_single_writes_and_jax():
    """``tests/test_serving.py:352``: one batched write == single-slot
    writes, bit for bit, == the JAX cache's; in place; a count mismatch
    refused alike; ``set_arrays`` takes back only its own tensors."""
    kw = dict(num_layers=2, num_heads=2, head_dim=4, max_slots=3, max_len=8)
    a, b, j = SlotKVCache(**kw), SlotKVCache(**kw), JSlotKVCache(**kw)
    rng = np.random.RandomState(0)
    rows = [(rng.randn(3, 2, 8, 4).astype(np.float32),
             rng.randn(3, 2, 8, 4).astype(np.float32)) for _ in range(2)]
    trows = [tuple(torch.from_numpy(r) for r in layer) for layer in rows]
    held = a.arrays()
    a.write_prefill_batch([2, 0], trows, [5, 3])
    j.write_prefill_batch([2, 0], [tuple(jnp.asarray(r) for r in layer)
                                   for layer in rows], [5, 3])
    for i, slot in enumerate([2, 0]):
        b.write_prefill(slot, [(rk[i:i + 1], rv[i:i + 1])
                               for rk, rv in trows], [5, 3][i])
    assert a.lengths.tolist() == b.lengths.tolist() == j.lengths.tolist()
    for la, lb, lj, lh in zip(a.arrays(), b.arrays(), j.arrays(), held):
        for x, y, z, h in zip(la, lb, lj, lh):
            assert x is h
            np.testing.assert_array_equal(x.numpy(), y.numpy())
            np.testing.assert_array_equal(x.numpy(), np.asarray(z))
    msgs = []
    for c, r in ((a, trows), (j, rows)):
        with pytest.raises(ValueError) as e:
            c.write_prefill_batch([0, 1], r, [3])
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    a.set_arrays(a.arrays())
    with pytest.raises(ValueError):
        a.set_arrays([tuple(x.clone() for x in layer)
                      for layer in a.arrays()])


# ------------------------------------------------------------ the engine
def _mixed_prompts():
    """Random prompts and repetitive ones (n-gram drafts accepted)."""
    prompts = _prompts((3, 7, 5, 11, 4), seed=6)
    prompts[1] = [5, 9, 5, 9, 5, 9, 5]
    prompts[3] = [2, 3, 4] * 3 + [2, 3]
    return prompts


@pytest.mark.parametrize("spec", [0, 3])
def test_dense_engine_matches_jax_and_greedy_search(models, spec):
    """Five mixed-length requests through 2 dense slots (slot reuse,
    mid-batch retirement, rollback after every verify at K 3): tokens
    equal the JAX dense engine's, the port's ``greedy_search`` at the
    engine's capacity and the JAX ``greedy_search``; no kernel launch."""
    jm, tm, _ = models
    prompts = _mixed_prompts()
    specs = [(p, {"max_new_tokens": 6}) for p in prompts]
    before = pa.launches
    eng = ServingEngine(tm, paged=False, spec_tokens=spec, device="cpu",
                        **ENGINE)
    got = _run(eng, specs)
    assert len(prompts) > eng.max_slots
    want = _run(JServingEngine(jm, paged=False, spec_tokens=spec, **ENGINE),
                specs)
    assert got == want
    for p, out in zip(prompts, got):
        ref = gen.greedy_search(tm, np.asarray([p]), max_new_tokens=6,
                                cache_len=ENGINE["max_len"])[0].tolist()
        assert out == ref
        assert ref == jgreedy(jm, np.asarray([p]), max_new_tokens=6,
                              cache_len=ENGINE["max_len"])[0].tolist()
    assert pa.launches == before
    st = eng.stats()
    assert st["paged"] is False and st["completed"] == 5
    assert "kv_blocks_used" not in st and "prefix_hit_rate" not in st
    assert eng.cache.num_free == eng.max_slots
    if spec:
        assert 0 < st["spec_accepted"] <= st["spec_proposed"]


def test_dense_slot_reuse_after_rollback(models):
    """``tests/test_serving.py:352``'s interleaving: a slot retires
    mid-batch and is prefilled again while its neighbour keeps verifying;
    every output equals ``greedy_search`` and the JAX engine's."""
    jm, tm, _ = models
    outs = []
    for side in ("port", "jax"):
        if side == "port":
            eng = ServingEngine(tm, paged=False, max_slots=2, max_len=32,
                                buckets=[4, 8], spec_tokens=3, device="cpu")
        else:
            eng = JServingEngine(jm, paged=False, max_slots=2, max_len=32,
                                 buckets=[4, 8], spec_tokens=3)
        long1 = eng.submit([3, 1, 4, 1, 5, 9, 2], max_new_tokens=9)
        short = eng.submit([2, 7], max_new_tokens=2)
        eng.step()
        while short.state != "done":
            eng.step()
        reused = eng.submit([8, 2, 8, 2, 8], max_new_tokens=6)
        assert reused.state == "queued"
        eng.run_until_idle()
        outs.append([r.output_ids for r in (long1, short, reused)])
    assert outs[0] == outs[1]
    for r, p in zip(outs[0], ([3, 1, 4, 1, 5, 9, 2], [2, 7],
                              [8, 2, 8, 2, 8])):
        ref = gen.greedy_search(tm, np.asarray([p]),
                                max_new_tokens=len(r) - len(p),
                                cache_len=32)[0].tolist()
        assert r == ref


def test_dense_engines_prefill_into_their_own_rows(models):
    """Two dense engines on one model, stepped in turn with offline
    generation between their steps: each prefills into rows of its own
    (no tensor shared with the other engine or the model's offline
    caches) and serves the tokens it serves alone."""
    _, tm, _ = models
    prompts = _mixed_prompts()
    specs = [(p, {"max_new_tokens": 6}) for p in prompts]
    alone = _run(ServingEngine(tm, paged=False, device="cpu", **ENGINE),
                 specs)
    engs = [ServingEngine(tm, paged=False, device="cpu", **ENGINE)
            for _ in range(2)]
    reqs = [[e.submit(p, **kw) for p, kw in specs] for e in engs]
    while not all(e.idle for e in engs):
        for e in engs:
            e.step()
            gen.greedy_search(tm, _prompts((5,), seed=9)[0:1],
                              max_new_tokens=3, cache_len=ENGINE["max_len"])
    for rs in reqs:
        assert [r.output_ids for r in rs] == alone
    ptrs = [{a.data_ptr() for layer in e._prefill_rows for a in layer}
            for e in engs]
    offline = {a.data_ptr() for _, c in tm._fixed_caches.values()
               for layer in c for a in layer}
    assert not ptrs[0] & ptrs[1] and not (ptrs[0] | ptrs[1]) & offline


def test_dense_eos_matches_greedy_search(models):
    jm, tm, _ = models
    prompts = _prompts((4, 6), seed=2)
    ref0 = gen.greedy_search(tm, np.asarray([prompts[0]]), max_new_tokens=8,
                             cache_len=32)[0].tolist()
    eos = ref0[len(prompts[0]) + 1]
    for spec in (0, 3):
        eng = ServingEngine(tm, paged=False, max_slots=2, max_len=32,
                            buckets=[8], eos_token_id=eos, spec_tokens=spec,
                            device="cpu")
        reqs = [eng.submit(p, max_new_tokens=8) for p in prompts]
        eng.run_until_idle()
        for p, r in zip(prompts, reqs):
            ref = gen.greedy_search(tm, np.asarray([p]), max_new_tokens=8,
                                    eos_token_id=eos,
                                    cache_len=32)[0].tolist()
            assert r.output_ids == ref
        assert reqs[0].tokens[-1] == eos and len(reqs[0].tokens) < 8


@pytest.mark.parametrize("spec", [0, 2])
def test_dense_sampled_matches_jax(models, spec):
    """Sampled requests (a greedy one among them) on the dense cache:
    the JAX dense engine's tokens; again in reverse order, the same per
    seed."""
    jm, tm, _ = models
    specs = [(p, dict(SAMPLED, seed=9 + i, max_new_tokens=8))
             for i, p in enumerate(_mixed_prompts())]
    specs[2] = (specs[2][0], {"max_new_tokens": 8})
    want = _run(JServingEngine(jm, paged=False, spec_tokens=spec, **ENGINE),
                specs)
    got = _run(ServingEngine(tm, paged=False, spec_tokens=spec,
                             device="cpu", **ENGINE), specs)
    assert got == want
    again = _run(ServingEngine(tm, paged=False, spec_tokens=spec,
                               device="cpu", **ENGINE), specs[::-1])
    assert again[::-1] == want


def test_dense_one_signature_per_key(models):
    """Across many requests of many lengths, the dense decode step, each
    prefill bucket and the verify step each specialise once (on the CPU
    the count is of input signatures, as the graphs on the card)."""
    arrays = models[2]
    tm = _port(arrays)
    eng = ServingEngine(tm, paged=False, max_slots=3, max_len=32,
                        buckets=[4, 8, 16], max_queue=32, device="cpu")
    for p in _prompts((2, 3, 4, 6, 7, 9, 13, 15), seed=1):
        eng.submit(p, max_new_tokens=4)
    eng.run_until_idle()
    assert gen.decode_step(tm)["traces"]["count"] == 1
    assert {b: e["traces"]["count"] for b, e in eng._prefill_fns.items()} \
        == {4: 1, 8: 1, 16: 1}
    assert set(eng._prefill_fns) == {4, 8, 16}
    assert ("prefill", 8, 3, 32) in tm._step_compile_cache
    seng = ServingEngine(tm, paged=False, max_slots=3, max_len=32,
                         buckets=[4, 8, 16], max_queue=32, spec_tokens=4,
                         device="cpu")
    for p in _prompts((2, 3, 4, 6, 7, 9, 13, 15), seed=7):
        seng.submit(p, max_new_tokens=4)
    seng.run_until_idle()
    assert gen.verify_step(tm, 4)["traces"]["count"] == 1
    # the verify is the decode: nothing more specialised
    assert gen.decode_step(tm)["traces"]["count"] == 1
    assert all(e["traces"]["count"] == 1 for e in seng._prefill_fns.values())


def test_dense_swap_weights_specialises_nothing(models):
    """A dense engine swaps to a second state with requests in flight:
    parameters keep their addresses, no entry or signature is added, and
    the tokens equal the JAX dense engine's after its own swap."""
    jm, _, arrays = models
    tm = _port(arrays)
    rng = np.random.RandomState(11)
    new = {n: (a + 0.05 * rng.randn(*a.shape)).astype(np.float32)
           for n, a in arrays.items()}
    prompts = _prompts((3, 7, 5, 11), seed=4)
    geom = {**ENGINE, "max_slots": 4}
    out = []
    for side in ("jax", "port"):
        if side == "jax":
            eng = JServingEngine(jm, paged=False, **geom)
        else:
            eng = ServingEngine(tm, paged=False, device="cpu", **geom)
        reqs = [eng.submit(p, max_new_tokens=7) for p in prompts]
        eng.step()
        if side == "port":
            ptrs = [p.data_ptr() for p in tm.parameters()]
            counts = {k: e["traces"]["count"]
                      for k, e in tm._step_compile_cache.items()}
        assert eng.swap_weights(new) == 1
        eng.run_until_idle()
        out.append([r.output_ids for r in reqs])
    for n, p in jm.named_parameters():
        p.value = jnp.asarray(arrays[n])
    assert [p.data_ptr() for p in tm.parameters()] == ptrs
    assert {k: e["traces"]["count"]
            for k, e in tm._step_compile_cache.items()} == counts
    assert out[1] == out[0]


def test_dense_refusals_match_jax(models):
    """Dense + megastep > 1 and dense + a non-f32 KV dtype raise the
    reference's ValueErrors; ``FLAGS_serving_paged`` off makes an engine
    dense; a dense request needs no block budget."""
    jm, tm, _ = models
    for bad in (dict(megastep=2), dict(kv_dtype="int8"),
                dict(kv_dtype="bf16")):
        with pytest.raises(ValueError) as want:
            JServingEngine(jm, paged=False, **{**ENGINE, **bad})
        with pytest.raises(ValueError) as got:
            ServingEngine(tm, paged=False, device="cpu", **{**ENGINE, **bad})
        assert type(got.value) is type(want.value)
        assert str(got.value) == str(want.value), bad
    tflags.set_flags({"serving_paged": False})
    pt.set_flags({"serving_paged": False})
    try:
        eng = ServingEngine(tm, device="cpu", **ENGINE)
        assert not eng.paged and not JServingEngine(jm, **ENGINE).paged
        assert isinstance(eng.cache, SlotKVCache)
        r = eng.submit(list(range(1, 21)), max_new_tokens=12)
        eng.run_until_idle()
        assert r.done and len(r.tokens) == 12
    finally:
        tflags.set_flags({"serving_paged": True})
        pt.set_flags({"serving_paged": True})
    assert ServingEngine(tm, device="cpu", **ENGINE).paged
