"""The port's encoder-decoder Transformer and multi-head attention on the
CPU, against the JAX package's (``paddle_tpu/nn/transformer.py``), at d
16, 2 heads, 2 + 2 layers, FFN 32, dropout 0, with the JAX parameters
carried across by name (``models.convert.transformer_state_from_numpy``):

- the forward, a loss and every parameter's gradient, post-LN and pre-LN
  (``normalize_before``, whose stacks end in a LayerNorm), with the
  decoder's square subsequent mask; held to 1e-5 absolute and relative
  (f32 both sides; JAX at "highest" matmul precision);
- ``MultiHeadAttention`` with separate key and value inputs of other
  widths (``kdim`` / ``vdim``), an additive mask, ``need_weights``
  (taken and ignored in both); ``Cache`` (keys and values grow) and
  ``StaticCache`` (projected once);
- the reference's incremental decoding (``tests/test_nn_dygraph.py:104``):
  a ``gen_cache`` over the memory, then one target token per step, each
  step equal to the full decoder over the prefix, and to JAX's steps;
- ``generate_square_subsequent_mask`` bit-equal;
- the route: at ``seq >= pallas_min_seq`` (lowered to 64, 32-row blocks,
  on both sides) the encoder's self-attention and the cross-attention
  take the flash predicate and the masked decoder self-attention does
  not, in both packages (the JAX kernel in Pallas interpret mode, the
  port's plain version), and the outputs agree.
"""

import torch_threads  # noqa: F401  (one worker's share of the cores)
import importlib

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.flags as jflags
from paddle_tpu import nn as jnn
from paddle_tpu.dygraph.tensor import Tensor
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.models.convert import transformer_state_from_numpy
from paddle_tpu_torch.ops import attention_ops as tops

jfa = importlib.import_module("paddle_tpu.ops.pallas.flash_attention")

D, H, LAYERS, FFN = 16, 2, 2, 32
TOL = dict(rtol=1e-5, atol=1e-5)


def _j(a):
    return Tensor(np.asarray(a))


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return np.asarray(t.value if hasattr(t, "value") else t.detach())


def _pair(normalize_before=False, **kw):
    """The JAX Transformer (seeded) and the port's with its weights."""
    pt.seed(3)
    jm = jnn.Transformer(D, H, LAYERS, LAYERS, FFN, dropout=0.0,
                         normalize_before=normalize_before, **kw)
    arrays = {n: np.asarray(p.value) for n, p in jm.named_parameters()}
    tm = tnn.Transformer(D, H, LAYERS, LAYERS, FFN, dropout=0.0,
                         normalize_before=normalize_before, device="cpu",
                         **kw)
    tm.load_state_dict(transformer_state_from_numpy(arrays, "cpu"),
                       strict=True)
    return jm, tm


def _inputs(s_src=7, s_tgt=5, b=2, seed=0):
    rng = np.random.RandomState(seed)
    src = rng.randn(b, s_src, D).astype(np.float32)
    tgt = rng.randn(b, s_tgt, D).astype(np.float32)
    w = rng.randn(b, s_tgt, D).astype(np.float32)
    return src, tgt, w


@pytest.mark.parametrize("normalize_before", [False, True],
                         ids=["post_ln", "pre_ln"])
def test_transformer_forward_loss_and_grads_match_jax(normalize_before):
    jm, tm = _pair(normalize_before)
    assert [n for n, _ in tm.named_parameters()] == \
        [n for n, _ in jm.named_parameters()]
    src, tgt, w = _inputs()
    jmask = jnn.Transformer.generate_square_subsequent_mask(tgt.shape[1])
    tmask = tnn.Transformer.generate_square_subsequent_mask(tgt.shape[1])
    jout = jm(_j(src), _j(tgt), tgt_mask=jmask)
    jloss = (jout * _j(w)).sum()
    jloss.backward()
    tout = tm(_t(src), _t(tgt), tgt_mask=tmask)
    tloss = (tout * _t(w)).sum()
    tloss.backward()
    np.testing.assert_allclose(_np(tout), _np(jout), **TOL)
    np.testing.assert_allclose(float(tloss), float(_np(jloss)), **TOL)
    tparams = dict(tm.named_parameters())
    for n, p in jm.named_parameters():
        np.testing.assert_allclose(tparams[n].grad.numpy(), _np(p.grad),
                                   err_msg=n, **TOL)


def test_square_subsequent_mask_is_bit_equal():
    for n in (1, 4, 9):
        np.testing.assert_array_equal(
            tnn.Transformer.generate_square_subsequent_mask(n).numpy(),
            _np(jnn.Transformer.generate_square_subsequent_mask(n)))


def _mha_pair(**kw):
    pt.seed(5)
    jm = jnn.MultiHeadAttention(D, H, **kw)
    tm = tnn.MultiHeadAttention(D, H, device="cpu", **kw)
    tm.load_state_dict(transformer_state_from_numpy(
        {n: np.asarray(p.value) for n, p in jm.named_parameters()}, "cpu"),
        strict=True)
    return jm, tm


@pytest.mark.parametrize("kdim, vdim", [(None, None), (6, 10)])
def test_attention_with_key_value_and_mask_matches_jax(kdim, vdim):
    jm, tm = _mha_pair(kdim=kdim, vdim=vdim, need_weights=True)
    rng = np.random.RandomState(1)
    q = rng.randn(2, 3, D).astype(np.float32)
    k = rng.randn(2, 5, kdim or D).astype(np.float32)
    v = rng.randn(2, 5, vdim or D).astype(np.float32)
    mask = np.where(rng.rand(2, 1, 3, 5) < 0.3, -1e9, 0.0).astype(
        np.float32)
    w = rng.randn(2, 3, D).astype(np.float32)
    jout = jm(_j(q), _j(k), _j(v), _j(mask))
    (jout * _j(w)).sum().backward()
    tout = tm(_t(q), _t(k), _t(v), _t(mask))
    (tout * _t(w)).sum().backward()
    np.testing.assert_allclose(_np(tout), _np(jout), **TOL)
    tparams = dict(tm.named_parameters())
    for n, p in jm.named_parameters():
        np.testing.assert_allclose(tparams[n].grad.numpy(), _np(p.grad),
                                   err_msg=n, **TOL)


def test_attention_caches_match_jax():
    """``Cache``: two calls append 2 then 3 rows to an empty cache, the
    outputs and the grown keys and values as JAX's; ``StaticCache``:
    the memory's projections once, then attention over them."""
    jm, tm = _mha_pair()
    rng = np.random.RandomState(2)
    x1, x2 = (rng.randn(2, n, D).astype(np.float32) for n in (2, 3))
    mem = rng.randn(2, 4, D).astype(np.float32)
    jc, tc = jm.gen_cache(_j(x1)), tm.gen_cache(_t(x1))
    assert tuple(tc.k.shape) == tuple(jc.k.shape) == (2, H, 0, D // H)
    for x in (x1, x2):
        jo, jc = jm(_j(x), cache=jc)
        to, tc = tm(_t(x), cache=tc)
        assert isinstance(tc, tnn.MultiHeadAttention.Cache)
        np.testing.assert_allclose(_np(to), _np(jo), **TOL)
        np.testing.assert_allclose(_np(tc.k), _np(jc.k), **TOL)
        np.testing.assert_allclose(_np(tc.v), _np(jc.v), **TOL)
    assert tc.k.shape[2] == 5
    S = tnn.MultiHeadAttention.StaticCache
    js = jm.gen_cache(_j(mem), _j(mem), jnn.MultiHeadAttention.StaticCache)
    ts = tm.gen_cache(_t(mem), _t(mem), S)
    assert isinstance(ts, S)
    np.testing.assert_allclose(_np(ts.k), _np(js.k), **TOL)
    jo = jm(_j(x2), _j(mem), _j(mem), cache=js)
    to = tm(_t(x2), _t(mem), _t(mem), cache=ts)
    assert isinstance(to, torch.Tensor)
    np.testing.assert_allclose(_np(to), _np(jo), **TOL)


def test_incremental_decoding_matches_full_decoding_and_jax():
    """The reference's ``test_transformer_decoder_incremental_cache``:
    a cache from the memory, then one target token at a time; each
    step's output equals the full decoder's last row over the prefix
    (square mask), and JAX's step."""
    jm, tm = _pair()
    src, tgt, _ = _inputs(s_src=6, s_tgt=5, seed=4)
    jmem = jm.encoder(_j(src))
    tmem = tm.encoder(_t(src))
    np.testing.assert_allclose(_np(tmem), _np(jmem), **TOL)
    jcache = jm.decoder.gen_cache(jmem)
    tcache = tm.decoder.gen_cache(tmem)
    for t in range(tgt.shape[1]):
        jstep, jcache = jm.decoder(_j(tgt[:, t:t + 1]), jmem, cache=jcache)
        tstep, tcache = tm.decoder(_t(tgt[:, t:t + 1]), tmem, cache=tcache)
        full = tm.decoder(_t(tgt[:, :t + 1]), tmem,
                          tnn.Transformer.generate_square_subsequent_mask(
                              t + 1))
        np.testing.assert_allclose(_np(tstep)[:, 0], _np(full)[:, -1],
                                   **TOL)
        np.testing.assert_allclose(_np(tstep), _np(jstep), **TOL)
    assert tcache[0][0].k.shape[2] == tgt.shape[1]


def test_encoder_cache_matches_jax():
    """The encoder's ``gen_cache`` / ``cache`` forms: each layer appends
    the rows it sees, as JAX's."""
    jm, tm = _pair()
    src, _, _ = _inputs(s_src=3, seed=6)
    jc, tc = jm.encoder.gen_cache(_j(src)), tm.encoder.gen_cache(_t(src))
    for part in (src[:, :2], src[:, 2:]):
        jo, jc = jm.encoder(_j(part), cache=jc)
        to, tc = tm.encoder(_t(part), cache=tc)
        np.testing.assert_allclose(_np(to), _np(jo), **TOL)
    assert [c.k.shape[2] for c in tc] == [3] * LAYERS


def test_clones_draw_fresh_parameters():
    """Every layer of a stack has parameters of its own (the reference
    rebuilds each clone from the first layer's constructor arguments)."""
    tm = tnn.Transformer(D, H, 3, 3, FFN, dropout=0.0, device="cpu")
    for stack in (tm.encoder.layers, tm.decoder.layers):
        ws = [layer.linear1.weight for layer in stack]
        assert len({w.data_ptr() for w in ws}) == 3
        assert not torch.equal(ws[0], ws[1])


@pytest.fixture
def flash_from_64(monkeypatch):
    """Flash route from 64 tokens with 32-row blocks on both sides; the
    packages' flash calls counted."""
    names = ["use_pallas_attention", "pallas_min_seq",
             "pallas_flash_block_q", "pallas_flash_block_k"]
    saved = (jflags.get_flags(names), tflags.get_flags(names))
    new = {"use_pallas_attention": True, "pallas_min_seq": 64,
           "pallas_flash_block_q": 32, "pallas_flash_block_k": 32}
    jflags.set_flags(new)
    tflags.set_flags(new)
    calls = {"jax": 0, "port": 0}
    jreal, treal = jfa.flash_attention, tops.flash_attention

    def jspy(*a, **kw):
        calls["jax"] += 1
        return jreal(*a, **kw)

    def tspy(*a, **kw):
        calls["port"] += 1
        return treal(*a, **kw)

    monkeypatch.setattr(jfa, "flash_attention", jspy)
    monkeypatch.setattr(tops, "flash_attention", tspy)
    yield calls
    jflags.set_flags(saved[0])
    tflags.set_flags(saved[1])


def test_route_takes_flash_for_encoder_and_cross_attention(flash_from_64):
    """At src = tgt = 64 tokens: per forward, 2 encoder self-attentions
    and 2 cross-attentions take the flash route (4 calls in each
    package), the 2 masked decoder self-attentions compose; the outputs
    agree. A shorter target keeps the cross-attention composed too
    (``s_q != s_k``)."""
    jm, tm = _pair()
    src, tgt, _ = _inputs(s_src=64, s_tgt=64, b=1, seed=7)
    mask64 = (jnn.Transformer.generate_square_subsequent_mask(64),
              tnn.Transformer.generate_square_subsequent_mask(64))
    jout = jm(_j(src), _j(tgt), tgt_mask=mask64[0])
    tout = tm(_t(src), _t(tgt), tgt_mask=mask64[1])
    assert flash_from_64 == {"jax": 2 * LAYERS, "port": 2 * LAYERS}
    np.testing.assert_allclose(_np(tout), _np(jout), rtol=1e-4, atol=1e-4)
    short = tgt[:, :8]
    tm(_t(src), _t(short),
       tgt_mask=tnn.Transformer.generate_square_subsequent_mask(8))
    assert flash_from_64["port"] == 3 * LAYERS
