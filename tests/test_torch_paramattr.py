"""A ``ParamAttr`` in the port's eager layers (``nn/layers_common.py``,
``nn/rnn.py``) against the reference's tape layers on the CPU: after the
same ``seed``, each parameter an attribute describes is drawn through
``initializer.eager_init`` from the seeded numpy stream, bit-equal to
the reference's; it keeps the attribute's name, ``trainable=False`` is
``requires_grad=False``, ``learning_rate`` its ``lr_scale`` and
``regularizer`` its ``regularizer``; a dropped weight raises ValueError
as the reference's layer does (at its forward, the port at
construction); and the layer's forward equals the reference's within
1e-6 relative plus 1e-6 absolute.
"""

import torch_threads  # noqa: F401  (one worker's share of the cores)

import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu.nn as JN
from paddle_tpu.initializer import NormalInitializer as JNormal
from paddle_tpu.initializer import UniformInitializer as JUniform
from paddle_tpu.optimizer import L2Decay as JL2
from paddle_tpu.param_attr import ParamAttr as JAttr

import paddle_tpu_torch.dygraph as TD
import paddle_tpu_torch.nn as TN
from paddle_tpu_torch.initializer import NormalInitializer as TNormal
from paddle_tpu_torch.initializer import UniformInitializer as TUniform
from paddle_tpu_torch.optimizer import L2Decay as TL2
from paddle_tpu_torch.param_attr import ParamAttr as TAttr

SIDES = {
    "jax": dict(N=JN, A=JAttr, Normal=JNormal, Uniform=JUniform, L2=JL2,
                kw={}, seed=jpt.seed),
    "port": dict(N=TN, A=TAttr, Normal=TNormal, Uniform=TUniform, L2=TL2,
                 kw={"device": "cpu"}, seed=TD.seed),
}


def _gen(S):
    return {"generator": torch.Generator()} if S is SIDES["port"] else {}


#: layer -> (build(S), input, the parameters to compare by attribute)
LAYERS = {
    "Linear": (lambda S: S["N"].Linear(
        3, 4, weight_attr=S["A"](name="fc.w", learning_rate=0.5,
                                 regularizer=S["L2"](0.1)),
        bias_attr=S["A"](initializer=S["Normal"](0.0, 1.0)),
        **S["kw"], **_gen(S)),
        np.random.RandomState(0).randn(2, 3), ("weight", "bias")),
    "Embedding": (lambda S: S["N"].Embedding(
        6, 3, padding_idx=1, weight_attr=S["A"](name="emb", trainable=False),
        **S["kw"], **_gen(S)),
        np.array([[0, 1, 5]], np.int64), ("weight",)),
    "LayerNorm": (lambda S: S["N"].LayerNorm(
        4, weight_attr=S["A"](initializer=S["Uniform"](0.5, 1.5)),
        bias_attr=False, **S["kw"]),
        np.random.RandomState(1).randn(2, 4), ("weight",)),
    "Conv2D": (lambda S: S["N"].Conv2D(
        2, 3, 3, padding=1, weight_attr="conv.w",
        bias_attr=S["A"](learning_rate=2.0), **S["kw"], **_gen(S)),
        np.random.RandomState(2).randn(1, 2, 4, 4), ("weight", "bias")),
    "BatchNorm2D": (lambda S: S["N"].BatchNorm2D(
        2, weight_attr=S["A"](initializer=S["Normal"](1.0, 0.1)),
        bias_attr=S["A"](name="bn.b"), **S["kw"]),
        np.random.RandomState(3).randn(2, 2, 3, 3), ("weight", "bias")),
    "LSTM": (lambda S: S["N"].LSTM(
        3, 4, weight_ih_attr=S["A"](initializer=S["Normal"](0.0, 0.5)),
        weight_hh_attr=S["A"](name="lstm.whh"), bias_ih_attr=False,
        bias_hh_attr=S["A"](trainable=False), **S["kw"]),
        np.random.RandomState(4).randn(2, 5, 3),
        ("weight_ih_l0", "weight_hh_l0", "bias_ih_l0", "bias_hh_l0")),
    "GRU": (lambda S: S["N"].GRU(
        3, 4, weight_ih_attr=S["A"](), weight_hh_attr=S["A"](),
        bias_ih_attr=S["A"](), bias_hh_attr=False, **S["kw"]),
        np.random.RandomState(5).randn(2, 5, 3),
        ("weight_ih_l0", "weight_hh_l0", "bias_ih_l0", "bias_hh_l0")),
}


NAMED = {"fc.w", "emb", "conv.w", "bn.b", "lstm.whh"}


def _value(p):
    return np.asarray(p.numpy()) if hasattr(p, "numpy") and not \
        isinstance(p, torch.Tensor) else p.detach().numpy()


@pytest.mark.parametrize("layer", sorted(LAYERS))
def test_param_attr_draws_and_tags_like_the_reference(layer):
    build, x, names = LAYERS[layer]
    got = {}
    for side, S in SIDES.items():
        S["seed"](21)
        m = build(S)
        if side == "jax":
            out = m(jpt.to_tensor(x.astype(x.dtype if x.dtype == np.int64
                                          else np.float32)))
        else:
            out = m(torch.tensor(x.astype(x.dtype if x.dtype == np.int64
                                          else np.float32)))
        out = out[0] if isinstance(out, tuple) else out
        got[side] = (np.asarray(out.numpy() if side == "jax"
                                else out.detach().numpy()),
                     {n: getattr(m, n) for n in names})
    (jo, jp), (to, tp) = got["jax"], got["port"]
    np.testing.assert_allclose(to, jo, rtol=1e-6, atol=1e-6)
    for n in names:
        j, t = jp[n], tp[n]
        np.testing.assert_array_equal(_value(t), _value(j), err_msg=n)
        assert t.requires_grad == (not j.stop_gradient), n
        assert getattr(t, "lr_scale", 1.0) == j.lr_scale, n
        reg = getattr(t, "regularizer", None)
        assert (reg is None) == (j.regularizer is None), n
        if reg is not None:
            assert reg.coeff == j.regularizer.coeff
        # an attribute's name is kept; the reference names the others
        # itself (a unique_name of its Layer), the port leaves them None
        if j.name in NAMED:
            assert t.name == j.name, n
        else:
            assert getattr(t, "name", None) is None, n


def test_a_dropped_weight_raises_like_the_reference():
    jpt.seed(0)
    j = JN.Linear(3, 2, weight_attr=False)
    with pytest.raises(ValueError):
        j(jpt.to_tensor(np.ones((1, 3), np.float32)))
    with pytest.raises(ValueError, match="weight_attr=False"):
        TN.Linear(3, 2, weight_attr=False, device="cpu",
                  generator=torch.Generator())
    with pytest.raises(ValueError, match="bias_attr=False"):
        TN.BatchNorm2D(2, bias_attr=False, device="cpu")
    # a bias may go: the layer runs without it in both packages
    assert TN.Linear(3, 2, bias_attr=False, device="cpu",
                     generator=torch.Generator()).bias is None
