"""The rest of ``paddle_tpu_torch.nn`` on the CPU, against the JAX
package's ``paddle_tpu.nn``: the recurrent layers and cells, every layer
and function the earlier slices had not ported, and the package's
exports. Inputs are drawn from numpy seeds; JAX parameters carry across
by name (``models.convert.rnn_state_from_numpy`` /
``layer_state_from_numpy``). Forwards and gradients (of a random
projection of the output, with respect to the input and every
parameter, where the reference differentiates) are held to 1e-5
absolute and relative unless a case states otherwise.
"""

import torch_threads  # noqa: F401  (one worker's share of the cores)
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import nn as jnn
from paddle_tpu.dygraph.tensor import Tensor
from paddle_tpu.nn import functional as JF
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.models.convert import (layer_state_from_numpy,
                                             rnn_state_from_numpy)
from paddle_tpu_torch.nn import functional as TF

TOL = dict(rtol=1e-5, atol=1e-5)


def _np(t):
    return np.asarray(t.value if hasattr(t, "value") else t.detach())


def _leaf_j(a, grad=True):
    return Tensor(np.array(a), stop_gradient=not grad)


def _leaf_t(a, grad=True):
    t = torch.from_numpy(np.array(a))
    return t.requires_grad_(grad and t.is_floating_point())


def _carry(jm, tm, convert=layer_state_from_numpy):
    tm.load_state_dict(convert(
        {n: np.asarray(p.value) for n, p in jm.named_parameters()}, "cpu"),
        strict=False)
    return tm


def _held(jout, tout, jins, tins, jm=None, tm=None, seed=9, tol=TOL):
    """Forward equal; then the gradient of ``sum(out * w)`` w.r.t. each
    differentiable input and every parameter equal."""
    np.testing.assert_allclose(_np(tout), _np(jout), **tol)
    if not tout.requires_grad:
        return
    w = np.asarray(np.random.RandomState(seed).randn(*tout.shape),
                   np.float32)
    (jout * Tensor(w)).sum().backward()
    (tout * torch.from_numpy(w)).sum().backward()
    for j, t in zip(jins, tins):
        if isinstance(t, torch.Tensor) and t.requires_grad:
            np.testing.assert_allclose(t.grad.numpy(), _np(j.grad), **tol)
    if jm is not None:
        tp = dict(tm.named_parameters())
        for n, p in jm.named_parameters():
            np.testing.assert_allclose(tp[n].grad.numpy(), _np(p.grad),
                                       err_msg=n, **tol)


# ------------------------------------------------------- recurrent layers
RNNS = {
    "LSTM": (jnn.LSTM, tnn.LSTM, {}),
    "GRU": (jnn.GRU, tnn.GRU, {}),
    "SimpleRNN-tanh": (jnn.SimpleRNN, tnn.SimpleRNN, {}),
    "SimpleRNN-relu": (jnn.SimpleRNN, tnn.SimpleRNN, {"activation": "relu"}),
}


@pytest.mark.parametrize("direction", ["forward", "bidirect"])
@pytest.mark.parametrize("kind", sorted(RNNS))
def test_rnn_matches_jax(kind, direction):
    """Two layers, the given direction, initial states and per-row
    lengths (one row shorter): outputs (zero past a length), final states
    and every gradient as JAX's; and without states or lengths."""
    jcls, tcls, kw = RNNS[kind]
    pt.seed(11)
    jm = jcls(4, 6, 2, direction=direction, **kw)
    tm = _carry(jm, tcls(4, 6, 2, direction=direction, device="cpu", **kw),
                rnn_state_from_numpy)
    assert [n for n, _ in tm.named_parameters()] == \
        [n for n, _ in jm.named_parameters()]
    rng = np.random.RandomState(1)
    x = rng.randn(3, 5, 4).astype(np.float32)
    ndir = 2 if direction != "forward" else 1
    h0 = rng.randn(2 * ndir, 3, 6).astype(np.float32) * 0.5
    c0 = rng.randn(2 * ndir, 3, 6).astype(np.float32) * 0.5
    lengths = np.array([5, 3, 4], np.int64)
    jx, tx = _leaf_j(x), _leaf_t(x)
    lstm = kind == "LSTM"
    jstates = (Tensor(h0), Tensor(c0)) if lstm else Tensor(h0)
    tstates = (torch.from_numpy(h0), torch.from_numpy(c0)) if lstm \
        else torch.from_numpy(h0)
    jout, jst = jm(jx, jstates, Tensor(lengths))
    tout, tst = tm(tx, tstates, torch.from_numpy(lengths))
    assert not tout[1, 3:].any()
    for js, ts in zip(jst if lstm else [jst], tst if lstm else [tst]):
        np.testing.assert_allclose(_np(ts), _np(js), **TOL)
    _held(jout, tout, [jx], [tx], jm, tm)
    jout, _ = jm(Tensor(x))
    tout, _ = tm(torch.from_numpy(x))
    np.testing.assert_allclose(_np(tout), _np(jout), **TOL)


@pytest.mark.parametrize("cell", ["LSTMCell", "GRUCell"])
def test_cells_match_jax(cell):
    pt.seed(12)
    jm = getattr(jnn, cell)(4, 5)
    tm = _carry(jm, getattr(tnn, cell)(4, 5, device="cpu"),
                rnn_state_from_numpy)
    rng = np.random.RandomState(2)
    x = rng.randn(3, 4).astype(np.float32)
    h = rng.randn(1, 3, 5).astype(np.float32)
    jx, tx = _leaf_j(x), _leaf_t(x)
    if cell == "LSTMCell":
        c = rng.randn(1, 3, 5).astype(np.float32)
        jout, (jh, jc) = jm(jx, (Tensor(h), Tensor(c)))
        tout, (th, tc) = tm(tx, (torch.from_numpy(h), torch.from_numpy(c)))
        np.testing.assert_allclose(_np(tc), _np(jc), **TOL)
    else:
        jout, jh = jm(jx, Tensor(h))
        tout, th = tm(tx, torch.from_numpy(h))
    np.testing.assert_allclose(_np(th), _np(jh), **TOL)
    assert tuple(tout.shape) == (3, 5)
    _held(jout, tout, [jx], [tx], jm, tm)


# ------------------------------------------------------------- functions
def _x(shape=(2, 3, 4, 5), seed=0, scale=2.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _probs(shape, seed):
    p = np.random.RandomState(seed).rand(*shape).astype(np.float32) + 0.1
    return p / p.sum(-1, keepdims=True)


# name -> (inputs, differentiable flags, call(F, *inputs)); each call
# takes the package's functional module and its inputs
UNARY = {
    "relu6": lambda F, x: F.relu6(x * 4.0),
    "sigmoid": lambda F, x: F.sigmoid(x),
    "log_softmax": lambda F, x: F.log_softmax(x, axis=1),
    "leaky_relu": lambda F, x: F.leaky_relu(x, 0.2),
    "elu": lambda F, x: F.elu(x, 0.7),
    "silu": lambda F, x: F.silu(x),
    "swish": lambda F, x: F.swish(x),
    "hardswish": lambda F, x: F.hardswish(x * 2.0),
    "hardsigmoid": lambda F, x: F.hardsigmoid(x * 2.0),
    "softplus": lambda F, x: F.softplus(x * 8.0, 2.0, 10.0),
}


@pytest.mark.parametrize("name", sorted(UNARY))
def test_activations_match_jax(name):
    x = _x()
    x.flat[:3] = 0.0                      # the gradient at 0
    jx, tx = _leaf_j(x), _leaf_t(x)
    _held(UNARY[name](JF, jx), UNARY[name](TF, tx), [jx], [tx])


FUNCS = {
    "prelu-all": ([_x(), np.array([0.25], np.float32)], [True, True],
                  lambda F, x, w: F.prelu(x, w)),
    "prelu-channel": ([_x(), np.array([0.1, 0.2, 0.3], np.float32)],
                      [True, True], lambda F, x, w: F.prelu(x, w)),
    "mse_loss": ([_x(seed=1), _x(seed=2)], [True, False],
                 lambda F, a, b: F.mse_loss(a, b)),
    "mse_loss-none": ([_x(seed=1), _x(seed=2)], [True, False],
                      lambda F, a, b: F.mse_loss(a, b, "none")),
    "l1_loss-sum": ([_x(seed=1), _x(seed=2)], [True, False],
                    lambda F, a, b: F.l1_loss(a, b, "sum")),
    "bce_with_logits": ([_x(seed=3), np.where(_x(seed=4) > 0, 1.0, 0.0)
                         .astype(np.float32)], [True, False],
                        lambda F, a, b: F.binary_cross_entropy_with_logits(
                            a, b)),
    "bce_ignore_index": ([_x((4, 3), seed=3), np.array(
        [[1, 0, -100], [0, 1, 1], [-100, -100, 0], [1, 1, 0]], np.float32)],
        [True, False], lambda F, a, b: F.binary_cross_entropy_with_logits(
            a, b, "none")),
    "nll_loss": ([np.log(_probs((5, 4), 5)), np.array([[0], [3], [1], [2],
                                                       [3]], np.int64)],
                 [True, False], lambda F, a, b: F.nll_loss(a, b)),
    "kl_div-batchmean": ([np.log(_probs((3, 4), 6)), np.concatenate(
        [_probs((2, 4), 7), np.zeros((1, 4), np.float32)])],
        [True, False], lambda F, a, b: F.kl_div(a, b, "batchmean")),
    "kl_div-none": ([np.log(_probs((3, 4), 6)), _probs((3, 4), 8)],
                    [True, False], lambda F, a, b: F.kl_div(a, b, "none")),
    "smooth_l1_loss": ([_x(seed=1), _x(seed=2)], [True, False],
                       lambda F, a, b: F.smooth_l1_loss(a, b, "mean", 1.5)),
    "label_smooth": ([np.eye(4, dtype=np.float32)[[0, 2, 3]]], [True],
                     lambda F, a: F.label_smooth(a, epsilon=0.2)),
    "label_smooth-prior": ([np.eye(4, dtype=np.float32)[[0, 2, 3]],
                            _probs((1, 4), 9)], [True, False],
                           lambda F, a, p: F.label_smooth(a, p, 0.1)),
    "group_norm": ([_x((2, 6, 3, 3)), _x((6,), 1, 1.0), _x((6,), 2, 1.0)],
                   [True, True, True],
                   lambda F, x, w, b: F.group_norm(x, 3, w, b, 1e-5)),
    "conv2d_transpose": ([_x((2, 3, 5, 4), 3, 1.0),
                          _x((3, 4, 3, 3), 4, 0.5), _x((4,), 5, 1.0)],
                         [True, True, True],
                         lambda F, x, w, b: F.conv2d_transpose(
                             x, w, b, stride=2, padding=1)),
    "conv2d_transpose-asym": ([_x((1, 2, 4, 4), 3, 1.0),
                               _x((2, 3, 2, 3), 4, 0.5)], [True, True],
                              lambda F, x, w: F.conv2d_transpose(
                                  x, w, None, stride=[2, 1],
                                  padding=[0, 1, 1, 0], dilation=[1, 2])),
    "embedding": ([np.array([[0, 2, 4], [4, 1, 2]], np.int64),
                   _x((5, 3), 6, 1.0)], [False, True],
                  lambda F, i, w: F.embedding(i, w, padding_idx=-1)),
    "one_hot": ([np.array([[0, 3], [5, 1]], np.int64)], [False],
                lambda F, i: F.one_hot(i, 4)),
    "sdpa-mask": ([_x((2, 2, 5, 4), 1, 1.0), _x((2, 2, 6, 4), 2, 1.0),
                   _x((2, 2, 6, 4), 3, 1.0),
                   np.where(_x((2, 1, 5, 6), 4) > 1.5, -1e9, 0.0).astype(
                       np.float32)], [True, True, True, False],
                  lambda F, q, k, v, m: F.scaled_dot_product_attention(
                      q, k, v, m)),
    "sdpa-causal": ([_x((1, 2, 6, 4), 1, 1.0), _x((1, 2, 6, 4), 2, 1.0),
                     _x((1, 2, 6, 4), 3, 1.0)], [True, True, True],
                    lambda F, q, k, v: F.scaled_dot_product_attention(
                        q, k, v, is_causal=True)),
}
for _mode in ("constant", "reflect", "edge", "circular"):
    FUNCS[f"pad2d-{_mode}"] = (
        [_x((1, 2, 4, 5))], [True],
        lambda F, x, m=_mode: F.pad(x, [1, 2, 2, 1], m, 0.5))
for _mode in ("constant", "reflect", "replicate", "circular"):
    FUNCS[f"pad3d-{_mode}"] = (
        [_x((1, 2, 3, 4, 4))], [True],
        lambda F, x, m=_mode: F.pad(x, [1, 0, 2, 1, 1, 2], m, -1.0))
FUNCS["pad-nd"] = ([_x((2, 3, 4))], [True],
                   lambda F, x: F.pad(x, [1, 2, 0, 3], value=2.0))
for _mode in ("nearest", "bilinear", "bicubic"):
    for _size, _tag in (([7, 9], "up"), ([3, 2], "down")):
        FUNCS[f"interpolate-{_mode}-{_tag}"] = (
            [_x((1, 2, 5, 6))], [_mode != "nearest"],
            lambda F, x, m=_mode, s=_size: F.interpolate(x, s, mode=m))
FUNCS["interpolate-scale"] = ([_x((1, 2, 4, 3))], [True],
                              lambda F, x: F.interpolate(
                                  x, scale_factor=2, mode="bilinear"))


@pytest.mark.parametrize("name", sorted(FUNCS))
def test_functions_match_jax(name):
    inputs, grads, call = FUNCS[name]
    jins = [_leaf_j(a, g) for a, g in zip(inputs, grads)]
    tins = [_leaf_t(a, g) for a, g in zip(inputs, grads)]
    _held(call(JF, *jins), call(TF, *tins), jins, tins)


def test_unfold_raises_as_the_reference():
    x = np.zeros((1, 1, 4, 4), np.float32)
    with pytest.raises(NotImplementedError) as want:
        JF.unfold(Tensor(x), 2)
    with pytest.raises(NotImplementedError) as got:
        TF.unfold(torch.from_numpy(x), 2)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------- layers
def test_conv2d_transpose_layer_matches_jax():
    """Shapes, the Xavier-uniform bound of the reference's fans, and the
    forward and gradients with its weights."""
    pt.seed(13)
    jm = jnn.Conv2DTranspose(3, 4, 3, stride=2, padding=1)
    tm = tnn.Conv2DTranspose(3, 4, 3, stride=2, padding=1, device="cpu",
                             generator=torch.Generator().manual_seed(0))
    limit = np.sqrt(6.0 / (4 * 9 + 3 * 9))
    assert tm.weight.abs().max() <= limit
    assert np.abs(_np(jm.weight)).max() <= limit
    _carry(jm, tm)
    x = _x((2, 3, 4, 4), 1, 1.0)
    jx, tx = _leaf_j(x), _leaf_t(x)
    _held(jm(jx), tm(tx), [jx], [tx], jm, tm)


def test_group_norm_layer_matches_jax():
    pt.seed(14)
    jm = jnn.GroupNorm(2, 4)
    tm = _carry(jm, tnn.GroupNorm(2, 4, device="cpu"))
    x = _x((3, 4, 2, 3))
    jx, tx = _leaf_j(x), _leaf_t(x)
    _held(jm(jx), tm(tx), [jx], [tx], jm, tm)


def test_sync_batch_norm_is_local_batch_norm_like_the_reference():
    """Outside a mesh: two training steps (outputs, gradients and the
    running statistics after each) and an eval step as JAX's; the
    converter swaps a BatchNorm2D for one sharing its state."""
    pt.seed(15)
    jm = jnn.SyncBatchNorm(3, momentum=0.8)
    tm = tnn.SyncBatchNorm(3, momentum=0.8, device="cpu")
    for seed in (1, 2):
        x = _x((4, 3, 2, 2), seed)
        jx, tx = _leaf_j(x), _leaf_t(x)
        _held(jm(jx), tm(tx), [jx], [tx], jm, tm)
        for p in list(jm.parameters()):
            p.clear_gradient()
        tm.zero_grad()
        np.testing.assert_allclose(tm._mean.numpy(), _np(jm._mean), **TOL)
        np.testing.assert_allclose(tm._variance.numpy(), _np(jm._variance),
                                   **TOL)
    jm.eval()
    tm.eval()
    x = _x((2, 3, 2, 2), 3)
    np.testing.assert_allclose(_np(tm(torch.from_numpy(x))),
                               _np(jm(Tensor(x))), **TOL)
    bn = tnn.BatchNorm2D(3, device="cpu")
    seq = tnn.Sequential(bn)
    out = tnn.SyncBatchNorm.convert_sync_batchnorm(seq)
    assert isinstance(out[0], tnn.SyncBatchNorm) and out[0].weight is \
        bn.weight and out[0]._mean is bn._mean


LOSSES = {
    "MSELoss": ({}, [_x(seed=1), _x(seed=2)]),
    "L1Loss": ({"reduction": "sum"}, [_x(seed=1), _x(seed=2)]),
    "BCEWithLogitsLoss": ({}, [_x(seed=3), np.where(_x(seed=4) > 0, 1.0,
                                                    0.0).astype(np.float32)]),
    "NLLLoss": ({"reduction": "sum"}, [np.log(_probs((5, 4), 5)),
                                       np.array([0, 3, 1, 2, 3], np.int64)]),
    "KLDivLoss": ({"reduction": "batchmean"},
                  [np.log(_probs((3, 4), 6)), _probs((3, 4), 7)]),
    "SmoothL1Loss": ({"delta": 0.5}, [_x(seed=1), _x(seed=2)]),
}


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_loss_layers_match_jax(name):
    kw, (a, b) = LOSSES[name]
    ja, ta = _leaf_j(a), _leaf_t(a)
    _held(getattr(jnn, name)(**kw)(ja, Tensor(b)),
          getattr(tnn, name)(**kw)(ta, torch.from_numpy(b)), [ja], [ta])


LAYERS = {
    "Pad2D-int": (lambda nn: nn.Pad2D(1), _x((1, 2, 3, 3))),
    "Pad2D-reflect": (lambda nn: nn.Pad2D([1, 0, 2, 1], "reflect"),
                      _x((1, 2, 4, 4))),
    "Upsample-nearest": (lambda nn: nn.Upsample(scale_factor=2),
                         _x((1, 2, 3, 3))),
    "Upsample-bicubic": (lambda nn: nn.Upsample([5, 4], mode="bicubic"),
                         _x((1, 2, 3, 3))),
    "ReLU6": (lambda nn: nn.ReLU6(), _x(scale=5.0)),
    "GELU": (lambda nn: nn.GELU(True), _x()),
    "Sigmoid": (lambda nn: nn.Sigmoid(), _x()),
    "Tanh": (lambda nn: nn.Tanh(), _x()),
    "Softmax": (lambda nn: nn.Softmax(1), _x()),
    "LogSoftmax": (lambda nn: nn.LogSoftmax(), _x()),
    "LeakyReLU": (lambda nn: nn.LeakyReLU(0.3), _x()),
    "SiLU": (lambda nn: nn.SiLU(), _x()),
    "Swish": (lambda nn: nn.Swish(), _x()),
    "Hardswish": (lambda nn: nn.Hardswish(), _x(scale=3.0)),
    "Hardsigmoid": (lambda nn: nn.Hardsigmoid(), _x(scale=3.0)),
    "ELU": (lambda nn: nn.ELU(0.5), _x()),
    "Softplus": (lambda nn: nn.Softplus(), _x()),
}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_parameterless_layers_match_jax(name):
    make, x = LAYERS[name]
    jx, tx = _leaf_j(x), _leaf_t(x)
    _held(make(jnn)(jx), make(tnn)(tx), [jx], [tx])


def test_nn_exports_every_name_of_the_reference():
    """``paddle_tpu_torch.nn`` exports what ``paddle_tpu.nn`` exports
    (the containers as torch's), and ``functional`` every public function
    of the reference's."""
    import paddle_tpu.nn as jpkg
    public = {n for n in vars(jpkg) if not n.startswith("_")}
    public -= {"layers_common", "transformer", "rnn"}
    assert sorted(public - set(vars(tnn))) == []
    assert tnn.Layer is torch.nn.Module and \
        tnn.LayerList is torch.nn.ModuleList
    jfuncs = {n for n, v in vars(JF).items() if callable(v) and
              not n.startswith("_") and getattr(v, "__module__", "") ==
              JF.__name__}
    assert sorted(jfuncs - set(vars(TF))) == []
