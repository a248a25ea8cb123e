"""``paddle_tpu_torch.tensor_api`` — the ``paddle.tensor`` functions over
the tape — against ``paddle_tpu.tensor_api`` on the CPU: every public
function of the reference's module as a case of one test, with the
reference's defaults and numpy-seeded inputs: the values, the dtype and
whether the result carries a gradient (``stop_gradient``). The gradients
of the ops beneath are held in ``test_torch_dygraph.py``.

Tolerance: 1e-6 relative plus 1e-6 absolute (float32 in both); integer
and boolean results exactly. The random creation functions draw from
numpy's global stream, seeded alike on both sides (``seed``).
"""

import torch_threads  # noqa: F401  (one worker's share of the cores)
import inspect

import numpy as np
import pytest

import paddle_tpu.tensor_api as JT

import paddle_tpu_torch.tensor_api as TT

X = np.random.RandomState(0).randn(2, 3).astype(np.float32)
Y = (np.abs(np.random.RandomState(1).randn(2, 3)) + 0.5).astype(np.float32)
IDX = np.array([2, 0], np.int64)


def _case(fn, diff=True):
    return (fn, diff)


#: function name -> (call(T, x, y, t) with the package's tensor_api ``T``,
#: its ``to_tensor`` ``t``; whether the result is differentiable)
CASES = {
    "abs": _case(lambda T, x, y, t: T.abs(x)),
    "add": _case(lambda T, x, y, t: T.add(x, y)),
    "all": _case(lambda T, x, y, t: T.all(x > 0.0, axis=1), False),
    "any": _case(lambda T, x, y, t: T.any(x > 0.0), False),
    "arange": _case(lambda T, x, y, t: T.arange(1, 7, 2, **t), False),
    "argmax": _case(lambda T, x, y, t: T.argmax(x, axis=1), False),
    "argmin": _case(lambda T, x, y, t: T.argmin(x, axis=0, keepdim=True),
                    False),
    "argsort": _case(lambda T, x, y, t: T.argsort(x, descending=True),
                     False),
    "bernoulli": _case(lambda T, x, y, t: T.bernoulli(T.to_tensor(
        np.zeros((2, 3), np.float32), **t)), False),
    "bmm": _case(lambda T, x, y, t: T.bmm(x.unsqueeze(0),
                                          y.transpose([1, 0]).unsqueeze(0))),
    "broadcast_to": _case(lambda T, x, y, t: T.broadcast_to(x, [2, 2, 3])),
    "cast": _case(lambda T, x, y, t: T.cast(x, "float64")),
    "ceil": _case(lambda T, x, y, t: T.ceil(x)),
    "clip": _case(lambda T, x, y, t: T.clip(x, -0.5, 0.5)),
    "concat": _case(lambda T, x, y, t: T.concat([x, y], axis=1)),
    "cos": _case(lambda T, x, y, t: T.cos(x)),
    "cumsum": _case(lambda T, x, y, t: T.cumsum(x, axis=1)),
    "divide": _case(lambda T, x, y, t: T.divide(x, y)),
    "dot": _case(lambda T, x, y, t: T.dot(x[0], y[1])),
    "equal": _case(lambda T, x, y, t: T.equal(x, x), False),
    "erf": _case(lambda T, x, y, t: T.erf(x)),
    "exp": _case(lambda T, x, y, t: T.exp(x)),
    "expand": _case(lambda T, x, y, t: T.expand(x[0], [2, 3])),
    "eye": _case(lambda T, x, y, t: T.eye(3, 2, **t), False),
    "flatten": _case(lambda T, x, y, t: T.flatten(x)),
    "flip": _case(lambda T, x, y, t: T.flip(x, 1)),
    "floor": _case(lambda T, x, y, t: T.floor(x)),
    "full": _case(lambda T, x, y, t: T.full([2, 2], 1.5, **t), False),
    "gather": _case(lambda T, x, y, t: T.gather(x, T.to_tensor(IDX[:1], **t),
                                                axis=1)),
    "gather_nd": _case(lambda T, x, y, t: T.gather_nd(
        x, T.to_tensor(np.array([[1, 2], [0, 0]], np.int64), **t))),
    "greater_equal": _case(lambda T, x, y, t: T.greater_equal(x, y), False),
    "greater_than": _case(lambda T, x, y, t: T.greater_than(x, 0.1), False),
    "index_select": _case(lambda T, x, y, t: T.index_select(
        x, T.to_tensor(IDX, **t), axis=1)),
    "isfinite": _case(lambda T, x, y, t: T.isfinite(x / (x * 0.0)), False),
    "isinf": _case(lambda T, x, y, t: T.isinf(x / (x * 0.0)), False),
    "isnan": _case(lambda T, x, y, t: T.isnan(T.log(x)), False),
    "less_equal": _case(lambda T, x, y, t: T.less_equal(x, y), False),
    "less_than": _case(lambda T, x, y, t: T.less_than(x, y), False),
    "linspace": _case(lambda T, x, y, t: T.linspace(0.0, 1.0, 7, **t),
                      False),
    "log": _case(lambda T, x, y, t: T.log(y)),
    "logical_and": _case(lambda T, x, y, t: T.logical_and(x > 0.0, y > 1.0),
                         False),
    "logical_not": _case(lambda T, x, y, t: T.logical_not(x > 0.0), False),
    "logical_or": _case(lambda T, x, y, t: T.logical_or(x > 0.0, y > 1.0),
                        False),
    "logsumexp": _case(lambda T, x, y, t: T.logsumexp(x, axis=1)),
    "masked_select": _case(lambda T, x, y, t: T.masked_select(x, x > 0.0),
                           False),
    "matmul": _case(lambda T, x, y, t: T.matmul(x, y, transpose_y=True)),
    "max": _case(lambda T, x, y, t: T.max(x, axis=0)),
    "maximum": _case(lambda T, x, y, t: T.maximum(x, y)),
    "mean": _case(lambda T, x, y, t: T.mean(x, axis=[0, 1], keepdim=True)),
    "min": _case(lambda T, x, y, t: T.min(x)),
    "minimum": _case(lambda T, x, y, t: T.minimum(x, y)),
    "mod": _case(lambda T, x, y, t: T.mod(x, y)),
    "multinomial": _case(lambda T, x, y, t: T.multinomial(T.to_tensor(
        np.array([[0.0, 1.0, 0.0]], np.float32), **t)), False),
    "multiply": _case(lambda T, x, y, t: T.multiply(x, y)),
    "nonzero": _case(lambda T, x, y, t: T.nonzero(x > 0.0), False),
    "norm": _case(lambda T, x, y, t: T.norm(x, p=2, axis=1)),
    "not_equal": _case(lambda T, x, y, t: T.not_equal(x, y), False),
    "one_hot": _case(lambda T, x, y, t: T.one_hot(T.to_tensor(IDX, **t), 4),
                     False),
    "ones": _case(lambda T, x, y, t: T.ones([2, 1], "int32", **t), False),
    "ones_like": _case(lambda T, x, y, t: T.ones_like(x), False),
    "pad": _case(lambda T, x, y, t: T.pad(x, [1, 2], value=0.5)),
    "pow": _case(lambda T, x, y, t: T.pow(y, x)),
    "pow_scalar": _case(lambda T, x, y, t: T.pow_scalar(y, 1.5)),
    "prod": _case(lambda T, x, y, t: T.prod(y, axis=1)),
    "rand": _case(lambda T, x, y, t: T.rand([2, 2], **t), False),
    "randint": _case(lambda T, x, y, t: T.randint(0, 9, [3], **t), False),
    "randn": _case(lambda T, x, y, t: T.randn([2, 2], **t), False),
    "reshape": _case(lambda T, x, y, t: T.reshape(x, [3, 2])),
    "roll": _case(lambda T, x, y, t: T.roll(x, 1, axis=1)),
    "round": _case(lambda T, x, y, t: T.round(x)),
    "rsqrt": _case(lambda T, x, y, t: T.rsqrt(y)),
    "scale": _case(lambda T, x, y, t: T.scale(x, 2.0, 0.5, False)),
    "scatter": _case(lambda T, x, y, t: T.scatter(
        x, T.to_tensor(np.array([1], np.int64), **t), y[:1])),
    "seed": _case(lambda T, x, y, t: T.seed(3) and T.rand([2], **t), False),
    "sigmoid": _case(lambda T, x, y, t: T.sigmoid(x)),
    "sign": _case(lambda T, x, y, t: T.sign(x)),
    "sin": _case(lambda T, x, y, t: T.sin(x)),
    "sort": _case(lambda T, x, y, t: T.sort(x, axis=0)),
    "split": _case(lambda T, x, y, t: T.split(x, [1, 2], axis=1)[1]),
    "sqrt": _case(lambda T, x, y, t: T.sqrt(y)),
    "square": _case(lambda T, x, y, t: T.square(x)),
    "squeeze": _case(lambda T, x, y, t: T.squeeze(x.unsqueeze(1), 1)),
    "stack": _case(lambda T, x, y, t: T.stack([x, y], axis=1)),
    "subtract": _case(lambda T, x, y, t: T.subtract(x, y)),
    "sum": _case(lambda T, x, y, t: T.sum(x, axis=1, keepdim=True)),
    "t": _case(lambda T, x, y, t: T.t(x)),
    "tan": _case(lambda T, x, y, t: T.tan(x)),
    "tanh": _case(lambda T, x, y, t: T.tanh(x)),
    "tile": _case(lambda T, x, y, t: T.tile(x, [2, 1])),
    # (a Python float is float32 in the port, float64 in JAX under the
    # tests' 64-bit types: test_torch_dygraph.py holds the port's rule)
    "to_tensor": _case(lambda T, x, y, t: T.to_tensor([[1.5, 2.0]],
                                                      "float32", **t),
                       False),
    "topk": _case(lambda T, x, y, t: T.topk(x, 2)[0]),
    "transpose": _case(lambda T, x, y, t: T.transpose(x, [1, 0])),
    "tril": _case(lambda T, x, y, t: T.tril(x)),
    "triu": _case(lambda T, x, y, t: T.triu(x, 1)),
    "unbind": _case(lambda T, x, y, t: T.unbind(x, axis=1)[2]),
    "unique": _case(lambda T, x, y, t: T.unique(T.to_tensor(
        np.array([3, 1, 3, 2], np.int64), **t)), False),
    "unsqueeze": _case(lambda T, x, y, t: T.unsqueeze(x, [0, 2])),
    "where": _case(lambda T, x, y, t: T.where(x > 0.0, x, y)),
    "zeros": _case(lambda T, x, y, t: T.zeros([1, 2], **t), False),
    "zeros_like": _case(lambda T, x, y, t: T.zeros_like(x, "int64"), False),
}


def _public(mod):
    return sorted(n for n, v in vars(mod).items()
                  if not n.startswith("_") and inspect.isfunction(v)
                  and v.__module__ == mod.__name__)


def test_every_function_of_the_reference_has_a_case():
    assert _public(JT) == _public(TT) == sorted(CASES)


def _run(T, t, name):
    fn, diff = CASES[name]
    x = T.to_tensor(X, stop_gradient=not diff, **t)
    y = T.to_tensor(Y, stop_gradient=not diff, **t)
    T.seed(11)
    out = fn(T, x, y, t)
    return np.asarray(out.numpy()), out.dtype, out.stop_gradient


@pytest.mark.parametrize("name", sorted(CASES))
def test_function_matches_the_reference(name):
    jo, jdt, jsg = _run(JT, {}, name)
    to, tdt, tsg = _run(TT, {"device": "cpu"}, name)
    assert tdt == jdt and to.shape == jo.shape and tsg == jsg
    if to.dtype.kind in "biu":
        np.testing.assert_array_equal(to, jo)
    else:
        np.testing.assert_allclose(to, jo, rtol=1e-6, atol=1e-6,
                                   equal_nan=True)
