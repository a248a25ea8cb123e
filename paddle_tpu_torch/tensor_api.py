"""paddle.tensor-style functional surface over the tape's Tensors — the
counterpart of ``paddle_tpu/tensor_api.py`` (math, manipulation,
creation, linalg, search, random), each function through
:func:`~paddle_tpu_torch.dygraph.tape.run_op` with the reference's
defaults.

The creation functions take a keyword-only ``device`` (None: the card;
raises without one). Data that is not a Tensor takes the device of the
Tensor it meets (``add(x, 2.0)``), else ``device``'s rule.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .device import resolve_device
from .dygraph.tape import run_op
from .dygraph.tensor import Tensor, _torch_dtype
from .framework.program import convert_dtype


def _t(x, ref: Optional[Tensor] = None) -> Tensor:
    """``x`` as a Tensor; a Python scalar or list meeting ``ref`` takes
    its dtype and device, as the reference takes the dtype."""
    if isinstance(x, Tensor):
        return x
    if ref is not None:
        arr = np.asarray(x)
        v = torch.as_tensor(arr).to(ref.value.device)
        if not isinstance(x, np.ndarray) and not hasattr(x, "dtype"):
            v = v.to(ref.value.dtype)
        return Tensor(v)
    return Tensor(x)


# -- creation ----------------------------------------------------------------

def to_tensor(data, dtype=None, stop_gradient=True, *, device=None) -> Tensor:
    from .dygraph.tensor import to_tensor as _to_tensor
    return _to_tensor(data, dtype, stop_gradient, device=device)


def zeros(shape, dtype="float32", *, device=None) -> Tensor:
    return Tensor(torch.zeros(tuple(shape), dtype=_torch_dtype(dtype),
                             device=resolve_device(device)))


def ones(shape, dtype="float32", *, device=None) -> Tensor:
    return Tensor(torch.ones(tuple(shape), dtype=_torch_dtype(dtype),
                            device=resolve_device(device)))


def full(shape, fill_value, dtype="float32", *, device=None) -> Tensor:
    return Tensor(torch.full(tuple(shape), fill_value,
                            dtype=_torch_dtype(dtype),
                            device=resolve_device(device)))


def zeros_like(x, dtype=None) -> Tensor:
    v = _t(x).value
    return Tensor(torch.zeros_like(
        v, dtype=_torch_dtype(dtype) if dtype else None))


def ones_like(x, dtype=None) -> Tensor:
    v = _t(x).value
    return Tensor(torch.ones_like(
        v, dtype=_torch_dtype(dtype) if dtype else None))


def arange(start=0, end=None, step=1, dtype="int64", *,
           device=None) -> Tensor:
    if end is None:
        start, end = 0, start
    return Tensor(torch.arange(start, end, step, dtype=_torch_dtype(dtype),
                              device=resolve_device(device)))


def linspace(start, stop, num, dtype="float32", *, device=None) -> Tensor:
    # numpy's points (jnp.linspace's), computed in float64 and cast
    return Tensor(torch.as_tensor(np.linspace(start, stop, num)).to(
        resolve_device(device), _torch_dtype(dtype)))


def eye(num_rows, num_columns=None, dtype="float32", *,
        device=None) -> Tensor:
    return Tensor(torch.eye(num_rows, num_columns or num_rows,
                           dtype=_torch_dtype(dtype),
                           device=resolve_device(device)))


def rand(shape, dtype="float32", *, device=None) -> Tensor:
    return Tensor(np.random.rand(*shape).astype(convert_dtype(dtype)),
                  device=device)


def randn(shape, dtype="float32", *, device=None) -> Tensor:
    return Tensor(np.random.randn(*shape).astype(convert_dtype(dtype)),
                  device=device)


def randint(low, high=None, shape=(1,), dtype="int64", *,
            device=None) -> Tensor:
    if high is None:
        low, high = 0, low
    return Tensor(np.random.randint(low, high, shape)
                  .astype(convert_dtype(dtype)), device=device)


def seed(value: int):
    from .dygraph.layers import seed as _seed
    np.random.seed(value)
    return _seed(value)


# -- binary / unary wrappers -------------------------------------------------

def _binary(op):
    def fn(x, y, name=None):
        xt = _t(x)
        return run_op(op, {"X": [xt], "Y": [_t(y, xt)]}, {})["Out"][0]
    return fn


add = _binary("elementwise_add")
subtract = _binary("elementwise_sub")
multiply = _binary("elementwise_mul")
divide = _binary("elementwise_div")
pow = _binary("elementwise_pow")  # noqa: A001
mod = _binary("elementwise_mod")
maximum = _binary("elementwise_max")
minimum = _binary("elementwise_min")
equal = _binary("equal")
not_equal = _binary("not_equal")
less_than = _binary("less_than")
less_equal = _binary("less_equal")
greater_than = _binary("greater_than")
greater_equal = _binary("greater_equal")
logical_and = _binary("logical_and")
logical_or = _binary("logical_or")


def _unary(op):
    def fn(x, name=None):
        return run_op(op, {"X": [_t(x)]}, {})["Out"][0]
    return fn


exp = _unary("exp")
log = _unary("log")
sqrt = _unary("sqrt")
rsqrt = _unary("rsqrt")
square = _unary("square")
abs = _unary("abs")  # noqa: A001
sin = _unary("sin")
cos = _unary("cos")
tan = _unary("tan")
tanh = _unary("tanh")
sigmoid = _unary("sigmoid")
floor = _unary("floor")
ceil = _unary("ceil")
round = _unary("round")  # noqa: A001
sign = _unary("sign")
erf = _unary("erf")
logical_not = _unary("logical_not")
isnan = _unary("isnan_v2")
isinf = _unary("isinf_v2")
isfinite = _unary("isfinite_v2")


def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    return run_op("matmul_v2", {"X": [_t(x)], "Y": [_t(y)]},
                  {"trans_x": transpose_x, "trans_y": transpose_y})["Out"][0]


def dot(x, y, name=None):
    return run_op("dot", {"X": [_t(x)], "Y": [_t(y)]}, {})["Out"][0]


def bmm(x, y):
    return matmul(x, y)


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True):  # noqa: A002
    return run_op("scale", {"X": [_t(x)]},
                  {"scale": scale, "bias": bias,
                   "bias_after_scale": bias_after_scale})["Out"][0]


def clip(x, min=None, max=None):  # noqa: A002
    return run_op("clip", {"X": [_t(x)]}, {"min": min, "max": max})["Out"][0]


def cast(x, dtype):
    return _t(x).astype(dtype)


def pow_scalar(x, factor):
    return run_op("pow", {"X": [_t(x)]}, {"factor": factor})["Out"][0]


# -- reductions --------------------------------------------------------------

def _reduction(op):
    def fn(x, axis=None, keepdim=False, name=None):
        attrs = {"keep_dim": keepdim}
        if axis is None:
            attrs["reduce_all"] = True
        else:
            attrs["dim"] = [axis] if isinstance(axis, int) else list(axis)
        return run_op(op, {"X": [_t(x)]}, attrs)["Out"][0]
    return fn


sum = _reduction("reduce_sum")  # noqa: A001
mean = _reduction("reduce_mean")
max = _reduction("reduce_max")  # noqa: A001
min = _reduction("reduce_min")  # noqa: A001
prod = _reduction("reduce_prod")
all = _reduction("reduce_all")  # noqa: A001
any = _reduction("reduce_any")  # noqa: A001


def logsumexp(x, axis=None, keepdim=False):
    attrs = {"keepdim": keepdim}
    if axis is None:
        attrs["reduce_all"] = True
    else:
        attrs["axis"] = [axis] if isinstance(axis, int) else list(axis)
    return run_op("logsumexp", {"X": [_t(x)]}, attrs)["Out"][0]


def cumsum(x, axis=None):
    if axis is None:
        return run_op("cumsum", {"X": [_t(x)]},
                      {"flatten": True, "axis": 0})["Out"][0]
    return run_op("cumsum", {"X": [_t(x)]}, {"axis": axis})["Out"][0]


# -- manipulation ------------------------------------------------------------

def reshape(x, shape):
    return _t(x).reshape(shape)


def transpose(x, perm):
    return _t(x).transpose(perm)


def flatten(x, start_axis=0, stop_axis=-1):
    return _t(x).flatten(start_axis, stop_axis)


def concat(x, axis=0):
    return run_op("concat", {"X": [_t(v) for v in x]},
                  {"axis": axis})["Out"][0]


def stack(x, axis=0):
    return run_op("stack", {"X": [_t(v) for v in x]}, {"axis": axis})["Y"][0]


def split(x, num_or_sections, axis=0):
    if isinstance(num_or_sections, int):
        attrs = {"num": num_or_sections, "axis": axis}
    else:
        attrs = {"sections": list(num_or_sections), "axis": axis}
    return run_op("split", {"X": [_t(x)]}, attrs)["Out"]


def unbind(x, axis=0):
    return run_op("unbind", {"X": [_t(x)]}, {"axis": axis})["Out"]


def squeeze(x, axis=None):
    return _t(x).squeeze(axis)


def unsqueeze(x, axis):
    return _t(x).unsqueeze(axis)


def expand(x, shape):
    return run_op("expand_v2", {"X": [_t(x)]},
                  {"shape": list(shape)})["Out"][0]


def tile(x, repeat_times):
    return run_op("tile", {"X": [_t(x)]},
                  {"repeat_times": list(repeat_times)})["Out"][0]


def broadcast_to(x, shape):
    return expand(x, shape)


def gather(x, index, axis=0):
    return run_op("gather", {"X": [_t(x)], "Index": [_t(index)]},
                  {"axis": axis})["Out"][0]


def gather_nd(x, index):
    return run_op("gather_nd", {"X": [_t(x)], "Index": [_t(index)]},
                  {})["Out"][0]


def scatter(x, index, updates, overwrite=True):
    return run_op("scatter",
                  {"X": [_t(x)], "Ids": [_t(index)], "Updates": [_t(updates)]},
                  {"overwrite": overwrite})["Out"][0]


def index_select(x, index, axis=0):
    return run_op("index_select", {"X": [_t(x)], "Index": [_t(index)]},
                  {"dim": axis})["Out"][0]


def where(condition, x, y):
    return run_op("where",
                  {"Condition": [_t(condition)], "X": [_t(x)], "Y": [_t(y)]},
                  {})["Out"][0]


def flip(x, axis):
    return run_op("flip", {"X": [_t(x)]},
                  {"axis": [axis] if isinstance(axis, int) else list(axis)}
                  )["Out"][0]


def roll(x, shifts, axis=None):
    return run_op("roll", {"X": [_t(x)]},
                  {"shifts": [shifts] if isinstance(shifts, int)
                   else list(shifts),
                   "axis": [axis] if isinstance(axis, int) else axis}
                  )["Out"][0]


def tril(x, diagonal=0):
    return run_op("tril_triu", {"X": [_t(x)]},
                  {"diagonal": diagonal, "lower": True})["Out"][0]


def triu(x, diagonal=0):
    return run_op("tril_triu", {"X": [_t(x)]},
                  {"diagonal": diagonal, "lower": False})["Out"][0]


def pad(x, paddings, value=0.0):
    """The reference's ``nn.functional.pad`` routes on the tape: four
    amounts on a 4-D ``x`` (``pad2d``), six on a 5-D one (``pad3d``),
    else the last axes first (``pad``)."""
    xt = _t(x)
    if len(paddings) == 4 and xt.ndim == 4:
        return run_op("pad2d", {"X": [xt]},
                      {"paddings": [paddings[2], paddings[3], paddings[0],
                                    paddings[1]],
                       "mode": "constant", "pad_value": value})["Out"][0]
    if len(paddings) == 6 and xt.ndim == 5:
        return run_op("pad3d", {"X": [xt]},
                      {"paddings": list(paddings), "mode": "constant",
                       "value": value})["Out"][0]
    cfg = [0] * (2 * xt.ndim)
    for i in range(len(paddings) // 2):
        ax = xt.ndim - 1 - i
        cfg[2 * ax] = paddings[2 * i]
        cfg[2 * ax + 1] = paddings[2 * i + 1]
    return run_op("pad", {"X": [xt]},
                  {"paddings": cfg, "pad_value": value})["Out"][0]


# -- search / sort -----------------------------------------------------------

def argmax(x, axis=-1, keepdim=False, dtype="int64"):
    return run_op("arg_max", {"X": [_t(x)]},
                  {"axis": axis, "keepdims": keepdim,
                   "dtype": dtype})["Out"][0]


def argmin(x, axis=-1, keepdim=False, dtype="int64"):
    return run_op("arg_min", {"X": [_t(x)]},
                  {"axis": axis, "keepdims": keepdim,
                   "dtype": dtype})["Out"][0]


def argsort(x, axis=-1, descending=False):
    return run_op("argsort", {"X": [_t(x)]},
                  {"axis": axis, "descending": descending})["Indices"][0]


def sort(x, axis=-1, descending=False):
    return run_op("argsort", {"X": [_t(x)]},
                  {"axis": axis, "descending": descending})["Out"][0]


def topk(x, k, axis=-1, largest=True):
    outs = run_op("top_k_v2", {"X": [_t(x)]},
                  {"k": k, "axis": axis, "largest": largest})
    return outs["Out"][0], outs["Indices"][0]


def unique(x):
    return Tensor(torch.unique(_t(x).value.detach(), sorted=True))


def masked_select(x, mask):
    # a shape that depends on the data: read on the host, as the
    # reference does
    xv = _t(x).value.detach()
    mv = _t(mask).value.detach().to(torch.bool)
    return Tensor(xv[mv])


def nonzero(x):
    v = _t(x).value.detach()
    return Tensor(torch.nonzero(v).to(torch.int64))


def one_hot(x, num_classes):
    return run_op("one_hot_v2", {"X": [_t(x)]},
                  {"depth": num_classes})["Out"][0]


def multinomial(x, num_samples=1, replacement=False):
    return run_op("multinomial", {"X": [_t(x)]},
                  {"num_samples": num_samples})["Out"][0]


def bernoulli(x):
    return run_op("bernoulli", {"X": [_t(x)]}, {})["Out"][0]


# -- linalg ------------------------------------------------------------------

def norm(x, p=2, axis=None, keepdim=False):
    if axis is None:
        return run_op("p_norm", {"X": [_t(x).flatten()]},
                      {"porder": float(p), "axis": 0,
                       "keepdim": keepdim})["Out"][0]
    return run_op("p_norm", {"X": [_t(x)]},
                  {"porder": float(p), "axis": axis,
                   "keepdim": keepdim})["Out"][0]


def t(x):
    xt = _t(x)
    if xt.ndim < 2:
        return xt
    return xt.transpose(list(range(xt.ndim - 2)) + [xt.ndim - 1, xt.ndim - 2])
