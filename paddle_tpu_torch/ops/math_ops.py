"""Dense math op lowerings — the counterpart of
``paddle_tpu/ops/math_ops.py`` for the ops the ported builders,
initializers, ``append_backward``, clips, regularizers and optimizers
emit.

Ported: ``elementwise_add`` / ``_sub`` / ``_mul`` / ``_div`` / ``_max`` /
``_min`` / ``_pow``; ``scale``, ``mul``, ``matmul``, ``matmul_v2``, ``cast`` (with
``cast_grad``), ``clip``, ``clip_by_norm``, ``sum``, ``increment``,
``squared_l2_norm``, ``optimization_barrier``, ``gelu``; the unary
activations ``relu``, ``relu6``, ``sigmoid``, ``logsigmoid``, ``tanh``,
``sqrt``, ``rsqrt``, ``square``, ``exp``, ``log``, ``abs``, ``floor``,
``sign``, ``silu``. Waiting (ROADMAP A7.2b): the other elementwise ops
(``_mod``, ``_floordiv``), the trigonometric unaries and the other
rounding ones, the parametrised activations (``leaky_relu``, ``elu``,
``softplus``, ``swish``, ``hard_*``, ``prelu``, ``pow``), ``dot``,
``addmm``, ``p_norm``, ``maximum`` / ``minimum``, the comparisons and
the ``isfinite`` family.

The products (``mul``, ``matmul``) are ``torch.matmul`` (cuBLAS on the
card): the reference computes them in XLA, outside any Pallas kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from .registry import register


def _bcast_y(x, y, axis: int):
    """Paddle elementwise broadcast: align y's dims to x starting at
    ``axis`` (elementwise_op_function.h semantics)."""
    if axis == -1 or x.dim() == y.dim():
        return y
    axis = int(axis)
    pad_right = x.dim() - axis - y.dim()
    return y.reshape((1,) * axis + tuple(y.shape) + (1,) * pad_right)


def _ew(name, fn):
    @register(name)
    def _lower(ctx, ins, attrs, _fn=fn):
        x, y = ins["X"][0], ins["Y"][0]
        y = _bcast_y(x, y, attrs.get("axis", -1))
        return {"Out": [_fn(x, y)]}
    return _lower


_ew("elementwise_add", torch.add)
_ew("elementwise_sub", torch.sub)
_ew("elementwise_mul", torch.mul)
_ew("elementwise_div", torch.div)
_ew("elementwise_max", torch.maximum)
_ew("elementwise_min", torch.minimum)
_ew("elementwise_pow", torch.pow)


def clip(x, lo=None, hi=None):
    """``jnp.clip``: ``minimum(maximum(x, lo), hi)``, whose gradient at a
    bound is split in half as JAX's is (``torch.clamp`` passes it
    whole); ``lo`` / ``hi`` are numbers, tensors or None."""
    def bound(v):
        return v if isinstance(v, torch.Tensor) else torch.full_like(x, v)
    if lo is not None:
        x = torch.maximum(x, bound(lo))
    if hi is not None:
        x = torch.minimum(x, bound(hi))
    return x


def absolute(x):
    """``jnp.abs``, whose gradient at 0 is JAX's 1 (``torch.abs`` gives
    0 there)."""
    return torch.where(x >= 0, x, -x)


def _unary(name, fn, **kw):
    @register(name, **kw)
    def _lower(ctx, ins, attrs, _fn=fn):
        return {"Out": [_fn(ins["X"][0])]}
    return _lower


_unary("relu", torch.relu)
_unary("relu6", lambda x: clip(x, 0.0, 6.0))
_unary("sigmoid", torch.sigmoid)
_unary("logsigmoid", torch.nn.functional.logsigmoid)
_unary("tanh", torch.tanh)
_unary("sqrt", torch.sqrt)
_unary("rsqrt", torch.rsqrt)
_unary("square", torch.square)
_unary("exp", torch.exp)
_unary("log", torch.log)
_unary("abs", absolute)
_unary("floor", torch.floor, not_differentiable=True)
_unary("sign", torch.sign, not_differentiable=True)
_unary("silu", torch.nn.functional.silu)


@register("gelu")
def _gelu(ctx, ins, attrs):
    approx = bool(attrs.get("approximate", False))
    return {"Out": [torch.nn.functional.gelu(
        ins["X"][0], approximate="tanh" if approx else "none")]}


def _scalar(value, like):
    """A Python scalar as a 0-dim tensor of ``like``'s dtype and device
    (``jnp.asarray(value, x.dtype)``), filled on the device: a copy from
    the host could not be captured."""
    return torch.full((), value, dtype=like.dtype, device=like.device)


@register("scale")
def _scale(ctx, ins, attrs):
    x = ins["X"][0]
    scale = attrs.get("scale", 1.0)
    bias = attrs.get("bias", 0.0)
    bias_after_scale = attrs.get("bias_after_scale", True)
    if "ScaleTensor" in ins and ins["ScaleTensor"]:
        scale = ins["ScaleTensor"][0]
    if bias_after_scale:
        out = x * scale + _scalar(bias, x)
    else:
        out = (x + _scalar(bias, x)) * scale
    return {"Out": [out]}


@register("clip")
def _clip(ctx, ins, attrs):
    lo = ins["Min"][0] if ins.get("Min") else attrs.get("min")
    hi = ins["Max"][0] if ins.get("Max") else attrs.get("max")
    return {"Out": [clip(ins["X"][0], lo, hi)]}


@register("clip_by_norm")
def _clip_by_norm(ctx, ins, attrs):
    x = ins["X"][0]
    max_norm = attrs["max_norm"]
    norm = torch.sqrt(torch.sum(torch.square(x)))
    scale = torch.where(norm > max_norm,
                        torch.div(torch.full_like(norm, max_norm),
                                  torch.clamp(norm, min=1e-12)),
                        torch.ones_like(norm))
    return {"Out": [x * scale.to(x.dtype)]}


@register("sum")
def _sum(ctx, ins, attrs):
    xs = ins["X"]
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return {"Out": [out]}


@register("cast", custom_grad_maker=None)
def _cast(ctx, ins, attrs):
    from .registry import np_dtype
    return {"Out": [ins["X"][0].to(np_dtype(attrs["out_dtype"]))]}


@register("cast_grad")
def _cast_grad(ctx, ins, attrs):
    from .registry import np_dtype
    g = ins["Out@GRAD"][0]
    if ins.get("X"):  # the default grad maker forwards X; its dtype rules
        in_dtype = ins["X"][0].dtype
    else:
        in_dtype = np_dtype(attrs.get("in_dtype", "float32"))
    if not (in_dtype.is_floating_point or in_dtype.is_complex):
        return {"X@GRAD": [torch.zeros(tuple(g.shape), dtype=in_dtype,
                                       device=g.device)]}
    return {"X@GRAD": [g.to(in_dtype)]}


@register("matmul")
def _matmul(ctx, ins, attrs):
    x, y = ins["X"][0], ins["Y"][0]
    if attrs.get("transpose_X", False) and x.dim() > 1:
        x = x.transpose(-1, -2)
    if attrs.get("transpose_Y", False) and y.dim() > 1:
        y = y.transpose(-1, -2)
    out = torch.matmul(x, y)
    alpha = attrs.get("alpha", 1.0)
    if alpha != 1.0:
        out = out * alpha
    return {"Out": [out]}


@register("matmul_v2")
def _matmul_v2(ctx, ins, attrs):
    x, y = ins["X"][0], ins["Y"][0]
    if attrs.get("trans_x", False) and x.dim() > 1:
        x = x.transpose(-1, -2)
    if attrs.get("trans_y", False) and y.dim() > 1:
        y = y.transpose(-1, -2)
    return {"Out": [torch.matmul(x, y)]}


@register("mul")
def _mul(ctx, ins, attrs):
    """FC matmul: x flattened to 2-D at ``x_num_col_dims``
    (operators/mul_op.cc)."""
    x, y = ins["X"][0], ins["Y"][0]
    xn = attrs.get("x_num_col_dims", 1)
    yn = attrs.get("y_num_col_dims", 1)
    xs, ys = tuple(x.shape), tuple(y.shape)
    x2 = x.reshape(int(np.prod(xs[:xn])), int(np.prod(xs[xn:])))
    y2 = y.reshape(int(np.prod(ys[:yn])), int(np.prod(ys[yn:])))
    return {"Out": [torch.matmul(x2, y2).reshape(xs[:xn] + ys[yn:])]}


@register("optimization_barrier", not_differentiable=True)
def _optimization_barrier(ctx, ins, attrs):
    """The recompute rewrite's CSE fence: there is no compiler to fence in
    the port, so it passes its inputs through."""
    return {"Out": list(ins["X"])}


@register("increment", not_differentiable=True)
def _increment(ctx, ins, attrs):
    x = ins["X"][0]
    # dtype-preserving: an int64 counter stays int64, as in the reference
    return {"Out": [x + _scalar(attrs.get("step", 1.0), x)]}


@register("squared_l2_norm")
def _squared_l2_norm(ctx, ins, attrs):
    x = ins["X"][0]
    return {"Out": [torch.sum(torch.square(x)).reshape(1)]}

