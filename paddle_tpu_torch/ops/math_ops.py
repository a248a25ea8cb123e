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
``sign``, ``silu``; and the rest of the reference's file: ``_mod``,
``_floordiv``, the trigonometric, logarithmic and rounding unaries,
``erf``, ``reciprocal``, ``softsign``, the parametrised activations
(``leaky_relu``, ``elu``, ``softplus``, ``swish``, ``hard_*``,
``prelu``, ``pow``), ``dot``, ``addmm``, ``p_norm``, ``maximum`` /
``minimum``, the comparisons and logical ops and the ``isfinite``
family.

Where JAX's derivative at a kink or a tie differs from torch's, the
lowering is written as JAX's function is (``jnp.where`` / ``clip``
forms): ``leaky_relu`` and ``prelu`` pass the whole gradient at 0,
``elu``'s is ``alpha`` there, ``hard_*`` split it in half at a bound,
``abs`` is 1 at 0.

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
_ew("elementwise_mod", torch.remainder)
_ew("elementwise_floordiv",
    lambda x, y: torch.div(x, y, rounding_mode="floor"))


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
_unary("log2", torch.log2)
_unary("log10", torch.log10)
_unary("log1p", torch.log1p)
_unary("abs", absolute)
_unary("reciprocal", torch.reciprocal)
_unary("sin", torch.sin)
_unary("cos", torch.cos)
_unary("tan", torch.tan)
_unary("asin", torch.asin)
_unary("acos", torch.acos)
_unary("atan", torch.atan)
_unary("sinh", torch.sinh)
_unary("cosh", torch.cosh)
_unary("asinh", torch.asinh)
_unary("acosh", torch.acosh)
_unary("atanh", torch.atanh)
_unary("erf", torch.erf)
_unary("floor", torch.floor, not_differentiable=True)
_unary("ceil", torch.ceil, not_differentiable=True)
_unary("round", torch.round, not_differentiable=True)
_unary("sign", torch.sign, not_differentiable=True)
_unary("logical_not", torch.logical_not, not_differentiable=True)
_unary("softsign", lambda x: x / (1.0 + absolute(x)))
_unary("silu", torch.nn.functional.silu)


@register("gelu")
def _gelu(ctx, ins, attrs):
    approx = bool(attrs.get("approximate", False))
    return {"Out": [torch.nn.functional.gelu(
        ins["X"][0], approximate="tanh" if approx else "none")]}


@register("leaky_relu")
def _leaky_relu(ctx, ins, attrs):
    x = ins["X"][0]
    return {"Out": [torch.where(x >= 0, x, attrs.get("alpha", 0.02) * x)]}


@register("elu")
def _elu(ctx, ins, attrs):
    x = ins["X"][0]
    alpha = attrs.get("alpha", 1.0)
    pos = x > 0
    neg = torch.where(pos, torch.zeros_like(x), x)
    return {"Out": [torch.where(pos, x, alpha * torch.expm1(neg))]}


@register("softplus")
def _softplus(ctx, ins, attrs):
    beta = attrs.get("beta", 1.0)
    threshold = attrs.get("threshold", 20.0)
    x = ins["X"][0]
    soft = torch.logaddexp(x * beta, torch.zeros_like(x)) / beta
    return {"Out": [torch.where(x * beta > threshold, x, soft)]}


@register("swish")
def _swish(ctx, ins, attrs):
    x = ins["X"][0]
    return {"Out": [x * torch.sigmoid(attrs.get("beta", 1.0) * x)]}


@register("hard_sigmoid")
def _hard_sigmoid(ctx, ins, attrs):
    slope = attrs.get("slope", 0.2)
    offset = attrs.get("offset", 0.5)
    return {"Out": [clip(slope * ins["X"][0] + offset, 0.0, 1.0)]}


@register("hard_swish")
def _hard_swish(ctx, ins, attrs):
    x = ins["X"][0]
    threshold = attrs.get("threshold", 6.0)
    scale = attrs.get("scale", 6.0)
    offset = attrs.get("offset", 3.0)
    return {"Out": [x * clip(x + offset, 0.0, threshold) / scale]}


@register("hard_tanh")
def _hard_tanh(ctx, ins, attrs):
    return {"Out": [clip(ins["X"][0], attrs.get("t_min", -1.0),
                         attrs.get("t_max", 1.0))]}


@register("prelu")
def _prelu(ctx, ins, attrs):
    x, alpha = ins["X"][0], ins["Alpha"][0]
    if attrs.get("mode", "all") == "channel":
        alpha = alpha.reshape((1, -1) + (1,) * (x.dim() - 2))
    return {"Out": [torch.where(x >= 0, x, alpha * x)]}


@register("pow")
def _pow(ctx, ins, attrs):
    return {"Out": [torch.pow(ins["X"][0], attrs.get("factor", 1.0))]}


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


@register("dot")
def _dot(ctx, ins, attrs):
    return {"Out": [torch.sum(ins["X"][0] * ins["Y"][0], dim=-1)]}


@register("addmm")
def _addmm(ctx, ins, attrs):
    inp, x, y = ins["Input"][0], ins["X"][0], ins["Y"][0]
    alpha = attrs.get("Alpha", 1.0)
    beta = attrs.get("Beta", 1.0)
    return {"Out": [beta * inp + alpha * torch.matmul(x, y)]}


def _cmp(name, fn):
    @register(name, not_differentiable=True)
    def _lower(ctx, ins, attrs, _fn=fn):
        return {"Out": [_fn(ins["X"][0], ins["Y"][0])]}
    return _lower


_cmp("equal", torch.eq)
_cmp("not_equal", torch.ne)
_cmp("less_than", torch.lt)
_cmp("less_equal", torch.le)
_cmp("greater_than", torch.gt)
_cmp("greater_equal", torch.ge)
_cmp("logical_and", torch.logical_and)
_cmp("logical_or", torch.logical_or)
_cmp("logical_xor", torch.logical_xor)


@register("isfinite", not_differentiable=True)
def _isfinite(ctx, ins, attrs):
    # the reference's isfinite_op reduces to one bool
    return {"Out": [torch.all(torch.isfinite(ins["X"][0]))]}


_unary("isfinite_v2", torch.isfinite, not_differentiable=True)
_unary("isnan_v2", torch.isnan, not_differentiable=True)
_unary("isinf_v2", torch.isinf, not_differentiable=True)


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


@register("p_norm")
def _p_norm(ctx, ins, attrs):
    x = ins["X"][0]
    porder = attrs.get("porder", 2.0)
    out = torch.pow(torch.sum(torch.pow(absolute(x), porder),
                              dim=attrs.get("axis", -1),
                              keepdim=attrs.get("keepdim", False))
                    + attrs.get("epsilon", 1e-12), 1.0 / porder)
    return {"Out": [out]}


@register("squared_l2_norm")
def _squared_l2_norm(ctx, ins, attrs):
    x = ins["X"][0]
    return {"Out": [torch.sum(torch.square(x)).reshape(1)]}



@register("maximum")
def _maximum(ctx, ins, attrs):
    return {"Out": [torch.maximum(ins["X"][0], ins["Y"][0])]}


@register("minimum")
def _minimum(ctx, ins, attrs):
    return {"Out": [torch.minimum(ins["X"][0], ins["Y"][0])]}
