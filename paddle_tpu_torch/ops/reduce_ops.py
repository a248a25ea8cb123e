"""Reduction op lowerings — the counterpart of
``paddle_tpu/ops/reduce_ops.py``.

Every lowering of the reference's file: ``reduce_sum``, ``reduce_mean``,
``reduce_max``, ``reduce_min``, ``reduce_prod``, ``reduce_all``,
``reduce_any``, ``mean`` and ``logsumexp``. ``logsumexp`` is
``jax.scipy.special.logsumexp``'s arithmetic: the maximum, taken as a
constant and replaced by 0 where it is not finite, shifts the
exponentials, so a row of ``-inf`` gives ``-inf`` and the gradient
JAX's.
"""

from __future__ import annotations

import torch

from .registry import register


def _axes(attrs, x):
    if attrs.get("reduce_all", False):
        return None
    dim = attrs.get("dim", [0])
    if isinstance(dim, int):
        dim = [dim]
    if not dim:
        return None
    return tuple(d % x.dim() for d in dim)


def _amax(x, dim, keepdim):
    return torch.amax(x, dim=() if dim is None else dim, keepdim=keepdim)


def _amin(x, dim, keepdim):
    return torch.amin(x, dim=() if dim is None else dim, keepdim=keepdim)


def _prod(x, dim, keepdim):
    if dim is None:
        out = torch.prod(x)
        return out.reshape((1,) * x.dim()) if keepdim else out
    for d in sorted(dim, reverse=True):
        x = torch.prod(x, dim=d, keepdim=keepdim)
    return x


def _logical(fn):
    def reduce(x, dim, keepdim):
        if dim is None:
            out = fn(x)
            return out.reshape((1,) * x.dim()) if keepdim else out
        return fn(x, dim=dim, keepdim=keepdim)
    return reduce


def _reduce(name, fn, differentiable=True):
    kw = {} if differentiable else {"not_differentiable": True}

    @register(name, **kw)
    def _lower(ctx, ins, attrs, _fn=fn):
        x = ins["X"][0]
        keep = attrs.get("keep_dim", False)
        axes = _axes(attrs, x)
        if axes is None and _fn in (torch.sum, torch.mean):
            out = _fn(x)
            return {"Out": [out.reshape((1,) * x.dim()) if keep else out]}
        return {"Out": [_fn(x, dim=axes, keepdim=keep)]}
    return _lower


_reduce("reduce_sum", torch.sum)
_reduce("reduce_mean", torch.mean)
_reduce("reduce_max", _amax)
_reduce("reduce_min", _amin)
_reduce("reduce_prod", _prod)
_reduce("reduce_all", _logical(torch.all), differentiable=False)
_reduce("reduce_any", _logical(torch.any), differentiable=False)


@register("mean")
def _mean(ctx, ins, attrs):
    return {"Out": [torch.mean(ins["X"][0])]}


@register("logsumexp")
def _logsumexp(ctx, ins, attrs):
    x = ins["X"][0]
    axis = attrs.get("axis", None)
    keepdim = attrs.get("keepdim", False)
    if attrs.get("reduce_all", False) or axis is None:
        dims = tuple(range(x.dim()))
    else:
        dims = tuple(a % x.dim() for a in (
            axis if isinstance(axis, (list, tuple)) else (axis,)))
    amax = torch.amax(x.detach(), dim=dims, keepdim=True)
    amax = torch.where(torch.isfinite(amax), amax, torch.zeros_like(amax))
    out = torch.log(torch.sum(torch.exp(x - amax), dim=dims,
                              keepdim=True)) + amax
    return {"Out": [out if keepdim else out.reshape(
        [d for i, d in enumerate(out.shape) if i not in dims])]}
