"""Reduction op lowerings — the counterpart of
``paddle_tpu/ops/reduce_ops.py``.

Ported: ``reduce_sum``, ``reduce_mean``, ``reduce_max``, ``reduce_min``,
``reduce_prod`` and ``mean``. Waiting (ROADMAP A7.2b): ``reduce_all``,
``reduce_any`` and ``logsumexp``.
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


def _reduce(name, fn):
    @register(name)
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


@register("mean")
def _mean(ctx, ins, attrs):
    return {"Out": [torch.mean(ins["X"][0])]}
