"""Tensor creation and manipulation op lowerings — the counterpart of
``paddle_tpu/ops/tensor_ops.py``.

Ported: ``fill_constant``, ``fill_constant_like``, ``fill_zeros_like``,
``assign``, ``assign_value``, ``reshape2`` (with ``reshape2_grad``),
``reshape``, ``transpose2`` (with ``transpose2_grad``), ``transpose``,
``flatten2``, ``concat``, ``split``, ``slice``, ``stack``, ``arg_max``,
``arg_min``, ``top_k_v2``, ``one_hot``, ``one_hot_v2``. Waiting (ROADMAP
A7.2b): the other ~36 (``fill_any_like``, ``shape``, ``size``,
``strided_slice``, ``unstack`` / ``unbind``, ``squeeze2`` /
``unsqueeze2``, ``expand_v2``, ``tile``, the gathers and scatters,
``where``, ``cumsum``, the pads, ``range``, ``argsort``, ``top_k``,
``eye``, ``linspace``, ``flip``, ``roll``, ``meshgrid``, ...).

``top_k_v2`` orders equal values by index, as ``lax.top_k`` does (the
first maximum first): ``argmax`` at k 1, a stable sort otherwise;
``torch.topk`` promises no order among ties.

A ``fill_constant`` fills on the op's device (``ctx.device``), so a
startup program's constants land where its parameters live.
"""

from __future__ import annotations

import numpy as np
import torch

from .registry import np_dtype, register


@register("fill_constant", not_differentiable=True)
def _fill_constant(ctx, ins, attrs):
    shape = attrs.get("shape", [1])
    dtype = np_dtype(attrs.get("dtype", "float32"))
    if ins.get("ShapeTensor"):
        raise NotImplementedError(
            "a dynamic ShapeTensor is not static; use the shape attr")
    return {"Out": [torch.full(tuple(int(d) for d in shape),
                               attrs.get("value", 0.0), dtype=dtype,
                               device=ctx.device)]}


@register("fill_constant_like", not_differentiable=True)
def _fill_constant_like(ctx, ins, attrs):
    x = ins["X"][0]
    dtype = attrs.get("dtype")
    dtype = x.dtype if dtype is None else np_dtype(dtype)
    return {"Out": [torch.full(tuple(x.shape), attrs.get("value", 0.0),
                               dtype=dtype, device=x.device)]}


@register("fill_zeros_like", not_differentiable=True)
def _fill_zeros_like(ctx, ins, attrs):
    return {"Out": [torch.zeros_like(ins["X"][0])]}


@register("assign")
def _assign(ctx, ins, attrs):
    return {"Out": [ins["X"][0]]}


@register("assign_value", not_differentiable=True)
def _assign_value(ctx, ins, attrs):
    dtype = np_dtype(attrs.get("dtype", "float32"))
    values = np.asarray(attrs["values"]).reshape(attrs["shape"])
    return {"Out": [torch.as_tensor(values).to(device=ctx.device,
                                               dtype=dtype)]}


def _infer_reshape(x, shape):
    shape = [int(s) for s in shape]
    out = []
    neg = -1
    for i, s in enumerate(shape):
        if s == -1:
            neg = i
            out.append(1)
        elif s == 0:  # paddle: 0 copies the input dim
            out.append(x.shape[i])
        else:
            out.append(s)
    if neg >= 0:
        known = int(np.prod(out))
        out[neg] = int(np.prod(tuple(x.shape))) // known
    return tuple(out)


def _xshape(x):
    """The reference's ``XShape`` output: an empty ``[0, *x.shape]`` that
    carries the input's shape to the grad op."""
    return torch.zeros((0,) + tuple(x.shape), dtype=x.dtype, device=x.device)


@register("reshape2", grad_needs_outputs=("XShape",), grad_drops_inputs=("X",))
def _reshape2(ctx, ins, attrs):
    x = ins["X"][0]
    if ins.get("Shape") or ins.get("ShapeTensor"):
        raise NotImplementedError("a tensor-valued reshape shape is not "
                                  "static")
    return {"Out": [x.reshape(_infer_reshape(x, attrs["shape"]))],
            "XShape": [_xshape(x)]}


@register("reshape2_grad")
def _reshape2_grad(ctx, ins, attrs):
    g = ins["Out@GRAD"][0]
    return {"X@GRAD": [g.reshape(tuple(ins["XShape"][0].shape[1:]))]}


@register("reshape")
def _reshape(ctx, ins, attrs):
    x = ins["X"][0]
    return {"Out": [x.reshape(_infer_reshape(x, attrs["shape"]))]}


@register("transpose2", grad_drops_inputs=("X",))
def _transpose2(ctx, ins, attrs):
    x = ins["X"][0]
    return {"Out": [x.permute(*attrs["axis"])], "XShape": [_xshape(x)]}


@register("transpose2_grad")
def _transpose2_grad(ctx, ins, attrs):
    g = ins["Out@GRAD"][0]
    inv = np.argsort(attrs["axis"])
    return {"X@GRAD": [g.permute(*[int(i) for i in inv])]}


@register("transpose")
def _transpose(ctx, ins, attrs):
    return {"Out": [ins["X"][0].permute(*attrs["axis"])]}


@register("flatten2")
def _flatten2(ctx, ins, attrs):
    x = ins["X"][0]
    ax = attrs.get("axis", 1)
    shape = (int(np.prod(tuple(x.shape[:ax]))),
             int(np.prod(tuple(x.shape[ax:]))))
    return {"Out": [x.reshape(shape)], "XShape": [_xshape(x)]}


@register("concat")
def _concat(ctx, ins, attrs):
    return {"Out": [torch.cat(list(ins["X"]), dim=attrs.get("axis", 0))]}


@register("split")
def _split(ctx, ins, attrs):
    x = ins["X"][0]
    axis = attrs.get("axis", 0)
    sections = attrs.get("sections", [])
    if sections:
        outs = torch.split(x, [int(s) for s in sections], dim=axis)
    else:
        num = attrs.get("num", 0)
        outs = torch.split(x, x.shape[axis] // num, dim=axis)
    return {"Out": list(outs)}


@register("slice")
def _slice(ctx, ins, attrs):
    x = ins["X"][0]
    idx = [slice(None)] * x.dim()
    for ax, st, en in zip(attrs["axes"], attrs["starts"], attrs["ends"]):
        dim = x.shape[ax]
        st = max(st + dim, 0) if st < 0 else min(st, dim)
        en = max(en + dim, 0) if en < 0 else min(en, dim)
        idx[ax] = slice(int(st), int(en))
    out = x[tuple(idx)]
    decrease = set(attrs.get("decrease_axis", []))
    if decrease:
        out = out.reshape([d for i, d in enumerate(out.shape)
                           if i not in decrease])
    return {"Out": [out]}


@register("stack")
def _stack(ctx, ins, attrs):
    return {"Y": [torch.stack(list(ins["X"]), dim=attrs.get("axis", 0))]}


def _arg(fn):
    def _lower(ctx, ins, attrs):
        x = ins["X"][0]
        axis = attrs.get("axis", -1)
        out = fn(x, dim=axis).to(np_dtype(attrs.get("dtype", "int64")))
        if attrs.get("keepdims", False):
            out = out.unsqueeze(axis)
        return {"Out": [out]}
    return _lower


register("arg_max", not_differentiable=True)(_arg(torch.argmax))
register("arg_min", not_differentiable=True)(_arg(torch.argmin))


@register("top_k_v2", nondiff_outputs=("Indices",), no_grad_slots=())
def _top_k_v2(ctx, ins, attrs):
    x = ins["X"][0]
    k, axis = int(attrs.get("k", 1)), attrs.get("axis", -1)
    largest = attrs.get("largest", True)
    if k == 1:
        idx = (torch.argmax if largest else torch.argmin)(
            x, dim=axis, keepdim=True)
    else:
        idx = torch.sort(x, dim=axis, descending=largest,
                         stable=True).indices.narrow(axis, 0, k)
    vals = torch.gather(x, axis, idx)
    return {"Out": [vals], "Indices": [idx.to(torch.int64)]}


def _one_hot(x, depth):
    return torch.nn.functional.one_hot(x.to(torch.int64), depth).to(
        torch.float32)


@register("one_hot_v2", not_differentiable=True)
def _one_hot_v2(ctx, ins, attrs):
    """out = x.shape + [depth] (operators/one_hot_v2_op.cc)."""
    return {"Out": [_one_hot(ins["X"][0], attrs["depth"])]}


@register("one_hot", not_differentiable=True)
def _one_hot_legacy(ctx, ins, attrs):
    """Legacy one_hot (operators/one_hot_op.cc): a trailing dim of 1 is
    replaced by depth."""
    x = ins["X"][0]
    if x.dim() > 0 and x.shape[-1] == 1:
        x = x.squeeze(-1)
    return {"Out": [_one_hot(x, attrs["depth"])]}
