"""Tensor creation and manipulation op lowerings — the counterpart of
``paddle_tpu/ops/tensor_ops.py``.

Every lowering of the reference's file, in its order: creation
(``fill_*``, ``assign*``, ``shape``, ``size``, ``range``, ``eye``,
``linspace``, ``meshgrid``), reshaping (``reshape*``, ``transpose*``,
``flatten*``, ``squeeze2`` / ``unsqueeze2`` with their grads,
``concat``, ``split``, ``slice``, ``strided_slice``, ``stack``,
``unstack``, ``unbind``, ``expand_v2``, ``expand_as_v2``, ``tile``,
``flip``, ``roll``, the pads, ``tril_triu``), indexing (``gather``,
``gather_nd``, ``scatter``, ``index_select``, ``where``,
``where_index``), ``cumsum`` and the orders (``arg_max`` / ``arg_min``,
``argsort``, ``top_k`` / ``top_k_v2``, ``one_hot*``).

``argsort``, ``top_k`` and ``top_k_v2`` order equal values by index, as
``jnp.argsort`` (stable) and ``lax.top_k`` do (the first maximum first):
``argmax`` at k 1, a stable sort otherwise; ``torch.topk`` promises no
order among ties.

``where_index`` (``nonzero``) has a shape that depends on values, so it
raises, as the reference's does; no graph could hold it. Constants from
the host (``shape``, ``assign_value``) are filled on the device
(:func:`host_values`), so a captured step holds no copy from the host.

A ``fill_constant`` fills on the op's device (``ctx.device``), so a
startup program's constants land where its parameters live.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .registry import np_dtype, register


def host_values(values, dtype, device) -> torch.Tensor:
    """A small array of host values as a tensor on ``device``. Outside a
    capture it is one copy; under capture each value is a fill on the
    device, as a copy from the host cannot be captured."""
    arr = np.asarray(values)
    if (device is None or torch.device(device).type != "cuda"
            or not torch.cuda.is_current_stream_capturing()):
        return torch.as_tensor(arr).to(device=device, dtype=dtype)
    flat = torch.empty(arr.size, dtype=dtype, device=device)
    for i, v in enumerate(arr.reshape(-1).tolist()):
        flat[i].fill_(v)
    return flat.reshape(arr.shape)


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


@register("fill_any_like", not_differentiable=True)
def _fill_any_like(ctx, ins, attrs):
    x = ins["X"][0]
    dtype = attrs.get("dtype")
    dtype = x.dtype if dtype in (None, -1) else np_dtype(dtype)
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
    return {"Out": [host_values(values, dtype, ctx.device)]}


@register("shape", not_differentiable=True)
def _shape(ctx, ins, attrs):
    x = ins["Input"][0]
    return {"Out": [host_values(np.asarray(tuple(x.shape), np.int64),
                                torch.int64, x.device)]}


@register("size", not_differentiable=True)
def _size(ctx, ins, attrs):
    x = ins["Input"][0]
    return {"Out": [torch.full((), x.numel(), dtype=torch.int64,
                               device=x.device)]}


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


def _reshape_back(ctx, ins, attrs):
    """The grad of a reshaping op: the cotangent in ``XShape``'s shape."""
    g = ins["Out@GRAD"][0]
    return {"X@GRAD": [g.reshape(tuple(ins["XShape"][0].shape[1:]))]}


@register("reshape2", grad_needs_outputs=("XShape",), grad_drops_inputs=("X",))
def _reshape2(ctx, ins, attrs):
    x = ins["X"][0]
    if ins.get("Shape") or ins.get("ShapeTensor"):
        raise NotImplementedError("a tensor-valued reshape shape is not "
                                  "static")
    return {"Out": [x.reshape(_infer_reshape(x, attrs["shape"]))],
            "XShape": [_xshape(x)]}


register("reshape2_grad")(_reshape_back)


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


@register("flatten_contiguous_range", grad_needs_outputs=("XShape",),
          grad_drops_inputs=("X",))
def _flatten_contiguous_range(ctx, ins, attrs):
    x = ins["X"][0]
    start = attrs.get("start_axis", 1)
    stop = attrs.get("stop_axis", -1)
    if stop < 0:
        stop += x.dim()
    shape = (tuple(x.shape[:start])
             + (int(np.prod(tuple(x.shape[start:stop + 1]))),)
             + tuple(x.shape[stop + 1:]))
    return {"Out": [x.reshape(shape)], "XShape": [_xshape(x)]}


register("flatten_contiguous_range_grad")(_reshape_back)


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


@register("strided_slice")
def _strided_slice(ctx, ins, attrs):
    """Python slicing per axis; a negative stride (which torch's views
    cannot take) selects its indices with ``index_select``."""
    out = ins["X"][0]
    for ax, st, en, sd in zip(attrs["axes"], attrs["starts"], attrs["ends"],
                              attrs["strides"]):
        sl = slice(int(st), int(en), int(sd))
        if sl.step > 0:
            idx = [slice(None)] * out.dim()
            idx[ax] = sl
            out = out[tuple(idx)]
        else:
            start, stop, step = sl.indices(out.shape[ax])
            pick = torch.arange(start, stop, step, dtype=torch.int64,
                                device=out.device)
            out = out.index_select(ax, pick)
    return {"Out": [out]}


@register("stack")
def _stack(ctx, ins, attrs):
    return {"Y": [torch.stack(list(ins["X"]), dim=attrs.get("axis", 0))]}


@register("unstack")
def _unstack(ctx, ins, attrs):
    return {"Y": list(torch.unbind(ins["X"][0], dim=attrs.get("axis", 0)))}


@register("unbind")
def _unbind(ctx, ins, attrs):
    return {"Out": list(torch.unbind(ins["X"][0],
                                     dim=attrs.get("axis", 0)))}


def squeezed_shape(x, axes):
    """``x``'s shape without the size-1 dims in ``axes`` (all of them for
    empty ``axes``)."""
    if axes:
        axes = {a % x.dim() for a in axes}
        return [d for i, d in enumerate(x.shape)
                if not (i in axes and d == 1)]
    return [d for d in x.shape if d != 1]


@register("squeeze2", grad_needs_outputs=("XShape",), grad_drops_inputs=("X",))
def _squeeze2(ctx, ins, attrs):
    x = ins["X"][0]
    return {"Out": [x.reshape(squeezed_shape(x, attrs.get("axes", [])))],
            "XShape": [_xshape(x)]}


register("squeeze2_grad")(_reshape_back)


@register("unsqueeze2", grad_needs_outputs=("XShape",),
          grad_drops_inputs=("X",))
def _unsqueeze2(ctx, ins, attrs):
    x = ins["X"][0]
    out = x
    for a in sorted(a % (x.dim() + len(attrs["axes"]))
                    for a in attrs["axes"]):
        out = out.unsqueeze(a)
    return {"Out": [out], "XShape": [_xshape(x)]}


register("unsqueeze2_grad")(_reshape_back)


@register("expand_v2")
def _expand_v2(ctx, ins, attrs):
    x = ins["X"][0]
    shape = [int(s) for s in attrs["shape"]]
    # -1 keeps the input's dim
    xshape = (1,) * (len(shape) - x.dim()) + tuple(x.shape)
    tgt = tuple(xs if s == -1 else s for s, xs in zip(shape, xshape))
    return {"Out": [x.reshape(xshape).expand(tgt)]}


@register("expand_as_v2")
def _expand_as_v2(ctx, ins, attrs):
    x = ins["X"][0]
    tgt = attrs.get("target_shape")
    if tgt is None:
        tgt = ins["Y"][0].shape
    return {"Out": [x.expand(tuple(int(d) for d in tgt))]}


@register("tile")
def _tile(ctx, ins, attrs):
    return {"Out": [torch.tile(ins["X"][0],
                               tuple(int(r) for r in attrs["repeat_times"]))]}


def take(x, idx, axis):
    """``jnp.take(x, idx, axis)`` for in-range indices of any shape."""
    axis = axis % x.dim()
    flat = x.index_select(axis, idx.reshape(-1).to(torch.int64))
    return flat.reshape(tuple(x.shape[:axis]) + tuple(idx.shape)
                        + tuple(x.shape[axis + 1:]))


@register("gather", no_grad_slots=("Index",))
def _gather(ctx, ins, attrs):
    return {"Out": [take(ins["X"][0], ins["Index"][0],
                         attrs.get("axis", 0))]}


@register("gather_nd", no_grad_slots=("Index",))
def _gather_nd(ctx, ins, attrs):
    x, idx = ins["X"][0], ins["Index"][0].to(torch.int64)
    return {"Out": [x[tuple(idx[..., i] for i in range(idx.shape[-1]))]]}


@register("scatter", no_grad_slots=("Ids",))
def _scatter(ctx, ins, attrs):
    x, ids, updates = ins["X"][0], ins["Ids"][0], ins["Updates"][0]
    ids = (ids.to(torch.int64),)
    return {"Out": [x.index_put(ids, updates,
                                accumulate=not attrs.get("overwrite",
                                                         True))]}


@register("index_select", no_grad_slots=("Index",))
def _index_select(ctx, ins, attrs):
    return {"Out": [take(ins["X"][0], ins["Index"][0],
                         attrs.get("dim", 0))]}


@register("where")
def _where(ctx, ins, attrs):
    return {"Out": [torch.where(ins["Condition"][0], ins["X"][0],
                                ins["Y"][0])]}


@register("where_index", not_differentiable=True)
def _where_index(ctx, ins, attrs):
    raise NotImplementedError(
        "where_index (nonzero) has an output shape that depends on the "
        "values, which no captured step can hold; use masked ops instead")


@register("cumsum")
def _cumsum(ctx, ins, attrs):
    x = ins["X"][0]
    axis = attrs.get("axis", -1)
    if attrs.get("flatten", False):
        x = x.reshape(-1)
        axis = 0
    if attrs.get("reverse", False):
        out = torch.flip(torch.cumsum(torch.flip(x, (axis,)), dim=axis),
                         (axis,))
    else:
        out = torch.cumsum(x, dim=axis)
    if attrs.get("exclusive", False):
        out = out - x
    return {"Out": [out]}


def _pad_pairs(pairs):
    """``jnp.pad``'s ``[(lo, hi)]`` per dim as ``F.pad``'s flat list, last
    dim first."""
    return [int(v) for lo_hi in reversed(pairs) for v in lo_hi]


@register("pad")
def _pad(ctx, ins, attrs):
    x = ins["X"][0]
    p = attrs["paddings"]
    pairs = [(p[2 * i], p[2 * i + 1]) for i in range(x.dim())]
    return {"Out": [F.pad(x, _pad_pairs(pairs),
                          value=attrs.get("pad_value", 0.0))]}


_PAD_MODES = {"reflect": "reflect", "replicate": "replicate",
              "edge": "replicate", "circular": "circular"}


def _pad_spatial(x, pairs, mode, value):
    if mode == "constant":
        return F.pad(x, _pad_pairs(pairs), value=value)
    return F.pad(x, _pad_pairs(pairs), mode=_PAD_MODES[mode])


@register("pad3d")
def _pad3d(ctx, ins, attrs):
    p = attrs["paddings"]  # [l, r, top, bottom, front, back] of NCDHW
    return {"Out": [_pad_spatial(ins["X"][0],
                                 [(p[4], p[5]), (p[2], p[3]), (p[0], p[1])],
                                 attrs.get("mode", "constant"),
                                 attrs.get("value", 0.0))]}


@register("pad2d")
def _pad2d(ctx, ins, attrs):
    p = attrs["paddings"]  # [top, bottom, l, r] of NCHW
    return {"Out": [_pad_spatial(ins["X"][0], [(p[0], p[1]), (p[2], p[3])],
                                 attrs.get("mode", "constant"),
                                 attrs.get("pad_value", 0.0))]}


@register("tril_triu")
def _tril_triu(ctx, ins, attrs):
    fn = torch.tril if attrs.get("lower", True) else torch.triu
    return {"Out": [fn(ins["X"][0], attrs.get("diagonal", 0))]}


@register("range", not_differentiable=True)
def _range(ctx, ins, attrs):
    start, end = attrs.get("start"), attrs.get("end")
    if start is None and ins.get("Start"):
        raise NotImplementedError("tensor-valued range bounds are not "
                                  "static")
    return {"Out": [torch.arange(start, end, attrs.get("step", 1),
                                 dtype=np_dtype(attrs.get("dtype", "int64")),
                                 device=ctx.device)]}


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


@register("argsort", nondiff_outputs=("Indices",))
def _argsort(ctx, ins, attrs):
    x = ins["X"][0]
    axis = attrs.get("axis", -1)
    key = -x if attrs.get("descending", False) else x
    idx = torch.argsort(key, dim=axis, stable=True)
    return {"Out": [torch.gather(x, axis, idx)], "Indices": [idx]}


def top_k(x, k, axis=-1, largest=True):
    """``lax.top_k`` along ``axis``: ``(values, int64 indices)``, equal
    values in index order."""
    if k == 1:
        idx = (torch.argmax if largest else torch.argmin)(
            x, dim=axis, keepdim=True)
    else:
        idx = torch.sort(x, dim=axis, descending=largest,
                         stable=True).indices.narrow(axis, 0, k)
    return torch.gather(x, axis, idx), idx.to(torch.int64)


@register("top_k_v2", nondiff_outputs=("Indices",), no_grad_slots=())
def _top_k_v2(ctx, ins, attrs):
    vals, idx = top_k(ins["X"][0], int(attrs.get("k", 1)),
                      attrs.get("axis", -1), attrs.get("largest", True))
    return {"Out": [vals], "Indices": [idx]}


@register("top_k", nondiff_outputs=("Indices",))
def _top_k(ctx, ins, attrs):
    vals, idx = top_k(ins["X"][0], int(attrs.get("k", 1)))
    return {"Out": [vals], "Indices": [idx]}


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


@register("eye", not_differentiable=True)
def _eye(ctx, ins, attrs):
    n = int(attrs["num_rows"])
    m = attrs.get("num_columns", n)
    return {"Out": [torch.eye(n, int(m) if m > 0 else n,
                              dtype=np_dtype(attrs.get("dtype", "float32")),
                              device=ctx.device)]}


@register("linspace", not_differentiable=True)
def _linspace(ctx, ins, attrs):
    """``jnp.linspace``'s arithmetic: ``start * (1 - t) + stop * t`` for
    ``t = i / (num - 1)``, then ``stop`` itself; floored for an integer
    dtype. Tensor bounds stay on the device."""
    if not attrs.get("num") and ins.get("Num"):
        raise NotImplementedError("a tensor-valued linspace count is not "
                                  "static")
    num = int(attrs["num"])
    dtype = np_dtype(attrs.get("dtype", "float32"))
    comp = dtype if dtype.is_floating_point else torch.float32
    dev = ctx.device

    def bound(slot, key):
        v = ins[slot][0] if ins.get(slot) else attrs[key]
        if isinstance(v, torch.Tensor):
            dev_ = v.device
            return v.reshape(()).to(comp), dev_
        return torch.full((), float(v), dtype=comp, device=dev), dev

    start, dev = bound("Start", "start")
    stop, _ = bound("Stop", "stop")
    if num > 1:
        div = num - 1
        t = torch.arange(div, dtype=comp, device=dev) / div
        out = torch.cat([start * (1 - t) + stop * t, stop.reshape(1)])
    else:
        out = start.reshape(1)[:num]
    if not dtype.is_floating_point:
        out = torch.floor(out)
    return {"Out": [out.to(dtype)]}


@register("flip")
def _flip(ctx, ins, attrs):
    axis = attrs["axis"]
    dims = (axis,) if isinstance(axis, int) else tuple(axis)
    return {"Out": [torch.flip(ins["X"][0], dims)]}


@register("roll")
def _roll(ctx, ins, attrs):
    shifts = attrs["shifts"]
    shifts = tuple(shifts) if isinstance(shifts, (list, tuple)) else shifts
    axis = attrs.get("axis", None)
    if axis:
        return {"Out": [torch.roll(ins["X"][0], shifts, tuple(axis))]}
    return {"Out": [torch.roll(ins["X"][0], shifts)]}


@register("meshgrid")
def _meshgrid(ctx, ins, attrs):
    return {"Out": list(torch.meshgrid(*ins["X"], indexing="ij"))}
