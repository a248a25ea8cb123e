"""Index op lowerings — the counterpart of ``paddle_tpu/ops/index_ops.py``:
``masked_select``, ``index_sample``, ``multiplex``, ``reverse``,
``scatter_nd_add``, ``gather_tree``, ``selu``, ``mish``, ``conv_shift``,
``row_conv`` (the lookahead convolution), ``partial_concat``,
``partial_sum``, ``shuffle_batch`` and the v1 ``expand`` / ``expand_as`` /
``flatten`` / ``squeeze`` / ``unsqueeze``, and ``im2sequence`` (conv
patches as a ``(N * Ho * Wo, C * kh * kw)`` sequence batch).

``masked_select`` has an output shape that depends on the values: it
runs in eager (dygraph) calls only and raises in the executor, on the
first run too, as the reference's does under its trace.
``shuffle_batch`` draws ``jax.random.permutation``'s stream
(:func:`~paddle_tpu_torch.prng.permutation`).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .. import prng
from .registry import register
from .tensor_ops import squeezed_shape


@register("masked_select", no_grad_slots=("Mask",))
def _masked_select(ctx, ins, attrs):
    """masked_select_op.cc: the elements of X where Mask holds."""
    if not ctx.eager:
        raise NotImplementedError(
            "masked_select has an output shape that depends on the values, "
            "which no captured step can hold; use it in dygraph (eager) "
            "mode, or keep the computation masked: x * mask / where(mask, "
            "x, fill)")
    return {"Y": [ins["X"][0][ins["Mask"][0].to(torch.bool)]]}


@register("index_sample", no_grad_slots=("Index",))
def _index_sample(ctx, ins, attrs):
    """index_sample_op.cc: out[i, j] = x[i, index[i, j]]."""
    return {"Out": [torch.gather(ins["X"][0], 1,
                                 ins["Index"][0].to(torch.int64))]}


@register("multiplex", no_grad_slots=("Ids",))
def _multiplex(ctx, ins, attrs):
    """multiplex_op.cc: out[i] = X[ids[i]][i]."""
    xs = torch.stack(list(ins["X"]), dim=0)            # (k, N, ...)
    ids = ins["Ids"][0].reshape(-1).to(torch.int64)
    rows = torch.arange(xs.shape[1], device=xs.device)
    return {"Out": [xs[ids, rows]]}


@register("reverse")
def _reverse(ctx, ins, attrs):
    axes = attrs.get("axis", [0])
    if not isinstance(axes, (list, tuple)):
        axes = [axes]
    return {"Out": [torch.flip(ins["X"][0], tuple(int(a) for a in axes))]}


@register("scatter_nd_add", no_grad_slots=("Index",))
def _scatter_nd_add(ctx, ins, attrs):
    """scatter_nd_add_op.cc: out = x; out[index] += updates, index (...,
    K) indexing x's first K dims."""
    x, idx, upd = ins["X"][0], ins["Index"][0], ins["Updates"][0]
    k = idx.shape[-1]
    flat = idx.reshape(-1, k).to(torch.int64)
    upd = upd.reshape((flat.shape[0],) + tuple(x.shape[k:]))
    return {"Out": [x.index_put(tuple(flat[:, i] for i in range(k)), upd,
                                accumulate=True)]}


@register("gather_tree", not_differentiable=True)
def _gather_tree(ctx, ins, attrs):
    """gather_tree_op.cc: whole beam-search sequences traced back through
    the parent pointers, time-major (T, B, W)."""
    ids, parents = ins["Ids"][0], ins["Parents"][0]
    sel = torch.arange(ids.shape[2], dtype=torch.int64,
                       device=ids.device).expand(tuple(ids.shape[1:]))
    outs = []
    for t in range(ids.shape[0] - 1, -1, -1):
        outs.append(torch.gather(ids[t], 1, sel))
        sel = torch.gather(parents[t], 1, sel).to(torch.int64)
    return {"Out": [torch.stack(outs[::-1])]}


@register("selu")
def _selu(ctx, ins, attrs):
    x = ins["X"][0]
    scale = attrs.get("scale", 1.0507009873554804934193349852946)
    alpha = attrs.get("alpha", 1.6732632423543772848170429916717)
    return {"Out": [scale * torch.where(x > 0, x, alpha * torch.expm1(x))]}


@register("mish")
def _mish(ctx, ins, attrs):
    """mish_op.cc: x * tanh(softplus(x)), x itself past ``threshold``."""
    x = ins["X"][0]
    soft = torch.logaddexp(x, torch.zeros_like(x))
    sp = torch.where(x > attrs.get("threshold", 20.0), x, soft)
    return {"Out": [x * torch.tanh(sp)]}


@register("conv_shift")
def _conv_shift(ctx, ins, attrs):
    """conv_shift_op.cc: circular correlation, X (B, M), Y (B, N) with N
    odd; out[:, i] = sum_k x[:, (i + k - N // 2) % M] * y[:, k]."""
    x, y = ins["X"][0], ins["Y"][0]
    half = y.shape[1] // 2
    return {"Out": [sum(torch.roll(x, half - k, dims=1) * y[:, k:k + 1]
                        for k in range(y.shape[1]))]}


@register("row_conv")
def _row_conv(ctx, ins, attrs):
    """row_conv_op.cc, dense: X (B, T, D), Filter (context, D);
    out[b, t] = sum_c x[b, t + c] * filter[c]."""
    x, f = ins["X"][0], ins["Filter"][0]
    ctx_len = f.shape[0]
    xp = F.pad(x, (0, 0, 0, ctx_len - 1))
    return {"Out": [sum(xp[:, c:c + x.shape[1]] * f[c]
                        for c in range(ctx_len))]}


def _partial(ins, attrs):
    start = int(attrs.get("start_index", 0))
    length = int(attrs.get("length", -1))
    parts = []
    for x in ins["X"]:
        s = start % x.shape[1] if start < 0 else start
        e = x.shape[1] if length == -1 else s + length
        parts.append(x[:, s:e])
    return parts


@register("partial_concat")
def _partial_concat(ctx, ins, attrs):
    """partial_concat_op.cc: columns [start, start + length) of each
    input, concatenated."""
    return {"Out": [torch.cat(_partial(ins, attrs), dim=1)]}


@register("partial_sum")
def _partial_sum(ctx, ins, attrs):
    """partial_sum_op.cc: the same columns, summed."""
    return {"Out": [sum(_partial(ins, attrs))]}


@register("shuffle_batch", no_grad_slots=("Seed",))
def _shuffle_batch(ctx, ins, attrs):
    """shuffle_batch_op.cc: a random row permutation, emitted so that a
    gradient can be unshuffled."""
    x = ins["X"][0]
    perm = prng.permutation(ctx.rng(), x.shape[0])
    seed = ins.get("Seed", [None])[0]
    if seed is None:
        seed = torch.zeros((1,), dtype=torch.int64, device=x.device)
    return {"Out": [x[perm]], "ShuffleIdx": [perm], "SeedOut": [seed]}


# -- v1 forms of v2 ops (their attrs differ) --------------------------------



@register("im2sequence")
def _im2sequence(ctx, ins, attrs):
    from .image_ops import _pair, extract_patches
    x = ins["X"][0]
    k = _pair(attrs["kernels"])
    s = _pair(attrs.get("strides", [1, 1]))
    pads = attrs.get("paddings", [0, 0, 0, 0])
    p = [int(pads[0]), int(pads[1])] if len(pads) >= 2 else _pair(pads)
    patches, ho, wo = extract_patches(x, k, s, p, [1, 1])
    n = x.shape[0]
    # (N,C,khkw,Ho,Wo) -> (N,Ho,Wo,C,khkw) -> (N*Ho*Wo, C*kh*kw)
    return {"Out": [patches.permute(0, 3, 4, 1, 2).reshape(n * ho * wo, -1)]}


@register("expand")
def _expand_v1(ctx, ins, attrs):
    """expand_op.cc: tiles by ``expand_times`` (not a target shape)."""
    return {"Out": [torch.tile(ins["X"][0],
                               tuple(int(t) for t in attrs["expand_times"]))]}


@register("expand_as")
def _expand_as_v1(ctx, ins, attrs):
    """expand_as_op.cc: tiles X up to the target's shape."""
    x = ins["X"][0]
    y = ins.get("target_tensor", ins.get("Y", [None]))[0]
    return {"Out": [torch.tile(x, tuple(ys // xs for xs, ys in
                                        zip(x.shape, y.shape)))]}


@register("flatten")
def _flatten_v1(ctx, ins, attrs):
    """flatten_op.cc: 2-D at ``axis`` (no XShape)."""
    x = ins["X"][0]
    ax = attrs.get("axis", 1)
    return {"Out": [x.reshape(int(np.prod(tuple(x.shape[:ax]))) or 1, -1)]}


@register("squeeze")
def _squeeze_v1(ctx, ins, attrs):
    x = ins["X"][0]
    return {"Out": [x.reshape(squeezed_shape(x, attrs.get("axes", [])))]}


@register("unsqueeze")
def _unsqueeze_v1(ctx, ins, attrs):
    out = ins["X"][0]
    for a in sorted(int(a) for a in attrs["axes"]):
        out = out.unsqueeze(a % (out.dim() + 1))
    return {"Out": [out]}
