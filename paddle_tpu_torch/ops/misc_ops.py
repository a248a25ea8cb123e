"""Miscellaneous op lowerings — the counterpart of
``paddle_tpu/ops/misc_ops.py`` for the ops the sequence and loss
and the dense veneers emit: ``fill_constant_batch_size_like``,
``uniform_random_batch_size_like`` and
``gaussian_random_batch_size_like`` (the reference's streams, as
``uniform_random`` / ``gaussian_random`` draw them),
``teacher_student_sigmoid_loss``, ``edit_distance``, ``ctc_align`` and
``shard_index``. The rest of the file waits for ROADMAP A7.2b2.

``edit_distance`` and ``ctc_align`` keep the reference's static shapes:
the Levenshtein table is a loop over both lengths' bounds with every row
of the batch at once, and the alignment is written to the front of a
``[B, T]`` buffer with its lengths beside it, so a captured step holds
both.
"""

from __future__ import annotations

import torch

from .. import prng
from .math_ops import absolute
from .registry import np_dtype, register


@register("fill_constant_batch_size_like", not_differentiable=True)
def _fill_constant_bsl(ctx, ins, attrs):
    ref = ins["Input"][0]
    shape = [int(s) for s in attrs["shape"]]
    shape[int(attrs.get("output_dim_idx", 0))] = \
        ref.shape[int(attrs.get("input_dim_idx", 0))]
    dt = attrs.get("dtype", "float32")
    dt = dt if isinstance(dt, str) else "float32"
    return {"Out": [torch.full(shape, attrs.get("value", 0.0),
                               dtype=np_dtype(dt), device=ref.device)]}


def _bsl_shape(ins, attrs):
    shape = [int(s) for s in attrs["shape"]]
    shape[int(attrs.get("output_dim_idx", 0))] = \
        ins["Input"][0].shape[int(attrs.get("input_dim_idx", 0))]
    return shape


@register("uniform_random_batch_size_like", not_differentiable=True)
def _uniform_random_bsl(ctx, ins, attrs):
    return {"Out": [prng.uniform_const(ctx.rng(), _bsl_shape(ins, attrs),
                                       attrs.get("min", -1.0),
                                       attrs.get("max", 1.0))]}


@register("gaussian_random_batch_size_like", not_differentiable=True)
def _gaussian_random_bsl(ctx, ins, attrs):
    out = prng.normal(ctx.rng(), _bsl_shape(ins, attrs))
    return {"Out": [out * attrs.get("std", 1.0) + attrs.get("mean", 0.0)]}


@register("teacher_student_sigmoid_loss", no_grad_slots=("Label",))
def _teacher_student_sigmoid_loss(ctx, ins, attrs):
    """reference teacher_student_sigmoid_loss_op.h:20-58: the CTR
    distillation loss over the label code {-2, -1, [0, 1), [1, 2]}."""
    x = ins["X"][0].reshape(-1)
    lab = ins["Label"][0].reshape(-1).to(x.dtype)

    def sce(z):
        return torch.relu(x) - x * z + torch.log1p(torch.exp(-absolute(x)))

    out = torch.where(
        lab < -1.0, sce(0.0),
        torch.where(lab < 0.0, sce(1.0),
                    torch.where(lab < 1.0, sce(0.0) + sce(lab),
                                sce(1.0) + sce(lab - 1.0))))
    return {"Y": [out.reshape(ins["X"][0].shape)]}


@register("edit_distance", not_differentiable=True)
def _edit_distance(ctx, ins, attrs):
    """reference edit_distance_op.cc, dense: the Levenshtein distance of
    each (hyp, ref) pair. Hyps (B, L1) + HypsLength, Refs (B, L2) +
    RefsLength; Out (B, 1) float32, SequenceNum [B]."""
    hyp = ins["Hyps"][0].to(torch.int64)
    ref = ins["Refs"][0].to(torch.int64)
    b, l1 = hyp.shape
    l2 = ref.shape[1]
    dev = hyp.device
    hl = ins.get("HypsLength", [None])[0]
    rl = ins.get("RefsLength", [None])[0]
    hl = (torch.full((b,), l1, dtype=torch.int64, device=dev) if hl is None
          else hl.reshape(-1).long())
    rl = (torch.full((b,), l2, dtype=torch.int64, device=dev) if rl is None
          else rl.reshape(-1).long())
    big = torch.full((b,), 10 ** 6, dtype=torch.int64, device=dev)
    cols = torch.arange(l2 + 1, device=dev)[None, :]
    prev = torch.where(cols <= rl[:, None], cols.expand(b, l2 + 1),
                       big[:, None])
    for i in range(l1):
        first = torch.full((b,), i + 1, dtype=torch.int64, device=dev)
        row, left = [first], first
        for j in range(l2):
            cost = (hyp[:, i] != ref[:, j]).to(torch.int64)
            val = torch.minimum(torch.minimum(prev[:, j + 1] + 1, left + 1),
                                prev[:, j] + cost)
            left = torch.where(j < rl, val, big)
            row.append(left)
        prev = torch.where((i < hl)[:, None], torch.stack(row, dim=1), prev)
    d = torch.gather(prev, 1, rl[:, None])[:, 0].to(torch.float32)
    if bool(attrs.get("normalized", False)):
        d = d / torch.clamp_min(rl.to(d.dtype), 1.0)
    return {"Out": [d[:, None]],
            "SequenceNum": [torch.full((1,), b, dtype=torch.int64,
                                       device=dev)]}


@register("ctc_align", not_differentiable=True)
def _ctc_align(ctx, ins, attrs):
    """reference ctc_align_op.cc, dense: merge repeats, then drop blanks;
    Output (B, T) padded with ``blank``, OutputLength (B, 1)."""
    x = ins["Input"][0].to(torch.int64)
    blank = int(attrs.get("blank", 0))
    b, t = x.shape
    prev = torch.cat([torch.full_like(x[:, :1], -1), x[:, :-1]], dim=1)
    keep = x != blank
    if bool(attrs.get("merge_repeated", True)):
        keep = keep & (x != prev)
    pos = torch.cumsum(keep.to(torch.int64), dim=1) - 1
    safe_pos = torch.where(keep, pos, torch.full_like(pos, t - 1))
    out = torch.full((b, t), blank, dtype=torch.int64, device=x.device)
    # kept tokens land at the front in order; the dropped ones write the
    # blank already there into the last slot, which a kept token takes
    # only when nothing was dropped
    out = out.scatter(1, safe_pos, torch.where(keep, x, out))
    lens = keep.sum(dim=1)
    cols = torch.arange(t, device=x.device)[None, :]
    out = torch.where(cols < lens[:, None], out,
                      torch.full_like(out, blank))
    return {"Output": [out], "OutputLength": [lens.to(torch.int64)[:, None]]}


@register("shard_index", not_differentiable=True)
def _shard_index(ctx, ins, attrs):
    x = ins["X"][0]
    nshards = int(attrs["nshards"])
    size = (int(attrs["index_num"]) + nshards - 1) // nshards
    mine = torch.div(x, size, rounding_mode="floor") == int(attrs["shard_id"])
    ignore = torch.full_like(x, int(attrs.get("ignore_value", -1)))
    return {"Out": [torch.where(mine, torch.remainder(x, size), ignore)]}
