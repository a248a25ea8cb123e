"""Index op lowerings — the counterpart of ``paddle_tpu/ops/index_ops.py``
for the ops the sequence builders emit: ``row_conv`` (the lookahead
convolution) and the v1 ``squeeze``. The rest of the file (the gathers
and scatters, ``multiplex``, ``unfold``, ``shard_index``, the v1
``flatten`` / ``unsqueeze`` / ``expand``, ...) waits for ROADMAP
A7.2b.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .registry import register


@register("row_conv")
def _row_conv(ctx, ins, attrs):
    """reference row_conv_op.cc, dense: X (B, T, D), Filter (context, D);
    out[b, t] = sum_c x[b, t + c] * filter[c]."""
    x, f = ins["X"][0], ins["Filter"][0]
    ctx_len = f.shape[0]
    xp = F.pad(x, (0, 0, 0, ctx_len - 1))
    return {"Out": [sum(xp[:, c:c + x.shape[1]] * f[c]
                        for c in range(ctx_len))]}


@register("squeeze")
def _squeeze_v1(ctx, ins, attrs):
    x = ins["X"][0]
    axes = attrs.get("axes", [])
    if axes:
        axes = tuple(a % x.dim() for a in axes)
        shape = [d for i, d in enumerate(x.shape)
                 if not (i in axes and d == 1)]
    else:
        shape = [d for d in x.shape if d != 1]
    return {"Out": [x.reshape(shape)]}
