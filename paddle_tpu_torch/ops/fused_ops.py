"""Fused-op lowerings — the counterpart of ``paddle_tpu/ops/fused_ops.py``:
``fused_elemwise_activation`` (``:39``) and ``fused_scale_bias_relu``
(``:57``), the targets of the reference's program-level fusion passes.
They are compositions of torch operations; their gradients come from the
registry's generic grad.
"""

from __future__ import annotations

import torch

from .math_ops import _bcast_y
from .registry import register

#: the unary functors of a fused composition (the reference's subset of
#: fused_elemwise_activation_op.h); each takes the activation op's attrs
_UNARY = {
    "relu": lambda x, a: torch.relu(x),
    "sigmoid": lambda x, a: torch.sigmoid(x),
    "tanh": lambda x, a: torch.tanh(x),
    "gelu": lambda x, a: torch.nn.functional.gelu(
        x, approximate="tanh" if a.get("approximate", False) else "none"),
    "identity": lambda x, a: x,
}

_BINARY = {
    "elementwise_add": torch.add,
    "elementwise_sub": torch.sub,
    "elementwise_mul": torch.mul,
}


@register("fused_elemwise_activation")
def _fused_elemwise_activation(ctx, ins, attrs):
    """unary(binary(X, Y)); ``functor_list`` is [binary, unary]."""
    binary_name, unary_name = attrs["functor_list"]
    x, y = ins["X"][0], ins["Y"][0]
    inner = _BINARY[binary_name](x, _bcast_y(x, y, attrs.get("axis", -1)))
    outs = {"Out": [_UNARY[unary_name](inner, attrs.get("act_attrs", {}))]}
    if attrs.get("save_intermediate_out"):
        outs["IntermediateOut"] = [inner]
    return outs


@register("fused_scale_bias_relu")
def _fused_scale_bias_relu(ctx, ins, attrs):
    """relu(x * scale + bias): inference BatchNorm folded to a
    per-channel scale and bias, then the activation."""
    x = ins["X"][0]
    scale, bias = ins["Scale"][0], ins["Bias"][0]
    if attrs.get("data_layout", "NCHW") == "NCHW" and x.dim() == 4:
        scale = scale.reshape(1, -1, 1, 1)
        bias = bias.reshape(1, -1, 1, 1)
    return {"Out": [torch.relu(x * scale + bias)]}
