"""Fake-quantization op lowerings for QAT / PTQ, and the real int8
storage helpers of the paged KV cache — the counterpart of
``paddle_tpu/ops/quant_ops.py``.

The 13 lowerings (``:43-277``): quantize-dequantize in one op (float in,
float out, rounded to the int grid) per tensor, per channel and with a
moving-average scale (``fake_quantize_dequantize_*``), the observer
``moving_average_abs_max_scale``, the quantize-only twins
(``fake_quantize_*``, the levels kept in float), the dequantizers and
``dequantize_log``. Their backward is the straight-through estimator:
``_ste_grad_maker`` emits ``ste_identity_grad`` (dX = dOut), as the
reference's grad maker does. Moving-average scale state follows the
batch_norm convention: OutScale / OutState / OutAccum alias the
persistable inputs and the executor writes them back each step.

The int8 helpers are the single source of the quantize / dequantize math,
so the KV write path (:func:`~.attention_ops.block_scatter_write_quant`),
the composed reference read and the CUDA kernel cannot drift apart. The
operation order is the JAX package's, which keeps the codes and scales
bit-equal to it: ``round(x / max(s, 1e-9) * 127)`` clipped to [-127,
127], and ``codes * (scale / 127)``. ``torch.round`` and ``jnp.round``
both round half to even.
"""

from __future__ import annotations

import torch

from .registry import register


def _qdq(x, scale, qmax):
    """round(clip(x / scale)) on the int grid, back to float."""
    scale = torch.clamp_min(scale, 1e-8)
    y = torch.clamp(x / scale, -1.0, 1.0)
    return torch.round(y * qmax) / qmax * scale


def _qmax(attrs, key="bit_length"):
    return float(2 ** (int(attrs.get(key, 8)) - 1) - 1)


def _ste_grad_maker(op, out_grad_names, wanted_input_grads):
    """Straight-through estimator: dX = dOut; the scale inputs take no
    gradient."""
    g = next((x for x in out_grad_names.get("Out", []) if x is not None),
             None)
    gx = next((x for x in wanted_input_grads.get("X", []) if x is not None),
              None)
    if g is None or gx is None:
        return []
    return [("ste_identity_grad", {"Out@GRAD": [g]}, {"X@GRAD": [gx]}, {})]


@register("ste_identity_grad", not_differentiable=True)
def _ste_identity_grad(ctx, ins, attrs):
    return {"X@GRAD": [ins["Out@GRAD"][0]]}


def _absmax(x):
    return torch.amax(torch.abs(x))


def _channel_absmax(x, axis):
    dims = tuple(i for i in range(x.ndim) if i != axis)
    return torch.amax(torch.abs(x), dim=dims, keepdim=True)


@register("fake_quantize_dequantize_abs_max",
          custom_grad_maker=_ste_grad_maker)
def _fake_qdq_abs_max(ctx, ins, attrs):
    x = ins["X"][0]
    scale = _absmax(x)
    return {"Out": [_qdq(x, scale, _qmax(attrs))], "OutScale": [scale]}


@register("fake_channel_wise_quantize_dequantize_abs_max",
          custom_grad_maker=_ste_grad_maker)
def _fake_qdq_channel_abs_max(ctx, ins, attrs):
    """Per-channel quant-dequant; ``quant_axis`` 0 for conv filters, 1
    for mul weights."""
    x = ins["X"][0]
    scale = _channel_absmax(x, int(attrs.get("quant_axis", 0)))
    return {"Out": [_qdq(x, scale, _qmax(attrs))],
            "OutScale": [scale.reshape(-1)]}


def _moving_scale(ins, attrs, x, outs):
    """state = rate * state + 1, accum = rate * accum + absmax(x),
    scale = accum / state; under ``is_test`` the frozen InScale."""
    in_scale = ins["InScale"][0].reshape(())
    if attrs.get("is_test"):
        outs["OutScale"] = [in_scale]
        return in_scale
    rate = float(attrs.get("moving_rate", 0.9))
    state = ins.get("InState", [torch.ones((), dtype=x.dtype,
                                           device=x.device)])[0].reshape(())
    accum = ins.get("InAccum", [in_scale])[0].reshape(())
    new_state = rate * state + 1.0
    new_accum = rate * accum + _absmax(x)
    scale = new_accum / new_state
    outs["OutScale"] = [scale]
    outs["OutState"] = [new_state]
    outs["OutAccum"] = [new_accum]
    return scale


@register("fake_quantize_dequantize_moving_average_abs_max",
          no_grad_slots=("InScale", "InAccum", "InState"),
          custom_grad_maker=_ste_grad_maker)
def _fake_qdq_moving_avg(ctx, ins, attrs):
    x = ins["X"][0]
    outs = {}
    scale = _moving_scale(ins, attrs, x, outs)
    outs["Out"] = [_qdq(x, scale, _qmax(attrs))]
    return outs


@register("moving_average_abs_max_scale",
          no_grad_slots=("InAccum", "InState"),
          custom_grad_maker=_ste_grad_maker)
def _moving_avg_scale_observer(ctx, ins, attrs):
    """The scale observer: Out is X unchanged."""
    x = ins["X"][0]
    outs = {"Out": [x]}
    if not attrs.get("is_test"):
        rate = float(attrs.get("moving_rate", 0.9))
        kw = dict(dtype=x.dtype, device=x.device)
        state = ins.get("InState", [torch.ones((), **kw)])[0].reshape(())
        accum = ins.get("InAccum", [torch.zeros((), **kw)])[0].reshape(())
        new_state = rate * state + 1.0
        new_accum = rate * accum + _absmax(x)
        outs["OutScale"] = [new_accum / new_state]
        outs["OutState"] = [new_state]
        outs["OutAccum"] = [new_accum]
    return outs


@register("fake_quantize_abs_max", custom_grad_maker=_ste_grad_maker)
def _fake_q_abs_max(ctx, ins, attrs):
    """The quantized levels (kept in float) and the scale."""
    x = ins["X"][0]
    scale = _absmax(x)
    return {"Out": [_q(x, scale, _qmax(attrs))], "OutScale": [scale]}


@register("fake_channel_wise_quantize_abs_max",
          custom_grad_maker=_ste_grad_maker)
def _fake_q_channel_abs_max(ctx, ins, attrs):
    x = ins["X"][0]
    scale = _channel_absmax(x, int(attrs.get("quant_axis", 0)))
    return {"Out": [_q(x, scale, _qmax(attrs))],
            "OutScale": [scale.reshape(-1)]}


@register("fake_quantize_range_abs_max",
          no_grad_slots=("InScale", "Iter", "InScales"),
          custom_grad_maker=_ste_grad_maker)
def _fake_q_range_abs_max(ctx, ins, attrs):
    """scale = the max over a ``window_size`` ring of per-step abs-maxes
    (InScales and Iter thread the ring); without them the running max."""
    x = ins["X"][0]
    in_scale = ins["InScale"][0].reshape(())
    outs = {}
    if attrs.get("is_test"):
        scale = in_scale
    else:
        cur = _absmax(x)
        if "InScales" in ins and "Iter" in ins:
            ring = ins["InScales"][0]
            it = ins["Iter"][0].reshape(()).to(torch.int64)
            slot = torch.remainder(it, ring.shape[0])
            ring = torch.where(
                torch.arange(ring.shape[0], device=ring.device) == slot,
                cur.to(ring.dtype), ring)
            scale = torch.amax(ring)   # empty slots are 0 <= any abs-max
            outs["OutScales"] = [ring]
        else:
            scale = torch.maximum(cur, in_scale)
            outs["OutScales"] = [scale.reshape(1)]
    outs["OutScale"] = [scale]
    outs["Out"] = [_q(x, scale, _qmax(attrs))]
    return outs


@register("fake_quantize_moving_average_abs_max",
          no_grad_slots=("InScale", "InAccum", "InState"),
          custom_grad_maker=_ste_grad_maker)
def _fake_q_moving_avg(ctx, ins, attrs):
    x = ins["X"][0]
    outs = {}
    scale = _moving_scale(ins, attrs, x, outs)
    outs["Out"] = [_q(x, scale, _qmax(attrs))]
    return outs


@register("fake_dequantize_max_abs", no_grad_slots=("Scale",))
def _fake_dequantize_max_abs(ctx, ins, attrs):
    """x * scale / max_range."""
    x = ins["X"][0]
    scale = ins["Scale"][0].reshape(())
    max_range = float(attrs.get("max_range", 127.0))
    return {"Out": [x.to(scale.dtype) * scale / max_range]}


@register("fake_channel_wise_dequantize_max_abs", no_grad_slots=("Scales",))
def _fake_channel_wise_dequantize_max_abs(ctx, ins, attrs):
    """One or two scale tensors: the weight's per channel and an
    optional activation scale."""
    x = ins["X"][0]
    scales = ins["Scales"]
    axis = int(attrs.get("quant_axis", 0))
    bits = attrs.get("quant_bits", [8, 8])
    shape = [1] * x.ndim
    shape[axis] = -1
    qmax0 = float(2 ** (int(bits[0]) - 1) - 1)
    out = x.to(scales[0].dtype) * scales[0].reshape(shape) / qmax0
    if len(scales) > 1 and scales[1] is not None:
        qmax1 = float(2 ** (int(bits[1]) - 1) - 1)
        out = out * scales[1].reshape(()) / qmax1
    return {"Out": [out]}


@register("dequantize_abs_max", no_grad_slots=("Scale",))
def _dequantize_abs_max(ctx, ins, attrs):
    x = ins["X"][0]
    scale = ins["Scale"][0].reshape(())
    max_range = float(attrs.get("max_range", 127.0))
    return {"Out": [x.to(torch.float32) * scale / max_range]}


@register("dequantize_log", no_grad_slots=("Dict",))
def _dequantize_log(ctx, ins, attrs):
    """Codebook lookup: a negative code is the negative of
    dict[code + 128]."""
    x = ins["X"][0].to(torch.int64)
    table = ins["Dict"][0]
    neg = x < 0
    idx = torch.where(neg, x + 128, x)
    val = table[torch.clamp(idx, 0, table.shape[0] - 1)]
    return {"Out": [torch.where(neg, -val, val)]}


# ---------------------------------------------------------------------------
# Real int8 storage helpers (serving KV cache)
# ---------------------------------------------------------------------------
#: int8 symmetric grid: codes in [-127, 127] (the -128 slot is unused)
KV_QMAX = 127.0


def _q(x, scale, qmax):
    """Quantize only (no dequant): round(x / scale * qmax), clipped."""
    s = torch.clamp_min(scale, 1e-9)
    return torch.clamp(torch.round(x / s * qmax), -qmax, qmax)


def quantize_int8(x, scale):
    """float -> int8 codes on the symmetric absmax grid. ``scale``
    broadcasts against ``x``. Exactly idempotent through a
    dequantize/requantize round trip at an unchanged scale."""
    return _q(x, scale, KV_QMAX).to(torch.int8)


def dequantize_int8(codes, scale):
    """int8 codes -> float32: codes * (scale / KV_QMAX)."""
    return codes.to(torch.float32) * (scale / KV_QMAX)
