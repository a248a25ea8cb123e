"""Real int8 storage helpers for the paged KV cache — the counterpart of
the int8 section of ``paddle_tpu/ops/quant_ops.py``.

The single source of the quantize/dequantize math, so the write path
(:func:`~.attention_ops.block_scatter_write_quant`), the composed
reference read and the CUDA kernel cannot drift apart. The operation
order is the JAX package's, which keeps the codes and scales bit-equal
to it: ``round(x / max(s, 1e-9) * 127)`` clipped to [-127, 127], and
``codes * (scale / 127)``. ``torch.round`` and ``jnp.round`` both round
half to even.
"""

from __future__ import annotations

import torch

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
