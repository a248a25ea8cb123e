"""Paged attention over the block-paged KV pool: the counterpart of
``paddle_tpu/ops/pallas/paged_attention.py``.

:func:`paged_attention` launches the hand-written CUDA kernel
(``paddle_tpu_torch/csrc/paged_attention.cu``, built on first use by
:mod:`._build`) for CUDA tensors, and runs :func:`paged_attention_plain`
only for tensors on the CPU. A CUDA tensor the kernel does not take
raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from ..attention_ops import paged_attention_reference

#: kernel launches made by :func:`paged_attention` (CPU calls excluded)
launches = 0

_Q_CODES = {torch.float32: 0, torch.bfloat16: 1}
_KV_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_MAX_D = 256
_ROWS = 8                  # warps per block (kRows in the source)
_MAX_SMEM = 48 * 1024      # shared memory a launch may take by default


def paged_attention_plain(q, k_pool, v_pool, tables, pos, *,
                          k_scale=None, v_scale=None, scale=None):
    """The kernel's function in plain PyTorch: f32 math over the
    gathered (upcast or dequantized) blocks, output in q's dtype."""
    quant = k_scale is not None
    out = paged_attention_reference(
        q.float(), k_pool if quant else k_pool.float(),
        v_pool if quant else v_pool.float(), tables, pos,
        k_scale=k_scale, v_scale=v_scale, scale=scale)
    return out.to(q.dtype)


def _lib():
    lib = _build.load("paged_attention")
    fn = lib.paged_attention_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 +
                       [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                        ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.paged_attention_error_string.argtypes = [ctypes.c_int]
        lib.paged_attention_error_string.restype = ctypes.c_char_p
    return lib


def _check(q, k_pool, v_pool, tables, pos, k_scale, v_scale):
    b, h, s, d = q.shape
    nb, hp, bs, dp = k_pool.shape
    if (hp, dp) != (h, d) or tuple(v_pool.shape) != tuple(k_pool.shape):
        raise ValueError(f"pool shape {tuple(k_pool.shape)}/"
                         f"{tuple(v_pool.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if tables.dim() != 2 or tables.shape[0] != b or \
            tuple(pos.shape) != (b,):
        raise ValueError(f"tables {tuple(tables.shape)} / pos "
                         f"{tuple(pos.shape)} do not match batch {b}")
    if q.dtype not in _Q_CODES:
        raise TypeError(f"q dtype {q.dtype} not supported by the kernel")
    if k_pool.dtype not in _KV_CODES or v_pool.dtype != k_pool.dtype:
        raise TypeError(f"pool dtypes {k_pool.dtype}/{v_pool.dtype} not "
                        "supported by the kernel")
    if (k_pool.dtype == torch.int8) != (k_scale is not None):
        raise TypeError("int8 pools need k_scale/v_scale, float pools "
                        "take none")
    if tables.dtype != torch.int32 or pos.dtype != torch.int32:
        raise TypeError("tables and pos must be int32")
    if not 1 <= d <= _MAX_D:
        raise ValueError(f"head_dim {d} outside the kernel's 1..{_MAX_D}")
    if (2 * bs * d + _ROWS * d + 2 * _ROWS) * 4 > _MAX_SMEM:
        raise ValueError(f"block_size {bs} x head_dim {d} exceeds the "
                         "kernel's shared-memory tile")
    tensors = [q, k_pool, v_pool, tables, pos]
    if k_scale is not None:
        if k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32 \
                or tuple(k_scale.shape) != (nb, h) \
                or tuple(v_scale.shape) != (nb, h):
            raise ValueError(f"scales must be float32 [{nb}, {h}]")
        tensors += [k_scale, v_scale]
    for t in tensors:
        if t.device != q.device:
            raise ValueError(f"all inputs must be on {q.device}, found "
                             f"{t.device}")
        if not t.is_contiguous():
            raise ValueError("the kernel takes contiguous tensors only")


def paged_attention(q, k_pool, v_pool, tables, pos, *,
                    k_scale=None, v_scale=None, scale=None):
    """Fused paged decode/verify/prefill attention over the block pool.

    Args:
      q: [batch, heads, q_len, head_dim] queries, f32 or bf16.
      k_pool / v_pool: [num_blocks, heads, block_size, head_dim] pools
        (f32/bf16, or int8 codes when scales are given).
      tables: [batch, T] int32 block tables (padding entries point at
        the trash block 0).
      pos: [batch] int32 committed lengths; query row i sits at
        absolute position ``pos[b] + i`` and sees keys ``<= pos[b]+i``.
      k_scale / v_scale: optional [num_blocks, heads] f32 absmax scales
        (both present selects the int8 path).
      scale: logit scale, default ``1/sqrt(head_dim)``.

    Returns [batch, heads, q_len, head_dim] in q's dtype, equal to
    :func:`~paddle_tpu_torch.ops.attention_ops.paged_attention_reference`
    up to the order of summation.
    """
    global launches
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale must be given together")
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pool, v_pool, tables, pos,
                                     k_scale=k_scale, v_scale=v_scale,
                                     scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention runs on cuda or cpu tensors, "
                         f"not {q.device}")
    _check(q, k_pool, v_pool, tables, pos, k_scale, v_scale)
    b, h, s, d = q.shape
    nb, _, bs, _ = k_pool.shape
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    out = torch.empty_like(q)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.paged_attention_launch(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            k_scale.data_ptr() if k_scale is not None else None,
            v_scale.data_ptr() if v_scale is not None else None,
            tables.data_ptr(), pos.data_ptr(), out.data_ptr(),
            b, h, s, d, nb, bs, tables.shape[1], float(scale),
            _Q_CODES[q.dtype], _KV_CODES[k_pool.dtype], stream)
    if rc != 0:
        msg = lib.paged_attention_error_string(rc).decode()
        raise RuntimeError(f"paged_attention launch failed: {msg} ({rc})")
    launches += 1
    return out
