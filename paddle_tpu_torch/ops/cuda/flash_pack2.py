"""Packed-heads flash-attention forward: the counterpart of
``tools/flash_pack2_bench.py`` (the TPU's measurement probe that packs
two d=64 heads into one 128-lane tile).

Hand-written CUDA kernels (``paddle_tpu_torch/csrc/flash_pack2.cu``,
built on first use by :mod:`._build`) replace ``_packed_fwd_kernel``:
:func:`packed_flash_fwd` takes head-pair slabs ``[b*h/2, s, 2d]``
(:func:`pack_pairs`) and returns each half's own attention in the same
layout, with no lse. It has two routes, decided by :func:`_tc_route`
before the launch: bf16 with 64-wide heads (the probe's shape) runs the
tensor-core (``wgmma``) kernel, everything else the CUDA-core
(``simt``) one; ``launches_by_route`` counts each. The wrapper launches
a kernel for CUDA tensors and runs :func:`packed_flash_fwd_plain` only
for tensors on the CPU; a CUDA input the kernels do not take raises,
and nothing falls back. It is forward only and on no model path, as its
reference is.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .flash_attention import flash_fwd_plain

#: kernel launches (CPU calls excluded)
launches = {"packed_flash_fwd": 0}
#: the same launches by route: "wgmma" (tensor cores) or "simt" (CUDA
#: cores)
launches_by_route = {"packed_flash_fwd": {"wgmma": 0, "simt": 0}}

_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_D = 64   # per head


def _tc_route(dtype, d):
    """Whether a call takes the tensor-core kernel: bf16 with 64-wide
    heads, so that a slab row is two 64-column panels. The CUDA side
    decides by the same rule (``flash_pack2_tc_route`` in the
    library)."""
    return dtype == torch.bfloat16 and d == 64


def pack_pairs(x):
    """``[b, h, s, d]`` -> ``[b*h/2, s, 2d]``: adjacent heads side by side
    (``tools/flash_pack2_bench.py:128-132``)."""
    b, h, s, d = x.shape
    return x.reshape(b, h // 2, 2, s, d).transpose(2, 3).reshape(
        b * h // 2, s, 2 * d)


def unpack_pairs(x):
    """``[b*h/2, s, 2d]`` -> ``[b*h, s, d]``, the inverse of
    :func:`pack_pairs` with batch and heads collapsed (the tool's
    ``o_pk_un``)."""
    bh2, s, d2 = x.shape
    return x.reshape(bh2, s, 2, d2 // 2).transpose(1, 2).reshape(
        2 * bh2, s, d2 // 2)


def packed_flash_fwd_plain(q, k, v, causal, scale):
    """What the kernel computes: each head of each pair attends with its
    own softmax, ``softmax(scale q_h k_h^T) v_h`` (causal: key <= query),
    in q's dtype and pair layout."""
    o, _ = flash_fwd_plain(unpack_pairs(q), unpack_pairs(k),
                           unpack_pairs(v), causal, scale)
    return pack_pairs(o[None])


def _lib():
    lib = _build.load("flash_pack2")
    if lib.flash_pack2_fwd_launch.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.flash_pack2_fwd_launch.argtypes = [ptr] * 4 + [i32] * 4 + [
            ctypes.c_float, i32, i32, ptr]
        lib.flash_pack2_fwd_launch.restype = ctypes.c_int
        lib.flash_pack2_error_string.argtypes = [ctypes.c_int]
        lib.flash_pack2_error_string.restype = ctypes.c_char_p
        lib.flash_pack2_tc_route.argtypes = [i32, i32]
        lib.flash_pack2_tc_route.restype = ctypes.c_int
    return lib


def _check(q, k, v, causal):
    """The kernel's contract, checked before any pointer is passed."""
    if q.dim() != 3 or k.dim() != 3 or tuple(v.shape) != tuple(k.shape) \
            or q.shape[0] != k.shape[0] or q.shape[2] != k.shape[2] \
            or q.shape[2] % 2:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)} are not [bh/2, s, 2d] head-pair "
                         "slabs of one geometry")
    if not 1 <= q.shape[2] // 2 <= MAX_D:
        raise ValueError(f"head_dim {q.shape[2] // 2} outside the kernel's "
                         f"1..{MAX_D}")
    if causal and q.shape[1] != k.shape[1]:
        raise ValueError("causal packed attention requires seq_q == seq_k")
    if q.dtype not in _CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"dtypes {q.dtype}/{k.dtype}/{v.dtype}: the kernel "
                        "takes float32 or bfloat16, all alike")
    for t in (q, k, v):
        if t.device != q.device:
            raise ValueError(f"all inputs must be on {q.device}, found "
                             f"{t.device}")
        if not t.is_contiguous():
            raise ValueError("the kernel takes contiguous tensors only")


def packed_flash_fwd(q, k, v, causal, scale):
    """Forward kernel on head-pair slabs ``[bh/2, s, 2d]``: the output
    in the same layout and dtype."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"packed_flash_fwd runs on cuda or cpu tensors, "
                         f"not {q.device}")
    if q.device.type == "cpu":
        return packed_flash_fwd_plain(q, k, v, causal, scale)
    _check(q, k, v, causal)
    bh2, s_q, d2 = q.shape
    o = torch.empty_like(q)
    with torch.cuda.device(q.device):
        rc = _lib().flash_pack2_fwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), bh2, s_q,
            k.shape[1], d2 // 2, float(scale), int(causal), _CODES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        msg = _lib().flash_pack2_error_string(rc).decode()
        raise RuntimeError(f"packed_flash_fwd launch failed: {msg} ({rc})")
    launches["packed_flash_fwd"] += 1
    route = "wgmma" if _tc_route(q.dtype, d2 // 2) else "simt"
    launches_by_route["packed_flash_fwd"][route] += 1
    return o
