"""Greedy non-maximum suppression over sorted candidates, every row at
once: the suppression loop of ``multiclass_nms``
(:mod:`~paddle_tpu_torch.ops.detection_ops`).

Not a TPU kernel's counterpart: the reference runs the loop as an XLA
``fori_loop`` over an M x M IoU matrix per class
(``paddle_tpu/ops/detection_ops.py:280-300``). :func:`nms_keep` launches
``nms_keep_kernel`` (``paddle_tpu_torch/csrc/nms.cu``, built on first use
by :mod:`._build`) for CUDA tensors: one block per row, the kept flags
in shared memory, one block-wide OR per candidate. Its plain version,
:func:`nms_keep_plain`, runs only for tensors on the CPU; a CUDA input
the kernel does not take raises, and nothing falls back. Both compute
each IoU operation by operation in the rows' dtype, so their decisions
are the same bit for bit.
"""

from __future__ import annotations

import ctypes
import sys

import torch

from . import _build, _launches

#: kernel launches (CPU calls excluded)
launches = {"nms_keep": 0}

_CODES = {torch.float32: 0, torch.float64: 1}
#: candidates per row the kernel takes: its kept flags fill shared memory
MAX_W = 227 * 1024


def iou_matrix(a, b, normalized=True):
    """a [..., N, 4], b [..., M, 4] (x1, y1, x2, y2) -> IoU [..., N, M],
    each operation rounded once in the boxes' dtype."""
    off = 0.0 if normalized else 1.0

    def area(z):
        return (torch.clamp_min(z[..., 2] - z[..., 0] + off, 0)
                * torch.clamp_min(z[..., 3] - z[..., 1] + off, 0))

    ix1 = torch.maximum(a[..., :, None, 0], b[..., None, :, 0])
    iy1 = torch.maximum(a[..., :, None, 1], b[..., None, :, 1])
    ix2 = torch.minimum(a[..., :, None, 2], b[..., None, :, 2])
    iy2 = torch.minimum(a[..., :, None, 3], b[..., None, :, 3])
    iw = torch.clamp_min(ix2 - ix1 + off, 0)
    ih = torch.clamp_min(iy2 - iy1 + off, 0)
    inter = iw * ih
    union = area(a)[..., :, None] + area(b)[..., None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def nms_keep_plain(boxes, scores, iou_thresh, normalized, chunk=32):
    """What the kernel computes: ``boxes [R, W, 4]`` and ``scores [R,
    W]`` sorted by score (best first, -inf where no candidate) -> keep
    ``[R, W]`` bool. A candidate is kept unless it overlaps a kept,
    higher-ranked one above ``iou_thresh``."""
    r, w = scores.shape
    over = torch.empty((r, w, w), dtype=torch.bool, device=scores.device)
    for i in range(0, r, chunk):
        b = boxes[i:i + chunk]
        over[i:i + chunk] = iou_matrix(b, b, normalized) > iou_thresh
    alive = scores > float("-inf")
    keep = torch.zeros((r, w), dtype=torch.bool, device=scores.device)
    for i in range(w):
        hit = (over[:, i, :i] & keep[:, :i]).any(dim=1)
        keep[:, i] = alive[:, i] & ~hit
    return keep


def _lib():
    lib = _build.load("nms")
    if lib.nms_keep_launch.argtypes is None:
        ptr, i32, f64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        lib.nms_keep_launch.argtypes = [ptr, ptr, ptr, i32, i32, f64, f64,
                                        i32, ptr]
        lib.nms_keep_launch.restype = ctypes.c_int
        lib.nms_error_string.argtypes = [ctypes.c_int]
        lib.nms_error_string.restype = ctypes.c_char_p
    return lib


def nms_keep(boxes, scores, iou_thresh, normalized):
    """Keep flags ``[R, W]`` of the greedy suppression of each row's
    sorted candidates (:func:`nms_keep_plain`'s contract)."""
    if boxes.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"nms_keep runs on cuda or cpu tensors, not "
                         f"{boxes.device}")
    if boxes.device.type in ("cpu", "meta"):   # meta: the plain shapes
        return nms_keep_plain(boxes, scores, iou_thresh, normalized)
    if boxes.dim() != 3 or boxes.shape[-1] != 4 or \
            tuple(scores.shape) != tuple(boxes.shape[:2]):
        raise ValueError(f"boxes {tuple(boxes.shape)} and scores "
                         f"{tuple(scores.shape)} are not [R, W, 4] and [R, W]")
    if boxes.dtype not in _CODES or scores.dtype != boxes.dtype:
        raise TypeError(f"boxes {boxes.dtype}, scores {scores.dtype}: the "
                        "kernel takes float32 or float64, one dtype")
    r, w = scores.shape
    if w > MAX_W:
        raise ValueError(f"{w} candidates per row: the kernel takes at most "
                         f"{MAX_W}")
    if scores.device != boxes.device:
        raise ValueError(f"all inputs must be on {boxes.device}")
    boxes, scores = boxes.contiguous(), scores.contiguous()
    keep = torch.empty((r, w), dtype=torch.bool, device=boxes.device)
    dev = boxes.device
    with torch.cuda.device(dev):
        rc = _lib().nms_keep_launch(
            boxes.data_ptr(), scores.data_ptr(), keep.data_ptr(), r, w,
            float(iou_thresh), 0.0 if normalized else 1.0,
            _CODES[boxes.dtype], torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"nms_keep launch failed: "
                           f"{_lib().nms_error_string(rc).decode()} ({rc})")
    _launches.count(sys.modules[__name__], "nms_keep")
    return keep
