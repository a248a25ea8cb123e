"""Multi-tensor AdamW (and Adam, the same kernel with ``coeff = 0``): one
launch updates a whole group of parameters in place. Not the port of a TPU kernel: the JAX package's update
(``paddle_tpu/ops/optimizer_ops.py:40-71``) is plain jnp that XLA fuses
inside the compiled train step, and this hand-written CUDA kernel
(``paddle_tpu_torch/csrc/adamw.cu``, built on first use by
:mod:`._build`) is the port's counterpart of that fusion.

:func:`adamw_multi` launches the kernel for CUDA tensors and runs
:func:`adamw_multi_plain` (the per-parameter loop over
:func:`~paddle_tpu_torch.ops.optimizer_ops.adamw`) only for tensors on
the CPU; a CUDA group the kernel does not take raises, and nothing falls
back. On the card the kernel is bit-equal to the plain loop.

A group shares (parameter dtype, moment dtype, device); parameters
(with their gradients and ``[1]`` beta powers) and moments are each
float32, bfloat16 or float16, and every operation rounds as the per-op
path's promotion rounds it. :class:`Table` holds the group's static
pointers on the device, each entry's learning rate among them (a
``[1]`` view into the optimizer's lr tensor, one slot per distinct
``lr_scale``); it is built once per parameter set, outside any CUDA
graph capture, and kept. The gradients' pointers travel as kernel
arguments, so a captured graph bakes them as it bakes every argument.
An optional ``grad_scale`` (a float32 ``[1]`` tensor on the card:
``GradientClipByGlobalNorm``'s factor) multiplies every gradient as the
kernel reads it, so the clip costs no pass of its own over the
gradients.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ...device import capturing
from ..optimizer_ops import adam, adamw
from . import _build

#: kernel launches (CPU calls excluded)
launches = {"adamw": 0}

#: elements per block and gradient pointers per launch (``kChunk`` and
#: ``kMaxTensors`` in csrc/adamw.cu)
CHUNK = 16384
MAX_TENSORS = 448

#: dtype codes of the C entry's ``pdtype`` and ``mdtype``
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

ARGTYPES = ([ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
            + [ctypes.c_float] * 8 + [ctypes.c_int] * 2 + [ctypes.c_void_p])


def _per_entry(lr, n):
    """``lr`` (one float or ``[1]`` tensor for the whole group, or a
    sequence of them, one per tensor) as a list of ``n``."""
    if isinstance(lr, (list, tuple)):
        if len(lr) != n:
            raise ValueError(f"{len(lr)} learning rates for {n} tensors")
        return list(lr)
    return [lr] * n


def scaled_grad(g, grad_scale):
    """The reference's clipped gradient ``g * scale``
    (``paddle_tpu/optimizer.py:99-101``): ``grad_scale`` a 0-dim or
    ``[1]`` tensor, the product in the promotion of the two dtypes, as
    jnp promotes it; the update then takes it to the parameter's
    dtype."""
    if grad_scale is None:
        return g
    dt = torch.promote_types(g.dtype, grad_scale.dtype)
    return g.to(dt) * grad_scale.reshape(()).to(dt)


def adamw_multi_plain(params, grads, m1s, m2s, b1ps, b2ps, lr, beta1=0.9,
                      beta2=0.999, epsilon=1e-8, coeff=0.01,
                      grad_scale=None):
    """What the kernel computes: :func:`adamw` on each parameter in turn
    (:func:`adam` at ``coeff = 0``, which has no decay term),
    written into ``params``, ``m1s``, ``m2s``, ``b1ps`` and ``b2ps`` in
    place (moments rounded to their own dtype), each gradient first
    :func:`scaled_grad` by ``grad_scale`` where one is given. ``lr`` is a
    float or a ``[1]`` tensor for the whole group, or one per
    parameter."""
    lrs = [float(v) for v in _per_entry(lr, len(params))]
    with torch.no_grad():
        for p, g, m1, m2, b1p, b2p, lr_i in zip(params, grads, m1s, m2s,
                                                b1ps, b2ps, lrs):
            g = scaled_grad(g, grad_scale).to(p.dtype)
            if coeff:
                new = adamw(p, g, m1, m2, b1p, b2p, lr_i, beta1, beta2,
                            epsilon, coeff)
            else:
                new = adam(p, g, m1, m2, b1p, b2p, lr_i, beta1, beta2,
                           epsilon)
            for t, v in zip((p, m1, m2, b1p, b2p), new):
                t.copy_(v)


def chunk_plan(sizes):
    """``(first, chunks, total)``: each tensor's first chunk in the group,
    its chunk count (at least 1, so an empty tensor still advances its
    beta powers) and the group's total; block ``c`` of the kernel walks
    elements ``(c - first[t]) * CHUNK ..`` of the last tensor ``t`` with
    ``first[t] <= c``."""
    chunks = [max(1, -(-int(n) // CHUNK)) for n in sizes]
    first = np.concatenate([[0], np.cumsum(chunks)[:-1]]).astype(np.int64)
    return first, chunks, int(sum(chunks))


def launch_ranges(chunks, max_tensors=MAX_TENSORS):
    """``[(t0, nt, c0, nchunks)]``: the launches of a group, each over at
    most ``max_tensors`` consecutive tensors (one launch for every model
    of the repository)."""
    out, c0 = [], 0
    for t0 in range(0, len(chunks), max_tensors):
        n = sum(chunks[t0:t0 + max_tensors])
        out.append((t0, min(max_tensors, len(chunks) - t0), c0, n))
        c0 += n
    return out


class Table:
    """The device table of one group: per tensor the pointers of p, m1,
    m2, b1p, b2p and its learning rate (``lrs``: float32 ``[1]`` tensors
    or views, one per tensor, or one for all), its size, first chunk and
    chunk count, and the arrival count the kernel resets itself
    (``Entry`` in csrc/adamw.cu). Built outside any capture; a graph
    captured later reads it, and the learning rates, where they lie."""

    def __init__(self, params, m1s, m2s, b1ps, b2ps, lrs):
        if capturing():
            raise RuntimeError(
                "the AdamW kernel's table is built outside a CUDA graph "
                "capture: run one step eagerly first")
        dev = params[0].device
        sizes = [p.numel() for p in params]
        first, chunks, _ = chunk_plan(sizes)
        lrs = _per_entry(lrs, len(params))
        for lr in lrs:
            if not isinstance(lr, torch.Tensor) or lr.dtype != torch.float32 \
                    or lr.numel() != 1 or lr.device != dev:
                raise ValueError("each learning rate must be a float32 [1] "
                                 "tensor on the parameters' device")
        words = np.zeros((len(params), 9), np.int64)
        for i, ts in enumerate(zip(params, m1s, m2s, b1ps, b2ps, lrs)):
            words[i, :6] = [t.data_ptr() for t in ts]
        words[:, 6] = sizes
        words[:, 7] = first
        words[:, 8] = np.asarray(chunks, np.int64) << 32   # arrive = 0
        self.device = dev
        self.lrs = lrs            # keeps the views (and their storage) alive
        self.chunks = chunks
        # None for a dtype the kernel does not take: the launch refuses it
        self.param_code = DTYPE_CODES.get(params[0].dtype)
        self.moment_code = DTYPE_CODES.get(m1s[0].dtype)
        self.tensor = torch.from_numpy(words).to(dev)


def _lib():
    lib = _build.load("adamw")
    if lib.adamw_multi_launch.argtypes is None:
        lib.adamw_multi_launch.argtypes = ARGTYPES
        lib.adamw_multi_launch.restype = ctypes.c_int
        lib.adamw_error_string.argtypes = [ctypes.c_int]
        lib.adamw_error_string.restype = ctypes.c_char_p
        for name, want in (("adamw_chunk", CHUNK),
                           ("adamw_max_tensors", MAX_TENSORS)):
            if getattr(lib, name)() != want:
                raise RuntimeError(f"{name}() of the built library is not "
                                   f"{want}: csrc/adamw.cu and this module "
                                   "disagree")
    return lib


def scalars(beta1, beta2, epsilon, coeff, moment_dtype):
    """The kernel's eight float arguments, rounded as the per-op path
    rounds them: beta1/beta2 in the moments' dtype for ``beta * m``
    (``_as`` in ops/optimizer_ops.py), in float32 for the beta powers,
    ``1 - beta`` computed in double then taken to float32, as a Python
    scalar meets a float32 tensor."""
    def as_moment(v):
        return float(torch.tensor(v, dtype=moment_dtype))
    return (as_moment(beta1), as_moment(beta2), float(np.float32(beta1)),
            float(np.float32(beta2)), float(np.float32(1 - beta1)),
            float(np.float32(1 - beta2)), float(np.float32(epsilon)),
            float(np.float32(coeff)))


def _check(params, grads, m1s, m2s, b1ps, b2ps, grad_scale, table):
    dev = params[0].device
    pdt, mdt = params[0].dtype, m1s[0].dtype
    for what, dt in (("parameters", pdt), ("moments", mdt)):
        if dt not in DTYPE_CODES:
            raise TypeError(f"{what} {dt}: the kernel takes float32, "
                            "bfloat16 or float16")
    if grad_scale is not None and (
            grad_scale.dtype != torch.float32 or grad_scale.numel() != 1
            or grad_scale.device != dev):
        raise ValueError("grad_scale must be a float32 [1] tensor on the "
                         "parameters' device")
    if (table.device != dev or len(table.chunks) != len(params)
            or table.param_code != DTYPE_CODES[pdt]
            or table.moment_code != DTYPE_CODES[mdt]):
        raise ValueError("the table was built for another group")
    for p, g, m1, m2, b1p, b2p in zip(params, grads, m1s, m2s, b1ps, b2ps):
        if p.dtype != pdt or g.dtype != pdt:
            raise TypeError(f"parameter {p.dtype}, gradient {g.dtype}: a "
                            f"group's parameters and gradients are {pdt}")
        if m1.dtype != mdt or m2.dtype != mdt:
            raise TypeError("every moment of a group shares one dtype")
        for t in (b1p, b2p):
            if t.dtype != pdt or t.numel() != 1:
                raise ValueError(f"beta powers must be [1] tensors in the "
                                 f"parameters' dtype {pdt}")
        for t in (p, g, m1, m2):
            if t.shape != p.shape:
                raise ValueError(f"shapes {tuple(p.shape)} / "
                                 f"{tuple(t.shape)} differ within a "
                                 "parameter's state")
        for t in (p, g, m1, m2, b1p, b2p):
            if t.device != dev:
                raise ValueError(f"all tensors must be on {dev}, found "
                                 f"{t.device}")
            if not t.is_contiguous():
                raise ValueError("the kernel takes contiguous tensors only")


def launch_args(table, grads, grad_scale, scal, stream, t0, nt, c0,
                nchunks):
    """The arguments of ``adamw_multi_launch`` (``ARGTYPES``) for the
    launch over tensors ``t0 .. t0 + nt - 1``; the gradient pointers go
    in a host array the C entry copies into the kernel's arguments, and
    a missing ``grad_scale`` is a null pointer."""
    ptrs = (ctypes.c_void_p * nt)(*[g.data_ptr()
                                    for g in grads[t0:t0 + nt]])
    return (table.tensor.data_ptr(), t0, nt, c0, nchunks, ptrs,
            None if grad_scale is None else grad_scale.data_ptr(), *scal,
            table.param_code, table.moment_code, stream)


def adamw_multi(params, grads, m1s, m2s, b1ps, b2ps, lr, beta1=0.9,
                beta2=0.999, epsilon=1e-8, coeff=0.01, grad_scale=None,
                table=None):
    """One AdamW step of a group, in place (Adam at ``coeff = 0``). CUDA
    tensors launch the kernel (one launch per :data:`MAX_TENSORS`
    tensors) with ``table`` (a :class:`Table` of the same group and
    learning rates, built here from ``lr`` when ``None``: float32 ``[1]``
    tensors on the card, one for the group or one per tensor) and
    ``grad_scale`` None or a float32 ``[1]`` tensor on the card; CPU
    tensors run :func:`adamw_multi_plain`."""
    if not params:
        return
    dev = params[0].device
    if dev.type == "cpu":
        adamw_multi_plain(params, grads, m1s, m2s, b1ps, b2ps, lr, beta1,
                          beta2, epsilon, coeff, grad_scale)
        return
    if dev.type != "cuda":
        raise ValueError(f"adamw_multi runs on cuda or cpu tensors, not "
                         f"{dev}")
    if table is None:
        table = Table(params, m1s, m2s, b1ps, b2ps, lr)
    _check(params, grads, m1s, m2s, b1ps, b2ps, grad_scale, table)
    scal = scalars(beta1, beta2, epsilon, coeff, m1s[0].dtype)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for t0, nt, c0, n in launch_ranges(table.chunks):
            rc = lib.adamw_multi_launch(*launch_args(
                table, grads, grad_scale, scal, stream, t0, nt, c0, n))
            if rc != 0:
                msg = lib.adamw_error_string(rc).decode()
                raise RuntimeError(f"adamw launch failed: {msg} ({rc})")
            launches["adamw"] += 1
