"""Fused LayerNorm, forward and backward: the counterpart of
``paddle_tpu/ops/pallas/layer_norm.py``.

Two hand-written CUDA kernels (``paddle_tpu_torch/csrc/layer_norm.cu``,
built on first use by :mod:`._build`) replace the two TPU kernels:
:func:`ln_fwd` (y, mean, rstd) and :func:`ln_bwd` (dx, dgamma, dbeta; a
row pass and a deterministic reduce of per-block column sums, counted as
one launch). Each wrapper launches its kernel for CUDA tensors and runs
its plain PyTorch version (``*_plain``) only for tensors on the CPU; a
CUDA input the kernel does not take raises, and nothing falls back.
:func:`fused_layer_norm_with_stats` ties them together in a
``torch.autograd.Function`` as the reference's ``custom_vjp`` does.

Rows are ``[n, h]`` with x float32 or bfloat16 and gamma/beta in x's
dtype or float32; statistics are float32 ``[n]``. Any n >= 1 is taken
(the reference tiles n into row blocks it can find; the kernel does not
need them) and h up to 8192.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

#: kernel launches per kernel (CPU calls excluded); one ln_bwd call counts
#: once although it launches its row pass and its reduce
launches = {"ln_fwd": 0, "ln_bwd": 0}

_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_H = 8192
#: row blocks of the backward's first stage (4 per SM of an H100); the
#: partial sums are added in a fixed order, so runs are deterministic
BWD_BLOCKS = 528


# ------------------------------------------------------------ plain versions

def ln_fwd_plain(x2, gamma, beta, eps):
    """What the forward kernel computes, in the reference's order
    (``layer_norm.py:27-37``): ``(y, mean, rstd)``, y in x's dtype."""
    x = x2.float()
    mean = x.mean(dim=1)
    xc = x - mean[:, None]
    rstd = torch.rsqrt((xc * xc).mean(dim=1) + eps)
    y = xc * rstd[:, None] * gamma.float() + beta.float()
    return y.to(x2.dtype), mean, rstd


def ln_bwd_plain(x2, gamma, mean, rstd, dy):
    """What the backward kernels compute (``layer_norm.py:40-64``):
    ``(dx, dgamma, dbeta)``, dx in x's dtype, the sums over rows in f32
    cast to gamma's dtype."""
    x, g, d = x2.float(), gamma.float(), dy.float()
    xhat = (x - mean[:, None]) * rstd[:, None]
    dyg = d * g
    m1 = dyg.mean(dim=1, keepdim=True)
    m2 = (dyg * xhat).mean(dim=1, keepdim=True)
    dx = rstd[:, None] * (dyg - m1 - xhat * m2)
    return (dx.to(x2.dtype), (d * xhat).sum(0).to(gamma.dtype),
            d.sum(0).to(gamma.dtype))


# ----------------------------------------------------------------- kernels

def _lib():
    lib = _build.load("layer_norm")
    if lib.ln_fwd_launch.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.ln_fwd_launch.argtypes = [ptr] * 6 + [i32, i32, ctypes.c_float,
                                                  i32, i32, ptr]
        lib.ln_bwd_launch.argtypes = [ptr] * 9 + [i32] * 5 + [ptr]
        lib.ln_fwd_launch.restype = ctypes.c_int
        lib.ln_bwd_launch.restype = ctypes.c_int
        lib.ln_error_string.argtypes = [ctypes.c_int]
        lib.ln_error_string.restype = ctypes.c_char_p
    return lib


def _device(name, x):
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu tensors, not "
                         f"{x.device}")
    return x.device.type


def _check(x2, gamma, others):
    """The kernels' contract, checked before any pointer is passed."""
    if x2.dim() != 2 or x2.shape[0] < 1 or not 1 <= x2.shape[1] <= MAX_H:
        raise ValueError(f"x {tuple(x2.shape)} is not [n >= 1, h] rows with "
                         f"1 <= h <= {MAX_H}")
    n, h = x2.shape
    if x2.dtype not in _CODES or gamma.dtype not in (x2.dtype,
                                                     torch.float32):
        raise TypeError(f"x {x2.dtype}, gamma {gamma.dtype}: the kernels "
                        "take float32 or bfloat16 x and gamma/beta in x's "
                        "dtype or float32")
    if tuple(gamma.shape) != (h,):
        raise ValueError(f"gamma {tuple(gamma.shape)} is not [{h}]")
    for name, t, shape, dtype in others:
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    for t in (x2, gamma) + tuple(o[1] for o in others):
        if t.device != x2.device:
            raise ValueError(f"all inputs must be on {x2.device}, found "
                             f"{t.device}")
        if not t.is_contiguous():
            raise ValueError("the kernels take contiguous tensors only")


def _run(name, fn, *args):
    dev = args[-1]
    with torch.cuda.device(dev):
        rc = fn(*args[:-1], torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        msg = _lib().ln_error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed: {msg} ({rc})")
    launches[name] += 1


def ln_fwd(x2, gamma, beta, eps):
    """Forward kernel on ``[n, h]`` rows: ``(y, mean, rstd)``."""
    if _device("ln_fwd", x2) == "cpu":
        return ln_fwd_plain(x2, gamma, beta, eps)
    n, h = x2.shape if x2.dim() == 2 else (0, 0)
    _check(x2, gamma, [("beta", beta, (h,), gamma.dtype)])
    y = torch.empty_like(x2)
    mean = torch.empty(n, dtype=torch.float32, device=x2.device)
    rstd = torch.empty(n, dtype=torch.float32, device=x2.device)
    _run("ln_fwd", _lib().ln_fwd_launch, x2.data_ptr(), gamma.data_ptr(),
         beta.data_ptr(), y.data_ptr(), mean.data_ptr(), rstd.data_ptr(), n,
         h, float(eps), _CODES[x2.dtype], _CODES[gamma.dtype], x2.device)
    return y, mean, rstd


def ln_bwd(x2, gamma, mean, rstd, dy):
    """Backward kernels: ``(dx, dgamma, dbeta)`` given the forward's
    statistics."""
    if _device("ln_bwd", x2) == "cpu":
        return ln_bwd_plain(x2, gamma, mean, rstd, dy)
    n, h = x2.shape if x2.dim() == 2 else (0, 0)
    _check(x2, gamma, [("mean", mean, (n,), torch.float32),
                       ("rstd", rstd, (n,), torch.float32),
                       ("dy", dy, (n, h), x2.dtype)])
    p = min(n, BWD_BLOCKS)
    dx = torch.empty_like(x2)
    dgamma = torch.empty_like(gamma)
    dbeta = torch.empty_like(gamma)
    part = torch.empty((2, p, h), dtype=torch.float32, device=x2.device)
    _run("ln_bwd", _lib().ln_bwd_launch, x2.data_ptr(), gamma.data_ptr(),
         mean.data_ptr(), rstd.data_ptr(), dy.data_ptr(), dx.data_ptr(),
         dgamma.data_ptr(), dbeta.data_ptr(), part.data_ptr(), n, h, p,
         _CODES[x2.dtype], _CODES[gamma.dtype], x2.device)
    return dx, dgamma, dbeta


class _LayerNorm(torch.autograd.Function):
    """``(y, mean, rstd)`` of ``[n, h]`` rows, saving ``(x, gamma, mean,
    rstd)``; the statistics' cotangents are ignored, as the reference's
    ``custom_vjp`` ignores them (``layer_norm.py:121-138``)."""

    @staticmethod
    def forward(ctx, x2, gamma, beta, eps):
        y, mean, rstd = ln_fwd(x2, gamma, beta, eps)
        ctx.save_for_backward(x2, gamma, mean, rstd)
        ctx.mark_non_differentiable(mean, rstd)
        return y, mean, rstd

    @staticmethod
    def backward(ctx, dy, _dmean, _drstd):
        x2, gamma, mean, rstd = ctx.saved_tensors
        dx, dgamma, dbeta = ln_bwd(x2, gamma, mean, rstd, dy.contiguous())
        return dx, dgamma, dbeta, None


def fused_layer_norm_with_stats(x, gamma, beta, eps=1e-5):
    """LayerNorm over the last axis returning ``(y, mean, variance)``,
    the statistics ``[rows]`` as the kernel computed them, the variance
    recovered as ``1 / rstd^2 - eps`` (``layer_norm.py:141-151``)."""
    if gamma.dtype != beta.dtype:
        raise TypeError(f"gamma {gamma.dtype} and beta {beta.dtype} must "
                        "share a dtype")
    shape = x.shape
    x2 = x.reshape(-1, shape[-1]).contiguous()
    y, mean, rstd = _LayerNorm.apply(x2, gamma.contiguous(),
                                     beta.contiguous(), float(eps))
    var = 1.0 / (rstd * rstd) - eps
    return y.reshape(shape), mean, var


def fused_layer_norm(x, gamma, beta, eps=1e-5):
    """LayerNorm over the last axis; leading axes are flattened to rows."""
    return fused_layer_norm_with_stats(x, gamma, beta, eps)[0]
