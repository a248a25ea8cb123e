"""Flash attention, forward and backward: the counterpart of
``paddle_tpu/ops/pallas/flash_attention.py``.

Three hand-written CUDA kernels (``paddle_tpu_torch/csrc/
flash_attention.cu``, built on first use by :mod:`._build`) replace the
three TPU kernels: :func:`flash_fwd` (O and lse), :func:`flash_bwd_dq`
and :func:`flash_bwd_dkv`. Each wrapper launches its kernel for CUDA
tensors and runs its plain PyTorch version (``*_plain``) only for
tensors on the CPU; a CUDA tensor the kernel does not take raises, and
nothing falls back. Each kernel has two routes, decided by
:func:`_tc_route` before the launch: bf16 with head_dim 64 or 128 runs
the tensor-core (``wgmma``) kernels, everything else (f32, fp16, other
widths) the CUDA-core (``simt``) ones; ``launches_by_route`` counts each.
Every route loads the input dtype, computes in f32 and stores the input
dtype, as the reference does for any float dtype.
:func:`flash_attention` ties them together in a
``torch.autograd.Function`` whose backward computes
``delta = sum(dO * O, -1)`` in plain torch, as the JAX package does
outside Pallas, then launches dQ, then dK/dV.

Layout: the kernels take ``[batch*heads, seq, head_dim]``; the public
entry takes ``[b, h, s, d]`` (or the collapsed form) like the
reference's.
"""

from __future__ import annotations

import ctypes
import math
import sys

import torch

from . import _build, _launches

#: kernel launches per kernel (CPU calls excluded)
launches = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
#: the same launches by route: "wgmma" (tensor cores) or "simt" (CUDA
#: cores)
launches_by_route = {name: {"wgmma": 0, "simt": 0} for name in launches}

_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
MAX_D = 128


def _tc_route(dtype, d):
    """Whether the three kernels take the tensor-core route: bf16
    with head_dim 64 or 128 (TMA needs rows of a multiple of 16 bytes and
    the tiles are 64-column panels). The CUDA side decides by the same
    rule (``flash_tc_route`` in the library)."""
    return dtype == torch.bfloat16 and d in (64, 128)


def pick_block(n: int, preferred: int, minimum: int = 8) -> int:
    """Largest power-of-two divisor of ``n`` in [minimum, preferred]; 0
    when none exists (a copy of ``paddle_tpu/ops/pallas/utils.py:24``,
    which decides whether a sequence is tileable)."""
    b = preferred
    while b >= minimum:
        if n % b == 0:
            return b
        b //= 2
    return 0


# ------------------------------------------------------------ plain versions

def _scores(q, k, causal, scale):
    """f32 logits of pre-scaled q against k, causal entries above the
    diagonal at -inf (the kernels' mask: row >= col)."""
    s = (q.float() * scale) @ k.float().transpose(-1, -2)
    if causal:
        s_q, s_k = s.shape[-2], s.shape[-1]
        keep = torch.ones((s_q, s_k), dtype=torch.bool,
                          device=s.device).tril()
        s = s.masked_fill(~keep, float("-inf"))
    return s


def flash_fwd_plain(q, k, v, causal, scale):
    """What the forward kernel computes: ``(o, lse)`` with ``o`` in q's
    dtype and ``lse = logsumexp(scale * q k^T)`` f32 ``[bh, s_q]``."""
    s = _scores(q, k, causal, scale)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    return (p @ v.float()).to(q.dtype), lse


def flash_bwd_dq_plain(q, k, v, do, lse, delta, causal, scale):
    """What the dQ kernel computes: ``scale * sum_k P * (dO V^T - delta)
    K`` with ``P = exp(S - lse)``, in q's dtype."""
    p = torch.exp(_scores(q, k, causal, scale) - lse[..., None])
    ds = p * (do.float() @ v.float().transpose(-1, -2) - delta[..., None])
    return (ds @ k.float() * scale).to(q.dtype)


def flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal, scale):
    """What the dK/dV kernel computes: ``dV = P^T dO`` and ``dK = dS^T
    (scale * q)``, in k's and v's dtype."""
    p = torch.exp(_scores(q, k, causal, scale) - lse[..., None])
    ds = p * (do.float() @ v.float().transpose(-1, -2) - delta[..., None])
    dv = p.transpose(-1, -2) @ do.float()
    dk = ds.transpose(-1, -2) @ (q.float() * scale)
    return dk.to(k.dtype), dv.to(v.dtype)


# ----------------------------------------------------------------- kernels

def _lib():
    lib = _build.load("flash_attention")
    if lib.flash_fwd_launch.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        tail = [i32] * 4 + [ctypes.c_float, i32, i32, ptr]
        lib.flash_fwd_launch.argtypes = [ptr] * 5 + tail
        lib.flash_bwd_dq_launch.argtypes = [ptr] * 7 + tail
        lib.flash_bwd_dkv_launch.argtypes = [ptr] * 8 + tail
        for fn in (lib.flash_fwd_launch, lib.flash_bwd_dq_launch,
                   lib.flash_bwd_dkv_launch):
            fn.restype = ctypes.c_int
        lib.flash_error_string.argtypes = [ctypes.c_int]
        lib.flash_error_string.restype = ctypes.c_char_p
        lib.flash_tc_route.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.flash_tc_route.restype = ctypes.c_int
    return lib


def _device(name, q):
    """'cpu' or 'cuda' for the tensor that decides where ``name`` runs;
    anything else raises."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu tensors, not "
                         f"{q.device}")
    return q.device.type


def _check(q, k, v, causal, extra=()):
    """The kernel's contract, checked before any pointer is passed."""
    if q.dim() != 3 or k.dim() != 3 or tuple(v.shape) != tuple(k.shape) \
            or q.shape[0] != k.shape[0] or q.shape[2] != k.shape[2]:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)} are not [bh, s, d] slabs of "
                         "one geometry")
    bh, s_q, d = q.shape
    if not 1 <= d <= MAX_D:
        raise ValueError(f"head_dim {d} outside the kernel's 1..{MAX_D}")
    if causal and s_q != k.shape[1]:
        raise ValueError("causal flash attention requires seq_q == seq_k")
    if q.dtype not in _CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"dtypes {q.dtype}/{k.dtype}/{v.dtype}: the kernel "
                        "takes float32, bfloat16 or float16, all alike")
    for t in (q, k, v) + tuple(extra):
        if t.device != q.device:
            raise ValueError(f"all inputs must be on {q.device}, found "
                             f"{t.device}")
        if not t.is_contiguous():
            raise ValueError("the kernel takes contiguous tensors only")


def _check_stats(q, do, lse, delta):
    if tuple(do.shape) != tuple(q.shape) or do.dtype != q.dtype:
        raise ValueError(f"dO {tuple(do.shape)} {do.dtype} does not match q "
                         f"{tuple(q.shape)} {q.dtype}")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.dtype != torch.float32 or tuple(t.shape) != tuple(q.shape[:2]):
            raise ValueError(f"{name} must be float32 {tuple(q.shape[:2])}, "
                             f"got {t.dtype} {tuple(t.shape)}")


def _run(name, route, fn, *args):
    with torch.cuda.device(args[-1]):
        stream = torch.cuda.current_stream(args[-1]).cuda_stream
        rc = fn(*args[:-1], stream)
    if rc != 0:
        msg = _lib().flash_error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed: {msg} ({rc})")
    _launches.count(sys.modules[__name__], name, route)


def _route(q):
    return "wgmma" if _tc_route(q.dtype, q.shape[-1]) else "simt"


def flash_fwd(q, k, v, causal, scale):
    """Forward kernel on ``[bh, s, d]`` slabs: ``(o, lse)``, o in the input
    dtype, lse f32 ``[bh, s_q]``."""
    if _device("flash_fwd", q) == "cpu":
        return flash_fwd_plain(q, k, v, causal, scale)
    _check(q, k, v, causal)
    bh, s_q, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((bh, s_q), dtype=torch.float32, device=q.device)
    _run("flash_fwd", _route(q), _lib().flash_fwd_launch, q.data_ptr(),
         k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(), bh, s_q,
         k.shape[1], d, float(scale), int(causal), _CODES[q.dtype],
         q.device)
    return o, lse


def flash_bwd_dq(q, k, v, do, lse, delta, causal, scale):
    """dQ kernel: the gradient of q given ``lse`` and ``delta``."""
    if _device("flash_bwd_dq", q) == "cpu":
        return flash_bwd_dq_plain(q, k, v, do, lse, delta, causal, scale)
    _check(q, k, v, causal, (do, lse, delta))
    _check_stats(q, do, lse, delta)
    bh, s_q, d = q.shape
    dq = torch.empty_like(q)
    _run("flash_bwd_dq", _route(q), _lib().flash_bwd_dq_launch,
         q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
         lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), bh, s_q,
         k.shape[1], d, float(scale), int(causal), _CODES[q.dtype],
         q.device)
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, causal, scale):
    """dK/dV kernel: the gradients of k and v given ``lse`` and
    ``delta``."""
    if _device("flash_bwd_dkv", q) == "cpu":
        return flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal, scale)
    _check(q, k, v, causal, (do, lse, delta))
    _check_stats(q, do, lse, delta)
    bh, s_q, d = q.shape
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _run("flash_bwd_dkv", _route(q), _lib().flash_bwd_dkv_launch,
         q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
         lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), bh,
         s_q, k.shape[1], d, float(scale), int(causal), _CODES[q.dtype],
         q.device)
    return dk, dv


class _Flash(torch.autograd.Function):
    """O = attention(q, k, v) with the saved residuals (q, k, v, o, lse),
    the reference's ``custom_vjp`` (``flash_attention.py:231-242``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        o, lse = flash_fwd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        delta = (do.float() * o.float()).sum(-1)
        dq = flash_bwd_dq(q, k, v, do, lse, delta, ctx.causal, ctx.scale)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, ctx.causal,
                               ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal=False, scale=None, block_q=512,
                    block_k=512):
    """Flash attention on ``[b, h, s, d]`` (or ``[bh, s, d]``) inputs,
    differentiable in q, k and v.

    Returns the attention output with the input's shape and dtype. Raises
    ValueError for shapes the reference cannot tile (no power-of-two
    divisor of a sequence in [16, block]), for causal attention with
    ``seq_q != seq_k``, and for ``head_dim > 128`` (the kernel's limit;
    the reference pads any width). ``block_q``/``block_k`` only decide
    tileability: the kernel picks its own 64-row tiles.
    """
    squeeze = q.dim() == 4
    if squeeze:
        b, h, s_q, d = q.shape
        q = q.reshape(b * h, s_q, d)
        k = k.reshape(b * h, k.shape[2], d)
        v = v.reshape(b * h, v.shape[2], d)
    bh, s_q, d = q.shape
    s_k = k.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if not pick_block(s_q, block_q, 16) or not pick_block(s_k, block_k, 16):
        raise ValueError(
            f"flash_attention: cannot tile seq_q={s_q}, seq_k={s_k}")
    if causal and s_q != s_k:
        raise ValueError("causal flash_attention requires seq_q == seq_k")
    if d > MAX_D:
        raise ValueError(f"flash_attention: head_dim {d} exceeds {MAX_D}")
    out = _Flash.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                       bool(causal), float(scale))
    return out.reshape(b, h, s_q, d) if squeeze else out
