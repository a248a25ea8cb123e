"""Optimizer updates as plain functions on tensors — the counterparts of
``adam`` and ``adamw`` in ``paddle_tpu/ops/optimizer_ops.py:40-71``. The
JAX package computes them outside Pallas, so plain PyTorch is their
port.

Rounding follows the reference op for op. With bf16 moments, jnp
promotes a Python scalar to the array's dtype, so ``beta1 * m1`` rounds
beta1 to bf16 (0.9 -> 0.8984375, 0.999 -> 1.0) and the product to bf16
before it meets the f32 gradient term; :func:`_as` reproduces that.
The new moments come back in f32: the caller rounds only what it
stores.
"""

from __future__ import annotations

import numpy as np
import torch


def _as(value: float, like: torch.Tensor) -> float:
    """``value`` rounded to ``like``'s dtype, as a Python float."""
    return float(torch.tensor(value, dtype=like.dtype))


def adam(param, grad, moment1, moment2, beta1_pow, beta2_pow, lr,
         beta1=0.9, beta2=0.999, epsilon=1e-8):
    """One Adam step (Paddle's form: the bias correction folds into the
    step size, ``lr_t = lr * sqrt(1 - b2^t) / (1 - b1^t)``, and epsilon
    is added to ``sqrt(m2)`` uncorrected). ``beta{1,2}_pow`` are the
    powers before this step (1.0 at the first) as ``[1]`` tensors.
    Returns ``(param, moment1, moment2, beta1_pow, beta2_pow)`` after
    it."""
    lr = float(np.float32(lr))
    g = grad.to(param.dtype)
    m1 = _as(beta1, moment1) * moment1 + (1 - beta1) * g
    m2 = _as(beta2, moment2) * moment2 + (1 - beta2) * g * g
    b1p = beta1_pow * beta1
    b2p = beta2_pow * beta2
    lr_t = lr * torch.sqrt(1 - b2p) / (1 - b1p)
    p = param - lr_t * m1 / (torch.sqrt(m2) + epsilon)
    return p, m1, m2, b1p, b2p


def adamw(param, grad, moment1, moment2, beta1_pow, beta2_pow, lr,
          beta1=0.9, beta2=0.999, epsilon=1e-8, coeff=0.01):
    """:func:`adam` followed by the decoupled weight decay
    ``- lr * coeff * param`` on the parameter as it was before the
    step."""
    out = adam(param, grad, moment1, moment2, beta1_pow, beta2_pow, lr,
               beta1, beta2, epsilon)
    decay = float(np.float32(lr) * np.float32(coeff))
    return (out[0] - decay * param,) + out[1:]
