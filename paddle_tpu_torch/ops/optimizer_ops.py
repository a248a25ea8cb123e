"""Optimizer updates as plain functions on tensors — the counterparts of
the update ops in ``paddle_tpu/ops/optimizer_ops.py:19-171`` (``sgd``,
``momentum``, ``adam``, ``adamw``, ``adagrad``, ``rmsprop``, ``lamb``,
``lars_momentum``, ``ftrl``). The JAX package computes them outside
Pallas, so plain PyTorch is their port; ``adam`` and ``adamw`` also
ride the multi-tensor kernel of :mod:`.cuda.adamw` on the card.

Rounding follows the reference op for op. With bf16 moments, jnp
promotes a Python scalar to the array's dtype, so ``beta1 * m1`` rounds
beta1 to bf16 (0.9 -> 0.8984375, 0.999 -> 1.0) and the product to bf16
before it meets the f32 gradient term; :func:`_as` reproduces that
(torch would take the scalar at float32). The new state comes back in
its promoted dtype: the caller rounds only what it stores.

Every op but ``adam``/``adamw`` takes the learning rate as a float32
``[1]`` tensor (the optimizer's device slot, which a captured step
reads at every replay) and, as the reference does, casts it to the
parameter's dtype (``lr.reshape(()).astype(p.dtype)``). ``adam`` and
``adamw`` take a host float: their plain form runs on the CPU and as
the kernel's reference, never under capture.

The second half registers these updates as the static ops of
``paddle_tpu/ops/optimizer_ops.py:19-172``, with the reference's slots
and attrs. ``adam`` and ``adamw`` launch the AdamW kernel on a
one-entry group, updating ``Param``, ``Moment1``, ``Moment2`` and the
beta powers in place (the op's outputs are those tensors), with the
kernel's table built at the op's first eager run and kept for its
tensors; on CPU tensors the kernel's plain version runs, in place too.
The others compute new tensors, which the executor writes into the
scope's. ``dpsgd`` waits for ROADMAP A5.
"""

from __future__ import annotations

import numpy as np
import torch

from .registry import register


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


def _lr(lr, p):
    """The reference's ``lr.reshape(()).astype(p.dtype)``."""
    return lr.reshape(()).to(p.dtype)


def _norm(x):
    """``jnp.sqrt(jnp.sum(jnp.square(x)))`` in ``x``'s dtype."""
    return torch.sqrt(torch.sum(torch.square(x)))


def sgd(param, grad, lr):
    """``p - lr * g``. Returns ``(param,)``."""
    return (param - _lr(lr, param) * grad.to(param.dtype),)


def momentum(param, grad, velocity, lr, mu=0.9, use_nesterov=False):
    """Heavy-ball momentum, ``v = mu v + g``; Nesterov's form steps by
    ``(g + mu v) lr``. Returns ``(param, velocity)``."""
    lr = _lr(lr, param)
    g = grad.to(param.dtype)
    v = _as(mu, velocity) * velocity + g
    if use_nesterov:
        return param - (g + _as(mu, v) * v) * lr, v
    return param - lr * v, v


def lars_momentum(param, grad, velocity, lr, mu=0.9, lars_coeff=0.001,
                  lars_weight_decay=0.0005, epsilon=0.0):
    """LARS: momentum with a per-tensor local learning rate
    ``lr * coeff * ||p|| / (||g|| + wd ||p|| + eps)`` (the norms in the
    parameter's dtype), ``lr`` where either norm is zero. Returns
    ``(param, velocity)``."""
    lr = _lr(lr, param)
    g = grad.to(param.dtype)
    p_norm, g_norm = _norm(param), _norm(g)
    wd = _as(lars_weight_decay, p_norm)
    local = torch.where(
        (p_norm > 0) & (g_norm > 0),
        lr * _as(lars_coeff, lr) * p_norm
        / (g_norm + wd * p_norm + _as(epsilon, g_norm)), lr)
    v = _as(mu, velocity) * velocity + local * (g + _as(lars_weight_decay,
                                                        param) * param)
    return param - v, v


def adagrad(param, grad, moment, lr, epsilon=1e-6):
    """``m += g^2``; ``p -= lr g / (sqrt(m) + eps)``. Returns ``(param,
    moment)``."""
    lr = _lr(lr, param)
    g = grad.to(param.dtype)
    m = moment + g * g
    return param - lr * g / (torch.sqrt(m) + _as(epsilon, m)), m


def rmsprop(param, grad, mean_square, moment, lr, decay=0.9, epsilon=1e-10,
            momentum=0.0):
    """Uncentered RMSProp: ``ms = decay ms + (1 - decay) g^2``, ``mom =
    momentum mom + lr g / sqrt(ms + eps)``, ``p -= mom``. (The centered
    form has no eager op in the reference.) Returns ``(param,
    mean_square, moment)``."""
    lr = _lr(lr, param)
    g = grad.to(param.dtype)
    ms = _as(decay, mean_square) * mean_square + _as(1 - decay, g) * g * g
    mom = _as(momentum, moment) * moment + lr * g / torch.sqrt(
        ms + _as(epsilon, ms))
    return param - mom, ms, mom


def lamb(param, grad, moment1, moment2, beta1_pow, beta2_pow, lr,
         beta1=0.9, beta2=0.999, epsilon=1e-6, weight_decay=0.01):
    """LAMB: Adam's bias-corrected direction plus ``wd * p``, rescaled by
    the trust ratio ``||p|| / ||update||`` (1 where either is zero; the
    norms in the parameter's dtype). The bias correction uses the powers
    before this step. Returns ``(param, moment1, moment2, beta1_pow,
    beta2_pow)``."""
    lr = _lr(lr, param)
    g = grad.to(param.dtype)
    m1 = _as(beta1, moment1) * moment1 + _as(1 - beta1, g) * g
    m2 = _as(beta2, moment2) * moment2 + _as(1 - beta2, g) * g * g
    m1_hat = m1 / (1 - beta1_pow.reshape(()))
    m2_hat = m2 / (1 - beta2_pow.reshape(()))
    upd = m1_hat / (torch.sqrt(m2_hat) + _as(epsilon, m2_hat)) \
        + _as(weight_decay, param) * param
    p_norm, u_norm = _norm(param), _norm(upd)
    ratio = torch.where((p_norm > 0) & (u_norm > 0), p_norm / u_norm, 1.0)
    return (param - lr * ratio * upd, m1, m2,
            beta1_pow * _as(beta1, beta1_pow),
            beta2_pow * _as(beta2, beta2_pow))


def ftrl(param, grad, squared, linear, lr, l1=0.0, l2=0.0, lr_power=-0.5):
    """FTRL-proximal. Returns ``(param, squared, linear)``."""
    lr = _lr(lr, param)
    g = grad.to(param.dtype)
    new_sq = squared + g * g
    power = _as(-lr_power, new_sq)
    sigma = (torch.pow(new_sq, power) - torch.pow(squared, power)) / lr
    lin = linear + g - sigma * param
    quad = torch.pow(new_sq, power) / lr + _as(2 * l2, lr)
    pre = torch.clamp(lin, -l1, l1) - lin
    out = torch.where(torch.abs(lin) > _as(l1, lin), pre / quad,
                      torch.zeros_like(param))
    return out, new_sq, lin


# ------------------------------------------------------ the static ops

_ND = {"not_differentiable": True}


@register("sgd", **_ND)
def _sgd_op(ctx, ins, attrs):
    (p,) = sgd(ins["Param"][0], ins["Grad"][0], ins["LearningRate"][0])
    return {"ParamOut": [p]}


@register("momentum", **_ND)
def _momentum_op(ctx, ins, attrs):
    p, v = momentum(ins["Param"][0], ins["Grad"][0], ins["Velocity"][0],
                    ins["LearningRate"][0], attrs.get("mu", 0.9),
                    attrs.get("use_nesterov", False))
    return {"ParamOut": [p], "VelocityOut": [v]}


#: the AdamW kernel's tables of the static ``adam`` / ``adamw`` ops, by
#: the addresses, sizes and dtypes of (param, moments, powers, lr)
_TABLES = {}


def _adam_op(ins, attrs, coeff):
    from .cuda import adamw as _kernel
    p, lr = ins["Param"][0], ins["LearningRate"][0]
    cols = [[p], [ins["Grad"][0].to(p.dtype).contiguous()],
            [ins["Moment1"][0]], [ins["Moment2"][0]],
            [ins["Beta1Pow"][0]], [ins["Beta2Pow"][0]]]
    args = dict(beta1=attrs.get("beta1", 0.9), beta2=attrs.get("beta2", 0.999),
                epsilon=attrs.get("epsilon", 1e-8), coeff=coeff)
    table = None
    if p.device.type == "cuda":
        state = [cols[0], *cols[2:]]
        key = tuple((t.data_ptr(), t.numel(), t.dtype)
                    for t in [c[0] for c in state] + [lr])
        table = _TABLES.get(key)
        if table is None:
            table = _TABLES[key] = _kernel.Table(*state, [lr])
    _kernel.adamw_multi(*cols, [lr], table=table, **args)
    return {"ParamOut": [p], "Moment1Out": cols[2], "Moment2Out": cols[3],
            "Beta1PowOut": cols[4], "Beta2PowOut": cols[5]}


@register("adam", **_ND)
def _adam_static(ctx, ins, attrs):
    return _adam_op(ins, attrs, 0.0)


@register("adamw", **_ND)
def _adamw_static(ctx, ins, attrs):
    """Decoupled weight decay ``coeff`` when ``with_decay`` (the
    reference's defaults: 0.01, True)."""
    with_decay = attrs.get("with_decay", True)
    return _adam_op(ins, attrs, attrs.get("coeff", 0.01) if with_decay
                    else 0.0)


@register("adagrad", **_ND)
def _adagrad_op(ctx, ins, attrs):
    p, m = adagrad(ins["Param"][0], ins["Grad"][0], ins["Moment"][0],
                   ins["LearningRate"][0], attrs.get("epsilon", 1e-6))
    return {"ParamOut": [p], "MomentOut": [m]}


@register("rmsprop", **_ND)
def _rmsprop_op(ctx, ins, attrs):
    p, g = ins["Param"][0], ins["Grad"][0]
    ms, mom = ins["MeanSquare"][0], ins["Moment"][0]
    lr = ins["LearningRate"][0]
    eps = attrs.get("epsilon", 1e-10)
    decay = attrs.get("decay", 0.9)
    mu = attrs.get("momentum", 0.0)
    if not attrs.get("centered", False):
        p, ms, mom = rmsprop(p, g, ms, mom, lr, decay, eps, mu)
        return {"ParamOut": [p], "MeanSquareOut": [ms], "MomentOut": [mom]}
    lr = _lr(lr, p)
    g = g.to(p.dtype)
    mg = ins["MeanGrad"][0]
    ms_out = _as(decay, ms) * ms + _as(1 - decay, g) * g * g
    mg_out = _as(decay, mg) * mg + _as(1 - decay, g) * g
    denom = torch.sqrt(ms_out - mg_out * mg_out + _as(eps, ms_out))
    mom_out = _as(mu, mom) * mom + lr * g / denom
    return {"ParamOut": [p - mom_out], "MeanSquareOut": [ms_out],
            "MomentOut": [mom_out], "MeanGradOut": [mg_out]}


@register("lamb", **_ND)
def _lamb_op(ctx, ins, attrs):
    out = lamb(ins["Param"][0], ins["Grad"][0], ins["Moment1"][0],
               ins["Moment2"][0], ins["Beta1Pow"][0], ins["Beta2Pow"][0],
               ins["LearningRate"][0], attrs.get("beta1", 0.9),
               attrs.get("beta2", 0.999), attrs.get("epsilon", 1e-6),
               attrs.get("weight_decay", 0.01))
    return dict(zip(("ParamOut", "Moment1Out", "Moment2Out", "Beta1PowOut",
                     "Beta2PowOut"), ([t] for t in out)))


@register("lars_momentum", **_ND)
def _lars_momentum_op(ctx, ins, attrs):
    p, v = lars_momentum(ins["Param"][0], ins["Grad"][0],
                         ins["Velocity"][0], ins["LearningRate"][0],
                         attrs.get("mu", 0.9), attrs.get("lars_coeff", 0.001),
                         attrs.get("lars_weight_decay", 0.0005),
                         attrs.get("epsilon", 0.0))
    return {"ParamOut": [p], "VelocityOut": [v]}


@register("ftrl", **_ND)
def _ftrl_op(ctx, ins, attrs):
    p, sq, lin = ftrl(ins["Param"][0], ins["Grad"][0],
                      ins["SquaredAccumulator"][0],
                      ins["LinearAccumulator"][0], ins["LearningRate"][0],
                      attrs.get("l1", 0.0), attrs.get("l2", 0.0),
                      attrs.get("lr_power", -0.5))
    return {"ParamOut": [p], "SquaredAccumOut": [sq],
            "LinearAccumOut": [lin]}
