"""Random op lowerings — the counterpart of
``paddle_tpu/ops/random_ops.py`` (``:26-55``): ``gaussian_random``,
``uniform_random`` and ``truncated_gaussian_random``, drawn from the op's
threefry key (:meth:`~.registry.LoweringContext.rng`, the run's key
folded with the op's index on the device) or from ``PRNGKey(seed)`` for
an op with a nonzero ``seed`` attr. The streams are JAX's
(:mod:`~paddle_tpu_torch.prng`): a seeded Program's startup run draws
the reference's initial weights, ``uniform_random`` bit for bit, the two
normal ops to a few float32 ulps (torch's ``erfinv`` is not XLA's).
Float32 only; another dtype draws in float32 and is cast.

``randint``, ``randperm``, ``bernoulli`` and ``multinomial`` (``:55-89``)
port JAX's arithmetic, not torch's samplers, so they draw the
reference's values bit for bit: ``randint`` two 32-bit words per value
reduced modulo the span (``jax.random.randint``), ``randperm`` rounds of
a stable sort by random 32-bit keys (``jax.random.permutation``),
``bernoulli`` a uniform below ``p``, ``multinomial`` the Gumbel-max of
``jax.random.categorical``. The integer draws are 32-bit, as JAX's with
64-bit types off, and come back in the op's dtype.
"""

from __future__ import annotations

import torch

from .. import prng
from .registry import np_dtype, register


def _maybe_seed(ctx, attrs):
    seed = attrs.get("seed", 0)
    if seed:
        return prng.PRNGKey(int(seed), device=ctx.device)
    return ctx.rng()


def _shape(attrs):
    return tuple(int(d) for d in attrs["shape"])


@register("gaussian_random", not_differentiable=True)
def _gaussian_random(ctx, ins, attrs):
    dtype = np_dtype(attrs.get("dtype", "float32"))
    mean = attrs.get("mean", 0.0)
    std = attrs.get("std", 1.0)
    out = mean + std * prng.normal(_maybe_seed(ctx, attrs), _shape(attrs))
    return {"Out": [out.to(dtype)]}


@register("uniform_random", not_differentiable=True)
def _uniform_random(ctx, ins, attrs):
    dtype = np_dtype(attrs.get("dtype", "float32"))
    out = prng.uniform_const(_maybe_seed(ctx, attrs), _shape(attrs),
                             attrs.get("min", -1.0), attrs.get("max", 1.0))
    return {"Out": [out.to(dtype)]}


@register("truncated_gaussian_random", not_differentiable=True)
def _truncated_gaussian_random(ctx, ins, attrs):
    dtype = np_dtype(attrs.get("dtype", "float32"))
    mean = attrs.get("mean", 0.0)
    std = attrs.get("std", 1.0)
    out = mean + std * prng.truncated_normal(_maybe_seed(ctx, attrs), -2.0,
                                             2.0, _shape(attrs))
    return {"Out": [out.to(dtype)]}


@register("randint", not_differentiable=True)
def _randint(ctx, ins, attrs):
    dtype = np_dtype(attrs.get("dtype", "int64"))
    out = prng.randint(_maybe_seed(ctx, attrs), _shape(attrs),
                       int(attrs.get("low", 0)), int(attrs.get("high")))
    return {"Out": [out.to(dtype)]}


@register("randperm", not_differentiable=True)
def _randperm(ctx, ins, attrs):
    dtype = np_dtype(attrs.get("dtype", "int64"))
    out = prng.permutation(_maybe_seed(ctx, attrs), int(attrs["n"]))
    return {"Out": [out.to(dtype)]}


@register("bernoulli", not_differentiable=True)
def _bernoulli(ctx, ins, attrs):
    x = ins["X"][0]
    u = prng.uniform(_maybe_seed(ctx, attrs), tuple(x.shape))
    return {"Out": [(u < x).to(x.dtype)]}


@register("multinomial", not_differentiable=True)
def _multinomial(ctx, ins, attrs):
    x = ins["X"][0]
    num = int(attrs.get("num_samples", 1))
    logits = torch.log(torch.clamp_min(x, 1e-30))
    g = prng.gumbel(_maybe_seed(ctx, attrs), (num,) + tuple(x.shape))
    out = torch.argmax(g + logits, dim=-1)
    return {"Out": [out.movedim(0, -1).to(torch.int64)]}
