"""Random op lowerings — the counterpart of
``paddle_tpu/ops/random_ops.py`` (``:26-55``): ``gaussian_random``,
``uniform_random`` and ``truncated_gaussian_random``, drawn from the op's
threefry key (:meth:`~.registry.LoweringContext.rng`, the run's key
folded with the op's index on the device) or from ``PRNGKey(seed)`` for
an op with a nonzero ``seed`` attr. The streams are JAX's
(:mod:`~paddle_tpu_torch.prng`): a seeded Program's startup run draws
the reference's initial weights, ``uniform_random`` bit for bit, the two
normal ops to a few float32 ulps (torch's ``erfinv`` is not XLA's).
Float32 only; another dtype draws in float32 and is cast. Waiting
(ROADMAP A7.2b): ``randint``, ``randperm``, ``bernoulli``,
``multinomial``.
"""

from __future__ import annotations

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
