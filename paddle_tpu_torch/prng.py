"""Threefry-2x32 random streams in torch, bit-equal to what the JAX package
draws through ``jax.random``: the counterpart of the parts of
``jax/_src/prng.py`` and ``jax/_src/random.py`` the serving sampler uses
(:func:`PRNGKey`, :func:`split`, :func:`random_bits`, :func:`uniform`,
:func:`gumbel`, :func:`categorical`).

The streams are those of ``jax_threefry_partitionable=True`` (JAX's
default since 0.5): a key ``(k1, k2)`` hashes the 64-bit index of every
output element, split into its high and low 32-bit halves, and
``split(key, n)[i]`` is the hash pair of index ``i`` while the random
bits of element ``i`` are the two halves xor-ed. Keys are 32-bit-unsigned
pairs ``[..., 2]``; here they are int64 tensors holding values in
[0, 2^32), and every step of the hash is int64 arithmetic masked back to
32 bits (no ``torch.uint32`` kernels). Nothing reads a value back to the
host, so each function can run inside a captured CUDA graph.

JAX's streams depend on ``jax_enable_x64``; these are the streams with
64-bit types off, JAX's default: seeds wrap to 32 bits and ``uniform``
draws float32.

A leading batch of keys ``[*b, 2]`` draws one independent stream per
key, as ``jax.vmap`` over the JAX function does: the result is
``[*b, *shape]``.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

MASK = 0xFFFFFFFF
#: the rotation constants of Threefry-2x32 (Salmon et al., 2011), the two
#: sets alternating every four rounds
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
#: the key-schedule parity constant
PARITY = 0x1BD11BDA

_F32_TINY = float(np.finfo(np.float32).tiny)


def _u32(x) -> torch.Tensor:
    """An integer tensor as int64 holding its 32-bit unsigned value."""
    x = torch.as_tensor(x)
    return x.to(torch.int64) & MASK


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash, 20 rounds: key ``(k1, k2)``, counter
    ``(x1, x2)``, all broadcast together; returns the two output words as
    int64 tensors in [0, 2^32). ``jax._src.prng._threefry2x32_lowering``
    unrolled."""
    k1, k2, x1, x2 = (_u32(a) for a in (k1, k2, x1, x2))
    ks = (k1, k2, k1 ^ k2 ^ PARITY)
    a = (x1 + ks[0]) & MASK
    b = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            a = (a + b) & MASK
            b = (((b << r) | (b >> (32 - r))) & MASK) ^ a
        a = (a + ks[(i + 1) % 3]) & MASK
        b = (b + ks[(i + 2) % 3] + (i + 1)) & MASK
    return a, b


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """The raw key ``[2]`` of ``jax.random.PRNGKey(seed)`` with 64-bit
    types off (JAX's default): the seed wraps to 32 bits, so the key is
    ``[0, seed mod 2^32]``; a seed outside int64 raises OverflowError, as
    JAX does."""
    s = int(np.int64(seed))
    return torch.tensor([0, s & MASK], dtype=torch.int64, device=device)


def _hash_counts(keys: torch.Tensor, shape: Sequence[int]):
    """The hash of every element index of ``shape`` under each key of
    ``keys [*b, 2]``: two ``[*b, *shape]`` words. The index's high word is
    0 for every shape below 2^32 elements, the only ones a sampler
    draws."""
    keys = _u32(keys)
    shape = tuple(int(d) for d in shape)
    n = int(np.prod(shape)) if shape else 1
    if n >= 2 ** 32:
        raise NotImplementedError("random draws of 2^32 or more elements")
    lo = torch.arange(n, dtype=torch.int64, device=keys.device).reshape(shape)
    batch = keys.shape[:-1]
    pad = (None,) * len(shape)
    k1 = keys[..., 0][(..., *pad)]
    k2 = keys[..., 1][(..., *pad)]
    hi = torch.zeros((), dtype=torch.int64, device=keys.device)
    b1, b2 = threefry2x32(k1, k2, hi, lo)
    full = (*batch, *shape)
    return b1.expand(full), b2.expand(full)


def split(keys: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)`` for each key of ``keys [*b, 2]``:
    ``[*b, num, 2]`` int64."""
    b1, b2 = _hash_counts(keys, (int(num),))
    return torch.stack([b1, b2], dim=-1)


def random_bits(keys: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """32 random bits per element, ``[*b, *shape]`` int64 in [0, 2^32):
    ``jax._src.prng._threefry_random_bits_partitionable`` at width 32."""
    b1, b2 = _hash_counts(keys, shape)
    return b1 ^ b2


def uniform(keys: torch.Tensor, shape: Sequence[int] = (),
            minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """float32 uniform in [minval, maxval), ``jax.random.uniform``: the
    top 23 random bits become the mantissa of a float in [1, 2), minus
    1, scaled to the range (the width rounded to float32 first, as JAX
    subtracts in float32) and clamped below at ``minval``."""
    bits = random_bits(keys, shape)
    one = 0x3F800000              # float32 1.0
    floats = ((bits >> 9) | one).to(torch.int32).view(torch.float32) - 1.0
    lo = np.float32(minval)
    width = float(np.float32(maxval) - lo)
    return torch.clamp_min(floats * width + float(lo), float(lo))


def gumbel(keys: torch.Tensor, shape: Sequence[int] = ()) -> torch.Tensor:
    """float32 standard Gumbel noise, ``jax.random.gumbel`` in its default
    ``"low"`` mode: ``-log(-log(u))`` of a uniform in [tiny, 1)."""
    u = uniform(keys, shape, minval=_F32_TINY, maxval=1.0)
    return -torch.log(-torch.log(u))


def categorical(keys: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """One draw per row of ``logits [*b, V]`` under its key of ``keys
    [*b, 2]``: the Gumbel-max trick of ``jax.random.categorical`` (axis
    -1, with replacement), the first index of the largest ``gumbel +
    logits``. Returns int64 ``[*b]``."""
    g = gumbel(keys, logits.shape[-1:])
    return torch.argmax(g + logits, dim=-1)
