"""Threefry-2x32 random streams in torch, bit-equal to what the JAX package
draws through ``jax.random``: the counterpart of the parts of
``jax/_src/prng.py`` and ``jax/_src/random.py`` the serving sampler uses
(:func:`PRNGKey`, :func:`split`, :func:`random_bits`, :func:`uniform`,
:func:`gumbel`, :func:`categorical`) and the static executor's random ops
use (:func:`fold_in`, :func:`normal`, :func:`truncated_normal`).

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
draws float32. :func:`fold_in` and :func:`uniform` are bit-equal to
JAX; :func:`normal` and :func:`truncated_normal` go through torch's
``erfinv`` (and ``erf``), which round differently from XLA's, so they
agree with JAX to a few float32 ulps, not bit for bit.

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
    return _rounds(*(_u32(a) for a in (k1, k2, x1, x2)))


def _rounds(k1, k2, x1, x2):
    """The 20 rounds on 32-bit values held in int64 tensors or Python
    ints."""
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
    key = torch.zeros(2, dtype=torch.int64, device=device)
    key[1].fill_(s & MASK)      # a fill, not a copy: capture-safe
    return key


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
    subtracts in float32) and clamped below at ``minval``. XLA contracts
    ``floats * width + minval`` into one fused multiply-add, rounded
    once; the product is exact in float64, so the sum is taken there and
    rounded to float32 once."""
    bits = random_bits(keys, shape)
    one = 0x3F800000              # float32 1.0
    floats = ((bits >> 9) | one).to(torch.int32).view(torch.float32) - 1.0
    lo = np.float32(minval)
    width = float(np.float32(maxval) - lo)
    fused = (floats.to(torch.float64) * width + float(lo)).to(torch.float32)
    return torch.clamp_min(fused, float(lo))


def uniform_const(keys: torch.Tensor, shape: Sequence[int] = (),
                  minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """:func:`uniform` as XLA computes it when the bounds are constants of
    the compiled function, as the static ``uniform_random`` op's are in
    the reference's executor: at a width of exactly 1 the simplifier drops
    the multiply and folds the constants, ``float + (minval - 1)``; at any
    other width it computes :func:`uniform`'s fused multiply-add."""
    lo = np.float32(minval)
    if np.float32(maxval) - lo != np.float32(1.0):
        return uniform(keys, shape, minval, maxval)
    bits = random_bits(keys, shape)
    one = 0x3F800000              # float32 1.0
    f1 = ((bits >> 9) | one).to(torch.int32).view(torch.float32)
    return torch.clamp_min(f1 + float(lo - np.float32(1.0)), float(lo))


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


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in(key, data)`` for each key of ``keys [*b, 2]``:
    the hash of the counter pair ``(0, uint32(data))`` under the key
    (``jax._src.prng.threefry_fold_in``). ``data`` is an int or an
    integer tensor broadcast against the keys' batch. Returns ``[*b,
    2]`` int64."""
    keys = _u32(keys)
    if not isinstance(data, torch.Tensor):
        # a fill, not a copy from the host, so a graph can capture it
        data = torch.full((), int(data) & MASK, dtype=torch.int64,
                          device=keys.device)
    b1, b2 = threefry2x32(keys[..., 0], keys[..., 1],
                          torch.zeros((), dtype=torch.int64,
                                      device=keys.device), data)
    return torch.stack([b1, b2], dim=-1)


def fold_in_host(key, data) -> tuple:
    """:func:`fold_in` of one key ``(k1, k2)`` computed on the host in
    Python ints: ``(k1, k2)`` of the new key. The executor makes each
    run's key so, then copies it to the card in one small copy."""
    return _rounds(int(key[0]) & MASK, int(key[1]) & MASK, 0,
                   int(data) & MASK)


_SQRT2 = float(np.float32(np.sqrt(2.0)))


def normal(keys: torch.Tensor, shape: Sequence[int] = ()) -> torch.Tensor:
    """float32 standard normal draws, ``jax.random.normal``: ``sqrt(2) *
    erfinv(u)`` of a uniform ``u`` in ``[nextafter(-1, 0), 1)``."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = uniform(keys, shape, minval=lo, maxval=1.0)
    return torch.erfinv(u) * _SQRT2


def truncated_normal(keys: torch.Tensor, lower: float, upper: float,
                     shape: Sequence[int] = ()) -> torch.Tensor:
    """float32 normal draws truncated to ``(lower, upper)``,
    ``jax.random.truncated_normal``: ``sqrt(2) * erfinv(u)`` of a uniform
    between ``erf(lower / sqrt(2))`` and ``erf(upper / sqrt(2))``,
    clamped inside the open interval."""
    lo32, hi32 = np.float32(lower), np.float32(upper)
    a, b = (float(torch.erf(torch.tensor(float(v), dtype=torch.float32)
                            / torch.tensor(_SQRT2, dtype=torch.float32)))
            for v in (lo32, hi32))
    u = uniform(keys, shape, minval=a, maxval=b)
    out = torch.erfinv(u) * _SQRT2
    return torch.clamp(out, float(np.nextafter(lo32, np.float32(np.inf))),
                       float(np.nextafter(hi32, np.float32(-np.inf))))


def randint(keys: torch.Tensor, shape: Sequence[int], low: int,
            high: int) -> torch.Tensor:
    """int32 draws in ``[low, high)``, ``jax.random.randint`` with 64-bit
    types off: two 32-bit words per value from the key's two halves, each
    reduced modulo the span and combined as ``hi * (2^32 mod span) + lo``
    modulo the span. Returns int64 ``[*b, *shape]``."""
    lo32 = int(np.clip(low, -2 ** 31, 2 ** 31 - 1))
    hi32 = int(np.clip(high, -2 ** 31, 2 ** 31 - 1))
    span = (hi32 - lo32) & MASK
    if hi32 <= lo32:
        span = 1
    if high > 2 ** 31 - 1 and hi32 > lo32:
        span = (span + 1) & MASK
    k = split(keys, 2)
    higher = random_bits(k[..., 0, :], shape)
    lower = random_bits(k[..., 1, :], shape)
    if span == 0:                 # the whole 32-bit range: no remainder
        offset = lower
    else:
        mult = ((pow(2, 16, span) ** 2) & MASK) % span
        offset = (((higher % span) * mult) & MASK) + (lower % span)
        offset = (offset & MASK) % span
    val = (lo32 + offset) & MASK
    return torch.where(val >= 2 ** 31, val - 2 ** 32, val)


def permutation(keys: torch.Tensor, n: int) -> torch.Tensor:
    """A random permutation of ``range(n)``, ``jax.random.permutation``:
    ``ceil(3 ln n / ln(2^32 - 1))`` rounds, each a stable sort by fresh
    random 32-bit keys. One key ``[2]``; returns int64 ``[n]``."""
    x = torch.arange(n, dtype=torch.int64, device=keys.device)
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(MASK)))
    key = keys
    for _ in range(rounds):
        key, sub = split(key, 2).unbind(-2)
        order = torch.sort(random_bits(sub, (n,)), stable=True).indices
        x = x[order]
    return x
