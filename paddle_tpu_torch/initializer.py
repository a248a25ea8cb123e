"""Parameter initializers — a copy of ``paddle_tpu/initializer.py``.

Analog of python/paddle/fluid/initializer.py: each initializer appends an
init op to the *startup program* for a parameter var. Randomness flows
through the executor's threefry keys (``ops/random_ops.py``), so a seeded
startup program draws the reference's values.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np


class Initializer:
    def __call__(self, var, block):
        raise NotImplementedError

    @staticmethod
    def _fan_in_out(var):
        shape = var.shape
        if len(shape) < 2:
            fan_in = fan_out = int(shape[0]) if shape else 1
        else:
            receptive = int(np.prod(shape[2:])) if len(shape) > 2 else 1
            fan_in = int(shape[1]) * receptive
            fan_out = int(shape[0]) * receptive
            if len(shape) == 2:
                fan_in, fan_out = int(shape[0]), int(shape[1])
        return fan_in, fan_out


class ConstantInitializer(Initializer):
    def __init__(self, value: float = 0.0):
        self.value = value

    def __call__(self, var, block):
        block.append_op("fill_constant", outputs={"Out": var.name},
                        attrs={"shape": list(var.shape), "dtype": var.dtype,
                               "value": float(self.value)})


class NormalInitializer(Initializer):
    def __init__(self, loc: float = 0.0, scale: float = 1.0, seed: int = 0):
        self.loc, self.scale, self.seed = loc, scale, seed

    def __call__(self, var, block):
        block.append_op("gaussian_random", outputs={"Out": var.name},
                        attrs={"shape": list(var.shape), "dtype": var.dtype,
                               "mean": self.loc, "std": self.scale,
                               "seed": self.seed})


class TruncatedNormalInitializer(Initializer):
    def __init__(self, loc: float = 0.0, scale: float = 1.0, seed: int = 0):
        self.loc, self.scale, self.seed = loc, scale, seed

    def __call__(self, var, block):
        block.append_op("truncated_gaussian_random", outputs={"Out": var.name},
                        attrs={"shape": list(var.shape), "dtype": var.dtype,
                               "mean": self.loc, "std": self.scale,
                               "seed": self.seed})


class UniformInitializer(Initializer):
    def __init__(self, low: float = -1.0, high: float = 1.0, seed: int = 0):
        self.low, self.high, self.seed = low, high, seed

    def __call__(self, var, block):
        block.append_op("uniform_random", outputs={"Out": var.name},
                        attrs={"shape": list(var.shape), "dtype": var.dtype,
                               "min": self.low, "max": self.high,
                               "seed": self.seed})


class XavierInitializer(Initializer):
    """Glorot. uniform=True -> U(-limit, limit), else N(0, std)."""

    def __init__(self, uniform: bool = True, fan_in=None, fan_out=None,
                 seed: int = 0):
        self.uniform, self.fan_in, self.fan_out, self.seed = \
            uniform, fan_in, fan_out, seed

    def __call__(self, var, block):
        fi, fo = self._fan_in_out(var)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        if self.uniform:
            limit = math.sqrt(6.0 / (fi + fo))
            UniformInitializer(-limit, limit, self.seed)(var, block)
        else:
            std = math.sqrt(2.0 / (fi + fo))
            NormalInitializer(0.0, std, self.seed)(var, block)


class MSRAInitializer(Initializer):
    """Kaiming/He."""

    def __init__(self, uniform: bool = True, fan_in=None, seed: int = 0):
        self.uniform, self.fan_in, self.seed = uniform, fan_in, seed

    def __call__(self, var, block):
        fi, _ = self._fan_in_out(var)
        fi = self.fan_in if self.fan_in is not None else fi
        if self.uniform:
            limit = math.sqrt(6.0 / fi)
            UniformInitializer(-limit, limit, self.seed)(var, block)
        else:
            std = math.sqrt(2.0 / fi)
            NormalInitializer(0.0, std, self.seed)(var, block)


class NumpyArrayInitializer(Initializer):
    def __init__(self, value: np.ndarray):
        self.value = np.asarray(value)

    def __call__(self, var, block):
        block.append_op("assign_value", outputs={"Out": var.name},
                        attrs={"shape": list(self.value.shape),
                               "dtype": var.dtype,
                               "values": self.value.reshape(-1).tolist()})


# fluid-style aliases
Constant = ConstantInitializer
Normal = NormalInitializer
TruncatedNormal = TruncatedNormalInitializer
Uniform = UniformInitializer
Xavier = XavierInitializer
MSRA = MSRAInitializer
KaimingUniform = MSRAInitializer


def _to_initializer(spec) -> Optional[Initializer]:
    if spec is None or isinstance(spec, Initializer):
        return spec
    raise TypeError(f"expected an Initializer, got {type(spec)}")


def eager_init(init: Initializer, shape, dtype, rng: np.random.RandomState
               ) -> np.ndarray:
    """Materialize an initializer eagerly (dygraph parameter creation)."""
    shape = tuple(int(d) for d in shape)

    class _FakeVar:
        pass

    v = _FakeVar()
    v.shape = shape
    if isinstance(init, ConstantInitializer):
        return np.full(shape, init.value, dtype)
    if isinstance(init, NormalInitializer):
        return (init.loc + init.scale * rng.randn(*shape)).astype(dtype)
    if isinstance(init, TruncatedNormalInitializer):
        x = rng.randn(*shape)
        while True:
            bad = np.abs(x) > 2.0
            if not bad.any():
                break
            x[bad] = rng.randn(int(bad.sum()))
        return (init.loc + init.scale * x).astype(dtype)
    if isinstance(init, UniformInitializer):
        return rng.uniform(init.low, init.high, shape).astype(dtype)
    if isinstance(init, XavierInitializer):
        fi, fo = Initializer._fan_in_out(v)
        fi = init.fan_in if init.fan_in is not None else fi
        fo = init.fan_out if init.fan_out is not None else fo
        if init.uniform:
            limit = math.sqrt(6.0 / (fi + fo))
            return rng.uniform(-limit, limit, shape).astype(dtype)
        return (math.sqrt(2.0 / (fi + fo)) * rng.randn(*shape)).astype(dtype)
    if isinstance(init, MSRAInitializer):
        fi, _ = Initializer._fan_in_out(v)
        fi = init.fan_in if init.fan_in is not None else fi
        if init.uniform:
            limit = math.sqrt(6.0 / fi)
            return rng.uniform(-limit, limit, shape).astype(dtype)
        return (math.sqrt(2.0 / fi) * rng.randn(*shape)).astype(dtype)
    if isinstance(init, NumpyArrayInitializer):
        return np.asarray(init.value, dtype).reshape(shape)
    raise TypeError(f"cannot eager-init {type(init)}")
