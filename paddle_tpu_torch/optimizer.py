"""Optimizers of the port — the counterpart of ``paddle_tpu/optimizer.py``
for the eager (2.0 dygraph) contract of ``Optimizer.step``
(``optimizer.py:376-455``). This slice carries :class:`AdamW`
(``AdamWOptimizer``, ``:615``).

torch parameters carry no name, so ``parameters=`` takes
``(name, parameter)`` pairs (``model.named_parameters()``); the names key
``state_dict()`` as ``"<name>:<key>"``, as the reference keys its own by
parameter name.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from .ops.optimizer_ops import adamw

_MOMENT_DTYPES = {None: None, "float32": torch.float32,
                  "bfloat16": torch.bfloat16}


class AdamW:
    """Adam with decoupled weight decay, applied to every parameter
    (LayerNorm and biases included), with Paddle's update
    (:func:`~paddle_tpu_torch.ops.optimizer_ops.adamw`).

    ``moment_dtype="bfloat16"`` stores m1/m2 in bf16: the update runs in
    f32 from the bf16 values and only the stored copy is rounded. Each
    step updates the parameters in place (their tensors keep their
    identity), where the reference rebinds new arrays.
    """

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=0.01, beta1=0.9, beta2=0.999, epsilon=1e-8,
                 moment_dtype=None):
        if parameters is None:
            raise ValueError("AdamW requires parameters= (name, parameter) "
                             "pairs, e.g. model.named_parameters()")
        self._params = []
        for item in parameters:
            if not (isinstance(item, tuple) and len(item) == 2
                    and isinstance(item[0], str)):
                raise TypeError("parameters= takes (name, parameter) pairs "
                                "such as model.named_parameters(): torch "
                                "parameters carry no name")
            self._params.append(item)
        if moment_dtype not in _MOMENT_DTYPES:
            raise ValueError(f"moment_dtype must be one of "
                             f"{sorted(k for k in _MOMENT_DTYPES if k)} or "
                             f"None, got {moment_dtype!r}")
        self._learning_rate = float(learning_rate)
        self._coeff = float(weight_decay)
        self._beta1, self._beta2 = float(beta1), float(beta2)
        self._epsilon = float(epsilon)
        self._moment_dtype = _MOMENT_DTYPES[moment_dtype]
        self._state: Dict[Tuple[str, str], torch.Tensor] = {}

    def get_lr(self) -> float:
        return self._learning_rate

    def _accumulators(self, name, p):
        """(m1, m2, b1p, b2p) of parameter ``name``, zero moments and unit
        beta powers at its first step."""
        if (name, "m1") not in self._state:
            dt = self._moment_dtype or p.dtype
            self._state[(name, "m1")] = torch.zeros_like(p, dtype=dt)
            self._state[(name, "m2")] = torch.zeros_like(p, dtype=dt)
            for key in ("b1p", "b2p"):
                self._state[(name, key)] = torch.ones(1, dtype=p.dtype,
                                                      device=p.device)
        return tuple(self._state[(name, k)]
                     for k in ("m1", "m2", "b1p", "b2p"))

    @torch.no_grad()
    def step(self):
        """One update of every parameter that has a gradient."""
        for name, p in self._params:
            if p.grad is None or not p.requires_grad:
                continue
            m1, m2, b1p, b2p = self._accumulators(name, p)
            new_p, *new = adamw(p, p.grad, m1, m2, b1p, b2p,
                                self._learning_rate, self._beta1,
                                self._beta2, self._epsilon, self._coeff)
            p.copy_(new_p)
            for key, old, val in zip(("m1", "m2", "b1p", "b2p"),
                                     (m1, m2, b1p, b2p), new):
                self._state[(name, key)] = val.to(old.dtype)

    def clear_grad(self):
        for _, p in self._params:
            p.grad = None

    clear_gradients = clear_grad

    def state_dict(self) -> dict:
        """``{"_lr": lr, "<name>:<key>": tensor}`` for keys m1, m2, b1p,
        b2p of every parameter that has stepped."""
        out = {"_lr": self._learning_rate}
        for (name, key), v in self._state.items():
            out[f"{name}:{key}"] = v
        return out

    def set_state_dict(self, state: dict):
        """Load a :meth:`state_dict`; entries of unknown parameters are
        skipped, as the reference skips them."""
        devices = {name: p.device for name, p in self._params}
        for k, v in state.items():
            if k == "_lr":
                self._learning_rate = float(v)
                continue
            name, _, key = k.rpartition(":")
            if name in devices:
                self._state[(name, key)] = torch.as_tensor(v).to(
                    devices[name])
