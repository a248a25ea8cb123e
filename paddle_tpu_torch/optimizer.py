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

from .device import capturing
from .ops.cuda import adamw as _adamw_kernel

_MOMENT_DTYPES = {None: None, "float32": torch.float32,
                  "bfloat16": torch.bfloat16}


class AdamW:
    """Adam with decoupled weight decay, applied to every parameter
    (LayerNorm and biases included), with Paddle's update
    (:func:`~paddle_tpu_torch.ops.optimizer_ops.adamw`).

    ``moment_dtype="bfloat16"`` stores m1/m2 in bf16: the update runs in
    f32 from the bf16 values and only the stored copy is rounded.

    Each step updates the parameters, moments and beta powers in place:
    their tensors keep their identity, where the reference rebinds new
    arrays, so a CUDA graph that captured a step reads and writes the
    live state on every replay. The learning rate lives in a float32
    ``[1]`` tensor per device, which :meth:`set_lr` changes in place.
    The parameters that have a gradient are grouped by (device,
    parameter dtype, moment dtype); a CUDA group is one launch of the
    multi-tensor kernel (:mod:`~paddle_tpu_torch.ops.cuda.adamw`), a CPU
    group the plain per-parameter loop. Accumulators are created at a
    parameter's first step, which must not be inside a capture.
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
        self._lr = {}
        for _, p in self._params:
            if p.device not in self._lr:
                self._lr[p.device] = torch.full(
                    (1,), self._learning_rate, dtype=torch.float32,
                    device=p.device)
        self._coeff = float(weight_decay)
        self._beta1, self._beta2 = float(beta1), float(beta2)
        self._epsilon = float(epsilon)
        self._moment_dtype = _MOMENT_DTYPES[moment_dtype]
        self._state: Dict[Tuple[str, str], torch.Tensor] = {}
        # the kernel's device tables, by the group's static pointers
        self._tables: Dict[tuple, _adamw_kernel.Table] = {}

    def get_lr(self) -> float:
        return self._learning_rate

    def set_lr(self, value):
        """Set the learning rate in place: a captured step reads the new
        value at its next replay."""
        self._learning_rate = float(value)
        for t in self._lr.values():
            t.fill_(self._learning_rate)

    def _accumulators(self, name, p):
        """(m1, m2, b1p, b2p) of parameter ``name``, zero moments and unit
        beta powers at its first step."""
        if (name, "m1") not in self._state:
            if capturing():
                raise RuntimeError(
                    f"AdamW: the accumulators of {name} would be created "
                    "inside a CUDA graph capture; run one step eagerly "
                    "first")
            dt = self._moment_dtype or p.dtype
            self._state[(name, "m1")] = torch.zeros_like(p, dtype=dt)
            self._state[(name, "m2")] = torch.zeros_like(p, dtype=dt)
            for key in ("b1p", "b2p"):
                self._state[(name, key)] = torch.ones(1, dtype=p.dtype,
                                                      device=p.device)
        return tuple(self._state[(name, k)]
                     for k in ("m1", "m2", "b1p", "b2p"))

    def _table(self, cols):
        """The kernel's table of a CUDA group, built at its first step."""
        p, _, m1, m2, b1p, b2p = cols
        key = tuple(t.data_ptr() for ts in (p, m1, m2, b1p, b2p)
                    for t in ts)
        table = self._tables.get(key)
        if table is None:
            table = self._tables[key] = _adamw_kernel.Table(p, m1, m2, b1p,
                                                            b2p)
        return table

    @torch.no_grad()
    def step(self):
        """One update of every parameter that has a gradient."""
        groups = {}
        for name, p in self._params:
            if p.grad is None or not p.requires_grad:
                continue
            m1, m2, b1p, b2p = self._accumulators(name, p)
            groups.setdefault((p.device, p.dtype, m1.dtype), []).append(
                (p, p.grad, m1, m2, b1p, b2p))
        for (dev, _, _), members in groups.items():
            cols = tuple(list(c) for c in zip(*members))
            _adamw_kernel.adamw_multi(
                *cols, self._lr[dev], self._beta1, self._beta2,
                self._epsilon, self._coeff,
                table=self._table(cols) if dev.type == "cuda" else None)

    def clear_grad(self):
        for _, p in self._params:
            p.grad = None

    clear_gradients = clear_grad

    def state_dict(self) -> dict:
        """``{"_lr": lr, "<name>:<key>": tensor}`` for keys m1, m2, b1p,
        b2p of every parameter that has stepped. The tensors are the live
        state, which later steps update in place: clone them to keep a
        snapshot."""
        out = {"_lr": self._learning_rate}
        for (name, key), v in self._state.items():
            out[f"{name}:{key}"] = v
        return out

    def set_state_dict(self, state: dict):
        """Load a :meth:`state_dict`; entries of unknown parameters are
        skipped, as the reference skips them. A value is copied into the
        existing tensor of the same shape and dtype (so a captured step
        sees it), otherwise into a new tensor on the parameter's
        device."""
        devices = {name: p.device for name, p in self._params}
        for k, v in state.items():
            if k == "_lr":
                self.set_lr(v)
                continue
            name, _, key = k.rpartition(":")
            if name not in devices:
                continue
            v = torch.as_tensor(v)
            old = self._state.get((name, key))
            if old is not None and old.shape == v.shape \
                    and old.dtype == v.dtype:
                old.copy_(v)
            else:
                self._state[(name, key)] = v.to(devices[name], copy=True)
