"""Optimizers of the port — the counterpart of ``paddle_tpu/optimizer.py``
for the eager (2.0 dygraph) contract of ``Optimizer.step``
(``optimizer.py:376-455``): gradient clipping (``:25-172``), L1/L2
regularization (``:812-827``), a learning rate that is a float or an
:class:`~paddle_tpu_torch.optimizer_lr.LRScheduler` (exported here as
``lr``, as ``optimizer.py:19`` exports the reference's), a parameter's
``lr_scale``, and every optimizer with an eager op: SGD, Momentum,
LarsMomentum, Adagrad, Adam, AdamW, Lamb, RMSProp (uncentered) and Ftrl,
with the reference's aliases (``:801-809``).

torch parameters carry no name, so ``parameters=`` takes
``(name, parameter)`` pairs (``model.named_parameters()``); the names key
``state_dict()`` as ``"<name>:<key>"``, with the reference's accumulator
keys (``velocity``, ``moment``, ``m1``/``m2``/``b1p``/``b2p``,
``ms``/``mom``, ``sq``/``lin``). A parameter's ``lr_scale`` and
``regularizer`` are read from attributes of the same names, as the
reference reads them from its ``ParamAttr``; a parameter with
``requires_grad=False`` is not trainable.

What a CUDA graph needs (``jit.to_static``), for every optimizer: state
is created at a parameter's first step, which must not be inside a
capture, and updated in place afterwards; the learning rate lives in a
float32 ``[k]`` tensor per device, one slot per distinct ``lr_scale``
holding ``float32(lr * lr_scale)`` as the reference computes it
(``optimizer.py:402``), which an eager step, :meth:`Optimizer.set_lr`
and ``jit`` (before each replay) refresh in place and a captured update
reads. Adam and AdamW ride the multi-tensor kernel
(:mod:`~paddle_tpu_torch.ops.cuda.adamw`, Adam at ``coeff = 0``), one
launch per (device, parameter dtype, moment dtype) group with each
entry's own lr slot, ``GradientClipByGlobalNorm``'s factor folded into
the kernel; the others run their plain update
(:mod:`~paddle_tpu_torch.ops.optimizer_ops`) per parameter.

Unlike the reference, ``step()`` leaves ``p.grad`` as backward left it:
the clipped and regularized gradient exists only inside the update
(with the clip folded into the kernel there is no clipped copy at all).
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from . import optimizer_lr as lr  # paddle.optimizer.lr namespace
from .device import capturing
from .ops import optimizer_ops as ops
from .ops.cuda import adamw as _adamw_kernel
from .optimizer_lr import LRScheduler

_MOMENT_DTYPES = {None: None, "float32": torch.float32,
                  "bfloat16": torch.bfloat16}


# ------------------------------------------------------------- clipping

def _scalar_div(num: float, den: torch.Tensor) -> torch.Tensor:
    """``num / den`` as jnp divides a Python float by an array (the float
    taken to ``den``'s dtype, then one division); torch's
    ``float / tensor`` multiplies by a reciprocal instead."""
    return torch.div(torch.full_like(den, num), den)


class GradClipBase:
    def _clip(self, grads):
        """The clipped gradients of ``grads`` (None entries stay None)."""
        raise NotImplementedError


class GradientClipByValue(GradClipBase):
    """Each gradient element clipped to ``[min, max]`` (``min`` defaults
    to ``-max``)."""

    def __init__(self, max, min=None):  # noqa: A002
        self.max = float(max)
        self.min = float(min) if min is not None else -float(max)

    def _clip(self, grads):
        return [None if g is None else torch.clamp(g, self.min, self.max)
                for g in grads]


class GradientClipByNorm(GradClipBase):
    """Each gradient scaled to L2 norm at most ``clip_norm``, in its own
    dtype."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _clip(self, grads):
        out = []
        for g in grads:
            if g is None:
                out.append(None)
                continue
            norm = ops._norm(g)
            scale = torch.where(
                norm > self.clip_norm,
                _scalar_div(self.clip_norm, torch.clamp(norm, min=1e-12)),
                1.0)
            out.append(g * scale)
        return out


class GradientClipByGlobalNorm(GradClipBase):
    """All gradients scaled by ``clip_norm / max(||g||, clip_norm)``,
    ``||g||`` the L2 norm over every gradient: per tensor
    ``sum(square(g))`` in its dtype, then one sum of those in their
    promoted dtype (fixed order), as the reference's
    ``sum(jnp.sum(jnp.square(g)) for g in gs)`` keeps bf16 for a bf16
    set."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def scale(self, grads) -> Optional[torch.Tensor]:
        """The 0-dim factor (None without gradients)."""
        gs = [g for g in grads if g is not None]
        if not gs:
            return None
        dt = functools.reduce(torch.promote_types, [g.dtype for g in gs])
        total = torch.stack([torch.sum(torch.square(g)).to(dt)
                             for g in gs]).sum()
        norm = torch.sqrt(total)
        return _scalar_div(self.clip_norm,
                           torch.clamp(norm, min=self.clip_norm))

    def _clip(self, grads):
        scale = self.scale(grads)
        return [None if g is None else _adamw_kernel.scaled_grad(g, scale)
                for g in grads]


# ------------------------------------------------------- regularization

class L1Decay:
    """``g += coeff * sign(p)`` before the update."""
    kind = "l1"

    def __init__(self, regularization_coeff=0.0):
        self.coeff = regularization_coeff


class L2Decay:
    """``g += coeff * p`` before the update."""
    kind = "l2"

    def __init__(self, regularization_coeff=0.0):
        self.coeff = regularization_coeff


def _regularized(reg, p, g):
    kind, coeff = reg if isinstance(reg, tuple) else (reg.kind, reg.coeff)
    if kind == "l2":
        return g + ops._as(coeff, p) * p
    if kind == "l1":
        return g + ops._as(coeff, p) * torch.sign(p)
    raise ValueError(f"unknown regularizer kind {kind!r}")


# ------------------------------------------------------------ optimizers

class Optimizer:
    """Base of the eager optimizers (``paddle_tpu/optimizer.py:175``).

    ``learning_rate`` is a float or an ``LRScheduler``; ``weight_decay``
    a float (meaning ``L2Decay(weight_decay)``) or a regularizer, unless
    ``regularization`` is given, as ``optimizer.py:194-199`` resolves
    them; ``grad_clip`` one of the clip classes above. Subclasses name
    their update (``_op``, None: no eager step), their accumulators
    (``_accums``: key, initial value, shape or None for the
    parameter's) and apply it to one parameter (``_apply``)."""

    _op: Optional[str] = None
    _accums: Tuple[tuple, ...] = ()
    _moment_dtype = None

    def __init__(self, learning_rate=0.001, parameter_list=None,
                 parameters=None, regularization=None, weight_decay=None,
                 grad_clip: Optional[GradClipBase] = None,
                 name: Optional[str] = None):
        params = parameters if parameters is not None else parameter_list
        if params is None:
            raise ValueError(f"{type(self).__name__} requires parameters= "
                             "(name, parameter) pairs, e.g. "
                             "model.named_parameters()")
        self._params = []
        for item in params:
            if not (isinstance(item, tuple) and len(item) == 2
                    and isinstance(item[0], str)):
                raise TypeError("parameters= takes (name, parameter) pairs "
                                "such as model.named_parameters(): torch "
                                "parameters carry no name")
            self._params.append(item)
        if regularization is None and weight_decay is not None and \
                not isinstance(weight_decay, float):
            regularization = weight_decay
        elif regularization is None and isinstance(weight_decay, float):
            regularization = L2Decay(weight_decay)
        self.regularization = regularization
        self._grad_clip = grad_clip
        self._name = name or type(self).__name__
        self._learning_rate = learning_rate
        self._state: Dict[Tuple[str, str], torch.Tensor] = {}
        self._steps = 0
        # lr slots: lr_scale -> index into each device's [k] lr tensor
        self._slots: Dict[float, int] = {}
        self._lr: Dict[torch.device, torch.Tensor] = {}
        self._lr_host: Dict[torch.device, list] = {}
        # each parameter's slot, fixed once a captured graph reads them
        self._pinned: Optional[list] = None
        self._refresh_lr()

    @property
    def _parameter_list(self):
        return [p for _, p in self._params]

    # -- learning rate -----------------------------------------------------
    def _current_lr(self) -> float:
        lr_ = self._learning_rate
        if isinstance(lr_, LRScheduler):
            return float(lr_())
        return float(lr_)

    def get_lr(self) -> float:
        return self._current_lr()

    def set_lr(self, value):
        """Set a constant learning rate (replacing a scheduler, as the
        reference does), in place: a captured step reads it at its next
        replay."""
        self._learning_rate = float(value)
        self._refresh_lr()

    def _slot(self, p) -> int:
        scale = float(getattr(p, "lr_scale", 1.0))
        if scale not in self._slots:
            self._slots[scale] = len(self._slots)
        return self._slots[scale]

    def _pin_lr(self):
        """Fix every parameter's slot: a captured graph reads the slots of
        this lr tensor, so from now on an ``lr_scale`` that would move a
        parameter to another slot (or make the tensor anew) raises."""
        self._pinned = [self._slot(p) for _, p in self._params]

    def _refresh_lr(self):
        """Write ``float32(lr * lr_scale)`` of the current learning rate
        into every slot that holds another value (a fill per changed
        slot, none when nothing changed). A device's tensor is made, or
        remade when a new ``lr_scale`` appeared, only outside a
        capture and before :meth:`_pin_lr`."""
        if self._pinned is not None and self._pinned != [
                self._slots.get(float(getattr(p, "lr_scale", 1.0)))
                for _, p in self._params]:
            raise RuntimeError(
                f"{type(self).__name__}: a parameter's lr_scale changed "
                "after a captured step pinned the learning-rate slots it "
                "reads; the graph would go on reading the old slot")
        for _, p in self._params:
            self._slot(p)
        values = [0.0] * len(self._slots)
        cur = self._current_lr()
        for scale, i in self._slots.items():
            values[i] = float(np.float32(cur * scale))
        for dev in {p.device for _, p in self._params}:
            t = self._lr.get(dev)
            if t is None or t.numel() != len(values):
                if capturing():
                    raise RuntimeError(
                        f"{type(self).__name__}: its learning-rate tensor "
                        "would be made inside a CUDA graph capture (a new "
                        "lr_scale?); run one step eagerly first")
                self._lr[dev] = torch.tensor(values, dtype=torch.float32,
                                             device=dev)
                self._lr_host[dev] = list(values)
                continue
            host = self._lr_host[dev]
            for i, v in enumerate(values):
                if host[i] != v:
                    t[i].fill_(v)
                    host[i] = v

    def _lr_of(self, p) -> torch.Tensor:
        i = self._slot(p)
        return self._lr[p.device][i:i + 1]

    # -- accumulators ------------------------------------------------------
    def _accumulators(self, name, p):
        """The state tensors of parameter ``name`` in ``_accums`` order,
        created at its first step."""
        out = []
        for key, init, shape in self._accums:
            t = self._state.get((name, key))
            if t is None:
                if capturing():
                    raise RuntimeError(
                        f"{type(self).__name__}: the accumulators of {name} "
                        "would be created inside a CUDA graph capture; run "
                        "one step eagerly first")
                dt = p.dtype
                if self._moment_dtype is not None and shape is None \
                        and key in ("m1", "m2", "moment", "mom"):
                    dt = self._moment_dtype
                t = self._state[(name, key)] = torch.full(
                    shape or p.shape, init, dtype=dt, device=p.device)
            out.append(t)
        return out

    # -- the eager step ----------------------------------------------------
    def _fold_clip(self, entries) -> bool:
        """Whether the update takes ``GradientClipByGlobalNorm``'s factor
        itself (the kernel's ``grad_scale``) instead of clipped copies."""
        return False

    def _regularizer(self, p):
        if self._op == "adamw":
            return None
        return getattr(p, "regularizer", None) or self.regularization

    @torch.no_grad()
    def step(self):
        """One update of every trainable parameter that has a gradient:
        clip, add the regularizer (every op but ``adamw``), update with
        the parameter's learning rate, as ``optimizer.py:376-424``."""
        if self._op is None:
            raise NotImplementedError(
                f"{type(self).__name__} has no eager step path")
        if not capturing():
            self._refresh_lr()
        with_grad = [(n, p) for n, p in self._params if p.grad is not None]
        grads = [p.grad for _, p in with_grad]
        entries = [(n, p, g) for (n, p), g in zip(with_grad, grads)
                   if p.requires_grad]
        clip, scale = self._grad_clip, None
        if isinstance(clip, GradientClipByGlobalNorm) and \
                self._fold_clip(entries):
            scale = clip.scale(grads)
        elif clip is not None:
            clipped = dict(zip((id(p) for _, p in with_grad),
                               clip._clip(grads)))
            entries = [(n, p, clipped[id(p)]) for n, p, _ in entries]
        out = []
        for n, p, g in entries:
            reg = self._regularizer(p)
            out.append((n, p, g if reg is None else _regularized(reg, p, g)))
        self._update(out, scale)
        self._steps += 1

    def _update(self, entries, grad_scale):
        """The plain update of each parameter, written in place."""
        for name, p, g in entries:
            accs = self._accumulators(name, p)
            new = self._apply(p, g, accs, self._lr_of(p))
            for t, v in zip([p] + accs, new):
                t.copy_(v)

    def _apply(self, p, g, accs, lr_):
        raise NotImplementedError

    def clear_grad(self):
        for _, p in self._params:
            p.grad = None

    clear_gradients = clear_grad

    # -- state -------------------------------------------------------------
    def state_dict(self) -> dict:
        """``{"_lr": current lr, "<name>:<key>": tensor}`` for every
        accumulator of every parameter that has stepped. The tensors are
        the live state, which later steps update in place: clone them to
        keep a snapshot."""
        out = {"_lr": self._current_lr()}
        for (name, key), v in self._state.items():
            out[f"{name}:{key}"] = v
        return out

    def set_state_dict(self, state: dict):
        """Load a :meth:`state_dict`; entries of unknown parameters are
        skipped, as the reference skips them, and ``_lr`` is ignored when
        the learning rate is a scheduler. A value is copied into the
        existing tensor of the same shape and dtype (so a captured step
        sees it), otherwise into a new tensor on the parameter's
        device."""
        devices = {name: p.device for name, p in self._params}
        for k, v in state.items():
            if k == "_lr":
                if not isinstance(self._learning_rate, LRScheduler):
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

    load_state_dict = set_state_dict


class SGDOptimizer(Optimizer):
    _op = "sgd"

    def _apply(self, p, g, accs, lr_):
        return ops.sgd(p, g, lr_)


class MomentumOptimizer(Optimizer):
    _op = "momentum"
    _accums = (("velocity", 0.0, None),)

    def __init__(self, learning_rate, momentum=0.9, use_nesterov=False,
                 **kw):
        super().__init__(learning_rate, **kw)
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _apply(self, p, g, accs, lr_):
        return ops.momentum(p, g, *accs, lr_, self._momentum,
                            self._use_nesterov)


class LarsMomentumOptimizer(Optimizer):
    _op = "lars_momentum"
    _accums = (("velocity", 0.0, None),)

    def __init__(self, learning_rate, momentum=0.9, lars_coeff=0.001,
                 lars_weight_decay=0.0005, **kw):
        super().__init__(learning_rate, **kw)
        self._momentum = momentum
        self._lars_coeff = lars_coeff
        self._lars_weight_decay = lars_weight_decay

    def _apply(self, p, g, accs, lr_):
        return ops.lars_momentum(p, g, *accs, lr_, self._momentum,
                                 self._lars_coeff, self._lars_weight_decay)


class AdagradOptimizer(Optimizer):
    _op = "adagrad"
    _accums = (("moment", 0.0, None),)

    def __init__(self, learning_rate, epsilon=1e-6, **kw):
        super().__init__(learning_rate, **kw)
        self._epsilon = epsilon

    def _apply(self, p, g, accs, lr_):
        return ops.adagrad(p, g, *accs, lr_, self._epsilon)


class AdamOptimizer(Optimizer):
    """Adam (Paddle's form, :func:`~.ops.optimizer_ops.adam`): on the
    card the multi-tensor kernel with ``coeff = 0``.

    ``moment_dtype="bfloat16"`` stores m1/m2 in bf16: the update runs in
    f32 from the bf16 values and only the stored copy is rounded.
    ``lazy_mode`` is accepted and, as in the reference, changes
    nothing."""

    _op = "adam"
    _accums = (("m1", 0.0, None), ("m2", 0.0, None), ("b1p", 1.0, (1,)),
               ("b2p", 1.0, (1,)))

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_mode=False, moment_dtype=None, **kw):
        super().__init__(learning_rate, **kw)
        if moment_dtype not in _MOMENT_DTYPES:
            raise ValueError(f"moment_dtype must be one of "
                             f"{sorted(k for k in _MOMENT_DTYPES if k)} or "
                             f"None, got {moment_dtype!r}")
        self._beta1, self._beta2 = float(beta1), float(beta2)
        self._epsilon = float(epsilon)
        self._moment_dtype = _MOMENT_DTYPES[moment_dtype]
        self._coeff = 0.0
        # the kernel's device tables, by the group's static pointers
        self._tables: Dict[tuple, _adamw_kernel.Table] = {}

    def _fold_clip(self, entries) -> bool:
        return all(self._regularizer(p) is None for _, p, _ in entries)

    def _table(self, cols, lrs):
        """The kernel's table of a CUDA group, built at its first step."""
        p, _, m1, m2, b1p, b2p = cols
        key = tuple(t.data_ptr() for ts in (p, m1, m2, b1p, b2p, lrs)
                    for t in ts)
        table = self._tables.get(key)
        if table is None:
            table = self._tables[key] = _adamw_kernel.Table(
                p, m1, m2, b1p, b2p, lrs)
        return table

    def _update(self, entries, grad_scale):
        """The parameters grouped by (device, parameter dtype, moment
        dtype): one kernel launch per CUDA group, the plain loop per CPU
        group, each entry with its own lr slot."""
        groups = {}
        for name, p, g in entries:
            m1, m2, b1p, b2p = self._accumulators(name, p)
            groups.setdefault((p.device, p.dtype, m1.dtype), []).append(
                (p, g, m1, m2, b1p, b2p, self._lr_of(p)))
        for (dev, _, _), members in groups.items():
            *cols, lrs = (list(c) for c in zip(*members))
            scale = None
            if grad_scale is not None:
                scale = grad_scale.to(dev, torch.float32).reshape(1)
            _adamw_kernel.adamw_multi(
                *cols, lrs, self._beta1, self._beta2, self._epsilon,
                self._coeff, grad_scale=scale,
                table=self._table(cols, lrs) if dev.type == "cuda" else None)


class AdamWOptimizer(AdamOptimizer):
    """Adam with decoupled weight decay ``coeff`` applied to every
    parameter (LayerNorm and biases included), with Paddle's update
    (:func:`~.ops.optimizer_ops.adamw`); regularizers are not applied,
    as in the reference."""

    _op = "adamw"

    def __init__(self, learning_rate=0.001, weight_decay=0.01, **kw):
        super().__init__(learning_rate, **kw)
        self._coeff = float(weight_decay)


class LambOptimizer(AdamOptimizer):
    """LAMB (:func:`~.ops.optimizer_ops.lamb`): the plain update per
    parameter."""

    _op = "lamb"

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, **kw):
        super().__init__(learning_rate, beta1=beta1, beta2=beta2,
                         epsilon=epsilon, **kw)
        self._weight_decay = lamb_weight_decay

    def _fold_clip(self, entries) -> bool:
        return False

    _update = Optimizer._update

    def _apply(self, p, g, accs, lr_):
        return ops.lamb(p, g, *accs, lr_, self._beta1, self._beta2,
                        self._epsilon, self._weight_decay)


class RMSPropOptimizer(Optimizer):
    """RMSProp; the centered form has no eager op in the reference, so its
    ``step()`` raises NotImplementedError."""

    _accums = (("ms", 0.0, None), ("mom", 0.0, None))

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, **kw):
        super().__init__(learning_rate, **kw)
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, centered
        if not centered:
            self._op = "rmsprop"

    def _apply(self, p, g, accs, lr_):
        return ops.rmsprop(p, g, *accs, lr_, self._rho, self._epsilon,
                           self._momentum)


class FtrlOptimizer(Optimizer):
    _op = "ftrl"
    _accums = (("sq", 0.0, None), ("lin", 0.0, None))

    def __init__(self, learning_rate, l1=0.0, l2=0.0, lr_power=-0.5, **kw):
        super().__init__(learning_rate, **kw)
        self._l1, self._l2, self._lr_power = l1, l2, lr_power

    def _apply(self, p, g, accs, lr_):
        return ops.ftrl(p, g, *accs, lr_, self._l1, self._l2,
                        self._lr_power)


# fluid-style aliases
SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adam = AdamOptimizer
AdamW = AdamWOptimizer
Adagrad = AdagradOptimizer
Lamb = LambOptimizer
RMSProp = RMSPropOptimizer
Ftrl = FtrlOptimizer
LarsMomentum = LarsMomentumOptimizer
