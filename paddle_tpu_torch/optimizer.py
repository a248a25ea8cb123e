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
``(name, parameter)`` pairs (``model.named_parameters()``) or the tape's
Parameters (:mod:`~paddle_tpu_torch.dygraph`: the name is ``.name``, the
tensor ``.value``); the names key
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

The static half (``optimizer.py:25-707``) rewrites a Program:
``minimize(loss)`` runs ``append_backward``, then the clip's
``_clip_static``, the regularization, the learning-rate variable
(``_create_lr_var``: a persistable ``[1]`` float32 initialized by the
startup program), the accumulators and one update op per parameter
(``_append_optimize_op``), ops the executor runs through the op
registry. An optimizer used only so may be built without
``parameters=`` (its ``step()`` then raises); ``parameters=`` takes the
eager (name, parameter) pairs and is not read by ``minimize``, which
takes Program variables through its ``parameter_list``.
:meth:`Optimizer.set_lr` with a ``scope`` writes the lr variable there as
the reference does, in place when a captured step holds it. The static
rewrites of ``optimizer.py:709-1104`` wrap an optimizer or append to
its Program: :class:`RecomputeOptimizer` (the checkpointed backward),
:class:`PipelineOptimizer` (the split into stages and its microbatch
runner, :mod:`~paddle_tpu_torch.distributed.fleet.pipeline`),
:class:`ExponentialMovingAverage`, :class:`ModelAverage` and
:class:`LookaheadOptimizer`; the fleet's strategy chain
(:mod:`~paddle_tpu_torch.distributed.fleet.fleet_base`) composes them.
DGC, LocalSGD and the sharded update run across cards and wait for
ROADMAP A5.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from . import optimizer_lr as lr  # paddle.optimizer.lr namespace
from .device import capturing
from .dygraph.tensor import Parameter as _TapeParameter
from .framework import unique_name
from .framework.backward import append_backward
from .framework.program import (Variable, default_main_program,
                                default_startup_program)
from .layers.tensor import create_global_var
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

    def _clip_static(self, params_grads, block):
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

    def _clip_static(self, params_grads, block):
        out = []
        for p, g in params_grads:
            clipped = block.create_var(unique_name.generate(g.name + "@CLIP"),
                                       stop_gradient=True)
            block.append_op("clip", {"X": g}, {"Out": clipped},
                            {"min": self.min, "max": self.max,
                             "op_role": "optimize"})
            out.append((p, clipped))
        return out


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

    def _clip_static(self, params_grads, block):
        out = []
        for p, g in params_grads:
            clipped = block.create_var(unique_name.generate(g.name + "@CLIP"),
                                       stop_gradient=True)
            block.append_op("clip_by_norm", {"X": g}, {"Out": clipped},
                            {"max_norm": self.clip_norm,
                             "op_role": "optimize"})
            out.append((p, clipped))
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

    def _clip_static(self, params_grads, block):
        sq_names = []
        for _, g in params_grads:
            sq = block.create_var(unique_name.generate("gsq"),
                                  stop_gradient=True)
            block.append_op("squared_l2_norm", {"X": g}, {"Out": sq},
                            {"op_role": "optimize"})
            sq_names.append(sq.name)
        total = block.create_var(unique_name.generate("global_norm_sq"),
                                 stop_gradient=True)
        block.append_op("sum", {"X": sq_names}, {"Out": total},
                        {"op_role": "optimize"})
        norm = block.create_var(unique_name.generate("global_norm"),
                                stop_gradient=True)
        block.append_op("sqrt", {"X": total}, {"Out": norm},
                        {"op_role": "optimize"})
        # scale = clip / max(norm, clip)
        maxed = block.create_var(unique_name.generate("norm_max"),
                                 stop_gradient=True)
        clip_v = block.create_var(unique_name.generate("clip_const"),
                                  stop_gradient=True)
        block.append_op("fill_constant_like", {"X": norm}, {"Out": clip_v},
                        {"value": self.clip_norm, "op_role": "optimize"})
        block.append_op("elementwise_max", {"X": norm, "Y": clip_v},
                        {"Out": maxed}, {"op_role": "optimize"})
        scale_var = block.create_var(unique_name.generate("clip_scale"),
                                     stop_gradient=True)
        block.append_op("elementwise_div", {"X": clip_v, "Y": maxed},
                        {"Out": scale_var}, {"op_role": "optimize"})
        out = []
        for p, g in params_grads:
            clipped = block.create_var(unique_name.generate(g.name + "@CLIP"),
                                       stop_gradient=True)
            block.append_op("elementwise_mul", {"X": g, "Y": scale_var},
                            {"Out": clipped},
                            {"axis": -1, "op_role": "optimize"})
            out.append((p, clipped))
        return out


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
        self._eager = params is not None
        self._params = []
        for item in params or ():
            if isinstance(item, _TapeParameter):
                # a tape Parameter: its name, its torch tensor (which
                # carries lr_scale and regularizer; trainable is
                # requires_grad), as the reference's eager step reads it
                item = (item.name, item.value)
            if not (isinstance(item, tuple) and len(item) == 2
                    and isinstance(item[0], str)):
                raise TypeError("parameters= takes tape Parameters or "
                                "(name, parameter) pairs such as "
                                "model.named_parameters(): torch "
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
        # the static half: the Program's lr variable and accumulators
        self._lr_var: Optional[Variable] = None
        self._accum_vars: Dict[str, Dict[str, Variable]] = {}
        self.helper = None

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

    def set_lr(self, value, scope=None):
        """Set a constant learning rate (replacing a scheduler, as the
        reference does), in place: a captured step reads it at its next
        replay. Once :meth:`minimize` made the Program's lr variable, its
        value is written into ``scope`` (the global scope by default), as
        ``optimizer.py:237-243`` does; a captured executor step that
        holds it reads the new value at its next replay."""
        self._learning_rate = float(value)
        self._refresh_lr()
        if self._lr_var is not None:
            from .framework.scope import global_scope
            self._write_lr(scope or global_scope(), float(value))

    def _write_lr(self, scope, value: float):
        old = scope.find_var(self._lr_var.name)
        scope.set_var(self._lr_var.name, torch.tensor(
            [value], dtype=torch.float32,
            device=None if old is None else old.device))

    def sync_lr(self, scope):
        """Push the scheduler's current lr into the scope's lr var (static
        mode). Call after scheduler.step()."""
        sched = getattr(self, "_lr_scheduler", None)
        if sched is not None and self._lr_var is not None:
            self._write_lr(scope, float(sched()))

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
        if not self._params:
            return      # a static-only optimizer keeps no device lr
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

    # -- the static half: Program rewrites -----------------------------------
    def _create_lr_var(self):
        if self._lr_var is not None:
            return self._lr_var
        lr_ = self._learning_rate
        if isinstance(lr_, Variable):
            self._lr_var = lr_
        else:
            if isinstance(lr_, LRScheduler):
                self._lr_scheduler = lr_
                lr_ = lr_()
            self._lr_var = create_global_var(
                shape=[1], value=float(lr_), dtype="float32",
                persistable=True,
                name=unique_name.generate("learning_rate"))
        return self._lr_var

    def get_lr_var(self):
        return self._lr_var

    def _add_accumulator(self, name: str, param: Variable, init_value=0.0,
                         shape=None, dtype=None):
        if name in self._accum_vars and param.name in self._accum_vars[name]:
            return self._accum_vars[name][param.name]
        shape = list(shape if shape is not None else param.shape)
        v = create_global_var(
            shape=shape, value=float(init_value), dtype=dtype or param.dtype,
            persistable=True, name=unique_name.generate(f"{param.name}_{name}"))
        self._accum_vars.setdefault(name, {})[param.name] = v
        return v

    def _get_accumulator(self, name, param):
        return self._accum_vars[name][param.name]

    def _append_regularization(self, params_grads, block):
        out = []
        for p, g in params_grads:
            reg = p.regularizer or self.regularization
            if reg is None:
                out.append((p, g))
                continue
            kind, coeff = (reg if isinstance(reg, tuple)
                           else (reg.kind, reg.coeff))
            if kind == "l2":
                scaled = block.create_var(
                    unique_name.generate(g.name + "@REG"), stop_gradient=True)
                block.append_op("scale", {"X": p}, {"Out": scaled},
                                {"scale": float(coeff),
                                 "op_role": "optimize"})
                merged = block.create_var(
                    unique_name.generate(g.name + "@REGSUM"),
                    stop_gradient=True)
                block.append_op("sum", {"X": [g.name, scaled.name]},
                                {"Out": merged}, {"op_role": "optimize"})
                out.append((p, merged))
            elif kind == "l1":
                sign = block.create_var(
                    unique_name.generate(g.name + "@SIGN"), stop_gradient=True)
                block.append_op("sign", {"X": p}, {"Out": sign},
                                {"op_role": "optimize"})
                scaled = block.create_var(
                    unique_name.generate(g.name + "@REG"), stop_gradient=True)
                block.append_op("scale", {"X": sign}, {"Out": scaled},
                                {"scale": float(coeff),
                                 "op_role": "optimize"})
                merged = block.create_var(
                    unique_name.generate(g.name + "@REGSUM"),
                    stop_gradient=True)
                block.append_op("sum", {"X": [g.name, scaled.name]},
                                {"Out": merged}, {"op_role": "optimize"})
                out.append((p, merged))
            else:
                raise ValueError(f"unknown regularizer kind {kind!r}")
        return out

    def _append_optimize_op(self, block, param_and_grad):
        raise NotImplementedError(
            f"{type(self).__name__} has no static update op")

    def _create_accumulators(self, block, parameters):
        pass

    def _finish_update(self, block, params_grads):
        pass

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, checkpoints=None):
        return append_backward(loss, parameter_list=parameter_list,
                               no_grad_set=no_grad_set,
                               checkpoints=checkpoints)

    def apply_gradients(self, params_grads, startup_program=None):
        # the program that owns the parameters, and the startup program
        # passed in or the one the main program was built against
        from .framework.program import program_guard
        program = params_grads[0][0].block.program if params_grads \
            else default_main_program()
        startup = startup_program or getattr(program, "_startup_ref", None)
        with program_guard(program, startup):
            block = program.global_block()
            if self._grad_clip is not None:
                params_grads = self._grad_clip._clip_static(params_grads,
                                                            block)
            params_grads = self._append_regularization(params_grads, block)
            self._create_lr_var()
            self._create_accumulators(block, [p for p, _ in params_grads])
            ops = []
            for p_g in params_grads:
                ops.append(self._append_optimize_op(block, p_g))
            self._finish_update(block, params_grads)
        return ops

    def apply_optimize(self, loss, startup_program, params_grads):
        return self.apply_gradients(params_grads, startup_program)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        params_grads = self.backward(loss, startup_program, parameter_list,
                                     no_grad_set)
        opt_ops = self.apply_gradients(params_grads, startup_program)
        return opt_ops, params_grads

    def _lr_input(self, param) -> Variable:
        """Per-param lr (honors ParamAttr.learning_rate scale)."""
        lr_ = self._create_lr_var()
        scale = getattr(param, "lr_scale", 1.0)
        if scale == 1.0:
            return lr_
        block = default_main_program().global_block()
        scaled = block.create_var(
            unique_name.generate(f"{param.name}_lr"), stop_gradient=True,
            persistable=False)
        block.append_op("scale", {"X": lr_}, {"Out": scaled},
                        {"scale": float(scale), "op_role": "optimize"})
        return scaled

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
        if not self._eager:
            raise ValueError(f"{type(self).__name__}: eager step() requires "
                             "parameters= (name, parameter) pairs, e.g. "
                             "model.named_parameters()")
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

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        return block.append_op(
            "sgd", {"Param": p, "Grad": g,
                    "LearningRate": self._lr_input(p)},
            {"ParamOut": p}, {"op_role": "optimize"})


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

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("velocity", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        v = self._get_accumulator("velocity", p)
        return block.append_op(
            "momentum",
            {"Param": p, "Grad": g, "Velocity": v,
             "LearningRate": self._lr_input(p)},
            {"ParamOut": p, "VelocityOut": v},
            {"mu": self._momentum, "use_nesterov": self._use_nesterov,
             "op_role": "optimize"})


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

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("velocity", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        v = self._get_accumulator("velocity", p)
        return block.append_op(
            "lars_momentum",
            {"Param": p, "Grad": g, "Velocity": v,
             "LearningRate": self._lr_input(p)},
            {"ParamOut": p, "VelocityOut": v},
            {"mu": self._momentum, "lars_coeff": self._lars_coeff,
             "lars_weight_decay": self._lars_weight_decay,
             "op_role": "optimize"})


class AdagradOptimizer(Optimizer):
    _op = "adagrad"
    _accums = (("moment", 0.0, None),)

    def __init__(self, learning_rate, epsilon=1e-6, **kw):
        super().__init__(learning_rate, **kw)
        self._epsilon = epsilon

    def _apply(self, p, g, accs, lr_):
        return ops.adagrad(p, g, *accs, lr_, self._epsilon)

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        m = self._get_accumulator("moment", p)
        return block.append_op(
            "adagrad",
            {"Param": p, "Grad": g, "Moment": m,
             "LearningRate": self._lr_input(p)},
            {"ParamOut": p, "MomentOut": m},
            {"epsilon": self._epsilon, "op_role": "optimize"})


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

    # -- the static op ------------------------------------------------------
    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment1", p)
            self._add_accumulator("moment2", p)
            self._add_accumulator("beta1_pow", p, init_value=1.0, shape=[1])
            self._add_accumulator("beta2_pow", p, init_value=1.0, shape=[1])

    def _extra_attrs(self):
        return {}

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        attrs = {"beta1": self._beta1, "beta2": self._beta2,
                 "epsilon": self._epsilon, "op_role": "optimize"}
        attrs.update(self._extra_attrs())
        acc = {k: self._get_accumulator(k, p)
               for k in ("moment1", "moment2", "beta1_pow", "beta2_pow")}
        return block.append_op(
            self._op,
            {"Param": p, "Grad": g,
             "Moment1": acc["moment1"], "Moment2": acc["moment2"],
             "Beta1Pow": acc["beta1_pow"], "Beta2Pow": acc["beta2_pow"],
             "LearningRate": self._lr_input(p)},
            {"ParamOut": p,
             "Moment1Out": acc["moment1"], "Moment2Out": acc["moment2"],
             "Beta1PowOut": acc["beta1_pow"],
             "Beta2PowOut": acc["beta2_pow"]},
            attrs)


class AdamWOptimizer(AdamOptimizer):
    """Adam with decoupled weight decay ``coeff`` applied to every
    parameter (LayerNorm and biases included), with Paddle's update
    (:func:`~.ops.optimizer_ops.adamw`); regularizers are not applied,
    as in the reference."""

    _op = "adamw"

    def __init__(self, learning_rate=0.001, weight_decay=0.01, **kw):
        super().__init__(learning_rate, **kw)
        self._coeff = float(weight_decay)

    def _extra_attrs(self):
        return {"coeff": self._coeff, "with_decay": True}


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

    def _extra_attrs(self):
        return {"weight_decay": self._weight_decay}


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

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("mean_square", p)
            self._add_accumulator("moment", p)
            if self._centered:
                self._add_accumulator("mean_grad", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        ins = {"Param": p, "Grad": g,
               "MeanSquare": self._get_accumulator("mean_square", p),
               "Moment": self._get_accumulator("moment", p),
               "LearningRate": self._lr_input(p)}
        outs = {"ParamOut": p,
                "MeanSquareOut": self._get_accumulator("mean_square", p),
                "MomentOut": self._get_accumulator("moment", p)}
        if self._centered:
            ins["MeanGrad"] = self._get_accumulator("mean_grad", p)
            outs["MeanGradOut"] = self._get_accumulator("mean_grad", p)
        return block.append_op(
            "rmsprop", ins, outs,
            {"decay": self._rho, "epsilon": self._epsilon,
             "momentum": self._momentum, "centered": self._centered,
             "op_role": "optimize"})


class FtrlOptimizer(Optimizer):
    _op = "ftrl"
    _accums = (("sq", 0.0, None), ("lin", 0.0, None))

    def __init__(self, learning_rate, l1=0.0, l2=0.0, lr_power=-0.5, **kw):
        super().__init__(learning_rate, **kw)
        self._l1, self._l2, self._lr_power = l1, l2, lr_power

    def _apply(self, p, g, accs, lr_):
        return ops.ftrl(p, g, *accs, lr_, self._l1, self._l2,
                        self._lr_power)

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("squared", p)
            self._add_accumulator("linear", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        return block.append_op(
            "ftrl",
            {"Param": p, "Grad": g,
             "SquaredAccumulator": self._get_accumulator("squared", p),
             "LinearAccumulator": self._get_accumulator("linear", p),
             "LearningRate": self._lr_input(p)},
            {"ParamOut": p,
             "SquaredAccumOut": self._get_accumulator("squared", p),
             "LinearAccumOut": self._get_accumulator("linear", p)},
            {"l1": self._l1, "l2": self._l2, "lr_power": self._lr_power,
             "op_role": "optimize"})


class RecomputeOptimizer(Optimizer):
    """Activation-recompute wrapper (``optimizer.py:709``, fluid
    ``optimizer.py:4518``)::

        opt = RecomputeOptimizer(SGDOptimizer(0.1))
        opt._set_checkpoints([h1, h2])
        opt.minimize(loss)

    backward() runs the checkpointed rewrite (``append_backward``'s
    ``checkpoints=``): the forward ops between checkpoints are cloned
    into the backward behind ``optimization_barrier`` ops, so only the
    checkpoints stay live across the forward — the executor's liveness
    (:func:`~paddle_tpu_torch.framework.executor.plan_drops`) frees the
    rest, as XLA's does in the reference: FLOPs traded for memory.
    """

    def __init__(self, inner_optimizer: Optimizer):
        self._inner = inner_optimizer
        self._checkpoints = None

    def _set_checkpoints(self, checkpoints):
        self._checkpoints = list(checkpoints)

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, checkpoints=None):
        return self._inner.backward(
            loss, startup_program, parameter_list, no_grad_set,
            checkpoints=checkpoints or self._checkpoints)

    def apply_gradients(self, params_grads, startup_program=None):
        return self._inner.apply_gradients(params_grads, startup_program)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        if not self._checkpoints:
            raise ValueError(
                "RecomputeOptimizer: call _set_checkpoints() first")
        params_grads = self.backward(loss, startup_program, parameter_list,
                                     no_grad_set)
        opt_ops = self.apply_gradients(params_grads, startup_program)
        return opt_ops, params_grads


class PipelineOptimizer:
    """Pipeline-parallel wrapper (``optimizer.py:753``, fluid
    ``optimizer.py:3666``)::

        with device_guard("gpu:0"): ...first half...
        with device_guard("gpu:1"): ...second half + loss...
        opt = PipelineOptimizer(SGDOptimizer(0.1), num_microbatches=4)
        opt.minimize(loss)
        runner = opt.runner()           # GPipe schedule
        runner.run(exe, scope, microbatch_feeds, fetch_list=[loss.name])

    minimize() builds the ordinary joint program (backward and optimizer
    ops inherit their forward op's ``op_device``), then splits it into
    per-stage forward/backward/optimize phase programs with microbatch
    gradient accumulation
    (:mod:`~paddle_tpu_torch.distributed.fleet.pipeline`).
    """

    def __init__(self, optimizer, num_microbatches: int = 1):
        self._inner = optimizer
        self._num_microbatches = int(num_microbatches)
        self._stages = None

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        opt_ops, params_grads = self._inner.minimize(
            loss, startup_program, parameter_list, no_grad_set)
        from .distributed.fleet.pipeline import split_pipeline_program
        program = loss.block.program
        self._stages = split_pipeline_program(program,
                                              self._num_microbatches)
        program._pipeline_stages = self._stages
        program._pipeline_num_microbatches = self._num_microbatches
        return opt_ops, params_grads

    def runner(self, devices=None, schedule: str = "gpipe"):
        """Build the microbatch runner. ``devices`` (``"cuda:0"``, a
        ``torch.device``, ``"cpu"``) gives each stage's phase programs
        an executor of their own there; ``schedule`` is "gpipe" or
        "1f1b"."""
        from .distributed.fleet.pipeline import PipelineRunner
        if self._stages is None:
            raise ValueError("call minimize() before runner()")
        return PipelineRunner(self._stages, self._num_microbatches,
                              devices=devices, schedule=schedule)


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


# ---------------------------------------------------------------------------
# Weight-averaging / slow-weight wrappers (optimizer.py:832-1104; fluid
# optimizer.py:3107 ModelAverage, :3416 ExponentialMovingAverage, :4828
# LookaheadOptimizer)
# ---------------------------------------------------------------------------


def _trainable_params(program):
    return [v for v in program.global_block().vars.values()
            if getattr(v, "is_parameter", False)
            and not getattr(v, "stop_gradient", False)]


def _append_shadow_init(startup, param_name, shadow_name):
    """startup: shadow <- param (runs after the param's own init op)."""
    sblk = startup.global_block()
    sblk.create_var(shadow_name, persistable=True, stop_gradient=True)
    sblk.append_op("assign", {"X": [param_name]}, {"Out": [shadow_name]},
                   {})


def _int_counter(program, startup, name: str):
    """Persistable int64 step counter initialized to 0 (int64 so the
    count never saturates the way a float32 would at 2^24)."""
    blk = program.global_block()
    cname = unique_name.generate(name)
    blk.create_var(cname, persistable=True, stop_gradient=True)
    sblk = startup.global_block()
    sblk.create_var(cname, persistable=True, stop_gradient=True)
    sblk.append_op("fill_constant", {}, {"Out": [cname]},
                   {"shape": [1], "value": 0, "dtype": "int64"})
    return cname


class _ScopeSwapMixin:
    """Shared apply/restore scaffolding: swap params for derived values
    in a scope, restore on exit (the EMA/ModelAverage protocol).

    The backups are clones: the reference keeps ``scope.find_var(p)``,
    an immutable array, but the port's scope tensor of a parameter that
    a captured step holds stays that step's tensor, and ``set_var``
    copies the swapped value into it — a backup that were the tensor
    itself would then hold the average, and ``restore`` would copy the
    tensor onto itself."""

    _pairs: list  # (param name, aux var name)
    _backup: dict

    def _swap_value(self, scope, param_name, aux_name):
        raise NotImplementedError

    def apply(self, scope=None, need_restore: bool = True):
        import contextlib

        from .framework.scope import global_scope
        scope = scope or global_scope()

        @contextlib.contextmanager
        def _ctx():
            self._backup = {p: scope.find_var(p).clone()
                            for p, _ in self._pairs}
            for p, a in self._pairs:
                scope.set_var(p, self._swap_value(scope, p, a))
            try:
                yield self
            finally:
                if need_restore:
                    self.restore(scope)
        return _ctx()

    def restore(self, scope=None):
        from .framework.scope import global_scope
        scope = scope or global_scope()
        for p, v in self._backup.items():
            scope.set_var(p, v)
        self._backup = {}


class ExponentialMovingAverage(_ScopeSwapMixin):
    """EMA shadow weights, updated in-graph
    (``optimizer.py:895``, fluid ``optimizer.py:3416``).

    >>> ema = ExponentialMovingAverage(0.999)
    >>> opt.minimize(loss); ema.update()        # build once
    >>> with ema.apply(scope):                  # eval with EMA weights
    ...     exe.run(test_program, ...)
    """

    def __init__(self, decay: float = 0.999, name: Optional[str] = None):
        self._decay = float(decay)
        self._name = name or "ema"
        self._pairs = []          # (param name, ema var name)
        self._backup = {}

    def update(self):
        """Append ema = decay*ema + (1-decay)*param for every trainable
        param of the current main program; shadow init rides the
        startup program (run startup after calling this)."""
        program = default_main_program()
        startup = default_startup_program()
        blk = program.global_block()
        for p in _trainable_params(program):
            ema_name = unique_name.generate(f"{p.name}.{self._name}")
            blk.create_var(ema_name, persistable=True,
                           stop_gradient=True)
            _append_shadow_init(startup, p.name, ema_name)
            scaled_e = unique_name.generate(f"{ema_name}.sc")
            blk.create_var(scaled_e, stop_gradient=True)
            blk.append_op("scale", {"X": [ema_name]}, {"Out": [scaled_e]},
                          {"scale": self._decay, "op_role": "optimize"})
            scaled_p = unique_name.generate(f"{p.name}.sc")
            blk.create_var(scaled_p, stop_gradient=True)
            blk.append_op("scale", {"X": [p.name]}, {"Out": [scaled_p]},
                          {"scale": 1.0 - self._decay,
                           "op_role": "optimize"})
            blk.append_op("sum", {"X": [scaled_e, scaled_p]},
                          {"Out": [ema_name]}, {"op_role": "optimize"})
            self._pairs.append((p.name, ema_name))
        return self

    def _swap_value(self, scope, param_name, aux_name):
        # a copy: a parameter rebound to the shadow's own tensor would
        # alias it (a later in-place write to one moves the other)
        return scope.find_var(aux_name).clone()


class ModelAverage(_ScopeSwapMixin):
    """Windowed parameter average, accumulated in-graph
    (``optimizer.py:941``, fluid ``optimizer.py:3107``). The reference
    rotates three partial sums; here the window restarts whenever the
    accumulated count reaches ``max_average_window`` — same estimator
    family (average over the most recent training tail), branch-free
    IR. ``average_window_rate``/``min_average_window`` are accepted for
    signature parity; the restart policy is driven by
    ``max_average_window`` alone. The average that ``apply`` swaps in
    is divided on the device (the reference divides on the host)."""

    def __init__(self, average_window_rate: float = 0.15,
                 min_average_window: int = 10000,
                 max_average_window: int = 10000):
        self._max_window = int(max_average_window)
        self._pairs = []          # (param, sum var)
        self._num_name = None
        self._backup = {}

    def update(self):
        program = default_main_program()
        startup = default_startup_program()
        blk = program.global_block()

        def ap(type_, ins, outs, attrs=None):
            blk.append_op(type_, ins, outs,
                          dict(attrs or {}, op_role="optimize"))

        def tmp(base, **kw):
            name = unique_name.generate(base)
            blk.create_var(name, stop_gradient=True, **kw)
            return name

        self._num_name = _int_counter(program, startup,
                                      "model_average.num")
        ap("increment", {"X": [self._num_name]},
           {"Out": [self._num_name]}, {"step": 1})
        # reset mask: 1.0 when the window is full (num == max_window)
        maxc = tmp("ma.max")
        ap("fill_constant_like", {"X": [self._num_name]}, {"Out": [maxc]},
           {"value": float(self._max_window)})
        eq = tmp("ma.eq")
        ap("equal", {"X": [self._num_name], "Y": [maxc]}, {"Out": [eq]},
           {})
        maskf = tmp("ma.maskf")
        ap("cast", {"X": [eq]}, {"Out": [maskf]},
           {"in_dtype": "bool", "out_dtype": "float32"})
        inv = tmp("ma.inv")
        ap("scale", {"X": [maskf]}, {"Out": [inv]},
           {"scale": -1.0, "bias": 1.0})
        # num <- num*(1-mask) + mask  (restart counts the current step)
        maski = tmp("ma.maski")
        ap("cast", {"X": [eq]}, {"Out": [maski]},
           {"in_dtype": "bool", "out_dtype": "int64"})
        invi = tmp("ma.invi")
        ap("scale", {"X": [maski]}, {"Out": [invi]},
           {"scale": -1, "bias": 1})
        kept = tmp("ma.kept")
        ap("elementwise_mul", {"X": [self._num_name], "Y": [invi]},
           {"Out": [kept]}, {"axis": -1})
        ap("sum", {"X": [kept, maski]}, {"Out": [self._num_name]}, {})
        for p in _trainable_params(program):
            sum_name = unique_name.generate(f"{p.name}.avg_sum")
            blk.create_var(sum_name, persistable=True,
                           stop_gradient=True)
            sblk = startup.global_block()
            sblk.create_var(sum_name, persistable=True,
                            stop_gradient=True)
            sblk.append_op("scale", {"X": [p.name]}, {"Out": [sum_name]},
                           {"scale": 0.0})
            acc = tmp(f"{p.name}.avg_acc")
            ap("sum", {"X": [sum_name, p.name]}, {"Out": [acc]}, {})
            # sum <- acc*(1-mask) + p*mask  (window restart)
            keep = tmp(f"{p.name}.avg_keep")
            ap("elementwise_mul", {"X": [acc], "Y": [inv]},
               {"Out": [keep]}, {"axis": -1})
            fresh = tmp(f"{p.name}.avg_fresh")
            ap("elementwise_mul", {"X": [p.name], "Y": [maskf]},
               {"Out": [fresh]}, {"axis": -1})
            ap("sum", {"X": [keep, fresh]}, {"Out": [sum_name]}, {})
            self._pairs.append((p.name, sum_name))
        return self

    def _swap_value(self, scope, param_name, aux_name):
        # sum / max(n, 1) as the reference's numpy divides a float32
        # array by a float: one float32 division, here on the device
        total = scope.find_var(aux_name)
        n = scope.find_var(self._num_name).reshape(-1)[:1]
        return total / torch.clamp(n.to(total.dtype), min=1.0)


class LookaheadOptimizer:
    """Lookahead slow/fast weights (``optimizer.py:1030``, fluid
    ``optimizer.py:4828``): every k steps slow += alpha * (fast - slow);
    fast <- slow. Branch-free IR (the k-step condition rides the shared
    every-k gate, no cond). Slow weights exist only for the params the
    inner optimizer actually updates (parameter_list respected)."""

    def __init__(self, inner_optimizer, alpha: float = 0.5, k: int = 5):
        self.inner_optimizer = inner_optimizer
        self.alpha = float(alpha)
        self.k = int(k)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        result = self.inner_optimizer.minimize(
            loss, startup_program, parameter_list, no_grad_set)
        _, params_grads = result
        program = loss.block.program
        startup = startup_program or getattr(program, "_startup_ref",
                                             None) or \
            default_startup_program()
        from .distributed.fleet.fleet_base import _emit_every_k_gate
        from .framework.program import program_guard
        with program_guard(program, startup):
            blk = program.global_block()
            step = _int_counter(program, startup, "lookahead.step")
            gate_b = _emit_every_k_gate(blk, step, self.k, "optimize")
            mask = unique_name.generate("lookahead.mask")
            blk.create_var(mask, stop_gradient=True)
            blk.append_op("cast", {"X": [gate_b]}, {"Out": [mask]},
                          {"in_dtype": "bool", "out_dtype": "float32",
                           "op_role": "optimize"})
            for p, _g in params_grads:
                slow = unique_name.generate(f"{p.name}.slow")
                blk.create_var(slow, persistable=True,
                               stop_gradient=True)
                _append_shadow_init(startup, p.name, slow)

                def tmp(base):
                    name = unique_name.generate(base)
                    blk.create_var(name, stop_gradient=True)
                    return name
                diff = tmp(f"{p.name}.la_diff")
                blk.append_op("elementwise_sub",
                              {"X": [p.name], "Y": [slow]},
                              {"Out": [diff]}, {"op_role": "optimize"})
                stepv = tmp(f"{p.name}.la_step")
                blk.append_op("scale", {"X": [diff]}, {"Out": [stepv]},
                              {"scale": self.alpha,
                               "op_role": "optimize"})
                masked = tmp(f"{p.name}.la_masked")
                blk.append_op("elementwise_mul",
                              {"X": [stepv], "Y": [mask]},
                              {"Out": [masked]},
                              {"axis": -1, "op_role": "optimize"})
                blk.append_op("sum", {"X": [slow, masked]},
                              {"Out": [slow]}, {"op_role": "optimize"})
                # fast <- mask*slow + (1-mask)*fast
                ps = tmp(f"{p.name}.la_ps")
                blk.append_op("elementwise_sub",
                              {"X": [slow], "Y": [p.name]},
                              {"Out": [ps]}, {"op_role": "optimize"})
                psm = tmp(f"{p.name}.la_psm")
                blk.append_op("elementwise_mul",
                              {"X": [ps], "Y": [mask]},
                              {"Out": [psm]},
                              {"axis": -1, "op_role": "optimize"})
                blk.append_op("sum", {"X": [p.name, psm]},
                              {"Out": [p.name]},
                              {"op_role": "optimize"})
        return result


EMA = ExponentialMovingAverage
Lookahead = LookaheadOptimizer
