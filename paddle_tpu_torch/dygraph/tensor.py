"""Eager Tensor — the counterpart of ``paddle_tpu/dygraph/tensor.py``.

A :class:`Tensor` holds a ``torch.Tensor`` (``.value``) and the
reference's autograd fields: ``stop_gradient`` (True by default for raw
data), ``is_leaf``, ``name`` and ``grad``. Ops dispatch through
:func:`~paddle_tpu_torch.dygraph.tape.run_op`, which runs the port's
registry lowering and records onto torch autograd (the tape's docstring
has the design). A leaf with ``stop_gradient=False`` is a torch leaf
that requires grad, so ``grad`` wraps ``value.grad``.

Where the reference rebinds its immutable array, the port writes in
place: :meth:`Tensor.set_value` copies into the held tensor under
``no_grad``, so a captured step or an optimizer that holds the tensor
sees the new value.
"""

from __future__ import annotations

import itertools
from typing import Optional

import numpy as np
import torch

from ..device import capturing, resolve_device
from ..framework.program import convert_dtype
from ..ops.registry import TORCH_DTYPES

_uid = itertools.count(1)


def _next_uid() -> str:
    return f"t{next(_uid)}"


def _torch_dtype(dtype) -> torch.dtype:
    return TORCH_DTYPES[convert_dtype(dtype)]


def _as_value(value, dtype=None, device=None) -> torch.Tensor:
    """``value`` as a torch tensor: a tensor stays where it is (moved
    only when ``device`` is given); anything else is made on ``device``
    (None: the card; raises without one). Python floats become float32,
    Paddle's default float, where numpy would give float64; numpy
    arrays keep their dtype."""
    if isinstance(value, Tensor):
        value = value.value
    if isinstance(value, torch.Tensor):
        v = value if device is None else value.to(torch.device(device))
        return v if dtype is None else v.to(_torch_dtype(dtype))
    dev = resolve_device(device)
    arr = np.asarray(value)
    if dtype is None and arr.dtype == np.float64 and \
            not isinstance(value, (np.ndarray, np.generic)):
        dtype = "float32"
    # a copy: the Tensor never shares the caller's array
    t = torch.tensor(arr)
    return t.to(dev) if dtype is None else t.to(dev, _torch_dtype(dtype))


def _run_op(op_type, ins, attrs):
    from .tape import run_op
    return run_op(op_type, ins, attrs)


def _reduce_attrs(axis, keepdim):
    attrs = {"keep_dim": keepdim}
    if axis is None:
        attrs["reduce_all"] = True
    else:
        attrs["dim"] = [axis] if isinstance(axis, int) else list(axis)
    return attrs


class Tensor:
    """Eager tensor. ``stop_gradient=True`` (default for raw data)
    excludes it from autograd, as the reference's VarBase does.
    ``device`` (keyword-only) places non-tensor data: None is the card."""

    def __init__(self, value, dtype=None, stop_gradient: bool = True,
                 name: Optional[str] = None, *, device=None):
        self.value = _as_value(value, dtype, device)
        if self.value.requires_grad or self.value.grad_fn is not None:
            self.value = self.value.detach()
        self.name = name or _next_uid()
        self.is_leaf = True
        self.persistable = False
        # the autograd output backward() and grad() start from: the
        # value of a recorded op's output (None on a leaf, and after a
        # backward that freed the graph)
        self._root = None
        self._stop_gradient = True
        self.stop_gradient = stop_gradient

    @classmethod
    def _wrap(cls, value: torch.Tensor) -> "Tensor":
        """A tensor around an op's output, without a copy."""
        t = cls.__new__(cls)
        t.value = value
        t.name = _next_uid()
        t.is_leaf = True
        t.persistable = False
        t._root = None
        t._stop_gradient = True
        return t

    # -- autograd fields ---------------------------------------------------
    @property
    def stop_gradient(self) -> bool:
        return self._stop_gradient

    @stop_gradient.setter
    def stop_gradient(self, value: bool):
        value = bool(value)
        if self.is_leaf:
            if self.value.is_floating_point() or self.value.is_complex():
                self.value.requires_grad_(not value)
        elif value and self.value.requires_grad:
            # later ops read a value cut from the graph; backward() and
            # grad() from this tensor itself still start at _root
            self.value = self.value.detach()
        self._stop_gradient = value

    @property
    def grad(self) -> Optional["Tensor"]:
        g = self.value.grad if self.is_leaf else None
        if g is None:
            return getattr(self, "_int_grad", None)
        return Tensor._wrap(g)

    @grad.setter
    def grad(self, value):
        if value is None:
            self.value.grad = None
            self._int_grad = None
            return
        g = value.value if isinstance(value, Tensor) else value
        if self.value.is_floating_point():
            self.value.grad = g
        else:
            self._int_grad = Tensor._wrap(g)

    # -- basic properties --------------------------------------------------
    @property
    def shape(self):
        return list(self.value.shape)

    @property
    def ndim(self):
        return self.value.dim()

    @property
    def dtype(self):
        return convert_dtype(self.value.dtype)

    @property
    def size(self):
        return int(self.value.numel()) if self.value.dim() else 1

    def numpy(self) -> np.ndarray:
        """A copy of the value (bfloat16 as float32, which numpy lacks)."""
        v = self.value.detach()
        if v.dtype == torch.bfloat16:
            v = v.float()
        return v.cpu().numpy().copy() if v.device.type == "cpu" else \
            v.cpu().numpy()

    def item(self):
        return self.numpy().item()

    def numel(self):
        return self.size

    def detach(self) -> "Tensor":
        return Tensor._wrap(self.value.detach())

    def clone(self) -> "Tensor":
        return _run_op("assign", {"X": [self]}, {})["Out"][0]

    def astype(self, dtype) -> "Tensor":
        return _run_op("cast", {"X": [self]},
                       {"out_dtype": convert_dtype(dtype),
                        "in_dtype": self.dtype})["Out"][0]

    def clear_grad(self):
        self.grad = None

    def clear_gradient(self):
        self.grad = None

    def set_value(self, value):
        """Copy ``value`` into the held tensor under ``no_grad`` (the
        port's state-in-place rule), in this tensor's dtype; a value of
        another shape replaces the tensor."""
        if isinstance(value, Tensor):
            value = value.value
        with torch.no_grad():
            src = value if isinstance(value, torch.Tensor) else \
                torch.tensor(np.asarray(value))
            if tuple(src.shape) == tuple(self.value.shape):
                self.value.copy_(src)
                return
            new = src.to(self.value.device, self.value.dtype).clone()
        new.requires_grad_(self.value.requires_grad)
        self.value = new

    def backward(self, grad_tensor: Optional["Tensor"] = None,
                 retain_graph: bool = False):
        from .tape import default_tracer
        default_tracer().backward(self, grad_tensor, retain_graph)

    # -- operators ---------------------------------------------------------
    def _binop(self, other, op_type, reverse=False):
        if not isinstance(other, Tensor):
            other = Tensor(torch.as_tensor(np.asarray(other)).to(
                self.value.device, self.value.dtype))
        x, y = (other, self) if reverse else (self, other)
        return _run_op(op_type, {"X": [x], "Y": [y]}, {})["Out"][0]

    def __add__(self, o):
        return self._binop(o, "elementwise_add")

    __radd__ = __add__

    def __sub__(self, o):
        return self._binop(o, "elementwise_sub")

    def __rsub__(self, o):
        return self._binop(o, "elementwise_sub", reverse=True)

    def __mul__(self, o):
        return self._binop(o, "elementwise_mul")

    __rmul__ = __mul__

    def __truediv__(self, o):
        return self._binop(o, "elementwise_div")

    def __rtruediv__(self, o):
        return self._binop(o, "elementwise_div", reverse=True)

    def __pow__(self, o):
        return self._binop(o, "elementwise_pow")

    def __matmul__(self, o):
        return _run_op("matmul_v2", {"X": [self], "Y": [o]}, {})["Out"][0]

    def __neg__(self):
        return _run_op("scale", {"X": [self]}, {"scale": -1.0})["Out"][0]

    def __lt__(self, o):
        return self._binop(o, "less_than")

    def __le__(self, o):
        return self._binop(o, "less_equal")

    def __gt__(self, o):
        return self._binop(o, "greater_than")

    def __ge__(self, o):
        return self._binop(o, "greater_equal")

    def __getitem__(self, idx):
        # plain slices go through the slice op (differentiable); advanced
        # indexing is read detached, as in the reference
        if isinstance(idx, (int, slice)) or (
                isinstance(idx, tuple)
                and all(isinstance(i, (int, slice)) for i in idx)):
            idxs = idx if isinstance(idx, tuple) else (idx,)
            axes, starts, ends, decrease = [], [], [], []
            ok = True
            for ax, i in enumerate(idxs):
                if isinstance(i, int):
                    d = self.value.shape[ax]
                    ii = i + d if i < 0 else i
                    axes.append(ax)
                    starts.append(ii)
                    ends.append(ii + 1)
                    decrease.append(ax)
                elif isinstance(i, slice):
                    if i.step not in (None, 1):
                        ok = False
                        break
                    if i.start is None and i.stop is None:
                        continue
                    d = self.value.shape[ax]
                    axes.append(ax)
                    starts.append(0 if i.start is None else i.start)
                    ends.append(d if i.stop is None else i.stop)
            if ok:
                return _run_op("slice", {"X": [self]},
                               {"axes": axes, "starts": starts, "ends": ends,
                                "decrease_axis": decrease})["Out"][0]
        if isinstance(idx, Tensor):
            idx = idx.value
        elif isinstance(idx, tuple):
            idx = tuple(i.value if isinstance(i, Tensor) else i for i in idx)
        return Tensor._wrap(self.value.detach()[idx])

    # -- common methods ----------------------------------------------------
    def reshape(self, shape):
        return _run_op("reshape2", {"X": [self]},
                       {"shape": list(shape)})["Out"][0]

    def transpose(self, perm):
        return _run_op("transpose2", {"X": [self]},
                       {"axis": list(perm)})["Out"][0]

    def flatten(self, start_axis=0, stop_axis=-1):
        return _run_op("flatten_contiguous_range", {"X": [self]},
                       {"start_axis": start_axis,
                        "stop_axis": stop_axis})["Out"][0]

    def sum(self, axis=None, keepdim=False):
        return _run_op("reduce_sum", {"X": [self]},
                       _reduce_attrs(axis, keepdim))["Out"][0]

    def mean(self, axis=None, keepdim=False):
        return _run_op("reduce_mean", {"X": [self]},
                       _reduce_attrs(axis, keepdim))["Out"][0]

    def max(self, axis=None, keepdim=False):
        return _run_op("reduce_max", {"X": [self]},
                       _reduce_attrs(axis, keepdim))["Out"][0]

    def unsqueeze(self, axis):
        axes = [axis] if isinstance(axis, int) else list(axis)
        return _run_op("unsqueeze2", {"X": [self]}, {"axes": axes})["Out"][0]

    def squeeze(self, axis=None):
        axes = [] if axis is None else (
            [axis] if isinstance(axis, int) else list(axis))
        return _run_op("squeeze2", {"X": [self]}, {"axes": axes})["Out"][0]

    def cast(self, dtype):
        return self.astype(dtype)

    def __len__(self):
        return self.value.shape[0] if self.value.dim() else 0

    # -- python scalar protocol ---------------------------------------------
    # Eagerly these behave like the reference's VarBase scalar coercions.
    # While the current stream captures a CUDA graph (jit.to_static) a
    # coercion would read back a value the graph has not computed yet and
    # bake ONE branch of data-dependent Python control flow into the
    # graph, so it raises, as the reference raises under a trace.

    def _concrete(self, what):
        if capturing():
            raise TypeError(
                f"cannot convert a traced Tensor to a python {what} inside "
                "jit.to_static: data-dependent `if`/`while` on tensor "
                "values would silently compile only the branch taken "
                "during tracing. Use layers.cond / layers.while_loop for "
                "captured control flow, or compute this value outside the "
                "to_static function.")
        return self.value.detach()

    def __bool__(self):
        return bool(self._concrete("bool"))

    def __int__(self):
        return int(self._concrete("int"))

    def __float__(self):
        return float(self._concrete("float"))

    def __index__(self):
        return int(self._concrete("index"))

    def __repr__(self):
        grad_txt = "" if self.stop_gradient else ", stop_gradient=False"
        return (f"Tensor(shape={self.shape}, dtype={self.dtype}{grad_txt},\n"
                f"       {self.numpy()!r})")


class Parameter(Tensor):
    """Trainable leaf tensor. ``trainable`` is ``not stop_gradient``;
    ``lr_scale`` and ``regularizer`` live on the held torch tensor as
    attributes of the same names, where the port's optimizers read a
    parameter's (``optimizer.py``)."""

    def __init__(self, value, name=None, trainable: bool = True, *,
                 device=None):
        super().__init__(value, stop_gradient=not trainable, name=name,
                         device=device)
        self.persistable = True
        self.regularizer = None
        self.lr_scale = 1.0

    @property
    def trainable(self) -> bool:
        return not self.stop_gradient

    @trainable.setter
    def trainable(self, value: bool):
        self.stop_gradient = not value

    @property
    def lr_scale(self) -> float:
        return getattr(self.value, "lr_scale", 1.0)

    @lr_scale.setter
    def lr_scale(self, value: float):
        self.value.lr_scale = value

    @property
    def regularizer(self):
        return getattr(self.value, "regularizer", None)

    @regularizer.setter
    def regularizer(self, value):
        self.value.regularizer = value


def to_tensor(data, dtype=None, stop_gradient: bool = True, *,
              device=None) -> Tensor:
    """A leaf Tensor of ``data`` on ``device`` (None: the card; raises
    without one)."""
    if isinstance(data, Tensor):
        data = data.value
    if isinstance(data, torch.Tensor) and device is None:
        device = data.device
    return Tensor(data, dtype=dtype, stop_gradient=stop_gradient,
                  device=resolve_device(device))


to_variable = to_tensor
