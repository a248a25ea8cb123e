"""Eager AMP autocast — the counterpart of ``paddle_tpu/amp/auto_cast.py``.

Under ``auto_cast(level="O1")`` white-list ops cast their floating
inputs to bf16 and black-list ops cast them back to float32; under
``"O2"`` every op outside the black list casts its floating inputs to
bf16. The port's functions call :func:`autocast_inputs` with the
op type the JAX package records for the same computation, so the two
packages round at the same places (``torch.autocast`` keeps other lists
and would not). The casts are ``Tensor.to``, which is differentiable:
float32 master parameters receive float32 gradients. The level is
per thread, as ``torch.autocast``'s is. The tape
(:mod:`~paddle_tpu_torch.dygraph.tape`) casts an op's Tensors through
:func:`maybe_autocast_inputs`, with the reference's cast ops.
"""

from __future__ import annotations

import contextlib
import threading

import torch

from .lists import BLACK_LIST, WHITE_LIST

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16}
_state = threading.local()


def amp_state():
    """``(level, dtype)`` in force on this thread: ("O0", bf16) outside
    any ``auto_cast``."""
    return (getattr(_state, "level", "O0"),
            getattr(_state, "dtype", torch.bfloat16))


@contextlib.contextmanager
def amp_state_guard(state):
    """Run the block with ``state`` (an :func:`amp_state` pair) in force
    on this thread. A checkpointed block's recomputation runs in
    autograd's thread, where no ``auto_cast`` is open: the block
    re-enters the state its forward ran under."""
    prev = amp_state()
    _state.level, _state.dtype = state
    try:
        yield
    finally:
        _state.level, _state.dtype = prev


def _cast_all(tensors, dtype):
    return tuple(t.to(dtype) if t is not None and t.is_floating_point()
                 and t.dtype != dtype else t for t in tensors)


def autocast_inputs(op_type: str, *tensors):
    """The inputs of op ``op_type`` as the reference's autocast leaves
    them (``maybe_autocast_inputs`` in ``paddle_tpu/amp/auto_cast.py``):
    a tuple of the same length, ``None`` and non-floating entries passed
    through."""
    level, dtype = amp_state()
    if level == "O1":
        if op_type in WHITE_LIST:
            return _cast_all(tensors, dtype)
        if op_type in BLACK_LIST:
            return _cast_all(tensors, torch.float32)
    elif level == "O2":
        if op_type in BLACK_LIST:
            return _cast_all(tensors, torch.float32)
        return _cast_all(tensors, dtype)
    return tensors


def maybe_autocast_inputs(op_type: str, ins, amp_dtype: str, level: str):
    """The tape's cast of op ``op_type``'s inputs ``ins`` (``{slot:
    [Tensor]}``) per the white and black lists at ``level``, through the
    ``cast`` op so gradients flow through the cast, as the reference's
    ``maybe_autocast_inputs`` casts them."""
    from ..dygraph.tape import default_tracer
    from ..framework.program import convert_dtype

    def cast_all(target):
        tracer = default_tracer()
        out = {}
        for slot, ts in ins.items():
            new = []
            for t in ts:
                if t.value.is_floating_point() and t.dtype != target:
                    t = tracer.trace_op(
                        "cast", {"X": [t]},
                        {"out_dtype": target, "in_dtype": t.dtype},
                        autocast=False)["Out"][0]
                new.append(t)
            out[slot] = new
        return out

    amp_dtype = convert_dtype(amp_dtype)
    if level == "O1":
        if op_type in WHITE_LIST:
            return cast_all(amp_dtype)
        if op_type in BLACK_LIST:
            return cast_all("float32")
        return ins
    if level == "O2":
        if op_type in BLACK_LIST:
            return cast_all("float32")
        return cast_all(amp_dtype)
    return ins


@contextlib.contextmanager
def auto_cast(enable: bool = True, custom_white_list=None,
              custom_black_list=None, level: str = "O1",
              dtype: str = "bfloat16"):
    """The reference's ``auto_cast`` (``amp_guard``): run the block at
    ``level`` ("O1" or "O2") in ``dtype``; ``enable=False`` runs it at
    "O0" (no casts). The custom lists are taken and, as in the reference
    (``paddle_tpu/amp/auto_cast.py:63``), not applied: both packages cast
    by the fixed lists of ``lists.py``."""
    if level not in ("O0", "O1", "O2"):
        raise ValueError(f"AMP level must be O0, O1 or O2, got {level!r}")
    if dtype not in _DTYPES:
        raise ValueError(f"AMP dtype must be one of {sorted(_DTYPES)}, got "
                         f"{dtype!r}")
    prev = amp_state()
    _state.level = level if enable else "O0"
    _state.dtype = _DTYPES[dtype]
    try:
        yield
    finally:
        _state.level, _state.dtype = prev


amp_guard = auto_cast
