"""Eager AMP autocast — the counterpart of ``paddle_tpu/amp/auto_cast.py``.

Under ``auto_cast(level="O1")`` white-list ops cast their floating
inputs to bf16 and black-list ops cast them back to float32; under
``"O2"`` every op outside the black list casts its floating inputs to
bf16. The port's functions call :func:`maybe_autocast_inputs` with the
op type the JAX package records for the same computation, so the two
packages round at the same places (``torch.autocast`` keeps other lists
and would not). The casts are ``Tensor.to``, which is differentiable:
float32 master parameters receive float32 gradients. The level is
per thread, as ``torch.autocast``'s is.
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


def maybe_autocast_inputs(op_type: str, *tensors):
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


@contextlib.contextmanager
def auto_cast(enable: bool = True, level: str = "O1",
              dtype: str = "bfloat16"):
    """The reference's ``auto_cast`` (``amp_guard``): run the block at ``level`` ("O1" or "O2") in
    ``dtype``; ``enable=False`` runs it at "O0" (no casts)."""
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
