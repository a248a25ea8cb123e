"""Automatic mixed precision (the counterpart of ``paddle_tpu/amp``):
``auto_cast`` and the white/black op lists it applies."""

from .auto_cast import auto_cast, maybe_autocast_inputs
from .lists import BLACK_LIST, WHITE_LIST

__all__ = ["BLACK_LIST", "WHITE_LIST", "auto_cast", "maybe_autocast_inputs"]
