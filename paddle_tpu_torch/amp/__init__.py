"""Automatic mixed precision (the counterpart of ``paddle_tpu/amp``):
``auto_cast``, the white/black op lists it applies and the loss scaler
``GradScaler``."""

from .auto_cast import auto_cast, maybe_autocast_inputs
from .grad_scaler import AmpScaler, GradScaler
from .lists import BLACK_LIST, WHITE_LIST

__all__ = ["AmpScaler", "BLACK_LIST", "GradScaler", "WHITE_LIST",
           "auto_cast", "maybe_autocast_inputs"]
