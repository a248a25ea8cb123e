"""Automatic mixed precision (the counterpart of ``paddle_tpu/amp``):
``auto_cast``, the white/black op lists it applies
(``AutoMixedPrecisionLists``), the loss scaler ``GradScaler`` and the
static rewrite of a Program (:mod:`.static_amp`)."""

from .auto_cast import (amp_guard, auto_cast, autocast_inputs,
                        maybe_autocast_inputs)
from .grad_scaler import AmpScaler, GradScaler
from .lists import BLACK_LIST, WHITE_LIST, AutoMixedPrecisionLists

__all__ = ["AmpScaler", "AutoMixedPrecisionLists", "BLACK_LIST",
           "GradScaler", "WHITE_LIST", "amp_guard", "auto_cast",
           "autocast_inputs", "maybe_autocast_inputs"]
