"""ParamAttr — per-parameter configuration; a copy of
``paddle_tpu/param_attr.py``.

Analog of python/paddle/fluid/param_attr.py: name, initializer, per-param
learning-rate scale, regularizer, trainable flag. The static layer
builders, the tape's ``Layer.create_parameter`` and the eager layers
(``nn/``) honour it.
"""

from __future__ import annotations

from typing import Optional

from .initializer import Initializer


class ParamAttr:
    def __init__(self, name: Optional[str] = None,
                 initializer: Optional[Initializer] = None,
                 learning_rate: float = 1.0,
                 regularizer=None,
                 trainable: bool = True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable

    @staticmethod
    def _to_attr(arg) -> Optional["ParamAttr"]:
        """Accept ParamAttr | str(name) | Initializer | bool | None.
        False means "no parameter" (e.g. bias_attr=False -> no bias)."""
        if arg is None:
            return ParamAttr()
        if arg is False:
            return None
        if arg is True:
            return ParamAttr()
        if isinstance(arg, ParamAttr):
            return arg
        if isinstance(arg, str):
            return ParamAttr(name=arg)
        if isinstance(arg, Initializer):
            return ParamAttr(initializer=arg)
        raise TypeError(f"cannot convert {type(arg)} to ParamAttr")
