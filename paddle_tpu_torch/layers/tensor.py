"""Tensor creation/manipulation builders (analog of
fluid/layers/tensor.py) — a copy of ``paddle_tpu/layers/tensor.py``."""

from __future__ import annotations

from ..framework import unique_name
from ..framework.program import (Variable, default_main_program,
                                 default_startup_program)
from ..layer_helper import LayerHelper


def fill_constant(shape, dtype, value, name=None):
    helper = LayerHelper("fill_constant", name=name)
    out = helper.create_variable_for_type_inference(dtype, True)
    out.shape = tuple(shape)
    helper.append_op("fill_constant", outputs={"Out": out},
                     attrs={"shape": list(shape), "dtype": dtype,
                            "value": float(value)})
    return out


def zeros(shape, dtype="float32", name=None):
    return fill_constant(shape, dtype, 0.0, name)


def ones(shape, dtype="float32", name=None):
    return fill_constant(shape, dtype, 1.0, name)


def assign(input, output=None, name=None):
    helper = LayerHelper("assign", name=name)
    if output is None:
        output = helper.create_variable_for_type_inference(input.dtype)
        output.shape = input.shape
    helper.append_op("assign", inputs={"X": input}, outputs={"Out": output})
    return output


def increment(x, value=1.0, name=None):
    helper = LayerHelper("increment", name=name)
    helper.append_op("increment", inputs={"X": x}, outputs={"Out": x},
                     attrs={"step": float(value)})
    return x


def create_global_var(shape, value, dtype, persistable=False, force_cpu=False,
                      name=None):
    """Persistable var declared in both programs; initialized by startup."""
    main = default_main_program().global_block()
    startup = default_startup_program().global_block()
    name = name or unique_name.generate("global_var")
    v = main.create_var(name, shape=shape, dtype=dtype,
                        persistable=persistable, stop_gradient=True)
    sv = startup.create_var(name, shape=shape, dtype=dtype,
                            persistable=persistable, stop_gradient=True)
    startup.append_op("fill_constant", outputs={"Out": sv},
                      attrs={"shape": list(shape), "dtype": dtype,
                             "value": float(value)})
    return v


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    helper = LayerHelper("create_parameter", name=name)
    from ..param_attr import ParamAttr
    attr = attr or ParamAttr(name=name)
    return helper.create_parameter(attr, shape, dtype, is_bias,
                                   default_initializer)


def cast(x, dtype, name=None):
    from .nn import cast as _cast
    return _cast(x, dtype, name)


def concat(input, axis=0, name=None):
    from .nn import concat as _concat
    return _concat(input, axis, name)


def argmax(x, axis=-1, dtype="int64", keepdims=False, name=None):
    helper = LayerHelper("argmax", name=name)
    out = helper.create_variable_for_type_inference(dtype, True)
    helper.append_op("arg_max", inputs={"X": x}, outputs={"Out": out},
                     attrs={"axis": axis, "dtype": dtype,
                            "keepdims": keepdims})
    return out
