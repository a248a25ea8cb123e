"""LayerHelper — shared machinery for functional layer builders; a copy of
``paddle_tpu/layer_helper.py``.

Analog of python/paddle/fluid/layer_helper.py: creates parameters (var in
the main program + init op in the startup program), temp variables, and
appends ops to the current main program.
"""

from __future__ import annotations

from typing import Optional, Sequence

from .framework import unique_name
from .framework.program import (Variable, default_main_program,
                                default_startup_program)
from .initializer import ConstantInitializer, Initializer, XavierInitializer
from .param_attr import ParamAttr


class LayerHelper:
    def __init__(self, layer_type: str, **kwargs):
        self.layer_type = layer_type
        self.kwargs = kwargs
        self.name = kwargs.get("name") or unique_name.generate(layer_type)

    @property
    def main_program(self):
        return default_main_program()

    @property
    def startup_program(self):
        return default_startup_program()

    @property
    def block(self):
        return self.main_program.current_block()

    def create_parameter(self, attr, shape: Sequence[int], dtype="float32",
                         is_bias: bool = False,
                         default_initializer: Optional[Initializer] = None
                         ) -> Optional[Variable]:
        attr = ParamAttr._to_attr(attr)
        if attr is None:
            return None
        name = attr.name or unique_name.generate(f"{self.name}.w")
        init = attr.initializer or default_initializer
        if init is None:
            init = (ConstantInitializer(0.0) if is_bias
                    else XavierInitializer())
        # main-program declaration
        p = self.block.create_parameter(
            name, shape=shape, dtype=dtype, trainable=attr.trainable,
            regularizer=attr.regularizer)
        p.initializer = {"type": type(init).__name__}
        p.lr_scale = attr.learning_rate
        # startup-program declaration + init op
        sb = self.startup_program.global_block()
        sv = sb.create_parameter(name, shape=shape, dtype=dtype,
                                 trainable=attr.trainable)
        init(sv, sb)
        return p

    def create_variable_for_type_inference(self, dtype="float32",
                                           stop_gradient: bool = False
                                           ) -> Variable:
        return self.block.create_var(
            unique_name.generate(f"{self.name}.tmp"), dtype=dtype,
            stop_gradient=stop_gradient)

    def append_op(self, type: str, inputs=None, outputs=None, attrs=None):  # noqa: A002
        return self.block.append_op(type, inputs, outputs, attrs)

    def append_activation(self, input_var: Variable,
                          act: Optional[str]) -> Variable:
        if act is None:
            return input_var
        out = self.create_variable_for_type_inference(input_var.dtype)
        out.shape = input_var.shape
        self.append_op(act, inputs={"X": input_var}, outputs={"Out": out})
        return out

    def append_bias_op(self, input_var: Variable, bias_attr,
                       dim_start: int = 1, num_flatten_dims: Optional[int] = None
                       ) -> Variable:
        attr = ParamAttr._to_attr(bias_attr)
        if attr is None:
            return input_var
        size = input_var.shape[-1] if input_var.shape else None
        b = self.create_parameter(attr, shape=[size], dtype=input_var.dtype,
                                  is_bias=True)
        out = self.create_variable_for_type_inference(input_var.dtype)
        out.shape = input_var.shape
        self.append_op("elementwise_add", inputs={"X": input_var, "Y": b},
                       outputs={"Out": out},
                       attrs={"axis": -1})
        return out


def build_simple_op(op_type: str, inputs, attrs, out_slots=("Out",),
                    dtype="float32", out_shapes=None, out_dtypes=None):
    """One-op builder: create fresh output vars for ``out_slots``,
    append the op, return the vars (single var if one slot). Shared by
    the sequence/detection layer modules. ``out_shapes`` maps slot ->
    static shape so downstream builders (e.g. fc) can infer sizes;
    ``out_dtypes`` maps slot -> dtype overriding ``dtype`` (e.g. int64
    length outputs alongside float data)."""
    helper = LayerHelper(op_type)
    outs = {s: helper.create_variable_for_type_inference(
        (out_dtypes or {}).get(s, dtype)) for s in out_slots}
    for s, shape in (out_shapes or {}).items():
        if shape is not None:
            outs[s].shape = list(shape)
    helper.append_op(op_type, inputs=inputs, outputs=outs, attrs=attrs)
    vals = tuple(outs[s] for s in out_slots)
    return vals[0] if len(vals) == 1 else vals
