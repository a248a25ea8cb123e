"""Functional layer builders (static graph) — a copy of
``paddle_tpu/layers/nn.py``.

Analog of python/paddle/fluid/layers/nn.py — each function appends ops to
the current main program and returns the output Variable(s). Shapes are
computed best-effort at build time (authoritative shapes come from the
feeds at run time).
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np

from ..framework import unique_name
from ..framework.program import Variable, default_main_program
from ..layer_helper import LayerHelper
from ..param_attr import ParamAttr


def data(name: str, shape: Sequence[int], dtype="float32",
         append_batch_size: bool = True) -> Variable:
    """Analog of fluid.layers.data / fluid.data. With append_batch_size,
    a leading -1 batch dim is prepended (specialized at feed time)."""
    shape = list(shape)
    if append_batch_size and (not shape or shape[0] != -1):
        shape = [-1] + shape
    block = default_main_program().global_block()
    return block.create_var(name, shape=shape, dtype=dtype, is_data=True,
                            stop_gradient=True, persistable=False)


def fc(input: Variable, size: int, num_flatten_dims: int = 1,
       param_attr=None, bias_attr=None, act: Optional[str] = None,
       name: Optional[str] = None) -> Variable:
    """Fully connected (reference layers/nn.py fc -> mul+elementwise_add).

    Like the reference, ``input`` may be a LIST of variables: each gets
    its own weight and the projections are summed before bias/act (the
    book programs' multi-feature mixing idiom)."""
    helper = LayerHelper("fc", name=name)
    inputs = list(input) if isinstance(input, (list, tuple)) else [input]
    # per-input param_attr list (reference fc semantics); a single NAMED
    # attr across several inputs would silently share/mismatch weights
    if isinstance(param_attr, (list, tuple)):
        if len(param_attr) != len(inputs):
            raise ValueError(
                f"fc got {len(inputs)} inputs but {len(param_attr)} "
                "param_attrs")
        attrs_per_input = list(param_attr)
    else:
        if len(inputs) > 1 and param_attr is not None and \
                getattr(ParamAttr._to_attr(param_attr), "name", None):
            raise ValueError(
                "fc with multiple inputs needs a param_attr LIST (one "
                "per input); a single named attr would share one weight "
                "across different-shaped projections")
        attrs_per_input = [param_attr] * len(inputs)
    projected = []
    for x, p_attr in zip(inputs, attrs_per_input):
        in_shape = x.shape
        in_features = int(np.prod(in_shape[num_flatten_dims:]))
        w = helper.create_parameter(p_attr,
                                    shape=[in_features, size],
                                    dtype=x.dtype)
        proj = helper.create_variable_for_type_inference(x.dtype)
        proj.shape = tuple(in_shape[:num_flatten_dims]) + (size,)
        helper.append_op("mul", inputs={"X": x, "Y": w},
                         outputs={"Out": proj},
                         attrs={"x_num_col_dims": num_flatten_dims,
                                "y_num_col_dims": 1})
        projected.append(proj)
    if len(projected) == 1:
        out = projected[0]
    else:
        out = helper.create_variable_for_type_inference(inputs[0].dtype)
        out.shape = projected[0].shape
        helper.append_op("sum", inputs={"X": projected},
                         outputs={"Out": out}, attrs={})
    out = helper.append_bias_op(out, bias_attr if bias_attr is not None else ParamAttr())
    return helper.append_activation(out, act)


def embedding(input: Variable, size: Sequence[int], is_sparse: bool = False,
              padding_idx: Optional[int] = None, param_attr=None,
              dtype="float32", name: Optional[str] = None) -> Variable:
    helper = LayerHelper("embedding", name=name)
    w = helper.create_parameter(param_attr, shape=list(size), dtype=dtype)
    out = helper.create_variable_for_type_inference(dtype)
    out.shape = tuple(input.shape) + (size[1],) if input.shape else None
    # None -> no padding row (sentinel -1 internally); negative indices are
    # normalized like the reference (vocab + padding_idx).
    if padding_idx is None:
        pidx = -1
    elif padding_idx < 0:
        pidx = int(size[0]) + int(padding_idx)
    else:
        pidx = int(padding_idx)
    helper.append_op("lookup_table_v2", inputs={"W": w, "Ids": input},
                     outputs={"Out": out}, attrs={"padding_idx": pidx})
    return out


def _pair(v):
    return [v, v] if isinstance(v, int) else list(v)


def conv2d(input: Variable, num_filters: int, filter_size, stride=1,
           padding=0, dilation=1, groups: int = 1, param_attr=None,
           bias_attr=None, act: Optional[str] = None,
           data_format: str = "NCHW", name: Optional[str] = None) -> Variable:
    helper = LayerHelper("conv2d", name=name)
    ksize = _pair(filter_size)
    stride = _pair(stride)
    padding = _pair(padding)
    dilation = _pair(dilation)
    caxis = 1 if data_format == "NCHW" else 3
    in_ch = input.shape[caxis]
    w = helper.create_parameter(
        param_attr, shape=[num_filters, in_ch // groups] + ksize,
        dtype=input.dtype)
    out = helper.create_variable_for_type_inference(input.dtype)
    if input.shape and all(d is not None for d in input.shape):
        h_axis = 2 if data_format == "NCHW" else 1
        hw = []
        for i in range(2):
            d = input.shape[h_axis + i]
            if d < 0:
                hw.append(-1)
            else:
                eff = (ksize[i] - 1) * dilation[i] + 1
                hw.append((d + 2 * padding[i] - eff) // stride[i] + 1)
        if data_format == "NCHW":
            out.shape = (input.shape[0], num_filters, hw[0], hw[1])
        else:
            out.shape = (input.shape[0], hw[0], hw[1], num_filters)
    helper.append_op("conv2d", inputs={"Input": input, "Filter": w},
                     outputs={"Output": out},
                     attrs={"strides": stride, "paddings": padding,
                            "dilations": dilation, "groups": groups,
                            "data_format": data_format})
    if bias_attr is not False:
        attr = ParamAttr._to_attr(bias_attr)
        b = helper.create_parameter(attr, shape=[num_filters],
                                    dtype=input.dtype, is_bias=True)
        out2 = helper.create_variable_for_type_inference(input.dtype)
        out2.shape = out.shape
        helper.append_op("elementwise_add", inputs={"X": out, "Y": b},
                         outputs={"Out": out2},
                         attrs={"axis": 1 if data_format == "NCHW" else 3})
        out = out2
    return helper.append_activation(out, act)


def pool2d(input: Variable, pool_size=2, pool_type: str = "max",
           pool_stride=None, pool_padding=0, global_pooling: bool = False,
           ceil_mode: bool = False, exclusive: bool = True,
           name: Optional[str] = None) -> Variable:
    helper = LayerHelper("pool2d", name=name)
    ksize = _pair(pool_size)
    stride = _pair(pool_stride if pool_stride is not None else pool_size)
    padding = _pair(pool_padding)
    out = helper.create_variable_for_type_inference(input.dtype)
    if input.shape:
        if global_pooling:
            out.shape = (input.shape[0], input.shape[1], 1, 1)
        else:
            hw = []
            for i in range(2):
                d = input.shape[2 + i]
                if d < 0:
                    hw.append(-1)
                else:
                    num = d + 2 * padding[i] - ksize[i]
                    hw.append((num + stride[i] - 1) // stride[i] + 1
                              if ceil_mode else num // stride[i] + 1)
            out.shape = (input.shape[0], input.shape[1], hw[0], hw[1])
    helper.append_op("pool2d", inputs={"X": input}, outputs={"Out": out},
                     attrs={"pooling_type": pool_type, "ksize": ksize,
                            "strides": stride, "paddings": padding,
                            "global_pooling": global_pooling,
                            "ceil_mode": ceil_mode, "exclusive": exclusive})
    return out


def batch_norm(input: Variable, act: Optional[str] = None,
               is_test: bool = False, momentum: float = 0.9,
               epsilon: float = 1e-5, param_attr=None, bias_attr=None,
               data_layout: str = "NCHW", name: Optional[str] = None,
               moving_mean_name=None, moving_variance_name=None,
               use_global_stats: bool = False) -> Variable:
    helper = LayerHelper("batch_norm", name=name)
    caxis = 1 if data_layout == "NCHW" else input.ndim - 1
    c = input.shape[caxis]
    from ..initializer import ConstantInitializer
    scale = helper.create_parameter(param_attr, shape=[c], dtype=input.dtype,
                                    default_initializer=ConstantInitializer(1.0))
    bias = helper.create_parameter(bias_attr, shape=[c], dtype=input.dtype,
                                   is_bias=True)
    mean = helper.create_parameter(
        ParamAttr(name=moving_mean_name, trainable=False), shape=[c],
        dtype=input.dtype, default_initializer=ConstantInitializer(0.0))
    var = helper.create_parameter(
        ParamAttr(name=moving_variance_name, trainable=False), shape=[c],
        dtype=input.dtype, default_initializer=ConstantInitializer(1.0))
    y = helper.create_variable_for_type_inference(input.dtype)
    y.shape = input.shape
    saved_m = helper.create_variable_for_type_inference(input.dtype, True)
    saved_v = helper.create_variable_for_type_inference(input.dtype, True)
    helper.append_op(
        "batch_norm",
        inputs={"X": input, "Scale": scale, "Bias": bias,
                "Mean": mean, "Variance": var},
        outputs={"Y": y, "MeanOut": mean, "VarianceOut": var,
                 "SavedMean": saved_m, "SavedVariance": saved_v},
        attrs={"momentum": momentum, "epsilon": epsilon, "is_test": is_test,
               "data_format": data_layout,
               "use_global_stats": use_global_stats})
    return helper.append_activation(y, act)


def layer_norm(input: Variable, scale: bool = True, shift: bool = True,
               begin_norm_axis: int = 1, epsilon: float = 1e-5,
               param_attr=None, bias_attr=None, act: Optional[str] = None,
               name: Optional[str] = None) -> Variable:
    helper = LayerHelper("layer_norm", name=name)
    from ..initializer import ConstantInitializer
    nshape = [int(np.prod(input.shape[begin_norm_axis:]))]
    inputs = {"X": input}
    if scale:
        s = helper.create_parameter(param_attr, shape=nshape,
                                    dtype=input.dtype,
                                    default_initializer=ConstantInitializer(1.0))
        inputs["Scale"] = s
    if shift:
        b = helper.create_parameter(bias_attr, shape=nshape,
                                    dtype=input.dtype, is_bias=True)
        inputs["Bias"] = b
    y = helper.create_variable_for_type_inference(input.dtype)
    y.shape = input.shape
    m = helper.create_variable_for_type_inference(input.dtype, True)
    v = helper.create_variable_for_type_inference(input.dtype, True)
    helper.append_op("layer_norm", inputs=inputs,
                     outputs={"Y": y, "Mean": m, "Variance": v},
                     attrs={"epsilon": epsilon,
                            "begin_norm_axis": begin_norm_axis})
    return helper.append_activation(y, act)


def dropout(x: Variable, dropout_prob: float, is_test: bool = False,
            dropout_implementation: str = "upscale_in_train",
            name: Optional[str] = None) -> Variable:
    helper = LayerHelper("dropout", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    out.shape = x.shape
    mask = helper.create_variable_for_type_inference("uint8", True)
    helper.append_op("dropout", inputs={"X": x},
                     outputs={"Out": out, "Mask": mask},
                     attrs={"dropout_prob": dropout_prob, "is_test": is_test,
                            "dropout_implementation": dropout_implementation})
    return out


def softmax(input: Variable, axis: int = -1,
            name: Optional[str] = None) -> Variable:
    helper = LayerHelper("softmax", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    out.shape = input.shape
    helper.append_op("softmax", inputs={"X": input}, outputs={"Out": out},
                     attrs={"axis": axis})
    return out


def matmul(x: Variable, y: Variable, transpose_x: bool = False,
           transpose_y: bool = False, alpha: float = 1.0,
           name: Optional[str] = None) -> Variable:
    helper = LayerHelper("matmul", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("matmul", inputs={"X": x, "Y": y},
                     outputs={"Out": out},
                     attrs={"transpose_X": transpose_x,
                            "transpose_Y": transpose_y, "alpha": alpha})
    return out


def relu(x, name=None):
    return _act("relu", x, name)


def gelu(x, approximate=False, name=None):
    helper = LayerHelper("gelu", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    out.shape = x.shape
    helper.append_op("gelu", inputs={"X": x}, outputs={"Out": out},
                     attrs={"approximate": approximate})
    return out


def sigmoid(x, name=None):
    return _act("sigmoid", x, name)


def tanh(x, name=None):
    return _act("tanh", x, name)


def sqrt(x, name=None):
    return _act("sqrt", x, name)


def square(x, name=None):
    return _act("square", x, name)


def exp(x, name=None):
    return _act("exp", x, name)


def log(x, name=None):
    return _act("log", x, name)


def _act(op, x, name=None):
    helper = LayerHelper(op, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    out.shape = x.shape
    helper.append_op(op, inputs={"X": x}, outputs={"Out": out})
    return out


def _elementwise(op, x, y, axis=-1, act=None, name=None):
    helper = LayerHelper(op, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    out.shape = x.shape
    helper.append_op(op, inputs={"X": x, "Y": y}, outputs={"Out": out},
                     attrs={"axis": axis})
    return helper.append_activation(out, act)


def elementwise_add(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_add", x, y, axis, act, name)


def elementwise_sub(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_sub", x, y, axis, act, name)


def elementwise_mul(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_mul", x, y, axis, act, name)


def elementwise_div(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_div", x, y, axis, act, name)


def elementwise_max(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_max", x, y, axis, act, name)


def elementwise_min(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_min", x, y, axis, act, name)


def mean(x, name=None):
    helper = LayerHelper("mean", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    out.shape = ()
    helper.append_op("mean", inputs={"X": x}, outputs={"Out": out})
    return out


def _reduce(op, x, dim=None, keep_dim=False, name=None):
    helper = LayerHelper(op, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    attrs = {"keep_dim": keep_dim}
    if dim is None:
        attrs["reduce_all"] = True
        if keep_dim:
            out.shape = ((1,) * len(x.shape) if x.shape is not None
                         else None)
        else:
            out.shape = ()
    else:
        dims = [dim] if isinstance(dim, int) else list(dim)
        attrs["dim"] = dims
        if x.shape is not None:
            nd = len(x.shape)
            axes = {d % nd for d in dims}
            out.shape = tuple(
                1 if i in axes else s
                for i, s in enumerate(x.shape)
                if keep_dim or i not in axes)
    helper.append_op(op, inputs={"X": x}, outputs={"Out": out}, attrs=attrs)
    return out


def reduce_sum(x, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_sum", x, dim, keep_dim, name)


def reduce_mean(x, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_mean", x, dim, keep_dim, name)


def reduce_max(x, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_max", x, dim, keep_dim, name)


def reduce_min(x, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_min", x, dim, keep_dim, name)


def reshape(x, shape, name=None):
    helper = LayerHelper("reshape", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    xshape = helper.create_variable_for_type_inference(x.dtype, True)
    # static shape inference so downstream builders (fc) see sizes;
    # 0 copies the input dim (reference reshape convention)
    inferred = [int(d) for d in shape]
    if x.shape:
        inferred = [x.shape[i] if d == 0 and i < len(x.shape) else d
                    for i, d in enumerate(inferred)]
    out.shape = inferred
    helper.append_op("reshape2", inputs={"X": x},
                     outputs={"Out": out, "XShape": xshape},
                     attrs={"shape": list(shape)})
    return out


def transpose(x, perm, name=None):
    helper = LayerHelper("transpose", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    xshape = helper.create_variable_for_type_inference(x.dtype, True)
    if x.shape:
        out.shape = tuple(x.shape[p] for p in perm)
    helper.append_op("transpose2", inputs={"X": x},
                     outputs={"Out": out, "XShape": xshape},
                     attrs={"axis": list(perm)})
    return out


def flatten(x, axis=1, name=None):
    helper = LayerHelper("flatten", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    xshape = helper.create_variable_for_type_inference(x.dtype, True)
    if x.shape:
        out.shape = (int(np.prod(x.shape[:axis])),
                     int(np.prod(x.shape[axis:])))
    helper.append_op("flatten2", inputs={"X": x},
                     outputs={"Out": out, "XShape": xshape},
                     attrs={"axis": axis})
    return out


def concat(input, axis=0, name=None):
    helper = LayerHelper("concat", name=name)
    out = helper.create_variable_for_type_inference(input[0].dtype)
    shapes = [v.shape for v in input]
    if all(s is not None for s in shapes):
        nd = len(shapes[0])
        ax = axis % nd
        cat = sum(s[ax] for s in shapes)
        if any(s[ax] < 0 for s in shapes):
            cat = -1
        out.shape = tuple(cat if i == ax else shapes[0][i]
                          for i in range(nd))
    helper.append_op("concat", inputs={"X": list(input)},
                     outputs={"Out": out}, attrs={"axis": axis})
    return out


def split(input, num_or_sections, dim=-1, name=None):
    helper = LayerHelper("split", name=name)
    if isinstance(num_or_sections, int):
        n = num_or_sections
        attrs = {"num": n, "axis": dim}
    else:
        n = len(num_or_sections)
        attrs = {"sections": list(num_or_sections), "axis": dim}
    outs = [helper.create_variable_for_type_inference(input.dtype)
            for _ in range(n)]
    helper.append_op("split", inputs={"X": input}, outputs={"Out": outs},
                     attrs=attrs)
    return outs


def cast(x, dtype, name=None):
    helper = LayerHelper("cast", name=name)
    from ..framework.program import convert_dtype
    dtype = convert_dtype(dtype)
    out = helper.create_variable_for_type_inference(dtype)
    out.shape = x.shape
    helper.append_op("cast", inputs={"X": x}, outputs={"Out": out},
                     attrs={"out_dtype": dtype, "in_dtype": x.dtype})
    return out


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None, name=None):
    helper = LayerHelper("scale", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    out.shape = x.shape
    helper.append_op("scale", inputs={"X": x}, outputs={"Out": out},
                     attrs={"scale": scale, "bias": bias,
                            "bias_after_scale": bias_after_scale})
    return helper.append_activation(out, act)


def topk(input, k, name=None):
    helper = LayerHelper("top_k", name=name)
    vals = helper.create_variable_for_type_inference(input.dtype)
    idx = helper.create_variable_for_type_inference("int64", True)
    helper.append_op("top_k_v2", inputs={"X": input},
                     outputs={"Out": vals, "Indices": idx}, attrs={"k": k})
    return vals, idx


def accuracy(input, label, k=1, name=None):
    """Analog of layers/metric_op.py accuracy: top_k + accuracy op."""
    helper = LayerHelper("accuracy", name=name)
    vals, idx = topk(input, k)
    acc = helper.create_variable_for_type_inference("float32", True)
    correct = helper.create_variable_for_type_inference("int32", True)
    total = helper.create_variable_for_type_inference("int32", True)
    helper.append_op("accuracy",
                     inputs={"Out": vals, "Indices": idx, "Label": label},
                     outputs={"Accuracy": acc, "Correct": correct,
                              "Total": total})
    return acc


def one_hot(input, depth, name=None):
    helper = LayerHelper("one_hot", name=name)
    out = helper.create_variable_for_type_inference("float32")
    # legacy fluid.layers.one_hot squeezes a trailing dim of 1 ([N,1] ->
    # [N,depth]); the v2 op appends depth to the unmodified shape
    helper.append_op("one_hot", inputs={"X": input},
                     outputs={"Out": out}, attrs={"depth": depth})
    return out
