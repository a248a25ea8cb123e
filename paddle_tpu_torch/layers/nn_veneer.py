"""1:1 fluid.layers veneers over existing lowerings — the counterpart of
``paddle_tpu/layers/nn_veneer.py``, whole, copies of the reference's
builders: the activations and unaries (``:26-108``),
``label_smooth``, ``l2_normalize`` and ``smooth_l1`` (``:109-157``),
shape and indexing (``:158-283``), the reductions and
the random builders (``:283-348``), ``group_norm`` / ``instance_norm``,
``mul`` and ``autoincreased_step_counter`` (``:426-512``), ``brelu``,
``soft_relu``, ``stanh``, ``dice_loss`` and ``scatter_nd``
(``:606-654``), and the LoD / SelectedRows identities and ``py_func``
(``:715-781``). Signatures follow the reference (python/paddle/fluid/
layers/nn.py); bodies are one append_op through the shared helpers.

``py_func`` registers a host op: on the card the executor splits a
captured key around it (the ops before and after it are graphs of their
own) and counts the copy of its inputs to the host among the run's host
reads.

The image and detection veneers: ``crop``, ``conv2d_transpose``,
``conv3d``, ``conv3d_transpose``, ``pool3d``, ``roi_align``,
``roi_pool``, ``prroi_pool``, ``psroi_pool``, ``deformable_conv``,
``adaptive_pool2d``, ``adaptive_pool3d``, ``fsp_matrix``,
``image_resize_short``, ``inplace_abn``, ``im2sequence`` and
``random_crop``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..layer_helper import LayerHelper
from ..param_attr import ParamAttr
from .nn_extra import _one_out


# -- activations / unary ------------------------------------------------

def clip(x, min, max, name=None):  # noqa: A002
    return _one_out("clip", {"X": x}, {"min": float(min),
                                       "max": float(max)}, name=name)


def clip_by_norm(x, max_norm, name=None):
    return _one_out("clip_by_norm", {"X": x},
                    {"max_norm": float(max_norm)}, name=name)


def elu(x, alpha=1.0, name=None):
    return _one_out("elu", {"X": x}, {"alpha": float(alpha)}, name=name)


def leaky_relu(x, alpha=0.02, name=None):
    return _one_out("leaky_relu", {"X": x}, {"alpha": float(alpha)},
                    name=name)


def relu6(x, threshold=6.0, name=None):
    return _one_out("relu6", {"X": x}, {"threshold": float(threshold)},
                    name=name)


def swish(x, beta=1.0, name=None):
    return _one_out("swish", {"X": x}, {"beta": float(beta)}, name=name)


def hard_sigmoid(x, slope=0.2, offset=0.5, name=None):
    return _one_out("hard_sigmoid", {"X": x},
                    {"slope": float(slope), "offset": float(offset)},
                    name=name)


def hard_swish(x, threshold=6.0, scale=6.0, offset=3.0, name=None):
    return _one_out("hard_swish", {"X": x},
                    {"threshold": float(threshold),
                     "scale": float(scale), "offset": float(offset)},
                    name=name)


def prelu(x, mode="all", param_attr=None, name=None):
    """channel-shared/channel-wise/element-wise learnable slope."""
    helper = LayerHelper("prelu", param_attr=param_attr, name=name)
    if mode == "all":
        shape = [1]
    elif mode == "channel":
        shape = [int(x.shape[1])]
    else:
        shape = [int(d) for d in x.shape[1:]]
    alpha = helper.create_parameter(param_attr, shape)
    return _one_out("prelu", {"X": x, "Alpha": alpha}, {"mode": mode})


def sign(x, name=None):
    return _one_out("sign", {"X": x}, name=name)


def pow(x, factor=1.0, name=None):  # noqa: A002
    return _one_out("pow", {"X": x}, {"factor": float(factor)},
                    name=name)


def logical_xor(x, y, out=None, name=None):
    return _one_out("logical_xor", {"X": x, "Y": y}, name=name,
                    dtype="bool")


def elementwise_pow(x, y, axis=-1, name=None):
    return _one_out("elementwise_pow", {"X": x, "Y": y},
                    {"axis": axis}, name=name)


def elementwise_mod(x, y, axis=-1, name=None):
    return _one_out("elementwise_mod", {"X": x, "Y": y},
                    {"axis": axis}, name=name)


def elementwise_floordiv(x, y, axis=-1, name=None):
    return _one_out("elementwise_floordiv", {"X": x, "Y": y},
                    {"axis": axis}, name=name)


def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    ins = {"X": label}
    if prior_dist is not None:
        ins["PriorDist"] = prior_dist
    return _one_out("label_smooth", ins, {"epsilon": float(epsilon)},
                    name=name)


def l2_normalize(x, axis, epsilon=1e-12, name=None):
    """x / sqrt(max(sum(x^2, axis), epsilon)) (layers/nn.py
    l2_normalize, composed as the reference composes it)."""
    from .nn import elementwise_div, reduce_sum
    sq = _one_out("square", {"X": x})
    ssum = reduce_sum(sq, dim=[axis], keep_dim=True)
    ssum = clip(ssum, float(epsilon), float(np.finfo(np.float32).max))
    norm = _one_out("sqrt", {"X": ssum})
    return elementwise_div(x, norm)


def smooth_l1(x, y, inside_weight=None, outside_weight=None,
              sigma=1.0, name=None):
    """Per-row smooth-L1 loss (layers/nn.py smooth_l1), composed from
    the huber pieces: 0.5*(s*d)^2 if |d|<1/s^2 else |d|-0.5/s^2,
    summed over features -> [N, 1]."""
    from .nn import (elementwise_mul, elementwise_sub, reduce_sum)
    d = elementwise_sub(x, y)
    if inside_weight is not None:
        d = elementwise_mul(d, inside_weight)
    s2 = float(sigma) ** 2
    absd = _one_out("abs", {"X": d})
    quad = _one_out("scale", {"X": _one_out("square", {"X": d})},
                    {"scale": 0.5 * s2, "bias": 0.0})
    lin = _one_out("scale", {"X": absd},
                   {"scale": 1.0, "bias": -0.5 / s2})
    thresh_shape = [1 if (d is None or d == -1) else int(d)
                    for d in x.shape]
    cond = _one_out("less_than", {"X": absd, "Y": _one_out(
        "fill_constant_batch_size_like", {"Input": absd},
        {"shape": thresh_shape, "dtype": "float32",
         "value": 1.0 / s2})}, dtype="bool")
    per = _one_out("where", {"Condition": cond, "X": quad, "Y": lin})
    if outside_weight is not None:
        per = elementwise_mul(per, outside_weight)
    return reduce_sum(per, dim=[1], keep_dim=True)


# -- tensor shape / indexing -------------------------------------------

def shape(input, name=None):  # noqa: A002
    return _one_out("shape", {"Input": input}, dtype="int32", name=name)


def size(input, name=None):  # noqa: A002
    return _one_out("size", {"Input": input}, dtype="int64", name=name)


def rank(input):  # noqa: A002
    from .tensor import fill_constant
    return fill_constant([1], "int32", len(input.shape))


def slice(input, axes, starts, ends, name=None):  # noqa: A002
    return _one_out("slice", {"X": input},
                    {"axes": list(axes), "starts": list(starts),
                     "ends": list(ends)}, name=name)


def strided_slice(input, axes, starts, ends, strides, name=None):  # noqa: A002
    return _one_out("strided_slice", {"X": input},
                    {"axes": list(axes), "starts": list(starts),
                     "ends": list(ends), "strides": list(strides)},
                    name=name)


def squeeze(input, axes, name=None):  # noqa: A002
    return _one_out("squeeze", {"X": input}, {"axes": list(axes)},
                    name=name)


def unsqueeze(input, axes, name=None):  # noqa: A002
    return _one_out("unsqueeze", {"X": input}, {"axes": list(axes)},
                    name=name)


def stack(x, axis=0, name=None):
    return _one_out("stack", {"X": list(x)}, {"axis": int(axis)},
                    out_slot="Y", name=name)


def _multi_out(op, inputs, attrs, n, out_slot="Y", dtype="float32"):
    helper = LayerHelper(op)
    outs = [helper.create_variable_for_type_inference(dtype)
            for _ in range(n)]
    helper.append_op(op, inputs=inputs, outputs={out_slot: outs},
                     attrs=attrs)
    return outs


def unstack(x, axis=0, num=None):
    n = num if num is not None else int(x.shape[axis])
    return _multi_out("unstack", {"X": [x]}, {"axis": int(axis),
                                              "num": n}, n)


def unbind(input, axis=0):  # noqa: A002
    n = int(input.shape[axis])
    return _multi_out("unbind", {"X": [input]}, {"axis": int(axis)}, n,
                      out_slot="Out")


def expand(x, expand_times, name=None):
    return _one_out("expand", {"X": x},
                    {"expand_times": list(expand_times)}, name=name)


def expand_as(x, target_tensor, name=None):
    return _one_out("expand_as", {"X": x,
                                  "target_tensor": target_tensor},
                    name=name)


def gather(input, index, overwrite=True):  # noqa: A002
    return _one_out("gather", {"X": input, "Index": index})


def gather_nd(input, index, name=None):  # noqa: A002
    return _one_out("gather_nd", {"X": input, "Index": index},
                    name=name)


def scatter(input, index, updates, name=None, overwrite=True):  # noqa: A002
    return _one_out("scatter", {"X": input, "Ids": index,
                                "Updates": updates},
                    {"overwrite": bool(overwrite)}, name=name)


def where(condition, x=None, y=None, name=None):
    return _one_out("where", {"Condition": condition, "X": x, "Y": y},
                    name=name)


def pad(x, paddings, pad_value=0.0, name=None):
    return _one_out("pad", {"X": x},
                    {"paddings": list(paddings),
                     "pad_value": float(pad_value)}, name=name)


def pad2d(input, paddings=(0, 0, 0, 0), mode="constant",  # noqa: A002
          pad_value=0.0, data_format="NCHW", name=None):
    return _one_out("pad2d", {"X": input},
                    {"paddings": list(paddings), "mode": mode,
                     "pad_value": float(pad_value),
                     "data_format": data_format}, name=name)


def shard_index(input, index_num, nshards, shard_id,  # noqa: A002
                ignore_value=-1):
    return _one_out("shard_index", {"X": input},
                    {"index_num": int(index_num),
                     "nshards": int(nshards),
                     "shard_id": int(shard_id),
                     "ignore_value": int(ignore_value)}, dtype="int64")


def sum(x):  # noqa: A002
    from .nn_extra import sums
    return sums(x if isinstance(x, (list, tuple)) else [x])


# -- reductions ---------------------------------------------------------

def _reduce(op, input, dim, keep_dim, name, dtype=None):  # noqa: A002
    attrs = {"keep_dim": bool(keep_dim),
             "reduce_all": dim is None}
    if dim is not None:
        attrs["dim"] = dim if isinstance(dim, (list, tuple)) else [dim]
    return _one_out(op, {"X": input}, attrs, name=name, dtype=dtype)


def reduce_all(input, dim=None, keep_dim=False, name=None):  # noqa: A002
    return _reduce("reduce_all", input, dim, keep_dim, name, "bool")


def reduce_any(input, dim=None, keep_dim=False, name=None):  # noqa: A002
    return _reduce("reduce_any", input, dim, keep_dim, name, "bool")


def reduce_prod(input, dim=None, keep_dim=False, name=None):  # noqa: A002
    return _reduce("reduce_prod", input, dim, keep_dim, name)


# -- random -------------------------------------------------------------

def gaussian_random(shape, mean=0.0, std=1.0, seed=0, dtype="float32"):  # noqa: A002
    return _one_out("gaussian_random", {},
                    {"shape": list(shape), "mean": float(mean),
                     "std": float(std), "seed": int(seed),
                     "dtype": dtype}, dtype=dtype)


def uniform_random(shape, dtype="float32", min=-1.0, max=1.0, seed=0):  # noqa: A002
    return _one_out("uniform_random", {},
                    {"shape": list(shape), "min": float(min),
                     "max": float(max), "seed": int(seed),
                     "dtype": dtype}, dtype=dtype)


def gaussian_random_batch_size_like(input, shape, mean=0.0, std=1.0,  # noqa: A002
                                    input_dim_idx=0, output_dim_idx=0,
                                    seed=0, dtype="float32"):
    return _one_out("gaussian_random_batch_size_like", {"Input": input},
                    {"shape": list(shape), "mean": float(mean),
                     "std": float(std), "seed": int(seed),
                     "input_dim_idx": int(input_dim_idx),
                     "output_dim_idx": int(output_dim_idx),
                     "dtype": dtype}, dtype=dtype)


def uniform_random_batch_size_like(input, shape, dtype="float32",  # noqa: A002
                                   input_dim_idx=0, output_dim_idx=0,
                                   min=-1.0, max=1.0, seed=0):
    return _one_out("uniform_random_batch_size_like", {"Input": input},
                    {"shape": list(shape), "min": float(min),
                     "max": float(max), "seed": int(seed),
                     "input_dim_idx": int(input_dim_idx),
                     "output_dim_idx": int(output_dim_idx),
                     "dtype": dtype}, dtype=dtype)


# -- normalization ------------------------------------------------------


def _affine_norm(op, input, groups_attr, param_attr, bias_attr,  # noqa: A002
                 epsilon, act, name, extra_outs):
    helper = LayerHelper(op, param_attr=param_attr, name=name)
    c = int(input.shape[1])
    scale = helper.create_parameter(
        param_attr, [c],
        default_initializer=None) if param_attr is not False else None
    bias = helper.create_parameter(bias_attr, [c], is_bias=True) \
        if bias_attr is not False else None
    from ..initializer import ConstantInitializer
    if scale is not None and getattr(
            ParamAttr._to_attr(param_attr), "initializer", None) is None:
        # norm scales default to ones (reference convention)
        sb = helper.startup_program.global_block()
        ConstantInitializer(1.0)(sb.vars[scale.name], sb)
    out = helper.create_variable_for_type_inference(input.dtype)
    extras = {slot: [helper.create_variable_for_type_inference()]
              for slot in extra_outs}
    ins = {"X": [input]}
    if scale is not None:
        ins["Scale"] = [scale]
    if bias is not None:
        ins["Bias"] = [bias]
    attrs = {"epsilon": float(epsilon)}
    attrs.update(groups_attr)
    helper.append_op(op, inputs=ins,
                     outputs={"Y": [out], **extras}, attrs=attrs)
    return helper.append_activation(out, act)


def group_norm(input, groups, epsilon=1e-5, param_attr=None,  # noqa: A002
               bias_attr=None, act=None, data_layout="NCHW", name=None):
    return _affine_norm("group_norm", input, {"groups": int(groups)},
                        param_attr, bias_attr, epsilon, act, name,
                        ("Mean", "Variance"))


def instance_norm(input, epsilon=1e-5, param_attr=None,  # noqa: A002
                  bias_attr=None, name=None):
    return _affine_norm("instance_norm", input, {}, param_attr,
                        bias_attr, epsilon, None, name,
                        ("SavedMean", "SavedVariance"))


def mul(x, y, x_num_col_dims=1, y_num_col_dims=1, name=None):
    return _one_out("mul", {"X": x, "Y": y},
                    {"x_num_col_dims": int(x_num_col_dims),
                     "y_num_col_dims": int(y_num_col_dims)}, name=name)


def autoincreased_step_counter(counter_name=None, begin=1, step=1):
    """Persistable step counter incremented each run (layers/nn.py
    autoincreased_step_counter; backbone of the lr schedulers)."""
    from .tensor import create_global_var, increment
    from ..framework import unique_name
    counter = create_global_var(
        shape=[1], value=float(begin - step), dtype="int64",
        persistable=True,
        name=counter_name or unique_name.generate("step_counter"))
    increment(counter, value=float(step))
    return counter


# -- misc activations and losses ----------------------------------------


def brelu(x, t_min=0.0, t_max=24.0, name=None):
    return clip(x, t_min, t_max, name=name)


def soft_relu(x, threshold=40.0, name=None):
    """log(1 + exp(clip(x, -t, t))) (layers/nn.py soft_relu)."""
    c = clip(x, -float(threshold), float(threshold))
    e = _one_out("exp", {"X": c})
    one = _one_out("fill_constant_batch_size_like", {"Input": e},
                   {"shape": list(e.shape), "dtype": "float32",
                    "value": 1.0})
    from .nn import elementwise_add
    return _one_out("log", {"X": elementwise_add(e, one)}, name=name)


def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    from .nn import tanh
    s = _one_out("scale", {"X": x}, {"scale": float(scale_a),
                                     "bias": 0.0})
    return _one_out("scale", {"X": tanh(s)},
                    {"scale": float(scale_b), "bias": 0.0}, name=name)


def dice_loss(input, label, epsilon=1e-5):  # noqa: A002
    """1 - 2*|A.B| / (|A|+|B|) over per-row flattened probabilities
    (layers/nn.py dice_loss)."""
    from .nn import (elementwise_add, elementwise_div, elementwise_mul,
                     one_hot, reduce_sum)
    n_cls = int(input.shape[-1])
    lab = one_hot(squeeze(label, [-1]), n_cls)
    inter = reduce_sum(elementwise_mul(input, lab), dim=None)
    union = elementwise_add(reduce_sum(input, dim=None),
                            reduce_sum(lab, dim=None))
    two_i = _one_out("scale", {"X": inter}, {"scale": 2.0,
                                             "bias": float(epsilon)})
    union_e = _one_out("scale", {"X": union},
                       {"scale": 1.0, "bias": float(epsilon)})
    frac = elementwise_div(two_i, union_e)
    return _one_out("scale", {"X": frac}, {"scale": -1.0, "bias": 1.0})


def scatter_nd(index, updates, shape, name=None):  # noqa: A002
    """scatter_nd_add into zeros (the reference lowers identically)."""
    from .tensor import zeros
    from .nn_extra import scatter_nd_add
    base = zeros(list(shape), dtype=updates.dtype)
    return scatter_nd_add(base, index, updates, name=name)


# -- LoD / SelectedRows compatibility (identity in the dense design) ----

def lod_reset(x, y=None, target_lod=None):
    """LoD metadata does not exist in the padded+lengths design —
    raggedness rides explicit length tensors (sequence_lod.py), so
    resetting LoD is the identity on the data tensor."""
    return x


def lod_append(x, level):
    return x


def merge_selected_rows(x, name=None):
    """SelectedRows gradients are realized as dense rows here; merging
    duplicates is the identity."""
    return x


def get_tensor_from_selected_rows(x, name=None):
    return x


def py_func(func, x, out, backward_func=None, skip_vars_in_backward_input=None):
    """Host-Python op (layers/nn.py py_func -> py_func_op.cc): ``func``
    runs on the host's numpy values of ``x`` at every run, through an op
    registered for this call as a host op. Gradients are not threaded
    (not_differentiable), as in the reference."""
    import uuid

    import torch

    from ..ops import control_flow_ops as _cf
    from ..ops.registry import register as _register

    xs = x if isinstance(x, (list, tuple)) else [x]
    outs = out if isinstance(out, (list, tuple)) else [out]
    op_name = f"py_func_{uuid.uuid4().hex[:8]}"
    dtypes = [np.dtype(o.dtype) for o in outs]

    def lowering(ctx, ins, attrs, _fn=func):
        arrs = ins["X"]
        dev = arrs[0].device if arrs else ctx.device
        if any(a.is_cuda for a in arrs):
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError(
                    "py_func runs on the host and cannot be captured; the "
                    "executor splits a key at a top-level one")
            _cf.note_host_read()
        r = _fn(*[a.detach().cpu().numpy() for a in arrs])
        r = r if isinstance(r, (list, tuple)) else [r]
        return {"Out": [torch.as_tensor(np.asarray(v, dt)).to(dev)
                        for v, dt in zip(r, dtypes)]}

    def infer(ictx, ins, attrs):
        # the reference's pure_callback templates: each output's declared
        # shape, -1/None dims the first input's batch dim (the abstract
        # interpreter cannot call ``func``: it has no values)
        from ..analysis.abstract_interp import AbstractVar
        first = (ins.get("X") or [AbstractVar()])[0]
        outs_av = []
        for o, dt in zip(outs, dtypes):
            if o.shape is None or (any(d in (-1, None) for d in o.shape)
                                   and not first.known):
                outs_av.append(AbstractVar())
                continue
            outs_av.append(AbstractVar(tuple(
                int(first.shape[0]) if d in (-1, None) else int(d)
                for d in o.shape), dt.name))
        return {"Out": outs_av}

    _register(op_name, not_differentiable=True, host_op=True,
              infer=infer)(lowering)
    helper = LayerHelper("py_func")
    helper.append_op(op_name, inputs={"X": list(xs)},
                     outputs={"Out": list(outs)}, attrs={})
    return out


__all__ = [
    "adaptive_pool2d", "adaptive_pool3d", "brelu", "deformable_conv", "dice_loss",
    "fsp_matrix", "get_tensor_from_selected_rows", "im2sequence",
    "image_resize_short", "inplace_abn", "lod_append", "lod_reset",
    "merge_selected_rows", "prroi_pool", "psroi_pool", "py_func",
    "random_crop", "roi_align", "roi_pool", "scatter_nd", "soft_relu",
    "stanh",
    "autoincreased_step_counter", "clip", "clip_by_norm",
    "conv2d_transpose", "conv3d", "conv3d_transpose", "crop",
    "elementwise_floordiv", "elementwise_mod", "elementwise_pow",
    "elu", "expand", "expand_as", "gather", "gather_nd",
    "gaussian_random", "gaussian_random_batch_size_like", "group_norm",
    "hard_sigmoid", "hard_swish", "instance_norm", "l2_normalize",
    "label_smooth", "leaky_relu", "logical_xor", "mul", "pad", "pad2d",
    "pool3d", "pow", "prelu", "rank", "reduce_all", "reduce_any",
    "reduce_prod", "relu6", "scatter", "shape", "shard_index", "sign",
    "size", "slice", "smooth_l1", "squeeze", "stack", "strided_slice",
    "sum", "swish", "unbind", "uniform_random",
    "uniform_random_batch_size_like", "unsqueeze", "unstack", "where",
]

# -- the image and detection veneers (the reference's ``:230-238``,
# ``:349-425``, ``:513-605``, ``:655-714``, ``:782-791``) ----------------

def _conv_like(op, input, num_filters, filter_size, stride, padding,  # noqa: A002
               dilation, groups, param_attr, bias_attr, act, name,
               ndim, transpose=False):
    from .nn import _pair
    helper = LayerHelper(op, param_attr=param_attr, name=name)

    def tup(v):
        return [v] * ndim if isinstance(v, int) else list(v)

    ksize = tup(filter_size)
    cin = int(input.shape[1])
    g = int(groups or 1)
    if transpose:
        wshape = [cin, num_filters // g] + ksize
    else:
        wshape = [num_filters, cin // g] + ksize
    w = helper.create_parameter(param_attr, wshape)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(op, inputs={"Input": [input], "Filter": [w]},
                     outputs={"Output": [out]},
                     attrs={"strides": tup(stride),
                            "paddings": tup(padding),
                            "dilations": tup(dilation), "groups": g})
    if bias_attr is not False:
        b = helper.create_parameter(bias_attr, [num_filters],
                                    is_bias=True)
        out2 = helper.create_variable_for_type_inference(input.dtype)
        helper.append_op("elementwise_add", {"X": [out], "Y": [b]},
                         {"Out": [out2]}, {"axis": 1})
        out = out2
    return helper.append_activation(out, act)


def crop(x, shape=None, offsets=None, name=None):  # noqa: A002
    attrs = {}
    if shape is not None and not hasattr(shape, "name"):
        attrs["shape"] = list(shape)
    if offsets is not None and not hasattr(offsets, "name"):
        attrs["offsets"] = list(offsets)
    return _one_out("crop", {"X": x}, attrs, name=name)


def conv2d_transpose(input, num_filters, output_size=None,  # noqa: A002
                     filter_size=None, padding=0, stride=1, dilation=1,
                     groups=None, param_attr=None, bias_attr=None,
                     act=None, name=None):
    return _conv_like("conv2d_transpose", input, num_filters,
                      filter_size, stride, padding, dilation, groups,
                      param_attr, bias_attr, act, name, 2,
                      transpose=True)


def conv3d(input, num_filters, filter_size, stride=1, padding=0,  # noqa: A002
           dilation=1, groups=None, param_attr=None, bias_attr=None,
           act=None, name=None):
    return _conv_like("conv3d", input, num_filters, filter_size, stride,
                      padding, dilation, groups, param_attr, bias_attr,
                      act, name, 3)


def conv3d_transpose(input, num_filters, output_size=None,  # noqa: A002
                     filter_size=None, padding=0, stride=1, dilation=1,
                     groups=None, param_attr=None, bias_attr=None,
                     act=None, name=None):
    return _conv_like("conv3d_transpose", input, num_filters,
                      filter_size, stride, padding, dilation, groups,
                      param_attr, bias_attr, act, name, 3,
                      transpose=True)


def pool3d(input, pool_size=-1, pool_type="max", pool_stride=1,  # noqa: A002
           pool_padding=0, global_pooling=False, ceil_mode=False,
           name=None):
    def tup(v):
        return [v] * 3 if isinstance(v, int) else list(v)

    return _one_out("pool3d", {"X": input},
                    {"ksize": tup(pool_size),
                     "pooling_type": str(pool_type),
                     "strides": tup(pool_stride),
                     "paddings": tup(pool_padding),
                     "global_pooling": bool(global_pooling),
                     "ceil_mode": bool(ceil_mode)}, name=name)


def roi_align(input, rois, pooled_height=1, pooled_width=1,  # noqa: A002
              spatial_scale=1.0, sampling_ratio=-1, rois_num=None,
              name=None):
    from . import detection as _det
    return _det.roi_align(input, rois, pooled_height, pooled_width,
                          spatial_scale, sampling_ratio, rois_num)


def roi_pool(input, rois, pooled_height=1, pooled_width=1,  # noqa: A002
             spatial_scale=1.0, rois_num=None, name=None):
    ins = {"X": input, "ROIs": rois}
    if rois_num is not None:
        ins["RoisNum"] = rois_num
    out, _ = _one_out("roi_pool", ins,
                      {"pooled_height": int(pooled_height),
                       "pooled_width": int(pooled_width),
                       "spatial_scale": float(spatial_scale)},
                      extra_outputs=("Argmax",), name=name)
    return out


def prroi_pool(input, rois, spatial_scale=1.0, pooled_height=1,  # noqa: A002
               pooled_width=1, batch_roi_nums=None, name=None):
    ins = {"X": input, "ROIs": rois}
    if batch_roi_nums is not None:
        ins["BatchRoINums"] = batch_roi_nums
    return _one_out("prroi_pool", ins,
                    {"pooled_height": int(pooled_height),
                     "pooled_width": int(pooled_width),
                     "spatial_scale": float(spatial_scale)}, name=name)


def psroi_pool(input, rois, output_channels, spatial_scale,  # noqa: A002
               pooled_height, pooled_width, rois_num=None, name=None):
    ins = {"X": input, "ROIs": rois}
    if rois_num is not None:
        ins["RoisNum"] = rois_num
    return _one_out("psroi_pool", ins,
                    {"output_channels": int(output_channels),
                     "spatial_scale": float(spatial_scale),
                     "pooled_height": int(pooled_height),
                     "pooled_width": int(pooled_width)}, name=name)


def deformable_conv(input, offset, mask, num_filters, filter_size,  # noqa: A002
                    stride=1, padding=0, dilation=1, groups=None,
                    deformable_groups=None, im2col_step=None,
                    param_attr=None, bias_attr=None,
                    modulated=True, name=None):
    from .nn import _pair
    helper = LayerHelper("deformable_conv", param_attr=param_attr,
                         name=name)
    ksize = _pair(filter_size)
    cin = int(input.shape[1])
    w = helper.create_parameter(param_attr, [num_filters, cin] + ksize)
    op = "deformable_conv" if modulated else "deformable_conv_v1"
    ins = {"Input": [input], "Offset": [offset], "Filter": [w]}
    if modulated:
        ins["Mask"] = [mask]
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(op, inputs=ins, outputs={"Output": [out]},
                     attrs={"strides": _pair(stride),
                            "paddings": _pair(padding),
                            "dilations": _pair(dilation),
                            "groups": int(groups or 1),
                            "deformable_groups":
                                int(deformable_groups or 1)})
    if bias_attr is not False:
        b = helper.create_parameter(bias_attr, [num_filters],
                                    is_bias=True)
        out2 = helper.create_variable_for_type_inference(input.dtype)
        helper.append_op("elementwise_add", {"X": [out], "Y": [b]},
                         {"Out": [out2]}, {"axis": 1})
        out = out2
    return out


def adaptive_pool2d(input, pool_size, pool_type="max",  # noqa: A002
                    require_index=False, name=None):
    """layers/nn.py adaptive_pool2d -> the pool2d lowering's adaptive
    mode (output spatial dims fixed to pool_size)."""
    def tup(v):
        return [v, v] if isinstance(v, int) else list(v)

    return _one_out("pool2d", {"X": input},
                    {"ksize": tup(pool_size),
                     "pooling_type": str(pool_type),
                     "adaptive": True, "strides": [1, 1],
                     "paddings": [0, 0]}, name=name)


def adaptive_pool3d(input, pool_size, pool_type="max",  # noqa: A002
                    require_index=False, name=None):
    def tup(v):
        return [v] * 3 if isinstance(v, int) else list(v)

    return _one_out("pool3d", {"X": input},
                    {"ksize": tup(pool_size),
                     "pooling_type": str(pool_type),
                     "adaptive": True, "strides": [1, 1, 1],
                     "paddings": [0, 0, 0]}, name=name)


def fsp_matrix(x, y):
    """Flow-of-solution-procedure matrix (layers/nn.py fsp_matrix):
    per-sample [C1, C2] Gram of two same-spatial feature maps, HW
    normalized — one batched matmul on the MXU."""
    from .nn import matmul, reshape, transpose
    n, c1 = int(x.shape[0]), int(x.shape[1])
    c2 = int(y.shape[1])
    h, w = int(x.shape[2]), int(x.shape[3])
    xf = reshape(x, [n, c1, h * w])
    yf = reshape(y, [n, c2, h * w])
    g = matmul(xf, transpose(yf, [0, 2, 1]))
    return _one_out("scale", {"X": g}, {"scale": 1.0 / float(h * w),
                                        "bias": 0.0})


def image_resize_short(input, out_short_len,  # noqa: A002
                       resample="BILINEAR"):
    from .nn_extra import image_resize
    h, w = int(input.shape[2]), int(input.shape[3])
    short = min(h, w)
    scale = out_short_len / float(short)
    return image_resize(input,
                        out_shape=[int(round(h * scale)),
                                   int(round(w * scale))],
                        resample=resample)


def inplace_abn(input, act=None, **kwargs):  # noqa: A002
    """In-place activated batch-norm: the port keeps no in-place
    aliasing, so this is batch_norm + act, as the reference's is."""
    from .nn import batch_norm
    return batch_norm(input, act=act, **{k: v for k, v in kwargs.items()
                                         if k != "act_alpha"})


def im2sequence(input, filter_size=1, stride=1, padding=0,  # noqa: A002
                input_image_size=None, out_stride=1, name=None):
    from .nn import _pair
    return _one_out("im2sequence", {"X": input},
                    {"kernels": _pair(filter_size),
                     "strides": _pair(stride),
                     "paddings": _pair(padding) + _pair(padding)},
                    name=name)


def random_crop(x, shape, seed=None):  # noqa: A002
    from .tensor import fill_constant
    import random as _random
    if seed is None:
        seed = _random.randint(-65536, 65535)
    if isinstance(seed, int):
        seed = fill_constant([1], "int64", seed)
    out, _ = _one_out("random_crop", {"X": x, "Seed": seed},
                      {"shape": list(shape)},
                      extra_outputs=("SeedOut",))
    return out


#: the reference's veneers the port has not yet: none
WAITING = ()
