"""Second tranche of fluid.layers builders — the counterpart of
``paddle_tpu/layers/nn_extra.py``, whole: the image builders (``lrn``,
``pixel_shuffle``, ``space_to_depth``, ``shuffle_channel``,
``temporal_shift``, ``affine_channel``, ``affine_grid``,
``grid_sampler``, the ``resize_*`` family and ``image_resize``,
``crop_tensor``, ``pad_constant_like``, ``unfold``), ``maxout``,
``add_position_encoding``, ``sampling_id``; the loss and sequence group
(``log_loss``, ``rank_loss``, ``margin_rank_loss``, ``hinge_loss``,
``bpr_loss``, ``center_loss``, ``cos_sim``, ``npair_loss`` (which
raises, as the reference's does), ``teacher_student_sigmoid_loss``,
``huber_loss``, ``linear_chain_crf``, ``exponential_decay``,
``crf_decoding``, ``sums``, ``fill_constant_batch_size_like``,
``warpctc``, ``edit_distance``, ``ctc_greedy_decoder``, ``row_conv``);
the CTR builders (``continuous_value_model``, ``data_norm``, ``nce``,
``hsigmoid``); the selection and activation builders (``multiplex``,
``index_sample``, ``masked_select``, ``scatter_nd_add``,
``gather_tree``, ``reverse``, ``selu``, ``mish``); and
``bilinear_tensor_product``, ``spectral_norm`` and ``mean_iou``.
Copies of the reference's builders.

``exponential_decay`` builds its step counter, ``increment``, ``floor``
and ``elementwise_pow`` into the Program: the counter is a persistable
variable the executor updates in place, so a captured step advances it
on every replay and the optimizer's update ops read the lr the graph
computed.
"""

from __future__ import annotations

from ..layer_helper import LayerHelper


def _one_out(op, inputs, attrs=None, out_slot="Out", name=None, dtype=None,
             extra_outputs=()):
    helper = LayerHelper(op, name=name)
    first = next(iter(inputs.values()))
    ref = first[0] if isinstance(first, (list, tuple)) else first
    out = helper.create_variable_for_type_inference(
        dtype or getattr(ref, "dtype", "float32"))
    outputs = {out_slot: out}
    extras = []
    for slot in extra_outputs:
        v = helper.create_variable_for_type_inference(
            dtype or getattr(ref, "dtype", "float32"))
        outputs[slot] = v
        extras.append(v)
    helper.append_op(op, inputs=inputs, outputs=outputs, attrs=attrs or {})
    return (out, *extras) if extras else out


# -- normalization / image ---------------------------------------------


def lrn(input, n=5, k=1.0, alpha=1e-4, beta=0.75, name=None):
    """fluid.layers.lrn parity (lrn_op.cc)."""
    out, _ = _one_out("lrn", {"X": input},
                      {"n": n, "k": k, "alpha": alpha, "beta": beta},
                      name=name, extra_outputs=("MidOut",))
    return out


def pixel_shuffle(x, upscale_factor, data_format="NCHW", name=None):
    return _one_out("pixel_shuffle", {"X": x},
                    {"upscale_factor": upscale_factor,
                     "data_format": data_format}, name=name)


def space_to_depth(x, blocksize, name=None):
    return _one_out("space_to_depth", {"X": x},
                    {"blocksize": blocksize}, name=name)


def shuffle_channel(x, group, name=None):
    return _one_out("shuffle_channel", {"X": x}, {"group": group},
                    name=name)


def temporal_shift(x, seg_num, shift_ratio=0.25, name=None):
    return _one_out("temporal_shift", {"X": x},
                    {"seg_num": seg_num, "shift_ratio": shift_ratio},
                    name=name)


def affine_channel(x, scale, bias, data_layout="NCHW", name=None):
    return _one_out("affine_channel",
                    {"X": x, "Scale": scale, "Bias": bias},
                    {"data_layout": data_layout}, name=name)


def affine_grid(theta, out_shape, align_corners=True, name=None):
    inputs = {"Theta": theta}
    attrs = {"align_corners": align_corners}
    if isinstance(out_shape, (list, tuple)):
        attrs["output_shape"] = [int(s) for s in out_shape]
    else:
        inputs["OutputShape"] = out_shape
    return _one_out("affine_grid", inputs, attrs, out_slot="Output",
                    name=name)


def grid_sampler(x, grid, mode="bilinear", padding_mode="zeros",
                 align_corners=True, name=None):
    return _one_out("grid_sampler", {"X": x, "Grid": grid},
                    {"mode": mode, "padding_mode": padding_mode,
                     "align_corners": align_corners},
                    out_slot="Output", name=name)


def _resize(op, input, out_shape, scale, name, extra=None):
    attrs = dict(extra or {})
    if out_shape is not None:
        keys = ["out_w"] if op.startswith("linear") else (
            ["out_d", "out_h", "out_w"] if op.startswith("trilinear")
            else ["out_h", "out_w"])
        for k_, v in zip(keys, out_shape):
            attrs[k_] = int(v)
    if scale:
        attrs["scale"] = float(scale)
    return _one_out(op, {"X": input}, attrs, name=name)


def resize_linear(input, out_shape=None, scale=None, name=None):
    return _resize("linear_interp_v2", input, out_shape, scale, name)


def resize_bilinear(input, out_shape=None, scale=None, name=None):
    return _resize("bilinear_interp_v2", input, out_shape, scale, name)


def resize_trilinear(input, out_shape=None, scale=None, name=None):
    return _resize("trilinear_interp_v2", input, out_shape, scale, name)


def resize_nearest(input, out_shape=None, scale=None, name=None):
    return _resize("nearest_interp_v2", input, out_shape, scale, name)


def image_resize(input, out_shape=None, scale=None, resample="BILINEAR",
                 name=None):
    op = {"BILINEAR": "bilinear_interp_v2",
          "NEAREST": "nearest_interp_v2",
          "BICUBIC": "bicubic_interp_v2",
          "TRILINEAR": "trilinear_interp_v2",
          "LINEAR": "linear_interp_v2"}[resample.upper()]
    return _resize(op, input, out_shape, scale, name)


def crop_tensor(x, shape=None, offsets=None, name=None):
    attrs = {}
    inputs = {"X": x}
    if isinstance(shape, (list, tuple)):
        attrs["shape"] = [int(s) for s in shape]
    elif shape is not None:
        inputs["Shape"] = shape
    if isinstance(offsets, (list, tuple)):
        attrs["offsets"] = [int(o) for o in offsets]
    elif offsets is not None:
        inputs["Offsets"] = offsets
    return _one_out("crop_tensor", inputs, attrs, name=name)


def pad_constant_like(x, y, pad_value=0.0, name=None):
    return _one_out("pad_constant_like", {"X": x, "Y": y},
                    {"pad_value": pad_value}, name=name)


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    def _pair(v):
        return [v, v] if isinstance(v, int) else list(v)
    return _one_out("unfold", {"X": x},
                    {"kernel_sizes": _pair(kernel_sizes),
                     "strides": _pair(strides),
                     "paddings": _pair(paddings),
                     "dilations": _pair(dilations)},
                    out_slot="Y", name=name)


def maxout(x, groups, axis=1, name=None):
    return _one_out("maxout", {"X": x}, {"groups": groups, "axis": axis},
                    name=name)


def add_position_encoding(input, alpha=1.0, beta=1.0, name=None):
    return _one_out("add_position_encoding", {"X": input},
                    {"alpha": alpha, "beta": beta}, name=name)


# -- selection ----------------------------------------------------------


def multiplex(inputs, index, name=None):
    return _one_out("multiplex", {"X": list(inputs), "Ids": index},
                    name=name)


def index_sample(x, index, name=None):
    return _one_out("index_sample", {"X": x, "Index": index}, name=name)


def masked_select(x, mask, name=None):
    """Eager-only (an output shape that depends on the values; the
    lowering raises in the executor)."""
    return _one_out("masked_select", {"X": x, "Mask": mask},
                    out_slot="Y", name=name)


def scatter_nd_add(ref, index, updates, name=None):
    return _one_out("scatter_nd_add",
                    {"X": ref, "Index": index, "Updates": updates},
                    name=name)


def gather_tree(ids, parents):
    return _one_out("gather_tree", {"Ids": ids, "Parents": parents})


def reverse(x, axis, name=None):
    return _one_out("reverse", {"X": x},
                    {"axis": axis if isinstance(axis, (list, tuple))
                     else [axis]}, name=name)


def sampling_id(x, min=0.0, max=1.0, seed=0, dtype="int64", name=None):
    return _one_out("sampling_id", {"X": x},
                    {"min": min, "max": max, "seed": seed}, name=name,
                    dtype=dtype)


# -- activations --------------------------------------------------------


def selu(x, scale=None, alpha=None, name=None):
    attrs = {}
    if scale is not None:
        attrs["scale"] = scale
    if alpha is not None:
        attrs["alpha"] = alpha
    return _one_out("selu", {"X": x}, attrs, name=name)


def mish(x, threshold=20.0, name=None):
    return _one_out("mish", {"X": x}, {"threshold": threshold}, name=name)


# -- losses -------------------------------------------------------------


def log_loss(input, label, epsilon=1e-4, name=None):
    return _one_out("log_loss", {"Predicted": input, "Labels": label},
                    {"epsilon": epsilon}, out_slot="Loss", name=name)


def rank_loss(label, left, right, name=None):
    return _one_out("rank_loss",
                    {"Label": label, "Left": left, "Right": right},
                    name=name)


def margin_rank_loss(label, left, right, margin=0.1, name=None):
    out, _ = _one_out("margin_rank_loss",
                      {"X1": left, "X2": right, "Label": label},
                      {"margin": margin}, name=name,
                      extra_outputs=("Activated",))
    return out


def hinge_loss(input, label, name=None):
    return _one_out("hinge_loss", {"Logits": input, "Labels": label},
                    out_slot="Loss", name=name)


def bpr_loss(input, label, name=None):
    return _one_out("bpr_loss", {"X": input, "Label": label},
                    out_slot="Y", name=name)


def center_loss(input, label, centers, update_rate, num_classes,
                update_center=True, name=None):
    loss, diff, centers_out = _one_out(
        "center_loss",
        {"X": input, "Label": label, "Centers": centers,
         "CenterUpdateRate": update_rate},
        {"cluster_num": num_classes, "need_update": update_center},
        out_slot="Loss", name=name,
        extra_outputs=("SampleCenterDiff", "CentersOut"))
    return loss, centers_out


def cos_sim(X, Y, name=None):
    out, _, _ = _one_out("cos_sim", {"X": X, "Y": Y}, name=name,
                         extra_outputs=("XNorm", "YNorm"))
    return out


def npair_loss(anchor, positive, labels, l2_reg=0.002):
    raise NotImplementedError(
        "npair_loss: compose from matmul + softmax_with_cross_entropy")


def teacher_student_sigmoid_loss(input, label, soft_max_up_bound=15.0,
                                 soft_max_lower_bound=-15.0):
    return _one_out("teacher_student_sigmoid_loss",
                    {"X": input, "Label": label}, out_slot="Y")


def huber_loss(input, label, delta, name=None):
    return _one_out("huber_loss", {"X": input, "Y": label},
                    {"delta": delta}, name=name)


# -- CTR / structured ---------------------------------------------------


def continuous_value_model(input, cvm, use_cvm=True):
    return _one_out("cvm", {"X": input, "CVM": cvm},
                    {"use_cvm": use_cvm}, out_slot="Y")


def data_norm(input, batch_size, batch_sum, batch_square_sum, slot_dim=-1,
              name=None):
    out, _, _ = _one_out(
        "data_norm",
        {"X": input, "BatchSize": batch_size, "BatchSum": batch_sum,
         "BatchSquareSum": batch_square_sum},
        {"slot_dim": slot_dim}, out_slot="Y", name=name,
        extra_outputs=("Means", "Scales"))
    return out


def nce(input, label, weight, bias=None, num_total_classes=None,
        num_neg_samples=10, sampler="uniform", name=None):
    sampler_id = {"uniform": 0, "log_uniform": 1, "custom_dist": 2}[sampler]
    inputs = {"Input": input, "Label": label, "Weight": weight}
    if bias is not None:
        inputs["Bias"] = bias
    cost, _, _ = _one_out(
        inputs=inputs, op="nce",
        attrs={"num_total_classes": num_total_classes,
               "num_neg_samples": num_neg_samples, "sampler": sampler_id},
        out_slot="Cost", name=name,
        extra_outputs=("SampleLogits", "SampleLabels"))
    return cost


def hsigmoid(input, label, num_classes, weight, bias=None, name=None):
    inputs = {"X": input, "Label": label, "W": weight}
    if bias is not None:
        inputs["Bias"] = bias
    out, _ = _one_out("hierarchical_sigmoid", inputs,
                      {"num_classes": num_classes}, name=name,
                      extra_outputs=("PreOut",))
    return out


def linear_chain_crf(input, label, param_attr=None, length=None, name=None):
    """Returns the per-sequence negative log likelihood; the Transition
    parameter must be created by the caller (shape (num_tags+2, num_tags))
    and passed via param_attr as an existing Variable."""
    inputs = {"Emission": input, "Label": label, "Transition": param_attr}
    if length is not None:
        inputs["Length"] = length
    ll, _, _, _ = _one_out(
        "linear_chain_crf", inputs, out_slot="LogLikelihood", name=name,
        extra_outputs=("Alpha", "EmissionExps", "TransitionExps"))
    return ll


def exponential_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    """fluid.layers.exponential_decay parity
    (layers/learning_rate_scheduler.py:94): builds the decay INTO the
    program — a persistable step counter auto-incremented every run
    feeds ``lr * decay_rate^(step/decay_steps)`` — and returns the lr
    VARIABLE, which the optimizers accept as learning_rate (static-mode
    only, like the reference's layers scheduler)."""
    from .tensor import create_global_var, increment
    from ..framework import unique_name

    counter = create_global_var(
        shape=[1], value=0.0, dtype="float32", persistable=True,
        name=unique_name.generate("lr_decay_step"))
    increment(counter, value=1.0)
    div = _one_out("scale", {"X": counter},
                   {"scale": 1.0 / float(decay_steps), "bias": 0.0})
    if staircase:
        div = _one_out("floor", {"X": div})
    base = _one_out("fill_constant_batch_size_like", {"Input": div},
                    {"shape": [1], "dtype": "float32",
                     "value": float(decay_rate)})
    factor = _one_out("elementwise_pow", {"X": base, "Y": div})
    lr = _one_out("scale", {"X": factor},
                  {"scale": float(learning_rate), "bias": 0.0})
    lr.shape = (1,)
    return lr


def crf_decoding(input, param_attr, label=None, length=None, name=None):
    """fluid.layers.crf_decoding parity (crf_decoding_op.h): Viterbi
    decode with the linear_chain_crf Transition variable. Without Label
    returns the best path [b, t] (0 past each length); with Label
    returns the 0/1 per-position correctness mask the reference emits."""
    inputs = {"Emission": input, "Transition": param_attr}
    if label is not None:
        inputs["Label"] = label
    if length is not None:
        inputs["Length"] = length
    return _one_out("crf_decoding", inputs, out_slot="ViterbiPath",
                    name=name, dtype="int64")


def sums(input, out=None):  # noqa: A002
    """fluid.layers.sums parity: elementwise sum of a list of vars."""
    res = _one_out("sum", {"X": list(input)})
    res.shape = next((tuple(v.shape) for v in input
                      if getattr(v, "shape", None) is not None), None)
    if out is not None:
        helper = LayerHelper("sums_assign")
        helper.append_op("assign", {"X": [res]}, {"Out": [out]}, {})
        return out
    return res


def fill_constant_batch_size_like(input, shape, dtype, value,  # noqa: A002
                                  input_dim_idx=0, output_dim_idx=0):
    """fluid.layers.fill_constant_batch_size_like parity."""
    out = _one_out("fill_constant_batch_size_like", {"Input": input},
                   {"shape": list(shape), "dtype": dtype,
                    "value": float(value),
                    "input_dim_idx": int(input_dim_idx),
                    "output_dim_idx": int(output_dim_idx)}, dtype=dtype)
    out.shape = tuple(shape)
    return out


def warpctc(input, label, blank=0, norm_by_times=False, input_length=None,
            label_length=None):
    inputs = {"Logits": input, "Label": label}
    if input_length is not None:
        inputs["LogitsLength"] = input_length
    if label_length is not None:
        inputs["LabelLength"] = label_length
    loss, _ = _one_out("warpctc", inputs,
                       {"blank": blank, "norm_by_times": norm_by_times},
                       out_slot="Loss", extra_outputs=("WarpCTCGrad",))
    return loss


def edit_distance(input, label, normalized=True, input_length=None,
                  label_length=None):
    inputs = {"Hyps": input, "Refs": label}
    if input_length is not None:
        inputs["HypsLength"] = input_length
    if label_length is not None:
        inputs["RefsLength"] = label_length
    dist, seq_num = _one_out("edit_distance", inputs,
                             {"normalized": normalized},
                             extra_outputs=("SequenceNum",))
    return dist, seq_num


def ctc_greedy_decoder(input, blank, input_length=None, name=None):
    """Dense redesign: argmax over classes then ctc_align collapse."""
    from . import nn as _nn
    idx = _nn.topk(input, 1)[1]
    idx2 = _nn.reshape(idx, [0, -1])
    inputs = {"Input": idx2}
    out, lens = _one_out("ctc_align", inputs, {"blank": blank,
                                               "merge_repeated": True},
                         out_slot="Output", name=name,
                         extra_outputs=("OutputLength",))
    return out, lens


def row_conv(input, future_context_size, param_attr=None, act=None):
    """Creates the lookahead filter parameter internally."""
    helper = LayerHelper("row_conv")
    d = input.shape[-1]
    filt = helper.create_parameter(
        param_attr, [future_context_size + 1, d], dtype=input.dtype)
    return helper.append_activation(
        _one_out("row_conv", {"X": input, "Filter": filt}), act)


def bilinear_tensor_product(x, y, size, param_attr=None, bias_attr=None,
                            act=None, name=None):
    helper = LayerHelper("bilinear_tensor_product", name=name)
    dx, dy = x.shape[-1], y.shape[-1]
    w = helper.create_parameter(param_attr, [size, dx, dy],
                                dtype=x.dtype)
    inputs = {"X": x, "Y": y, "Weight": w}
    if bias_attr is not False:
        b = helper.create_parameter(bias_attr, [1, size], dtype=x.dtype,
                                    is_bias=True)
        inputs["Bias"] = b
    return helper.append_activation(
        _one_out("bilinear_tensor_product", inputs, name=name), act)


def spectral_norm(weight, dim=0, power_iters=1, eps=1e-12, name=None):
    import numpy as _np

    helper = LayerHelper("spectral_norm", name=name)
    h = weight.shape[dim]
    w = int(_np.prod(weight.shape)) // h
    u = helper.create_parameter(None, [h], dtype=weight.dtype)
    v = helper.create_parameter(None, [w], dtype=weight.dtype)
    return _one_out("spectral_norm", {"Weight": weight, "U": u, "V": v},
                    {"dim": dim, "power_iters": power_iters, "eps": eps},
                    name=name)


def mean_iou(input, label, num_classes):
    miou, wrong, correct = _one_out(
        "mean_iou", {"Predictions": input, "Labels": label},
        {"num_classes": num_classes}, out_slot="OutMeanIou",
        extra_outputs=("OutWrong", "OutCorrect"))
    return miou, wrong, correct
