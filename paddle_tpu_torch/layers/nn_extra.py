"""Second tranche of fluid.layers builders — the counterpart of
``paddle_tpu/layers/nn_extra.py``, its loss and sequence group
(``:231-466``): ``log_loss``, ``rank_loss``, ``margin_rank_loss``,
``hinge_loss``, ``bpr_loss``, ``center_loss``, ``cos_sim``,
``npair_loss`` (which raises, as the reference's does),
``teacher_student_sigmoid_loss``, ``huber_loss``, ``linear_chain_crf``,
``exponential_decay``, ``crf_decoding``, ``sums``,
``fill_constant_batch_size_like``, ``warpctc``, ``edit_distance``,
``ctc_greedy_decoder`` and ``row_conv``; and the selection and
activation builders over the dense lowerings (``multiplex``,
``index_sample``, ``masked_select``, ``scatter_nd_add``, ``gather_tree``,
``reverse``, ``selu``, ``mish``), copies of the reference's.

Waiting for ROADMAP A7.2b2, with their lowerings: the image builders
(``:37-170``: ``lrn``, ``pixel_shuffle``, ``space_to_depth``,
``shuffle_channel``, ``temporal_shift``, ``affine_channel``,
``affine_grid``, ``grid_sampler``, the ``resize_*`` family and
``image_resize``, ``crop_tensor``, ``pad_constant_like``, ``unfold``,
``maxout``, ``add_position_encoding``, ``sampling_id``); the
CTR builders (``:297-337``: ``continuous_value_model``, ``data_norm``,
``nce``, ``hsigmoid``); and ``bilinear_tensor_product``,
``spectral_norm`` and ``mean_iou`` (``:467-500``).

``exponential_decay`` builds its step counter, ``increment``, ``floor``
and ``elementwise_pow`` into the Program: the counter is a persistable
variable the executor updates in place, so a captured step advances it
on every replay and the optimizer's update ops read the lr the graph
computed.
"""



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


# -- structured ---------------------------------------------------------


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
