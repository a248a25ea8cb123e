"""Sequence layer builders over the padded+lengths design — a copy of
``paddle_tpu/layers/sequence_lod.py``.

Analog of python/paddle/fluid/layers/sequence_lod.py (sequence_pool,
sequence_conv, sequence_softmax, sequence_pad/unpad, ...). Fluid threads
raggedness through LoD metadata on the tensor; here, as in the JAX
package, a "sequence" is a padded [batch, time, ...] tensor plus an
explicit per-row length tensor, and every builder takes that
``sequence_length`` beside the data. The lowerings mask and gather so
padding never leaks into results (``ops/rnn_ops.py``, sequence section),
with static shapes, so a captured step holds them.
"""

from __future__ import annotations

from ..layer_helper import LayerHelper, build_simple_op


def _seq_op(op_type, inputs, attrs, n_outs=("Out",), dtype="float32",
            out_shapes=None, out_dtypes=None):
    return build_simple_op(op_type, inputs, attrs, out_slots=n_outs,
                           dtype=dtype, out_shapes=out_shapes,
                           out_dtypes=out_dtypes)


def _shape_of(v):
    return list(v.shape) if getattr(v, "shape", None) is not None else None


def sequence_pool(input, pool_type, sequence_length, is_test=False):  # noqa: A002
    """[b, s, d] + lengths [b] -> [b, d]; pool_type in
    sum/average/max/last/first (fluid layers.sequence_pool)."""
    shp = _shape_of(input)
    return _seq_op("sequence_pool",
                   {"X": [input], "Length": [sequence_length]},
                   {"pooltype": str(pool_type).upper()},
                   out_shapes={"Out": [shp[0]] + shp[2:] if shp else None})


def sequence_first_step(input, sequence_length):  # noqa: A002
    return sequence_pool(input, "FIRST", sequence_length)


def sequence_last_step(input, sequence_length):  # noqa: A002
    return sequence_pool(input, "LAST", sequence_length)


def sequence_softmax(input, sequence_length):  # noqa: A002
    return _seq_op("sequence_softmax",
                   {"X": [input], "Length": [sequence_length]}, {},
                   out_shapes={"Out": _shape_of(input)})


def sequence_reverse(x, sequence_length):
    return _seq_op("sequence_reverse",
                   {"X": [x], "Length": [sequence_length]}, {},
                   out_shapes={"Out": _shape_of(x)})


def sequence_mask(x, maxlen, dtype="int64"):
    """lengths [b] -> 0/1 mask [b, maxlen] (layers.sequence_mask);
    maxlen must be a static int (static shapes)."""
    return _seq_op("sequence_mask", {"X": [x]},
                   {"maxlen": int(maxlen), "out_dtype": dtype},
                   n_outs=("Y",), dtype=dtype)


def sequence_pad(x, pad_value, sequence_length, padded_length):
    """Packed rows [total, d] + lengths -> (padded [b, maxlen, d],
    lengths) (layers.sequence_pad); padded_length must be static."""
    return _seq_op(
        "sequence_pad",
        {"X": [x], "PadValue": [pad_value], "Length": [sequence_length]},
        {"padded_length": int(padded_length)}, n_outs=("Out", "Length"),
        out_dtypes={"Length": "int64"})


def sequence_unpad(x, sequence_length):
    """Padded [b, s, d] -> (packed [b*s, d] front-compacted, total)
    (layers.sequence_unpad under static shapes)."""
    return _seq_op("sequence_unpad",
                   {"X": [x], "Length": [sequence_length]}, {},
                   n_outs=("Out", "Total"),
                   out_dtypes={"Total": "int64"})


def sequence_conv(input, num_filters, filter_size=3, filter_stride=1,  # noqa: A002
                  padding=True, sequence_length=None, param_attr=None,
                  bias_attr=None, act=None):
    """Context-window convolution over time (layers.sequence_conv):
    input [b, s, d] -> [b, s, num_filters]. Only stride 1 is supported
    (same restriction as the reference); out-of-bounds context rows are
    zero (``padding`` is accepted for signature parity)."""
    if int(filter_stride) != 1:
        raise ValueError("sequence_conv only supports filter_stride=1")
    helper = LayerHelper("sequence_conv", param_attr=param_attr)
    d = input.shape[-1]
    w = helper.create_parameter(param_attr, [filter_size * d, num_filters])
    inputs = {"X": [input], "Filter": [w]}
    if sequence_length is not None:
        inputs["Length"] = [sequence_length]
    out = helper.create_variable_for_type_inference()
    shp = _shape_of(input)
    if shp:
        out.shape = shp[:2] + [num_filters]
    helper.append_op("sequence_conv", inputs=inputs,
                     outputs={"Out": [out]},
                     attrs={"contextLength": int(filter_size),
                            "contextStart": -(int(filter_size) - 1) // 2,
                            "contextStride": int(filter_stride)})
    if bias_attr is not False:
        b = helper.create_parameter(bias_attr, [num_filters], is_bias=True)
        out2 = helper.create_variable_for_type_inference()
        out2.shape = out.shape
        helper.append_op("elementwise_add", {"X": [out], "Y": [b]},
                         {"Out": [out2]}, {"axis": -1})
        out = out2
    return helper.append_activation(out, act)


def dynamic_lstm(input, size, sequence_length=None, use_peepholes=True,  # noqa: A002
                 is_reverse=False, param_attr=None, bias_attr=None,
                 gate_activation="sigmoid", cell_activation="tanh",
                 candidate_activation="tanh", dtype="float32", name=None):
    """fluid.layers.dynamic_lstm parity (layers/nn.py dynamic_lstm; op
    lstm_op.cc): classic LSTM over a PRE-PROJECTED input [b, s, 4h]
    (``size`` = 4h, the caller's fc supplies x·W). Padded+lengths
    redesign: pass ``sequence_length`` instead of LoD. Returns
    (hidden, cell), both [b, s, h]."""
    helper = LayerHelper("dynamic_lstm", param_attr=param_attr, name=name)
    h = int(size) // 4
    w = helper.create_parameter(param_attr, [h, 4 * h], dtype=dtype)
    bias_size = 7 * h if use_peepholes else 4 * h
    b = helper.create_parameter(bias_attr, [1, bias_size], dtype=dtype,
                                is_bias=True)
    inputs = {"Input": [input], "Weight": [w], "Bias": [b]}
    if sequence_length is not None:
        inputs["Length"] = [sequence_length]
    hidden = helper.create_variable_for_type_inference(dtype)
    cell = helper.create_variable_for_type_inference(dtype)
    shp = _shape_of(input)
    if shp:
        hidden.shape = cell.shape = shp[:2] + [h]
    helper.append_op("dynamic_lstm", inputs=inputs,
                     outputs={"Hidden": [hidden], "Cell": [cell]},
                     attrs={"use_peepholes": bool(use_peepholes),
                            "is_reverse": bool(is_reverse),
                            "gate_activation": str(gate_activation),
                            "cell_activation": str(cell_activation),
                            "candidate_activation":
                                str(candidate_activation)})
    return hidden, cell


def sequence_slice(input, offset, length):  # noqa: A002
    """Per-row [offset, offset+length) slice, front-aligned and
    zero-padded (layers.sequence_slice)."""
    return _seq_op("sequence_slice",
                   {"X": [input], "Offset": [offset], "Length": [length]},
                   {})


def sequence_concat(input, sequence_lengths):  # noqa: A002
    """Ragged concat along time: list of padded [b, s_i, d] + list of
    lengths -> (padded [b, sum(s_i), d], total lengths)
    (layers.sequence_concat)."""
    return _seq_op("sequence_concat",
                   {"X": list(input), "Length": list(sequence_lengths)},
                   {}, n_outs=("Out", "Length"),
                   out_dtypes={"Length": "int64"})


def sequence_enumerate(input, win_size, pad_value=0,  # noqa: A002
                       sequence_length=None):
    """Sliding windows of ids [b, s] -> [b, s, win_size]
    (layers.sequence_enumerate)."""
    inputs = {"X": [input]}
    if sequence_length is not None:
        inputs["Length"] = [sequence_length]
    return _seq_op("sequence_enumerate", inputs,
                   {"win_size": int(win_size), "pad_value": int(pad_value)},
                   dtype="int64")


def sequence_expand_as(x, sequence_length, maxlen):
    """Broadcast [b, d] over time to [b, maxlen, d], masked per row
    (layers.sequence_expand_as under static shapes)."""
    return _seq_op("sequence_expand_as",
                   {"X": [x], "Length": [sequence_length]},
                   {"maxlen": int(maxlen)})


def sequence_expand(x, times):
    """Fixed-ratio row repeat (beam-search form of
    layers.sequence_expand)."""
    return _seq_op("sequence_expand", {"X": [x]}, {"times": int(times)})


__all__ = [
    "sequence_concat", "sequence_conv", "sequence_enumerate",
    "sequence_expand", "sequence_expand_as", "sequence_first_step",
    "sequence_last_step", "sequence_mask", "sequence_pad",
    "sequence_pool", "sequence_reverse", "sequence_slice",
    "sequence_softmax", "sequence_unpad",
]
