"""Loss layer builders (analog of fluid/layers/loss.py) — a copy of
``paddle_tpu/layers/loss.py``."""

from __future__ import annotations

from typing import Optional

from ..layer_helper import LayerHelper


def cross_entropy(input, label, soft_label: bool = False,
                  ignore_index: int = -100, name=None):
    helper = LayerHelper("cross_entropy", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("cross_entropy", inputs={"X": input, "Label": label},
                     outputs={"Y": out},
                     attrs={"soft_label": soft_label,
                            "ignore_index": ignore_index})
    return out


def softmax_with_cross_entropy(logits, label, soft_label: bool = False,
                               ignore_index: int = -100, axis: int = -1,
                               return_softmax: bool = False, name=None):
    helper = LayerHelper("softmax_with_cross_entropy", name=name)
    softmax = helper.create_variable_for_type_inference(logits.dtype)
    loss = helper.create_variable_for_type_inference(logits.dtype)
    helper.append_op("softmax_with_cross_entropy",
                     inputs={"Logits": logits, "Label": label},
                     outputs={"Softmax": softmax, "Loss": loss},
                     attrs={"soft_label": soft_label,
                            "ignore_index": ignore_index, "axis": axis})
    if return_softmax:
        return loss, softmax
    return loss


def square_error_cost(input, label, name=None):
    helper = LayerHelper("square_error_cost", name=name)
    diff = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("elementwise_sub", inputs={"X": input, "Y": label},
                     outputs={"Out": diff})
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("square", inputs={"X": diff}, outputs={"Out": out})
    return out


def sigmoid_cross_entropy_with_logits(x, label, ignore_index=-100,
                                      normalize=False, name=None):
    helper = LayerHelper("sigmoid_cross_entropy_with_logits", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("sigmoid_cross_entropy_with_logits",
                     inputs={"X": x, "Label": label}, outputs={"Out": out},
                     attrs={"ignore_index": ignore_index,
                            "normalize": normalize})
    return out
