"""Functional layer builders (analog of python/paddle/fluid/layers/) —
the counterpart of ``paddle_tpu/layers/``: ``nn.py``, ``loss.py`` and
``tensor.py``, whose names this package exports. ``control_flow``,
``nn_extra``, ``nn_veneer``, ``dynamic_rnn``, ``detection`` and
``sequence_lod`` wait for ROADMAP A7.2, with the op lowerings they
emit."""

from .nn import *  # noqa: F401,F403
from .nn import (accuracy, batch_norm, cast, concat, conv2d, data, dropout,
                 elementwise_add, elementwise_div, elementwise_mul,
                 elementwise_sub, embedding, fc, flatten, gelu, layer_norm,
                 matmul, mean, one_hot, pool2d, reduce_max, reduce_mean,
                 reduce_min, reduce_sum, relu, reshape, scale, sigmoid,
                 softmax, split, tanh, topk, transpose)
from .loss import (cross_entropy, sigmoid_cross_entropy_with_logits,
                   softmax_with_cross_entropy, square_error_cost)
from .tensor import (argmax, assign, create_global_var, create_parameter,
                     fill_constant, increment, ones, zeros)
