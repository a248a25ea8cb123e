"""Functional layer builders (analog of python/paddle/fluid/layers/) —
the counterpart of ``paddle_tpu/layers/``: ``nn.py``, ``loss.py``,
``tensor.py``, ``sequence_lod.py`` and ``dynamic_rnn.py`` whole, and
``nn_extra.py``'s loss and sequence group and ``nn_veneer.py``'s
``slice`` / ``squeeze`` / ``stack``, whose names this package exports as
the reference's does. ``control_flow``, ``detection``, the rest of
``nn_extra`` and ``nn_veneer`` wait for ROADMAP A7.2b, with the op
lowerings they emit."""

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
from .nn_extra import (bpr_loss, center_loss, cos_sim, crf_decoding,
                       ctc_greedy_decoder, edit_distance, exponential_decay,
                       fill_constant_batch_size_like, hinge_loss, huber_loss,
                       linear_chain_crf, log_loss, margin_rank_loss,
                       rank_loss, row_conv, sums,
                       teacher_student_sigmoid_loss, warpctc)
from .nn_veneer import slice, squeeze, stack  # noqa: A004
from .dynamic_rnn import DynamicRNN
from .sequence_lod import (dynamic_lstm, sequence_concat, sequence_conv,
                           sequence_enumerate, sequence_expand,
                           sequence_expand_as, sequence_first_step,
                           sequence_last_step, sequence_mask, sequence_pad,
                           sequence_pool, sequence_reverse, sequence_slice,
                           sequence_softmax, sequence_unpad)
