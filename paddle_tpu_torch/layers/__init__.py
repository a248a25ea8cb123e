"""Functional layer builders (analog of python/paddle/fluid/layers/) —
the counterpart of ``paddle_tpu/layers/``: ``nn.py``, ``loss.py``,
``tensor.py``, ``sequence_lod.py``, ``dynamic_rnn.py`` and
``control_flow.py`` whole, ``nn_extra.py``'s loss, sequence, selection
and activation builders and ``nn_veneer.py``'s dense half, whose names
this package exports as the reference's does. ``detection``, the image
builders of ``nn_extra`` and the image and detection veneers
(``nn_veneer.WAITING``) wait for ROADMAP A7.2b2, with the op lowerings
they emit."""

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
from .control_flow import (While, case, cond, equal, greater_equal,
                           greater_than, less_equal, less_than, logical_and,
                           logical_not, logical_or, not_equal, switch_case,
                           while_loop)
from .nn_extra import (bpr_loss, center_loss, cos_sim, crf_decoding,
                       ctc_greedy_decoder, edit_distance, exponential_decay,
                       fill_constant_batch_size_like, gather_tree,
                       hinge_loss, huber_loss, index_sample,
                       linear_chain_crf, log_loss, margin_rank_loss,
                       masked_select, mish, multiplex, rank_loss, reverse,
                       row_conv, scatter_nd_add, selu, sums,
                       teacher_student_sigmoid_loss, warpctc)
from .nn_veneer import (brelu, dice_loss,  # noqa: A004
                        get_tensor_from_selected_rows, lod_append,
                        lod_reset, merge_selected_rows, py_func,
                        scatter_nd, soft_relu, stanh,
                        autoincreased_step_counter, clip, clip_by_norm,
                        elementwise_floordiv, elementwise_mod,
                        elementwise_pow, elu, expand, expand_as,
                        gather, gather_nd, gaussian_random,
                        gaussian_random_batch_size_like, group_norm,
                        hard_sigmoid, hard_swish, instance_norm,
                        l2_normalize, label_smooth, leaky_relu,
                        logical_xor, mul, pad, pad2d, pow,
                        prelu, rank, reduce_all, reduce_any,
                        reduce_prod, relu6, scatter, shape,
                        shard_index, sign, size, slice, smooth_l1,
                        squeeze, stack, strided_slice, sum, swish,
                        unbind, uniform_random,
                        uniform_random_batch_size_like, unsqueeze,
                        unstack, where)
from .dynamic_rnn import DynamicRNN
from .sequence_lod import (dynamic_lstm, sequence_concat, sequence_conv,
                           sequence_enumerate, sequence_expand,
                           sequence_expand_as, sequence_first_step,
                           sequence_last_step, sequence_mask, sequence_pad,
                           sequence_pool, sequence_reverse, sequence_slice,
                           sequence_softmax, sequence_unpad)
