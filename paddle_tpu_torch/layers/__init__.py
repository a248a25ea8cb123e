"""Functional layer builders (analog of python/paddle/fluid/layers/) —
the counterpart of ``paddle_tpu/layers/``, whole: ``nn.py``,
``loss.py``, ``tensor.py``, ``sequence_lod.py``, ``dynamic_rnn.py``,
``control_flow.py``, ``detection.py``, ``nn_extra.py`` and
``nn_veneer.py``, whose names this package exports as the reference's
does."""

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
from .nn_extra import (add_position_encoding, affine_channel, affine_grid,
                       bilinear_tensor_product, bpr_loss, center_loss,
                       continuous_value_model, cos_sim, crf_decoding,
                       crop_tensor,
                       ctc_greedy_decoder, data_norm, edit_distance,
                       exponential_decay, fill_constant_batch_size_like,
                       gather_tree, grid_sampler, hinge_loss, hsigmoid,
                       huber_loss, image_resize, index_sample,
                       linear_chain_crf, log_loss, lrn, margin_rank_loss,
                       masked_select, maxout, mean_iou, mish, multiplex,
                       nce, pad_constant_like, pixel_shuffle, rank_loss,
                       resize_bilinear, resize_linear, resize_nearest,
                       resize_trilinear, reverse, row_conv, sampling_id,
                       scatter_nd_add, selu, shuffle_channel,
                       space_to_depth, spectral_norm, sums,
                       teacher_student_sigmoid_loss,
                       temporal_shift, unfold, warpctc)
from .nn_veneer import (adaptive_pool2d, adaptive_pool3d, brelu, deformable_conv,
                        dice_loss, fsp_matrix,
                        get_tensor_from_selected_rows, im2sequence,
                        image_resize_short, inplace_abn, lod_append,
                        lod_reset, merge_selected_rows, prroi_pool,
                        psroi_pool, py_func, random_crop, roi_align,
                        roi_pool, scatter_nd, soft_relu, stanh,
                        autoincreased_step_counter, clip, clip_by_norm,
                        conv2d_transpose, conv3d, conv3d_transpose,
                        crop, elementwise_floordiv, elementwise_mod,
                        elementwise_pow, elu, expand, expand_as,
                        gather, gather_nd, gaussian_random,
                        gaussian_random_batch_size_like, group_norm,
                        hard_sigmoid, hard_swish, instance_norm,
                        l2_normalize, label_smooth, leaky_relu,
                        logical_xor, mul, pad, pad2d, pool3d, pow,
                        prelu, rank, reduce_all, reduce_any,
                        reduce_prod, relu6, scatter, shape,
                        shard_index, sign, size, slice, smooth_l1,
                        squeeze, stack, strided_slice, sum, swish,
                        unbind, uniform_random,
                        uniform_random_batch_size_like, unsqueeze,
                        unstack, where)
from .dynamic_rnn import DynamicRNN
from . import detection
from .sequence_lod import (dynamic_lstm, sequence_concat, sequence_conv,
                           sequence_enumerate, sequence_expand,
                           sequence_expand_as, sequence_first_step,
                           sequence_last_step, sequence_mask, sequence_pad,
                           sequence_pool, sequence_reverse, sequence_slice,
                           sequence_softmax, sequence_unpad)
