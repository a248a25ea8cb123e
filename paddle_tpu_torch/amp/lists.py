"""AMP op lists: which ops run in low precision — a copy of
``paddle_tpu/amp/lists.py``, keyed by the JAX package's op types so that
the port casts exactly where the reference does. The low-precision type
is bfloat16: products go to the tensor cores in bf16, numerically
sensitive reductions and normalizations stay in float32."""

# Ops that benefit from bf16 (matrix-unit bound) — the white list.
WHITE_LIST = {
    "conv2d", "depthwise_conv2d", "conv3d", "conv2d_transpose",
    "matmul", "matmul_v2", "mul", "fused_attention_qkv",
}

# Numerically dangerous in low precision — forced float32.
BLACK_LIST = {
    "exp", "square", "log", "mean", "sum", "cos_sim",
    "softmax", "log_softmax", "softmax_with_cross_entropy",
    "sigmoid_cross_entropy_with_logits", "cross_entropy",
    "layer_norm", "batch_norm", "group_norm", "instance_norm",
    "reduce_sum", "reduce_mean", "reduce_prod",
    "squared_l2_norm", "p_norm", "norm", "logsumexp",
}

# Everything else runs in whatever dtype its inputs already have (O1), or
# in the low-precision type (O2).


class AutoMixedPrecisionLists:
    """The white and black lists one AMP rewrite applies
    (``paddle_tpu/amp/lists.py:28``): the defaults above, a custom white
    op leaving the black list and a custom black op the white list."""

    def __init__(self, custom_white_list=None, custom_black_list=None):
        self.white_list = set(WHITE_LIST)
        self.black_list = set(BLACK_LIST)
        if custom_white_list:
            self.white_list |= set(custom_white_list)
            self.black_list -= set(custom_white_list)
        if custom_black_list:
            self.black_list |= set(custom_black_list)
            self.white_list -= set(custom_black_list)
