"""Op cases of the dense half of the op library and the control-flow
ops (``tests/test_torch_static.py``'s ``OP_CASES`` form: case id -> (op
type, inputs(rng), attrs, tolerance)), in a module of their own that
imports numpy only: ``test_torch_static.py`` holds each against the JAX
package's lowering on the CPU, and ``chip_smoke.py``'s phase 25 runs
each on the card against the port on the CPU.

A case id holds its op's name before any ":" (variants of one op). A
``:ties`` / ``:kink`` case puts inputs on an op's ties or kinks, where
JAX's gradient is the one to match.
"""

import numpy as np

#: products, normalizations and factorizations: their tolerance
_PROD = (1e-5, 1e-4)


def _f(rng, *shape, pos=False):
    a = rng.randn(*shape).astype(np.float32)
    return np.abs(a) + 0.5 if pos else a


def _ids(rng, hi, *shape):
    return rng.randint(0, hi, shape).astype(np.int64)


def _lens(*v):
    return np.array(v, np.int64)


def _probs(rng, *shape):
    return (1.0 / (1.0 + np.exp(-rng.randn(*shape)))).astype(np.float32)


def _tied(rng, *shape):
    """Floats on a coarse grid, so a row holds equal values."""
    return np.round(rng.randn(*shape) * 1.5).astype(np.float32)


def _u(rng, *shape):
    """Floats in (-0.9, 0.9): the domain of asin, acos, atanh."""
    return (rng.rand(*shape) * 1.8 - 0.9).astype(np.float32)


def _kinks(*v):
    """A [2, 4] float32 row pair holding ``v`` (the kinks of an op)."""
    a = np.array(list(v) * 8, np.float32)[:8]
    return a.reshape(2, 4)


def _bools(rng, *shape):
    return rng.rand(*shape) > 0.5


def _spd(rng, b, n):
    a = rng.randn(b, n, n)
    return (a @ a.transpose(0, 2, 1) + 3 * np.eye(n)).astype(np.float32)


def _x(fn):
    """A unary op's inputs: ``{"X": [fn(rng)]}``."""
    return lambda r: {"X": [fn(r)]}


_SPECIAL = np.array([[1.0, np.inf, -np.inf, np.nan], [0.0, -2.0, 3.0, 4.0]],
                    np.float32)

#: the dense half of the op library and the control-flow ops
DENSE_CASES = {
    **{op: (op, _x(lambda r: _f(r, 3, 4)), {}, None) for op in (
        "asinh", "atan", "cos", "cosh", "sin", "sinh", "erf", "softsign",
        "ceil")},
    **{op: (op, _x(lambda r: _u(r, 3, 4)), {}, None) for op in (
        "asin", "acos", "atanh", "tan")},
    **{op: (op, _x(lambda r: _f(r, 3, 4, pos=True)), {}, None) for op in (
        "log2", "log10", "log1p", "reciprocal")},
    "acosh": ("acosh", _x(lambda r: _f(r, 3, 4, pos=True) + 1.0), {}, None),
    "round": ("round", _x(lambda r: _f(r, 3, 4) * 3), {}, None),
    "softsign:kink": ("softsign", _x(lambda r: _kinks(0.0, -1.0, 2.0)), {},
                      None),
    "elu": ("elu", _x(lambda r: _f(r, 3, 4)), {"alpha": 0.5}, None),
    "elu:kink": ("elu", _x(lambda r: _kinks(0.0, -0.5, 0.5)),
                 {"alpha": 0.5}, None),
    "leaky_relu": ("leaky_relu", _x(lambda r: _f(r, 3, 4)), {"alpha": 0.1},
                   None),
    "leaky_relu:kink": ("leaky_relu", _x(lambda r: _kinks(0.0, -1.0, 1.0)),
                        {"alpha": 0.1}, None),
    "softplus": ("softplus", _x(lambda r: _f(r, 3, 4) * 3),
                 {"beta": 2.0, "threshold": 3.0}, None),
    "swish": ("swish", _x(lambda r: _f(r, 3, 4)), {"beta": 1.5}, None),
    "hard_sigmoid": ("hard_sigmoid", _x(lambda r: _f(r, 3, 4) * 3), {},
                     None),
    "hard_sigmoid:kink": ("hard_sigmoid", _x(lambda r: _kinks(-2.5, 2.5,
                                                              0.0)),
                          {"slope": 0.2, "offset": 0.5}, None),
    "hard_swish": ("hard_swish", _x(lambda r: _f(r, 3, 4) * 4), {}, None),
    "hard_swish:kink": ("hard_swish", _x(lambda r: _kinks(-3.0, 3.0, 0.0)),
                        {}, None),
    "hard_tanh": ("hard_tanh", _x(lambda r: _f(r, 3, 4) * 2), {}, None),
    "hard_tanh:kink": ("hard_tanh", _x(lambda r: _kinks(-1.0, 1.0, 0.5)),
                       {"t_min": -1.0, "t_max": 1.0}, None),
    "prelu": ("prelu", lambda r: {"X": [_f(r, 3, 4)],
                                  "Alpha": [np.array([0.25], np.float32)]},
              {"mode": "all"}, None),
    "prelu:channel_kink": ("prelu", lambda r: {
        "X": [np.concatenate([_f(r, 2, 3, 4), np.zeros((2, 3, 1),
                                                        np.float32)], -1)],
        "Alpha": [_f(r, 3)]}, {"mode": "channel"}, None),
    "pow": ("pow", _x(lambda r: _f(r, 3, 4, pos=True)), {"factor": 2.5},
            None),
    "pow:zero": ("pow", _x(lambda r: _kinks(0.0, 1.5, 2.0)),
                 {"factor": 2.0}, None),
    **{op: (op, lambda r: {"X": [_tied(r, 3, 4)], "Y": [_tied(r, 3, 4)]},
            {}, None) for op in ("equal", "not_equal", "less_than",
                                 "less_equal", "greater_than",
                                 "greater_equal")},
    **{op: (op, lambda r: {"X": [_bools(r, 3, 4)], "Y": [_bools(r, 3, 4)]},
            {}, None) for op in ("logical_and", "logical_or",
                                 "logical_xor")},
    "logical_not": ("logical_not", _x(lambda r: _bools(r, 3, 4)), {}, None),
    "elementwise_mod": ("elementwise_mod", lambda r: {
        "X": [_f(r, 3, 4, pos=True) * 4], "Y": [_f(r, 3, 4, pos=True)]},
        {}, None),
    "elementwise_mod:int": ("elementwise_mod", lambda r: {
        "X": [r.randint(-9, 9, (3, 4))], "Y": [r.randint(1, 4, (3, 4))]},
        {}, None),
    "elementwise_floordiv": ("elementwise_floordiv", lambda r: {
        "X": [r.randint(-9, 9, (3, 4))], "Y": [r.randint(1, 4, (4,))]},
        {}, None),
    "maximum": ("maximum", lambda r: {"X": [_f(r, 3, 4)],
                                      "Y": [_f(r, 3, 4)]}, {}, None),
    "maximum:ties": ("maximum", lambda r: {"X": [_tied(r, 3, 4)],
                                           "Y": [_tied(r, 3, 4)]}, {}, None),
    "minimum": ("minimum", lambda r: {"X": [_f(r, 3, 4)],
                                      "Y": [_f(r, 3, 4)]}, {}, None),
    "minimum:ties": ("minimum", lambda r: {"X": [_tied(r, 3, 4)],
                                           "Y": [_tied(r, 3, 4)]}, {}, None),
    "elementwise_max:ties": ("elementwise_max", lambda r: {
        "X": [_tied(r, 2, 3)], "Y": [_tied(r, 2, 3)]}, {}, None),
    "dot": ("dot", lambda r: {"X": [_f(r, 3, 4)], "Y": [_f(r, 3, 4)]}, {},
            None),
    "addmm": ("addmm", lambda r: {"Input": [_f(r, 3, 5)],
                                  "X": [_f(r, 3, 4)], "Y": [_f(r, 4, 5)]},
              {"Alpha": 2.0, "Beta": 0.5}, _PROD),
    "p_norm": ("p_norm", lambda r: {"X": [_f(r, 3, 4)]},
               {"porder": 3.0, "axis": 1, "keepdim": True}, None),
    "p_norm:zero": ("p_norm", lambda r: {"X": [_kinks(0.0, 1.0, -2.0)]},
                    {"porder": 1.0, "axis": -1}, None),
    **{op: (op, _x(lambda r: _SPECIAL), {}, None) for op in (
        "isfinite", "isfinite_v2", "isnan_v2", "isinf_v2")},
    # tensor_ops
    "shape": ("shape", lambda r: {"Input": [_f(r, 2, 3, 4)]}, {}, None),
    "size": ("size", lambda r: {"Input": [_f(r, 2, 3, 4)]}, {}, None),
    "fill_any_like": ("fill_any_like", lambda r: {"X": [_f(r, 2, 3)]},
                      {"value": 2.5}, None),
    "fill_any_like:dtype": ("fill_any_like", lambda r: {"X": [_f(r, 2, 3)]},
                            {"value": 3.0, "dtype": "int32"}, None),
    "eye": ("eye", lambda r: {}, {"num_rows": 3, "num_columns": 4,
                                  "dtype": "float32"}, None),
    "range": ("range", lambda r: {}, {"start": 1, "end": 10, "step": 2,
                                      "dtype": "int64"}, None),
    "range:float": ("range", lambda r: {}, {"start": 0.5, "end": 2.0,
                                            "step": 0.25,
                                            "dtype": "float32"}, None),
    "linspace": ("linspace", lambda r: {}, {"start": -1.0, "stop": 2.0,
                                            "num": 7, "dtype": "float32"},
                 None),
    "linspace:int": ("linspace", lambda r: {}, {"start": 0, "stop": 10,
                                                "num": 4, "dtype": "int64"},
                     None),
    "meshgrid": ("meshgrid", lambda r: {"X": [_f(r, 3), _f(r, 4)]}, {},
                 None),
    "flatten_contiguous_range": ("flatten_contiguous_range", lambda r: {
        "X": [_f(r, 2, 3, 4, 5)]}, {"start_axis": 1, "stop_axis": 2}, None),
    "squeeze2": ("squeeze2", lambda r: {"X": [_f(r, 2, 1, 3, 1)]},
                 {"axes": [1]}, None),
    "unsqueeze2": ("unsqueeze2", lambda r: {"X": [_f(r, 2, 3)]},
                   {"axes": [0, 2]}, None),
    "strided_slice": ("strided_slice", lambda r: {"X": [_f(r, 5, 6, 4)]},
                      {"axes": [0, 1], "starts": [0, 5], "ends": [5, 0],
                       "strides": [2, -2]}, None),
    "unstack": ("unstack", lambda r: {"X": [_f(r, 3, 2, 4)]}, {"axis": 1},
                None),
    "unbind": ("unbind", lambda r: {"X": [_f(r, 3, 2, 4)]}, {"axis": 0},
               None),
    "expand_v2": ("expand_v2", lambda r: {"X": [_f(r, 3, 1)]},
                  {"shape": [2, -1, 4]}, None),
    "expand_as_v2": ("expand_as_v2", lambda r: {"X": [_f(r, 1, 3)]},
                     {"target_shape": [4, 3]}, None),
    "tile": ("tile", lambda r: {"X": [_f(r, 2, 3)]},
             {"repeat_times": [2, 1, 2]}, None),
    "flip": ("flip", lambda r: {"X": [_f(r, 2, 3, 4)]}, {"axis": [0, 2]},
             None),
    "roll": ("roll", lambda r: {"X": [_f(r, 3, 4)]},
             {"shifts": [1, -2], "axis": [0, 1]}, None),
    "gather": ("gather", lambda r: {"X": [_f(r, 5, 3)],
                                    "Index": [_ids(r, 5, 4)]}, {}, None),
    "gather:axis1": ("gather", lambda r: {"X": [_f(r, 2, 5, 3)],
                                          "Index": [_ids(r, 5, 2, 2)]},
                     {"axis": 1}, None),
    "gather_nd": ("gather_nd", lambda r: {"X": [_f(r, 4, 5, 3)],
                                          "Index": [_ids(r, 4, 2, 2)]},
                  {}, None),
    "scatter": ("scatter", lambda r: {"X": [_f(r, 5, 3)],
                                      "Ids": [_lens(4, 0, 2)],
                                      "Updates": [_f(r, 3, 3)]},
                {"overwrite": True}, None),
    "scatter:add": ("scatter", lambda r: {"X": [_f(r, 5, 3)],
                                          "Ids": [_lens(1, 1, 3)],
                                          "Updates": [_f(r, 3, 3)]},
                    {"overwrite": False}, None),
    "index_select": ("index_select", lambda r: {"X": [_f(r, 4, 5)],
                                                "Index": [_ids(r, 5, 3)]},
                     {"dim": 1}, None),
    "where": ("where", lambda r: {"Condition": [_bools(r, 3, 4)],
                                  "X": [_f(r, 3, 4)], "Y": [_f(r, 3, 4)]},
              {}, None),
    "where_index": ("where_index", lambda r: {"Condition": [_bools(r, 3)]},
                    {}, None),
    "cumsum": ("cumsum", lambda r: {"X": [_f(r, 3, 5)]}, {"axis": 1},
               None),
    "cumsum:reverse_exclusive": ("cumsum", lambda r: {"X": [_f(r, 3, 5)]},
                                 {"axis": 0, "reverse": True,
                                  "exclusive": True}, None),
    "cumsum:flatten": ("cumsum", lambda r: {"X": [_f(r, 3, 5)]},
                       {"flatten": True}, None),
    "pad": ("pad", lambda r: {"X": [_f(r, 2, 3)]},
            {"paddings": [1, 0, 2, 1], "pad_value": 0.5}, None),
    "pad2d": ("pad2d", lambda r: {"X": [_f(r, 1, 2, 3, 4)]},
              {"paddings": [1, 0, 2, 1], "mode": "reflect"}, None),
    "pad2d:constant": ("pad2d", lambda r: {"X": [_f(r, 1, 2, 3, 4)]},
                       {"paddings": [0, 2, 1, 1], "pad_value": -1.0}, None),
    "pad3d": ("pad3d", lambda r: {"X": [_f(r, 1, 1, 2, 3, 4)]},
              {"paddings": [1, 1, 0, 1, 1, 0], "mode": "replicate"}, None),
    "pad3d:circular": ("pad3d", lambda r: {"X": [_f(r, 1, 1, 2, 3, 4)]},
                       {"paddings": [1, 2, 1, 0, 0, 1], "mode": "circular"},
                       None),
    "tril_triu": ("tril_triu", lambda r: {"X": [_f(r, 2, 4, 5)]},
                  {"diagonal": 1, "lower": False}, None),
    "tril_triu:lower": ("tril_triu", lambda r: {"X": [_f(r, 4, 5)]},
                        {"diagonal": -1}, None),
    "argsort": ("argsort", lambda r: {"X": [_tied(r, 3, 5)]},
                {"axis": -1, "descending": True}, None),
    "argsort:ascending": ("argsort", lambda r: {"X": [_tied(r, 4, 3)]},
                          {"axis": 0}, None),
    "top_k": ("top_k", lambda r: {"X": [_tied(r, 3, 6)]}, {"k": 3}, None),
    # reduce_ops
    "logsumexp": ("logsumexp", lambda r: {"X": [_f(r, 3, 4, 2)]},
                  {"axis": [1], "keepdim": True}, None),
    "logsumexp:neg_inf": ("logsumexp", lambda r: {"X": [np.array(
        [[-np.inf] * 4, [-np.inf, 1.0, 2.0, -np.inf], [0.5, 1.5, -1.0, 2.0]],
        np.float32)]}, {"axis": -1}, None),
    "reduce_all": ("reduce_all", lambda r: {"X": [_bools(r, 3, 4)]},
                   {"dim": [1], "keep_dim": True}, None),
    "reduce_any": ("reduce_any", lambda r: {"X": [_bools(r, 3, 4) &
                                                  _bools(r, 3, 4)]},
                   {"reduce_all": True}, None),
    # random_ops (the reference's streams, 64-bit types off)
    "randint": ("randint", lambda r: {}, {"shape": [3, 4], "low": -5,
                                          "high": 7}, None),
    "randperm": ("randperm", lambda r: {}, {"n": 10}, None),
    "bernoulli": ("bernoulli", lambda r: {"X": [_probs(r, 4, 5)]}, {},
                  None),
    "multinomial": ("multinomial", lambda r: {"X": [_probs(r, 3, 5)]},
                    {"num_samples": 4}, None),
    # linalg_ops
    "bmm": ("bmm", lambda r: {"X": [_f(r, 2, 3, 4)], "Y": [_f(r, 2, 4, 5)]},
            {}, _PROD),
    "cholesky": ("cholesky", lambda r: {"X": [_spd(r, 2, 3)]}, {}, _PROD),
    "cholesky:upper": ("cholesky", lambda r: {"X": [_spd(r, 1, 4)]},
                       {"upper": True}, _PROD),
    "cholesky:not_pd": ("cholesky", lambda r: {"X": [np.array(
        [[[1.0, 2.0], [2.0, 1.0]], [[2.0, 0.5], [0.5, 1.0]]], np.float32)]},
        {}, _PROD),
    "inverse": ("inverse", lambda r: {"Input": [_spd(r, 2, 3)]}, {}, _PROD),
    "kron": ("kron", lambda r: {"X": [_f(r, 2, 3)], "Y": [_f(r, 3, 2)]}, {},
             None),
    "cross": ("cross", lambda r: {"X": [_f(r, 4, 3)], "Y": [_f(r, 4, 3)]},
              {"dim": 1}, None),
    "cross:default_dim": ("cross", lambda r: {"X": [_f(r, 3, 4)],
                                              "Y": [_f(r, 3, 4)]}, {}, None),
    "trace": ("trace", lambda r: {"Input": [_f(r, 3, 4, 5)]},
              {"offset": 1, "dim1": 1, "dim2": 2}, None),
    # fused_ops
    "fused_elemwise_activation": ("fused_elemwise_activation", lambda r: {
        "X": [_f(r, 3, 4)], "Y": [_f(r, 4)]},
        {"functor_list": ["elementwise_add", "relu"],
         "save_intermediate_out": True}, None),
    "fused_elemwise_activation:gelu": ("fused_elemwise_activation",
                                       lambda r: {"X": [_f(r, 3, 4)],
                                                  "Y": [_f(r, 3, 4)]},
                                       {"functor_list": ["elementwise_mul",
                                                         "gelu"],
                                        "act_attrs": {"approximate": True}},
                                       None),
    "fused_scale_bias_relu": ("fused_scale_bias_relu", lambda r: {
        "X": [_f(r, 2, 3, 4, 4)], "Scale": [_f(r, 3)], "Bias": [_f(r, 3)]},
        {}, None),
    # index_ops
    "masked_select": ("masked_select", lambda r: {
        "X": [_f(r, 3, 4)], "Mask": [_bools(r, 3, 4)]}, {}, None),
    "masked_select:executor": ("masked_select", lambda r: {
        "X": [_f(r, 3, 4)], "Mask": [_bools(r, 3, 4)]}, {}, None),
    "index_sample": ("index_sample", lambda r: {"X": [_f(r, 3, 5)],
                                                "Index": [_ids(r, 5, 3, 2)]},
                     {}, None),
    "multiplex": ("multiplex", lambda r: {
        "X": [_f(r, 4, 3), _f(r, 4, 3), _f(r, 4, 3)],
        "Ids": [r.randint(0, 3, (4, 1)).astype(np.int32)]}, {}, None),
    "reverse": ("reverse", lambda r: {"X": [_f(r, 2, 3, 4)]},
                {"axis": [0, 2]}, None),
    "scatter_nd_add": ("scatter_nd_add", lambda r: {
        "X": [_f(r, 4, 5)], "Index": [_ids(r, 4, 3, 1)],
        "Updates": [_f(r, 3, 5)]}, {}, None),
    "scatter_nd_add:k2": ("scatter_nd_add", lambda r: {
        "X": [_f(r, 4, 5)], "Index": [np.stack([_ids(r, 4, 3),
                                                _ids(r, 5, 3)], -1)],
        "Updates": [_f(r, 3)]}, {}, None),
    "gather_tree": ("gather_tree", lambda r: {"Ids": [_ids(r, 9, 4, 2, 3)],
                                              "Parents": [_ids(r, 3, 4, 2,
                                                               3)]},
                    {}, None),
    "selu": ("selu", _x(lambda r: _f(r, 3, 4)), {}, None),
    "mish": ("mish", _x(lambda r: _f(r, 3, 4) * 2), {"threshold": 1.0},
             None),
    "conv_shift": ("conv_shift", lambda r: {"X": [_f(r, 2, 5)],
                                            "Y": [_f(r, 2, 3)]}, {}, None),
    "partial_concat": ("partial_concat", lambda r: {
        "X": [_f(r, 3, 6), _f(r, 3, 6)]},
        {"start_index": 1, "length": 3}, None),
    "partial_sum": ("partial_sum", lambda r: {"X": [_f(r, 3, 6),
                                                    _f(r, 3, 6)]},
                    {"start_index": -4, "length": 2}, None),
    "shuffle_batch": ("shuffle_batch", lambda r: {"X": [_f(r, 6, 3)]}, {},
                      None),
    "expand": ("expand", lambda r: {"X": [_f(r, 2, 3)]},
               {"expand_times": [2, 1]}, None),
    "expand_as": ("expand_as", lambda r: {"X": [_f(r, 2, 3)],
                                          "target_tensor": [_f(r, 4, 6)]},
                  {}, None),
    "flatten": ("flatten", lambda r: {"X": [_f(r, 2, 3, 4)]}, {"axis": 2},
                None),
    "unsqueeze": ("unsqueeze", lambda r: {"X": [_f(r, 3, 4)]},
                  {"axes": [0, -1]}, None),
    # nn_ops
    "squared_l2_distance": ("squared_l2_distance", lambda r: {
        "X": [_f(r, 4, 3)], "Y": [_f(r, 4, 3)]}, {}, None),
    "smooth_l1_loss": ("smooth_l1_loss", lambda r: {
        "X": [_f(r, 4, 3)], "Y": [_f(r, 4, 3)]}, {"sigma": 2.0}, None),
    "mse_loss": ("mse_loss", lambda r: {"Input": [_f(r, 4, 3)],
                                        "Label": [_f(r, 4, 3)]}, {}, None),
    "kldiv_loss": ("kldiv_loss", lambda r: {
        "X": [_f(r, 3, 4)],
        "Target": [_probs(r, 3, 4) * (r.rand(3, 4) > 0.3)]},
        {"reduction": "batchmean"}, None),
    "kldiv_loss:none": ("kldiv_loss", lambda r: {
        "X": [_f(r, 3, 4)], "Target": [_probs(r, 3, 4)]},
        {"reduction": "none"}, None),
    "label_smooth": ("label_smooth", lambda r: {"X": [_probs(r, 3, 5)]},
                     {"epsilon": 0.1}, None),
    "label_smooth:prior": ("label_smooth", lambda r: {
        "X": [_probs(r, 3, 5)], "PriorDist": [_probs(r, 1, 5)]},
        {"epsilon": 0.2}, None),
    "group_norm": ("group_norm", lambda r: {
        "X": [_f(r, 2, 4, 3, 3)], "Scale": [_f(r, 4)], "Bias": [_f(r, 4)]},
        {"groups": 2, "epsilon": 1e-5}, _PROD),
    "instance_norm": ("instance_norm", lambda r: {
        "X": [_f(r, 2, 3, 4, 4)], "Scale": [_f(r, 3)], "Bias": [_f(r, 3)]},
        {"epsilon": 1e-5}, _PROD),
    "norm": ("norm", lambda r: {"X": [_f(r, 3, 4)]}, {"axis": 1}, _PROD),
    "embedding_bag": ("embedding_bag", lambda r: {
        "W": [_f(r, 10, 4)], "Ids": [_ids(r, 10, 3, 4)]}, {}, None),
    "embedding_bag:mean": ("embedding_bag", lambda r: {
        "W": [_f(r, 10, 4)], "Ids": [_ids(r, 10, 3, 4)]}, {"mode": "mean"},
        None),
    "auc": ("auc", lambda r: {
        "Predict": [np.concatenate([1 - _probs(r, 8, 1), _probs(r, 8, 1)],
                                   1)],
        "Label": [_ids(r, 2, 8, 1)], "StatPos": [_ids(r, 3, 11)],
        "StatNeg": [_ids(r, 3, 11)]}, {"num_thresholds": 10}, None),
    # misc_ops
    "uniform_random_batch_size_like": (
        "uniform_random_batch_size_like", lambda r: {"Input": [_f(r, 4, 3)]},
        {"shape": [-1, 5], "min": -0.3, "max": 0.7}, (0, 0)),
    "gaussian_random_batch_size_like": (
        "gaussian_random_batch_size_like",
        lambda r: {"Input": [_f(r, 3, 2)]},
        {"shape": [2, -1], "input_dim_idx": 0, "output_dim_idx": 1,
         "mean": 0.5, "std": 2.0}, (1e-5, 1e-5)),
    "shard_index": ("shard_index", lambda r: {"X": [_ids(r, 20, 6, 1)]},
                    {"index_num": 20, "nshards": 3, "shard_id": 1}, None),
    # control_flow_ops: run only through the executor (their programs are
    # in test_torch_control_flow.py); as standalone ops both raise
    **{op: (op, lambda r: {"Cond": [np.array([True])],
                           "Index": [np.array([0], np.int32)],
                           "Condition": [np.array([True])],
                           "X": [_f(r, 2)]}, {}, None)
       for op in ("while", "cond", "switch_case")},
}

#: case id -> the exception both packages raise (no standalone run)
_RAISES = {"where_index": NotImplementedError,
           "masked_select:executor": NotImplementedError,
           "while": RuntimeError, "cond": RuntimeError,
           "switch_case": RuntimeError}
#: cases run as eager (dygraph) calls
_EAGER = {"masked_select"}
#: cases whose reference has no gradient (masked_select's output shape
#: depends on the values, which jax.vjp cannot trace)
_NO_GRAD = {"masked_select"}

#: cases whose JAX side runs with 64-bit types off: the random streams
DENSE_X32 = {"randint", "randperm", "bernoulli", "multinomial",
             "shuffle_batch", "uniform_random_batch_size_like",
             "gaussian_random_batch_size_like"}
