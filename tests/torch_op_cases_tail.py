"""Op cases of the image, detection and quantization half of the op
library (``torch_op_cases.py``'s form: case id -> (op type, inputs(rng),
attrs, tolerance)), in a module of their own that imports numpy only:
``test_torch_ops_tail.py`` holds each against the JAX package's lowering
on the CPU, and ``chip_smoke.py``'s phase 26 runs each on the card
against the port on the CPU.

A case id holds its op's name before any ":" (variants of one op).
``:up`` / ``:down`` cases resize both ways (a downsampling linear or
cubic resize widens its filter, as ``jax.image.resize`` antialiases);
``multiclass_nms:kth_tie`` puts equal scores at a class's k-th place,
which the pre-NMS truncation admits together; ``deformable_conv`` takes
offsets off the pixel grid, some taps outside the image;
``subgraph_delegate`` runs a delegated cluster by the inline engine.
"""

import json

import numpy as np

#: products, normalizations and contractions: their tolerance
_PROD = (1e-5, 1e-4)


def _f(rng, *shape, pos=False):
    a = rng.randn(*shape).astype(np.float32)
    return np.abs(a) + 0.5 if pos else a


def _ids(rng, hi, *shape):
    return rng.randint(0, hi, shape).astype(np.int64)


def _boxes(rng, n, scale=1.0, lead=()):
    """``lead + (n, 4)`` float32 boxes (x1, y1, x2, y2) with x1 < x2,
    y1 < y2, inside [0, scale]."""
    xy = rng.rand(*lead, n, 2) * 0.6
    wh = rng.rand(*lead, n, 2) * 0.35 + 0.05
    return (np.concatenate([xy, xy + wh], -1) * scale).astype(np.float32)


def _img(rng, n, c, h, w):
    return rng.randn(n, c, h, w).astype(np.float32)


def _unpool_ins(r):
    """X [1, 2, 2, 2] and the flat argmax of each 2 x 2 window of a
    4 x 4 plane."""
    a, b = r.randint(0, 2, (1, 2, 2, 2)), r.randint(0, 2, (1, 2, 2, 2))
    i = np.arange(2)[:, None]
    j = np.arange(2)[None, :]
    idx = ((2 * i + a) * 4 + (2 * j + b)).astype(np.int32)
    return {"X": [_f(r, 1, 2, 2, 2)], "Indices": [idx]}


def _interp_cases():
    cases = {}
    for op, nd in (("linear_interp", 1), ("linear_interp_v2", 1),
                   ("trilinear_interp", 3), ("trilinear_interp_v2", 3),
                   ("bicubic_interp", 2), ("nearest_interp", 2),
                   ("nearest_interp_v2", 2), ("bilinear_interp", 2),
                   ("bilinear_interp_v2", 2), ("bicubic_interp_v2", 2)):
        keys = ["out_d", "out_h", "out_w"][-nd:]
        src = (4, 5, 6)[-nd:]
        for tag, dst in (("up", (7, 9, 11)[-nd:]), ("down", (2, 3, 3)[-nd:])):
            cases[f"{op}:{tag}"] = (
                op, lambda r, s=src: {"X": [_f(r, 2, 3, *s)]},
                dict(zip(keys, dst)), _PROD)
        cases[f"{op}:scale"] = (
            op, lambda r, s=src: {"X": [_f(r, 1, 2, *s)]},
            {"scale": 1.5}, _PROD)
    return cases


def _nms_ins(r, n=2, c=3, m=12, tie=False):
    boxes = _boxes(r, m, 10.0, (n,))
    scores = r.rand(n, c, m).astype(np.float32)
    if tie:
        # the 4th..7th best of every class share one score: a k of 5
        # admits all four at the k-th place
        for i in range(n):
            for k in range(c):
                order = np.argsort(-scores[i, k])
                scores[i, k, order[3:7]] = scores[i, k, order[3]]
    return {"BBoxes": [boxes], "Scores": [scores]}


def _yolo_gt(r, n, b):
    box = np.concatenate([r.rand(n, b, 2) * 0.8 + 0.1,
                          r.rand(n, b, 2) * 0.5 + 0.05], -1)
    box[:, -1] = 0.0                      # an empty slot
    return box.astype(np.float32)


_YOLO_ANCHORS = [10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119]


def _anchors(h, w, sizes, stride=16.0):
    out = np.zeros((h, w, len(sizes), 4), np.float32)
    for y in range(h):
        for x in range(w):
            cx, cy = x * stride + stride / 2, y * stride + stride / 2
            for k, s in enumerate(sizes):
                out[y, x, k] = [cx - s / 2, cy - s / 2, cx + s / 2,
                                cy + s / 2]
    return out


def _proposal_ins(r):
    h = w = 4
    a = 2
    return {"Scores": [r.randn(1, a, h, w).astype(np.float32)],
            "BboxDeltas": [(r.randn(1, 4 * a, h, w) * 0.2)
                           .astype(np.float32)],
            "ImInfo": [np.array([[64, 64, 1]], np.float32)],
            "Anchors": [_anchors(h, w, (24.0, 40.0))],
            "Variances": [np.ones((h, w, a, 4), np.float32)]}


def _rpn_ins(r):
    anchors = _anchors(4, 4, (24.0,)).reshape(-1, 4)
    gt = np.zeros((1, 2, 4), np.float32)
    gt[0, 0] = anchors[5] + [1, 1, 1, 1]
    gt[0, 1] = anchors[10] + [-2, 0, 3, 1]
    return {"Anchor": [anchors], "GtBoxes": [gt],
            "GtNum": [np.array([2], np.int32)],
            "ImInfo": [np.array([[64, 64, 1]], np.float32)]}


def _labels_ins(r):
    rois = np.zeros((1, 10, 4), np.float32)
    rois[0, :8] = _boxes(r, 8, 60.0)
    gt = _boxes(r, 2, 60.0)[None]
    rois[0, 0] = gt[0, 0] + 0.5
    return {"RpnRois": [rois], "RpnRoisNum": [np.array([8], np.int32)],
            "GtClasses": [np.array([[1, 2]], np.int32)], "GtBoxes": [gt],
            "GtNum": [np.array([2], np.int32)],
            "ImInfo": [np.array([[64, 64, 1]], np.float32)]}


def _ma_ins(r, **extra):
    ins = {"X": [_f(r, 3, 4)], "InScale": [np.array([0.8], np.float32)],
           "InState": [np.array([1.0], np.float32)],
           "InAccum": [np.array([0.8], np.float32)]}
    ins.update(extra)
    return ins


_QAT = {"bit_length": 8}

#: the image, detection and quantization half of the op library
TAIL_CASES = {
    **_interp_cases(),
    # image_ops
    "affine_grid": ("affine_grid", lambda r: {"Theta": [_f(r, 2, 2, 3)]},
                    {"output_shape": [2, 3, 4, 5]}, None),
    "affine_grid:corners": ("affine_grid",
                            lambda r: {"Theta": [_f(r, 1, 2, 3)]},
                            {"output_shape": [1, 1, 3, 3],
                             "align_corners": False}, None),
    **{f"grid_sampler:{mode}_{pad}_{int(al)}": (
        "grid_sampler", lambda r: {
            "X": [_img(r, 2, 3, 5, 6)],
            "Grid": [(r.rand(2, 4, 3, 2) * 2.4 - 1.2).astype(np.float32)]},
        {"mode": mode, "padding_mode": pad, "align_corners": al}, None)
       for mode in ("bilinear", "nearest")
       for pad in ("zeros", "border", "reflection")
       for al in (True, False)},
    "affine_channel": ("affine_channel", lambda r: {
        "X": [_img(r, 2, 3, 4, 4)], "Scale": [_f(r, 3)],
        "Bias": [_f(r, 3)]}, {}, None),
    "affine_channel:nhwc": ("affine_channel", lambda r: {
        "X": [_img(r, 2, 4, 4, 3)], "Scale": [_f(r, 3)],
        "Bias": [_f(r, 3)]}, {"data_layout": "NHWC"}, None),
    "pixel_shuffle": ("pixel_shuffle", lambda r: {"X": [_img(r, 2, 8, 3, 3)]},
                      {"upscale_factor": 2}, None),
    "pixel_shuffle:nhwc": ("pixel_shuffle",
                           lambda r: {"X": [_img(r, 1, 3, 3, 8)]},
                           {"upscale_factor": 2, "data_format": "NHWC"},
                           None),
    "space_to_depth": ("space_to_depth", lambda r: {"X": [_img(r, 2, 3, 4, 6)]},
                       {"blocksize": 2}, None),
    "shuffle_channel": ("shuffle_channel",
                        lambda r: {"X": [_img(r, 2, 6, 3, 3)]},
                        {"group": 3}, None),
    "temporal_shift": ("temporal_shift", lambda r: {"X": [_img(r, 6, 8, 2, 2)]},
                       {"seg_num": 3, "shift_ratio": 0.25}, None),
    "lrn": ("lrn", lambda r: {"X": [_img(r, 2, 7, 3, 3)]},
            {"n": 5, "k": 2.0, "alpha": 1e-2, "beta": 0.75}, None),
    "crop": ("crop", lambda r: {"X": [_img(r, 2, 3, 5, 6)]},
             {"shape": [2, 2, 3, -1], "offsets": [0, 1, 1, 2]}, None),
    "crop:like": ("crop", lambda r: {"X": [_f(r, 5, 6)], "Y": [_f(r, 3, 4)]},
                  {"offsets": [1, 2]}, None),
    "crop_tensor": ("crop_tensor", lambda r: {"X": [_f(r, 4, 5, 6)]},
                    {"shape": [2, 3, 4], "offsets": [1, 1, 2]}, None),
    "pad_constant_like": ("pad_constant_like", lambda r: {
        "X": [_f(r, 3, 5)], "Y": [_f(r, 2, 3)]}, {"pad_value": 1.5}, None),
    "unfold": ("unfold", lambda r: {"X": [_img(r, 2, 2, 5, 6)]},
               {"kernel_sizes": [2, 3], "strides": [1, 2],
                "paddings": [1, 1], "dilations": [1, 1]}, None),
    "unfold:dilated": ("unfold", lambda r: {"X": [_img(r, 1, 2, 6, 6)]},
                       {"kernel_sizes": [2, 2], "dilations": [2, 2]}, None),
    "max_pool2d_with_index": ("max_pool2d_with_index",
                              lambda r: {"X": [_img(r, 2, 2, 5, 5)]},
                              {"ksize": [2, 2], "strides": [2, 2],
                               "paddings": [1, 1]}, None),
    "max_pool2d_with_index:adaptive": (
        "max_pool2d_with_index", lambda r: {"X": [_img(r, 1, 2, 4, 6)]},
        {"ksize": [2, 3], "adaptive": True}, None),
    "max_pool3d_with_index": ("max_pool3d_with_index",
                              lambda r: {"X": [_f(r, 1, 2, 4, 4, 5)]},
                              {"ksize": [2, 2, 2], "strides": [2, 2, 2],
                               "paddings": [0, 1, 1]}, None),
    "unpool": ("unpool", _unpool_ins, {"ksize": [2, 2], "strides": [2, 2]},
               None),
    # nn_ops
    "depthwise_conv2d": ("depthwise_conv2d", lambda r: {
        "Input": [_img(r, 2, 3, 6, 6)], "Filter": [_f(r, 3, 1, 3, 3)]},
        {"groups": 3, "paddings": [1, 1], "strides": [2, 2]}, _PROD),
    "depthwise_conv2d:same": ("depthwise_conv2d", lambda r: {
        "Input": [_img(r, 1, 2, 5, 5)], "Filter": [_f(r, 2, 1, 3, 3)]},
        {"groups": 2, "paddings": "SAME", "strides": [2, 2]}, _PROD),
    "conv2d_transpose": ("conv2d_transpose", lambda r: {
        "Input": [_img(r, 2, 3, 4, 5)], "Filter": [_f(r, 3, 2, 3, 3)]},
        {"strides": [2, 2], "paddings": [1, 1]}, _PROD),
    "conv2d_transpose:asym": ("conv2d_transpose", lambda r: {
        "Input": [_img(r, 1, 2, 3, 3)], "Filter": [_f(r, 2, 4, 2, 3)]},
        {"strides": [1, 2], "paddings": [0, 1, 1, 0],
         "dilations": [2, 1]}, _PROD),
    "conv2d_transpose:same": ("conv2d_transpose", lambda r: {
        "Input": [_img(r, 1, 2, 3, 4)], "Filter": [_f(r, 2, 3, 3, 2)]},
        {"strides": [2, 3], "paddings": "SAME"}, _PROD),
    "conv2d_transpose:valid": ("conv2d_transpose", lambda r: {
        "Input": [_img(r, 1, 2, 3, 3)], "Filter": [_f(r, 2, 2, 2, 3)]},
        {"strides": [1, 2], "paddings": "VALID", "dilations": [2, 1]}, _PROD),
    "conv3d:same": ("conv3d", lambda r: {"Input": [_f(r, 1, 2, 4, 5, 5)],
                                         "Filter": [_f(r, 2, 2, 2, 3, 3)]},
                    {"paddings": "SAME", "strides": [2, 2, 1]}, _PROD),
    "conv3d": ("conv3d", lambda r: {"Input": [_f(r, 1, 2, 4, 5, 5)],
                                    "Filter": [_f(r, 3, 2, 2, 3, 3)]},
               {"paddings": [1, 1, 1], "strides": [1, 2, 1]}, _PROD),
    # structured_ops
    "conv3d_transpose": ("conv3d_transpose", lambda r: {
        "Input": [_f(r, 1, 2, 3, 3, 3)], "Filter": [_f(r, 2, 3, 2, 2, 2)]},
        {"strides": [2, 1, 2], "paddings": [0, 1, 0]}, _PROD),
    "depthwise_conv2d_transpose": ("depthwise_conv2d_transpose", lambda r: {
        "Input": [_img(r, 2, 3, 4, 4)], "Filter": [_f(r, 3, 1, 3, 3)]},
        {"strides": [2, 2], "paddings": [1, 1]}, _PROD),
    "deformable_conv": ("deformable_conv", lambda r: {
        "Input": [_img(r, 2, 3, 5, 5)],
        "Offset": [(r.randn(2, 18, 5, 5) * 1.3).astype(np.float32)],
        "Mask": [r.rand(2, 9, 5, 5).astype(np.float32)],
        "Filter": [_f(r, 4, 3, 3, 3)]}, {"paddings": [1, 1]}, _PROD),
    "deformable_conv_v1": ("deformable_conv_v1", lambda r: {
        "Input": [_img(r, 1, 2, 6, 6)],
        "Offset": [(r.randn(1, 8, 3, 3) * 0.9).astype(np.float32)],
        "Filter": [_f(r, 3, 2, 2, 2)]},
        {"strides": [2, 2], "dilations": [2, 2], "paddings": [1, 1]},
        _PROD),
    "fsp": ("fsp", lambda r: {"X": [_img(r, 2, 3, 4, 4)],
                              "Y": [_img(r, 2, 5, 4, 4)]}, {}, _PROD),
    # index_ops
    "im2sequence": ("im2sequence", lambda r: {"X": [_img(r, 2, 2, 5, 5)]},
                    {"kernels": [2, 3], "strides": [1, 2],
                     "paddings": [1, 0, 1, 0]}, None),
    # misc_ops
    "allclose": ("allclose", lambda r: {
        "Input": [np.array([1.0, np.nan, 2.0], np.float32)],
        "Other": [np.array([1.0 + 1e-7, np.nan, 2.0], np.float32)]},
        {"equal_nan": True}, None),
    "allclose:far": ("allclose", lambda r: {"Input": [_f(r, 3)],
                                            "Other": [_f(r, 3)]}, {}, None),
    "diag": ("diag", lambda r: {"Diagonal": [_f(r, 4)]}, {}, None),
    "diag_v2": ("diag_v2", lambda r: {"X": [_f(r, 3)]},
                {"offset": 1, "padding_value": 2.0}, None),
    "diag_v2:matrix": ("diag_v2", lambda r: {"X": [_f(r, 4, 5)]},
                       {"offset": -1}, None),
    "diag_embed": ("diag_embed", lambda r: {"Input": [_f(r, 2, 3)]},
                   {"offset": 1}, None),
    "diag_embed:dims": ("diag_embed", lambda r: {"Input": [_f(r, 2, 3)]},
                        {"offset": -1, "dim1": 0, "dim2": 2}, None),
    "histogram": ("histogram", lambda r: {"X": [_f(r, 40)]},
                  {"bins": 6, "min": -1.0, "max": 1.5}, None),
    "histogram:auto": ("histogram", lambda r: {"X": [_f(r, 5, 8)]},
                       {"bins": 5}, None),
    "is_empty": ("is_empty", lambda r: {"X": [_f(r, 2, 3)]}, {}, None),
    "maxout": ("maxout", lambda r: {"X": [_img(r, 2, 6, 3, 3)]},
               {"groups": 3}, None),
    "mean_iou": ("mean_iou", lambda r: {
        "Predictions": [_ids(r, 4, 20).astype(np.int32)],
        "Labels": [_ids(r, 4, 20).astype(np.int32)]},
        {"num_classes": 4}, None),
    "pool3d": ("pool3d", lambda r: {"X": [_f(r, 1, 2, 4, 4, 5)]},
               {"ksize": [2, 2, 2], "strides": [2, 2, 2],
                "paddings": [0, 1, 1]}, None),
    "pool3d:avg": ("pool3d", lambda r: {"X": [_f(r, 1, 2, 4, 4, 5)]},
                   {"pooling_type": "avg", "ksize": [2, 3, 2],
                    "strides": [1, 2, 2], "paddings": [1, 1, 0]}, None),
    "pool3d:avg_inclusive": ("pool3d", lambda r: {"X": [_f(r, 1, 1, 3, 4, 4)]},
                             {"pooling_type": "avg", "ksize": [2, 2, 2],
                              "paddings": [1, 0, 1], "exclusive": False},
                             None),
    "modified_huber_loss": ("modified_huber_loss", lambda r: {
        "X": [_f(r, 6, 1) * 2], "Y": [_ids(r, 2, 6, 1).astype(np.float32)]},
        {}, None),
    "add_position_encoding": ("add_position_encoding",
                              lambda r: {"X": [_f(r, 2, 5, 6)]},
                              {"alpha": 0.5, "beta": 2.0}, None),
    "bilinear_tensor_product": ("bilinear_tensor_product", lambda r: {
        "X": [_f(r, 3, 4)], "Y": [_f(r, 3, 5)], "Weight": [_f(r, 2, 4, 5)],
        "Bias": [_f(r, 1, 2)]}, {}, _PROD),
    "fill": ("fill", lambda r: {}, {"shape": [2, 3], "dtype": "float32",
                                   "value": [0.5, 1, 2, -3, 4, 5.5]}, None),
    "fill_zeros_like2": ("fill_zeros_like2", lambda r: {"X": [_f(r, 2, 3)]},
                         {}, None),
    "sampling_id": ("sampling_id", lambda r: {
        "X": [np.full((6, 5), 0.2, np.float32)]}, {}, None),
    "seed": ("seed", lambda r: {}, {"seed": 123}, None),
    "sequence_reshape": ("sequence_reshape", lambda r: {"X": [_f(r, 2, 4, 6)]},
                         {"new_dim": 8}, None),
    "sequence_scatter": ("sequence_scatter", lambda r: {
        "X": [_f(r, 3, 6)], "Ids": [_ids(r, 6, 3, 4)],
        "Updates": [_f(r, 3, 4)]}, {}, None),
    "spectral_norm": ("spectral_norm", lambda r: {
        "Weight": [_f(r, 4, 3, 2)], "U": [_f(r, 4)], "V": [_f(r, 6)]},
        {"dim": 0, "power_iters": 3}, _PROD),
    "spectral_norm:dim1": ("spectral_norm", lambda r: {
        "Weight": [_f(r, 3, 5)], "U": [_f(r, 5)], "V": [_f(r, 3)]},
        {"dim": 1, "power_iters": 2}, _PROD),
    "hierarchical_sigmoid": ("hierarchical_sigmoid", lambda r: {
        "X": [_f(r, 4, 3)], "W": [_f(r, 5, 3)], "Label": [_ids(r, 6, 4, 1)],
        "Bias": [_f(r, 5)]}, {"num_classes": 6}, None),
    "hierarchical_sigmoid:custom": ("hierarchical_sigmoid", lambda r: {
        "X": [_f(r, 3, 3)], "W": [_f(r, 4, 3)], "Label": [_ids(r, 4, 3, 1)],
        "PathTable": [np.array([[0, 1, -1], [0, 2, 3], [0, 1, 3]], np.int64)],
        "PathCode": [np.array([[0, 1, 0], [1, 0, 1], [0, 0, 1]], np.int64)]},
        {"num_classes": 4}, None),
    "polygon_box_transform": ("polygon_box_transform",
                              lambda r: {"Input": [_img(r, 1, 4, 3, 3)]},
                              {}, None),
    "bipartite_match": ("bipartite_match",
                        lambda r: {"DistMat": [r.rand(3, 5).astype(
                            np.float32)]}, {}, None),
    "bipartite_match:per_prediction": (
        "bipartite_match",
        lambda r: {"DistMat": [r.rand(2, 5).astype(np.float32)]},
        {"match_type": "per_prediction", "dist_threshold": 0.3}, None),
    "target_assign": ("target_assign", lambda r: {
        "X": [_f(r, 2, 3, 4)],
        "MatchIndices": [np.array([[0, -1, 2, 1], [-1, 1, 1, 0]], np.int32)]},
        {"mismatch_value": 0.5}, None),
    "fc": ("fc", lambda r: {"Input": [_f(r, 2, 3, 4)], "W": [_f(r, 12, 5)],
                            "Bias": [_f(r, 5)]},
           {"in_num_col_dims": 1, "activation_type": "relu"}, _PROD),
    "multiclass_nms2": ("multiclass_nms2", lambda r: _nms_ins(r),
                        {"score_threshold": 0.1, "nms_top_k": 6,
                         "keep_top_k": 7, "nms_threshold": 0.3,
                         "normalized": False}, None),
    "random_crop": ("random_crop", lambda r: {
        "X": [_f(r, 2, 5, 6)], "Seed": [np.array([3], np.int64)]},
        {"shape": [3, 4]}, None),
    "precision_recall": ("precision_recall", lambda r: {
        "Indices": [_ids(r, 3, 10, 1)], "Labels": [_ids(r, 3, 10, 1)],
        "Weights": [r.rand(10, 1).astype(np.float32)],
        "StatesInfo": [(r.rand(3, 4) * 5).astype(np.float32)]},
        {"class_number": 3}, None),
    # ctr_ops
    "cvm": ("cvm", lambda r: {"X": [np.abs(_f(r, 3, 5))],
                              "CVM": [np.abs(_f(r, 3, 2))]}, {}, None),
    "cvm:strip": ("cvm", lambda r: {"X": [_f(r, 3, 5)],
                                    "CVM": [_f(r, 3, 2)]},
                  {"use_cvm": False}, None),
    "data_norm": ("data_norm", lambda r: {
        "X": [_f(r, 4, 6)], "BatchSize": [np.full(6, 8.0, np.float32)],
        "BatchSum": [_f(r, 6)],
        "BatchSquareSum": [_f(r, 6, pos=True) * 8]}, {}, None),
    "data_norm:slots": ("data_norm", lambda r: {
        "X": [np.concatenate([np.zeros((4, 1), np.float32), _f(r, 4, 5)],
                             1)],
        "BatchSize": [np.full(6, 8.0, np.float32)], "BatchSum": [_f(r, 6)],
        "BatchSquareSum": [_f(r, 6, pos=True) * 8]}, {"slot_dim": 3}, None),
    **{f"nce:{s}": ("nce", lambda r, s=s: dict(
        {"Input": [_f(r, 4, 3)], "Label": [_ids(r, 10, 4, 2)],
         "Weight": [_f(r, 10, 3) * 0.5], "Bias": [_f(r, 10) * 0.1],
         "SampleWeight": [r.rand(4, 1).astype(np.float32)]},
        **({"CustomDistProbs": [np.full(10, 0.1, np.float32)]}
           if s == 2 else {})),
        {"num_total_classes": 10, "num_neg_samples": 5, "sampler": s},
        _PROD) for s in (0, 1, 2)},
    "sample_logits": ("sample_logits", lambda r: {
        "Logits": [_f(r, 3, 20)], "Labels": [_ids(r, 20, 3, 2)]},
        {"num_samples": 6}, None),
    "sample_logits:custom": ("sample_logits", lambda r: {
        "Logits": [_f(r, 2, 8)], "Labels": [_ids(r, 8, 2, 1)],
        "CustomizedSamples": [np.array([[1, 3, 1, 5], [2, 0, 6, 2]],
                                       np.int64)],
        "CustomizedProbabilities": [r.rand(2, 4).astype(np.float32) + 0.1]},
        {"num_samples": 3}, None),
    # quant_ops
    "ste_identity_grad": ("ste_identity_grad",
                          lambda r: {"Out@GRAD": [_f(r, 3, 4)]}, {}, None),
    "fake_quantize_dequantize_abs_max": (
        "fake_quantize_dequantize_abs_max", lambda r: {"X": [_f(r, 4, 5)]},
        _QAT, None),
    "fake_channel_wise_quantize_dequantize_abs_max": (
        "fake_channel_wise_quantize_dequantize_abs_max",
        lambda r: {"X": [_f(r, 3, 2, 2, 2)]}, {"quant_axis": 0}, None),
    "fake_channel_wise_quantize_dequantize_abs_max:axis1": (
        "fake_channel_wise_quantize_dequantize_abs_max",
        lambda r: {"X": [_f(r, 4, 3)]}, {"quant_axis": 1, "bit_length": 4},
        None),
    "fake_quantize_dequantize_moving_average_abs_max": (
        "fake_quantize_dequantize_moving_average_abs_max", _ma_ins,
        {"moving_rate": 0.9}, None),
    "fake_quantize_dequantize_moving_average_abs_max:test": (
        "fake_quantize_dequantize_moving_average_abs_max", _ma_ins,
        {"is_test": True}, None),
    "moving_average_abs_max_scale": (
        "moving_average_abs_max_scale", lambda r: {
            "X": [_f(r, 3, 4)], "InState": [np.array([2.0], np.float32)],
            "InAccum": [np.array([1.5], np.float32)]}, {}, None),
    "fake_quantize_abs_max": ("fake_quantize_abs_max",
                              lambda r: {"X": [_f(r, 4, 5)]}, _QAT, None),
    "fake_channel_wise_quantize_abs_max": (
        "fake_channel_wise_quantize_abs_max",
        lambda r: {"X": [_f(r, 3, 4)]}, {"quant_axis": 0}, None),
    "fake_quantize_range_abs_max": (
        "fake_quantize_range_abs_max", lambda r: {
            "X": [_f(r, 3, 4)], "InScale": [np.array([0.5], np.float32)],
            "InScales": [np.array([0.3, 2.5, 0.0], np.float32)],
            "Iter": [np.array([4], np.int64)]}, {}, None),
    "fake_quantize_range_abs_max:running": (
        "fake_quantize_range_abs_max", lambda r: {
            "X": [_f(r, 3, 4)], "InScale": [np.array([5.0], np.float32)]},
        {}, None),
    "fake_quantize_moving_average_abs_max": (
        "fake_quantize_moving_average_abs_max", _ma_ins, {}, None),
    "fake_dequantize_max_abs": ("fake_dequantize_max_abs", lambda r: {
        "X": [np.round(_f(r, 3, 4) * 40)],
        "Scale": [np.array([2.5], np.float32)]}, {"max_range": 127.0}, None),
    "fake_channel_wise_dequantize_max_abs": (
        "fake_channel_wise_dequantize_max_abs", lambda r: {
            "X": [np.round(_f(r, 3, 4) * 40)],
            "Scales": [_f(r, 3, pos=True), np.array([1.5], np.float32)]},
        {"quant_axis": 0, "quant_bits": [8, 8]}, None),
    "dequantize_abs_max": ("dequantize_abs_max", lambda r: {
        "X": [r.randint(-127, 128, (3, 4)).astype(np.int8)],
        "Scale": [np.array([0.7], np.float32)]}, {}, None),
    "dequantize_log": ("dequantize_log", lambda r: {
        "X": [r.randint(-128, 128, (3, 4)).astype(np.int8)],
        "Dict": [np.sort(r.rand(128)).astype(np.float32)]}, {}, None),
    # detection_ops
    "iou_similarity": ("iou_similarity", lambda r: {
        "X": [_boxes(r, 3)], "Y": [_boxes(r, 5)]}, {}, None),
    "iou_similarity:pixels": ("iou_similarity", lambda r: {
        "X": [_boxes(r, 3, 20.0)], "Y": [_boxes(r, 4, 20.0)]},
        {"box_normalized": False}, None),
    "box_clip": ("box_clip", lambda r: {
        "Input": [(_boxes(r, 3, 1.0, (2,)) * 80 - 10)],
        "ImInfo": [np.array([[40, 50, 1.0], [60, 30, 2.0]], np.float32)]},
        {}, None),
    "box_coder:encode": ("box_coder", lambda r: {
        "PriorBox": [_boxes(r, 4)], "PriorBoxVar": [np.full(
            (4, 4), 0.1, np.float32)], "TargetBox": [_boxes(r, 3)]}, {},
        _PROD),
    "box_coder:decode": ("box_coder", lambda r: {
        "PriorBox": [_boxes(r, 4, 20.0)],
        "PriorBoxVar": [np.array([0.1, 0.1, 0.2, 0.2], np.float32)],
        "TargetBox": [_f(r, 3, 4, 4) * 0.5]},
        {"code_type": "decode_center_size", "box_normalized": False}, _PROD),
    "box_coder:decode_axis1": ("box_coder", lambda r: {
        "PriorBox": [_boxes(r, 3)], "TargetBox": [_f(r, 3, 2, 4) * 0.5]},
        {"code_type": "decode_center_size", "axis": 1}, _PROD),
    "prior_box": ("prior_box", lambda r: {
        "Input": [_img(r, 1, 2, 4, 4)], "Image": [_img(r, 1, 3, 32, 32)]},
        {"min_sizes": [8.0], "max_sizes": [16.0], "aspect_ratios": [2.0],
         "flip": True, "clip": True}, None),
    "anchor_generator": ("anchor_generator", lambda r: {
        "Input": [_img(r, 1, 2, 3, 4)]},
        {"anchor_sizes": [16.0, 32.0], "aspect_ratios": [0.5, 1.0, 2.0],
         "stride": [8.0, 8.0]}, None),
    "yolo_box": ("yolo_box", lambda r: {
        "X": [_img(r, 2, 16, 4, 4)],
        "ImgSize": [np.array([[64, 64], [48, 64]], np.int32)]},
        {"anchors": [10, 13, 16, 30], "class_num": 3, "conf_thresh": 0.3,
         "downsample_ratio": 16}, None),
    "multiclass_nms": ("multiclass_nms", lambda r: _nms_ins(r),
                       {"score_threshold": 0.05, "nms_top_k": 5,
                        "keep_top_k": 6, "nms_threshold": 0.3,
                        "normalized": False}, None),
    "multiclass_nms:kth_tie": ("multiclass_nms",
                               lambda r: _nms_ins(r, tie=True),
                               {"score_threshold": 0.0, "nms_top_k": 5,
                                "keep_top_k": 12, "nms_threshold": 0.2,
                                "normalized": False,
                                "background_label": -1}, None),
    "multiclass_nms:kth_tie_wide": ("multiclass_nms",
                                    lambda r: _nms_ins(r, 1, 2, 100,
                                                       tie=True),
                                    {"score_threshold": 0.0,
                                     "nms_top_k": 5, "keep_top_k": 20,
                                     "nms_threshold": 0.4,
                                     "normalized": False}, None),
    "multiclass_nms:untruncated": ("multiclass_nms",
                                   lambda r: _nms_ins(r, 1, 4, 9),
                                   {"score_threshold": 0.3, "nms_top_k": 50,
                                    "keep_top_k": 30, "nms_threshold": 0.5,
                                    "background_label": 2}, None),
    "roi_align": ("roi_align", lambda r: {
        "X": [_img(r, 2, 3, 8, 8)], "ROIs": [_boxes(r, 4, 14.0)],
        "RoisNum": [np.array([1, 3], np.int32)]},
        {"pooled_height": 2, "pooled_width": 3, "spatial_scale": 0.5,
         "sampling_ratio": 2}, _PROD),
    "roi_align:adaptive": ("roi_align", lambda r: {
        "X": [_img(r, 1, 2, 6, 7)], "ROIs": [_boxes(r, 3, 6.0)]},
        {"pooled_height": 2, "pooled_width": 2, "aligned": True}, _PROD),
    "roi_pool": ("roi_pool", lambda r: {
        "X": [_img(r, 2, 2, 6, 6)], "ROIs": [_boxes(r, 3, 10.0)],
        "RoisNum": [np.array([2, 1], np.int32)]},
        {"pooled_height": 2, "pooled_width": 2, "spatial_scale": 0.5},
        None),
    "psroi_pool": ("psroi_pool", lambda r: {
        "X": [_img(r, 1, 8, 6, 6)], "ROIs": [_boxes(r, 3, 10.0)]},
        {"output_channels": 2, "pooled_height": 2, "pooled_width": 2,
         "spatial_scale": 0.5}, _PROD),
    "yolov3_loss": ("yolov3_loss", lambda r: {
        "X": [_img(r, 2, 24, 4, 4)], "GTBox": [_yolo_gt(r, 2, 3)],
        "GTLabel": [_ids(r, 3, 2, 3).astype(np.int32)]},
        {"anchors": _YOLO_ANCHORS, "anchor_mask": [3, 4, 5], "class_num": 3,
         "ignore_thresh": 0.5, "downsample_ratio": 16}, _PROD),
    "yolov3_loss:score": ("yolov3_loss", lambda r: {
        "X": [_img(r, 1, 16, 4, 4)], "GTBox": [_yolo_gt(r, 1, 3)],
        "GTLabel": [_ids(r, 3, 1, 3).astype(np.int32)],
        "GTScore": [r.rand(1, 3).astype(np.float32)]},
        {"anchors": _YOLO_ANCHORS, "anchor_mask": [0, 1], "class_num": 3,
         "ignore_thresh": 0.3, "downsample_ratio": 8,
         "use_label_smooth": False, "scale_x_y": 1.2}, _PROD),
    "density_prior_box": ("density_prior_box", lambda r: {
        "Input": [_img(r, 1, 2, 3, 3)], "Image": [_img(r, 1, 3, 24, 24)]},
        {"fixed_sizes": [8.0, 12.0], "fixed_ratios": [1.0, 2.0],
         "densities": [2, 1], "clip": True}, None),
    "matrix_nms": ("matrix_nms", lambda r: _nms_ins(r),
                   {"score_threshold": 0.1, "post_threshold": 0.05,
                    "nms_top_k": 8, "keep_top_k": 10}, None),
    "matrix_nms:gaussian": ("matrix_nms", lambda r: _nms_ins(r, 1, 3, 7),
                            {"use_gaussian": True, "gaussian_sigma": 2.0,
                             "background_label": -1}, None),
    "prroi_pool": ("prroi_pool", lambda r: {
        "X": [_img(r, 2, 2, 6, 6)], "ROIs": [_boxes(r, 3, 10.0)],
        "BatchRoINums": [np.array([2, 1], np.int32)]},
        {"pooled_height": 2, "pooled_width": 2, "spatial_scale": 0.5},
        _PROD),
    # proposal_ops (host ops)
    "generate_proposals": ("generate_proposals", _proposal_ins,
                           {"pre_nms_topN": 20, "post_nms_topN": 6,
                            "nms_thresh": 0.5, "min_size": 2.0}, None),
    "rpn_target_assign": ("rpn_target_assign", _rpn_ins,
                          {"rpn_batch_size_per_im": 8, "use_random": True,
                           "seed": 3}, None),
    "generate_proposal_labels": ("generate_proposal_labels", _labels_ins,
                                 {"batch_size_per_im": 6,
                                  "fg_fraction": 0.5, "class_nums": 3,
                                  "use_random": True, "seed": 1}, None),
    # delegate_ops: a delegated cluster of three ops, two of its values
    # leaving it, run by the inline engine
    "subgraph_delegate": ("subgraph_delegate", lambda r: {
        "X": [_f(r, 3, 4), _f(r, 3, 4)]}, {
        "sub_ops": json.dumps([
            {"type": "elementwise_add", "inputs": {"X": ["a"], "Y": ["b"]},
             "outputs": {"Out": ["s"]}, "attrs": {}},
            {"type": "relu", "inputs": {"X": ["s"]},
             "outputs": {"Out": ["t"]}, "attrs": {}},
            {"type": "scale", "inputs": {"X": ["t"]},
             "outputs": {"Out": ["u"]}, "attrs": {"scale": 2.0}}]),
        "input_names": ["a", "b"], "output_names": ["s", "u"],
        "engine": "inline"}, None),
}

#: case id -> the exception both packages raise (no standalone run)
TAIL_RAISES = {}
#: cases whose JAX side runs with 64-bit types off: the random streams
TAIL_X32 = {"sampling_id", "random_crop", "nce:0", "nce:1", "nce:2",
            "sample_logits"}
#: cases whose JAX side runs compiled (``jax.jit``, the attrs constants,
#: as the reference's executor compiles an op): eagerly their loops
#: dispatch thousands of small ops
TAIL_JIT = {"yolov3_loss", "yolov3_loss:score", "multiclass_nms",
            "multiclass_nms:kth_tie", "multiclass_nms:kth_tie_wide",
            "multiclass_nms:untruncated", "multiclass_nms2", "matrix_nms",
            "matrix_nms:gaussian", "roi_align", "roi_align:adaptive",
            "psroi_pool", "prroi_pool", "deformable_conv",
            "deformable_conv_v1", "max_pool3d_with_index",
            "hierarchical_sigmoid", "hierarchical_sigmoid:custom"}
