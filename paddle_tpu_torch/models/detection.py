"""Detection heads built as static Programs with the ``layers`` builders:
the programs ``chip_smoke.py``'s phase 26 runs on the card at
PaddleDetection's published geometries, and the ones the CPU tests build
with both packages at small sizes.

:func:`yolov3_programs`: the YOLOv3 head of ``configs/yolov3_darknet.yml``
over fed DarkNet-53 features (three scales): a trainable 1 x 1
``conv2d`` per scale to ``len(mask) * (5 + classes)`` channels, a
``yolov3_loss`` op per scale (appended through ``LayerHelper``, as the
reference has no builder), the sum of their batch means, minimized by
Momentum with L2 decay; and the inference program over the same
parameters: ``yolo_box`` per scale, the boxes and scores concatenated,
``multiclass_nms``.

:func:`rpn_program`: Faster R-CNN's RPN and RoIAlign of
``configs/faster_rcnn_r50_1x.yml`` over a fed C4 feature: the RPN head
(3 x 3 conv with relu, 1 x 1 to the anchors' scores and deltas),
``anchor_generator``, ``rpn_target_assign`` and the RPN's two losses
(sigmoid cross entropy of the sampled anchors, smooth L1 of the fg
anchors' deltas), ``generate_proposals`` and
``generate_proposal_labels`` (the three host ops), ``roi_align`` of the
sampled RoIs; the loss is the RPN's two losses plus the mean of the
pooled features, minimized by Momentum with L2 decay. The feature takes
a gradient (``feat@GRAD``).

Each builder takes the static-graph modules as a namespace (the port's
by default, :func:`port_static`; a test passes the JAX package's) and
names every parameter, so both packages build the same Program.
:func:`yolo_feeds` and :func:`rpn_feeds` make their seeded synthetic
batches.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np

#: configs/yolov3_darknet.yml: anchors, masks (largest first) and the
#: three scales' strides
YOLO_ANCHORS = [10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119, 116, 90,
                156, 198, 373, 326]
YOLO_MASKS = [[6, 7, 8], [3, 4, 5], [0, 1, 2]]
YOLO_DOWNSAMPLE = [32, 16, 8]


def port_static():
    """The port's static-graph modules, as the builders take them."""
    from .. import layers, optimizer
    from ..framework import Program, program_guard, unique_name
    from ..layer_helper import LayerHelper
    from ..param_attr import ParamAttr
    return SimpleNamespace(layers=layers, Program=Program,
                           program_guard=program_guard,
                           unique_name=unique_name, Momentum=optimizer.Momentum,
                           L2Decay=optimizer.L2Decay,
                           LayerHelper=LayerHelper, ParamAttr=ParamAttr)


def _append(S, op, inputs, outputs, attrs, dtypes):
    """One op appended through ``LayerHelper`` (an op the reference has
    no builder for): its outputs, new variables of ``dtypes``."""
    helper = S.LayerHelper(op)
    outs = {}
    for slot, dt in zip(outputs, dtypes):
        outs[slot] = helper.create_variable_for_type_inference(dt)
    helper.append_op(op, inputs=inputs, outputs=outs, attrs=attrs)
    return outs


def _yolo_heads(S, feats, class_num):
    L = S.layers
    outs = []
    for i, (f, mask) in enumerate(zip(feats, YOLO_MASKS)):
        outs.append(L.conv2d(f, len(mask) * (5 + class_num), 1,
                             param_attr=S.ParamAttr(name=f"yolo_out{i}.w"),
                             bias_attr=S.ParamAttr(name=f"yolo_out{i}.b")))
    return outs


def _yolo_data(L, channels, sizes):
    return [L.data(f"feat{i}", [c, s, s]) for i, (c, s) in
            enumerate(zip(channels, sizes))]


def yolov3_programs(image=608, class_num=80, channels=(1024, 512, 256),
                    gt_slots=50, ignore_thresh=0.7, label_smooth=True,
                    lr=0.001, momentum=0.9, l2=5e-4, conf_thresh=0.01,
                    nms_top_k=1000, keep_top_k=100, nms_threshold=0.45,
                    score_threshold=0.01, seed=None, static=None):
    """-> SimpleNamespace(main, startup, loss, infer, boxes, scores, out,
    num): the training program (feeds ``feat0..2``, ``gt_box [B, 4]``
    (cx, cy, w, h in [0, 1]), ``gt_label [B]`` int32), its startup, the
    loss; the inference program (feeds ``feat0..2``, ``img_size [2]``
    int32) with its concatenated boxes and transposed scores and the
    ``multiclass_nms`` outputs."""
    S = static or port_static()
    L = S.layers
    sizes = [image // d for d in YOLO_DOWNSAMPLE]
    main, startup, infer = S.Program(), S.Program(), S.Program()
    if seed is not None:
        main.random_seed = startup.random_seed = seed
    with S.program_guard(main, startup), S.unique_name.guard():
        feats = _yolo_data(L, channels, sizes)
        gt_box = L.data("gt_box", [gt_slots, 4])
        gt_label = L.data("gt_label", [gt_slots], dtype="int32")
        losses = []
        for i, x in enumerate(_yolo_heads(S, feats, class_num)):
            out = _append(S, "yolov3_loss",
                          {"X": [x], "GTBox": [gt_box],
                           "GTLabel": [gt_label]},
                          ("Loss", "ObjectnessMask", "GTMatchMask"),
                          {"anchors": YOLO_ANCHORS,
                           "anchor_mask": YOLO_MASKS[i],
                           "class_num": class_num,
                           "ignore_thresh": ignore_thresh,
                           "downsample_ratio": YOLO_DOWNSAMPLE[i],
                           "use_label_smooth": label_smooth},
                          ("float32", "float32", "int32"))
            losses.append(L.reduce_mean(out["Loss"]))
        loss = L.sums(losses)
        S.Momentum(learning_rate=lr, momentum=momentum,
                   regularization=S.L2Decay(l2)).minimize(loss)
    infer_startup = S.Program()
    with S.program_guard(infer, infer_startup), S.unique_name.guard():
        feats = _yolo_data(L, channels, sizes)
        img_size = L.data("img_size", [2], dtype="int32")
        boxes, scores = [], []
        for i, x in enumerate(_yolo_heads(S, feats, class_num)):
            anchors = []
            for m in YOLO_MASKS[i]:
                anchors += YOLO_ANCHORS[2 * m:2 * m + 2]
            b, s = L.detection.yolo_box(x, img_size, anchors, class_num,
                                        conf_thresh, YOLO_DOWNSAMPLE[i])
            boxes.append(b)
            scores.append(s)
        all_boxes = L.concat(boxes, axis=1)
        all_scores = L.transpose(L.concat(scores, axis=1), [0, 2, 1])
        out, num = L.detection.multiclass_nms(
            all_boxes, all_scores, score_threshold, nms_top_k, keep_top_k,
            nms_threshold=nms_threshold, normalized=False,
            background_label=-1)
    return SimpleNamespace(main=main, startup=startup, loss=loss,
                           infer=infer, boxes=all_boxes, scores=all_scores,
                           out=out, num=num)


#: configs/faster_rcnn_r50_1x.yml's RPN, proposals and RoI sampling
RPN_ANCHOR_SIZES = [32.0, 64.0, 128.0, 256.0, 512.0]
RPN_RATIOS = [0.5, 1.0, 2.0]


def rpn_program(channels=1024, height=50, width=84, gt_slots=8,
                rpn_batch=256, rpn_fg=0.5, rpn_pos=0.7, rpn_neg=0.3,
                pre_nms=12000, post_nms=2000, nms_thresh=0.7, min_size=0.0,
                roi_batch=512, roi_fg=0.25, fg_thresh=0.5, bg_hi=0.5,
                bg_lo=0.0, class_nums=81, reg_weights=(0.1, 0.1, 0.2, 0.2),
                pooled=14, lr=0.02, momentum=0.9, l2=1e-4, batch=2,
                seed=None, static=None):
    """-> SimpleNamespace(main, startup, loss, fetch): feeds ``feat [C, H,
    W]`` (stride 16), ``gt_boxes [G, 4]`` (x1, y1, x2, y2 in pixels),
    ``gt_num [1]``, ``gt_classes [G]`` (all int32 but the boxes),
    ``im_info [3]``; ``fetch`` the loss, its two RPN terms, the pooled
    mean, ``feat@GRAD``, the RoIs and their count."""
    S = static or port_static()
    L = S.layers
    a = len(RPN_ANCHOR_SIZES) * len(RPN_RATIOS)
    hwa = height * width * a
    main, startup = S.Program(), S.Program()
    if seed is not None:
        main.random_seed = startup.random_seed = seed
    with S.program_guard(main, startup), S.unique_name.guard():
        feat = L.data("feat", [channels, height, width])
        feat.stop_gradient = False
        gt_boxes = L.data("gt_boxes", [gt_slots, 4])
        gt_num = L.data("gt_num", [], dtype="int32")
        gt_classes = L.data("gt_classes", [gt_slots], dtype="int32")
        im_info = L.data("im_info", [3])
        conv = L.conv2d(feat, channels, 3, padding=1, act="relu",
                        param_attr=S.ParamAttr(name="rpn_conv.w"),
                        bias_attr=S.ParamAttr(name="rpn_conv.b"))
        cls = L.conv2d(conv, a, 1, param_attr=S.ParamAttr(name="rpn_cls.w"),
                       bias_attr=S.ParamAttr(name="rpn_cls.b"))
        bbox = L.conv2d(conv, 4 * a, 1,
                        param_attr=S.ParamAttr(name="rpn_bbox.w"),
                        bias_attr=S.ParamAttr(name="rpn_bbox.b"))
        anchors, variances = L.detection.anchor_generator(
            feat, RPN_ANCHOR_SIZES, RPN_RATIOS, variance=(1.0, 1.0, 1.0, 1.0),
            stride=(16.0, 16.0))
        asn = _append(S, "rpn_target_assign",
                      {"Anchor": [L.reshape(anchors, [-1, 4])],
                       "GtBoxes": [gt_boxes], "GtNum": [gt_num],
                       "ImInfo": [im_info]},
                      ("LocationIndex", "ScoreIndex", "TargetLabel",
                       "TargetBBox", "BBoxInsideWeight", "FgNum",
                       "SampledNum"),
                      {"rpn_batch_size_per_im": rpn_batch,
                       "rpn_fg_fraction": rpn_fg,
                       "rpn_positive_overlap": rpn_pos,
                       "rpn_negative_overlap": rpn_neg, "use_random": True,
                       "seed": 0},
                      ("int32", "int32", "int32", "float32", "float32",
                       "int32", "int32"))
        zero = L.fill_constant([1], "int32", 0)
        score_idx = asn["ScoreIndex"]
        valid = L.cast(L.greater_equal(score_idx, zero), "float32")
        # [N, A, H, W] -> [N, H*W*A]: the anchors' (y, x, a) order
        flat = L.reshape(L.transpose(cls, [0, 2, 3, 1]), [batch, hwa])
        picked = L.index_sample(flat, L.elementwise_max(score_idx, zero))
        bce = L.sigmoid_cross_entropy_with_logits(
            picked, L.cast(asn["TargetLabel"], "float32"))
        n_valid = L.reduce_sum(valid)
        loss_cls = L.elementwise_div(
            L.reduce_sum(L.elementwise_mul(bce, valid)), n_valid)
        # [N, 4A, H, W] -> [N*4, H*W*A]; the fg anchors' four deltas
        deltas = L.reshape(L.transpose(
            L.reshape(bbox, [batch, a, 4, height, width]), [0, 2, 3, 4, 1]),
            [batch * 4, hwa])
        loc = L.reshape(L.expand(L.unsqueeze(
            L.elementwise_max(asn["LocationIndex"], zero), [1]), [1, 4, 1]),
            [batch * 4, rpn_batch])
        got = L.transpose(L.reshape(L.index_sample(deltas, loc),
                                    [batch, 4, rpn_batch]), [0, 2, 1])
        w = asn["BBoxInsideWeight"]
        loss_bbox = L.elementwise_div(L.reduce_sum(L.smooth_l1(
            L.reshape(got, [-1, 4]), L.reshape(asn["TargetBBox"], [-1, 4]),
            L.reshape(w, [-1, 4]), L.reshape(w, [-1, 4]), sigma=3.0)),
            n_valid)
        props = _append(S, "generate_proposals",
                        {"Scores": [L.sigmoid(cls)], "BboxDeltas": [bbox],
                         "ImInfo": [im_info], "Anchors": [anchors],
                         "Variances": [variances]},
                        ("RpnRois", "RpnRoiProbs", "RpnRoisNum"),
                        {"pre_nms_topN": pre_nms, "post_nms_topN": post_nms,
                         "nms_thresh": nms_thresh, "min_size": min_size},
                        ("float32", "float32", "int32"))
        labels = _append(S, "generate_proposal_labels",
                         {"RpnRois": [props["RpnRois"]],
                          "RpnRoisNum": [props["RpnRoisNum"]],
                          "GtClasses": [gt_classes], "GtBoxes": [gt_boxes],
                          "GtNum": [gt_num], "ImInfo": [im_info]},
                         ("Rois", "LabelsInt32", "BboxTargets",
                          "BboxInsideWeights", "BboxOutsideWeights",
                          "RoisNum"),
                         {"batch_size_per_im": roi_batch,
                          "fg_fraction": roi_fg, "fg_thresh": fg_thresh,
                          "bg_thresh_hi": bg_hi, "bg_thresh_lo": bg_lo,
                          "class_nums": class_nums, "use_random": True,
                          "seed": 0, "bbox_reg_weights": list(reg_weights)},
                         ("float32", "int32", "float32", "float32",
                          "float32", "int32"))
        # every image's rows padded to roi_batch: the row's image by
        # that fixed count
        per_image = L.fill_constant([batch], "int32", roi_batch)
        pooled_feat = L.roi_align(feat, L.reshape(labels["Rois"], [-1, 4]),
                                  pooled, pooled, 1.0 / 16, 0,
                                  rois_num=per_image)
        loss_roi = L.reduce_mean(pooled_feat)
        loss = L.sums([loss_cls, loss_bbox, loss_roi])
        S.Momentum(learning_rate=lr, momentum=momentum,
                   regularization=S.L2Decay(l2)).minimize(loss)
    fetch = [loss.name, loss_cls.name, loss_bbox.name, loss_roi.name,
             "feat@GRAD", labels["Rois"].name, labels["RoisNum"].name,
             props["RpnRoisNum"].name, asn["FgNum"].name]
    return SimpleNamespace(main=main, startup=startup, loss=loss,
                           fetch=fetch)


def yolo_feeds(rng, steps, batch=2, image=64, channels=(16, 8, 4),
               gt_slots=4, class_num=3):
    """Seeded feeds of :func:`yolov3_programs`: the three scales'
    features, the ground truth (cx, cy, w, h in [0, 1], the last slot of
    each image empty), labels."""
    out = []
    for _ in range(steps):
        f = {f"feat{i}": rng.randn(batch, c, image // d, image // d)
             .astype(np.float32) for i, (c, d) in
             enumerate(zip(channels, YOLO_DOWNSAMPLE))}
        gt = np.concatenate([rng.rand(batch, gt_slots, 2) * 0.8 + 0.1,
                             rng.rand(batch, gt_slots, 2) * 0.5 + 0.05], -1)
        gt[:, -1] = 0.0
        f["gt_box"] = gt.astype(np.float32)
        f["gt_label"] = rng.randint(0, class_num, (batch, gt_slots)).astype(
            np.int32)
        out.append(f)
    return out


def rpn_feeds(rng, steps, batch=2, channels=16, height=8, width=8,
              gt_slots=3):
    """Seeded feeds of :func:`rpn_program`: the feature, two to
    ``gt_slots`` ground-truth boxes per image inside the ``16 * (height,
    width)`` image, their classes."""
    out = []
    ih, iw = 16 * height, 16 * width
    for _ in range(steps):
        gt = np.zeros((batch, gt_slots, 4), np.float32)
        num = rng.randint(2, gt_slots + 1, batch).astype(np.int32)
        for i in range(batch):
            xy = rng.rand(num[i], 2) * [iw * 0.6, ih * 0.6]
            wh = rng.rand(num[i], 2) * [iw * 0.35, ih * 0.35] + 16
            gt[i, :num[i]] = np.concatenate([xy, xy + wh], 1)
        out.append({
            "feat": rng.randn(batch, channels, height, width).astype(
                np.float32),
            "gt_boxes": gt, "gt_num": num,
            "gt_classes": rng.randint(1, 4, (batch, gt_slots)).astype(
                np.int32),
            "im_info": np.array([[ih, iw, 1.0]] * batch, np.float32)})
    return out
