"""Detection layer builders (fluid ``layers/detection.py``) — the
counterpart of ``paddle_tpu/layers/detection.py``: ``yolo_box``,
``box_coder``, ``prior_box``, ``anchor_generator``, ``iou_similarity``,
``box_clip``, ``multiclass_nms`` and ``roi_align`` over
:mod:`~paddle_tpu_torch.ops.detection_ops`. The reference's
variable-count outputs are fixed-capacity here: ``multiclass_nms``
returns ``(out, num_detected)``."""

from __future__ import annotations

from ..layer_helper import build_simple_op as _op


def iou_similarity(x, y, box_normalized=True):
    return _op("iou_similarity", {"X": [x], "Y": [y]},
               {"box_normalized": box_normalized})


def box_clip(input, im_info):  # noqa: A002
    return _op("box_clip", {"Input": [input], "ImInfo": [im_info]}, {},
               out_slots=("Output",))


def box_coder(prior_box, prior_box_var, target_box,
              code_type="encode_center_size", box_normalized=True,
              axis=0):
    inputs = {"PriorBox": [prior_box], "TargetBox": [target_box]}
    if prior_box_var is not None:
        inputs["PriorBoxVar"] = [prior_box_var]
    return _op("box_coder", inputs,
               {"code_type": code_type, "box_normalized": box_normalized,
                "axis": axis}, out_slots=("OutputBox",))


def prior_box(input, image, min_sizes, max_sizes=None,  # noqa: A002
              aspect_ratios=(1.0,), variance=(0.1, 0.1, 0.2, 0.2),
              flip=False, clip=False, steps=(0.0, 0.0), offset=0.5):
    return _op("prior_box", {"Input": [input], "Image": [image]},
               {"min_sizes": list(min_sizes),
                "max_sizes": list(max_sizes or []),
                "aspect_ratios": list(aspect_ratios),
                "variances": list(variance), "flip": flip, "clip": clip,
                "step_w": steps[0], "step_h": steps[1], "offset": offset},
               out_slots=("Boxes", "Variances"))


def anchor_generator(input, anchor_sizes, aspect_ratios,  # noqa: A002
                     variance=(0.1, 0.1, 0.2, 0.2), stride=(16.0, 16.0),
                     offset=0.5):
    return _op("anchor_generator", {"Input": [input]},
               {"anchor_sizes": list(anchor_sizes),
                "aspect_ratios": list(aspect_ratios),
                "variances": list(variance), "stride": list(stride),
                "offset": offset},
               out_slots=("Anchors", "Variances"))


def yolo_box(x, img_size, anchors, class_num, conf_thresh,
             downsample_ratio, clip_bbox=True, scale_x_y=1.0):
    return _op("yolo_box", {"X": [x], "ImgSize": [img_size]},
               {"anchors": list(anchors), "class_num": int(class_num),
                "conf_thresh": float(conf_thresh),
                "downsample_ratio": int(downsample_ratio),
                "clip_bbox": clip_bbox, "scale_x_y": scale_x_y},
               out_slots=("Boxes", "Scores"))


def multiclass_nms(bboxes, scores, score_threshold, nms_top_k,
                   keep_top_k, nms_threshold=0.3, normalized=True,
                   background_label=0):
    """-> (out [N, keep_top_k, 6] rows (label, score, box), padded with
    label -1; num_detected [N])."""
    return _op("multiclass_nms",
               {"BBoxes": [bboxes], "Scores": [scores]},
               {"score_threshold": float(score_threshold),
                "nms_top_k": int(nms_top_k),
                "keep_top_k": int(keep_top_k),
                "nms_threshold": float(nms_threshold),
                "normalized": normalized,
                "background_label": int(background_label)},
               out_slots=("Out", "NumDetected"))


def roi_align(input, rois, pooled_height=1, pooled_width=1,  # noqa: A002
              spatial_scale=1.0, sampling_ratio=-1, rois_num=None,
              aligned=False):
    inputs = {"X": [input], "ROIs": [rois]}
    if rois_num is not None:
        inputs["RoisNum"] = [rois_num]
    return _op("roi_align", inputs,
               {"pooled_height": int(pooled_height),
                "pooled_width": int(pooled_width),
                "spatial_scale": float(spatial_scale),
                "sampling_ratio": int(sampling_ratio),
                "aligned": aligned})


__all__ = ["anchor_generator", "box_clip", "box_coder", "iou_similarity",
           "multiclass_nms", "prior_box", "roi_align", "yolo_box"]
