"""The port's detection ops, proposal host ops and detection programs
against numpy references and the JAX package on the CPU.

- The counterparts of ``tests/test_detection_ops.py`` and
  ``tests/test_proposal_ops.py`` (numpy references of IoU, box coding,
  priors, anchors, the YOLOv3 decode, greedy NMS with the pre-NMS
  truncation, RoIAlign; the proposal ops' padded contracts).
- The reference's RPN training step runs through its dygraph tape (A7.5
  in the port); here it is a static Program, ``chip_smoke.py`` phase 26
  (c)'s (:func:`paddle_tpu_torch.models.detection.rpn_program`) at a
  small size: built by both packages to the same JSON, then three steps
  from the JAX startup's state, per step against JAX.
- Phase 26 (b)'s YOLOv3 programs (:func:`yolov3_programs`) at 64 x 64
  and three classes the same way, and their inference program's NMS.
- The three proposal ops are host ops: a captured key splits at each.

The training programs are held in float64 (the scope and the feeds
upcast, both packages then compute in float64): the RPN's proposals sort
hundreds of scores and sample with numpy's ``RandomState``, and the
YOLOv3 loss thresholds IoUs, so a float32 rounding difference can change
which boxes a step takes. Losses within 1e-9 relative, ``feat@GRAD`` and
every variable after the steps within 1e-8 relative Frobenius distance
or 1e-9 absolute, the RoIs within 1e-4 absolute (float32 outputs of the
host ops), counts exactly.
"""

import torch_threads  # noqa: F401  (one worker's share of the cores)
import types

import jax
import numpy as np
import pytest

import paddle_tpu.layers as JL
import paddle_tpu.optimizer as JO
from paddle_tpu.framework import Executor as JExecutor
from paddle_tpu.framework import Program as JProgram
from paddle_tpu.framework import Scope as JScope
from paddle_tpu.framework import program_guard as jguard
from paddle_tpu.framework import unique_name as jun
from paddle_tpu.layer_helper import LayerHelper as JLayerHelper
from paddle_tpu.param_attr import ParamAttr as JParamAttr

import torch

from paddle_tpu_torch.framework import Executor
from paddle_tpu_torch.framework.executor import plan_pieces
from paddle_tpu_torch.models import detection as det
from paddle_tpu_torch.models.convert import scope_from_numpy
from paddle_tpu_torch.ops import registry as treg

JSTATIC = types.SimpleNamespace(
    layers=JL, Program=JProgram, program_guard=jguard, unique_name=jun,
    Momentum=JO.Momentum, L2Decay=JO.L2Decay, LayerHelper=JLayerHelper,
    ParamAttr=JParamAttr)


def _run(op, ins, attrs):
    ctx = treg.LoweringContext(device="cpu")
    tin = {k: [torch.as_tensor(np.asarray(v)) for v in vs]
           for k, vs in ins.items()}
    return {k: [t.numpy() for t in ts]
            for k, ts in treg.execute(ctx, op, tin, attrs).items()}


def _iou_np(a, b):
    x1 = np.maximum(a[:, None, 0], b[None, :, 0])
    y1 = np.maximum(a[:, None, 1], b[None, :, 1])
    x2 = np.minimum(a[:, None, 2], b[None, :, 2])
    y2 = np.minimum(a[:, None, 3], b[None, :, 3])
    inter = np.maximum(x2 - x1, 0) * np.maximum(y2 - y1, 0)

    def area(z):
        return (z[:, 2] - z[:, 0]) * (z[:, 3] - z[:, 1])

    union = area(a)[:, None] + area(b)[None, :] - inter
    return np.where(union > 0, inter / union, 0)


# ------------------------------------------------ test_detection_ops.py
def test_iou_similarity():
    rng = np.random.RandomState(0)
    a = np.sort(rng.rand(4, 4).astype(np.float32), -1)[:, [0, 2, 1, 3]]
    b = np.sort(rng.rand(3, 4).astype(np.float32), -1)[:, [0, 2, 1, 3]]
    out = _run("iou_similarity", {"X": [a], "Y": [b]},
               {"box_normalized": True})["Out"][0]
    np.testing.assert_allclose(out, _iou_np(a, b), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("boxes,im_info,want", [
    ([[[-5.0, -3.0, 120.0, 140.0], [10.0, 20.0, 30.0, 40.0]]],
     [[100.0, 80.0, 1.0]], [[0.0, 0.0, 79.0, 99.0], [10, 20, 30, 40]]),
    ([[[0.0, 0.0, 700.0, 500.0]]], [[600.0, 800.0, 2.0]],
     [[0.0, 0.0, 399.0, 299.0]]),
], ids=["clip", "respects_scale"])
def test_box_clip(boxes, im_info, want):
    out = _run("box_clip", {"Input": [np.array(boxes, np.float32)],
                            "ImInfo": [np.array(im_info, np.float32)]},
               {})["Output"][0]
    np.testing.assert_allclose(out[0], want)


def test_box_coder_encode_decode_roundtrip():
    rng = np.random.RandomState(1)
    priors = np.sort(rng.rand(5, 4).astype(np.float32), -1)[:, [0, 2, 1, 3]]
    var = np.array([0.1, 0.1, 0.2, 0.2], np.float32)
    targets = np.sort(rng.rand(5, 4).astype(np.float32),
                      -1)[:, [0, 2, 1, 3]] + 0.05
    enc = _run("box_coder", {"PriorBox": [priors], "PriorBoxVar": [var],
                             "TargetBox": [targets]},
               {"code_type": "encode_center_size"})["OutputBox"][0]
    assert enc.shape == (5, 5, 4)
    diag = np.stack([enc[i, i] for i in range(5)])[:, None, :]
    dec = _run("box_coder", {"PriorBox": [priors], "PriorBoxVar": [var],
                             "TargetBox": [np.repeat(diag, 5, 1)]},
               {"code_type": "decode_center_size", "axis": 0})[
        "OutputBox"][0]
    got = np.stack([dec[i, i] for i in range(5)])
    np.testing.assert_allclose(got, targets, rtol=1e-4, atol=1e-5)


def test_prior_box_shapes_and_range():
    boxes, variances = (
        _run("prior_box", {"Input": [np.zeros((1, 8, 4, 4), np.float32)],
                           "Image": [np.zeros((1, 3, 64, 64), np.float32)]},
             {"min_sizes": [16.0], "max_sizes": [32.0],
              "aspect_ratios": [2.0], "flip": True, "clip": True,
              "variances": [0.1, 0.1, 0.2, 0.2]})[k][0]
        for k in ("Boxes", "Variances"))
    assert boxes.shape == (4, 4, 4, 4) and variances.shape == boxes.shape
    assert boxes.min() >= 0.0 and boxes.max() <= 1.0
    cx = (boxes[1, 1, 0, 0] + boxes[1, 1, 0, 2]) / 2
    np.testing.assert_allclose(cx, 1.5 * 16 / 64, atol=1e-5)
    np.testing.assert_allclose(variances[0, 0, 0], [0.1, 0.1, 0.2, 0.2])


def test_anchor_generator_shapes():
    anchors = _run("anchor_generator",
                   {"Input": [np.zeros((1, 8, 3, 5), np.float32)]},
                   {"anchor_sizes": [64.0, 128.0],
                    "aspect_ratios": [0.5, 1.0],
                    "stride": [16.0, 16.0]})["Anchors"][0]
    assert anchors.shape == (3, 5, 4, 4)
    np.testing.assert_allclose(anchors[0, 0, 2],
                               [8 - 32, 8 - 32, 8 + 32, 8 + 32], atol=1e-4)


def _sig(v):
    return 1 / (1 + np.exp(-v))


def test_yolo_box_decode():
    an, nc = [10, 13, 16, 30], 2
    x = np.random.RandomState(2).randn(1, 2 * (5 + nc), 2, 2).astype(
        np.float32)
    out = _run("yolo_box", {"X": [x], "ImgSize": [np.array([[64, 64]])]},
               {"anchors": an, "class_num": nc, "conf_thresh": 0.0,
                "downsample_ratio": 32, "clip_bbox": True})
    boxes, scores = out["Boxes"][0], out["Scores"][0]
    assert boxes.shape == (1, 8, 4) and scores.shape == (1, 8, nc)
    t = x[0, :7]
    cx = _sig(t[0, 0, 0]) / 2 * 64
    cy = _sig(t[1, 0, 0]) / 2 * 64
    bw = np.exp(t[2, 0, 0]) * 10 / (32 * 2) * 64
    bh = np.exp(t[3, 0, 0]) * 13 / (32 * 2) * 64
    np.testing.assert_allclose(
        boxes[0, 0], [max(cx - bw / 2, 0), max(cy - bh / 2, 0),
                      min(cx + bw / 2, 63), min(cy + bh / 2, 63)],
        rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(scores[0, 0],
                               _sig(t[4, 0, 0]) * _sig(t[5:7, 0, 0]),
                               rtol=1e-5)
    assert boxes.min() >= 0 and boxes.max() <= 63


def test_yolo_box_anchor_major_ordering():
    x = np.random.RandomState(6).randn(1, 12, 2, 2).astype(np.float32)
    boxes = _run("yolo_box", {"X": [x], "ImgSize": [np.array([[64, 64]])]},
                 {"anchors": [10, 13, 16, 30], "class_num": 1,
                  "conf_thresh": 0.0, "downsample_ratio": 32,
                  "clip_bbox": False})["Boxes"][0]
    cx = (_sig(x[0, 6, 0, 1]) + 1) / 2 * 64   # anchor 1, y 0, x 1: row 5
    np.testing.assert_allclose((boxes[0, 5, 0] + boxes[0, 5, 2]) / 2, cx,
                               rtol=1e-4)


def _nms_np(boxes, scores, thresh):
    keep = []
    for i in np.argsort(-scores):
        if scores[i] == -np.inf:
            continue
        if all(_iou_np(boxes[i:i + 1], boxes[j:j + 1])[0, 0] <= thresh
               for j in keep):
            keep.append(i)
    return keep


def test_multiclass_nms_matches_greedy_reference():
    rng = np.random.RandomState(3)
    m, c = 12, 3
    base = np.sort(rng.rand(m, 2), 1)
    boxes = np.concatenate([base[:, :1], base[:, :1], base[:, 1:],
                            base[:, 1:]], 1).astype(np.float32)[None]
    scores = rng.rand(1, c, m).astype(np.float32)
    out = _run("multiclass_nms", {"BBoxes": [boxes], "Scores": [scores]},
               {"background_label": 0, "score_threshold": 0.2,
                "nms_threshold": 0.4, "nms_top_k": 10, "keep_top_k": 8,
                "normalized": True})
    rows, num = out["Out"][0][0], int(out["NumDetected"][0][0])
    valid = rows[rows[:, 0] >= 0]
    assert len(valid) == num
    assert (np.diff(valid[:, 1]) <= 1e-6).all()
    expect = set()
    for cls in range(1, c):
        s = scores[0, cls].copy()
        s[s < 0.2] = -np.inf
        s[s < np.sort(s)[::-1][9]] = -np.inf
        for i in _nms_np(boxes[0], s, 0.4):
            expect.add((cls, round(float(scores[0, cls, i]), 5)))
    got = {(int(r[0]), round(float(r[1]), 5)) for r in valid}
    assert got == set(sorted(expect, key=lambda t: -t[1])[:8])


def test_nms_top_k_truncates_before_suppression():
    boxes = np.array([[[0, 0, 1, 1], [2, 2, 3, 3], [4, 4, 5, 5],
                       [6, 6, 7, 7]]], np.float32)
    scores = np.array([[[0.9, 0.8, 0.7, 0.6]]], np.float32)
    out = _run("multiclass_nms", {"BBoxes": [boxes], "Scores": [scores]},
               {"background_label": -1, "score_threshold": 0.0,
                "nms_threshold": 0.5, "nms_top_k": 2, "keep_top_k": 4,
                "normalized": True})
    assert int(out["NumDetected"][0][0]) == 2
    np.testing.assert_allclose(sorted(out["Out"][0][0][:2, 1],
                                      reverse=True), [0.9, 0.8], rtol=1e-5)


def test_multiclass_nms_suppresses_over_candidates_only():
    """At M much larger than nms_top_k the port suppresses over the
    candidates alone; the rows equal a greedy NMS over all M boxes with
    the reference's truncation (numpy)."""
    rng = np.random.RandomState(9)
    m, k = 400, 20
    xy = rng.rand(m, 2) * 50
    boxes = np.concatenate([xy, xy + rng.rand(m, 2) * 20 + 5],
                           1).astype(np.float32)[None]
    scores = rng.rand(1, 2, m).astype(np.float32)
    out = _run("multiclass_nms", {"BBoxes": [boxes], "Scores": [scores]},
               {"background_label": -1, "score_threshold": 0.0,
                "nms_threshold": 0.3, "nms_top_k": k, "keep_top_k": 40,
                "normalized": True})
    rows = out["Out"][0][0]
    expect = []
    for cls in range(2):
        s = scores[0, cls].copy()
        s[s < np.sort(s)[::-1][k - 1]] = -np.inf
        expect += [(cls, float(scores[0, cls, i])) for i in
                   _nms_np(boxes[0], s, 0.3)]
    expect.sort(key=lambda t: -t[1])
    n = int(out["NumDetected"][0][0])
    assert n == len(expect)
    assert [(int(r[0]), float(r[1])) for r in rows[:n]] == expect


def test_roi_align_constant_region():
    out = _run("roi_align",
               {"X": [np.full((1, 2, 8, 8), 3.5, np.float32)],
                "ROIs": [np.array([[1.0, 1.0, 6.0, 6.0]], np.float32)]},
               {"pooled_height": 2, "pooled_width": 2,
                "spatial_scale": 1.0, "sampling_ratio": 2})["Out"][0]
    assert out.shape == (1, 2, 2, 2)
    np.testing.assert_allclose(out, 3.5, rtol=1e-6)


def test_roi_align_batch_routing():
    x = np.stack([np.full((1, 4, 4), 1.0), np.full((1, 4, 4), 2.0)]
                 ).astype(np.float32)
    out = _run("roi_align",
               {"X": [x], "ROIs": [np.array([[0.0, 0.0, 3.0, 3.0]] * 3,
                                            np.float32)],
                "RoisNum": [np.array([1, 2], np.int32)]},
               {"pooled_height": 1, "pooled_width": 1,
                "spatial_scale": 1.0})["Out"][0]
    np.testing.assert_allclose(out.ravel(), [1.0, 2.0, 2.0], rtol=1e-6)


def test_roi_align_grad_matches_finite_differences():
    """The reference's (slow) OpTest of roi_align's gradient, in
    float64 against central differences."""
    rng = np.random.RandomState(4)
    x = rng.randn(1, 2, 6, 6)
    rois = np.array([[0.5, 0.5, 4.5, 4.5], [1.0, 2.0, 5.0, 5.5]])
    attrs = {"pooled_height": 2, "pooled_width": 2, "spatial_scale": 1.0,
             "sampling_ratio": 2}
    cot = rng.randn(2, 2, 2, 2)
    xt = torch.tensor(x, requires_grad=True)
    ctx = treg.LoweringContext(device="cpu")
    out = treg.execute(ctx, "roi_align", {"X": [xt],
                                          "ROIs": [torch.tensor(rois)]},
                       attrs)["Out"][0]
    (g,) = torch.autograd.grad(out, xt, torch.tensor(cot))

    def f(v):
        return float((_run("roi_align", {"X": [v], "ROIs": [rois]},
                           attrs)["Out"][0] * cot).sum())

    num = np.zeros_like(x)
    for idx in np.ndindex(*x.shape):
        e = np.zeros_like(x)
        e[idx] = 1e-6
        num[idx] = (f(x + e) - f(x - e)) / 2e-6
    np.testing.assert_allclose(g.numpy(), num, atol=1e-7, rtol=1e-5)


def test_detection_layers_static():
    import paddle_tpu_torch.layers as L
    from paddle_tpu_torch.framework import (Program, Scope, program_guard,
                                            unique_name)
    main, startup = Program(), Program()
    with program_guard(main, startup), unique_name.guard():
        feat = L.data("feat", [8, 4, 4])
        img = L.data("img", [3, 64, 64])
        boxes, _ = L.detection.prior_box(feat, img, min_sizes=[16.0],
                                         aspect_ratios=[2.0], flip=True,
                                         clip=True)
        x = L.data("x", [2, 8, 8])
        rois = L.data("rois", [4], dtype="float32")
        pooled = L.detection.roi_align(x, rois, pooled_height=2,
                                       pooled_width=2)
    scope, exe = Scope(), Executor("cpu")
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(5)
    outs = exe.run(main, feed={
        "feat": rng.randn(1, 8, 4, 4).astype(np.float32),
        "img": rng.randn(1, 3, 64, 64).astype(np.float32),
        "x": rng.randn(1, 2, 8, 8).astype(np.float32),
        "rois": np.array([[1.0, 1.0, 6.0, 6.0]], np.float32)},
        fetch_list=[boxes.name, pooled.name], scope=scope)
    assert outs[0].shape == (4, 4, 3, 4) and outs[1].shape == (1, 2, 2, 2)


# ------------------------------------------------- test_proposal_ops.py
def _grid_anchors(h, w, sizes=(32.0,), stride=16.0):
    out = np.zeros((h, w, len(sizes), 4), np.float32)
    for y in range(h):
        for x in range(w):
            cx, cy = x * stride + stride / 2, y * stride + stride / 2
            for k, s in enumerate(sizes):
                out[y, x, k] = [cx - s / 2, cy - s / 2, cx + s / 2,
                                cy + s / 2]
    return out


def test_generate_proposals_shapes_and_validity():
    rng = np.random.RandomState(0)
    n, h, w, a = 2, 4, 4, 2
    out = _run("generate_proposals",
               {"Scores": [rng.rand(n, a, h, w).astype(np.float32)],
                "BboxDeltas": [(rng.randn(n, 4 * a, h, w) * 0.1)
                               .astype(np.float32)],
                "ImInfo": [np.array([[64.0, 64.0, 1.0]] * n, np.float32)],
                "Anchors": [_grid_anchors(h, w, sizes=(24.0, 40.0))]},
               {"pre_nms_topN": 12, "post_nms_topN": 5, "nms_thresh": 0.7,
                "min_size": 4.0})
    rois, probs, num = (out["RpnRois"][0], out["RpnRoiProbs"][0],
                        out["RpnRoisNum"][0])
    assert rois.shape == (n, 5, 4) and probs.shape == (n, 5, 1)
    for i in range(n):
        c = int(num[i])
        assert 0 < c <= 5
        r = rois[i, :c]
        assert (r >= 0).all() and (r <= 63).all()
        assert (np.diff(probs[i, :c, 0]) <= 1e-6).all()
        assert (rois[i, c:] == 0).all()


def test_rpn_target_assign_semantics():
    anchors = _grid_anchors(4, 4, sizes=(24.0,)).reshape(-1, 4)
    gt = np.zeros((1, 2, 4), np.float32)
    gt[0, 0] = anchors[5] + [1, 1, 1, 1]
    gt[0, 1] = [0, 0, 10, 10]
    out = _run("rpn_target_assign",
               {"Anchor": [anchors], "GtBoxes": [gt],
                "GtNum": [np.array([2], np.int32)],
                "ImInfo": [np.array([[64, 64, 1]], np.float32)]},
               {"rpn_batch_size_per_im": 8, "rpn_fg_fraction": 0.5,
                "rpn_positive_overlap": 0.7, "rpn_negative_overlap": 0.3,
                "use_random": False})
    fgn, tot = int(out["FgNum"][0][0]), int(out["SampledNum"][0][0])
    labels, loc = out["TargetLabel"][0][0], out["LocationIndex"][0][0]
    assert fgn >= 2 and tot <= 8
    assert (labels[:fgn] == 1).all() and (labels[fgn:] == 0).all()
    assert 5 in loc[:fgn]
    assert np.abs(out["TargetBBox"][0][0][:fgn]).sum() > 0
    iw = out["BBoxInsideWeight"][0][0]
    assert (iw[:fgn] == 1).all() and (iw[fgn:] == 0).all()


def test_generate_proposal_labels_classes():
    rois = np.zeros((1, 4, 4), np.float32)
    rois[0, :3] = [[10, 10, 30, 30], [40, 40, 60, 60], [0, 0, 5, 5]]
    gt_boxes = np.array([[[11, 11, 31, 31], [41, 41, 61, 61]]], np.float32)
    out = _run("generate_proposal_labels",
               {"RpnRois": [rois], "RpnRoisNum": [np.array([3], np.int32)],
                "GtClasses": [np.array([[3, 7]], np.int32)],
                "GtBoxes": [gt_boxes], "GtNum": [np.array([2], np.int32)],
                "ImInfo": [np.array([[64, 64, 1]], np.float32)]},
               {"batch_size_per_im": 6, "fg_fraction": 0.5,
                "fg_thresh": 0.5, "bg_thresh_lo": 0.0, "bg_thresh_hi": 0.5,
                "class_nums": 8, "use_random": False})
    labels, c = out["LabelsInt32"][0][0], int(out["RoisNum"][0][0])
    assert {int(v) for v in labels[:c] if v > 0} >= {3, 7}
    iw = out["BboxInsideWeights"][0][0]
    for j in range(c):
        cls = int(labels[j])
        if cls > 0:
            assert iw[j, 4 * cls:4 * cls + 4].sum() == 4.0
            assert iw[j].sum() == 4.0
    assert out["BboxTargets"][0][0].shape == (6, 32)


# ------------------------------------------------- phase 26's programs
def _up(a):
    return a.astype(np.float64) if a.dtype == np.float32 else a


def _state_close(got, ref, fro=1e-8, atol=1e-9):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    if got.size:
        rel = np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30)
        assert rel <= fro or np.abs(got - ref).max() <= atol, rel


def _train_both(jprog, tprog, jstart, feeds, fetch, f64=True):
    """``len(feeds)`` steps of one program in both packages from the JAX
    startup's state: the per-step fetches (jax, port) and both scopes."""
    jscope, jexe = JScope(), JExecutor()
    jexe.run(jstart, scope=jscope)
    start = {n: jscope.get_numpy(n) for n in jscope.var_names()}
    if f64:
        start = {n: _up(a) for n, a in start.items()}
        feeds = [{k: _up(v) for k, v in f.items()} for f in feeds]
        jscope = JScope()
        for n, a in start.items():
            jscope.set_var(n, jax.numpy.asarray(a))
    tscope, texe = scope_from_numpy(start, "cpu"), Executor("cpu")
    steps = []
    for f in feeds:
        a = jexe.run(jprog, feed=f, fetch_list=fetch, scope=jscope)
        b = texe.run(tprog, feed=f, fetch_list=fetch, scope=tscope)
        steps.append((a, b))
    return steps, jscope, tscope, texe


RPN_SMALL = dict(channels=16, height=8, width=8, gt_slots=3, rpn_batch=32,
                 pre_nms=120, post_nms=24, roi_batch=16, class_nums=4,
                 pooled=2, batch=2)


def test_rpn_program_trains_like_jax():
    j = det.rpn_program(**RPN_SMALL, seed=7, static=JSTATIC)
    t = det.rpn_program(**RPN_SMALL, seed=7)
    assert t.main.to_json() == j.main.to_json()
    assert t.startup.to_json() == j.startup.to_json()
    feeds = det.rpn_feeds(np.random.RandomState(26), 3)
    steps, jscope, tscope, texe = _train_both(j.main, t.main, j.startup,
                                              feeds, t.fetch)
    for a, b in steps:
        for k in range(4):                       # the loss and its terms
            np.testing.assert_allclose(b[k], a[k], rtol=1e-9, atol=1e-9)
        _state_close(b[4], a[4])                 # feat@GRAD
        np.testing.assert_allclose(b[5], a[5], atol=1e-4)   # RoIs
        for k in (6, 7, 8):                      # the counts
            np.testing.assert_array_equal(b[k], a[k])
        assert (np.asarray(b[6]) > 0).all() and (np.asarray(b[8]) > 0).all()
    assert texe.host_syncs == 0                  # no card: no host read
    for n in jscope.var_names():
        _state_close(tscope.get_numpy(n), jscope.get_numpy(n))


def test_proposal_ops_split_a_captured_key():
    """The three proposal ops are host ops: on the card the executor
    splits a captured key at each; the pieces between are graphs."""
    t = det.rpn_program(**RPN_SMALL)
    host = [n for n in ("rpn_target_assign", "generate_proposals",
                        "generate_proposal_labels")
            if treg.get_op_def(n).host_op]
    assert len(host) == 3
    pieces = plan_pieces(t.main, on_card=True)
    ops = t.main.global_block().ops
    assert [ops[a].type for a, b, h in pieces if h] == [
        "rpn_target_assign", "generate_proposals",
        "generate_proposal_labels"]
    # the two proposal ops are neighbours: three graphs around them
    assert sum(not h for _, _, h in pieces) == 3
    assert plan_pieces(t.main, on_card=False) == pieces


YOLO_SMALL = dict(image=64, class_num=3, channels=(16, 8, 4), gt_slots=4)


def test_yolov3_programs_train_and_infer_like_jax():
    j = det.yolov3_programs(**YOLO_SMALL, seed=3, static=JSTATIC)
    t = det.yolov3_programs(**YOLO_SMALL, seed=3)
    for a, b in ((j.main, t.main), (j.startup, t.startup),
                 (j.infer, t.infer)):
        assert b.to_json() == a.to_json()
    feeds = det.yolo_feeds(np.random.RandomState(26), 3)
    steps, jscope, tscope, _ = _train_both(j.main, t.main, j.startup, feeds,
                                           [t.loss.name])
    for a, b in steps:
        np.testing.assert_allclose(b[0], a[0], rtol=1e-9)
    for n in jscope.var_names():
        _state_close(tscope.get_numpy(n), jscope.get_numpy(n))
    # inference in float32 from the trained state: the NMS rows and
    # counts; boxes and scores within float32 rounding
    f = {k: v for k, v in feeds[0].items() if k.startswith("feat")}
    f["img_size"] = np.array([[64, 64], [48, 64]], np.int32)
    state = {n: jscope.get_numpy(n).astype(np.float32)
             for n in jscope.var_names() if n.startswith("yolo_out")}
    js = JScope()
    for n, v in state.items():
        js.set_var(n, jax.numpy.asarray(v))
    fetch = [t.boxes.name, t.scores.name, t.out.name, t.num.name]
    a = JExecutor().run(j.infer, feed=f, fetch_list=fetch, scope=js)
    b = Executor("cpu").run(t.infer, feed=f, fetch_list=fetch,
                            scope=scope_from_numpy(state, "cpu"))
    for k in (0, 1):
        np.testing.assert_allclose(b[k], a[k], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(b[3], a[3])
    assert (np.asarray(b[3]) > 0).all()
    np.testing.assert_array_equal(b[2][..., 0], a[2][..., 0])
    np.testing.assert_allclose(b[2], a[2], rtol=1e-5, atol=1e-4)


def test_nms_wrapper_runs_plain_only_on_cpu_and_raises_elsewhere():
    """``ops.cuda.nms.nms_keep``: its plain version for CPU tensors (no
    launch counted), equal to a greedy numpy NMS per row; a ``meta``
    tensor raises."""
    from paddle_tpu_torch.ops.cuda import nms as nk
    rng = np.random.RandomState(11)
    r, w = 5, 40
    xy = rng.rand(r, w, 2) * 50
    boxes = np.concatenate([xy, xy + rng.rand(r, w, 2) * 20 + 2], -1)
    boxes[:, 5] = boxes[:, 2]                       # an exact duplicate
    scores = -np.sort(-rng.rand(r, w), axis=1)
    scores[1, 30:] = -np.inf
    before = dict(nk.launches)
    for dt in (np.float32, np.float64):
        keep = nk.nms_keep(torch.tensor(boxes.astype(dt)),
                           torch.tensor(scores.astype(dt)), 0.3, False)
        assert keep.dtype == torch.bool and keep.shape == (r, w)
        for i in range(r):
            s = scores[i].copy()
            want = np.zeros(w, bool)
            want[_nms_np(boxes[i].astype(dt) + [0, 0, 1, 1], s, 0.3)] = True
            np.testing.assert_array_equal(keep[i].numpy(), want)
    assert nk.launches == before
    # a meta tensor (the abstract interpreter's) takes the plain shapes
    keep = nk.nms_keep(torch.zeros(1, 2, 4, device="meta"),
                       torch.zeros(1, 2, device="meta"), 0.5, True)
    assert keep.is_meta and keep.shape == (1, 2) and nk.launches == before
    from types import SimpleNamespace
    with pytest.raises(ValueError, match="cuda or cpu"):
        nk.nms_keep(SimpleNamespace(device=torch.device("xpu")),
                    torch.zeros(1, 2), 0.5, True)
