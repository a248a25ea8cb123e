"""Two-stage detection proposal ops — the counterpart of
``paddle_tpu/ops/proposal_ops.py``: ``generate_proposals``,
``rpn_target_assign`` and ``generate_proposal_labels``.

They are host ops, as the reference's are (it runs numpy through
``jax.pure_callback``): per-image variable counts, greedy NMS over
decoded anchors and random sampling of fg / bg sets. Each reads its
inputs back to the host, runs the reference's numpy functions (copied
here, ``RandomState(seed)`` per call included) and returns padded,
fixed-capacity outputs with valid counts. They are registered with
``host_op=True``: on the card the executor splits a captured key at each
(:func:`~.control_flow_ops.splits_key`), counts each run's read in
``Executor.host_syncs`` and captures the pieces between. None is
differentiable; gradients flow through the gathers that consume their
indices.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .registry import register, register_infer

_BBOX_CLIP = math.log(1000.0 / 16.0)


# ---------------------------------------------------------------------------
# numpy geometry helpers (host side)
# ---------------------------------------------------------------------------

def _decode(anchors, deltas, variances):
    """anchors [M,4] xyxy, deltas [M,4] -> boxes [M,4] xyxy."""
    w = anchors[:, 2] - anchors[:, 0] + 1.0
    h = anchors[:, 3] - anchors[:, 1] + 1.0
    cx = anchors[:, 0] + 0.5 * w
    cy = anchors[:, 1] + 0.5 * h
    d = deltas * variances if variances is not None else deltas
    pcx = d[:, 0] * w + cx
    pcy = d[:, 1] * h + cy
    pw = np.exp(np.minimum(d[:, 2], _BBOX_CLIP)) * w
    ph = np.exp(np.minimum(d[:, 3], _BBOX_CLIP)) * h
    return np.stack([pcx - 0.5 * pw, pcy - 0.5 * ph,
                     pcx + 0.5 * pw - 1.0, pcy + 0.5 * ph - 1.0], axis=1)


def _encode(ex, gt, weights=(1.0, 1.0, 1.0, 1.0)):
    """Inverse of _decode: regression targets of gt w.r.t. ex boxes."""
    ew = ex[:, 2] - ex[:, 0] + 1.0
    eh = ex[:, 3] - ex[:, 1] + 1.0
    ecx = ex[:, 0] + 0.5 * ew
    ecy = ex[:, 1] + 0.5 * eh
    gw = gt[:, 2] - gt[:, 0] + 1.0
    gh = gt[:, 3] - gt[:, 1] + 1.0
    gcx = gt[:, 0] + 0.5 * gw
    gcy = gt[:, 1] + 0.5 * gh
    wx, wy, ww, wh = weights
    return np.stack([wx * (gcx - ecx) / ew, wy * (gcy - ecy) / eh,
                     ww * np.log(gw / ew), wh * np.log(gh / eh)], axis=1)


def _clip(boxes, im_h, im_w):
    out = boxes.copy()
    out[:, 0::2] = np.clip(out[:, 0::2], 0, im_w - 1)
    out[:, 1::2] = np.clip(out[:, 1::2], 0, im_h - 1)
    return out


def _iou(a, b):
    """[M,4] x [G,4] -> [M,G] IoU (legacy +1 pixel convention)."""
    if a.size == 0 or b.size == 0:
        return np.zeros((a.shape[0], b.shape[0]), np.float32)
    ax = np.maximum(a[:, None, 0], b[None, :, 0])
    ay = np.maximum(a[:, None, 1], b[None, :, 1])
    bx = np.minimum(a[:, None, 2], b[None, :, 2])
    by = np.minimum(a[:, None, 3], b[None, :, 3])
    iw = np.maximum(bx - ax + 1.0, 0.0)
    ih = np.maximum(by - ay + 1.0, 0.0)
    inter = iw * ih
    area_a = (a[:, 2] - a[:, 0] + 1.0) * (a[:, 3] - a[:, 1] + 1.0)
    area_b = (b[:, 2] - b[:, 0] + 1.0) * (b[:, 3] - b[:, 1] + 1.0)
    return (inter / (area_a[:, None] + area_b[None] - inter)).astype(
        np.float32)


def _nms_np(boxes, scores, thresh, max_keep):
    order = np.argsort(-scores)
    keep = []
    while order.size and len(keep) < max_keep:
        i = order[0]
        keep.append(i)
        if order.size == 1:
            break
        ious = _iou(boxes[i:i + 1], boxes[order[1:]])[0]
        order = order[1:][ious <= thresh]
    return np.asarray(keep, np.int64)


def _sample(idx, want, rng):
    """Reservoir-sampling analog: keep ``want`` of ``idx`` (all if fewer);
    deterministic prefix when rng is None (use_random=False)."""
    if want <= 0 or idx.size <= want:
        return idx
    if rng is None:
        return idx[:want]
    return rng.choice(idx, size=want, replace=False)


# ---------------------------------------------------------------------------
# generate_proposals
# ---------------------------------------------------------------------------

def _gen_proposals_host(scores, deltas, im_info, anchors, variances,
                        pre_n, post_n, nms_thresh, min_size):
    n = scores.shape[0]
    rois = np.zeros((n, post_n, 4), np.float32)
    probs = np.zeros((n, post_n, 1), np.float32)
    counts = np.zeros((n,), np.int32)
    a_flat = anchors.reshape(-1, 4).astype(np.float32)
    v_flat = (variances.reshape(-1, 4).astype(np.float32)
              if variances is not None and variances.size else None)
    for i in range(n):
        # [A,H,W] score / [4A,H,W] deltas -> anchor-major flat order
        s = np.transpose(scores[i], (1, 2, 0)).reshape(-1)
        d = np.transpose(
            deltas[i].reshape(-1, 4, deltas.shape[2], deltas.shape[3]),
            (2, 3, 0, 1)).reshape(-1, 4)
        k = min(pre_n, s.size) if pre_n > 0 else s.size
        top = np.argsort(-s)[:k]
        boxes = _decode(a_flat[top], d[top],
                        v_flat[top] if v_flat is not None else None)
        im_h, im_w, im_scale = im_info[i][:3]
        boxes = _clip(boxes, im_h, im_w)
        ws = (boxes[:, 2] - boxes[:, 0] + 1.0) / im_scale
        hs = (boxes[:, 3] - boxes[:, 1] + 1.0) / im_scale
        ms = max(min_size, 1.0)
        keep = (ws >= ms) & (hs >= ms)
        boxes, sc = boxes[keep], s[top][keep]
        if boxes.shape[0]:
            kept = _nms_np(boxes, sc, nms_thresh, post_n)
            c = kept.size
            rois[i, :c] = boxes[kept]
            probs[i, :c, 0] = sc[kept]
            counts[i] = c
    return rois, probs, counts


# ---------------------------------------------------------------------------
# rpn_target_assign
# ---------------------------------------------------------------------------

def _rpn_assign_host(anchors, gt_boxes, gt_counts, im_info, batch_per_im,
                     fg_frac, pos_thresh, neg_thresh, use_random, seed):
    n = gt_boxes.shape[0]
    a = anchors.reshape(-1, 4)
    na = a.shape[0]
    loc_idx = np.full((n, batch_per_im), -1, np.int32)
    score_idx = np.full((n, batch_per_im), -1, np.int32)
    labels = np.zeros((n, batch_per_im), np.int32)
    targets = np.zeros((n, batch_per_im, 4), np.float32)
    fg_counts = np.zeros((n,), np.int32)
    tot_counts = np.zeros((n,), np.int32)
    rng = np.random.RandomState(seed) if use_random else None
    for i in range(n):
        g = gt_boxes[i][:int(gt_counts[i])]
        if g.shape[0] == 0:
            continue
        iou = _iou(a, g)                       # [A, G]
        amax = iou.max(axis=1)
        argmax = iou.argmax(axis=1)
        fg_mask = amax >= pos_thresh
        # per-gt best anchor is always fg (handles all-low-IoU gts)
        fg_mask[iou.argmax(axis=0)] = True
        fg = np.flatnonzero(fg_mask)
        fg = _sample(fg, int(fg_frac * batch_per_im), rng)
        bg = np.flatnonzero((amax < neg_thresh) & ~fg_mask)
        bg = _sample(bg, batch_per_im - fg.size, rng)
        nf, nb = fg.size, bg.size
        loc_idx[i, :nf] = fg
        score_idx[i, :nf] = fg
        score_idx[i, nf:nf + nb] = bg
        labels[i, :nf] = 1
        targets[i, :nf] = _encode(a[fg], g[argmax[fg]])
        fg_counts[i] = nf
        tot_counts[i] = nf + nb
    return loc_idx, score_idx, labels, targets, fg_counts, tot_counts


# ---------------------------------------------------------------------------
# generate_proposal_labels
# ---------------------------------------------------------------------------

def _proposal_labels_host(rois, rois_num, gt_classes, gt_boxes, gt_num,
                          im_info, batch_per_im, fg_frac, fg_thresh,
                          bg_lo, bg_hi, class_nums, use_random, seed,
                          bbox_reg_weights):
    n = rois.shape[0]
    out_rois = np.zeros((n, batch_per_im, 4), np.float32)
    out_labels = np.zeros((n, batch_per_im), np.int32)
    out_targets = np.zeros((n, batch_per_im, 4 * class_nums), np.float32)
    out_inside = np.zeros_like(out_targets)
    counts = np.zeros((n,), np.int32)
    rng = np.random.RandomState(seed) if use_random else None
    for i in range(n):
        r = rois[i][:int(rois_num[i])]
        g = gt_boxes[i][:int(gt_num[i])]
        gc = gt_classes[i][:int(gt_num[i])]
        # gt boxes join the candidate set (generate_proposal_labels_op.cc
        # concatenates gt to rois so every gt has a perfect candidate)
        cand = np.concatenate([r, g], axis=0) if g.size else r
        if cand.shape[0] == 0:
            continue
        iou = _iou(cand, g)
        cmax = iou.max(axis=1) if g.size else np.zeros(cand.shape[0])
        cargmax = iou.argmax(axis=1) if g.size else np.zeros(
            cand.shape[0], np.int64)
        fg = np.flatnonzero(cmax >= fg_thresh)
        fg = _sample(fg, int(fg_frac * batch_per_im), rng)
        bg = np.flatnonzero((cmax < bg_hi) & (cmax >= bg_lo))
        bg = _sample(bg, batch_per_im - fg.size, rng)
        sel = np.concatenate([fg, bg])
        c = sel.size
        out_rois[i, :c] = cand[sel]
        lab = np.zeros((c,), np.int32)
        lab[:fg.size] = gc[cargmax[fg]].astype(np.int32)
        out_labels[i, :c] = lab
        if fg.size:
            t = _encode(cand[fg], g[cargmax[fg]], bbox_reg_weights)
            for j, cls in enumerate(lab[:fg.size]):
                out_targets[i, j, 4 * cls:4 * cls + 4] = t[j]
                out_inside[i, j, 4 * cls:4 * cls + 4] = 1.0
        counts[i] = c
    return out_rois, out_labels, out_targets, out_inside, counts


# ---------------------------------------------------------------------------
# the host ops
# ---------------------------------------------------------------------------


def _host_call(name, fn, args, dtypes, device):
    """Run ``fn`` on the host's numpy copies of ``args`` (None passes
    through) and bring its outputs back to ``device`` in ``dtypes``."""
    from . import control_flow_ops as _cf
    ts = [a for a in args if a is not None]
    if any(t.is_cuda for t in ts):
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"{name} runs on the host and cannot be captured; the "
                f"executor splits a key at a top-level one")
        _cf.note_host_read()
    outs = fn(*[None if a is None else a.detach().cpu().numpy()
                for a in args])
    return [torch.as_tensor(np.asarray(o, dt)).to(device)
            for o, dt in zip(outs, dtypes)]


@register("generate_proposals", not_differentiable=True, host_op=True)
def _generate_proposals(ctx, ins, attrs):
    """RPN proposals. Padded contract: RpnRois [N, post_nms_topN, 4],
    RpnRoiProbs [N, post_nms_topN, 1], RpnRoisNum [N] valid counts."""
    scores = ins["Scores"][0]
    pre_n = int(attrs.get("pre_nms_topN", 6000))
    post_n = int(attrs.get("post_nms_topN", 1000))
    nms_thresh = float(attrs.get("nms_thresh", 0.5))
    min_size = float(attrs.get("min_size", 0.1))

    def cb(s, d, ii, an, va):
        return _gen_proposals_host(s, d, ii, an, va, pre_n, post_n,
                                   nms_thresh, min_size)

    rois, probs, counts = _host_call(
        "generate_proposals", cb,
        [scores, ins["BboxDeltas"][0], ins["ImInfo"][0], ins["Anchors"][0],
         ins.get("Variances", [None])[0]],
        (np.float32, np.float32, np.int32), scores.device)
    return {"RpnRois": [rois], "RpnRoiProbs": [probs],
            "RpnRoisNum": [counts]}


@register("rpn_target_assign", not_differentiable=True, host_op=True)
def _rpn_target_assign(ctx, ins, attrs):
    """RPN anchor sampling. Per-image padded contract: LocationIndex /
    ScoreIndex [N, rpn_batch_size_per_im] anchor indices (-1 padded),
    TargetLabel [N, B] (1 fg / 0 bg), TargetBBox [N, B, 4],
    BBoxInsideWeight [N, B, 4], FgNum / SampledNum [N]. GtBoxes comes
    padded [N, G, 4] with GtNum [N]."""
    anchors = ins["Anchor"][0]
    gt = ins["GtBoxes"][0]
    gt_num = ins.get("GtNum", [None])[0]
    n, gmax = gt.shape[0], gt.shape[1]
    if gt_num is None:
        gt_num = torch.full((n,), gmax, dtype=torch.int32, device=gt.device)
    b = int(attrs.get("rpn_batch_size_per_im", 256))
    fg_frac = float(attrs.get("rpn_fg_fraction", 0.5))
    pos = float(attrs.get("rpn_positive_overlap", 0.7))
    neg = float(attrs.get("rpn_negative_overlap", 0.3))
    use_random = bool(attrs.get("use_random", True))
    seed = int(attrs.get("seed", 0))

    def cb(a, g, gn, ii):
        return _rpn_assign_host(a, g, gn, ii, b, fg_frac, pos, neg,
                                use_random, seed)

    loc, sc, lab, tgt, fgn, totn = _host_call(
        "rpn_target_assign", cb, [anchors, gt, gt_num, ins["ImInfo"][0]],
        (np.int32, np.int32, np.int32, np.float32, np.int32, np.int32),
        anchors.device)
    inside_w = (torch.arange(b, device=fgn.device)[None, :, None]
                < fgn[:, None, None]).to(torch.float32).expand(n, b, 4)
    return {"LocationIndex": [loc], "ScoreIndex": [sc],
            "TargetLabel": [lab], "TargetBBox": [tgt],
            "BBoxInsideWeight": [inside_w], "FgNum": [fgn],
            "SampledNum": [totn]}


@register("generate_proposal_labels", not_differentiable=True,
          host_op=True)
def _generate_proposal_labels(ctx, ins, attrs):
    """RoI sampling for the box head. Padded contract: Rois [N,
    batch_size_per_im, 4], LabelsInt32 [N, B], BboxTargets [N, B,
    4 * class_nums] with inside / outside weights, RoisNum [N]. RpnRois
    comes padded [N, R, 4] with RpnRoisNum (``generate_proposals``'
    output feeds straight in)."""
    rois = ins["RpnRois"][0]
    rois_num = ins.get("RpnRoisNum", [None])[0]
    gt_boxes = ins["GtBoxes"][0]
    gt_num = ins.get("GtNum", [None])[0]
    n, rmax = rois.shape[0], rois.shape[1]
    gmax = gt_boxes.shape[1]
    dev = rois.device
    if rois_num is None:
        rois_num = torch.full((n,), rmax, dtype=torch.int32, device=dev)
    if gt_num is None:
        gt_num = torch.full((n,), gmax, dtype=torch.int32, device=dev)
    b = int(attrs.get("batch_size_per_im", 512))
    fg_frac = float(attrs.get("fg_fraction", 0.25))
    fg_thresh = float(attrs.get("fg_thresh", 0.5))
    bg_lo = float(attrs.get("bg_thresh_lo", 0.0))
    bg_hi = float(attrs.get("bg_thresh_hi", 0.5))
    class_nums = int(attrs.get("class_nums", 81))
    use_random = bool(attrs.get("use_random", True))
    seed = int(attrs.get("seed", 0))
    # the reference's weights divide the targets; _encode multiplies
    w = tuple(1.0 / x for x in attrs.get("bbox_reg_weights",
                                         (0.1, 0.1, 0.2, 0.2)))

    def cb(r, rn, gc, g, gn, ii):
        return _proposal_labels_host(r, rn, gc, g, gn, ii, b, fg_frac,
                                     fg_thresh, bg_lo, bg_hi, class_nums,
                                     use_random, seed, w)

    out_rois, labels, targets, inside, counts = _host_call(
        "generate_proposal_labels", cb,
        [rois, rois_num, ins["GtClasses"][0], gt_boxes, gt_num,
         ins["ImInfo"][0]],
        (np.float32, np.int32, np.float32, np.float32, np.int32), dev)
    return {"Rois": [out_rois], "LabelsInt32": [labels],
            "BboxTargets": [targets], "BboxInsideWeights": [inside],
            "BboxOutsideWeights": [inside], "RoisNum": [counts]}


# ---------------------------------------------------------------------------
# static infer rules (the abstract interpreter): a host op reads its
# inputs' values, which a meta tensor does not have; its outputs are
# padded to shapes the attrs fix, the reference's ``pure_callback``
# result shapes (``paddle_tpu/ops/proposal_ops.py:190-194, 270-276,
# 372-377``)
# ---------------------------------------------------------------------------


def _av(shape, dtype):
    from ..analysis.abstract_interp import AbstractVar
    return AbstractVar(tuple(int(d) for d in shape), dtype)


@register_infer("generate_proposals")
def _generate_proposals_infer(ictx, ins, attrs):
    n = ins["Scores"][0].shape[0]
    post_n = int(attrs.get("post_nms_topN", 1000))
    return {"RpnRois": [_av((n, post_n, 4), "float32")],
            "RpnRoiProbs": [_av((n, post_n, 1), "float32")],
            "RpnRoisNum": [_av((n,), "int32")]}


@register_infer("rpn_target_assign")
def _rpn_target_assign_infer(ictx, ins, attrs):
    n = ins["GtBoxes"][0].shape[0]
    b = int(attrs.get("rpn_batch_size_per_im", 256))
    return {"LocationIndex": [_av((n, b), "int32")],
            "ScoreIndex": [_av((n, b), "int32")],
            "TargetLabel": [_av((n, b), "int32")],
            "TargetBBox": [_av((n, b, 4), "float32")],
            "BBoxInsideWeight": [_av((n, b, 4), "float32")],
            "FgNum": [_av((n,), "int32")],
            "SampledNum": [_av((n,), "int32")]}


@register_infer("generate_proposal_labels")
def _generate_proposal_labels_infer(ictx, ins, attrs):
    n = ins["RpnRois"][0].shape[0]
    b = int(attrs.get("batch_size_per_im", 512))
    c4 = 4 * int(attrs.get("class_nums", 81))
    return {"Rois": [_av((n, b, 4), "float32")],
            "LabelsInt32": [_av((n, b), "int32")],
            "BboxTargets": [_av((n, b, c4), "float32")],
            "BboxInsideWeights": [_av((n, b, c4), "float32")],
            "BboxOutsideWeights": [_av((n, b, c4), "float32")],
            "RoisNum": [_av((n,), "int32")]}
