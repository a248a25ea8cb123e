"""Detection op lowerings — the counterpart of
``paddle_tpu/ops/detection_ops.py``: ``iou_similarity``, ``box_clip``,
``box_coder``, ``prior_box``, ``anchor_generator``, ``yolo_box``,
``multiclass_nms``, ``roi_align``, ``roi_pool``, ``psroi_pool``,
``yolov3_loss``, ``density_prior_box``, ``matrix_nms`` and
``prroi_pool``.

Every output has a static shape and nothing is read back to the host, so
each op runs inside a captured step. The reference's variable-count
outputs (``multiclass_nms``'s LoD rows) are fixed-capacity rows padded
with label -1 plus a count.

``multiclass_nms`` keeps the reference's pre-NMS truncation (only the
``nms_top_k`` best scores of a class, ties at the k-th score included,
enter suppression) but suppresses over those candidates only: a stable
sort per (image, class), then the greedy loop over the first ``min(M,
nms_top_k + 64)`` sorted boxes of every (image, class) at once, on the
card by the hand-written kernel of :mod:`.cuda.nms` (one block per row).
The reference builds an M x M IoU matrix per class and loops over all M
boxes, which at a YOLOv3 geometry (M = 22,743, 80 classes) is ~2 GB per
class. The results are the same unless more than 64 boxes of a class tie
at its k-th score (ROADMAP C).

``roi_align`` contracts each RoI's bin-averaged bilinear weights with
the feature map, one separable matrix per axis (the reference gathers
every sample point of every RoI, which at a Faster R-CNN geometry is
~13 GB per gather).
"""

from __future__ import annotations

import numpy as np
import torch

from .cuda.nms import iou_matrix as _iou_matrix
from .cuda.nms import nms_keep
from .math_ops import absolute
from .registry import register
from .tensor_ops import host_values

#: boxes tied at a class's k-th score beyond ``nms_top_k`` that
#: ``multiclass_nms`` still admits to its suppression
NMS_TIE_SLACK = 64


# ------------------------------------------------------------- helpers

def _rois_batch_idx(rois_num, r, device):
    """Each flat RoI row's image: RoisNum holds the per-image counts;
    None means one image."""
    if rois_num is None:
        return torch.zeros((r,), dtype=torch.int64, device=device)
    ends = torch.cumsum(rois_num.reshape(-1).to(torch.int64), 0)
    return torch.searchsorted(ends, torch.arange(r, device=device),
                              right=True)


def _f32(v, device):
    """Host constants as a float32 tensor on ``device`` (filled on the
    device under a capture)."""
    return host_values(np.asarray(v, np.float32), torch.float32, device)


# ------------------------------------------------------------- iou

@register("iou_similarity", no_grad_slots=("Y",))
def _iou_similarity(ctx, ins, attrs):
    normalized = bool(attrs.get("box_normalized", True))
    return {"Out": [_iou_matrix(ins["X"][0], ins["Y"][0], normalized)]}


# ------------------------------------------------------------- box_clip

@register("box_clip", no_grad_slots=("ImInfo",))
def _box_clip(ctx, ins, attrs):
    """Boxes clipped to the original image: (h, w) of ImInfo over its
    scale, rounded, minus one."""
    boxes = ins["Input"][0]
    im_info = ins["ImInfo"][0]
    scale = im_info[:, 2]
    shape = (-1,) + (1,) * (boxes.ndim - 2)
    h = (torch.round(im_info[:, 0] / scale) - 1.0).reshape(shape)
    w = (torch.round(im_info[:, 1] / scale) - 1.0).reshape(shape)
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)

    def clip(v, hi):
        return torch.minimum(torch.maximum(v, zero), hi)

    return {"Output": [torch.stack([
        clip(boxes[..., 0], w), clip(boxes[..., 1], h),
        clip(boxes[..., 2], w), clip(boxes[..., 3], h)], dim=-1)]}


# ------------------------------------------------------------- box_coder

@register("box_coder", no_grad_slots=("PriorBox", "PriorBoxVar"))
def _box_coder(ctx, ins, attrs):
    """Encode / decode boxes against priors in center-size form."""
    prior = ins["PriorBox"][0]
    pvar = ins.get("PriorBoxVar", [None])[0]
    target = ins["TargetBox"][0]
    code_type = attrs.get("code_type", "encode_center_size")
    normalized = bool(attrs.get("box_normalized", True))
    axis = int(attrs.get("axis", 0))
    off = 0.0 if normalized else 1.0
    pw = prior[:, 2] - prior[:, 0] + off
    ph = prior[:, 3] - prior[:, 1] + off
    pcx = prior[:, 0] + pw * 0.5
    pcy = prior[:, 1] + ph * 0.5
    if pvar is None:
        pvar_arr = torch.ones((prior.shape[0], 4), dtype=prior.dtype,
                              device=prior.device)
    elif pvar.ndim == 1:
        pvar_arr = pvar.expand(prior.shape[0], 4)
    else:
        pvar_arr = pvar

    if code_type.startswith("encode"):
        tw = target[:, 2] - target[:, 0] + off
        th = target[:, 3] - target[:, 1] + off
        tcx = target[:, 0] + tw * 0.5
        tcy = target[:, 1] + th * 0.5
        dx = (tcx[:, None] - pcx[None, :]) / pw[None, :]
        dy = (tcy[:, None] - pcy[None, :]) / ph[None, :]
        dw = torch.log(tw[:, None] / pw[None, :])
        dh = torch.log(th[:, None] / ph[None, :])
        out = torch.stack([dx, dy, dw, dh], dim=-1) / pvar_arr[None]
        return {"OutputBox": [out]}  # [N, M, 4]

    squeeze = target.ndim == 2
    if squeeze:
        target = target[:, None, :]
    if axis == 0:
        pcx_b, pcy_b = pcx[None, :, None], pcy[None, :, None]
        pw_b, ph_b = pw[None, :, None], ph[None, :, None]
        var_b = pvar_arr[None, :, :]
    else:
        pcx_b, pcy_b = pcx[:, None, None], pcy[:, None, None]
        pw_b, ph_b = pw[:, None, None], ph[:, None, None]
        var_b = pvar_arr[:, None, :]
    t = target * var_b
    cx = t[..., 0:1] * pw_b + pcx_b
    cy = t[..., 1:2] * ph_b + pcy_b
    w = torch.exp(t[..., 2:3]) * pw_b
    h = torch.exp(t[..., 3:4]) * ph_b
    out = torch.cat([cx - w * 0.5, cy - h * 0.5,
                     cx + w * 0.5 - off, cy + h * 0.5 - off], dim=-1)
    return {"OutputBox": [out.squeeze(1) if out.shape[1] == 1 and squeeze
                          else out]}


# ------------------------------------------------------------- priors

def _grid_boxes(h, w, step_h, step_w, offset, sizes, device):
    """Centers on an h x w grid, box sizes [(bw, bh), ...] ->
    [h, w, len(sizes), 4] (x1, y1, x2, y2)."""
    cy = (torch.arange(h, dtype=torch.float32, device=device) + offset) \
        * step_h
    cx = (torch.arange(w, dtype=torch.float32, device=device) + offset) \
        * step_w
    cyg, cxg = torch.meshgrid(cy, cx, indexing="ij")
    bw = _f32([s[0] for s in sizes], device) * 0.5
    bh = _f32([s[1] for s in sizes], device) * 0.5
    return torch.stack([cxg[..., None] - bw, cyg[..., None] - bh,
                        cxg[..., None] + bw, cyg[..., None] + bh], dim=-1)


def _variances(attrs, like):
    return _f32(attrs.get("variances", [0.1, 0.1, 0.2, 0.2]),
                like.device).expand(like.shape)


@register("prior_box", not_differentiable=True)
def _prior_box(ctx, ins, attrs):
    """SSD priors [H, W, num_priors, 4], normalized to [0, 1]."""
    feat, img = ins["Input"][0], ins["Image"][0]
    h, w = feat.shape[2], feat.shape[3]
    ih, iw = img.shape[2], img.shape[3]
    min_sizes = [float(s) for s in attrs["min_sizes"]]
    max_sizes = [float(s) for s in attrs.get("max_sizes", [])]
    ars = [1.0]
    for ar in attrs.get("aspect_ratios", []):
        ar = float(ar)
        if not any(abs(ar - e) < 1e-6 for e in ars):
            ars.append(ar)
            if attrs.get("flip", True):
                ars.append(1.0 / ar)
    step_w = float(attrs.get("step_w", 0) or iw / w)
    step_h = float(attrs.get("step_h", 0) or ih / h)
    offset = float(attrs.get("offset", 0.5))
    sizes = []
    for i, ms in enumerate(min_sizes):
        sizes.append((ms, ms))
        for ar in ars[1:]:
            sizes.append((ms * ar ** 0.5, ms / ar ** 0.5))
        if max_sizes:
            big = (ms * max_sizes[i]) ** 0.5
            sizes.append((big, big))
    boxes = _grid_boxes(h, w, step_h, step_w, offset, sizes, feat.device)
    boxes = boxes / _f32([iw, ih, iw, ih], feat.device)
    if attrs.get("clip", True):
        boxes = torch.clamp(boxes, 0.0, 1.0)
    return {"Boxes": [boxes], "Variances": [_variances(attrs, boxes)]}


@register("anchor_generator", not_differentiable=True)
def _anchor_generator(ctx, ins, attrs):
    """RPN anchors [H, W, num_anchors, 4] in input-image pixels."""
    feat = ins["Input"][0]
    h, w = feat.shape[2], feat.shape[3]
    sizes = [float(s) for s in attrs.get("anchor_sizes", [64, 128, 256])]
    ars = [float(a) for a in attrs.get("aspect_ratios", [0.5, 1.0, 2.0])]
    stride = [float(s) for s in attrs.get("stride", [16.0, 16.0])]
    offset = float(attrs.get("offset", 0.5))
    shapes = []
    for ar in ars:
        for sz in sizes:
            area = stride[0] * stride[1]
            base_w = (area / ar) ** 0.5
            base_h = base_w * ar
            scale = sz / (area ** 0.5)
            shapes.append((base_w * scale, base_h * scale))
    anchors = _grid_boxes(h, w, stride[1], stride[0], offset, shapes,
                          feat.device)
    return {"Anchors": [anchors], "Variances": [_variances(attrs, anchors)]}


# ------------------------------------------------------------- yolo_box

@register("yolo_box", no_grad_slots=("ImgSize",), not_differentiable=True)
def _yolo_box(ctx, ins, attrs):
    """YOLOv3 head decode: X [N, an*(5+nc), H, W] + ImgSize [N, 2] ->
    Boxes [N, an*H*W, 4] (x1 y1 x2 y2 in image pixels, anchor-major
    rows), Scores [N, an*H*W, nc]."""
    x = ins["X"][0]
    img_size = ins["ImgSize"][0]
    anchors = [float(a) for a in attrs["anchors"]]
    nc = int(attrs["class_num"])
    conf_thresh = float(attrs.get("conf_thresh", 0.01))
    downsample = int(attrs.get("downsample_ratio", 32))
    clip_bbox = bool(attrs.get("clip_bbox", True))
    scale_xy = float(attrs.get("scale_x_y", 1.0))
    n, c, h, w = x.shape
    an = len(anchors) // 2
    dev = x.device
    x = x.reshape(n, an, 5 + nc, h, w)
    gx = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    gy = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    bias = -0.5 * (scale_xy - 1.0)
    sx = torch.sigmoid(x[:, :, 0]) * scale_xy + bias
    sy = torch.sigmoid(x[:, :, 1]) * scale_xy + bias
    cx = (sx + gx) / w
    cy = (sy + gy) / h
    aw = _f32(anchors[0::2], dev)[None, :, None, None]
    ah = _f32(anchors[1::2], dev)[None, :, None, None]
    in_w = float(np.float32(downsample) * np.float32(w))
    in_h = float(np.float32(downsample) * np.float32(h))
    bw = torch.exp(x[:, :, 2]) * aw / in_w
    bh = torch.exp(x[:, :, 3]) * ah / in_h
    conf = torch.sigmoid(x[:, :, 4])
    probs = torch.sigmoid(x[:, :, 5:]) * conf[:, :, None]
    keep = conf >= conf_thresh
    probs = torch.where(keep[:, :, None], probs, torch.zeros_like(probs))
    imh = img_size[:, 0].to(torch.float32)[:, None, None, None]
    imw = img_size[:, 1].to(torch.float32)[:, None, None, None]
    x1 = (cx - bw * 0.5) * imw
    y1 = (cy - bh * 0.5) * imh
    x2 = (cx + bw * 0.5) * imw
    y2 = (cy + bh * 0.5) * imh
    if clip_bbox:
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        x1 = torch.minimum(torch.maximum(x1, zero), imw - 1)
        y1 = torch.minimum(torch.maximum(y1, zero), imh - 1)
        x2 = torch.minimum(torch.maximum(x2, zero), imw - 1)
        y2 = torch.minimum(torch.maximum(y2, zero), imh - 1)
    boxes = torch.stack([x1, y1, x2, y2], dim=-1).reshape(n, an * h * w, 4)
    scores = probs.permute(0, 1, 3, 4, 2).reshape(n, an * h * w, nc)
    return {"Boxes": [boxes], "Scores": [scores]}


# ------------------------------------------------------------- nms

@register("multiclass_nms", not_differentiable=True)
def _multiclass_nms(ctx, ins, attrs):
    """Per-class greedy NMS with fixed-capacity output: BBoxes [N, M, 4],
    Scores [N, C, M] -> Out [N, keep_top_k, 6] rows (label, score, x1,
    y1, x2, y2) padded with label -1, NumDetected [N]."""
    bboxes = ins["BBoxes"][0]
    scores = ins["Scores"][0]
    bg = int(attrs.get("background_label", 0))
    score_thresh = float(attrs.get("score_threshold", 0.0))
    nms_thresh = float(attrs.get("nms_threshold", 0.3))
    nms_top_k = int(attrs.get("nms_top_k", 400))
    keep_top_k = int(attrs.get("keep_top_k", 100))
    normalized = bool(attrs.get("normalized", True))
    n, c, m = scores.shape
    dev = scores.device
    ninf = torch.full((), float("-inf"), dtype=scores.dtype, device=dev)
    fg = [i for i in range(c) if i != bg] if 0 <= bg < c else list(range(c))
    fg_idx = host_values(np.asarray(fg, np.int64), torch.int64, dev)
    s = scores.index_select(1, fg_idx) if len(fg) < c else scores
    # s: [N, C', M]
    s = torch.where(s >= score_thresh, s, ninf)
    top_k = min(nms_top_k, m)
    sorted_s, order = torch.sort(s, dim=-1, descending=True, stable=True)
    if top_k < m:
        # the pre-NMS truncation: only scores >= the k-th enter
        kth = sorted_s[..., top_k - 1:top_k]
        width = min(m, top_k + NMS_TIE_SLACK)
        sorted_s, order = sorted_s[..., :width], order[..., :width]
        sorted_s = torch.where(sorted_s >= kth, sorted_s, ninf)
    cf, width = len(fg), sorted_s.shape[-1]
    cand = torch.gather(bboxes[:, None].expand(n, cf, m, 4), 2,
                        order[..., None].expand(n, cf, width, 4))
    keep = nms_keep(cand.reshape(n * cf, width, 4),
                    sorted_s.reshape(n * cf, width), nms_thresh,
                    normalized).reshape(n, cf, width)
    kept = torch.full((n, c, m), float("-inf"), dtype=scores.dtype,
                      device=dev)
    kept[:, fg_idx] = kept[:, fg_idx].scatter(
        2, order, torch.where(keep, sorted_s, ninf))
    flat = kept.reshape(n, c * m)
    k = min(keep_top_k, c * m)
    top_vals, top_idx = torch.sort(flat, dim=1, descending=True,
                                   stable=True)
    top_vals, top_idx = top_vals[:, :k], top_idx[:, :k]
    labels = torch.div(top_idx, m, rounding_mode="floor").to(scores.dtype)
    box_idx = top_idx % m
    sel = torch.gather(bboxes, 1, box_idx[..., None].expand(n, k, 4))
    valid = top_vals > float("-inf")
    zero = torch.zeros((), dtype=scores.dtype, device=dev)
    rows = torch.cat([
        torch.where(valid, labels, torch.full_like(labels, -1.0))[..., None],
        torch.where(valid, top_vals, zero)[..., None],
        torch.where(valid[..., None], sel, zero)], dim=2)
    outs = {"Out": [rows], "NumDetected": [valid.sum(1).to(torch.int64)]}
    if attrs.get("__want_index__"):
        offs = torch.arange(n, device=dev)[:, None] * m
        idx = torch.where(valid, box_idx + offs, torch.full_like(box_idx, -1))
        outs["Index"] = [idx.to(torch.int32).reshape(-1, 1)]
    return outs


# ------------------------------------------------------------- roi_align

def _bin_weights(start, bin_size, pooled, ratio, size):
    """Each bin's mean bilinear weight over the input positions of one
    axis: ``start``/``bin_size`` [R] -> [R, pooled, size]."""
    r = start.shape[0]
    dev, dt = start.device, start.dtype
    pts = (torch.arange(pooled, device=dev, dtype=dt)[:, None]
           * bin_size[:, None, None] + start[:, None, None]
           + (torch.arange(ratio, device=dev, dtype=dt)[None, :] + 0.5)
           * bin_size[:, None, None] / ratio)         # [R, pooled, ratio]
    pts = torch.clamp(pts, 0.0, size - 1.0)
    lo = torch.floor(pts).to(torch.int64)
    hi = torch.clamp_max(lo + 1, size - 1)
    frac = pts - lo
    w = torch.zeros((r, pooled, size), dtype=dt, device=dev)
    w = w.scatter_add(2, lo, (1 - frac) / ratio)
    return w.scatter_add(2, hi, frac / ratio)


@register("roi_align", no_grad_slots=("ROIs", "RoisNum"))
def _roi_align(ctx, ins, attrs):
    """RoIAlign: X [N, C, H, W] + ROIs [R, 4] (x1, y1, x2, y2) -> [R, C,
    ph, pw], the mean of ``ratio x ratio`` bilinear samples per bin
    (``sampling_ratio <= 0`` samples 4 x 4, as the reference)."""
    x = ins["X"][0]
    rois = ins["ROIs"][0]
    rois_num = ins.get("RoisNum", [None])[0]
    ph = int(attrs.get("pooled_height", 1))
    pw = int(attrs.get("pooled_width", 1))
    scale = float(attrs.get("spatial_scale", 1.0))
    ratio = int(attrs.get("sampling_ratio", -1))
    if ratio <= 0:
        ratio = 4
    aligned = bool(attrs.get("aligned", False))
    n, c, h, w = x.shape
    r = rois.shape[0]
    bi = _rois_batch_idx(rois_num, r, x.device)
    half = 0.5 if aligned else 0.0
    x1 = rois[:, 0] * scale - half
    y1 = rois[:, 1] * scale - half
    x2 = rois[:, 2] * scale - half
    y2 = rois[:, 3] * scale - half
    floor = 1e-6 if aligned else 1.0
    rw = torch.clamp_min(x2 - x1, floor)
    rh = torch.clamp_min(y2 - y1, floor)
    wy = _bin_weights(y1, rh / ph, ph, ratio, h).to(x.dtype)   # [R, ph, H]
    wx = _bin_weights(x1, rw / pw, pw, ratio, w).to(x.dtype)   # [R, pw, W]
    # each RoI's weights on its own image only: [R, N, pw, W]
    onehot = (bi[:, None] == torch.arange(n, device=x.device)[None, :])
    wxn = wx[:, None] * onehot[:, :, None, None].to(x.dtype)
    cols = torch.einsum("nchw,rnpw->rchp", x, wxn)              # [R,C,H,pw]
    return {"Out": [torch.einsum("rchp,rqh->rcqp", cols, wy)]}


@register("roi_pool", no_grad_slots=("ROIs", "RoisNum"),
          nondiff_outputs=("Argmax",))
def _roi_pool(ctx, ins, attrs):
    """RoIPool: max over each quantized bin by a per-bin membership mask
    (the reference's rounding)."""
    x = ins["X"][0]
    rois = ins["ROIs"][0]
    rois_num = ins.get("RoisNum", [None])[0]
    ph = int(attrs.get("pooled_height", 1))
    pw = int(attrs.get("pooled_width", 1))
    scale = float(attrs.get("spatial_scale", 1.0))
    n, c, h, w = x.shape
    r = rois.shape[0]
    dev = x.device
    bi = _rois_batch_idx(rois_num, r, dev)
    neg = torch.full((), float(torch.finfo(x.dtype).min), dtype=x.dtype,
                     device=dev)
    ys = torch.arange(h, device=dev)
    xs = torch.arange(w, device=dev)
    x1 = torch.round(rois[:, 0] * scale)
    y1 = torch.round(rois[:, 1] * scale)
    x2 = torch.round(rois[:, 2] * scale)
    y2 = torch.round(rois[:, 3] * scale)
    bin_h = torch.clamp_min(y2 - y1 + 1, 1.0) / ph
    bin_w = torch.clamp_min(x2 - x1 + 1, 1.0) / pw
    i_ = torch.arange(ph, device=dev, dtype=x.dtype)[None, :, None]
    j_ = torch.arange(pw, device=dev, dtype=x.dtype)[None, None, :]
    bh, bw = bin_h[:, None, None], bin_w[:, None, None]
    y1_, x1_ = y1[:, None, None], x1[:, None, None]
    hstart = torch.clamp(torch.floor(i_ * bh) + y1_, 0, h)
    hend = torch.clamp(torch.ceil((i_ + 1) * bh) + y1_, 0, h)
    wstart = torch.clamp(torch.floor(j_ * bw) + x1_, 0, w)
    wend = torch.clamp(torch.ceil((j_ + 1) * bw) + x1_, 0, w)
    in_y = (ys >= hstart[..., None]) & (ys < hend[..., None])  # R,ph,1,H
    in_x = (xs >= wstart[..., None]) & (xs < wend[..., None])  # R,1,pw,W
    mask = in_y[..., :, None] & in_x[..., None, :]     # [R, ph, pw, H, W]
    img = x[bi]                                         # [R, C, H, W]
    masked = torch.where(mask[:, None], img[:, :, None, None], neg)
    flat = masked.reshape(r, c, ph, pw, h * w)
    val = torch.amax(flat, dim=-1)
    amax = torch.argmax(flat, dim=-1)
    empty = ~mask.any(dim=-1).any(dim=-1)               # [R, ph, pw]
    val = torch.where(empty[:, None], torch.zeros_like(val), val)
    amax = torch.where(empty[:, None], torch.full_like(amax, -1), amax)
    return {"Out": [val], "Argmax": [amax]}


@register("psroi_pool", no_grad_slots=("ROIs", "RoisNum"))
def _psroi_pool(ctx, ins, attrs):
    """Position-sensitive average pooling: bin (i, j) of output channel
    c averages input channel c*ph*pw + i*pw + j over the bin."""
    x = ins["X"][0]
    rois = ins["ROIs"][0]
    rois_num = ins.get("RoisNum", [None])[0]
    oc = int(attrs["output_channels"])
    ph = int(attrs.get("pooled_height", 1))
    pw = int(attrs.get("pooled_width", 1))
    scale = float(attrs.get("spatial_scale", 1.0))
    n, c, h, w = x.shape
    r = rois.shape[0]
    dev = x.device
    bi = _rois_batch_idx(rois_num, r, dev)
    ys = torch.arange(h, device=dev)
    xs = torch.arange(w, device=dev)
    x1 = (torch.round(rois[:, 0]) * scale)[:, None, None]
    y1 = (torch.round(rois[:, 1]) * scale)[:, None, None]
    x2 = (torch.round(rois[:, 2] + 1.0) * scale)[:, None, None]
    y2 = (torch.round(rois[:, 3] + 1.0) * scale)[:, None, None]
    bin_h = torch.clamp_min(y2 - y1, 0.1) / ph
    bin_w = torch.clamp_min(x2 - x1, 0.1) / pw
    i_ = torch.arange(ph, device=dev, dtype=x.dtype)[None, :, None]
    j_ = torch.arange(pw, device=dev, dtype=x.dtype)[None, None, :]
    hstart = torch.clamp(torch.floor(i_ * bin_h + y1), 0, h)
    hend = torch.clamp(torch.ceil((i_ + 1) * bin_h + y1), 0, h)
    wstart = torch.clamp(torch.floor(j_ * bin_w + x1), 0, w)
    wend = torch.clamp(torch.ceil((j_ + 1) * bin_w + x1), 0, w)
    in_y = (ys >= hstart[..., None]) & (ys < hend[..., None])
    in_x = (xs >= wstart[..., None]) & (xs < wend[..., None])
    mask = (in_y[..., :, None] & in_x[..., None, :]).to(x.dtype)
    count = mask.sum(dim=(-1, -2))                     # [R, ph, pw]
    img = x[bi].reshape(r, oc, ph, pw, h, w)
    summed = torch.einsum("rcijhw,rijhw->rcij", img, mask)
    out = summed / torch.clamp_min(count, 1.0)[:, None]
    return {"Out": [torch.where((count == 0)[:, None],
                                torch.zeros_like(out), out)]}


def _sce(x, z):
    """Sigmoid cross entropy (yolov3_loss_op.h:34)."""
    return torch.relu(x) - x * z + torch.log1p(torch.exp(-absolute(x)))


def _iou_cwh(x1, y1, w1, h1, x2, y2, w2, h2):
    left = torch.maximum(x1 - w1 / 2, x2 - w2 / 2)
    right = torch.minimum(x1 + w1 / 2, x2 + w2 / 2)
    top = torch.maximum(y1 - h1 / 2, y2 - h2 / 2)
    bottom = torch.minimum(y1 + h1 / 2, y2 + h2 / 2)
    inter = torch.clamp_min(right - left, 0.0) \
        * torch.clamp_min(bottom - top, 0.0)
    union = w1 * h1 + w2 * h2 - inter
    return inter / torch.clamp_min(union, 1e-10)


@register("yolov3_loss",
          no_grad_slots=("GTBox", "GTLabel", "GTScore"),
          nondiff_outputs=("ObjectnessMask", "GTMatchMask"))
def _yolov3_loss(ctx, ins, attrs):
    """YOLOv3 training loss: one pass for the ignore mask (every
    prediction against every ground truth), then a loop over the B
    ground-truth slots (a static count) with indexed updates."""
    x = ins["X"][0]
    gtbox = ins["GTBox"][0]
    gtlabel = ins["GTLabel"][0].to(torch.int64)
    gtscore = ins.get("GTScore", [None])[0]
    anchors = [int(a) for a in attrs["anchors"]]
    anchor_mask = [int(a) for a in attrs["anchor_mask"]]
    class_num = int(attrs["class_num"])
    ignore_thresh = float(attrs.get("ignore_thresh", 0.7))
    downsample = int(attrs.get("downsample_ratio", 32))
    use_label_smooth = bool(attrs.get("use_label_smooth", True))
    scale_xy = float(attrs.get("scale_x_y", 1.0))
    bias_xy = -0.5 * (scale_xy - 1.0)
    n, _, h, w = x.shape
    b = gtbox.shape[1]
    dev, dt = x.device, x.dtype
    mask_num = len(anchor_mask)
    an_num = len(anchors) // 2
    input_size = downsample * h
    if gtscore is None:
        gtscore = torch.ones((n, b), dtype=dt, device=dev)
    label_pos, label_neg = 1.0, 0.0
    if use_label_smooth:
        delta = min(1.0 / class_num, 1.0 / 40.0)
        label_pos, label_neg = 1.0 - delta, delta

    def vec(v):
        return host_values(np.asarray(v), dt, dev)

    xr = x.reshape(n, mask_num, 5 + class_num, h, w)
    aw = vec([anchors[2 * i] for i in range(an_num)])
    ah = vec([anchors[2 * i + 1] for i in range(an_num)])
    maw = vec([anchors[2 * m] for m in anchor_mask])
    mah = vec([anchors[2 * m + 1] for m in anchor_mask])
    cols = torch.arange(w, dtype=dt, device=dev)[None, None, None, :]
    rows = torch.arange(h, dtype=dt, device=dev)[None, None, :, None]
    px = (cols + torch.sigmoid(xr[:, :, 0]) * scale_xy + bias_xy) / h
    py = (rows + torch.sigmoid(xr[:, :, 1]) * scale_xy + bias_xy) / h
    pw_ = torch.exp(xr[:, :, 2]) * maw[None, :, None, None] / input_size
    ph_ = torch.exp(xr[:, :, 3]) * mah[None, :, None, None] / input_size
    gt_valid = (gtbox[:, :, 2] > 1e-6) & (gtbox[:, :, 3] > 1e-6)

    g = gtbox[:, None, None, None]
    iou = _iou_cwh(px[..., None], py[..., None], pw_[..., None],
                   ph_[..., None], g[..., 0], g[..., 1], g[..., 2],
                   g[..., 3])
    iou = torch.where(gt_valid[:, None, None, None, :], iou,
                      torch.zeros_like(iou))
    best_iou = torch.amax(iou, dim=-1).detach()        # (N, mask, H, W)
    obj_mask = torch.where(best_iou > ignore_thresh,
                           torch.full_like(best_iou, -1.0),
                           torch.zeros_like(best_iou))

    loss = torch.zeros((n,), dtype=dt, device=dev)
    match_mask = torch.full((n, b), -1, dtype=torch.int32, device=dev)
    lookup = [-1] * an_num
    for mi, m in enumerate(anchor_mask):
        lookup[m] = mi
    mask_lookup = host_values(np.asarray(lookup, np.int64), torch.int64, dev)
    narange = torch.arange(n, device=dev)
    cls_ids = torch.arange(class_num, device=dev)[None, :]
    for t in range(b):
        gx, gy = gtbox[:, t, 0], gtbox[:, t, 1]
        gw, gh = gtbox[:, t, 2], gtbox[:, t, 3]
        valid = gt_valid[:, t]
        score = gtscore[:, t]
        zero = torch.zeros((), dtype=dt, device=dev)
        a_iou = _iou_cwh(zero, zero, gw[:, None], gh[:, None], zero, zero,
                         (aw / input_size)[None, :],
                         (ah / input_size)[None, :])
        best_n = torch.argmax(a_iou, dim=1)
        mask_idx = mask_lookup[best_n]
        matched = valid & (mask_idx >= 0)
        mi_c = torch.clamp_min(mask_idx, 0)
        gi = torch.clamp((gx * w).to(torch.int64), 0, w - 1)
        gj = torch.clamp((gy * h).to(torch.int64), 0, h - 1)
        sel = xr[narange, mi_c, :, gj, gi]               # (N, 5 + cls)
        tx = gx * w - gi
        ty = gy * h - gj
        tw = torch.log(torch.clamp_min(gw, 1e-9) * input_size / aw[best_n])
        th = torch.log(torch.clamp_min(gh, 1e-9) * input_size / ah[best_n])
        sc = (2.0 - gw * gh) * score
        loc = (_sce(sel[:, 0], tx) + _sce(sel[:, 1], ty)
               + absolute(sel[:, 2] - tw) + absolute(sel[:, 3] - th)) * sc
        tgt = torch.where(cls_ids == gtlabel[:, t, None],
                          torch.full((), label_pos, dtype=dt, device=dev),
                          torch.full((), label_neg, dtype=dt, device=dev))
        cls = _sce(sel[:, 5:], tgt).sum(dim=1) * score
        loss = loss + torch.where(matched, loc + cls, zero)
        old = obj_mask[narange, mi_c, gj, gi]
        obj_mask = obj_mask.index_put(
            (narange, mi_c, gj, gi), torch.where(matched, score.detach(),
                                                 old))
        match_mask[:, t] = torch.where(valid, mask_idx.to(torch.int32),
                                       torch.full_like(match_mask[:, t],
                                                       -1))
    obj_logit = xr[:, :, 4]
    pos_l = torch.where(obj_mask > 1e-5, _sce(obj_logit, 1.0) * obj_mask,
                        torch.zeros_like(obj_logit))
    neu_l = torch.where((obj_mask <= 1e-5) & (obj_mask > -0.5),
                        _sce(obj_logit, 0.0), torch.zeros_like(obj_logit))
    loss = loss + (pos_l + neu_l).sum(dim=(1, 2, 3))
    return {"Loss": [loss], "ObjectnessMask": [obj_mask],
            "GTMatchMask": [match_mask]}


@register("density_prior_box", not_differentiable=True)
def _density_prior_box(ctx, ins, attrs):
    """Densified SSD priors: per fixed size s with density d, a d x d grid
    of shifted centers in each step cell, crossed with fixed_ratios."""
    feat, img = ins["Input"][0], ins["Image"][0]
    fixed_sizes = [float(v) for v in attrs.get("fixed_sizes", [])]
    fixed_ratios = [float(v) for v in attrs.get("fixed_ratios", [])]
    densities = [int(v) for v in attrs.get("densities", [])]
    clip = bool(attrs.get("clip", False))
    offset = float(attrs.get("offset", 0.5))
    img_h, img_w = img.shape[2], img.shape[3]
    fh, fw = feat.shape[2], feat.shape[3]
    step_w = float(attrs.get("step_w", 0.0)) or img_w / fw
    step_h = float(attrs.get("step_h", 0.0)) or img_h / fh
    step_avg = int(0.5 * (step_w + step_h))
    dev = feat.device
    cx = (torch.arange(fw, device=dev) + offset) * step_w
    cy = (torch.arange(fh, device=dev) + offset) * step_h
    cxg = cx[None, :].expand(fh, fw)
    cyg = cy[:, None].expand(fh, fw)
    boxes = []
    for s, density in zip(fixed_sizes, densities):
        shift = step_avg // density
        for r in fixed_ratios:
            bw = s * float(np.sqrt(r))
            bh = s / float(np.sqrt(r))
            d0x = cxg - step_avg / 2.0 + shift / 2.0
            d0y = cyg - step_avg / 2.0 + shift / 2.0
            for di in range(density):
                for dj in range(density):
                    ccx = d0x + dj * shift
                    ccy = d0y + di * shift
                    boxes.append(torch.stack([
                        (ccx - bw / 2.0) / img_w, (ccy - bh / 2.0) / img_h,
                        (ccx + bw / 2.0) / img_w, (ccy + bh / 2.0) / img_h,
                    ], dim=-1))
    out = torch.stack(boxes, dim=2).to(torch.float32)   # (H, W, P, 4)
    if clip:
        out = torch.clamp(out, 0.0, 1.0)
    var = _f32(attrs.get("variances", [0.1, 0.1, 0.2, 0.2]),
               dev).expand(out.shape)
    if attrs.get("flatten_to_2d", False):
        out = out.reshape(-1, 4)
        var = var.reshape(-1, 4)
    return {"Boxes": [out], "Variances": [var]}


@register("matrix_nms", not_differentiable=True)
def _matrix_nms(ctx, ins, attrs):
    """Matrix NMS (SOLOv2): soft suppression by decay = min over
    higher-ranked j of f(iou_ij) / f(iou_max_j), over the ``nms_top_k``
    best of each class (all M with -1). Fixed-capacity output."""
    bboxes = ins["BBoxes"][0]       # (N, M, 4)
    scores = ins["Scores"][0]       # (N, C, M)
    score_thresh = float(attrs.get("score_threshold", 0.0))
    post_thresh = float(attrs.get("post_threshold", 0.0))
    nms_top_k = int(attrs.get("nms_top_k", -1))
    keep_top_k = int(attrs.get("keep_top_k", -1))
    background = int(attrs.get("background_label", 0))
    use_gaussian = bool(attrs.get("use_gaussian", False))
    sigma = float(attrs.get("gaussian_sigma", 2.0))
    normalized = bool(attrs.get("normalized", True))
    n, c, m = scores.shape
    dev = scores.device
    pre = m if nms_top_k <= 0 else min(nms_top_k, m)
    jmask = (torch.arange(pre, device=dev)[:, None]
             > torch.arange(pre, device=dev)[None, :])

    def one_class(sc):
        sc = torch.where(sc > score_thresh, sc, torch.zeros_like(sc))
        order = torch.sort(-sc, dim=-1, stable=True).indices[:, :pre]
        s = torch.gather(sc, 1, order)
        b = torch.gather(bboxes, 1, order[..., None].expand(n, pre, 4))
        iou = _iou_matrix(b, b, normalized)
        tri = torch.tril(iou, diagonal=-1)
        iou_max = torch.amax(tri, dim=2)
        if use_gaussian:
            decay_ij = torch.exp((iou_max[:, None, :] ** 2 - tri ** 2)
                                 * sigma)
        else:
            decay_ij = (1.0 - tri) / torch.clamp_min(
                1.0 - iou_max[:, None, :], 1e-10)
        decay = torch.amin(torch.where(jmask, decay_ij,
                                       torch.full_like(decay_ij,
                                                       float("inf"))), 2)
        decay = torch.where(torch.isfinite(decay), decay,
                            torch.ones_like(decay))
        ds = torch.clamp_max(decay, 1.0) * s
        return torch.where(ds > post_thresh, ds, torch.zeros_like(ds)), order

    parts = [(ci, *one_class(scores[:, ci])) for ci in range(c)
             if ci != background]
    all_cls = torch.cat([torch.full(ds.shape, float(ci), device=dev)
                         for ci, ds, _ in parts], dim=1)
    all_ds = torch.cat([ds for _, ds, _ in parts], dim=1)
    all_ord = torch.cat([o for _, _, o in parts], dim=1)
    keep = all_ds.shape[1] if keep_top_k <= 0 else min(keep_top_k,
                                                       all_ds.shape[1])
    top = torch.sort(-all_ds, dim=1, stable=True).indices[:, :keep]
    sel_ds = torch.gather(all_ds, 1, top)
    sel_cls = torch.gather(all_cls, 1, top)
    sel_ord = torch.gather(all_ord, 1, top)
    sel_box = torch.gather(bboxes, 1, sel_ord[..., None].expand(n, keep, 4))
    live = sel_ds > 0
    out = torch.cat([torch.where(live, sel_cls,
                                 torch.full_like(sel_cls, -1.0))[..., None],
                     sel_ds[..., None], sel_box], dim=-1)
    return {"Out": [out.reshape(-1, 6)],
            "Index": [(sel_ord + torch.arange(n, device=dev)[:, None] * m)
                      .reshape(-1, 1).to(torch.int32)],
            "RoisNum": [live.sum(1).to(torch.int32)]}


def _tri_integral(t):
    """The antiderivative of the triangle kernel max(0, 1 - |s|) from -1
    to ``t``, clamped to [0, 1]."""
    t = torch.clamp(t, -1.0, 1.0)
    return torch.where(t < 0, 0.5 * torch.square(t + 1.0),
                       0.5 + t - 0.5 * torch.square(t))


@register("prroi_pool", no_grad_slots=("ROIs", "BatchRoINums"))
def _prroi_pool(ctx, ins, attrs):
    """Precise RoI pooling: the exact integral of the bilinearly
    interpolated feature over each bin, by the separable closed form
    (per-pixel weight = the triangle kernel's integral over the bin in x
    times the same in y, over the bin's area)."""
    x = ins["X"][0]
    rois = ins["ROIs"][0]
    ph = int(attrs.get("pooled_height", 1))
    pw = int(attrs.get("pooled_width", 1))
    scale = float(attrs.get("spatial_scale", 1.0))
    n, c, h, w = x.shape
    r = rois.shape[0]
    dev, dt = x.device, x.dtype
    bi = _rois_batch_idx(ins.get("BatchRoINums", [None])[0], r, dev)
    ys = torch.arange(h, dtype=dt, device=dev)
    xs = torch.arange(w, dtype=dt, device=dev)
    x1, y1 = rois[:, 0] * scale, rois[:, 1] * scale
    x2, y2 = rois[:, 2] * scale, rois[:, 3] * scale
    bw = torch.clamp_min((x2 - x1) / pw, 1e-6)[:, None, None]
    bh = torch.clamp_min((y2 - y1) / ph, 1e-6)[:, None, None]
    ax = x1[:, None, None] + torch.arange(pw, dtype=dt,
                                          device=dev)[None, :, None] * bw
    ay = y1[:, None, None] + torch.arange(ph, dtype=dt,
                                          device=dev)[None, :, None] * bh
    wx = (_tri_integral(ax + bw - xs) - _tri_integral(ax - xs))  # R,pw,W
    wy = (_tri_integral(ay + bh - ys) - _tri_integral(ay - ys))  # R,ph,H
    val = torch.einsum("rchw,rih,rjw->rcij", x[bi], wy, wx)
    return {"Out": [val / (bw * bh)[:, None]]}
