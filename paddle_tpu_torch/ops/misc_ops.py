"""Miscellaneous op lowerings — the counterpart of
``paddle_tpu/ops/misc_ops.py``: ``allclose``, ``diag``, ``diag_v2``,
``diag_embed``, ``histogram``, ``is_empty``, ``maxout``, ``mean_iou``,
``pool3d``, ``modified_huber_loss``, ``add_position_encoding``,
``bilinear_tensor_product``, ``fill``, ``fill_constant_batch_size_like``,
``fill_zeros_like2``, ``uniform_random_batch_size_like`` and
``gaussian_random_batch_size_like`` (the reference's streams, as
``uniform_random`` / ``gaussian_random`` draw them), ``sampling_id``,
``seed``, ``sequence_reshape``, ``sequence_scatter``, ``spectral_norm``
(its power iteration outside the gradient), ``teacher_student_sigmoid_loss``,
``edit_distance``, ``ctc_align``, ``hierarchical_sigmoid``,
``polygon_box_transform``, ``bipartite_match`` (the reference's scan as a
loop of ``min(rows, cols)`` greedy steps on the device), ``target_assign``,
``fc``, ``shard_index``, ``multiclass_nms2`` (``multiclass_nms`` with its
``Index``), ``random_crop`` and ``precision_recall``.

The random ops (``sampling_id``, ``random_crop``) draw JAX's streams from
the op's key (:mod:`~paddle_tpu_torch.prng`); ``random_crop`` slices at
its drawn offsets by an index on the device, so nothing is read back to
the host. ``edit_distance`` and ``ctc_align`` keep the reference's static
shapes: the Levenshtein table is a loop over both lengths' bounds with
every row of the batch at once, and the alignment is written to the
front of a ``[B, T]`` buffer with its lengths beside it, so a captured
step holds both.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .. import prng
from .math_ops import absolute
from .registry import np_dtype, register


@register("allclose", not_differentiable=True)
def _allclose(ctx, ins, attrs):
    x, y = ins["Input"][0], ins["Other"][0]
    return {"Out": [torch.isclose(
        x, y, rtol=float(attrs.get("rtol", 1e-5)),
        atol=float(attrs.get("atol", 1e-8)),
        equal_nan=bool(attrs.get("equal_nan", False))).all()]}


@register("diag", not_differentiable=True)
def _diag_v1(ctx, ins, attrs):
    """Vector -> diagonal matrix."""
    return {"Out": [torch.diag(ins["Diagonal"][0])]}


@register("diag_v2")
def _diag_v2(ctx, ins, attrs):
    """1-D -> matrix, 2-D -> its diagonal, at ``offset``."""
    x = ins["X"][0]
    offset = int(attrs.get("offset", 0))
    pad = attrs.get("padding_value", 0.0)
    out = torch.diag(x, offset)
    if x.ndim == 1 and pad:
        n = out.shape[0]
        mask = torch.ones(n - abs(offset), dtype=torch.bool,
                          device=x.device).diag(offset)
        out = torch.where(mask, out, torch.full_like(out, pad))
    return {"Out": [out]}


@register("diag_embed")
def _diag_embed(ctx, ins, attrs):
    x = ins["Input"][0]
    offset = int(attrs.get("offset", 0))
    dim1 = int(attrs.get("dim1", -2))
    dim2 = int(attrs.get("dim2", -1))
    size = x.shape[-1] + abs(offset)
    out = torch.zeros(tuple(x.shape[:-1]) + (size, size), dtype=x.dtype,
                      device=x.device)
    idx = torch.arange(x.shape[-1], device=x.device)
    out[..., idx + max(-offset, 0), idx + max(offset, 0)] = x
    nd = out.ndim
    d1, d2 = dim1 % nd, dim2 % nd
    if (d1, d2) != (nd - 2, nd - 1):
        rest = iter(i for i in range(nd) if i not in (nd - 2, nd - 1))
        full = [nd - 2 if i == d1 else nd - 1 if i == d2 else next(rest)
                for i in range(nd)]
        out = out.permute(full)
    return {"Out": [out]}


@register("histogram", not_differentiable=True)
def _histogram(ctx, ins, attrs):
    """``jnp.histogram``: ``bins + 1`` edges from ``jnp.linspace``'s
    arithmetic, a value's bin by a right-sided search, the last edge
    inside the last bin, values outside the range dropped."""
    x = ins["X"][0].reshape(-1)
    if not x.is_floating_point():
        x = x.to(torch.float32)
    bins = int(attrs.get("bins", 100))
    lo, hi = attrs.get("min", 0), attrs.get("max", 0)
    if lo == hi == 0:
        lo, hi = torch.amin(x), torch.amax(x)
    else:
        lo = torch.full((), float(lo), dtype=x.dtype, device=x.device)
        hi = torch.full((), float(hi), dtype=x.dtype, device=x.device)
    flat = hi == lo
    lo, hi = torch.where(flat, lo - 0.5, lo), torch.where(flat, hi + 0.5, hi)
    step = (torch.arange(bins, dtype=x.dtype, device=x.device)
            / float(bins))
    edges = torch.cat([lo * (1 - step) + hi * step, hi[None]])
    idx = torch.searchsorted(edges, x, right=True)
    idx = torch.where(x == edges[-1], torch.full_like(idx, bins), idx)
    counts = torch.zeros(bins + 2, dtype=x.dtype, device=x.device)
    counts = counts.scatter_add(0, idx, torch.ones_like(x))
    return {"Out": [counts[1:bins + 1].to(torch.int64)]}


@register("is_empty", not_differentiable=True)
def _is_empty(ctx, ins, attrs):
    x = ins["X"][0]
    return {"Out": [torch.full((), x.numel() == 0, dtype=torch.bool,
                               device=x.device)]}


@register("maxout")
def _maxout(ctx, ins, attrs):
    """Max over channel groups."""
    x = ins["X"][0]
    g = int(attrs.get("groups", 1))
    axis = int(attrs.get("axis", 1))
    shape = list(x.shape)
    shape[axis:axis + 1] = [x.shape[axis] // g, g]
    return {"Out": [torch.amax(x.reshape(shape), dim=axis + 1)]}


@register("mean_iou", not_differentiable=True)
def _mean_iou(ctx, ins, attrs):
    """Streaming mean IoU from the confusion counts."""
    pred = ins["Predictions"][0].reshape(-1).to(torch.int64)
    label = ins["Labels"][0].reshape(-1).to(torch.int64)
    k = int(attrs["num_classes"])
    valid = (label >= 0) & (label < k)
    safe_l = torch.where(valid, label, torch.zeros_like(label))
    safe_p = torch.where(valid, pred, torch.zeros_like(pred))
    ones = valid.to(torch.int32)
    zeros = torch.zeros(k, dtype=torch.int32, device=pred.device)
    inter = zeros.scatter_add(0, safe_l, ones * (safe_l == safe_p))
    pred_c = zeros.scatter_add(0, safe_p, ones)
    lab_c = zeros.scatter_add(0, safe_l, ones)
    wrong = pred_c + lab_c - 2 * inter
    for extra in ins.get("InWrongs", []):
        wrong = wrong + extra
    correct = inter
    for extra in ins.get("InCorrects", []):
        correct = correct + extra
    union = wrong + correct
    present = union > 0
    iou = torch.where(present, correct / torch.clamp_min(union, 1),
                      torch.zeros((), dtype=torch.float32,
                                  device=pred.device))
    miou = iou.sum() / torch.clamp_min(present.sum(), 1)
    for extra in ins.get("InMeanIou", []):
        miou = miou + extra
    return {"OutMeanIou": [miou.to(torch.float32)],
            "OutWrong": [wrong], "OutCorrect": [correct]}


@register("pool3d")
def _pool3d(ctx, ins, attrs):
    """3-D pooling (NCDHW)."""
    from .nn_ops import _conv_padding
    x = ins["X"][0]
    ptype = attrs.get("pooling_type", "max")
    ksize = [int(k) for k in attrs.get("ksize", [2, 2, 2])]
    strides = [int(s) for s in attrs.get("strides", ksize)]
    paddings = attrs.get("paddings", [0, 0, 0])
    if attrs.get("global_pooling", False):
        ksize = [int(s) for s in x.shape[2:]]
        strides, paddings = ksize, [0, 0, 0]
    pad = []
    for lo, hi in reversed(_conv_padding(paddings, 3)):
        pad += [lo, hi]
    if ptype == "max":
        xp = F.pad(x, pad, value=float("-inf")) if any(pad) else x
        return {"Out": [F.max_pool3d(xp, ksize, strides)]}
    xp = F.pad(x, pad) if any(pad) else x
    summed = F.avg_pool3d(xp, ksize, strides, divisor_override=1)
    if attrs.get("exclusive", True):
        ones = F.pad(torch.ones_like(x), pad) if any(pad) else \
            torch.ones_like(x)
        counts = F.avg_pool3d(ones, ksize, strides, divisor_override=1)
        return {"Out": [summed / torch.clamp_min(counts, 1.0)]}
    return {"Out": [summed / float(np.prod(ksize))]}


@register("modified_huber_loss", no_grad_slots=("Y",))
def _modified_huber_loss(ctx, ins, attrs):
    """y in {0, 1} -> {-1, 1}; loss = max(0, 1 - yv)^2 if yv >= -1 else
    -4 yv."""
    x = ins["X"][0]
    y = ins["Y"][0].to(x.dtype)
    yv = (2.0 * y - 1.0) * x
    inter = torch.where(yv < -1.0, -4.0 * yv, torch.square(torch.relu(1.0 - yv)))
    return {"Out": [inter], "IntermediateVal": [yv]}


@register("add_position_encoding")
def _add_position_encoding(ctx, ins, attrs):
    """A sin (first half) / cos (second half) sinusoid added to x * alpha
    (dense (B, T, D))."""
    x = ins["X"][0]
    alpha = attrs.get("alpha", 1.0)
    beta = attrs.get("beta", 1.0)
    b, t, d = x.shape
    half = d // 2
    kw = dict(dtype=x.dtype, device=x.device)
    pos = torch.arange(t, **kw)[:, None]
    if half > 1:
        denom = torch.pow(10000.0, torch.arange(half, **kw) / max(half - 1, 1))
    else:
        denom = torch.full((1,), 10000.0, **kw)
    val = pos / denom[None, :]
    pe = torch.cat([torch.sin(val), torch.cos(val)], dim=1)
    return {"Out": [x * alpha + pe[None] * beta]}


@register("bilinear_tensor_product")
def _bilinear_tensor_product(ctx, ins, attrs):
    """out[b, k] = x[b] @ W[k] @ y[b] + bias[k]."""
    x, y, w = ins["X"][0], ins["Y"][0], ins["Weight"][0]
    out = torch.einsum("bi,kij,bj->bk", x, w, y)
    bias = ins.get("Bias", [None])[0]
    if bias is not None:
        out = out + bias.reshape(1, -1)
    return {"Out": [out]}


@register("fill", not_differentiable=True)
def _fill(ctx, ins, attrs):
    from ..framework.program import convert_dtype
    from .tensor_ops import host_values
    shape = [int(s) for s in attrs["shape"]]
    vals = np.asarray(attrs["value"], np.float64).reshape(shape)
    dt = attrs.get("dtype_str", attrs.get("dtype"))
    dt = "float32" if dt is None else convert_dtype(dt)
    return {"Out": [host_values(vals, np_dtype(dt), ctx.device)]}


@register("fill_constant_batch_size_like", not_differentiable=True)
def _fill_constant_bsl(ctx, ins, attrs):
    ref = ins["Input"][0]
    shape = [int(s) for s in attrs["shape"]]
    shape[int(attrs.get("output_dim_idx", 0))] = \
        ref.shape[int(attrs.get("input_dim_idx", 0))]
    dt = attrs.get("dtype", "float32")
    dt = dt if isinstance(dt, str) else "float32"
    return {"Out": [torch.full(shape, attrs.get("value", 0.0),
                               dtype=np_dtype(dt), device=ref.device)]}


def _bsl_shape(ins, attrs):
    shape = [int(s) for s in attrs["shape"]]
    shape[int(attrs.get("output_dim_idx", 0))] = \
        ins["Input"][0].shape[int(attrs.get("input_dim_idx", 0))]
    return shape


@register("fill_zeros_like2", not_differentiable=True)
def _fill_zeros_like2(ctx, ins, attrs):
    return {"Out": [torch.zeros_like(ins["X"][0])]}


@register("uniform_random_batch_size_like", not_differentiable=True)
def _uniform_random_bsl(ctx, ins, attrs):
    return {"Out": [prng.uniform_const(ctx.rng(), _bsl_shape(ins, attrs),
                                       attrs.get("min", -1.0),
                                       attrs.get("max", 1.0))]}


@register("gaussian_random_batch_size_like", not_differentiable=True)
def _gaussian_random_bsl(ctx, ins, attrs):
    out = prng.normal(ctx.rng(), _bsl_shape(ins, attrs))
    return {"Out": [out * attrs.get("std", 1.0) + attrs.get("mean", 0.0)]}


@register("sampling_id", not_differentiable=True)
def _sampling_id(ctx, ins, attrs):
    """An inverse-CDF draw per probability row."""
    x = ins["X"][0]
    u = prng.uniform(ctx.rng(), (x.shape[0],), attrs.get("min", 0.0),
                     attrs.get("max", 1.0)).to(x.device)
    idx = (torch.cumsum(x, dim=1) < u[:, None]).sum(dim=1)
    return {"Out": [torch.clamp(idx, 0, x.shape[1] - 1).to(torch.int64)]}


@register("seed", not_differentiable=True)
def _seed(ctx, ins, attrs):
    s = int(attrs.get("seed", 0))
    if s == 0:
        s = int(np.random.randint(1, 2 ** 31 - 1))
    return {"Out": [torch.full((1,), s, dtype=torch.int32,
                               device=ctx.device)]}


@register("sequence_reshape")
def _sequence_reshape(ctx, ins, attrs):
    """Dense: the feature dim redistributed, batch rows kept
    (B, T*D // nd, nd)."""
    x = ins["X"][0]
    return {"Out": [x.reshape(x.shape[0], -1, int(attrs["new_dim"]))]}


@register("sequence_scatter", no_grad_slots=("Ids",))
def _sequence_scatter(ctx, ins, attrs):
    """Dense: per-row scatter-add of Updates (B, L) into X (B, D) at Ids
    (B, L)."""
    x, ids, upd = ins["X"][0], ins["Ids"][0], ins["Updates"][0]
    rows = torch.arange(x.shape[0], device=x.device)[:, None]
    return {"Out": [x.index_put((rows.expand_as(ids), ids.to(torch.int64)),
                                upd, accumulate=True)]}


@register("spectral_norm", no_grad_slots=("U", "V"))
def _spectral_norm(ctx, ins, attrs):
    """weight / sigma_max by power iteration, which takes no gradient."""
    w = ins["Weight"][0]
    u = ins["U"][0].reshape(-1).detach()
    v = ins["V"][0].reshape(-1).detach()
    dim = int(attrs.get("dim", 0))
    iters = int(attrs.get("power_iters", 1))
    eps = attrs.get("eps", 1e-12)
    perm = [dim] + [i for i in range(w.ndim) if i != dim]
    mat = w.permute(perm).reshape(w.shape[dim], -1)
    frozen = mat.detach()

    def _norm(a):
        return a / (torch.linalg.vector_norm(a) + eps)

    for _ in range(iters):
        v = _norm(frozen.T @ u)
        u = _norm(frozen @ v)
    sigma = u @ mat @ v
    return {"Out": [w / sigma]}


@register("teacher_student_sigmoid_loss", no_grad_slots=("Label",))
def _teacher_student_sigmoid_loss(ctx, ins, attrs):
    """reference teacher_student_sigmoid_loss_op.h:20-58: the CTR
    distillation loss over the label code {-2, -1, [0, 1), [1, 2]}."""
    x = ins["X"][0].reshape(-1)
    lab = ins["Label"][0].reshape(-1).to(x.dtype)

    def sce(z):
        return torch.relu(x) - x * z + torch.log1p(torch.exp(-absolute(x)))

    out = torch.where(
        lab < -1.0, sce(0.0),
        torch.where(lab < 0.0, sce(1.0),
                    torch.where(lab < 1.0, sce(0.0) + sce(lab),
                                sce(1.0) + sce(lab - 1.0))))
    return {"Y": [out.reshape(ins["X"][0].shape)]}


@register("edit_distance", not_differentiable=True)
def _edit_distance(ctx, ins, attrs):
    """reference edit_distance_op.cc, dense: the Levenshtein distance of
    each (hyp, ref) pair. Hyps (B, L1) + HypsLength, Refs (B, L2) +
    RefsLength; Out (B, 1) float32, SequenceNum [B]."""
    hyp = ins["Hyps"][0].to(torch.int64)
    ref = ins["Refs"][0].to(torch.int64)
    b, l1 = hyp.shape
    l2 = ref.shape[1]
    dev = hyp.device
    hl = ins.get("HypsLength", [None])[0]
    rl = ins.get("RefsLength", [None])[0]
    hl = (torch.full((b,), l1, dtype=torch.int64, device=dev) if hl is None
          else hl.reshape(-1).long())
    rl = (torch.full((b,), l2, dtype=torch.int64, device=dev) if rl is None
          else rl.reshape(-1).long())
    big = torch.full((b,), 10 ** 6, dtype=torch.int64, device=dev)
    cols = torch.arange(l2 + 1, device=dev)[None, :]
    prev = torch.where(cols <= rl[:, None], cols.expand(b, l2 + 1),
                       big[:, None])
    for i in range(l1):
        first = torch.full((b,), i + 1, dtype=torch.int64, device=dev)
        row, left = [first], first
        for j in range(l2):
            cost = (hyp[:, i] != ref[:, j]).to(torch.int64)
            val = torch.minimum(torch.minimum(prev[:, j + 1] + 1, left + 1),
                                prev[:, j] + cost)
            left = torch.where(j < rl, val, big)
            row.append(left)
        prev = torch.where((i < hl)[:, None], torch.stack(row, dim=1), prev)
    d = torch.gather(prev, 1, rl[:, None])[:, 0].to(torch.float32)
    if bool(attrs.get("normalized", False)):
        d = d / torch.clamp_min(rl.to(d.dtype), 1.0)
    return {"Out": [d[:, None]],
            "SequenceNum": [torch.full((1,), b, dtype=torch.int64,
                                       device=dev)]}


@register("ctc_align", not_differentiable=True)
def _ctc_align(ctx, ins, attrs):
    """reference ctc_align_op.cc, dense: merge repeats, then drop blanks;
    Output (B, T) padded with ``blank``, OutputLength (B, 1)."""
    x = ins["Input"][0].to(torch.int64)
    blank = int(attrs.get("blank", 0))
    b, t = x.shape
    prev = torch.cat([torch.full_like(x[:, :1], -1), x[:, :-1]], dim=1)
    keep = x != blank
    if bool(attrs.get("merge_repeated", True)):
        keep = keep & (x != prev)
    pos = torch.cumsum(keep.to(torch.int64), dim=1) - 1
    safe_pos = torch.where(keep, pos, torch.full_like(pos, t - 1))
    out = torch.full((b, t), blank, dtype=torch.int64, device=x.device)
    # kept tokens land at the front in order; the dropped ones write the
    # blank already there into the last slot, which a kept token takes
    # only when nothing was dropped
    out = out.scatter(1, safe_pos, torch.where(keep, x, out))
    lens = keep.sum(dim=1)
    cols = torch.arange(t, device=x.device)[None, :]
    out = torch.where(cols < lens[:, None], out,
                      torch.full_like(out, blank))
    return {"Output": [out], "OutputLength": [lens.to(torch.int64)[:, None]]}


@register("hierarchical_sigmoid",
          no_grad_slots=("Label", "PathTable", "PathCode"))
def _hierarchical_sigmoid(ctx, ins, attrs):
    """The sum over a label's path of the sigmoid cross entropy between
    x . w_node and the branch bit: the complete binary tree by default,
    or a custom PathTable / PathCode."""
    x = ins["X"][0]                                # (N, D)
    w = ins["W"][0]                                # (num_nodes, D)
    label = ins["Label"][0].reshape(-1).to(torch.int64)
    bias = ins.get("Bias", [None])[0]
    num_classes = int(attrs.get("num_classes", 2))
    path_table = ins.get("PathTable", [None])[0]
    path_code = ins.get("PathCode", [None])[0]
    if path_table is None:
        # internal nodes 0..C-2; class c's leaf at heap position C-1+c;
        # the path walks its ancestors from the root down
        depth = max(int(np.ceil(np.log2(num_classes))), 1)
        cur = label + (num_classes - 1)
        nodes, codes = [], []
        for _ in range(depth):
            parent = torch.div(cur - 1, 2, rounding_mode="floor")
            nodes.append(parent)
            codes.append(cur - (2 * parent + 1))   # 0 left, 1 right
            cur = parent
        path_table = torch.stack(nodes[::-1], dim=1)
        path_code = torch.stack(codes[::-1], dim=1)
    else:
        path_table = path_table.to(torch.int64)
        path_code = path_code.to(torch.int64)
    valid = path_table >= 0
    safe = torch.clamp_min(path_table, 0)
    logits = torch.einsum("nd,npd->np", x, w[safe])
    if bias is not None:
        logits = logits + bias.reshape(-1)[safe]
    z = path_code.to(x.dtype)
    ce = torch.relu(logits) - logits * z + torch.log1p(
        torch.exp(-absolute(logits)))
    loss = torch.where(valid, ce, torch.zeros_like(ce)).sum(1, keepdim=True)
    return {"Out": [loss], "PreOut": [logits]}


@register("polygon_box_transform", not_differentiable=True)
def _polygon_box_transform(ctx, ins, attrs):
    """EAST geometry to corners: even channels 4 * w_idx - in, odd
    4 * h_idx - in."""
    x = ins["Input"][0]
    n, c, h, w = x.shape
    kw = dict(dtype=x.dtype, device=x.device)
    wi = torch.arange(w, **kw)[None, None, None, :]
    hi = torch.arange(h, **kw)[None, None, :, None]
    even = (torch.arange(c, device=x.device) % 2 == 0)[None, :, None, None]
    return {"Output": [torch.where(even, 4.0 * wi - x, 4.0 * hi - x)]}


@register("bipartite_match", not_differentiable=True)
def _bipartite_match(ctx, ins, attrs):
    """Greedy bipartite matching on a (rows = gt, cols = pred) distance
    matrix: each of ``min(rows, cols)`` steps takes the global maximum
    (the first at ties), assigns it while it is positive and masks its
    row and column; ``per_prediction`` then tops up the unmatched
    columns at or above ``dist_threshold``."""
    dist = ins["DistMat"][0]
    rows, cols = dist.shape
    thresh = attrs.get("dist_threshold", 0.5)
    dev = dist.device
    r_ids = torch.arange(rows, device=dev)
    c_ids = torch.arange(cols, device=dev)
    neg = torch.full((), -1.0, dtype=dist.dtype, device=dev)
    d = dist
    midx = torch.full((cols,), -1, dtype=torch.int32, device=dev)
    mdist = torch.zeros((cols,), dtype=dist.dtype, device=dev)
    for _ in range(min(rows, cols)):
        flat = torch.argmax(d.reshape(-1)).reshape(1)
        r, c = flat // cols, flat % cols
        best = d.reshape(-1).gather(0, flat)
        do = best > 0
        at_c = (c_ids == c) & do
        midx = torch.where(at_c, r.to(torch.int32), midx)
        mdist = torch.where(at_c, best, mdist)
        hit = ((r_ids == r)[:, None] | (c_ids == c)[None, :]) & do
        d = torch.where(hit, neg, d)
    if attrs.get("match_type", "bipartite") == "per_prediction":
        col_best = torch.amax(dist, dim=0)
        col_best_row = torch.argmax(dist, dim=0)
        top_up = (midx < 0) & (col_best >= thresh)
        midx = torch.where(top_up, col_best_row.to(torch.int32), midx)
        mdist = torch.where(top_up, col_best, mdist)
    return {"ColToRowMatchIndices": [midx[None, :]],
            "ColToRowMatchDist": [mdist[None, :]]}


@register("target_assign", not_differentiable=True)
def _target_assign(ctx, ins, attrs):
    """Per-prior targets gathered through MatchIndices; unmatched priors
    take ``mismatch_value``."""
    x = ins["X"][0]                                   # (N, M, K)
    match = ins["MatchIndices"][0].to(torch.int64)    # (N, P)
    n, p = match.shape
    rows = torch.arange(n, device=x.device)[:, None]
    out = x[rows, torch.clamp_min(match, 0)]          # (N, P, K)
    matched = (match >= 0)[:, :, None]
    out = torch.where(matched, out, torch.full_like(
        out, attrs.get("mismatch_value", 0)))
    return {"Out": [out], "OutWeight": [matched.to(torch.float32)]}


@register("fc")
def _fc(ctx, ins, attrs):
    """X flattened to 2-D at ``in_num_col_dims``, X @ W + b."""
    x = ins["Input"][0]
    w = ins["W"][0]
    ncd = int(attrs.get("in_num_col_dims", 1))
    out = x.reshape(int(np.prod(x.shape[:ncd])), -1) @ w
    bias = ins.get("Bias", [None])[0]
    if bias is not None:
        out = out + bias.reshape(1, -1)
    if attrs.get("activation_type") == "relu":
        out = torch.relu(out)
    return {"Out": [out.reshape(tuple(x.shape[:ncd]) + (w.shape[1],))]}


@register("shard_index", not_differentiable=True)
def _shard_index(ctx, ins, attrs):
    x = ins["X"][0]
    nshards = int(attrs["nshards"])
    size = (int(attrs["index_num"]) + nshards - 1) // nshards
    mine = torch.div(x, size, rounding_mode="floor") == int(attrs["shard_id"])
    ignore = torch.full_like(x, int(attrs.get("ignore_value", -1)))
    return {"Out": [torch.where(mine, torch.remainder(x, size), ignore)]}


@register("multiclass_nms2", not_differentiable=True)
def _multiclass_nms2(ctx, ins, attrs):
    """``multiclass_nms`` with ``Index``: each kept detection's index
    into the input boxes, flat across the batch, -1 on padding rows."""
    from .registry import OPS
    return OPS["multiclass_nms"].lowering(
        ctx, ins, dict(attrs, __want_index__=True))


@register("random_crop", no_grad_slots=("Seed",))
def _random_crop(ctx, ins, attrs):
    """The trailing dims cropped to ``shape`` at offsets drawn from the
    op's key (one split key per dim, ``jax.random.randint``), taken by an
    index on the device; SeedOut passes Seed through."""
    x = ins["X"][0]
    shape = [int(s) for s in attrs["shape"]]
    lead = x.ndim - len(shape)
    keys = prng.split(ctx.rng(), len(shape))
    for i, size in enumerate(shape):
        lim = x.shape[lead + i] - size
        if lim <= 0:
            x = x.narrow(lead + i, 0, size)
            continue
        off = prng.randint(keys[i], (), 0, lim + 1).to(x.device)
        idx = off + torch.arange(size, device=x.device)
        x = x.index_select(lead + i, idx)
    seed = ins.get("Seed", [None])[0]
    if seed is None:
        seed = torch.zeros((1,), dtype=torch.int64, device=x.device)
    return {"Out": [x], "SeedOut": [seed]}


@register("precision_recall", not_differentiable=True)
def _precision_recall(ctx, ins, attrs):
    """Streaming multi-class precision / recall / F1 from per-class
    TP / FP / TN / FN state."""
    idx = ins["Indices"][0].reshape(-1).to(torch.int64)
    label = ins["Labels"][0].reshape(-1).to(torch.int64)
    weights = ins.get("Weights", [None])[0]
    states = ins.get("StatesInfo", [None])[0]
    c = int(attrs["class_number"])
    f32 = dict(dtype=torch.float32, device=idx.device)
    w = (torch.ones(idx.shape, **f32) if weights is None
         else weights.reshape(-1).to(torch.float32))
    correct = (idx == label).to(torch.float32)
    zeros = torch.zeros(c, **f32)
    tp = zeros.scatter_add(0, label, w * correct)
    fn = zeros.scatter_add(0, label, w * (1 - correct))
    fp = zeros.scatter_add(0, idx, w * (1 - correct))
    tn = w.sum() - tp - fn - fp

    def ratio(a, b):
        return torch.where(b > 0, a / torch.clamp_min(b, 1e-12),
                           torch.zeros_like(a))

    def metrics(tp_, fp_, tn_, fn_):
        prec = ratio(tp_, tp_ + fp_)
        rec = ratio(tp_, tp_ + fn_)
        f1 = ratio(2 * prec * rec, prec + rec)
        macro = torch.stack([prec.mean(), rec.mean(), f1.mean()])
        stp, sfp, sfn = tp_.sum(), fp_.sum(), fn_.sum()
        mp = ratio(stp, stp + sfp)
        mr = ratio(stp, stp + sfn)
        mf = ratio(2 * mp * mr, mp + mr)
        return torch.cat([macro, torch.stack([mp, mr, mf])])

    batch = metrics(tp, fp, tn, fn)
    if states is not None:
        tp = tp + states[:, 0]
        fp = fp + states[:, 1]
        tn = tn + states[:, 2]
        fn = fn + states[:, 3]
    return {"BatchMetrics": [batch], "AccumMetrics": [metrics(tp, fp, tn, fn)],
            "AccumStatesInfo": [torch.stack([tp, fp, tn, fn], dim=1)]}
