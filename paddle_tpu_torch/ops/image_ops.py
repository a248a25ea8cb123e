"""Image and spatial op lowerings — the counterpart of
``paddle_tpu/ops/image_ops.py``: the N-d interpolations (``linear_interp``,
``trilinear_interp``, ``bicubic_interp`` and their v2 forms),
``affine_grid``, ``grid_sampler``, ``affine_channel``, ``pixel_shuffle``,
``space_to_depth``, ``shuffle_channel``, ``temporal_shift``, ``lrn``,
``crop``, ``crop_tensor``, ``pad_constant_like``, ``unfold``,
``max_pool2d_with_index``, ``max_pool3d_with_index`` and ``unpool``.

The interpolations are the reference's ``jax.image.resize``, not
``F.interpolate``: :func:`resize` builds JAX's per-axis weight matrices
(half-pixel centres, a triangle filter widened when it downsamples,
Keys' cubic with a = -0.5 also widened, nearest by ``floor((i + 0.5) *
in / out)``) and contracts each resized axis with its matrix. Patch
extraction (unfold, pool with index) stacks static strided slices, as
the reference does. Max reductions are ``amax``, which shares the
gradient among tied maxima as JAX's ``max`` does.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .registry import register


# ---------------------------------------------------------------------------
# jax.image.resize
# ---------------------------------------------------------------------------

_F32_EPS = float(np.finfo(np.float32).eps)


def _triangle(x):
    return torch.clamp_min(1.0 - torch.abs(x), 0.0)


def _keys_cubic(x):
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


_KERNELS = {"linear": _triangle, "cubic": _keys_cubic}


def _weight_mat(m, n, kernel, dtype, device):
    """``jax.image``'s ``compute_weight_mat`` for an axis of ``m`` inputs
    resized to ``n`` (translation 0, antialiasing on): ``[m, n]``,
    computed in float64 and cast to ``dtype``."""
    scale = n / m
    inv = 1.0 / scale
    kscale = max(inv, 1.0)
    f64 = dict(dtype=torch.float64, device=device)
    sample_f = (torch.arange(n, **f64) + 0.5) * inv - 0.5
    x = torch.abs(sample_f[None, :] - torch.arange(m, **f64)[:, None]) / kscale
    w = kernel(x)
    tot = w.sum(0, keepdim=True)
    w = torch.where(torch.abs(tot) > 1000.0 * _F32_EPS,
                    w / torch.where(tot != 0, tot, torch.ones_like(tot)),
                    torch.zeros_like(w))
    inside = (sample_f >= -0.5) & (sample_f <= m - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w)).to(dtype)


def resize(x: torch.Tensor, shape, method: str) -> torch.Tensor:
    """``jax.image.resize(x, shape, method)`` for ``method`` "nearest",
    "linear" or "cubic" (antialiasing on, as its default)."""
    shape = tuple(int(s) for s in shape)
    dims = [d for d in range(x.ndim) if x.shape[d] != shape[d]]
    if method == "nearest":
        for d in dims:
            m, n = x.shape[d], shape[d]
            off = (torch.arange(n, dtype=torch.float32, device=x.device)
                   + 0.5) * m / n
            x = x.index_select(d, torch.floor(off).to(torch.int64))
        return x
    kernel = _KERNELS[method]
    for d in dims:
        w = _weight_mat(x.shape[d], shape[d], kernel, x.dtype, x.device)
        x = torch.movedim(torch.movedim(x, d, -1) @ w, -1, d)
    return x


def _interp_nd(name, method, spatial):
    @register(name)
    def _lower(ctx, ins, attrs, _m=method, _nd=spatial):
        x = ins["X"][0]  # NC + spatial
        keys = ["out_d", "out_h", "out_w"][-_nd:]
        sizes = [int(attrs.get(k, -1) or -1) for k in keys]
        scale = attrs.get("scale", 0.0)
        for i in range(_nd):
            if sizes[i] <= 0:
                if not scale:
                    raise ValueError(f"{name}: need out sizes or scale")
                sizes[i] = int(x.shape[2 + i] * scale)
        return {"Out": [resize(x, tuple(x.shape[:2]) + tuple(sizes), _m)]}
    return _lower


_interp_nd("linear_interp", "linear", 1)
_interp_nd("linear_interp_v2", "linear", 1)
_interp_nd("trilinear_interp", "linear", 3)
_interp_nd("trilinear_interp_v2", "linear", 3)
_interp_nd("bicubic_interp", "cubic", 2)


# ---------------------------------------------------------------------------
# grid sampling
# ---------------------------------------------------------------------------


def _host_ints(v):
    """A shape or offsets given as a tensor: its values on the host (they
    fix the output's shape, as in the reference)."""
    return [int(i) for i in torch.as_tensor(v).reshape(-1).tolist()]


@register("affine_grid")
def _affine_grid(ctx, ins, attrs):
    theta = ins["Theta"][0]
    if ins.get("OutputShape", [None])[0] is not None:
        oshape = _host_ints(ins["OutputShape"][0])
    else:
        oshape = [int(v) for v in attrs.get("output_shape")]
    n, _, h, w = oshape
    align = bool(attrs.get("align_corners", True))

    def _axis(size):
        kw = dict(dtype=theta.dtype, device=theta.device)
        if align:
            return torch.linspace(-1.0, 1.0, size, **kw)
        step = 2.0 / size
        return torch.linspace(-1.0 + step / 2, 1.0 - step / 2, size, **kw)

    xs = _axis(w)[None, :].expand(h, w)
    ys = _axis(h)[:, None].expand(h, w)
    base = torch.stack([xs, ys, torch.ones_like(xs)], dim=-1)  # (H, W, 3)
    return {"Output": [torch.einsum("hwj,nkj->nhwk", base, theta)]}


def _gather_hw(x, iy, ix):
    """``x[n, :, iy, ix]`` with zeros out of range; ``iy``/``ix``
    ``(N, ...)`` integer tensors -> ``(N, C, ...)``."""
    n, c, h, w = x.shape
    valid = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
    idx = (torch.clamp(iy, 0, h - 1) * w + torch.clamp(ix, 0, w - 1))
    idx = idx.reshape(n, 1, -1).expand(n, c, -1)
    got = torch.gather(x.reshape(n, c, h * w), 2, idx)
    got = got.reshape((n, c) + tuple(ix.shape[1:]))
    return got * valid[:, None].to(x.dtype)


@register("grid_sampler", no_grad_slots=())
def _grid_sampler(ctx, ins, attrs):
    x = ins["X"][0]
    grid = ins["Grid"][0]
    align = bool(attrs.get("align_corners", True))
    mode = attrs.get("mode", "bilinear")
    pad = attrs.get("padding_mode", "zeros")
    n, c, h, w = x.shape
    gx, gy = grid[..., 0], grid[..., 1]

    def _unnorm(g, size):
        if align:
            return (g + 1.0) / 2.0 * (size - 1)
        return ((g + 1.0) * size - 1.0) / 2.0

    fx = _unnorm(gx, w)
    fy = _unnorm(gy, h)

    def _reflect(v, lo, hi):
        rng = hi - lo
        if rng <= 0:
            return torch.zeros_like(v)
        v = torch.fmod(torch.abs(v - lo), 2 * rng)
        return lo + torch.where(v > rng, 2 * rng - v, v)

    if pad == "border":
        fx = torch.clamp(fx, 0, w - 1)
        fy = torch.clamp(fy, 0, h - 1)
    elif pad == "reflection":
        if align:
            fx = _reflect(fx, 0.0, float(w - 1))
            fy = _reflect(fy, 0.0, float(h - 1))
        else:
            fx = torch.clamp(_reflect(fx, -0.5, w - 0.5), 0, w - 1)
            fy = torch.clamp(_reflect(fy, -0.5, h - 0.5), 0, h - 1)

    if mode == "nearest":
        out = _gather_hw(x, torch.round(fy).to(torch.int64),
                         torch.round(fx).to(torch.int64))
    else:
        x0 = torch.floor(fx).to(torch.int64)
        y0 = torch.floor(fy).to(torch.int64)
        x1, y1 = x0 + 1, y0 + 1
        wx = (fx - x0).to(x.dtype)[:, None]
        wy = (fy - y0).to(x.dtype)[:, None]
        out = (_gather_hw(x, y0, x0) * (1 - wx) * (1 - wy)
               + _gather_hw(x, y0, x1) * wx * (1 - wy)
               + _gather_hw(x, y1, x0) * (1 - wx) * wy
               + _gather_hw(x, y1, x1) * wx * wy)
    return {"Output": [out]}


# ---------------------------------------------------------------------------
# channel rearrangement family
# ---------------------------------------------------------------------------


@register("affine_channel")
def _affine_channel(ctx, ins, attrs):
    x = ins["X"][0]
    scale = ins["Scale"][0].reshape(-1)
    bias = ins["Bias"][0].reshape(-1)
    if attrs.get("data_layout", "NCHW") == "NHWC":
        return {"Out": [x * scale + bias]}
    shape = (1, -1) + (1,) * (x.ndim - 2)
    return {"Out": [x * scale.reshape(shape) + bias.reshape(shape)]}


@register("pixel_shuffle")
def _pixel_shuffle(ctx, ins, attrs):
    x = ins["X"][0]
    r = int(attrs.get("upscale_factor", 1))
    if attrs.get("data_format", "NCHW") == "NHWC":
        n, h, w, c = x.shape
        x = x.reshape(n, h, w, c // (r * r), r, r)
        x = x.permute(0, 1, 4, 2, 5, 3)
        out = x.reshape(n, h * r, w * r, c // (r * r))
    else:
        n, c, h, w = x.shape
        x = x.reshape(n, c // (r * r), r, r, h, w)
        x = x.permute(0, 1, 4, 2, 5, 3)
        out = x.reshape(n, c // (r * r), h * r, w * r)
    return {"Out": [out]}


@register("space_to_depth")
def _space_to_depth(ctx, ins, attrs):
    x = ins["X"][0]
    b = int(attrs.get("blocksize", 1))
    n, c, h, w = x.shape
    x = x.reshape(n, c, h // b, b, w // b, b).permute(0, 3, 5, 1, 2, 4)
    return {"Out": [x.reshape(n, c * b * b, h // b, w // b)]}


@register("shuffle_channel")
def _shuffle_channel(ctx, ins, attrs):
    x = ins["X"][0]
    g = int(attrs.get("group", 1))
    n, c, h, w = x.shape
    x = x.reshape(n, g, c // g, h, w).permute(0, 2, 1, 3, 4)
    return {"Out": [x.reshape(n, c, h, w)]}


@register("temporal_shift")
def _temporal_shift(ctx, ins, attrs):
    x = ins["X"][0]  # (N*T, C, H, W)
    t = int(attrs.get("seg_num", 1))
    ratio = attrs.get("shift_ratio", 0.25)
    nt, c, h, w = x.shape
    n = nt // t
    c1 = int(c * ratio)
    c2 = int(c * 2 * ratio)
    v = x.reshape(n, t, c, h, w)
    zeros = torch.zeros((n, 1, c, h, w), dtype=x.dtype, device=x.device)
    fwd = torch.cat([v[:, 1:], zeros], dim=1)    # t <- t+1
    bwd = torch.cat([zeros, v[:, :-1]], dim=1)   # t <- t-1
    out = torch.cat([fwd[:, :, :c1], bwd[:, :, c1:c2], v[:, :, c2:]], dim=2)
    return {"Out": [out.reshape(nt, c, h, w)]}


@register("lrn", grad_needs_outputs=("MidOut",))
def _lrn(ctx, ins, attrs):
    """mid = k + alpha * sum over a window of n channels of x^2;
    out = x * mid^-beta."""
    x = ins["X"][0]
    n_size = int(attrs.get("n", 5))
    k = attrs.get("k", 2.0)
    alpha = attrs.get("alpha", 1e-4)
    beta = attrs.get("beta", 0.75)
    half = n_size // 2
    pad = [0, 0] * (x.ndim - 2) + [half, n_size - half - 1]
    sqp = F.pad(x * x, pad)
    acc = sum(sqp[:, i:i + x.shape[1]] for i in range(n_size))
    mid = k + alpha * acc
    return {"Out": [x * torch.pow(mid, -beta)], "MidOut": [mid]}


# ---------------------------------------------------------------------------
# crop / pad
# ---------------------------------------------------------------------------


def _crop_impl(ins, attrs):
    x = ins["X"][0]
    if ins.get("Offsets", [None])[0] is not None:
        offsets = _host_ints(ins["Offsets"][0])
    else:
        offsets = [int(v) for v in attrs.get("offsets", [0] * x.ndim)]
    if ins.get("Shape", [None])[0] is not None:
        shape = _host_ints(ins["Shape"][0])
    else:
        shape = [int(v) for v in attrs.get("shape")]
    shape = [x.shape[i] - offsets[i] if s == -1 else s
             for i, s in enumerate(shape)]
    return {"Out": [x[tuple(slice(o, o + s)
                            for o, s in zip(offsets, shape))]]}


@register("crop", no_grad_slots=("Y", "Offsets"))
def _crop(ctx, ins, attrs):
    """Crop; the shape may come from a ``Y`` reference tensor."""
    if ins.get("Y", [None])[0] is not None and "shape" not in attrs:
        attrs = dict(attrs, shape=list(ins["Y"][0].shape))
    return _crop_impl(ins, attrs)


@register("crop_tensor", no_grad_slots=("Shape", "Offsets"))
def _crop_tensor(ctx, ins, attrs):
    return _crop_impl(ins, attrs)


@register("pad_constant_like", no_grad_slots=("X",))
def _pad_constant_like(ctx, ins, attrs):
    """``Y`` at the origin of an X-shaped tensor of ``pad_value``."""
    x, y = ins["X"][0], ins["Y"][0]
    pad = []
    for xs, ys in reversed(list(zip(x.shape, y.shape))):
        pad += [0, xs - ys]
    return {"Out": [F.pad(y, pad, value=float(attrs.get("pad_value", 0.0)))]}


# ---------------------------------------------------------------------------
# im2col family: unfold / pool-with-index / unpool
# ---------------------------------------------------------------------------


def _pair(v, n=2):
    if isinstance(v, (list, tuple)):
        if len(v) == n:
            return [int(i) for i in v]
        if len(v) == 2 * n:  # begin/end pairs
            return [int(i) for i in v[:n]]
        return [int(v[0])] * n
    return [int(v)] * n


def extract_patches(x, ksize, strides, paddings, dilations, pad_value=0.0):
    """(N,C,H,W) -> ((N, C, kh*kw, Ho, Wo), Ho, Wo) by static strided
    slices."""
    kh, kw = ksize
    sh, sw = strides
    ph, pw = paddings
    dh, dw = dilations
    xp = F.pad(x, [pw, pw, ph, ph], value=pad_value)
    H, W = xp.shape[2], xp.shape[3]
    ho = (H - (dh * (kh - 1) + 1)) // sh + 1
    wo = (W - (dw * (kw - 1) + 1)) // sw + 1
    cols = []
    for i in range(kh):
        for j in range(kw):
            r0, c0 = i * dh, j * dw
            cols.append(xp[:, :, r0:r0 + (ho - 1) * sh + 1:sh,
                           c0:c0 + (wo - 1) * sw + 1:sw])
    return torch.stack(cols, dim=2), ho, wo


@register("unfold")
def _unfold(ctx, ins, attrs):
    """im2col: (N,C,H,W) -> (N, C*kh*kw, Ho*Wo)."""
    x = ins["X"][0]
    k = _pair(attrs["kernel_sizes"])
    patches, ho, wo = extract_patches(
        x, k, _pair(attrs.get("strides", [1, 1])),
        _pair(attrs.get("paddings", [0, 0])),
        _pair(attrs.get("dilations", [1, 1])))
    n, c = x.shape[:2]
    return {"Y": [patches.reshape(n, c * k[0] * k[1], ho * wo)]}


def _arange(n, x, shape):
    return torch.arange(n, device=x.device).reshape(shape)


@register("max_pool2d_with_index", nondiff_outputs=("Mask",))
def _max_pool2d_with_index(ctx, ins, attrs):
    """Max pool and each window's flat argmax in its plane (h * W + w),
    which ``unpool`` reads."""
    x = ins["X"][0]
    k = _pair(attrs["ksize"])
    s = _pair(attrs.get("strides", [1, 1]))
    p = _pair(attrs.get("paddings", [0, 0]))
    n, c, h, w = x.shape
    if attrs.get("global_pooling", False):
        k, p = [h, w], [0, 0]
    if attrs.get("adaptive", False):
        oh, ow = k
        k = [h // oh, w // ow]
        s = list(k)
        p = [0, 0]
    neg = float(torch.finfo(x.dtype).min)
    patches, ho, wo = extract_patches(x, k, s, p, [1, 1], pad_value=neg)
    amax = torch.argmax(patches, dim=2)            # (N,C,Ho,Wo)
    out = torch.amax(patches, dim=2)
    hi = _arange(ho, x, (1, 1, -1, 1)) * s[0] + amax // k[1] - p[0]
    wi = _arange(wo, x, (1, 1, 1, -1)) * s[1] + amax % k[1] - p[1]
    return {"Out": [out], "Mask": [(hi * w + wi).to(torch.int32)]}


@register("max_pool3d_with_index", nondiff_outputs=("Mask",))
def _max_pool3d_with_index(ctx, ins, attrs):
    x = ins["X"][0]  # (N,C,D,H,W)
    k = _pair(attrs["ksize"], 3)
    s = _pair(attrs.get("strides", [1, 1, 1]), 3)
    p = _pair(attrs.get("paddings", [0, 0, 0]), 3)
    n, c, d, h, w = x.shape
    if attrs.get("global_pooling", False):
        k, p = [d, h, w], [0, 0, 0]
    neg = float(torch.finfo(x.dtype).min)
    xp = F.pad(x, [p[2], p[2], p[1], p[1], p[0], p[0]], value=neg)
    do = (xp.shape[2] - k[0]) // s[0] + 1
    ho = (xp.shape[3] - k[1]) // s[1] + 1
    wo = (xp.shape[4] - k[2]) // s[2] + 1
    cols = []
    for a in range(k[0]):
        for b in range(k[1]):
            for e in range(k[2]):
                cols.append(xp[:, :, a:a + (do - 1) * s[0] + 1:s[0],
                               b:b + (ho - 1) * s[1] + 1:s[1],
                               e:e + (wo - 1) * s[2] + 1:s[2]])
    patches = torch.stack(cols, dim=2)
    amax = torch.argmax(patches, dim=2)
    out = torch.amax(patches, dim=2)
    di = _arange(do, x, (1, 1, -1, 1, 1)) * s[0] + amax // (k[1] * k[2]) \
        - p[0]
    hi = _arange(ho, x, (1, 1, 1, -1, 1)) * s[1] + (amax // k[2]) % k[1] \
        - p[1]
    wi = _arange(wo, x, (1, 1, 1, 1, -1)) * s[2] + amax % k[2] - p[2]
    return {"Out": [out], "Mask": [((di * h + hi) * w + wi).to(torch.int32)]}


@register("unpool", no_grad_slots=("Indices",))
def _unpool(ctx, ins, attrs):
    """Max unpooling: ``X`` added into zeros at the per-plane flat
    ``Indices`` of ``max_pool2d_with_index``."""
    x = ins["X"][0]
    idx = ins["Indices"][0].to(torch.int64)
    k = _pair(attrs.get("ksize", [2, 2]))
    s = _pair(attrs.get("strides", [1, 1]))
    p = _pair(attrs.get("paddings", [0, 0]))
    n, c, h, w = x.shape
    ho = (h - 1) * s[0] - 2 * p[0] + k[0]
    wo = (w - 1) * s[1] - 2 * p[1] + k[1]
    flat = torch.zeros((n, c, ho * wo), dtype=x.dtype, device=x.device)
    out = flat.scatter_add(2, idx.reshape(n, c, -1), x.reshape(n, c, -1))
    return {"Out": [out.reshape(n, c, ho, wo)]}
