"""Paged attention over the block-paged KV pool: the counterpart of
``paddle_tpu/ops/pallas/paged_attention.py``.

:func:`paged_attention` launches the hand-written CUDA kernel
(``paddle_tpu_torch/csrc/paged_attention.cu``, built on first use by
:mod:`._build`) for CUDA tensors, and runs :func:`paged_attention_plain`
only for tensors on the CPU. A CUDA tensor the kernel does not take
raises; nothing falls back. :func:`plan` decides each launch's shape
(rows per block, sub-tile rows, how far each query tile's table is
split across warp groups) and its shared-memory layout from the shapes
alone, so the CPU tests check it; the kernel takes the layout as
given. :func:`split_ranges` lists the sub-tiles each key range then
reads. :func:`read_probe` launches the same walk without the math.
"""

from __future__ import annotations

import ctypes
import math
import sys

import torch

from . import _build, _launches
from ..attention_ops import paged_attention_reference

#: kernel launches made by :func:`paged_attention` (CPU calls excluded)
launches = 0
#: the same launches by route: "single" (one warp group walks a query
#: tile's whole table) or "split" (the table split across the warp
#: groups of one block, merged in shared memory)
launches_by_route = {"paged_attention": {"single": 0, "split": 0}}

_Q_CODES = {torch.float32: 0, torch.bfloat16: 1}
_KV_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_ELEM = {torch.float32: 4, torch.bfloat16: 2, torch.int8: 1}
# the kernel's limits, as in csrc/paged_attention.cu
MAX_STAGES = 4             # kMaxStages: sub-tiles in a ring, at most
MAX_KT = 16                # kMaxKT: key rows per sub-tile, at most
MAX_WARPS = 8              # kMaxWarps: warps of 8 rows in a block
MAX_WARPS_ONE_ROW = 16     # kMaxWarps1: warps of one row in a block
MAX_RANGES = 15            # kMaxRanges: key ranges (named barriers)
MAX_SMEM = 232448          # kMaxSmem: what one block may opt in to
# the plan's own choices
ROWS_PER_WARP = 8          # query rows of a warp when q_len > 1
RING_BYTES = 68 * 1024     # shared memory one full-depth ring may take
RINGS_BYTES = 200 * 1024   # shared memory the rings of a block may take


def _round_up(x, m):
    return -(-x // m) * m


def lane_cols(d):
    """Output columns a lane keeps in registers; 0 puts the accumulator
    in shared memory (d > 256)."""
    return 2 if d <= 64 else 4 if d <= 128 else 8 if d <= 256 else 0


def layout(d, elem, rows, kt, stages, ks):
    """The block's shared-memory layout, in bytes: ``ks`` rings of
    ``stages`` stages at 0 (a stage holds a K and a V sub-tile of ``kt``
    rows ``rs`` bytes apart, padded 16 B past the row so the keys of a
    sub-tile sit in different banks, then the two int8 multipliers),
    reused for the groups' partial accumulators once every group is
    done; the tile's query rows as f32 (``dp`` floats each) at
    ``q_off``; each group's partial (m, l) per row at ``ml_off``; the
    accumulators of d > 256 at ``acc_off``; ``smem`` in all."""
    rs = _round_up(d * elem, 16) + 16
    stage = 2 * kt * rs + 16
    dp = _round_up(d, 8)
    parts = _round_up(ks * rows * d * 4, 16) if lane_cols(d) else 0
    q_off = max(ks * stages * stage, parts)
    ml_off = q_off + rows * dp * 4
    acc_off = ml_off + ks * rows * 2 * 4
    smem = acc_off + (0 if lane_cols(d) else ks * rows * d * 4)
    return {"rs": rs, "stage": stage, "dp": dp, "q_off": q_off,
            "ml_off": ml_off, "acc_off": acc_off, "smem": smem}


def plan(b, h, s, d, bs, T, elem, *, align=16):
    """The kernel's launch plan for q [b, h, s, d] over pools of
    ``elem``-byte elements in blocks of ``bs`` rows and tables of ``T``
    entries, for pools whose addresses are multiples of ``align`` bytes.

    A block serves ``rows`` query rows of one (batch row, head): one row
    at decode (s 1), else ``ROWS_PER_WARP`` rows per warp (one at
    d > 256) in up to ``MAX_WARPS`` row groups. Entries are cut into
    sub-tiles of ``kt`` <= 16 key rows, so shared memory does not grow
    with ``bs``. Each query tile's valid sub-tiles are split into ``ks``
    ranges, one ring of ``stages`` sub-tiles and one warp group each: as
    many as the table has sub-tiles, up to ``MAX_RANGES`` and the
    block's warps, with the deepest ring (then 8-key sub-tiles) that
    lets them fit ``RINGS_BYTES``. The shared-memory layout is
    :func:`layout`'s. Raises ValueError where one block would need more
    than ``MAX_SMEM`` bytes of shared memory."""
    ne = lane_cols(d)
    if s == 1:
        rpw, rg = 1, 1
    elif ne:
        rpw, rg = ROWS_PER_WARP, min(MAX_WARPS, -(-s // ROWS_PER_WARP))
    else:
        rpw, rg = 1, min(MAX_WARPS, s)
    rows = rpw * rg
    tiles = -(-s // rows)
    rs = layout(d, elem, rows, 1, 1, 1)["rs"]
    kt0 = max(1, min(MAX_KT, bs, RING_BYTES // (MAX_STAGES * 2 * rs)))
    cap = min(MAX_RANGES,
              (MAX_WARPS_ONE_ROW if rpw == 1 else MAX_WARPS) // rg)
    # as many key ranges as the table has sub-tiles, up to cap: the
    # deepest ring that lets them fit, then 8-key sub-tiles
    best = None
    for kt in ((kt0, 8) if kt0 > 8 else (kt0,)):
        want = max(1, min(cap, T * -(-bs // kt)))
        for stages in range(MAX_STAGES, 1, -1):
            stage = layout(d, elem, rows, kt, stages, 1)["stage"]
            ks = max(1, min(want, RINGS_BYTES // (stages * stage)))
            if best is None or ks > best[0]:
                best = (ks, kt, stages)
            if ks == want:
                break
        if best[0] == want:
            break
    ks, kt, stages = best
    while ks > 1 and layout(d, elem, rows, kt, stages, ks)["smem"] > \
            MAX_SMEM:    # the rows' own bytes
        ks -= 1
    lay = layout(d, elem, rows, kt, stages, ks)
    if lay["smem"] > MAX_SMEM:
        raise ValueError(f"head_dim {d} needs {lay['smem']} B of shared "
                         f"memory per block, more than the card's "
                         f"{MAX_SMEM}")
    copy = next((w for w in (16, 8, 4)
                 if (d * elem) % w == 0 and align % w == 0), 0)
    return {"route": "single" if ks == 1 else "split", "rows": rows,
            "rows_per_warp": rpw, "lane_cols": ne, "warps": rg * ks,
            "tiles": tiles, "ks": ks, "kt": kt, "stages": stages,
            "sub_tiles": -(-bs // kt), "copy_bytes": copy,
            "grid": (b * h, tiles), "threads": rg * ks * 32, **lay}


def split_ranges(pl, pos, s, bs, T):
    """The sub-tiles ``[u0, u1)`` (sub-tile u is rows ``(u % sub_tiles) *
    kt`` on of table entry ``u // sub_tiles``) each key range of plan
    ``pl`` reads, as the kernel computes them: ``{(batch row, tile,
    range): (u0, u1)}``. A tile's ``ks`` ranges cut its valid sub-tiles
    (those of entries below ``nt``, the tile's last row's last key's
    entry) into contiguous, balanced runs; no entry at or past ``nt`` is
    read."""
    out = {}
    ks = pl["ks"]
    for bi, p in enumerate(pos):
        for tile in range(pl["tiles"]):
            last = min(s, (tile + 1) * pl["rows"]) - 1
            nt = min(T, -(-(int(p) + last + 1) // bs))
            units = nt * pl["sub_tiles"]
            for g in range(ks):
                out[(bi, tile, g)] = (units * g // ks,
                                      units * (g + 1) // ks)
    return out


def paged_attention_plain(q, k_pool, v_pool, tables, pos, *,
                          k_scale=None, v_scale=None, scale=None):
    """The kernel's function in plain PyTorch: f32 math over the
    gathered (upcast or dequantized) blocks, output in q's dtype."""
    quant = k_scale is not None
    out = paged_attention_reference(
        q.float(), k_pool if quant else k_pool.float(),
        v_pool if quant else v_pool.float(), tables, pos,
        k_scale=k_scale, v_scale=v_scale, scale=scale)
    return out.to(q.dtype)


_ENTRIES = ("paged_attention_launch", "paged_attention_read_probe")
#: the C entries' parameters: 8 pointers, the shapes and the plan (21
#: ints), scale, the two dtype codes, the stream
ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 21 +
            [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])


def _lib():
    lib = _build.load("paged_attention")
    if lib.paged_attention_launch.argtypes is None:
        for name in _ENTRIES:
            fn = getattr(lib, name)
            fn.argtypes = ARGTYPES
            fn.restype = ctypes.c_int
        lib.paged_attention_error_string.argtypes = [ctypes.c_int]
        lib.paged_attention_error_string.restype = ctypes.c_char_p
    return lib


def _check(q, k_pool, v_pool, tables, pos, k_scale, v_scale):
    b, h, s, d = q.shape
    nb, hp, _, dp = k_pool.shape
    if (hp, dp) != (h, d) or tuple(v_pool.shape) != tuple(k_pool.shape):
        raise ValueError(f"pool shape {tuple(k_pool.shape)}/"
                         f"{tuple(v_pool.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if tables.dim() != 2 or tables.shape[0] != b or \
            tuple(pos.shape) != (b,):
        raise ValueError(f"tables {tuple(tables.shape)} / pos "
                         f"{tuple(pos.shape)} do not match batch {b}")
    if q.dtype not in _Q_CODES:
        raise TypeError(f"q dtype {q.dtype} not supported by the kernel")
    if k_pool.dtype not in _KV_CODES or v_pool.dtype != k_pool.dtype:
        raise TypeError(f"pool dtypes {k_pool.dtype}/{v_pool.dtype} not "
                        "supported by the kernel")
    if (k_pool.dtype == torch.int8) != (k_scale is not None):
        raise TypeError("int8 pools need k_scale/v_scale, float pools "
                        "take none")
    if tables.dtype != torch.int32 or pos.dtype != torch.int32:
        raise TypeError("tables and pos must be int32")
    if min(q.shape) < 1 or min(k_pool.shape) < 1 or tables.shape[1] < 1:
        raise ValueError(f"empty q {tuple(q.shape)}, pool "
                         f"{tuple(k_pool.shape)} or table "
                         f"{tuple(tables.shape)}")
    tensors = [q, k_pool, v_pool, tables, pos]
    if k_scale is not None:
        if k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32 \
                or tuple(k_scale.shape) != (nb, h) \
                or tuple(v_scale.shape) != (nb, h):
            raise ValueError(f"scales must be float32 [{nb}, {h}]")
        tensors += [k_scale, v_scale]
    for t in tensors:
        if t.device != q.device:
            raise ValueError(f"all inputs must be on {q.device}, found "
                             f"{t.device}")
        if not t.is_contiguous():
            raise ValueError("the kernel takes contiguous tensors only")


def paged_attention(q, k_pool, v_pool, tables, pos, *,
                    k_scale=None, v_scale=None, scale=None):
    """Fused paged decode/verify/prefill attention over the block pool.

    Args:
      q: [batch, heads, q_len, head_dim] queries, f32 or bf16.
      k_pool / v_pool: [num_blocks, heads, block_size, head_dim] pools
        (f32/bf16, or int8 codes when scales are given).
      tables: [batch, T] int32 block tables (padding entries point at
        the trash block 0).
      pos: [batch] int32 committed lengths; query row i sits at
        absolute position ``pos[b] + i`` and sees keys ``<= pos[b]+i``.
      k_scale / v_scale: optional [num_blocks, heads] f32 absmax scales
        (both present selects the int8 path).
      scale: logit scale, default ``1/sqrt(head_dim)``.

    Returns [batch, heads, q_len, head_dim] in q's dtype, equal to
    :func:`~paddle_tpu_torch.ops.attention_ops.paged_attention_reference`
    up to the order of summation.
    """
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale must be given together")
    if q.device.type in ("cpu", "meta"):   # meta: the plain shapes
        return paged_attention_plain(q, k_pool, v_pool, tables, pos,
                                     k_scale=k_scale, v_scale=v_scale,
                                     scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention runs on cuda or cpu tensors, "
                         f"not {q.device}")
    out = torch.empty_like(q)
    pl = _launch("paged_attention_launch", q, k_pool, v_pool, tables, pos,
                 k_scale, v_scale, scale, out)
    _launches.count(sys.modules[__name__], None, pl["route"])
    return out


def read_probe(q, k_pool, v_pool, tables, pos, *, k_scale=None,
               v_scale=None):
    """Launches the kernel's read probe on CUDA tensors: the same plan
    and walk (pos, the table, every valid K/V sub-tile copied into the
    rings) with no math; writes nothing and counts no launch. Returns
    the plan."""
    if q.device.type != "cuda":
        raise ValueError(f"read_probe runs on cuda tensors, not {q.device}")
    return _launch("paged_attention_read_probe", q, k_pool, v_pool, tables,
                   pos, k_scale, v_scale, None, torch.empty_like(q))


def _launch(entry, q, k_pool, v_pool, tables, pos, k_scale, v_scale, scale,
            out):
    _check(q, k_pool, v_pool, tables, pos, k_scale, v_scale)
    b, h, s, d = q.shape
    bs = k_pool.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    align = math.gcd(16, k_pool.data_ptr(), v_pool.data_ptr())
    pl = plan(b, h, s, d, bs, tables.shape[1], _ELEM[k_pool.dtype],
              align=align)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = getattr(lib, entry)(*launch_args(
            pl, q, k_pool, v_pool, tables, pos, k_scale, v_scale, out,
            scale, stream))
    if rc != 0:
        msg = lib.paged_attention_error_string(rc).decode()
        raise RuntimeError(f"{entry} failed: {msg} ({rc})")
    return pl


def launch_args(pl, q, k_pool, v_pool, tables, pos, k_scale, v_scale, out,
                scale, stream):
    """The arguments of the C entries (``ARGTYPES``) for plan ``pl``."""
    b, h, s, d = q.shape
    nb, _, bs, _ = k_pool.shape
    return (q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            k_scale.data_ptr() if k_scale is not None else None,
            v_scale.data_ptr() if v_scale is not None else None,
            tables.data_ptr(), pos.data_ptr(), out.data_ptr(),
            b, h, s, d, nb, bs, tables.shape[1], pl["rows"],
            pl["rows_per_warp"], pl["lane_cols"], pl["kt"], pl["stages"],
            pl["ks"], pl["copy_bytes"], pl["rs"], pl["stage"], pl["dp"],
            pl["q_off"], pl["ml_off"], pl["acc_off"], pl["smem"],
            float(scale), _Q_CODES[q.dtype], _KV_CODES[k_pool.dtype],
            stream)
