"""Attention ops — the counterpart of ``paddle_tpu/ops/attention_ops.py``:
the ``fused_attention_qkv`` op and the KV-cache serving primitives, for
the fixed-capacity (slotted) cache and the block-paged one.

Layouts follow the JAX package: queries ``[b, h, s, d]``, slotted caches
``[b, h, capacity, d]``, KV pools ``[num_blocks, h, block_size, d]``,
block tables ``[b, T]`` int32 and committed lengths ``pos [b]`` int32.
Where JAX rebuilds a cache or a pool functionally
(``dynamic_update_slice``, ``pool.at[...].set``), the port writes it in
place (``scatter_``, ``index_put_``) and returns the same tensor: a
serving step owns its caches, and a fresh copy per layer per step would
double the KV bytes moved.

Physical block 0 is the trash block. Rows whose logical block falls
outside the table go there; JAX's scatter clamps out-of-range indices
and torch's raises (a device assert on CUDA), so the routing is
explicit here as it is there.
"""

from __future__ import annotations

import math

import torch

from .. import flags
from ..amp.auto_cast import autocast_inputs
from .cuda.flash_attention import flash_attention, pick_block
from .quant_ops import dequantize_int8, quantize_int8


def decode_attention_mask(pos, q_len: int, capacity: int,
                          dtype=torch.float32):
    """Additive mask: query i (absolute position ``pos[b] + i``) may
    attend key j iff ``j <= pos[b] + i``; other keys get
    ``finfo(dtype).min``. Returns ``[b, 1, q_len, capacity]``."""
    pos = pos.to(torch.int32)
    ar = torch.arange(q_len, dtype=torch.int32, device=pos.device)
    qpos = pos[:, None] + ar                                   # [b, q]
    keys = torch.arange(capacity, dtype=torch.int32, device=pos.device)
    valid = keys[None, None, :] <= qpos[:, :, None]            # [b, q, C]
    # filled on the device: a host-made scalar would be a copy, which a
    # captured serving step cannot hold
    neg = torch.full((), torch.finfo(dtype).min, dtype=dtype,
                     device=pos.device)
    zero = torch.zeros((), dtype=dtype, device=pos.device)
    return torch.where(valid, zero, neg)[:, None]


def cache_scatter_write(buf, new, pos):
    """Write ``new`` [b, h, s, d] rows into the fixed-capacity cache
    ``buf`` [b, h, capacity, d] at each batch row's own offset ``pos[b]``
    (an int, or a [b] tensor on ``buf``'s device); in place, returns
    ``buf``. Nothing is read back to the host, so a captured step can
    hold it.

    As ``jax.lax.dynamic_update_slice`` does, a negative start counts
    from the end (``pos + capacity``) and a start that would run past
    the capacity is clamped to ``[0, capacity - s]``: the window shifts
    back onto earlier rows instead of failing. Callers keep ``pos[b] + s
    <= capacity`` for every live row (the engine reserves the headroom
    at submission)."""
    b, h, s, d = new.shape
    cap = buf.shape[2]
    pos = torch.as_tensor(pos, device=buf.device).to(torch.int64)
    if pos.dim() == 0:
        pos = pos.expand(b)
    start = torch.clamp(torch.where(pos < 0, pos + cap, pos), 0, cap - s)
    rows = start[:, None] + torch.arange(s, device=buf.device)   # [b, s]
    idx = rows[:, None, :, None].expand(b, h, s, d)
    buf.scatter_(2, idx, new.to(buf.dtype))
    return buf


def _route(pos, tables, s: int, bs: int, overflow_block: int):
    """Physical (block, offset) of each written row: ``[b, s]`` each,
    rows past the table routed to ``overflow_block``."""
    T = tables.shape[1]
    ar = torch.arange(s, dtype=torch.int64, device=pos.device)
    rowpos = pos.to(torch.int64)[:, None] + ar                 # [b, s]
    logical = rowpos // bs
    phys = torch.gather(tables.to(torch.int64), 1,
                        torch.clamp_max(logical, T - 1))
    phys = torch.where(logical < T, phys,
                       torch.full_like(phys, overflow_block))
    return phys, rowpos % bs


def block_scatter_write(pool, new, pos, tables, overflow_block=0):
    """Write ``new`` [b, h, s, d] rows into ``pool`` [num_blocks, h, bs,
    d] at logical positions ``pos[b]..pos[b]+s-1`` routed through each
    row's block table; in place, returns ``pool``. Duplicate (trash,
    offset) targets are fine: one row's value wins and nothing reads
    the trash block through a position mask."""
    b, h, s, d = new.shape
    phys, offset = _route(pos, tables, s, pool.shape[2], overflow_block)
    rows = new.transpose(1, 2).reshape(b * s, h, d).to(pool.dtype)
    # advanced indices separated by the heads slice broadcast to the
    # front, as in numpy: the indexed view is [b*s, h, d]
    pool[phys.reshape(-1), :, offset.reshape(-1)] = rows
    return pool


def block_scatter_write_quant(pool, scales, new, pos, tables,
                              overflow_block=0):
    """Quantizing variant of :func:`block_scatter_write` for the int8
    pool: ``pool`` [num_blocks, h, bs, d] int8 codes with
    per-block-per-head absmax ``scales`` [num_blocks, h] f32, both
    updated in place. Returns ``(pool, scales, max_abs_err)``, the
    error being the max abs dequantization error over the live rows
    just written (overflow rows excluded).

    Only the window of blocks a write can touch (``(s-1)//bs + 2`` per
    request) is dequantized, updated and requantized; untouched blocks
    keep their exact codes and scales. Scales only grow, so at an
    unchanged scale the round trip of committed rows is idempotent.
    """
    b, h, s, d = new.shape
    bs = pool.shape[2]
    T = tables.shape[1]
    dev = new.device
    new = new.to(torch.float32)
    pos = pos.to(torch.int64)

    lo = pos // bs                                       # [b] first block
    n_aff = (s - 1) // bs + 2                            # static bound
    jblocks = lo[:, None] + torch.arange(n_aff, device=dev)[None]
    phys = torch.gather(tables.to(torch.int64), 1,
                        torch.clamp_max(jblocks, T - 1))  # [b, n_aff]
    phys = torch.where(jblocks < T, phys,
                       torch.full_like(phys, overflow_block))

    codes = pool[phys]                                   # [b,n_aff,h,bs,d]
    sc = scales[phys]                                    # [b,n_aff,h]
    vals = dequantize_int8(codes, sc[..., None, None])

    # insert the new rows at their in-window offsets (window-local
    # position = global position - lo*bs, always within n_aff*bs)
    win = vals.transpose(2, 3).reshape(b, n_aff * bs, h, d)
    local = (pos % bs)[:, None] + torch.arange(s, device=dev)[None]
    newrows = new.transpose(1, 2)                        # [b, s, h, d]
    bidx = torch.arange(b, device=dev)[:, None]
    win[bidx, local] = newrows
    win = win.reshape(b, n_aff, bs, h, d).transpose(2, 3)

    # which window blocks actually received a row this call
    wrote = torch.arange(n_aff, device=dev)[None] \
        <= ((pos % bs) + s - 1)[:, None] // bs           # [b, n_aff]

    amax = torch.amax(torch.abs(win), dim=(3, 4))        # [b, n_aff, h]
    new_sc = torch.where(wrote[..., None], torch.maximum(sc, amax), sc)
    new_codes = torch.where(wrote[..., None, None, None],
                            quantize_int8(win, new_sc[..., None, None]),
                            codes)

    flat = phys.reshape(-1)
    pool[flat] = new_codes.reshape(b * n_aff, h, bs, d)
    scales[flat] = new_sc.reshape(b * n_aff, h)

    # max abs dequant error over the live rows just written
    recon = dequantize_int8(new_codes, new_sc[..., None, None])
    recon = recon.transpose(2, 3).reshape(b, n_aff * bs, h, d)
    recon_rows = recon[bidx, local]                      # [b, s, h, d]
    rowpos = pos[:, None] + torch.arange(s, device=dev)[None]
    live = (rowpos // bs < T)[..., None, None]
    err = torch.amax(torch.where(live, torch.abs(recon_rows - newrows),
                                 torch.zeros((), device=dev)))
    return pool, scales, err


def block_gather(pool, tables):
    """Each request's logical KV rows from the pool:
    [b, h, T*block_size, d] (table padding reads the trash block, whose
    rows the position mask hides)."""
    g = pool[tables.to(torch.int64)]                     # [b, T, h, bs, d]
    b, T, h, bs, d = g.shape
    return g.transpose(1, 2).reshape(b, h, T * bs, d)


def block_gather_dequant(pool, scales, tables):
    """:func:`block_gather` for the int8 pool, dequantized to f32 with
    the same ``codes * (scale / 127)`` math the CUDA kernel applies."""
    idx = tables.to(torch.int64)
    g = dequantize_int8(pool[idx], scales[idx][..., None, None])
    b, T, h, bs, d = g.shape
    return g.transpose(1, 2).reshape(b, h, T * bs, d)


def paged_attention_reference(q, k_pool, v_pool, tables, pos, *,
                              k_scale=None, v_scale=None, scale=None):
    """Composed paged attention, the oracle for the CUDA kernel: gather
    (+ dequantize) each request's rows through its table, mask every
    key past ``pos[b] + row``, softmax, V-accumulate.
    q: [b, h, s, d] -> [b, h, s, d]."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale must be given together")
    if k_scale is not None:
        k = block_gather_dequant(k_pool, k_scale, tables)
        v = block_gather_dequant(v_pool, v_scale, tables)
    else:
        k = block_gather(k_pool, tables)
        v = block_gather(v_pool, tables)
    b, h, s, d = q.shape
    mask = decode_attention_mask(pos, s, k.shape[2], k.dtype)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    return _composed_attention(q, k, v, mask, causal=False,
                               scale=float(scale))


def _composed_attention(q, k, v, mask, causal, scale):
    # jnp.einsum promotes mixed f32/bf16 operands to f32; torch's
    # matmul wants one dtype, so cast to the promoted type first
    dt = torch.promote_types(q.dtype, k.dtype)
    q, k, v = q.to(dt), k.to(dt), v.to(dt)
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    if causal:
        s_q, s_k = logits.shape[-2], logits.shape[-1]
        causal_mask = torch.tril(torch.ones((s_q, s_k), dtype=torch.bool,
                                            device=q.device), s_k - s_q)
        logits = torch.where(causal_mask, logits,
                             torch.finfo(logits.dtype).min)
    if mask is not None:
        logits = logits + mask.to(logits.dtype)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v)


def flash_route(q, k, mask) -> bool:
    """Whether ``fused_attention_qkv`` takes the flash kernel: the JAX
    op's predicate (``paddle_tpu/ops/attention_ops.py:286``) plus the
    tileability check that the JAX op learns from a caught ValueError."""
    s_q, s_k = q.shape[-2], k.shape[-2]
    return (bool(flags.get_flag("use_pallas_attention"))
            and s_q >= flags.get_flag("pallas_min_seq")
            and s_q == s_k
            and mask is None
            and pick_block(s_q, flags.get_flag("pallas_flash_block_q"), 16) > 0
            and pick_block(s_k, flags.get_flag("pallas_flash_block_k"), 16) > 0)


def fused_attention_qkv(q, k, v, mask=None, causal=False, scale=None):
    """Attention over ``[batch, heads, seq, head_dim]`` q/k/v with an
    optional additive ``mask`` broadcastable to ``[b, h, s_q, s_k]``:
    the counterpart of the registered op (``attention_ops.py:256``).

    Shapes :func:`flash_route` admits go through the CUDA flash kernels
    (their plain versions on CPU tensors) and raise if those refuse them;
    nothing is caught. Every other call takes the composed form. The
    ``seq_axis`` ring route is not ported."""
    q, k, v, mask = autocast_inputs("fused_attention_qkv", q, k, v,
                                          mask)
    scale = scale or (1.0 / math.sqrt(q.shape[-1]))
    if flash_route(q, k, mask):
        return flash_attention(
            q, k, v, causal=causal, scale=scale,
            block_q=flags.get_flag("pallas_flash_block_q"),
            block_k=flags.get_flag("pallas_flash_block_k"))
    return _composed_attention(q, k, v, mask, causal, scale)
