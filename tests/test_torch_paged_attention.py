"""The port's paged-attention kernel module and KV write primitives
against the JAX package, on the CPU.

``paddle_tpu_torch.ops.cuda.paged_attention.paged_attention`` runs its
plain PyTorch version for CPU tensors; it is held within 2e-5 (only the
order of summation differs) of the JAX Pallas kernel in interpret mode
and of ``paged_attention_reference``, on the cases of
``tests/test_paged_attention.py``. The block writes must give the JAX
pools bit for bit: codes, scales and the trash-block routing of rows
past the table. The CUDA kernel itself is held against the plain
version on the card by ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import attention_ops as jops
from paddle_tpu.ops.pallas.paged_attention import \
    paged_attention as jax_paged_attention
from paddle_tpu_torch.ops import attention_ops as tops
from paddle_tpu_torch.ops.cuda import paged_attention as pa
from paddle_tpu_torch.ops.quant_ops import dequantize_int8, quantize_int8

TOL = dict(rtol=2e-5, atol=2e-5)

# one compile per shape instead of one eager dispatch compile per op
_jax_write_quant = jax.jit(jops.block_scatter_write_quant)
_jax_write = jax.jit(jops.block_scatter_write)


def _tables_for(pos, s, bs, T):
    """Each request's live logical blocks on distinct physical blocks,
    every entry past the reservation on the trash block (0)."""
    tables = np.zeros((len(pos), T), np.int32)
    nxt = 1
    for i, p in enumerate(pos):
        for j in range((p + s - 1) // bs + 1):
            tables[i, j] = nxt
            nxt += 1
    return tables, nxt


def _both(*arrays):
    """numpy arrays -> (jax arrays, torch CPU tensors)."""
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays])


def _check_attention(q, kp, vp, tables, pos, ksc=None, vsc=None):
    (jq, jk, jv, jt, jp), (tq, tk, tv, tt, tp) = _both(
        q, kp, vp, tables, np.asarray(pos, np.int32))
    jkw, tkw = {}, {}
    if ksc is not None:
        (jks, jvs), (tks, tvs) = _both(ksc, vsc)
        jkw, tkw = dict(k_scale=jks, v_scale=jvs), dict(k_scale=tks,
                                                        v_scale=tvs)
    before = pa.launches
    out = pa.paged_attention(tq, tk, tv, tt, tp, **tkw)
    assert pa.launches == before      # CPU tensors never launch
    assert out.dtype == tq.dtype and out.shape == tq.shape
    kernel = np.asarray(jax_paged_attention(jq, jk, jv, jt, jp, **jkw))
    ref = np.asarray(jops.paged_attention_reference(jq, jk, jv, jt, jp,
                                                    **jkw))
    np.testing.assert_allclose(out.numpy(), kernel, **TOL)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    np.testing.assert_allclose(
        tops.paged_attention_reference(tq, tk, tv, tt, tp, **tkw).numpy(),
        ref, **TOL)


@pytest.mark.parametrize("s,pos", [
    (1, [3, 15, 4]),     # decode width; pos=15 ends exactly on a block
    (3, [3, 13, 0]),     # verify width (spec K=2): rows straddle blocks
    (1, [0, 7, 8]),      # first token; boundary-1 / boundary
])
@pytest.mark.parametrize("kv_dtype", ["f32", "bf16"])
def test_paged_attention_matches_jax(s, pos, kv_dtype):
    rng = np.random.RandomState(3)
    bs, T, h, d = 4, 5, 2, 32
    tables, nb = _tables_for(pos, s, bs, T)
    k_pool = rng.randn(nb, h, bs, d).astype(np.float32)
    v_pool = rng.randn(nb, h, bs, d).astype(np.float32)
    # poison the trash block: a side that fails to mask table padding
    # blows the comparison wide open
    k_pool[0] = 100.0
    v_pool[0] = 100.0
    q = rng.randn(len(pos), h, s, d).astype(np.float32)
    if kv_dtype == "bf16":
        (jk, jv), _ = _both(k_pool, v_pool)
        k_pool = np.asarray(jk.astype(jnp.bfloat16))
        v_pool = np.asarray(jv.astype(jnp.bfloat16))
        tk = torch.from_numpy(k_pool.astype(np.float32)).to(torch.bfloat16)
        assert np.array_equal(tk.float().numpy(), k_pool.astype(np.float32))
        # numpy has no bfloat16: hand the same bf16 values to both sides
        out = pa.paged_attention(
            torch.from_numpy(q), tk,
            torch.from_numpy(v_pool.astype(np.float32)).to(torch.bfloat16),
            torch.from_numpy(tables), torch.tensor(pos, dtype=torch.int32))
        ref = jops.paged_attention_reference(
            jnp.asarray(q), jnp.asarray(k_pool), jnp.asarray(v_pool),
            jnp.asarray(tables), jnp.asarray(pos, jnp.int32))
        kernel = jax_paged_attention(
            jnp.asarray(q), jnp.asarray(k_pool), jnp.asarray(v_pool),
            jnp.asarray(tables), jnp.asarray(pos, jnp.int32))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
        np.testing.assert_allclose(out.numpy(), np.asarray(kernel), **TOL)
        return
    _check_attention(q, k_pool, v_pool, tables, pos)


def test_paged_attention_odd_head_dim():
    rng = np.random.RandomState(17)
    bs, T, h, d = 4, 4, 2, 20
    pos = [5, 9]
    tables, nb = _tables_for(pos, 1, bs, T)
    k_pool = rng.randn(nb, h, bs, d).astype(np.float32)
    v_pool = rng.randn(nb, h, bs, d).astype(np.float32)
    q = rng.randn(2, h, 1, d).astype(np.float32)
    _check_attention(q, k_pool, v_pool, tables, pos)


def _write_both(rng, tables, nb, bs, h, d, widths):
    """Run the same mixed decode/verify write sequence through the JAX
    and the port's quantizing and float writes, asserting bit-equal
    pools after every write."""
    b = tables.shape[0]
    zq = np.zeros((nb, h, bs, d), np.int8)
    zs = np.zeros((nb, h), np.float32)
    zf = np.zeros((nb, h, bs, d), np.float32)
    (jkq, jks, jkf, jt), (tkq, tks, tkf, tt) = _both(zq, zs, zf, tables)
    pos = 0
    for w in widths:
        new = rng.randn(b, h, w, d).astype(np.float32)
        posv = np.full((b,), pos, np.int32)
        (jn, jp), (tn, tp) = _both(new, posv)
        jkq, jks, jerr = _jax_write_quant(jkq, jks, jn, jp, jt)
        _, _, terr = tops.block_scatter_write_quant(tkq, tks, tn, tp, tt)
        jkf = _jax_write(jkf, jn, jp, jt)
        tops.block_scatter_write(tkf, tn, tp, tt)
        np.testing.assert_array_equal(tkq.numpy(), np.asarray(jkq))
        np.testing.assert_array_equal(tks.numpy(), np.asarray(jks))
        np.testing.assert_array_equal(tkf.numpy(), np.asarray(jkf))
        # the error scalar is arithmetic on top of the pools: XLA may
        # fuse its dequantize differently, so it agrees to rounding
        np.testing.assert_allclose(float(terr), float(jerr), rtol=1e-5)
        assert float(terr) < 0.05
        pos += w
    return tkq, tks, tkf, pos


@pytest.mark.parametrize("s", [1, 3])
def test_paged_attention_int8_matches_jax(s):
    rng = np.random.RandomState(5)
    bs, T, h, d = 4, 5, 2, 32
    b = 2
    widths = [3, 1, 4, 1, 2]  # mixed decode/verify writes, 11 rows
    end = sum(widths)
    tables, nb = _tables_for([end - 1] * b, 1, bs, T)
    kq, ks, _, _ = _write_both(rng, tables, nb, bs, h, d, widths)
    vq, vs, _, _ = _write_both(rng, tables, nb, bs, h, d, widths)
    pos = [end - s] * b       # rows pos..end-1 written
    q = rng.randn(b, h, s, d).astype(np.float32)
    _check_attention(q, kq.numpy(), vq.numpy(), tables, pos,
                     ks.numpy(), vs.numpy())


def test_quant_helpers_bit_equal():
    from paddle_tpu.ops.quant_ops import dequantize_int8 as jdeq
    from paddle_tpu.ops.quant_ops import quantize_int8 as jq
    rng = np.random.RandomState(23)
    x = (rng.randn(64, 16) * 3).astype(np.float32)
    sc = np.abs(x).max(axis=1, keepdims=True).astype(np.float32)
    sc[0] = 0.0               # the 1e-9 floor
    x[1, :4] = [0.5, -0.5, 1.5, 2.5]   # round-half-to-even cases
    sc[1] = 127.0
    codes = quantize_int8(torch.from_numpy(x), torch.from_numpy(sc))
    np.testing.assert_array_equal(codes.numpy(),
                                  np.asarray(jq(jnp.asarray(x),
                                                jnp.asarray(sc))))
    np.testing.assert_array_equal(
        dequantize_int8(codes, torch.from_numpy(sc)).numpy(),
        np.asarray(jdeq(jnp.asarray(codes.numpy()), jnp.asarray(sc))))


def test_quant_write_quieter_rows_never_drift_committed_codes():
    """Monotone scales: a later, quieter write into the same block must
    leave the committed codes AND scale bit-identical."""
    rng = np.random.RandomState(9)
    bs, h, d = 4, 2, 8
    tables = torch.tensor([[1, 2]], dtype=torch.int32)
    pool = torch.zeros((3, h, bs, d), dtype=torch.int8)
    sc = torch.zeros((3, h))
    loud = torch.from_numpy(rng.randn(1, h, 2, d).astype(np.float32) * 4)
    tops.block_scatter_write_quant(pool, sc, loud,
                                   torch.tensor([0], dtype=torch.int32),
                                   tables)
    before_codes = pool[1, :, :2].clone()
    before_sc = sc[1].clone()
    quiet = torch.from_numpy(rng.randn(1, h, 1, d).astype(np.float32) * .1)
    tops.block_scatter_write_quant(pool, sc, quiet,
                                   torch.tensor([2], dtype=torch.int32),
                                   tables)
    assert torch.equal(sc[1], before_sc)
    assert torch.equal(pool[1, :, :2], before_codes)


def test_quant_write_only_touches_window_blocks():
    rng = np.random.RandomState(11)
    bs, h, d = 4, 2, 8
    tables = torch.tensor([[1, 2, 3]], dtype=torch.int32)
    pool = torch.zeros((4, h, bs, d), dtype=torch.int8)
    sc = torch.zeros((4, h))
    first = torch.from_numpy(rng.randn(1, h, 3, d).astype(np.float32))
    tops.block_scatter_write_quant(pool, sc, first,
                                   torch.tensor([0], dtype=torch.int32),
                                   tables)
    blk1_codes, blk1_sc = pool[1].clone(), sc[1].clone()
    # a write entirely within logical block 1 (pos 4..5) leaves
    # physical block 1 untouched
    nxt = torch.from_numpy(rng.randn(1, h, 2, d).astype(np.float32))
    tops.block_scatter_write_quant(pool, sc, nxt,
                                   torch.tensor([4], dtype=torch.int32),
                                   tables)
    assert torch.equal(pool[1], blk1_codes)
    assert torch.equal(sc[1], blk1_sc)


@pytest.mark.parametrize("quant", [True, False])
def test_overflow_rows_route_to_trash_like_jax(quant):
    """Rows past the table (bucketed prefill suffix padding) land in the
    trash block; live blocks match JAX bit for bit and the error stat
    covers live rows only."""
    rng = np.random.RandomState(13)
    bs, T, h, d = 4, 2, 2, 8
    tables = np.asarray([[1, 2]], np.int32)
    new = rng.randn(1, h, 3, d).astype(np.float32)
    posv = np.asarray([T * bs - 1], np.int32)   # rows 8/9 overflow
    if quant:
        (jp, js, jn, jpos, jt), (tp, ts, tn, tpos, tt) = _both(
            np.zeros((3, h, bs, d), np.int8), np.zeros((3, h), np.float32),
            new, posv, tables)
        jp, js, jerr = _jax_write_quant(jp, js, jn, jpos, jt)
        _, _, terr = tops.block_scatter_write_quant(tp, ts, tn, tpos, tt)
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        np.testing.assert_allclose(float(terr), float(jerr), rtol=1e-5)
        assert float(terr) < 0.05
        deq = dequantize_int8(tp[2], ts[2][:, None, None])
        np.testing.assert_allclose(deq[:, bs - 1].numpy(), new[0, :, 0],
                                   atol=0.05)
    else:
        (jp, jn, jpos, jt), (tp, tn, tpos, tt) = _both(
            np.zeros((3, h, bs, d), np.float32), new, posv, tables)
        jp = _jax_write(jp, jn, jpos, jt)
        tops.block_scatter_write(tp, tn, tpos, tt)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    assert tp[0].abs().sum() > 0          # overflow went to the trash
    assert tp[1].abs().sum() == 0         # untouched live block


# ---------------------------------------------------------------- the
# CUDA kernel's launch plan and its split-and-combine arithmetic

@pytest.mark.parametrize("s", [1, 3, 5, 16, 64, 100])
@pytest.mark.parametrize("bs,T", [(1, 40), (4, 5), (16, 16), (64, 4),
                                  (128, 2), (20, 3)])
def test_split_plan_covers_each_valid_entry_once(s, bs, T):
    rng = np.random.RandomState(bs * 131 + s)
    b, h, d = 3, 2, 64
    T = max(T, -(-s // bs))       # the table holds every query row
    pos = [int(p) for p in rng.randint(0, max(1, T * bs - s + 1), size=b)]
    pos[0] = 0
    for elem in (1, 2, 4):
        pl = pa.plan(b, h, s, d, bs, T, elem)
        assert pl["grid"] == (b * h, pl["tiles"])
        assert pl["tiles"] * pl["rows"] >= s
        assert pl["threads"] == 32 * pl["warps"] <= 512
        assert pl["ks"] <= pa.MAX_RANGES and 2 <= pl["stages"] <= 4
        nsub, kt = pl["sub_tiles"], pl["kt"]
        ranges = pa.split_ranges(pl, pos, s, bs, T)
        for bi, p in enumerate(pos):
            for tile in range(pl["tiles"]):
                last = min(s, (tile + 1) * pl["rows"]) - 1
                nt = min(T, -(-(p + last + 1) // bs))
                seen = []
                for g in range(pl["ks"]):
                    u0, u1 = ranges[(bi, tile, g)]
                    seen += range(u0, u1)
                # every sub-tile of every entry a row of the tile can
                # see, once; none of an entry at or past the tile's last
                # valid one (trash padding)
                assert sorted(seen) == list(range(nt * nsub))
                keys = {(u // nsub) * bs + (u % nsub) * kt + j
                        for u in seen for j in range(kt)
                        if (u % nsub) * kt + j < bs}
                for row in range(tile * pl["rows"], last + 1):
                    assert set(range(p + row + 1)) <= keys
                assert max(keys) < nt * bs


def test_split_plan_routes_decode_to_splits_and_prefill_to_one_group():
    dec = pa.plan(8, 16, 1, 64, 16, 16, 4)
    assert dec["route"] == "split" and dec["ks"] > 1
    assert dec["rows"] == 1 and dec["copy_bytes"] == 16
    # 15 one-warp key ranges per block: int8 rings at full depth and
    # 16 keys, bf16 at depth 2, f32 with 8-key sub-tiles at depth 3
    for elem, kt, stages in ((4, 8, 3), (2, 16, 2), (1, 16, 4)):
        pl = pa.plan(8, 16, 1, 64, 16, 16, elem)
        assert (pl["ks"], pl["kt"], pl["stages"], pl["warps"]) == \
            (15, kt, stages, 15)
    # few (b, h) pairs: still one block each, its warps split the table
    one = pa.plan(1, 2, 1, 64, 16, 16, 4)
    assert one["route"] == "split" and one["grid"] == (2, 1)
    pre = pa.plan(8, 16, 64, 64, 16, 16, 4)
    assert pre["route"] == "single" and pre["rows"] == 64
    assert pre["warps"] == 8 and pre["tiles"] == 1
    # an entry is read once per 64 query rows, not once per 8
    assert pa.plan(8, 16, 128, 64, 16, 16, 4)["tiles"] == 2


@pytest.mark.parametrize("elem", [1, 2, 4])
@pytest.mark.parametrize("s", [1, 5, 64])
def test_plan_shared_memory_fits_every_block_size_and_width(elem, s):
    for bs in (1, 2, 3, 16, 20, 64, 100, 128):
        for d in list(range(1, 65)) + [80, 96, 100, 128, 200, 256, 257,
                                       320, 384, 500, 512]:
            pl = pa.plan(8, 16, s, d, bs, 4, elem)
            assert pl["smem"] <= pa.MAX_SMEM
            _assert_layout_holds(pl, d, elem)
            assert 1 <= pl["kt"] <= min(16, bs)
            assert pl["sub_tiles"] * pl["kt"] >= bs
            assert pl["rows"] <= 64 and pl["ks"] <= pa.MAX_RANGES
            assert pl["warps"] <= (16 if pl["rows_per_warp"] == 1 else 8)
            assert pl["warps"] == pl["ks"] * pl["rows"] // \
                pl["rows_per_warp"]
            assert pl["copy_bytes"] in (0, 4, 8, 16)
            if pl["copy_bytes"]:
                assert (d * elem) % pl["copy_bytes"] == 0
            if d > 256:
                assert pl["rows_per_warp"] == 1


def _assert_layout_holds(pl, d, elem):
    """The plan's shared-memory regions hold what the kernel indexes in
    them, do not overlap, are aligned for its vector reads and lie
    inside ``smem``; the groups' partial accumulators (d <= 256) reuse
    the rings."""
    rows, ks = pl["rows"], pl["ks"]
    assert pl["rs"] % 16 == 0 and pl["rs"] >= d * elem + 16
    assert pl["stage"] % 16 == 0 and pl["stage"] >= 2 * pl["kt"] * \
        pl["rs"] + 8
    assert pl["dp"] % 8 == 0 and pl["dp"] >= d
    assert pl["q_off"] % 16 == 0
    regions = [(0, ks * pl["stages"] * pl["stage"]),
               (pl["q_off"], pl["q_off"] + rows * pl["dp"] * 4),
               (pl["ml_off"], pl["ml_off"] + ks * rows * 8)]
    if pl["lane_cols"]:
        assert ks * rows * d * 4 <= pl["q_off"]
    else:
        regions.append((pl["acc_off"], pl["acc_off"] + ks * rows * d * 4))
    regions.sort()
    for (_, end), (start, _) in zip(regions, regions[1:]):
        assert end <= start
    assert regions[-1][1] <= pl["smem"]


def test_plan_copy_width_follows_row_bytes_and_alignment():
    assert pa.plan(1, 1, 1, 20, 4, 2, 1)["copy_bytes"] == 4    # int8 d 20
    assert pa.plan(1, 1, 1, 3, 4, 2, 1)["copy_bytes"] == 0     # 3 B rows
    assert pa.plan(1, 1, 1, 7, 4, 2, 2)["copy_bytes"] == 0     # 14 B rows
    assert pa.plan(1, 1, 1, 12, 4, 2, 2)["copy_bytes"] == 8
    assert pa.plan(1, 1, 1, 64, 4, 2, 4, align=8)["copy_bytes"] == 8


@pytest.mark.parametrize("bs,d,T", [(64, 128, 4), (128, 64, 2),
                                    (16, 320, 16)])
def test_check_takes_the_block_sizes_and_widths_the_reference_takes(bs, d,
                                                                    T):
    q = torch.zeros(2, 2, 1, d)
    pool = torch.zeros(3, 2, bs, d)
    tables = torch.ones(2, T, dtype=torch.int32)
    pos = torch.zeros(2, dtype=torch.int32)
    pa._check(q, pool, pool, tables, pos, None, None)   # no raise
    pa.plan(2, 2, 1, d, bs, T, 4)
    out = pa.paged_attention(q, pool, pool, tables, pos)
    assert out.shape == q.shape


def _emulated(q, kp, vp, tables, pos, ks=None, vs=None, splits=None,
              drop=None):
    """The kernel's arithmetic in plain torch: the plan's query tiles and
    key ranges (``splits`` ranges per block overrides the plan's), each
    range walking its sub-tiles of ``kt`` keys with one max and one
    rescale per sub-tile, the ranges of a tile merged at the end.
    ``drop`` leaves range number ``drop`` out of the merge."""
    b, h, s, d = q.shape
    nb, _, bs, _ = kp.shape
    T = tables.shape[1]
    elem = {torch.float32: 4, torch.bfloat16: 2, torch.int8: 1}[kp.dtype]
    pl = pa.plan(b, h, s, d, bs, T, elem)
    if splits is not None:
        pl = {**pl, "ks": splits}
    ranges = pa.split_ranges(pl, pos, s, bs, T)
    kt, rows, nsub = pl["kt"], pl["rows"], pl["sub_tiles"]
    scale = 1.0 / np.sqrt(d)
    out = torch.empty(b, h, s, d)
    ninf = torch.tensor(-np.inf)

    def rows_of(pool, sc, blk, hh):
        x = pool[blk, hh].float()
        return x * (sc[blk, hh] / 127.0) if sc is not None else x

    for bi in range(b):
        for tile in range(pl["tiles"]):
            r0, r1 = tile * rows, min(s, (tile + 1) * rows)
            qpos = int(pos[bi]) + torch.arange(r0, r1)
            for hh in range(h):
                qq = q[bi, hh, r0:r1].float() * scale
                parts = []
                for g in range(pl["ks"]):
                    u0, u1 = ranges[(bi, tile, g)]
                    m = torch.full((r1 - r0,), -np.inf)
                    l = torch.zeros(r1 - r0)
                    acc = torch.zeros(r1 - r0, d)
                    for u in range(u0, u1):
                        t, j0 = u // nsub, (u % nsub) * kt
                        blk = int(tables[bi, t])
                        K = rows_of(kp, ks, blk, hh)[j0:j0 + kt]
                        V = rows_of(vp, vs, blk, hh)[j0:j0 + kt]
                        kpos = t * bs + j0 + torch.arange(len(K))
                        x_ = torch.where(kpos[None] <= qpos[:, None],
                                         qq @ K.T, ninf)
                        m_new = torch.maximum(m, x_.max(1).values)
                        mu = torch.where(m_new == -np.inf,
                                         torch.zeros(()), m_new)
                        alpha = torch.exp(m - mu)
                        p = torch.exp(x_ - mu[:, None])
                        l = l * alpha + p.sum(1)
                        acc = acc * alpha[:, None] + p @ V
                        m = m_new
                    if drop != g:
                        parts.append((m, l, acc))
                # the merge: weights exp(m_k - max m), 0 for a range
                # that saw no key
                mx = torch.stack([pm for pm, _, _ in parts]).max(0).values
                f = [torch.exp(pm - mx) for pm, _, _ in parts]
                lsum = sum(pl_ * fi for (_, pl_, _), fi in zip(parts, f))
                o = sum(pc * fi[:, None] for (_, _, pc), fi in zip(parts, f))
                out[bi, hh, r0:r1] = o / lsum[:, None]
    return out.to(q.dtype)


def _split_case(name):
    """(q, k pool, v pool, tables, pos, k scale, v scale) as numpy, the
    trash block poisoned with 100.0."""
    rng = np.random.RandomState(sum(map(ord, name)))
    s, bs, d, pos = {
        "decode": (1, 16, 64, [0, 15, 37, 50]),
        "verify s=5": (5, 16, 64, [0, 11, 40, 58]),
        "prefill s=64": (64, 16, 64, [0, 0, 3, 0]),
        "pad rows s=64": (64, 16, 64, [0, 0, 0, 0]),
        "bs 64 d 128": (1, 64, 128, [3, 63, 100, 190]),
        "bs 128 d 64": (3, 128, 64, [0, 120, 130, 250]),
        "d 320": (1, 16, 320, [1, 16, 30, 47]),
        "bs 4 d 20": (3, 4, 20, [0, 5, 9, 13]),
    }[name]
    h = 2
    T = -(-(max(pos) + s) // bs) + 1
    tables, nb = _tables_for(pos, s, bs, T)
    if name.startswith("pad rows"):
        tables[2:] = 0       # bucketed padding rows: all trash at pos 0
    kp = rng.randn(nb, h, bs, d).astype(np.float32)
    vp = rng.randn(nb, h, bs, d).astype(np.float32)
    kp[0] = 100.0
    vp[0] = 100.0
    q = rng.randn(len(pos), h, s, d).astype(np.float32)
    return q, kp, vp, tables, np.asarray(pos, np.int32)


_SPLIT_CASES = ["decode", "verify s=5", "prefill s=64", "pad rows s=64",
                "bs 64 d 128", "bs 128 d 64", "d 320", "bs 4 d 20"]


@pytest.mark.parametrize("name", _SPLIT_CASES)
def test_split_and_combine_matches_jax_kernel(name):
    q, kp, vp, tables, pos = _split_case(name)
    kernel = np.asarray(jax_paged_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(pos)))
    args = [torch.from_numpy(a) for a in (q, kp, vp, tables, pos)]
    for splits in (None, 1, 2, 3, 4, 8, 15):
        out = _emulated(*args, splits=splits)
        np.testing.assert_allclose(out.numpy(), kernel, **TOL,
                                   err_msg=f"{name}, splits {splits}")


@pytest.mark.parametrize("s", [1, 5])
def test_split_and_combine_int8_matches_jax_kernel(s):
    rng = np.random.RandomState(29 + s)
    bs, T, h, d, b = 4, 5, 2, 32, 2
    widths = [3, 1, 4, 1, 2]
    end = sum(widths)
    tables, nb = _tables_for([end - 1] * b, 1, bs, T)
    kq, ks, _, _ = _write_both(rng, tables, nb, bs, h, d, widths)
    vq, vs, _, _ = _write_both(rng, tables, nb, bs, h, d, widths)
    pos = np.asarray([end - s] * b, np.int32)
    q = rng.randn(b, h, s, d).astype(np.float32)
    kernel = np.asarray(jax_paged_attention(
        jnp.asarray(q), jnp.asarray(kq.numpy()), jnp.asarray(vq.numpy()),
        jnp.asarray(tables), jnp.asarray(pos),
        k_scale=jnp.asarray(ks.numpy()), v_scale=jnp.asarray(vs.numpy())))
    for splits in (1, 2, 6):
        out = _emulated(torch.from_numpy(q), kq, vq,
                        torch.from_numpy(tables), torch.from_numpy(pos),
                        ks, vs, splits=splits)
        np.testing.assert_allclose(out.numpy(), kernel, **TOL)


@pytest.mark.parametrize("name", ["decode", "bs 64 d 128", "d 320"])
def test_dropping_one_split_fails_the_bound(name):
    q, kp, vp, tables, pos = _split_case(name)
    kernel = np.asarray(jax_paged_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(pos)))
    args = [torch.from_numpy(a) for a in (q, kp, vp, tables, pos)]
    out = _emulated(*args, splits=4, drop=1)
    assert not np.allclose(out.numpy(), kernel, **TOL)


@pytest.mark.parametrize("entry", ["paged_attention_launch",
                                   "paged_attention_read_probe"])
def test_launch_args_match_the_c_entry(entry):
    """The wrapper passes as many arguments, of the same kinds, as the C
    entry in csrc/paged_attention.cu declares (a mismatch only shows on
    the card)."""
    import ctypes
    import pathlib
    import re
    src = (pathlib.Path(pa.__file__).resolve().parents[2] / "csrc" /
           "paged_attention.cu").read_text()
    decl = re.search(r'extern "C" int ' + entry + r'\(([^)]*)\)', src)
    params = [p.strip() for p in decl.group(1).split(",")]
    kinds = [ctypes.c_void_p if "*" in p else
             ctypes.c_float if p.startswith("float") else ctypes.c_int
             for p in params]
    assert kinds == pa.ARGTYPES
    q = torch.zeros(2, 4, 1, 64)
    pool = torch.zeros(3, 4, 16, 64)
    tables = torch.ones(2, 4, dtype=torch.int32)
    pos = torch.zeros(2, dtype=torch.int32)
    pl = pa.plan(2, 4, 1, 64, 16, 4, 4)
    args = pa.launch_args(pl, q, pool, pool, tables, pos, None, None, q,
                          0.125, None)
    assert len(args) == len(params)
    for a, kind in zip(args, kinds):
        if kind is ctypes.c_int:
            assert isinstance(a, int)
        elif kind is ctypes.c_float:
            assert isinstance(a, float)
