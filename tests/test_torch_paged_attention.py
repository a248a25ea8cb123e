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
