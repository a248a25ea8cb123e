"""The route of the port's flash kernels and the bound that holds the
tensor-core route on the card, on the CPU.

``_tc_route`` decides before any launch which kernel a CUDA call takes:
bf16 with head_dim 64 or 128 goes to the tensor-core (``wgmma``)
forward, dQ and dK/dV, everything else to the CUDA-core ones; the packed
forward's ``_tc_route`` sends bf16 with 64-wide heads to its tensor-core
kernel. CPU tensors run the plain versions and count no launch on
either route.

The tensor-core kernels round P (and dS) to bf16 before the second
product, so ``chip_smoke.py`` holds their bf16 outputs to
``close_rounded``: the f32 bound plus half a bf16 ulp plus 2^-8 of the
same product over magnitudes. Here a plain emulation of the kernels'
arithmetic (64-key tiles, the online softmax with its running max, P
rounded to bf16 before P V; dS rounded before dQ += dS K, per 64-key
tile; P^T and dS^T rounded before dV and dK; the packed forward as the
forward on each head of a pair; the outputs rounded to bf16 once), on
numpy-seeded inputs, stays within that bound, and the same emulation
with one tile left out does not; nor does the f32 result truncated to
bf16, which the bound's width would take but its bias check does not.
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops.cuda import flash_attention as fa
from paddle_tpu_torch.ops.cuda import flash_pack2 as fp2

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def smoke():
    """``chip_smoke.py`` as a module (it imports torch only in main)."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("dtype,d,want", [
    (torch.bfloat16, 64, True),
    (torch.bfloat16, 128, True),
    (torch.float32, 64, False),
    (torch.float32, 128, False),
    (torch.bfloat16, 20, False),
    (torch.bfloat16, 32, False),
    (torch.bfloat16, 80, False),
])
def test_tc_route_takes_bf16_with_d_64_or_128_only(dtype, d, want):
    assert fa._tc_route(dtype, d) is want


@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 64),
                                     (torch.bfloat16, 128),
                                     (torch.float32, 20)])
def test_cpu_tensors_count_no_launch_on_either_route(dtype, d):
    rng = np.random.RandomState(0)
    q, k, v, do = (torch.from_numpy(rng.randn(2, 64, d).astype(np.float32))
                   .to(dtype) for _ in range(4))
    before = (dict(fa.launches),
              {n: dict(r) for n, r in fa.launches_by_route.items()})
    o, lse = fa.flash_fwd(q, k, v, True, 0.125)
    delta = (do.float() * o.float()).sum(-1)
    fa.flash_bwd_dq(q, k, v, do, lse, delta, True, 0.125)
    fa.flash_bwd_dkv(q, k, v, do, lse, delta, True, 0.125)
    qa = q.float().requires_grad_()
    fa.flash_attention(qa[None], k.float()[None], v.float()[None],
                       causal=True).sum().backward()
    after = (dict(fa.launches),
             {n: dict(r) for n, r in fa.launches_by_route.items()})
    assert after == before
    assert set(fa.launches_by_route) == set(fa.launches)
    assert all(set(r) == {"wgmma", "simt"}
               for r in fa.launches_by_route.values())


@pytest.mark.parametrize("dtype,d,want", [
    (torch.bfloat16, 64, True),
    (torch.float32, 64, False),
    (torch.bfloat16, 20, False),
    (torch.bfloat16, 32, False),
])
def test_packed_tc_route_takes_bf16_with_d_64_only(dtype, d, want):
    assert fp2._tc_route(dtype, d) is want


@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 64),
                                     (torch.float32, 20)])
def test_packed_cpu_tensors_count_no_launch_on_either_route(dtype, d):
    rng = np.random.RandomState(1)
    q, k, v = (torch.from_numpy(rng.randn(2, 64, 2 * d).astype(np.float32))
               .to(dtype) for _ in range(3))
    before = (dict(fp2.launches),
              {n: dict(r) for n, r in fp2.launches_by_route.items()})
    o = fp2.packed_flash_fwd(q, k, v, True, 0.125)
    assert o.dtype == dtype and o.shape == q.shape
    after = (dict(fp2.launches),
             {n: dict(r) for n, r in fp2.launches_by_route.items()})
    assert after == before
    assert set(fp2.launches_by_route) == set(fp2.launches)
    assert all(set(r) == {"wgmma", "simt"}
               for r in fp2.launches_by_route.values())


def _inputs(seed, bh, s_q, s_k, d):
    """q, k, v, dO with bf16 values, as f32 (what both sides read)."""
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.randn(bh, s, d).astype(np.float32))
            .bfloat16().float() for s in (s_q, s_k, s_k, s_q)]


def _fwd_emulated(q, k, v, causal, scale, skip=None):
    """The tensor-core forward's arithmetic in plain torch: 64-key tiles,
    the running max and sum in f32, P rounded to bf16 before P V, O
    rounded to bf16 once; ``skip`` leaves one k tile out."""
    s = fa._scores(q, k, causal, scale)
    bh, s_q, s_k = s.shape
    m = torch.full((bh, s_q), float("-inf"))
    l = torch.zeros(bh, s_q)
    acc = torch.zeros(bh, s_q, q.shape[-1])
    for t, k0 in enumerate(range(0, s_k, 64)):
        if t == skip:
            continue
        st = s[:, :, k0:k0 + 64]
        m_new = torch.maximum(m, st.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(st - m_new[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + p.bfloat16().float() @ v[:, k0:k0 + 64]
        m = m_new
    return (acc / l[..., None]).bfloat16()


def _dkv_emulated(q, k, v, do, lse, delta, causal, scale, skip=None):
    """The tensor-core dK/dV's arithmetic: P^T and dS^T in f32, rounded to
    bf16 before dV += P^T dO and dK += dS^T q (scaled after), per 64-row q
    tile; dK and dV rounded to bf16 once; ``skip`` leaves one q tile
    out."""
    p = torch.exp(fa._scores(q, k, causal, scale) - lse[..., None])
    ds = p * (do @ v.transpose(-1, -2) - delta[..., None])
    dk = torch.zeros_like(k)
    dv = torch.zeros_like(v)
    for t, q0 in enumerate(range(0, q.shape[1], 64)):
        if t == skip:
            continue
        rows = slice(q0, q0 + 64)
        dv += p[:, rows].bfloat16().float().transpose(-1, -2) @ do[:, rows]
        dk += ds[:, rows].bfloat16().float().transpose(-1, -2) @ q[:, rows]
    return (dk * scale).bfloat16(), dv.bfloat16()


def _dq_emulated(q, k, v, do, lse, delta, causal, scale, skip=None):
    """The tensor-core dQ's arithmetic: dS in f32, rounded to bf16 before
    dQ += dS K per 64-key tile (scaled after); dQ rounded to bf16 once;
    ``skip`` leaves one k tile out."""
    p = torch.exp(fa._scores(q, k, causal, scale) - lse[..., None])
    ds = p * (do @ v.transpose(-1, -2) - delta[..., None])
    dq = torch.zeros_like(q)
    for t, k0 in enumerate(range(0, k.shape[1], 64)):
        if t == skip:
            continue
        keys = slice(k0, k0 + 64)
        dq += ds[:, :, keys].bfloat16().float() @ k[:, keys]
    return (dq * scale).bfloat16()


def _packed_emulated(q, k, v, causal, scale, skip=None):
    """The tensor-core packed forward's arithmetic on head-pair slabs:
    the forward's (:func:`_fwd_emulated`) on each head of each pair."""
    o = _fwd_emulated(*(fp2.unpack_pairs(t) for t in (q, k, v)), causal,
                      scale, skip)
    return fp2.pack_pairs(o[None])


CASES = [(True, 192, 192, 64), (False, 192, 192, 64),
         (False, 128, 192, 64), (True, 128, 128, 128)]


@pytest.mark.parametrize("causal,s_q,s_k,d", CASES)
def test_rounding_bound_holds_the_emulated_kernels(smoke, causal, s_q, s_k,
                                                   d):
    q, k, v, do = _inputs(3, 2, s_q, s_k, d)
    scale = 1.0 / d ** 0.5
    ro, lse = fa.flash_fwd_plain(q, k, v, causal, scale)
    delta = (do * ro).sum(-1)
    rdk, rdv = fa.flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal, scale)
    r_o, r_dv, r_dk, _ = smoke.rounding_terms(fa, q, k, v, do, lse, delta,
                                              causal, scale)
    o = _fwd_emulated(q, k, v, causal, scale)
    dk, dv = _dkv_emulated(q, k, v, do, lse, delta, causal, scale)
    for out, ref, tol, rnd in ((o, ro, 2e-5, r_o), (dk, rdk, 2e-4, r_dk),
                               (dv, rdv, 2e-4, r_dv)):
        err, ok = smoke.close_rounded(out, ref, tol, rnd)
        assert ok, err
        # why the route needs its own bound: the rounding of P and dS
        # puts these outputs outside the unchanged bf16 bound
        assert not smoke.close(out, ref, "bf16", tol)[1]
    # the f32 plain outputs themselves are within the bound too
    for ref, tol, rnd in ((ro, 2e-5, r_o), (rdk, 2e-4, r_dk),
                          (rdv, 2e-4, r_dv)):
        assert smoke.close_rounded(ref, ref, tol, rnd)[1]


@pytest.mark.parametrize("causal,s_q,s_k,d", CASES)
def test_rounding_bound_fails_a_skipped_tile(smoke, causal, s_q, s_k, d):
    q, k, v, do = _inputs(4, 2, s_q, s_k, d)
    scale = 1.0 / d ** 0.5
    ro, lse = fa.flash_fwd_plain(q, k, v, causal, scale)
    delta = (do * ro).sum(-1)
    rdk, rdv = fa.flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal, scale)
    r_o, r_dv, r_dk, _ = smoke.rounding_terms(fa, q, k, v, do, lse, delta,
                                              causal, scale)
    last_k = (s_k - 1) // 64
    last_q = (s_q - 1) // 64
    o = _fwd_emulated(q, k, v, causal, scale, skip=last_k)
    dk, dv = _dkv_emulated(q, k, v, do, lse, delta, causal, scale,
                           skip=last_q)
    assert not smoke.close_rounded(o, ro, 2e-5, r_o)[1]
    assert not smoke.close_rounded(dk, rdk, 2e-4, r_dk)[1]
    assert not smoke.close_rounded(dv, rdv, 2e-4, r_dv)[1]


def _truncated(x):
    """x rounded towards zero to bf16 (as f32)."""
    return (x.float().view(torch.int32) & ~0xFFFF).view(torch.float32)


@pytest.mark.parametrize("causal,s_q,s_k,d", CASES)
def test_rounding_bound_fails_a_truncated_output(smoke, causal, s_q, s_k,
                                                 d):
    q, k, v, do = _inputs(5, 2, s_q, s_k, d)
    scale = 1.0 / d ** 0.5
    ro, lse = fa.flash_fwd_plain(q, k, v, causal, scale)
    delta = (do * ro).sum(-1)
    rdk, rdv = fa.flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal, scale)
    r_o, r_dv, r_dk, _ = smoke.rounding_terms(fa, q, k, v, do, lse, delta,
                                              causal, scale)
    for ref, tol, rnd in ((ro, 2e-5, r_o), (rdk, 2e-4, r_dk),
                          (rdv, 2e-4, r_dv)):
        assert smoke.close_rounded(ref.bfloat16(), ref, tol, rnd)[1]
        assert not smoke.close_rounded(_truncated(ref), ref, tol, rnd)[1]


def _dq_case(seed, causal, s_q, s_k, d):
    """Inputs, the plain dQ and its rounding term for one case."""
    q, k, v, do = _inputs(seed, 2, s_q, s_k, d)
    scale = 1.0 / d ** 0.5
    ro, lse = fa.flash_fwd_plain(q, k, v, causal, scale)
    delta = (do * ro).sum(-1)
    rdq = fa.flash_bwd_dq_plain(q, k, v, do, lse, delta, causal, scale)
    return (q, k, v, do, lse, delta, scale), rdq


@pytest.mark.parametrize("causal,s_q,s_k,d", CASES)
def test_rounding_bound_holds_the_emulated_dq(smoke, causal, s_q, s_k, d):
    args, rdq = _dq_case(3, causal, s_q, s_k, d)
    q, k, v, do, lse, delta, scale = args
    r_dq = smoke.rounding_terms(fa, q, k, v, do, lse, delta, causal,
                                scale)[3]
    dq = _dq_emulated(q, k, v, do, lse, delta, causal, scale)
    err, ok = smoke.close_rounded(dq, rdq, 2e-4, r_dq)
    assert ok, err
    # the rounding of dS puts dQ outside the unchanged bf16 bound
    assert not smoke.close(dq, rdq, "bf16", 2e-4)[1]
    assert smoke.close_rounded(rdq, rdq, 2e-4, r_dq)[1]


@pytest.mark.parametrize("causal,s_q,s_k,d", CASES)
def test_rounding_bound_fails_a_dq_with_a_skipped_tile(smoke, causal, s_q,
                                                       s_k, d):
    args, rdq = _dq_case(4, causal, s_q, s_k, d)
    q, k, v, do, lse, delta, scale = args
    r_dq = smoke.rounding_terms(fa, q, k, v, do, lse, delta, causal,
                                scale)[3]
    dq = _dq_emulated(q, k, v, do, lse, delta, causal, scale,
                      skip=(s_k - 1) // 64)
    assert not smoke.close_rounded(dq, rdq, 2e-4, r_dq)[1]


@pytest.mark.parametrize("causal,s_q,s_k,d", CASES)
def test_rounding_bound_fails_a_truncated_dq(smoke, causal, s_q, s_k, d):
    args, rdq = _dq_case(5, causal, s_q, s_k, d)
    r_dq = smoke.rounding_terms(fa, *args[:6], causal, args[6])[3]
    assert smoke.close_rounded(rdq.bfloat16(), rdq, 2e-4, r_dq)[1]
    assert not smoke.close_rounded(_truncated(rdq), rdq, 2e-4, r_dq)[1]


PACKED_CASES = [(True, 192, 192), (False, 192, 192), (False, 128, 192)]


def _packed_case(seed, causal, s_q, s_k):
    """Head-pair slabs of two pairs (d 64 per head), the plain output and
    its rounding term (``chip_smoke.packed_rounding``)."""
    q, k, v, _ = _inputs(seed, 2, s_q, s_k, 128)
    ro = fp2.packed_flash_fwd_plain(q, k, v, causal, 0.125)
    return (q, k, v), ro


@pytest.mark.parametrize("causal,s_q,s_k", PACKED_CASES)
def test_rounding_bound_holds_the_emulated_packed_forward(smoke, causal, s_q,
                                                          s_k):
    (q, k, v), ro = _packed_case(6, causal, s_q, s_k)
    rnd = smoke.packed_rounding(fa, fp2, q, k, v, causal, 0.125)
    assert rnd.shape == ro.shape
    o = _packed_emulated(q, k, v, causal, 0.125)
    err, ok = smoke.close_rounded(o, ro, 2e-5, rnd)
    assert ok, err
    assert not smoke.close(o, ro, "bf16", 2e-5)[1]
    assert smoke.close_rounded(ro, ro, 2e-5, rnd)[1]


@pytest.mark.parametrize("causal,s_q,s_k", PACKED_CASES)
def test_rounding_bound_fails_a_packed_forward_with_a_skipped_tile(
        smoke, causal, s_q, s_k):
    (q, k, v), ro = _packed_case(7, causal, s_q, s_k)
    rnd = smoke.packed_rounding(fa, fp2, q, k, v, causal, 0.125)
    o = _packed_emulated(q, k, v, causal, 0.125, skip=(s_k - 1) // 64)
    assert not smoke.close_rounded(o, ro, 2e-5, rnd)[1]


@pytest.mark.parametrize("causal,s_q,s_k", PACKED_CASES)
def test_rounding_bound_fails_a_truncated_packed_forward(smoke, causal, s_q,
                                                         s_k):
    (q, k, v), ro = _packed_case(8, causal, s_q, s_k)
    rnd = smoke.packed_rounding(fa, fp2, q, k, v, causal, 0.125)
    assert smoke.close_rounded(ro.bfloat16(), ro, 2e-5, rnd)[1]
    assert not smoke.close_rounded(_truncated(ro), ro, 2e-5, rnd)[1]
