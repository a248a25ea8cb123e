"""The route of the port's flash kernels and the bound that holds the
tensor-core route on the card, on the CPU.

``_tc_route`` decides before any launch which kernel a CUDA call takes:
bf16 with head_dim 64 or 128 goes to the tensor-core (``wgmma``) forward
and dK/dV, everything else to the CUDA-core ones. CPU tensors run the
plain versions and count no launch on either route.

The tensor-core kernels round P (and dS) to bf16 before the second
product, so ``chip_smoke.py`` holds their bf16 outputs to
``close_rounded``: the f32 bound plus half a bf16 ulp plus 2^-8 of the
same product over magnitudes. Here a plain emulation of the kernels'
arithmetic (64-key tiles, the online softmax with its running max, P
rounded to bf16 before P V; P^T and dS^T rounded before dV and dK; the
outputs rounded to bf16 once), on numpy-seeded inputs, stays within
that bound, and the same emulation with one tile left out does not; nor
does the f32 result truncated to bf16, which the bound's width would
take but its bias check does not.
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops.cuda import flash_attention as fa

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
    r_o, r_dv, r_dk = smoke.rounding_terms(fa, q, k, v, do, lse, delta,
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
    r_o, r_dv, r_dk = smoke.rounding_terms(fa, q, k, v, do, lse, delta,
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
    r_o, r_dv, r_dk = smoke.rounding_terms(fa, q, k, v, do, lse, delta,
                                           causal, scale)
    for ref, tol, rnd in ((ro, 2e-5, r_o), (rdk, 2e-4, r_dk),
                          (rdv, 2e-4, r_dv)):
        assert smoke.close_rounded(ref.bfloat16(), ref, tol, rnd)[1]
        assert not smoke.close_rounded(_truncated(ref), ref, tol, rnd)[1]
