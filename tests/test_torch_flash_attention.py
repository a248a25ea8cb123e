"""The port's flash attention against the JAX package on the CPU: the
three plain functions (what the CUDA kernels compute) against the Pallas
kernels ``_flash_fwd`` / ``_flash_bwd`` run in interpret mode, the
differentiable ``flash_attention`` against ``jax.grad`` of the
reference's, and ``fused_attention_qkv``'s routing against the JAX op's.

Tolerances: f32 ``|out - ref| <= 2e-5 + 2e-5 |ref|`` forward and 2e-4 for
gradients (``tests/test_pallas_kernels.py``): the two sides differ only
in the order of summation. bf16 inputs: both sides compute in f32 from
the same bf16 values and round the result to bf16, so a result may sit
one bf16 step (2^-8 relative) apart; held within 1e-2 of the largest
``|ref|``.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.flags as jflags
from paddle_tpu.ops import registry as jreg
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch.ops import attention_ops as tops
from paddle_tpu_torch.ops.cuda import flash_attention as tfa

# the package re-exports the function under the module's name
jfa = importlib.import_module("paddle_tpu.ops.pallas.flash_attention")

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(seed, bh, s_q, s_k, d, n=4):
    rng = np.random.RandomState(seed)
    return [rng.randn(bh, s, d).astype(np.float32)
            for s in (s_q, s_k, s_k, s_q)[:n]]


def _pair(a, dt):
    """The same values as a JAX array and a torch tensor of dtype ``dt``."""
    jdt, tdt = DTYPES[dt]
    j = jnp.asarray(a, jdt)
    return j, torch.from_numpy(np.array(j, np.float32)).to(tdt)


def _close(out, ref, dt, tol):
    out = np.asarray(out, np.float32)
    ref = np.asarray(ref, np.float32)
    assert out.shape == ref.shape
    if dt == "f32":
        np.testing.assert_allclose(out, ref, rtol=tol, atol=tol)
    else:
        assert np.abs(out - ref).max() <= 1e-2 * np.abs(ref).max()


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("causal", [False, True])
def test_plain_functions_match_the_pallas_kernels(causal, dt):
    """Forward (O, lse), dQ and dK/dV of the plain functions against the
    reference kernels on the same inputs, the backward fed the same
    lse and delta on both sides."""
    bh, s, d = 6, 128, 32
    scale = 1.0 / np.sqrt(d)
    (jq, tq), (jk, tk), (jv, tv), (jdo, tdo) = (
        _pair(a, dt) for a in _inputs(0, bh, s, s, d))
    jo, jlse = jfa._flash_fwd(jq, jk, jv, causal, scale, 32, 32)
    to, tlse = tfa.flash_fwd_plain(tq, tk, tv, causal, scale)
    assert to.dtype == tq.dtype and tlse.dtype == torch.float32
    _close(to.float(), jo, dt, 2e-5)
    _close(tlse, np.asarray(jlse)[:, 0], "f32", 2e-5)

    jdq, jdk, jdv = jfa._flash_bwd(causal, scale, 32, 32,
                                   (jq, jk, jv, jo, jlse), jdo)
    to = torch.from_numpy(np.array(jo, np.float32)).to(tq.dtype)
    lse = torch.from_numpy(np.array(jlse)[:, 0])
    delta = (tdo.float() * to.float()).sum(-1)
    tdq = tfa.flash_bwd_dq_plain(tq, tk, tv, tdo, lse, delta, causal, scale)
    tdk, tdv = tfa.flash_bwd_dkv_plain(tq, tk, tv, tdo, lse, delta, causal,
                                       scale)
    for out, ref in ((tdq, jdq), (tdk, jdk), (tdv, jdv)):
        assert out.dtype == tq.dtype
        _close(out.float(), ref, dt, 2e-4)


@pytest.mark.parametrize("causal,s_q,s_k,d", [
    (True, 128, 128, 32),
    (False, 128, 128, 32),
    (False, 64, 128, 32),     # cross shape, non-causal only
    (True, 80, 80, 20),       # ragged: 80 tiles only by 16; d unaligned
])
def test_flash_attention_grad_matches_jax_grad(causal, s_q, s_k, d):
    """The autograd.Function (plain functions on CPU tensors) against
    ``jax.grad`` of the reference's ``flash_attention`` in f32."""
    b, h = 2, 3
    rng = np.random.RandomState(1)
    q, k, v = (rng.randn(b, h, s, d).astype(np.float32)
               for s in (s_q, s_k, s_k))
    w = rng.randn(b, h, s_q, d).astype(np.float32)

    def jloss(q, k, v):
        o = jfa.flash_attention(q, k, v, causal=causal, block_q=32,
                                block_k=32)
        return jnp.sum(o * w)

    jo = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=causal, block_q=32, block_k=32)
    jg = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                            jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    before = dict(tfa.launches)
    to = tfa.flash_attention(tq, tk, tv, causal=causal, block_q=32,
                             block_k=32)
    (to * torch.from_numpy(w)).sum().backward()
    assert tfa.launches == before          # CPU tensors launch nothing
    _close(to.detach(), jo, "f32", 2e-5)
    for t, g in zip((tq, tk, tv), jg):
        _close(t.grad, g, "f32", 2e-4)


def test_flash_attention_rejects_what_the_reference_rejects():
    q = torch.zeros(1, 1, 100, 32)
    with pytest.raises(ValueError, match="cannot tile"):
        tfa.flash_attention(q, q, q, block_q=64, block_k=64)
    with pytest.raises(ValueError, match="seq_q == seq_k"):
        tfa.flash_attention(torch.zeros(1, 1, 32, 8), torch.zeros(1, 1, 64, 8),
                            torch.zeros(1, 1, 64, 8), causal=True)
    with pytest.raises(ValueError, match="head_dim"):
        z = torch.zeros(1, 1, 32, 160)
        tfa.flash_attention(z, z, z)


@pytest.fixture
def low_min_seq():
    """Flash route from 64 tokens with 32-row blocks, on both sides."""
    names = ["use_pallas_attention", "pallas_min_seq", "pallas_flash_block_q",
             "pallas_flash_block_k"]
    saved = (jflags.get_flags(names), tflags.get_flags(names))
    new = {"use_pallas_attention": True, "pallas_min_seq": 64,
           "pallas_flash_block_q": 32, "pallas_flash_block_k": 32}
    jflags.set_flags(new)
    tflags.set_flags(new)
    yield
    jflags.set_flags(saved[0])
    tflags.set_flags(saved[1])


ROUTES = [
    # (name, s_q, s_k, mask, causal, flags) -> the JAX op decides
    ("admitted causal", 64, 64, False, True, {}),
    ("admitted non-causal", 128, 128, False, False, {}),
    ("ragged but tileable", 80, 80, False, True, {}),
    ("below pallas_min_seq", 48, 48, False, True, {}),
    ("seq_q != seq_k", 64, 128, False, False, {}),
    ("masked", 64, 64, True, False, {}),
    ("untileable", 72, 72, False, True, {}),
    ("flag off", 64, 64, False, True, {"use_pallas_attention": False}),
]


@pytest.mark.parametrize("name,s_q,s_k,masked,causal,extra", ROUTES,
                         ids=[r[0] for r in ROUTES])
def test_fused_attention_qkv_routes_as_the_jax_op(
        low_min_seq, monkeypatch, name, s_q, s_k, masked, causal, extra):
    """The port takes the flash route exactly where the JAX op's flash
    call succeeds (its caught ValueError counts as the composed route),
    and both return the same output."""
    jflags.set_flags(extra)
    tflags.set_flags(extra)
    jcalls, tcalls = [], []
    real_j, real_t = jfa.flash_attention, tops.flash_attention

    def jspy(*a, **kw):
        out = real_j(*a, **kw)           # raises for untileable shapes
        jcalls.append(name)
        return out

    def tspy(*a, **kw):
        tcalls.append(name)
        return real_t(*a, **kw)

    monkeypatch.setattr(jfa, "flash_attention", jspy)
    monkeypatch.setattr(tops, "flash_attention", tspy)
    rng = np.random.RandomState(2)
    q = rng.randn(1, 2, s_q, 16).astype(np.float32)
    k, v = (rng.randn(1, 2, s_k, 16).astype(np.float32) for _ in range(2))
    mask = (np.triu(np.full((s_q, s_k), -1e9, np.float32), 1)[None, None]
            if masked else None)
    ins = {"Q": [jnp.asarray(q)], "K": [jnp.asarray(k)],
           "V": [jnp.asarray(v)]}
    if masked:
        ins["Mask"] = [jnp.asarray(mask)]
    ref = jreg.execute(jreg.LoweringContext(eager=True),
                       "fused_attention_qkv", ins, {"causal": causal})
    out = tops.fused_attention_qkv(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        None if mask is None else torch.from_numpy(mask), causal=causal)
    assert bool(tcalls) == bool(jcalls), (tcalls, jcalls)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref["Out"][0]),
                               rtol=2e-5, atol=2e-5)


def test_fused_attention_qkv_never_catches(low_min_seq, monkeypatch):
    """A shape the predicate admits launches the kernel or raises; the
    composed form is not a fallback."""
    def refuse(*a, **kw):
        raise ValueError("kernel refused")

    monkeypatch.setattr(tops, "flash_attention", refuse)
    q = torch.zeros(1, 1, 64, 16)
    with pytest.raises(ValueError, match="kernel refused"):
        tops.fused_attention_qkv(q, q, q, causal=True)
    tops.fused_attention_qkv(torch.zeros(1, 1, 48, 16),
                             torch.zeros(1, 1, 48, 16),
                             torch.zeros(1, 1, 48, 16), causal=True)
