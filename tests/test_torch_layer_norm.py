"""The port's fused LayerNorm against the JAX package on the CPU: the
plain functions the CUDA kernels compute, through the port's
``fused_layer_norm_with_stats`` and its ``autograd.Function``, against
``paddle_tpu.ops.pallas.layer_norm`` run in Pallas interpret mode (as
``tests/test_pallas_kernels.py`` runs it), and the route of
``nn.functional.layer_norm`` against the JAX op's predicate.

Tolerances: f32 y, mean and variance within 1e-5, dx/dgamma/dbeta
against ``jax.grad`` within 1e-4 (the tolerances of
``test_pallas_kernels.py``): the sides differ only in the order of
summation. bf16: both sides compute in f32 from the same bf16 values
and round each output once, so an element may land one bf16 step
(2^-7 relative) apart: held to 2^-7 |ref| plus the f32 tolerance.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.flags as jflags
from paddle_tpu.dygraph.tensor import Tensor
from paddle_tpu.nn import functional as JF
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.ops.cuda import layer_norm as tln

# the package re-exports names over the module's, so load it by path
jln = importlib.import_module("paddle_tpu.ops.pallas.layer_norm")

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _pair(a, dt):
    """The same values as a JAX array and a torch tensor of dtype ``dt``."""
    jdt, tdt = DTYPES[dt]
    j = jnp.asarray(a, jdt)
    return j, torch.from_numpy(np.array(j, np.float32)).to(tdt)


def _inputs(seed, n, h):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, h).astype(np.float32) * 2 + 0.5,
            (rng.rand(h) + 0.5).astype(np.float32),
            rng.randn(h).astype(np.float32),
            rng.randn(n, h).astype(np.float32))


def _close(out, ref, dt, tol):
    out = np.asarray(out, np.float32)
    ref = np.asarray(ref, np.float32)
    assert out.shape == ref.shape
    ulp = 2.0 ** -7 if dt == "bf16" else 0.0
    assert np.all(np.abs(out - ref) <= tol + tol * np.abs(ref)
                  + ulp * np.abs(ref)), np.abs(out - ref).max()


def _both(x, g, b, w, xdt, gdt):
    """``(y, mean, var)`` and ``(dx, dgamma, dbeta)`` of ``sum(y * w)`` on
    each side."""
    (jx, tx), (jg, tg), (jb, tb) = _pair(x, xdt), _pair(g, gdt), _pair(b, gdt)
    jw = jnp.asarray(w)
    jout = jln.fused_layer_norm_with_stats(jx, jg, jb)
    jgrads = jax.grad(
        lambda *a: jnp.sum(jln.fused_layer_norm(*a).astype(jnp.float32)
                           * jw), argnums=(0, 1, 2))(jx, jg, jb)
    leaves = [t.requires_grad_() for t in (tx, tg, tb)]
    tout = tln.fused_layer_norm_with_stats(*leaves)
    (tout[0].float() * torch.from_numpy(w)).sum().backward()
    return jout, jgrads, tout, [t.grad for t in leaves]


@pytest.mark.parametrize("h", [128, 768])
@pytest.mark.parametrize("n", [48, 37, 256])
def test_matches_the_pallas_kernels_f32(n, h):
    x, g, b, w = _inputs(n + h, n, h)
    jout, jgrads, tout, tgrads = _both(x, g, b, w, "f32", "f32")
    assert [t.dtype for t in tout] == [torch.float32] * 3
    assert [tuple(t.shape) for t in tout] == [(n, h), (n,), (n,)]
    for j, t in zip(jout, tout):
        _close(t.detach(), j, "f32", 1e-5)
    for j, t, name in zip(jgrads, tgrads, ("dx", "dgamma", "dbeta")):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-4,
                                   atol=1e-4, err_msg=name)


@pytest.mark.parametrize("gdt", ["bf16", "f32"])
def test_matches_the_pallas_kernels_bf16_input(gdt):
    """bf16 rows with gamma/beta in bf16 or f32: y and dx in bf16, the
    statistics f32, dgamma/dbeta in gamma's dtype."""
    x, g, b, w = _inputs(5, 48, 128)
    jout, jgrads, tout, tgrads = _both(x, g, b, w, "bf16", gdt)
    assert tout[0].dtype == torch.bfloat16
    assert tout[1].dtype == tout[2].dtype == torch.float32
    _close(tout[0].detach().float(), jout[0], "bf16", 1e-5)
    for j, t in zip(jout[1:], tout[1:]):
        _close(t, j, "f32", 1e-5)
    assert tgrads[0].dtype == torch.bfloat16
    assert tgrads[1].dtype == tgrads[2].dtype == DTYPES[gdt][1]
    for j, t in zip(jgrads, tgrads):
        _close(t.float(), j, "bf16", 1e-4)


@pytest.mark.parametrize("lead", [(6,), (2, 3)])
@pytest.mark.parametrize("h", [64, 128])
@pytest.mark.parametrize("flag", [False, True])
def test_route_follows_the_jax_predicate(monkeypatch, flag, h, lead):
    """With ``h % 128 == 0`` and ``use_pallas_layer_norm`` on, both sides
    take the kernel (the port's plain version here on the CPU) on the
    rows of a 2-D or 3-D input; otherwise both compose. The outputs agree
    either way."""
    calls = {"jax": 0, "torch": 0}

    def spy(side, real):
        def wrapped(*a, **kw):
            calls[side] += 1
            return real(*a, **kw)
        return wrapped

    monkeypatch.setattr(jln, "fused_layer_norm_with_stats",
                        spy("jax", jln.fused_layer_norm_with_stats))
    monkeypatch.setattr(tln, "ln_fwd_plain", spy("torch", tln.ln_fwd_plain))
    saved = (jflags.get_flag("use_pallas_layer_norm"),
             tflags.get_flag("use_pallas_layer_norm"))
    jflags.set_flags({"use_pallas_layer_norm": flag})
    tflags.set_flags({"use_pallas_layer_norm": flag})
    try:
        x, g, b, _ = _inputs(h, 6, h)
        x = x.reshape(*lead, h)
        jy = JF.layer_norm(Tensor(jnp.asarray(x)), [h],
                           Tensor(jnp.asarray(g)), Tensor(jnp.asarray(b)))
        ty = TF.layer_norm(torch.from_numpy(x), torch.from_numpy(g),
                           torch.from_numpy(b))
    finally:
        jflags.set_flags({"use_pallas_layer_norm": saved[0]})
        tflags.set_flags({"use_pallas_layer_norm": saved[1]})
    kernel = flag and h % 128 == 0
    assert calls == {"jax": int(kernel), "torch": int(kernel)}
    assert ty.shape == x.shape
    _close(ty, jy.value, "f32", 1e-5)
