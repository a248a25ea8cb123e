"""The port's ``GradScaler`` (``paddle_tpu_torch/amp/grad_scaler.py``)
against the JAX package's on the CPU: the loss scale, the skipped
updates and the ``state_dict`` over a sequence of steps with injected
inf and NaN gradients, bit for bit in the scale and within float32
rounding in the parameters (tolerance 1e-6: Momentum's update from
gradients divided by a power of two, which both divide exactly); the
double unscale after a manual ``unscale_``, which both keep; the refusal
under a CUDA graph capture; and the port's flash attention at fp16
against the reference's, which ``chip_smoke.py`` runs in an O1 fp16 GPT
step."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import amp as jamp
from paddle_tpu import optimizer as jopt
from paddle_tpu.dygraph.tensor import Parameter as JParameter
from paddle_tpu.dygraph.tensor import Tensor
from paddle_tpu.ops.pallas import flash_attention as jflash
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.amp import grad_scaler as tgs
from paddle_tpu_torch.ops.cuda import flash_attention as tfa

SHAPES = [(4, 3), (5,)]


def _pair(**kw):
    rng = np.random.RandomState(0)
    init = [rng.randn(*s).astype(np.float32) for s in SHAPES]
    jps = [JParameter(jnp.asarray(a), name=f"p{i}")
           for i, a in enumerate(init)]
    tps = [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in init]
    jo = jopt.Momentum(learning_rate=0.1, momentum=0.9, parameters=jps)
    to = topt.Momentum(learning_rate=0.1, momentum=0.9,
                       parameters=[(f"p{i}", p) for i, p in enumerate(tps)])
    return (jps, jo, jamp.GradScaler(**kw)), (tps, to, tamp.GradScaler(**kw))


def _scaled_grads(rng, scale, bad):
    gs = [(rng.randn(*s) * 0.1 * scale).astype(np.float32) for s in SHAPES]
    if bad:
        gs[bad % 2].flat[1] = np.inf if bad > 0 else np.nan
    return gs


def test_scale_skip_and_state_follow_the_reference():
    """Ten steps, inf or NaN injected at steps 2, 3, 6 and 7: a bad step
    leaves every parameter and velocity unchanged; two bad steps in a row
    halve the scale; three good ones double it."""
    kw = dict(init_loss_scaling=2.0 ** 10, incr_every_n_steps=3,
              decr_every_n_nan_or_inf=2)
    (jps, jo, js), (tps, to, ts) = _pair(**kw)
    rng = np.random.RandomState(1)
    bad_at = {2: 1, 3: -1, 6: 2, 7: 1}
    scales = []
    for step in range(10):
        bad = bad_at.get(step, 0)
        assert ts.get_loss_scaling() == js.get_loss_scaling()
        gs = _scaled_grads(rng, js.get_loss_scaling(), bad)
        for jp, tp, g in zip(jps, tps, gs):
            jp.grad = Tensor(jnp.asarray(g))
            tp.grad = torch.from_numpy(g.copy())
        before = [tp.detach().clone() for tp in tps]
        vel = {k: v.clone() for k, v in to.state_dict().items()
               if k != "_lr"}
        js.step(jo)
        ts.step(to)
        assert ts._found_inf == bool(bad) == js._found_inf
        if bad:
            assert all(torch.equal(a, b.detach())
                       for a, b in zip(before, tps))
            assert all(torch.equal(v, to.state_dict()[k])
                       for k, v in vel.items())
        for jp, tp in zip(jps, tps):
            np.testing.assert_allclose(tp.detach().numpy(),
                                       np.asarray(jp.value), rtol=0,
                                       atol=1e-6)
        assert ts.state_dict() == js.state_dict()
        scales.append(ts.get_loss_scaling())
    assert scales == [1024.0, 1024.0, 1024.0, 512.0, 512.0, 512.0, 512.0,
                      256.0, 256.0, 256.0]
    restored = tamp.GradScaler(**kw)
    restored.load_state_dict(ts.state_dict())
    assert restored.state_dict() == ts.state_dict()
    assert tamp.AmpScaler is tamp.GradScaler


def test_step_after_a_manual_unscale_unscales_again():
    """The reference's ``step`` calls ``unscale_`` itself, so a manual
    ``unscale_`` first divides the gradients twice (kept, ROADMAP queue
    C); ``scale`` multiplies the loss, and a disabled scaler is a
    pass-through."""
    (jps, jo, js), (tps, to, ts) = _pair(init_loss_scaling=4.0)
    g = np.full(SHAPES[0], 8.0, np.float32)
    jps[0].grad = Tensor(jnp.asarray(g))
    tps[0].grad = torch.from_numpy(g.copy())
    js.unscale_(jo)
    ts.unscale_(to)
    assert float(tps[0].grad[0, 0]) == float(jps[0].grad.value[0, 0]) == 2.0
    js.step(jo)
    ts.step(to)
    np.testing.assert_allclose(tps[0].detach().numpy(),
                               np.asarray(jps[0].value), rtol=0, atol=1e-7)
    assert float(ts.scale(torch.tensor(1.5))) == 6.0
    off = tamp.GradScaler(enable=False)
    loss = torch.tensor(2.0)
    assert off.scale(loss) is loss and not off.is_enable()
    ts.unscale_([tps[0]])
    ts.unscale_([("p0", tps[0])])


def test_unscale_raises_under_capture(monkeypatch):
    """The finite check is a host read, which a CUDA graph capture cannot
    make: ``unscale_`` (and so ``step``) raises instead of moving the
    check onto the device."""
    (_, _, _), (tps, to, ts) = _pair()
    tps[0].grad = torch.ones(SHAPES[0])
    monkeypatch.setattr(tgs, "capturing", lambda: True)
    with pytest.raises(RuntimeError, match="capture"):
        ts.unscale_(to)
    with pytest.raises(RuntimeError, match="capture"):
        ts.step(to)


def test_flash_refuses_fp16_where_the_reference_takes_it():
    """Named after a fault of the port that is now repaired: the
    reference's Pallas flash attention takes any float dtype, fp16
    included (it computes in f32 and returns the input's dtype), and the
    port's CUDA-core kernels now take fp16 too. Here the port's fp16
    plain version (what those kernels compute) holds the JAX kernel in
    interpret mode, forward and the gradients of q, k and v, causal and
    not, to 2e-3 of the largest magnitude of each output: two fp16
    roundings (2 x 2^-11 ~ 1e-3) of values computed in f32 on both
    sides, in different orders."""
    import jax
    rng = np.random.RandomState(2)
    q, k, v, do = (rng.randn(2, 32, 16).astype(np.float16) for _ in range(4))
    t = [torch.from_numpy(a.copy()).requires_grad_() for a in (q, k, v)]
    tfa._check(*(a.detach() for a in t), False)   # fp16 is accepted
    for causal in (False, True):
        def fwd(q, k, v):
            return jflash(q, k, v, causal=causal, block_q=16, block_k=16)
        out, vjp = jax.vjp(fwd, *(jnp.asarray(a) for a in (q, k, v)))
        grads = vjp(jnp.asarray(do))
        assert out.dtype == jnp.float16
        for a in t:
            a.grad = None
        tout = tfa.flash_attention(*t, causal=causal, block_q=16,
                                   block_k=16)
        tout.backward(torch.from_numpy(do))
        assert tout.dtype == torch.float16
        for got, want in zip([tout] + [a.grad for a in t],
                             [out] + list(grads)):
            want = np.asarray(want).astype(np.float32)
            assert got.dtype == torch.float16
            got = got.detach().float().numpy()
            assert np.isfinite(got).all()
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=2e-3 * np.abs(want).max())
