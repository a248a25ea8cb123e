"""The port's optimizer plane (``paddle_tpu_torch.optimizer``,
``ops/optimizer_ops.py``) against the JAX package's on the CPU: every
update op against its JAX lowering, every eager optimizer over three
steps with clipping, L1/L2 regularization, ``lr_scale``, a frozen
parameter and a scheduler stepped between steps, ``state_dict`` carried
across with ``models/convert.py``, the clips in f32 and bf16, centered
RMSProp's refusal, and the learning rate a ``to_static`` step reads.

Inputs come from numpy seeds. Tolerances: float32 results within 2e-6
relative plus 1e-7 absolute per op (the norms of LARS and LAMB sum in
another order than XLA's, and ``pow(x, 0.5)`` is a square root in torch);
after three optimizer steps parameters and state within 2e-6 relative
plus 2e-6 absolute (bf16 moments: 2^-8 relative, one bf16 rounding of a
product that differs in its last float32 bits); a bf16 clip within
2^-7 relative (one bf16 ulp: the per-tensor sums round once in torch
and on every add in the reference's Python ``sum``).
"""

import torch_threads  # noqa: F401  (one worker's share of the cores)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import jit as jjit
from paddle_tpu import optimizer as jopt
from paddle_tpu.dygraph.tensor import Parameter as JParameter
from paddle_tpu.dygraph.tensor import Tensor
from paddle_tpu.ops import optimizer_ops as jops
from paddle_tpu_torch import jit as tjit
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.models.convert import optimizer_state_from_numpy
from paddle_tpu_torch.ops import optimizer_ops as tops

SHAPES = [(5, 4), (4,), (3, 2, 2), (6,)]
OP_TOL = dict(rtol=2e-6, atol=1e-7)
STEP_TOL = dict(rtol=2e-6, atol=2e-6)


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


# ------------------------------------------------------------- update ops

def _op_inputs(seed, n=37):
    rng = np.random.RandomState(seed)
    return {"p": rng.randn(n).astype(np.float32),
            "g": (rng.randn(n) * 0.1).astype(np.float32),
            "a": (rng.randn(n) * 0.01).astype(np.float32),
            "s": (rng.rand(n) * 0.01 + 1e-3).astype(np.float32),
            "lr": np.asarray([0.05], np.float32)}


# (name, JAX op, JAX input slots beyond Param/Grad/LearningRate, attrs,
#  port call) -- the accumulators are "a" (signed) or "s" (positive)
OPS = [
    ("sgd", jops._sgd, [], {}, lambda x: tops.sgd(x["p"], x["g"], x["lr"])),
    ("momentum", jops._momentum, [("Velocity", "a")], {"mu": 0.8},
     lambda x: tops.momentum(x["p"], x["g"], x["a"], x["lr"], 0.8)),
    ("nesterov", jops._momentum, [("Velocity", "a")],
     {"mu": 0.8, "use_nesterov": True},
     lambda x: tops.momentum(x["p"], x["g"], x["a"], x["lr"], 0.8, True)),
    ("lars_momentum", jops._lars_momentum, [("Velocity", "a")],
     {"mu": 0.9, "lars_coeff": 0.002, "lars_weight_decay": 0.001},
     lambda x: tops.lars_momentum(x["p"], x["g"], x["a"], x["lr"], 0.9,
                                  0.002, 0.001)),
    ("adagrad", jops._adagrad, [("Moment", "s")], {"epsilon": 1e-6},
     lambda x: tops.adagrad(x["p"], x["g"], x["s"], x["lr"], 1e-6)),
    ("rmsprop", jops._rmsprop, [("MeanSquare", "s"), ("Moment", "a")],
     {"decay": 0.95, "epsilon": 1e-6, "momentum": 0.5},
     lambda x: tops.rmsprop(x["p"], x["g"], x["s"], x["a"], x["lr"], 0.95,
                            1e-6, 0.5)),
    ("ftrl", jops._ftrl, [("SquaredAccumulator", "s"),
                          ("LinearAccumulator", "a")],
     {"l1": 0.01, "l2": 0.02, "lr_power": -0.5},
     lambda x: tops.ftrl(x["p"], x["g"], x["s"], x["a"], x["lr"], 0.01,
                         0.02, -0.5)),
]
OUT_SLOTS = {"sgd": ["ParamOut"], "momentum": ["ParamOut", "VelocityOut"],
             "nesterov": ["ParamOut", "VelocityOut"],
             "lars_momentum": ["ParamOut", "VelocityOut"],
             "adagrad": ["ParamOut", "MomentOut"],
             "rmsprop": ["ParamOut", "MeanSquareOut", "MomentOut"],
             "ftrl": ["ParamOut", "SquaredAccumOut", "LinearAccumOut"]}


@pytest.mark.parametrize("name,jop,slots,attrs,call", OPS,
                         ids=[o[0] for o in OPS])
def test_update_op_matches_the_jax_lowering(name, jop, slots, attrs, call):
    x = _op_inputs(0)
    ins = {"Param": [jnp.asarray(x["p"])], "Grad": [jnp.asarray(x["g"])],
           "LearningRate": [jnp.asarray(x["lr"])]}
    for slot, key in slots:
        ins[slot] = [jnp.asarray(x[key])]
    want = jop(None, ins, attrs)
    got = call({k: _t(v) for k, v in x.items()})
    for slot, t in zip(OUT_SLOTS[name], got):
        assert t.dtype == torch.float32, slot
        np.testing.assert_allclose(t.numpy(), _np(want[slot][0]),
                                   err_msg=slot, **OP_TOL)


@pytest.mark.parametrize("mdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("first", [True, False])
def test_lamb_matches_the_jax_lowering(mdtype, first):
    """LAMB with f32 or bf16 moments, from fresh beta powers (1: both
    sides divide by 1 - 1 = 0 and agree on the infinities and NaNs) and
    from later ones."""
    x = _op_inputs(1)
    b1p = np.asarray([1.0 if first else 0.9 ** 4], np.float32)
    b2p = np.asarray([1.0 if first else 0.999 ** 4], np.float32)
    jd = jnp.bfloat16 if mdtype == "bfloat16" else jnp.float32
    td = getattr(torch, mdtype)
    m1 = x["a"]
    m2 = x["s"] * 1e-2
    ins = {"Param": [jnp.asarray(x["p"])], "Grad": [jnp.asarray(x["g"])],
           "LearningRate": [jnp.asarray(x["lr"])],
           "Moment1": [jnp.asarray(m1).astype(jd)],
           "Moment2": [jnp.asarray(m2).astype(jd)],
           "Beta1Pow": [jnp.asarray(b1p)], "Beta2Pow": [jnp.asarray(b2p)]}
    attrs = {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-6,
             "weight_decay": 0.01}
    want = jops._lamb(None, ins, attrs)
    got = tops.lamb(_t(x["p"]), _t(x["g"]), _t(m1, td), _t(m2, td),
                    _t(b1p), _t(b2p), _t(x["lr"]), 0.9, 0.999, 1e-6, 0.01)
    tol = OP_TOL if mdtype == "float32" else dict(rtol=2 ** -8, atol=1e-7)
    for slot, t in zip(["ParamOut", "Moment1Out", "Moment2Out",
                        "Beta1PowOut", "Beta2PowOut"], got):
        w = want[slot][0]
        assert str(t.dtype).replace("torch.", "") == str(w.dtype), slot
        got_np = np.nan_to_num(t.float().numpy(), posinf=1e30)
        np.testing.assert_allclose(got_np, np.nan_to_num(_np(w),
                                                         posinf=1e30),
                                   err_msg=slot, **tol)


# ---------------------------------------------------------- optimizers

OPTS = [("SGD", {}), ("Momentum", {"momentum": 0.9}),
        ("Momentum", {"momentum": 0.8, "use_nesterov": True}),
        ("LarsMomentum", {"lars_coeff": 0.01}),
        ("Adagrad", {}), ("Adam", {}), ("Adam", {"moment_dtype": "bfloat16"}),
        ("AdamW", {"weight_decay": 0.02}), ("Lamb", {}),
        ("RMSProp", {"momentum": 0.5}), ("Ftrl", {"l1": 0.01, "l2": 0.02})]
OPT_IDS = [f"{n}-{i}" for i, (n, _) in enumerate(OPTS)]


def _config(kind, side):
    """(grad_clip, weight_decay, per-parameter regularizer of p2) of one
    configuration, built from ``side``'s module (jopt or topt)."""
    if kind == "full":
        return side.GradientClipByGlobalNorm(0.3), 0.01, side.L1Decay(5e-3)
    if kind == "norm":
        return side.GradientClipByNorm(0.2), None, side.L2Decay(0.02)
    return side.GradientClipByValue(0.05), side.L1Decay(2e-3), None


def _pair(name, kw, kind, seed=0):
    """The JAX optimizer and the port's, each over its own copy of the
    same parameters: p1 at ``lr_scale`` 0.5, p2 with its own regularizer
    (where the config has one), p3 frozen (it keeps a gradient, which the
    global clip counts, as the reference's does), a StepDecay schedule."""
    rng = np.random.RandomState(seed)
    init = [rng.randn(*s).astype(np.float32) for s in SHAPES]
    jps = [JParameter(jnp.asarray(a), name=f"p{i}")
           for i, a in enumerate(init)]
    tps = [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in init]
    out = []
    for side, ps in ((jopt, jps), (topt, tps)):
        clip, wd, reg = _config(kind, side)
        ps[1].lr_scale = 0.5
        if reg is not None:
            ps[2].regularizer = reg
        sched = side.lr.StepDecay(0.05, step_size=2, gamma=0.5)
        args = dict(kw, learning_rate=sched, grad_clip=clip)
        if wd is not None and name != "AdamW":
            args["weight_decay"] = wd
        plist = ps if side is jopt else [(f"p{i}", p)
                                         for i, p in enumerate(ps)]
        out.append((getattr(side, name)(parameters=plist, **args), sched))
    jps[3].trainable = False
    jps[3].stop_gradient = True
    tps[3].requires_grad_(False)
    if name == "Lamb":
        _lamb_powers_after_one_step(out[0][0], out[1][0], jps, tps)
    return jps, tps, out


def _lamb_powers_after_one_step(jo, to, jps, tps):
    """Both LAMBs start from zero moments and beta powers beta^1 (what
    Paddle's own LAMB initializes): from powers 1, as both packages
    create them, the first step divides by 1 - 1 = 0
    (:func:`test_lamb_from_fresh_state_is_nan_in_both`)."""
    state = {"_lr": jo.get_lr()}
    for i, jp in enumerate(jps[:3]):          # p3 is frozen
        z = np.zeros(jp.value.shape, np.float32)
        state.update({f"p{i}:m1": z, f"p{i}:m2": z,
                      f"p{i}:b1p": np.asarray([0.9], np.float32),
                      f"p{i}:b2p": np.asarray([0.999], np.float32)})
    state.pop("_lr")
    jo.set_state_dict(state)
    to.set_state_dict(optimizer_state_from_numpy(
        state, {f"p{i}": f"p{i}" for i in range(3)}, "cpu"))


def _grads(rng):
    return [(rng.randn(*s) * 0.1).astype(np.float32) for s in SHAPES]


def _set_grads(jps, tps, grads):
    for jp, tp, g in zip(jps, tps, grads):
        jp.grad = Tensor(jnp.asarray(g))
        tp.grad = torch.from_numpy(g.copy())


def _hold_state(jo, to, tol=STEP_TOL):
    js = {k: v for k, v in jo.state_dict().items()}
    ts = to.state_dict()
    assert set(js) == set(ts)
    assert ts["_lr"] == js["_lr"]
    for k, v in js.items():
        if k == "_lr":
            continue
        assert str(ts[k].dtype).replace("torch.", "") == str(v.dtype), k
        np.testing.assert_allclose(ts[k].float().numpy(), _np(v),
                                   err_msg=k, **tol)


@pytest.mark.parametrize("kind", ["full", "norm", "value"])
@pytest.mark.parametrize("name,kw", OPTS, ids=OPT_IDS)
def test_optimizer_matches_jax_for_three_steps(name, kw, kind):
    jps, tps, ((jo, js), (to, ts)) = _pair(name, kw, kind)
    rng = np.random.RandomState(1)
    tol = STEP_TOL if kw.get("moment_dtype") is None else \
        dict(rtol=2 ** -8, atol=2e-6)
    frozen = tps[3].detach().clone()
    for step in range(3):
        _set_grads(jps, tps, _grads(rng))
        grads_before = [tp.grad for tp in tps]
        jo.step()
        to.step()
        assert [tp.grad for tp in tps] == grads_before   # not rebound
        for jp, tp in zip(jps, tps):
            np.testing.assert_allclose(tp.detach().numpy(), _np(jp.value),
                                       err_msg=f"step {step}", **tol)
        _hold_state(jo, to, tol)
        assert to.get_lr() == jo.get_lr()
        js.step()
        ts.step()
    assert torch.equal(tps[3].detach(), frozen)
    assert not any(k.startswith("p3:") for k in to.state_dict())


@pytest.mark.parametrize("name,kw", OPTS, ids=OPT_IDS)
def test_state_dict_carries_across_with_convert(name, kw):
    """One JAX step, its state carried into a fresh port optimizer over
    the JAX parameters' values (``optimizer_state_from_numpy``), then two
    more steps on both sides agree."""
    jps, tps, ((jo, js), (to, _)) = _pair(name, kw, "full", seed=3)
    rng = np.random.RandomState(4)
    _set_grads(jps, tps, _grads(rng))
    jo.step()
    js.step()
    with torch.no_grad():
        for jp, tp in zip(jps, tps):
            tp.copy_(torch.from_numpy(_np(jp.value)))
    state = {k: (v if k == "_lr" else np.array(v))
             for k, v in jo.state_dict().items()}
    clip, wd, _ = _config("full", topt)
    sched = topt.lr.StepDecay(0.05, step_size=2, gamma=0.5)
    sched.step()
    args = dict(kw, learning_rate=sched, grad_clip=clip)
    if name != "AdamW":
        args["weight_decay"] = wd
    fresh = getattr(topt, name)(
        parameters=[(f"p{i}", p) for i, p in enumerate(tps)], **args)
    fresh.set_state_dict(optimizer_state_from_numpy(
        state, {f"p{i}": f"p{i}" for i in range(len(tps))}, "cpu"))
    tol = STEP_TOL if kw.get("moment_dtype") is None else \
        dict(rtol=2 ** -8, atol=2e-6)
    _hold_state(jo, fresh, tol)
    for _ in range(2):
        _set_grads(jps, tps, _grads(rng))
        jo.step()
        fresh.step()
        for jp, tp in zip(jps, tps):
            np.testing.assert_allclose(tp.detach().numpy(), _np(jp.value),
                                       **tol)
        _hold_state(jo, fresh, tol)


def test_lamb_from_fresh_state_is_nan_in_both():
    """The reference's ``lamb`` op (``ops/optimizer_ops.py:123-124``)
    corrects the moments with the beta powers BEFORE the step, which a
    fresh optimizer creates as 1: the first step divides by 1 - 1 = 0 and
    every parameter becomes NaN. The port keeps the reference's
    arithmetic, so it does the same (a fault of both, ROADMAP queue C)."""
    init = np.linspace(-1, 1, 6).astype(np.float32)
    jp = JParameter(jnp.asarray(init), name="p")
    tp = torch.nn.Parameter(torch.from_numpy(init.copy()))
    jp.grad = Tensor(jnp.full(6, 0.1, jnp.float32))
    tp.grad = torch.full((6,), 0.1)
    jopt.Lamb(parameters=[jp]).step()
    topt.Lamb(parameters=[("p", tp)]).step()
    assert np.isnan(_np(jp.value)).all()
    assert torch.isnan(tp.detach()).all()


def test_centered_rmsprop_has_no_eager_step():
    p = torch.nn.Parameter(torch.zeros(3))
    p.grad = torch.ones(3)
    opt = topt.RMSProp(learning_rate=0.1, parameters=[("p", p)],
                       centered=True)
    with pytest.raises(NotImplementedError, match="no eager step"):
        opt.step()
    jp = JParameter(jnp.zeros(3), name="p")
    jp.grad = Tensor(jnp.ones(3))
    with pytest.raises(NotImplementedError, match="no eager step"):
        jopt.RMSProp(learning_rate=0.1, parameters=[jp],
                     centered=True).step()


def test_aliases_and_regularizer_resolution():
    for alias in ("SGD", "Momentum", "Adam", "AdamW", "Adagrad", "Lamb",
                  "RMSProp", "Ftrl", "LarsMomentum"):
        assert getattr(topt, alias) is getattr(topt, alias + "Optimizer")
    p = [("p", torch.nn.Parameter(torch.zeros(2)))]
    assert isinstance(topt.SGD(0.1, parameters=p,
                               weight_decay=0.1).regularization, topt.L2Decay)
    reg = topt.L1Decay(0.1)
    assert topt.SGD(0.1, parameters=p, weight_decay=reg).regularization \
        is reg
    assert topt.AdamW(parameters=p, weight_decay=0.1).regularization is None
    with pytest.raises(TypeError, match="named_parameters"):
        topt.Momentum(0.1, parameters=[p[0][1]])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_global_norm_clip_keeps_the_gradients_dtype(dtype):
    """GradientClipByGlobalNorm on f32 gradients (O2's master gradients)
    and on bf16 ones, which the reference clips in bf16 (``jnp.square``,
    ``jnp.sum`` and Python ``sum`` keep it): same dtype, same values
    within a float32 bound or one bf16 ulp."""
    rng = np.random.RandomState(5)
    gs = [rng.randn(*s).astype(np.float32) for s in SHAPES]
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    jps = [JParameter(jnp.zeros(s, jd), name=f"p{i}")
           for i, s in enumerate(SHAPES)]
    for jp, g in zip(jps, gs):
        jp.grad = Tensor(jnp.asarray(g).astype(jd))
    jopt.GradientClipByGlobalNorm(1.0)._clip_eager(jps)
    got = topt.GradientClipByGlobalNorm(1.0)._clip([_t(g, td) for g in gs])
    tol = OP_TOL if dtype == "float32" else dict(rtol=2 ** -7, atol=0)
    for jp, t in zip(jps, got):
        assert t.dtype == td
        np.testing.assert_allclose(t.float().numpy(), _np(jp.grad.value),
                                   **tol)
    for clip in ("GradientClipByNorm", "GradientClipByValue"):
        for jp, g in zip(jps, gs):
            jp.grad = Tensor(jnp.asarray(g).astype(jd))
        getattr(jopt, clip)(0.5)._clip_eager(jps)
        got = getattr(topt, clip)(0.5)._clip([_t(g, td) for g in gs])
        for jp, t in zip(jps, got):
            assert t.dtype == td
            np.testing.assert_allclose(t.float().numpy(),
                                       _np(jp.grad.value), **tol)


def test_adam_folds_the_global_clip_into_the_update(monkeypatch):
    """AdamW with GradientClipByGlobalNorm hands the kernel the clip
    factor (``grad_scale``) and the unclipped gradients; a regularized
    Adam clips first instead (the regularizer adds after the clip)."""
    seen = []
    real = topt._adamw_kernel.adamw_multi

    def spy(*args, grad_scale=None, **kw):
        seen.append(grad_scale)
        return real(*args, grad_scale=grad_scale, **kw)

    monkeypatch.setattr(topt._adamw_kernel, "adamw_multi", spy)
    for cls, kw, folded in ((topt.AdamW, {}, True),
                            (topt.Adam, {"weight_decay": 0.01}, False)):
        p = torch.nn.Parameter(torch.ones(4))
        p.grad = torch.full((4,), 3.0)
        opt = cls(parameters=[("p", p)],
                  grad_clip=topt.GradientClipByGlobalNorm(1.0), **kw)
        opt.step()
        if folded:
            assert float(seen[-1]) == np.float32(1.0) / np.float32(6.0)
        else:
            assert seen[-1] is None


def _sgd_steps(w0, c, lrs, fused):
    """``w - lr * c`` step by step in float32: with ``fused`` the product
    and the difference rounded once (XLA fuses the update into one
    multiply-add on the CPU), else each rounded (torch's two ops)."""
    w = w0
    for lr in lrs:
        lr = np.float32(lr)
        if fused:
            w = (w.astype(np.float64) - np.float64(lr) *
                 c.astype(np.float64)).astype(np.float32)
        else:
            w = w - lr * c
    return w


def test_to_static_reads_the_scheduler_where_jax_keeps_its_first_lr():
    """SGD on a loss linear in its weights (gradient ``c``), a StepDecay
    halving the lr after each call: the JAX ``to_static`` step bakes
    ``float(lr)`` in at its trace and keeps it (its key, which gradients
    are present and the flags, ignores the lr): the first call traces at
    0.1, the second (gradients now present) retraces at 0.05 and the
    third reuses it, so the weights move by (0.1 + 0.05 + 0.05) c, and
    the step compiled exactly twice. The port refreshes its device lr
    before every replay (here on the CPU every call runs the step, which
    reads the schedule too): 0.1 + 0.05 + 0.025. A deliberate divergence
    (ROADMAP queue C).

    The weights start from a numpy seed, not from the reference's
    process-wide initializer stream (whose state depends on what ran
    before in the process), and each side is held bit for bit to its own
    rounding: XLA's update ``w - lr * g`` rounds once, torch's twice. An
    element that nearly cancels (``w0 ~ 0.2 c``) made the earlier
    ``rtol=1e-6`` comparison against the twice-rounded sum fail for a
    few initial draws in the process."""
    from paddle_tpu import nn as jnn
    from paddle_tpu.observability import compile_tracker as jct
    c = np.arange(6, dtype=np.float32).reshape(3, 2) / 10
    w0 = np.random.RandomState(18).uniform(-1, 1, (3, 2)).astype(np.float32)
    jlin = jnn.Linear(3, 2)
    jlin.weight.value = jnp.asarray(w0)
    jsched = jopt.lr.StepDecay(0.1, step_size=1, gamma=0.5)
    jo = jopt.SGD(learning_rate=jsched, parameters=jlin.parameters())

    def jstep_sched(cc):
        loss = (jlin.weight * cc).sum()
        jlin.clear_gradients()
        loss.backward()
        jo.step()
        return loss

    tw = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    tlayer = torch.nn.Module()
    tlayer.weight = tw
    tsched = topt.lr.StepDecay(0.1, step_size=1, gamma=0.5)
    to = topt.SGD(learning_rate=tsched, parameters=[("weight", tw)])

    def tstep(cc):
        loss = (tw * cc).sum()
        to.clear_grad()
        loss.backward()
        to.step()
        return loss.detach()

    site = "to_static{py_fn=jstep_sched}"

    def traces():
        return jct.compiles().get(site, {}).get("count", 0)

    before = traces()
    jfast = jjit.to_static(jstep_sched, layers=[jlin], optimizers=[jo])
    tfast = tjit.to_static(tstep, layers=[tlayer], optimizers=[to])
    for _ in range(3):
        jfast(c)
        tfast(torch.from_numpy(c))
        jsched.step()
        tsched.step()
    assert traces() - before == 2
    np.testing.assert_array_equal(
        _np(jlin.weight.value), _sgd_steps(w0, c, (0.1, 0.05, 0.05), True))
    np.testing.assert_array_equal(
        tw.detach().numpy(), _sgd_steps(w0, c, (0.1, 0.05, 0.025), False))


def test_lr_slots_follow_lr_scale_and_refresh_in_place():
    """One f32 slot per distinct ``lr_scale``, each ``float32(lr *
    scale)`` as the reference computes it; ``set_lr`` and a scheduler
    step refresh the same tensor in place, and a new ``lr_scale`` seen at
    a later step grows it (outside any capture)."""
    ps = [torch.nn.Parameter(torch.zeros(2)) for _ in range(3)]
    ps[1].lr_scale = 0.1
    ps[2].lr_scale = 0.1
    sched = topt.lr.ExponentialDecay(0.3, 0.7)
    opt = topt.Momentum(sched, parameters=[(f"p{i}", p)
                                           for i, p in enumerate(ps)])
    t = opt._lr[torch.device("cpu")]
    assert t.tolist() == [np.float32(0.3), np.float32(0.3 * 0.1)]
    assert opt._lr_of(ps[2]).data_ptr() == t.data_ptr() + 4
    sched.step()
    opt._refresh_lr()
    assert opt._lr[torch.device("cpu")] is t
    assert t.tolist() == [np.float32(0.3 * 0.7), np.float32(0.3 * 0.7 * 0.1)]
    opt.set_lr(0.5)
    assert opt.get_lr() == 0.5 and t.tolist()[0] == 0.5
    ps[0].lr_scale = 2.0
    for p in ps:
        p.grad = torch.ones(2)
    opt.step()
    assert opt._lr[torch.device("cpu")].tolist() == [0.5, np.float32(0.05),
                                                     1.0]
