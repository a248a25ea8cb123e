"""The dygraph tape of the port (``paddle_tpu_torch/dygraph``: the eager
Tensor, ``run_op`` on torch autograd, ``backward`` / ``grad`` /
``no_grad``, ``record_program``, ``seed``, the tape ``Layer`` and its
containers, AMP on the tape, the eager optimizers and ``GradScaler`` over
tape Parameters, ``framework_io.save`` / ``load``) against the JAX
package's tape on the CPU, from numpy-seeded inputs.

Tolerances: single ops within 1e-6 relative plus 1e-6 absolute (the
same float32 arithmetic in another library); seeded parameters and
dropout masks bit-equal; the small tape encoder (2 layers, d 32, 4
heads, seq 16, batch 2) over 3 AdamW steps at lr 1e-3: losses within
1e-5 relative, parameters within ``1e-6 + 1e-5 |ref|`` (the key
projections' biases, whose true gradient is zero, within 1e-4 of zero
in both). Its loss weighs
the output by a fixed random tensor: the mean square of a LayerNorm
output (phase 23's loss) has gradients that are differences of nearly
equal terms, whose float32 rounding Adam's first, sign-like update
turns into lr-sized differences.

Every op case of ``test_torch_static.py``, ``torch_op_cases_tail.py``
and ``torch_op_cases_collective.py`` also runs through ``run_op`` with
gradients on, against the static plane's lowering and grad ops (which
those files hold to the reference).
"""

import torch_threads  # noqa: F401  (one worker's share of the cores)
import types
import zlib

import jax
import numpy as np
import pytest
import torch

import paddle_tpu.amp as jamp
import paddle_tpu.dygraph as JD
import paddle_tpu.framework_io as jio
import paddle_tpu.optimizer as JO
import paddle_tpu.tensor_api as JT
from paddle_tpu.framework import Program as JProgram
from paddle_tpu.initializer import (NormalInitializer as JNormal,
                                    TruncatedNormalInitializer as JTrunc,
                                    UniformInitializer as JUniform)

import paddle_tpu_torch
import paddle_tpu_torch.amp as tamp
import paddle_tpu_torch.dygraph as TD
import paddle_tpu_torch.framework_io as tio
import paddle_tpu_torch.optimizer as TO
import paddle_tpu_torch.tensor_api as TT
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch import prng
from paddle_tpu_torch.framework import Program as TProgram
from paddle_tpu_torch.initializer import (NormalInitializer as TNormal,
                                          TruncatedNormalInitializer as TTrunc,
                                          UniformInitializer as TUniform)
from paddle_tpu_torch.models.tape_encoder import build_tape_encoder
from paddle_tpu_torch.ops import registry as treg

JAX = types.SimpleNamespace(name="jax", D=JD, T=JT, O=JO, amp=jamp, io=jio,
                            kw={}, Program=JProgram,
                            init=(JNormal, JUniform, JTrunc))
PORT = types.SimpleNamespace(name="port", D=TD, T=TT, O=TO, amp=tamp,
                             io=tio, kw={"device": "cpu"}, Program=TProgram,
                             init=(TNormal, TUniform, TTrunc))
TOL = dict(rtol=1e-6, atol=1e-6)


def _t(pkg, a, **kw):
    return pkg.D.to_tensor(np.asarray(a), **kw, **pkg.kw)


def _np(t):
    return np.asarray(t.numpy())


def _both(fn):
    """``fn(pkg)`` in either package, numpy results."""
    return [fn(pkg) for pkg in (JAX, PORT)]


def _close(a, b, **tol):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.dtype, b.dtype)
    np.testing.assert_allclose(a, b, **(tol or TOL))


# ------------------------------------------------------- the Tensor surface
_A = np.random.RandomState(0).randn(2, 3).astype(np.float32)
_B = (np.abs(np.random.RandomState(1).randn(2, 3)) + 0.5).astype(np.float32)

SURFACE = {
    "add": lambda a, b: a + b,
    "radd": lambda a, b: 2.0 + a,
    "sub": lambda a, b: a - b,
    "rsub": lambda a, b: 1.5 - a,
    "mul": lambda a, b: a * b,
    "rmul": lambda a, b: 3.0 * a,
    "div": lambda a, b: a / b,
    "rdiv": lambda a, b: 2.0 / b,
    "pow": lambda a, b: b ** a,
    "matmul": lambda a, b: a @ b.transpose([1, 0]),
    "neg": lambda a, b: -a,
    "lt": lambda a, b: a < b,
    "le": lambda a, b: a <= b,
    "gt": lambda a, b: a > b,
    "ge": lambda a, b: a >= b,
    "getitem_int": lambda a, b: a[1],
    "getitem_slice": lambda a, b: a[:, 1:3],
    "getitem_advanced": lambda a, b: a[np.array([1, 0])],
    "reshape": lambda a, b: a.reshape([3, 2]),
    "transpose": lambda a, b: a.transpose([1, 0]),
    "flatten": lambda a, b: a.flatten(),
    "sum": lambda a, b: a.sum(axis=1),
    "mean_all": lambda a, b: a.mean(),
    "max_keep": lambda a, b: a.max(axis=0, keepdim=True),
    "unsqueeze": lambda a, b: a.unsqueeze(0),
    "squeeze": lambda a, b: a.unsqueeze(0).squeeze(0),
    "cast": lambda a, b: a.cast("int32"),
    "astype_bf16": lambda a, b: a.astype("bfloat16"),
    "clone": lambda a, b: a.clone(),
    "detach": lambda a, b: a.detach(),
}


@pytest.mark.parametrize("what", sorted(SURFACE))
def test_tensor_surface_matches_the_reference(what):
    fn = SURFACE[what]
    j, t = _both(lambda P: fn(_t(P, _A), _t(P, _B)))
    assert t.shape == j.shape and t.dtype == j.dtype
    _close(_np(t).astype(np.float32), _np(j).astype(np.float32))
    assert t.stop_gradient and j.stop_gradient


def test_tensor_fields_and_scalar_protocol():
    for P in (JAX, PORT):
        a = _t(P, _A)
        s = _t(P, np.float32(2.5))
        assert (a.ndim, a.size, a.numel(), len(a)) == (2, 6, 6, 2)
        assert float(s) == 2.5 and int(s) == 2 and bool(s)
        assert [10, 20, 30][_t(P, np.int64(1))] == 20
        assert s.item() == 2.5 and a.is_leaf and a.grad is None
        assert "stop_gradient=False" in repr(_t(P, _A, stop_gradient=False))
    # a Python float becomes float32 in the port, Paddle's default float
    assert TD.to_tensor(1.5, device="cpu").dtype == "float32"
    assert TD.to_tensor([1, 2], device="cpu").dtype == "int64"
    x = TD.to_tensor(_A, device="cpu")
    x.set_value(np.ones((2, 3)))
    held = x.value
    x.set_value(_B)
    assert x.value is held and x.dtype == "float32"
    np.testing.assert_array_equal(x.numpy(), _B)


def test_scalar_protocol_raises_while_the_stream_captures(monkeypatch):
    from paddle_tpu_torch.dygraph import tensor as ttensor
    monkeypatch.setattr(ttensor, "capturing", lambda: True)
    with pytest.raises(TypeError, match="cannot convert a traced Tensor"):
        bool(TD.to_tensor(1.0, device="cpu"))


# ------------------------------------------------ backward and stop_gradient
def test_backward_accumulates_and_retain_graph():
    def run(P):
        x = _t(P, _A, stop_gradient=False)
        y = (x * x * 3.0).sum()
        y.backward(retain_graph=True)
        g1 = _np(x.grad)
        y.backward()              # retained: accumulates
        g2 = _np(x.grad)
        y.backward()              # the graph was dropped: nothing
        g3 = _np(x.grad)
        z = (x * 2.0).mean()
        z.backward()
        g4 = _np(x.grad)
        x.clear_grad()
        return g1, g2, g3, g4, x.grad
    j, t = _both(run)
    for a, b in zip(t[:4], j[:4]):
        _close(a, b)
    np.testing.assert_array_equal(t[2], t[1])
    assert t[4] is None and j[4] is None


def test_stop_gradient_on_leaves_non_leaves_and_nondiff_outputs():
    def run(P):
        x = _t(P, _A, stop_gradient=False)
        w = _t(P, _B, stop_gradient=False)
        frozen = _t(P, _B)                      # stop_gradient leaf
        h = x * w
        h2 = h * frozen
        h2.stop_gradient = True                 # cut a non-leaf
        y = (h2 * x + h).sum()
        vals, idx = P.T.topk(h, 2)              # Indices: nondiff
        y.backward()
        return (_np(x.grad), _np(w.grad), frozen.grad, h.stop_gradient,
                h.is_leaf, vals.stop_gradient, idx.stop_gradient)
    j, t = _both(run)
    _close(t[0], j[0])
    _close(t[1], j[1])
    assert t[2:] == j[2:] == (None, False, False, False, True)


def test_integer_leaf_wanting_a_gradient_gets_the_grad_ops_zeros():
    """Zeros where the backward reaches an op the leaf feeds: float32
    from the generic grad (``elementwise_add``), the input's dtype from
    ``cast_grad``."""
    def run(P):
        x = _t(P, _A, stop_gradient=False)
        n = _t(P, np.array([[1, 2, 3], [4, 5, 6]], np.int64),
               stop_gradient=False)
        m = _t(P, np.array([[1, 0, 1], [0, 1, 0]], np.int64),
               stop_gradient=False)
        y = (x * n.cast("float32")).sum() + P.D.run_op(
            "elementwise_add", {"X": [x], "Y": [m]}, {})["Out"][0].sum()
        gx, gn, gm = P.D.grad(y, [x, n, m], retain_graph=True)
        y.backward()
        return [_np(v) for v in (gx, gn, gm, x.grad, n.grad, m.grad)]
    j, t = _both(run)
    for a, b in zip(t, j):
        _close(a, b)
    assert t[1].dtype == np.int64 and t[2].dtype == np.float32
    assert not t[4].any() and not t[5].any()


def test_no_grad_context_and_decorator():
    def run(P):
        x = _t(P, _A, stop_gradient=False)
        with P.D.no_grad():
            y = x * 2.0

        @P.D.no_grad()
        def f(v):
            return v + 1.0

        z = f(x)
        return y.stop_gradient, z.stop_gradient, (x * 2.0).stop_gradient
    assert _both(run) == [(True, True, False)] * 2
    x = TD.to_tensor(_A, stop_gradient=False, device="cpu")
    with TD.no_grad():
        y = x * 2.0
    assert y.value.grad_fn is None and y._root is None


# ---------------------------------------------------- partial grad (paddle.grad)
def _pg_basic(P):
    x = _t(P, np.array([1.0, 2.0, 3.0], np.float32))
    x.stop_gradient = False
    (g,) = P.D.grad((x * x).sum(), [x])
    return [_np(g), x.grad is None]


def _pg_unused(P):
    a, b, c = (_t(P, np.array([v], np.float32), stop_gradient=False)
               for v in (2.0, 3.0, 4.0))
    ga, gb, gc = P.D.grad(a * b, [a, b, c], allow_unused=True)
    with pytest.raises(ValueError):
        P.D.grad(a * b, [c])
    with pytest.raises(ValueError, match="connected"):
        P.D.grad(_t(P, np.ones(1, np.float32)), [a])
    return [_np(ga), _np(gb), gc is None]


def _pg_seed(P):
    x = _t(P, np.array([1.0, 1.0], np.float32), stop_gradient=False)
    seed = _t(P, np.array([10.0, 100.0], np.float32))
    (g,) = P.D.grad(x * 3.0, [x], grad_outputs=[seed])
    return [_np(g)]


def _pg_retain(P):
    x = _t(P, np.array([5.0], np.float32), stop_gradient=False)
    y = x * x
    (g1,) = P.D.grad(y, [x], retain_graph=True)
    (g2,) = P.D.grad(y, [x], retain_graph=True)
    return [_np(g1), _np(g2)]


def _pg_create_graph(P):
    x = _t(P, np.array([1.0], np.float32), stop_gradient=False)
    with pytest.raises(NotImplementedError):
        P.D.grad(x * x, [x], create_graph=True)
    return [True]


PARTIAL = {"basic_no_side_effects": _pg_basic,
           "multiple_inputs_and_unused": _pg_unused,
           "grad_outputs_seed": _pg_seed,
           "retains_graph_for_second_call": _pg_retain,
           "create_graph_raises": _pg_create_graph}


@pytest.mark.parametrize("what", sorted(PARTIAL))
def test_partial_grad_semantics_match_the_reference(what):
    j, t = _both(PARTIAL[what])
    for a, b in zip(t, j):
        if isinstance(a, bool):
            assert a == b
        else:
            _close(a, b)


def test_grad_of_a_non_leaf_leaves_every_grad_untouched():
    def run(P):
        x = _t(P, _A, stop_gradient=False)
        h = x * x
        y = (h * 3.0).sum()
        gh, gx = P.D.grad(y, [h, x])
        return _np(gh), _np(gx), x.grad
    j, t = _both(run)
    _close(t[0], j[0])
    _close(t[1], j[1])
    assert t[2] is None and j[2] is None


# ---------------------------------------------------------- record_program
def _recorded(P):
    prog = P.Program()
    x = _t(P, _A, stop_gradient=False)
    p = P.D.Parameter(_B, name="w", **P.kw)
    with P.D.tape.record_program(prog):
        y = P.T.sum(P.T.exp(x * p), axis=1)
        _ = y + 1.0
    blk = prog.global_block()
    rename = {}
    for op in blk.ops:
        for names in list(op.inputs.values()) + list(op.outputs.values()):
            for n in names:
                rename.setdefault(n, f"v{len(rename)}" if n != "w" else n)
    ops = [(op.type, {s: [rename[n] for n in ns] for s, ns in
                      op.inputs.items()},
            {s: [rename[n] for n in ns] for s, ns in op.outputs.items()},
            sorted(op.attrs.items()))
           for op in blk.ops]
    var = {rename[n]: (tuple(v.shape), v.dtype, bool(v.persistable))
           for n, v in blk.vars.items()}
    return ops, var


def test_record_program_appends_the_reference_ops_and_vars():
    j, t = _both(_recorded)
    assert [o[:3] for o in t[0]] == [o[:3] for o in j[0]]
    for (_, _, _, ta), (_, _, _, ja) in zip(t[0], j[0]):
        assert dict(ta).keys() == dict(ja).keys()
    assert t[1] == j[1]
    assert t[1]["w"][2]


# ---------------------------------------------------------------- seeding
def _draws(P):
    Normal, Uniform, Trunc = P.init
    P.D.seed(123)
    layer = P.D.Layer(**P.kw)
    out = [layer.create_parameter([3, 4]),
           layer.create_parameter([4], is_bias=True),
           layer.create_parameter([5], attr=P.D.layers.ParamAttr(
               initializer=Normal(0.5, 2.0))),
           layer.create_parameter([2, 3], default_initializer=Uniform(-1, 1)),
           layer.create_parameter([6], default_initializer=Trunc(0.0, 1.0))]
    P.D.seed(9)
    x = _t(P, np.ones((4, 256), np.float32))
    masks = [P.D.run_op("dropout", {"X": [x]}, {"dropout_prob": 0.3})
             for _ in range(2)]
    return [_np(p) for p in out] + [_np(m["Mask"][0]) for m in masks] + \
        [_np(masks[0]["Out"][0])]


def test_seed_gives_bit_equal_parameters_and_dropout_masks():
    with jax.enable_x64(False):
        j = _draws(JAX)
    t = _draws(PORT)
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a, b)
    assert not np.array_equal(t[5], t[6])     # two ops, two draws


# ------------------------------------------------- Layer and the containers
_X4 = np.random.RandomState(4).randn(2, 4).astype(np.float32)


def _mlp(P, din=4, hid=8, dout=3):
    run_op = P.D.run_op

    class Linear(P.D.Layer):
        def __init__(self, i, o, **kw):
            super().__init__(**kw)
            self.weight = self.create_parameter([i, o])
            self.bias = self.create_parameter([o], is_bias=True)

        def forward(self, x):
            y = run_op("matmul_v2", {"X": [x], "Y": [self.weight]}, {})
            return run_op("elementwise_add", {"X": [y["Out"][0]],
                                              "Y": [self.bias]}, {})["Out"][0]

    class ReLU(P.D.Layer):
        def forward(self, x):
            return run_op("relu", {"X": [x]}, {})["Out"][0]

    return P.D.Sequential(Linear(din, hid, **P.kw), ReLU(),
                          Linear(hid, dout, **P.kw))


def test_layer_containers_state_dicts_and_hooks():
    def run(P):
        P.D.seed(5)
        m = _mlp(P)
        seen = []
        m.register_forward_pre_hook(lambda layer, a: seen.append("pre"))
        m.register_forward_post_hook(
            lambda layer, a, out: out * 2.0)
        out = m(_t(P, _X4))
        names = [n for n, _ in m.named_parameters()]
        sd = m.state_dict()
        lst = P.D.LayerList([m[0], m[2]]).append(m[1])
        pl = P.D.ParameterList([m[0].weight]).append(m[2].bias)
        modes = []
        m.eval()
        modes.append([s.training for s in m.sublayers(include_self=True)])
        m.train()
        modes.append([s.training for s in m.sublayers(include_self=True)])
        visited = []
        m.apply(lambda layer: visited.append(type(layer).__name__))
        fresh = _mlp(P)
        missing = fresh.set_state_dict({k: v.numpy() for k, v in sd.items()
                                        if k != "2.bias"})
        out.sum().backward()
        m.clear_gradients()
        return (_np(out), names, list(sd), len(lst), len(pl), modes,
                visited, missing, seen,
                [_np(a) for a in fresh.parameters()][:3],
                [p.grad for p in m.parameters()],
                len(m.parameters(include_sublayers=False)))
    j, t = _both(run)
    _close(t[0], j[0])
    assert t[1:9] == j[1:9]
    assert t[1] == ["0.weight", "0.bias", "2.weight", "2.bias"]
    for a, b in zip(t[9], j[9]):
        np.testing.assert_array_equal(a, b)
    assert t[10] == j[10] == [None] * 4 and t[11] == j[11] == 0
    assert isinstance(TD.Layer().full_name(), str)


def test_layer_places_parameters_on_its_device_and_needs_one(monkeypatch):
    layer = TD.Layer(device="cpu")
    assert layer.create_parameter([2]).value.device.type == "cpu"
    assert layer.create_parameter([2], attr=False) is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    TD.Sequential()                     # a container makes no parameter
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TD.Layer().create_parameter([2])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TD.to_tensor([1.0])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TT.zeros([2])
    with pytest.raises(ValueError, match="one device"):
        TD.run_op("elementwise_add", {
            "X": [TD.to_tensor([1.0], device="cpu")],
            "Y": [TD.Tensor(torch.ones(1, device="meta"))]}, {})


# --------------------------------------------------------------------- AMP
AMP_OPS = {
    "matmul_v2": lambda P, a, b: P.T.matmul(a, b.transpose([1, 0])),
    "elementwise_add": lambda P, a, b: a + b,
    "reduce_mean": lambda P, a, b: P.T.mean(a),
    "exp": lambda P, a, b: P.T.exp(a),
    "layer_norm": lambda P, a, b: P.D.run_op(
        "layer_norm", {"X": [a]}, {"begin_norm_axis": 1})["Y"][0],
    "relu": lambda P, a, b: P.D.run_op("relu", {"X": [a]}, {})["Out"][0],
}


@pytest.mark.parametrize("level", ["O1", "O2"])
def test_auto_cast_dtypes_per_op_match_the_reference(level):
    def run(P):
        a, b = _t(P, _A, stop_gradient=False), _t(P, _B)
        out = {}
        with P.amp.auto_cast(level=level):
            for name, fn in AMP_OPS.items():
                out[name] = fn(P, a, b).dtype
            y = P.T.matmul(a, b.transpose([1, 0]))
        y.astype("float32").mean().backward()
        out["grad"] = a.grad.dtype
        return out
    j, t = _both(run)
    assert t == j


# ---------------------------------------------- test_nn_dygraph's semantics
def test_sequential_eager_train_matches_the_reference():
    rng = np.random.RandomState(0)
    W = rng.randn(4, 3).astype(np.float32)
    xs = [rng.randn(2, 4).astype(np.float32)] * 4

    def run(P):
        P.D.seed(42)
        m = _mlp(P)
        opt = P.O.Adam(learning_rate=5e-3, parameters=m.parameters())
        losses = []
        for x in xs:
            y = np.eye(3, dtype=np.float32)[(x @ W).argmax(-1)]
            d = m(_t(P, x)) - _t(P, y)
            loss = (d * d).mean()
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses.append(float(loss.numpy()))
        return losses, [_np(p) for p in m.parameters()]
    j, t = _both(run)
    np.testing.assert_allclose(t[0], j[0], rtol=1e-5)
    assert t[0][-1] < t[0][0]
    for a, b in zip(t[1], j[1]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def test_grad_clip_on_tape_parameters_matches_the_reference():
    def run(P):
        P.D.seed(1)
        m = _mlp(P)
        opt = P.O.SGD(learning_rate=1.0, parameters=m.parameters(),
                      grad_clip=P.O.GradientClipByGlobalNorm(0.1))
        m(_t(P, 100 * _X4)).sum().backward()
        before = [_np(p).copy() for p in m.parameters()]
        opt.step()
        return [_np(p) - b for p, b in zip(m.parameters(), before)]
    j, t = _both(run)
    for a, b in zip(t, j):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)
    assert np.sqrt(sum(np.sum(d ** 2) for d in t)) <= 0.1 + 1e-5


def test_optimizer_reads_lr_scale_regularizer_and_trainable_off_parameters():
    def run(P):
        ps = [P.D.Parameter(_A * (i + 1), name=f"p{i}", **P.kw)
              for i in range(3)]
        ps[0].lr_scale = 0.5
        ps[1].regularizer = P.O.L2Decay(0.1)
        ps[2].trainable = False
        opt = P.O.Momentum(learning_rate=0.1, momentum=0.9, parameters=ps)
        for _ in range(2):
            loss = sum(((p * p).sum() for p in ps[1:]), (ps[0] * 3.0).sum())
            loss.backward()
            opt.step()
            opt.clear_grad()
        return [_np(p) for p in ps] + [sorted(opt.state_dict())]
    j, t = _both(run)
    for a, b in zip(t[:3], j[:3]):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
    assert t[3] == j[3]


def test_grad_scaler_with_a_tape_loss_and_parameters():
    def run(P):
        P.D.seed(3)
        m = _mlp(P)
        opt = P.O.SGD(learning_rate=0.1, parameters=m.parameters())
        scaler = P.amp.GradScaler(init_loss_scaling=128.0)
        loss = m(_t(P, _X4)).mean()
        scaled = scaler.scale(loss)
        scaled.backward()
        raw = [_np(p.grad).copy() for p in m.parameters()]
        scaler.minimize(opt, scaled)
        return (float(scaled.numpy()), raw,
                [_np(p) for p in m.parameters()],
                scaler.get_loss_scaling())
    j, t = _both(run)
    np.testing.assert_allclose(t[0], j[0], rtol=1e-6)
    for a, b in zip(t[1] + t[2], j[1] + j[2]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    assert t[3] == j[3]


def test_save_and_load_state_dicts_across_the_packages(tmp_path):
    def run(P):
        P.D.seed(11)
        m = _mlp(P)
        path = str(tmp_path / f"{P.name}.pdparams")
        P.io.save(m.state_dict(), path)
        P.io.save(m[0].weight, path + ".one")
        return m, path
    (jm, jpath), (tm, tpath) = _both(run)
    for P, m, other in ((JAX, jm, tpath), (PORT, tm, jpath)):
        P.D.seed(0)
        fresh = _mlp(P)
        assert fresh.set_state_dict(P.io.load(other)) == []
        for (k1, p1), (k2, p2) in zip(jm.state_dict().items(),
                                      fresh.state_dict().items()):
            assert k1 == k2
            np.testing.assert_array_equal(_np(p1), _np(p2))
        one = P.io.load(other + ".one")
        assert list(one) == ["tensor"]
        np.testing.assert_array_equal(one["tensor"], _np(jm[0].weight))
    with pytest.raises(TypeError):
        tio.save([1], str(tmp_path / "bad"))


def test_tensor_api_surface_like_the_reference():
    def run(P):
        a = _t(P, np.arange(6, dtype=np.float32).reshape(2, 3))
        v, i = P.T.topk(a, 2)
        w = P.T.where(a > 2.0, a, P.T.zeros_like(a))
        return (P.T.sum(a).item(), P.T.mean(a).item(),
                _np(P.T.argmax(a, axis=1)).tolist(),
                P.T.concat([a, a], axis=0).shape,
                P.T.transpose(a, [1, 0]).shape, v.shape,
                float(_np(w)[0, 0]))
    j, t = _both(run)
    assert t == j == (15.0, 2.5, [2, 2], [4, 3], [3, 2], [2, 2], 0.0)
    # the package's names bind as the reference's imports bind them
    import paddle_tpu
    assert paddle_tpu_torch.Tensor is TD.Tensor
    assert paddle_tpu_torch.tensor is TT and paddle_tpu_torch.exp is TT.exp
    for name in ("seed", "to_tensor", "grad", "no_grad", "Parameter"):
        j = getattr(paddle_tpu, name)
        t = getattr(paddle_tpu_torch, name)
        assert t.__module__.replace("paddle_tpu_torch", "paddle_tpu") == \
            j.__module__, name


# ------------------------------------------------------ the tape's own routes
def test_registry_gradients_run_the_registered_grad_ops():
    """``lookup_table_v2`` (its registered grad skips ``padding_idx``)
    and a fake quantizer (a custom grad maker: straight through) take
    the reference's gradients on the tape."""
    w = np.random.RandomState(2).randn(5, 3).astype(np.float32)
    ids = np.array([[0, 2, 2], [4, 0, 1]], np.int64)

    def run(P):
        wt = _t(P, w, stop_gradient=False)
        out = P.D.run_op("lookup_table_v2", {"W": [wt], "Ids": [_t(P, ids)]},
                         {"padding_idx": 2})["Out"][0]
        x = _t(P, _A, stop_gradient=False)
        q = P.D.run_op("fake_quantize_dequantize_abs_max", {"X": [x]},
                       {"bit_length": 8})["Out"][0]
        (gw, gx) = P.D.grad([(out * 3.0).sum(), (q * q).sum()], [wt, x])
        return _np(gw), _np(gx)
    j, t = _both(run)
    for a, b in zip(t, j):
        _close(a, b)
    assert not t[0][2].any()


def test_fused_attention_reaches_the_flash_route_on_the_tape(monkeypatch):
    from paddle_tpu_torch.ops import attention_ops
    calls = []
    real = attention_ops.flash_attention
    monkeypatch.setattr(attention_ops, "flash_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    saved = tflags.get_flags(["use_pallas_attention", "pallas_min_seq"])
    tflags.set_flags({"use_pallas_attention": True, "pallas_min_seq": 64})
    try:
        q = TD.to_tensor(np.random.RandomState(3).randn(1, 2, 64, 16)
                         .astype(np.float32), stop_gradient=False,
                         device="cpu")
        out = TD.run_op("fused_attention_qkv", {"Q": [q], "K": [q],
                                                "V": [q]},
                        {"causal": False})["Out"][0]
        out.sum().backward()
    finally:
        tflags.set_flags(saved)
    assert calls == [1] and q.grad is not None


# --------------------------------------------------- the tape encoder vs JAX
#: the key projections' biases (``fc_<6 i + 1>.w_1``): adding one bias to
#: every key shifts each query's logits alike, so their true gradient
#: is zero (chip_smoke.py's se_grad_scale has the same rule)
KEY_BIASES = {f"fc_{6 * i + 1}.w_1" for i in range(2)}

def test_tape_encoder_trains_like_the_reference():
    """The JAX side runs its tape under ``paddle_tpu.jit.to_static`` (two
    XLA compiles, where op by op its tape compiles each op's forward and
    grad at their first use: 10 s against 4 s here)."""
    import paddle_tpu.jit as jjit
    x = np.random.RandomState(0).randn(2, 16, 32).astype(np.float32)
    r = np.random.RandomState(1).randn(2, 16, 32).astype(np.float32)

    def run(P):
        P.D.seed(7)
        enc = build_tape_encoder(
            2, 32, 4, 64, dygraph=None if P is PORT else JD, device="cpu")
        opt = P.O.AdamW(learning_rate=1e-3, weight_decay=0.01,
                        parameters=enc.parameters())

        def step(xt, rt):
            loss = P.T.mean(enc(xt) * rt)
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss

        if P is JAX:
            step = jjit.to_static(step, layers=[enc], optimizers=[opt])
        xt, rt = _t(P, x), _t(P, r)
        losses = [float(_np(step(xt, rt))) for _ in range(3)]
        return losses, {p.name: _np(p) for p in enc.parameters()}
    j, t = _both(run)
    np.testing.assert_allclose(t[0], j[0], rtol=1e-5)
    assert list(t[1]) == list(j[1])
    for n in j[1]:
        if n in KEY_BIASES:
            # zero true gradient: both are rounding noise that Adam
            # scales by 1 / eps, far below one lr-sized step
            assert np.abs(t[1][n]).max() < 1e-4 > np.abs(j[1][n]).max()
            continue
        np.testing.assert_allclose(t[1][n], j[1][n], rtol=1e-5, atol=1e-6,
                                   err_msg=n)


# -------------------------------------- every op case through run_op on tape
def _tape_cases():
    from test_torch_static import _EAGER, _NO_GRAD, _RAISES, OP_CASES
    from torch_op_cases_collective import ONE_RANK_CASES
    from torch_op_cases_tail import TAIL_CASES, TAIL_RAISES
    cases = {**OP_CASES, **TAIL_CASES, **ONE_RANK_CASES}
    skip = set(_RAISES) | set(TAIL_RAISES)
    return {k: v for k, v in cases.items() if k not in skip}, _NO_GRAD, \
        _EAGER


_CASES, _CASES_NO_GRAD, _ = _tape_cases()


def _static_plane(op_type, ins_np, attrs, cots):
    """The port's lowering and grad ops as the static executor runs them,
    inputs and outputs named apart: ``(outs, {input name: grad})``."""
    conv = {f"i:{s}:{i}": torch.tensor(np.asarray(a))
            for s, v in ins_np.items() for i, a in enumerate(v)}
    ins = {s: [conv[f"i:{s}:{i}"] for i in range(len(v))]
           for s, v in ins_np.items()}
    # the key the tape's first draw takes (the eager counter at 4 + 1),
    # held for the grad ops' rerun of a random forward
    ctx = treg.LoweringContext(rng=prng.PRNGKey(5), device="cpu",
                               eager=True)
    outs = treg.execute(ctx, op_type, ins, dict(attrs))
    d = treg.get_op_def(op_type)
    if cots is None or d.not_differentiable:
        return outs, {}
    fw = types.SimpleNamespace(
        type=op_type, attrs=dict(attrs),
        inputs={s: [f"i:{s}:{i}" for i in range(len(v))]
                for s, v in ins.items()},
        outputs={s: [f"o:{s}:{i}" for i in range(len(v))]
                 for s, v in outs.items()})
    out_g = {s: [f"o:{s}:{i}@G" if f"{s}:{i}" in cots else None
                 for i in range(len(v))] for s, v in outs.items()}
    wanted = {s: [f"i:{s}:{i}@IG" if v.is_floating_point() else None
                  for i, v in enumerate(vals)] for s, vals in ins.items()}
    env = dict(conv)
    env.update({f"o:{s}:{i}": v for s, vals in outs.items()
                for i, v in enumerate(vals)})
    env.update({f"o:{k}@G": torch.tensor(v) for k, v in cots.items()})
    grads = {}
    for g_type, g_in, g_out, g_attrs in treg.make_grad_ops(fw, out_g,
                                                           wanted):
        res = treg.execute(ctx, g_type, {s: [env[n] for n in ns]
                                         for s, ns in g_in.items()}, g_attrs)
        for s, ns in g_out.items():
            for n, v in zip(ns, res[s]):
                grads[n[2:-3]] = v
    return outs, grads


@pytest.mark.parametrize("case", sorted(_CASES))
def test_op_case_runs_on_the_tape_with_gradients(case):
    op_type, make, attrs, _ = _CASES[case]
    ins = make(np.random.RandomState(zlib.crc32(case.encode())))
    d = treg.get_op_def(op_type)
    tins = {s: [TD.Tensor(torch.tensor(np.asarray(a)),
                          stop_gradient=np.asarray(a).dtype.kind != "f")
                for a in v] for s, v in ins.items()}
    treg._EAGER_SEED = 4
    outs = TD.run_op(op_type, tins, dict(attrs))
    crng = np.random.RandomState(7)
    cots = None if case in _CASES_NO_GRAD or d.not_differentiable else {
        f"{s}:{i}": np.asarray(crng.randn(*v.shape)).astype(
            np.float64 if v.dtype == "float64" else np.float32)
        for s, vals in outs.items() for i, v in enumerate(vals)
        if v.value.is_floating_point() and s not in d.nondiff_outputs}
    souts, sgrads = _static_plane(op_type, ins, attrs, cots)
    assert list(outs) == list(souts)
    for s in souts:
        for a, b in zip(outs[s], souts[s]):
            if s != "XShape":
                torch.testing.assert_close(a.value, b, rtol=1e-5, atol=1e-5,
                                           equal_nan=True)
    if not cots:
        return
    roots = [(outs[s][int(i)], cots[k]) for k in cots
             for s, i in [k.split(":")] if outs[s][int(i)]._root is not None]
    leaves = [(f"{s}:{i}", t) for s, ts in tins.items()
              for i, t in enumerate(ts) if not t.stop_gradient]
    got = TD.grad([r for r, _ in roots], [t for _, t in leaves],
                  [TD.Tensor(torch.tensor(c)) for _, c in roots],
                  allow_unused=True) if roots else [None] * len(leaves)
    for (name, t), g in zip(leaves, got):
        ref = sgrads.get(name)
        if ref is None:
            assert g is None or not g.value.any(), name
            continue
        val = torch.zeros_like(ref) if g is None else g.value
        torch.testing.assert_close(val, ref, rtol=1e-4, atol=1e-5,
                                   equal_nan=True, msg=name)
