"""The port's control flow against the JAX package on the CPU: the
``while`` / ``cond`` / ``switch_case`` ops and the ``layers``
builders over them (``layers/control_flow.py``), run through both
executors on the same programs.

- The counterparts of ``tests/test_control_flow.py``'s 13 tests, each
  program built by both packages and run by both, values and gradients
  compared (the dead-iteration NaN cases included).
- One executor key whose branch changes between runs, a ``cond`` nested
  in a ``while`` body, a dropout inside a loop body (the reference's
  stream: ``while`` splits its key every iteration), a ``switch_case``
  gradient, ``py_func`` and a dynamic ``while`` planned as host pieces.
- Phase 25's programs at 2 layers, d 64, seq 64 (``pallas_min_seq``
  lowered to 64 on both sides, so attention takes the flash route):
  the encoder whose lr is Transformer-base's warm-up built with
  ``layers.case``, and one shared layer under ``while_loop``, forward
  at fed trip counts and trained with ``max_iters``, each against the
  JAX package per step; the loop against its unrolled twin.
- The kernel wrappers read ``torch.cuda.current_stream()`` at each call
  (an IF body captures from a stream of its own).

Tolerances: f32 values within ``1e-6 + 1e-5 |ref|``, gradients within
``1e-5 + 1e-4 |ref|`` (the two sides sum in other orders); the dropout
masks bit for bit; the encoder programs' losses within 1e-5 relative
and state within ``1e-5 + 1e-4 |ref|``; the loop and its unrolled twin
bit for bit on the port.
"""

import torch_threads  # noqa: F401  (one worker's share of the cores)
import ast
import contextlib
import pathlib
import types

import jax
import numpy as np
import pytest
import torch

import paddle_tpu.flags as jflags
import paddle_tpu.layers as JL
import paddle_tpu.optimizer as JO
from paddle_tpu.framework import Executor as JExecutor
from paddle_tpu.framework import Program as JProgram
from paddle_tpu.framework import Scope as JScope
from paddle_tpu.framework import append_backward as japp
from paddle_tpu.framework import program_guard as jguard
from paddle_tpu.framework import unique_name as jun

import paddle_tpu_torch.layers as TL
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch import jit
from paddle_tpu_torch.framework import (Executor, Program, Scope,
                                        append_backward, program_guard,
                                        unique_name)
from paddle_tpu_torch.framework.executor import plan_pieces
from paddle_tpu_torch.models import static_encoder as se
from paddle_tpu_torch.models.convert import scope_from_numpy
from paddle_tpu_torch.ops import control_flow_ops as cf

PKGS = {
    "jax": types.SimpleNamespace(L=JL, P=JProgram, guard=jguard, un=jun,
                                 exe=JExecutor, S=JScope, app=japp,
                                 AdamW=JO.AdamW),
    "port": types.SimpleNamespace(L=TL, P=Program, guard=program_guard,
                                  un=unique_name,
                                  exe=lambda: Executor("cpu"), S=Scope,
                                  app=append_backward, AdamW=None),
}
JSTATIC = types.SimpleNamespace(layers=JL, Program=JProgram,
                                program_guard=jguard, unique_name=jun,
                                AdamW=JO.AdamW)
VAL, GRAD = (1e-6, 1e-5), (1e-5, 1e-4)


@pytest.fixture(autouse=True)
def _port_flags():
    """Every flag this file sets is put back."""
    saved = tflags.get_flags(["pallas_min_seq"])
    yield
    tflags.set_flags(saved)


def _close(out, ref, tol=VAL):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    if ref.dtype.kind in "biu":
        np.testing.assert_array_equal(out, ref)
    else:
        np.testing.assert_allclose(out.astype(np.float64),
                                   ref.astype(np.float64), atol=tol[0],
                                   rtol=tol[1])


def _both(build, feeds, scope_vals=None, seed=None):
    """Build with each package (``build(pk) -> fetch names``) and run
    each feed of ``feeds`` through one executor and scope per package.
    Returns ``{pkg: [[fetch values] per run]}`` and the programs' JSON."""
    res, js = {}, {}
    for name, pk in PKGS.items():
        prog, start = pk.P(), pk.P()
        if seed is not None:
            prog.random_seed = start.random_seed = seed
        with pk.guard(prog, start), pk.un.guard():
            fetch = build(pk)
        js[name] = prog.to_json()
        scope, exe = pk.S(), pk.exe()
        for n, v in (scope_vals or {}).items():
            scope.set_var(n, v if name == "jax" else
                          torch.tensor(np.asarray(v)))
        exe.run(start, scope=scope)
        res[name] = [exe.run(prog, feed=f, fetch_list=fetch, scope=scope)
                     for f in feeds]
    assert js["jax"] == js["port"]
    return res


def _same(res, tol=VAL):
    for a, b in zip(res["port"], res["jax"]):
        for x, y in zip(a, b):
            _close(x, y, tol)


# ------------------------------- counterparts of tests/test_control_flow
def test_while_loop_counter():
    def build(pk):
        L = pk.L
        i = L.fill_constant([1], "int64", 0)
        ten = L.fill_constant([1], "int64", 10)
        acc = L.fill_constant([1], "float32", 0.0)
        def body(i, acc):
            new_acc = L.elementwise_add(acc, L.cast(i, "float32"))
            return L.increment(i, 1.0), new_acc

        i_out, acc_out = L.while_loop(lambda i, acc: L.less_than(i, ten),
                                      body, [i, acc])
        return [i_out.name, acc_out.name]

    res = _both(build, [{}])
    _same(res)
    assert res["port"][0][0][0] == 10 and res["port"][0][1][0] == 45


def test_while_class_block_style():
    def build(pk):
        L = pk.L
        i = L.fill_constant([1], "int64", 0)
        n = L.fill_constant([1], "int64", 5)
        x = L.fill_constant([1], "float32", 1.0)
        cond = L.less_than(i, n)
        w = L.While(cond)
        with w.block():
            L.assign(L.scale(x, scale=2.0), x)
            L.increment(i, 1.0)
            L.assign(L.less_than(i, n), cond)
        return [x.name]

    res = _both(build, [{}])
    _same(res)
    assert res["port"][0][0][0] == 32.0


def _cond_prog(pk):
    L = pk.L
    x = L.data("x", shape=[3], dtype="float32")
    p = L.data("p", shape=[1], dtype="bool")
    out = L.cond(p, lambda: L.scale(x, scale=2.0),
                 lambda: L.scale(x, scale=-1.0))
    return [out.name]


def test_cond_selects_branch():
    xv = np.array([[1.0, 2.0, 3.0]], np.float32)
    feeds = [{"x": xv, "p": np.array([True])},
             {"x": xv, "p": np.array([False])}]
    res = _both(_cond_prog, feeds)
    _same(res)
    np.testing.assert_allclose(res["port"][0][0], xv * 2)
    np.testing.assert_allclose(res["port"][1][0], -xv)


def test_one_key_takes_either_branch_across_runs():
    """The same executor key (same feed shapes and fetches) runs the
    branch each run's predicate selects, as a captured key's IF nodes
    do on the card."""
    xv = np.array([[1.0, -2.0, 3.0]], np.float32)
    feeds = [{"x": xv, "p": np.array([v])}
             for v in (True, False, False, True, False)]
    res = _both(_cond_prog, feeds)
    _same(res)
    for f, (o,) in zip(feeds, res["port"]):
        np.testing.assert_allclose(o, xv * (2.0 if f["p"][0] else -1.0))


def _param_prog(pk, body, shape=(4,)):
    """A program over parameter ``w`` (set in the scope), ``body(pk, w)``
    giving the loss; returns the loss and ``w``'s gradient names."""
    L = pk.L
    blk = L.data("_unused", [1]).block  # noqa: F841 (the global block)
    blk.create_parameter("w", shape=list(shape))
    loss = body(pk, blk.var("w"))
    grad = dict((p.name, g.name) for p, g in pk.app(loss))["w"]
    return [loss.name, grad]


def test_cond_gradient():
    """Gradients flow through the taken branch only."""
    def body(pk, w):
        L = pk.L
        p = L.data("p", shape=[1], dtype="bool")
        y = L.cond(p, lambda: L.scale(w, scale=2.0),
                   lambda: L.scale(w, scale=3.0))
        return L.reduce_sum(y)

    feeds = [{"p": np.array([v]), "_unused": np.zeros((1, 1), np.float32)}
             for v in (True, False)]
    res = _both(lambda pk: _param_prog(pk, body), feeds,
                {"w": np.ones(4, np.float32)})
    _same(res, GRAD)
    np.testing.assert_allclose(res["port"][0][1], np.full(4, 2.0))
    np.testing.assert_allclose(res["port"][1][1], np.full(4, 3.0))


def test_while_differentiable_scan():
    """max_iters: x doubles 3 times -> dx = 8."""
    def body(pk, w):
        L = pk.L
        i = L.fill_constant([1], "int64", 0)
        three = L.fill_constant([1], "int64", 3)
        x = L.assign(w)
        _, x_out = L.while_loop(
            lambda i, x: L.less_than(i, three),
            lambda i, x: (L.increment(i, 1.0), L.scale(x, scale=2.0)),
            [i, x], max_iters=6)
        return L.reduce_sum(x_out)

    res = _both(lambda pk: _param_prog(pk, body, (2,)),
                [{"_unused": np.zeros((1, 1), np.float32)}],
                {"w": np.array([1.0, 2.0], np.float32)})
    _same(res, GRAD)
    np.testing.assert_allclose(res["port"][0][0], 24.0)
    np.testing.assert_allclose(res["port"][0][1], [8.0, 8.0])


def test_while_loop_closure_param():
    def build(pk):
        L = pk.L
        step = L.data("step", shape=[1], dtype="float32")
        i = L.fill_constant([1], "int64", 0)
        four = L.fill_constant([1], "int64", 4)
        acc = L.fill_constant([1], "float32", 0.0)
        _, acc_out = L.while_loop(
            lambda i, acc: L.less_than(i, four),
            lambda i, acc: (L.increment(i, 1.0),
                            L.elementwise_add(acc, step)), [i, acc])
        return [acc_out.name]

    res = _both(build, [{"step": np.array([2.5], np.float32)}])
    _same(res)
    np.testing.assert_allclose(res["port"][0][0], [10.0])


def _switch_prog(pk, default=False):
    L = pk.L
    idx = L.data("idx", shape=[1], dtype="int32")
    x = L.data("x", shape=[2], dtype="float32")
    fns = [lambda: L.scale(x, scale=1.0), lambda: L.scale(x, scale=10.0)]
    if default:
        out = L.switch_case(idx, fns,
                            default=lambda: L.scale(x, scale=100.0))
    else:
        out = L.switch_case(idx, fns + [lambda: L.scale(x, scale=100.0)])
    return [out.name]


def test_switch_case():
    xv = np.array([[1.0, 2.0]], np.float32)
    cases = ((0, 1), (1, 10), (2, 100), (7, 100))       # 7 -> default
    feeds = [{"idx": np.array([[i]], np.int32), "x": xv} for i, _ in cases]
    res = _both(_switch_prog, feeds)
    _same(res)
    for (_, mult), (o,) in zip(cases, res["port"]):
        np.testing.assert_allclose(o, xv * mult)


def test_case_first_match_wins():
    def build(pk):
        L = pk.L
        x = L.data("x", shape=[1], dtype="float32")
        one = L.fill_constant([1], "float32", 1.0)
        two = L.fill_constant([1], "float32", 2.0)
        out = L.case(
            [(L.less_than(x, one), lambda: L.scale(x, scale=-1.0)),
             (L.less_than(x, two), lambda: L.scale(x, scale=10.0))],
            default=lambda: L.scale(x, scale=100.0))
        return [out.name]

    cases = ((0.5, -0.5), (1.5, 15.0), (5.0, 500.0))
    res = _both(build, [{"x": np.array([[v]], np.float32)}
                        for v, _ in cases])
    _same(res)
    for (_, want), (o,) in zip(cases, res["port"]):
        np.testing.assert_allclose(o, [[want]], rtol=1e-6)


def test_while_loop_swapped_carries():
    def build(pk):
        L = pk.L
        i = L.fill_constant([1], "int64", 0)
        one = L.fill_constant([1], "int64", 1)
        a = L.fill_constant([1], "float32", 1.0)
        b = L.fill_constant([1], "float32", 2.0)
        _, a_out, b_out = L.while_loop(
            lambda i, a, b: L.less_than(i, one),
            lambda i, a, b: (L.increment(i, 1.0), b, a), [i, a, b])
        return [a_out.name, b_out.name]

    res = _both(build, [{}])
    _same(res)
    assert res["port"][0][0][0] == 2.0 and res["port"][0][1][0] == 1.0


def test_switch_case_negative_index_runs_default():
    xv = np.array([[1.0, 2.0]], np.float32)
    res = _both(lambda pk: _switch_prog(pk, default=True),
                [{"idx": np.array([[-1]], np.int32), "x": xv}])
    _same(res)
    np.testing.assert_allclose(res["port"][0][0], xv * 100)


def test_while_shape_change_rejected():
    """Loop-variant shapes fail loudly in both."""
    for name, pk in PKGS.items():
        prog, start = pk.P(), pk.P()
        with pk.guard(prog, start):
            L = pk.L
            i = L.fill_constant([1], "int64", 0)
            n = L.fill_constant([1], "int64", 3)
            x = L.fill_constant([1], "float32", 1.0)
            _, x_out = L.while_loop(
                lambda i, x: L.less_than(i, n),
                lambda i, x: (L.increment(i, 1.0),
                              L.concat([x, x], axis=0)), [i, x])
        with pytest.raises(Exception):
            pk.exe().run(prog, fetch_list=[x_out.name], scope=pk.S())


def _dead_iteration_prog(pk, step, bias, thresh, max_iters):
    """``v <- step * v + bias`` while ``v > thresh``, with ``log(v)`` in
    the live graph (scaled by 0): NaN on any iteration past the end."""
    L = pk.L
    x = L.data("x", [1], dtype="float64")
    x.stop_gradient = False
    t = L.fill_constant([1], "float64", thresh)

    def body(v):
        lg = L.log(v)
        return L.elementwise_add(L.scale(v, scale=step, bias=bias),
                                 L.scale(lg, scale=0.0))

    out = L.while_loop(lambda v: L.less_than(t, v), body, [x],
                       max_iters=max_iters)
    loss = L.mean(out)
    pk.app(loss)
    return [loss.name, "x@GRAD"]


def test_differentiable_while_dead_iteration_no_nan():
    """The reference drives ``lax.scan`` over ``lax.cond`` directly: x
    steps down by 0.4 while x > 0 over 8 bounded iterations, ``log(x)``
    NaN once x <= 0. Here the same loop through the ``while`` op and
    ``while_grad`` of both packages: the dead iterations run nothing, so
    the gradient is finite and equal."""
    res = _both(lambda pk: _dead_iteration_prog(pk, 1.0, -0.4, 0.0, 8),
                [{"x": np.array([[1.0]])}])
    _same(res, GRAD)
    assert np.isfinite(res["port"][0][1]).all()
    np.testing.assert_allclose(res["port"][0][1], [[1.0]])


def test_differentiable_while_program_grad_finite():
    """log inside the loop body, trip count shorter than max_iters."""
    res = _both(lambda pk: _dead_iteration_prog(pk, 0.5, -0.1, 0.2, 6),
                [{"x": np.array([[2.0]])}])
    _same(res, GRAD)
    assert all(np.isfinite(v).all() for v in res["port"][0])


# ----------------------------------------------------------- beyond them
def test_cond_nested_in_a_while_body():
    """Each iteration adds 1 to ``acc`` when ``i`` is even, 10 when odd."""
    def build(pk):
        L = pk.L
        i = L.fill_constant([1], "int64", 0)
        two = L.fill_constant([1], "int64", 2)
        zero = L.fill_constant([1], "int64", 0)
        n = L.fill_constant([1], "int64", 5)
        acc = L.fill_constant([1], "float32", 0.0)

        def body(i, acc):
            even = L.equal(L.elementwise_mod(i, two), zero)
            inc = L.cond(even,
                         lambda: L.fill_constant([1], "float32", 1.0),
                         lambda: L.fill_constant([1], "float32", 10.0))
            return L.increment(i, 1.0), L.elementwise_add(acc, inc)

        _, out = L.while_loop(lambda i, acc: L.less_than(i, n), body,
                              [i, acc])
        return [out.name]

    res = _both(build, [{}])
    _same(res)
    assert res["port"][0][0][0] == 23.0


def test_a_loop_body_reads_its_carry_after_a_cond():
    """A carry that a ``cond`` made in the last iteration is read again
    after the same ``cond`` ran in this one: the body's ops see this
    iteration's values (a loop body's outputs are fresh tensors)."""
    def build(pk):
        L = pk.L
        i = L.fill_constant([1], "int64", 0)
        n = L.fill_constant([1], "int64", 4)
        h = L.fill_constant([1], "float32", 1.0)
        two = L.fill_constant([1], "float32", 2.0)

        def body(i, h):
            y = L.cond(L.less_than(h, two),
                       lambda: L.scale(h, scale=3.0),
                       lambda: L.scale(h, scale=0.5, bias=1.0))
            return L.increment(i, 1.0), L.elementwise_add(y, h)

        _, out = L.while_loop(lambda i, h: L.less_than(i, n), body, [i, h])
        return [out.name]

    res = _both(build, [{}])
    _same(res)
    h = 1.0
    for _ in range(4):
        h = (3.0 * h if h < 2.0 else 0.5 * h + 1.0) + h
    assert res["port"][0][0][0] == h


def test_dropout_in_a_loop_body_draws_the_reference_stream():
    """A seeded program's dropout inside a ``while`` body: each
    iteration draws under its own split of the loop's key, bit for bit
    the reference's (64-bit types off, as its streams are compared)."""
    def build(pk):
        L = pk.L
        x = L.data("x", [16], dtype="float32")
        i = L.fill_constant([1], "int64", 0)
        n = L.fill_constant([1], "int64", 3)
        _, out = L.while_loop(
            lambda i, h: L.less_than(i, n),
            lambda i, h: (L.increment(i, 1.0),
                          L.scale(L.dropout(h, 0.25), scale=1.5)),
            [i, x])
        return [out.name]

    x = np.random.RandomState(3).rand(4, 16).astype(np.float32) + 0.5
    with jax.enable_x64(False):
        res = _both(build, [{"x": x}, {"x": x}], seed=11)
    for a, b in zip(res["port"], res["jax"]):
        # the masks bit for bit; the kept values to XLA's fusion rounding
        np.testing.assert_array_equal(a[0] == 0, b[0] == 0)
        _close(a[0], b[0])
    assert not np.array_equal(res["port"][0][0], res["port"][1][0])
    assert (res["port"][0][0] == 0).any()


def test_switch_case_gradient():
    def body(pk, w):
        L = pk.L
        idx = L.data("idx", shape=[1], dtype="int32")
        y = L.switch_case(idx, [lambda: L.scale(w, scale=2.0),
                                lambda: L.square(w)],
                          default=lambda: L.scale(w, scale=-1.0))
        return L.reduce_sum(y)

    feeds = [{"idx": np.array([[i]], np.int32),
              "_unused": np.zeros((1, 1), np.float32)} for i in (0, 1, 5)]
    w = np.array([1.0, -2.0, 0.5, 3.0], np.float32)
    res = _both(lambda pk: _param_prog(pk, body), feeds, {"w": w})
    _same(res, GRAD)
    np.testing.assert_allclose(res["port"][1][1], 2 * w)


def test_the_key_split_is_planned_from_op_types():
    """A ``while`` without ``max_iters`` and a ``py_func`` are host
    pieces of block 0, a bounded ``while`` is not; a host op inside a
    captured body raises on the card before anything runs."""
    prog, start = Program(), Program()
    with program_guard(prog, start), unique_name.guard():
        L = TL
        x = L.data("x", [2])
        i = L.fill_constant([1], "int64", 0)
        n = L.fill_constant([1], "int64", 2)
        L.while_loop(lambda i, h: L.less_than(i, n),
                     lambda i, h: (L.increment(i, 1.0), L.scale(h, 2.0)),
                     [i, x])
        L.while_loop(lambda i, h: L.less_than(i, n),
                     lambda i, h: (L.increment(i, 1.0), L.scale(h, 2.0)),
                     [i, x], max_iters=3)
        out = prog.global_block().create_var("pyout", shape=[-1, 2])
        out.dtype = "float32"
        L.py_func(lambda a: a + 1.0, x, out)
        L.scale(out, 3.0)
    types_ = [op.type for op in prog.global_block().ops]
    pieces = plan_pieces(prog, on_card=True)
    hosts = [types_[a] for a, b, host in pieces if host]
    assert hosts[0] == "while" and hosts[1].startswith("py_func_")
    assert len(hosts) == 2 and not pieces[-1][2]
    assert [p for p in pieces if not p[2]][-1][1] == len(types_)
    # the JAX package has no such split: both give the same values here
    feed = {"x": np.ones((1, 2), np.float32)}
    (got,) = Executor("cpu").run(prog, feed=feed, fetch_list=["pyout"],
                                 scope=Scope())
    np.testing.assert_allclose(got, [[2.0, 2.0]])

    nested, start = Program(), Program()
    with program_guard(nested, start), unique_name.guard():
        p = TL.data("p", [1], dtype="bool", append_batch_size=False)
        i = TL.fill_constant([1], "int64", 0)
        n = TL.fill_constant([1], "int64", 2)
        TL.cond(p, lambda: TL.while_loop(
            lambda i: TL.less_than(i, n),
            lambda i: [TL.increment(i, 1.0)], [i]),
            lambda: TL.increment(i, 5.0))
    with pytest.raises(NotImplementedError, match="host op"):
        plan_pieces(nested, on_card=True)
    assert plan_pieces(nested, on_card=False)[-1] == (0, len(
        nested.global_block().ops), False)


# -------------------------------------------------------- phase 25 at size
SMALL = dict(d_model=64, num_heads=2, d_ffn=128, seq=64)


@pytest.fixture
def _flash_at_64():
    saved = jflags.get_flags(["pallas_min_seq"])
    jflags.set_flags({"pallas_min_seq": 64})
    tflags.set_flags({"pallas_min_seq": 64})
    yield
    jflags.set_flags(saved)


def _copy_scope(jscope):
    return scope_from_numpy({n: jscope.get_numpy(n)
                             for n in jscope.var_names()}, "cpu")


def test_warmup_encoder_matches_jax_per_step(_flash_at_64):
    """Phase 25 (b): the encoder whose lr is Transformer-base's warm-up
    (``layers.case`` on a step counter, W = 3) for 5 steps, both warm-up
    and decay branches: lr, loss and the state per step against the JAX
    package; the lr against the closed form. The schedule is scaled by
    1e-3: at d 64 the paper's peaks near 0.07, where Adam's first
    updates (lr x sign(g)) turn rounding noise into differences of lr."""
    jl, tl = se.NoamLR(3, 1e-3), se.NoamLR(3, 1e-3)
    jm, js, jloss = se.build_encoder_program(2, **SMALL, lr=jl,
                                             static=JSTATIC)
    tm, _, tloss = se.build_encoder_program(2, **SMALL, lr=tl)
    assert jm.to_json() == tm.to_json()
    jscope, jexe = JScope(), JExecutor()
    jexe.run(js, scope=jscope)
    tscope, texe = _copy_scope(jscope), Executor("cpu")
    x = np.random.RandomState(5).randn(2, SMALL["seq"], SMALL["d_model"]) \
        .astype(np.float32)
    for step in range(1, 6):
        a = jexe.run(jm, feed={"x": x}, fetch_list=[jloss.name, jl.var.name],
                     scope=jscope)
        b = texe.run(tm, feed={"x": x}, fetch_list=[tloss.name, tl.var.name],
                     scope=tscope)
        np.testing.assert_allclose(b[0], a[0], rtol=1e-5)
        _close(b[1], a[1])
        assert float(b[1][0]) == tl.closed_form(step, SMALL["d_model"])
    for n in jscope.var_names():
        _close(tscope.get_numpy(n), jscope.get_numpy(n), GRAD)


def test_shared_layer_loop_matches_jax_and_its_unrolled_twin(_flash_at_64):
    """Phase 25 (c): one shared layer under ``while_loop``, forward at
    fed trip counts (2, 0, 3) against the JAX package and, on the port,
    bit for bit against its unrolled twin; then with ``max_iters=3``
    trained at trip counts 3, 3, 2 against the JAX package per step."""
    kw = dict(SMALL)
    x = np.random.RandomState(6).randn(2, kw["seq"], kw["d_model"]) \
        .astype(np.float32)
    jm, js, jout, _ = se.build_loop_program(**kw, static=JSTATIC)
    tm, _, tout, _ = se.build_loop_program(**kw)
    assert jm.to_json() == tm.to_json()
    jscope, jexe = JScope(), JExecutor()
    jexe.run(js, scope=jscope)
    tscope, texe = _copy_scope(jscope), Executor("cpu")
    for n in (2, 0, 3):
        feed = {"x": x, "n": np.array([n], np.int64)}
        (a,) = jexe.run(jm, feed=feed, fetch_list=[jout.name], scope=jscope)
        (b,) = texe.run(tm, feed=feed, fetch_list=[tout.name], scope=tscope)
        _close(b, a, GRAD)
        um, _, uout, _ = se.build_unrolled_program(n, **kw)
        (c,) = texe.run(um, feed={"x": x}, fetch_list=[uout.name],
                        scope=tscope)
        np.testing.assert_array_equal(b, c)

    jm, js, _, jloss = se.build_loop_program(**kw, max_iters=3,
                                             static=JSTATIC)
    tm, _, _, tloss = se.build_loop_program(**kw, max_iters=3)
    assert jm.to_json() == tm.to_json()
    jscope = JScope()
    jexe.run(js, scope=jscope)
    tscope = _copy_scope(jscope)
    for n in (3, 3, 2):
        feed = {"x": x, "n": np.array([n], np.int64)}
        (a,) = jexe.run(jm, feed=feed, fetch_list=[jloss.name],
                        scope=jscope)
        (b,) = texe.run(tm, feed=feed, fetch_list=[tloss.name],
                        scope=tscope)
        np.testing.assert_allclose(b, a, rtol=1e-5)
    for n in jscope.var_names():
        _close(tscope.get_numpy(n), jscope.get_numpy(n), GRAD)


# ------------------------------------------------------ the kernel streams
_CUDA = pathlib.Path(__file__).resolve().parents[1] / "paddle_tpu_torch" \
    / "ops" / "cuda"


def test_kernel_wrappers_read_the_stream_at_each_call(monkeypatch):
    """Inside an IF body the current stream is the body's own, so no
    wrapper may hold a stream handle: every ``cuda_stream`` a kernel
    module passes is read from ``torch.cuda.current_stream()`` in the
    launching function, and two calls under two streams pass each its
    own."""
    for path in sorted(_CUDA.glob("*.py")):
        tree = ast.parse(path.read_text())
        for node in tree.body:          # no module-level stream handle
            if isinstance(node, (ast.Assign, ast.AnnAssign)):
                assert "current_stream" not in ast.unparse(node), path.name
        if path.name == "cond_graph.py":
            continue                     # its body streams are its own
        for node in ast.walk(tree):
            if isinstance(node, ast.Attribute) and node.attr == "cuda_stream":
                assert isinstance(node.value, ast.Call) and \
                    ast.unparse(node.value.func).endswith(
                        "current_stream"), (path.name, ast.unparse(node))

    from paddle_tpu_torch.ops.cuda import flash_attention, layer_norm
    streams = iter(range(101, 200))
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None:
                        types.SimpleNamespace(cuda_stream=next(streams)))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    counts = jit.launch_counts()
    seen = []
    try:
        for _ in range(2):
            layer_norm._run("ln_fwd", lambda *a: seen.append(a[-1]) or 0,
                            "cuda")
            flash_attention._run("flash_fwd", "simt",
                                 lambda *a: seen.append(a[-1]) or 0, "cuda")
    finally:
        jit._set_launch_counts(counts)
    assert seen == [101, 102, 103, 104]


def test_host_reads_are_counted_only_on_the_card():
    before = cf.host_reads
    assert cf.read_pred(torch.tensor([True])) is True
    assert cf.host_reads == before
