"""The port's static-graph plane against the JAX package on the CPU: the
op registry and its lowerings, the Program IR, ``append_backward``, the
Executor, the ``layers`` builders and ``Optimizer.minimize``.

- Programs built by both packages (``models/ctr.py``'s Wide&Deep and
  ``models/static_encoder.py``'s encoder, 2 layers at width 128) under
  ``unique_name.guard()`` serialize to the same JSON, character for
  character; a JSON saved by one package loads and runs in the other.
- The counterparts of ``tests/test_framework_core.py`` and
  ``tests/test_backward_regressions.py``.
- One parametrised test over every op the port registers: its outputs,
  and its generic or registered grad, against the JAX lowering's on the
  same seeded inputs.
- ``Scope.set_var`` into a tensor a captured step holds,
  ``FLAGS_check_nan_inf``, the ``exec.step`` fault point, the waiting
  parts raising with their items.

Tolerances: f32 results within ``2e-6 + 2e-5 |ref|`` (the two sides
differ in the order of sums), products, normalizations and attention
within ``1e-5 + 1e-4 |ref|``; integer results and ``uniform_random``
bit for bit; the normal draws within ``1e-5 + 1e-5 |ref|`` (torch's
``erfinv`` rounds otherwise than XLA's). Random streams are compared
with JAX's 64-bit types off (``jax.enable_x64(False)``), the streams
the port reproduces. Whole programs: losses within 1e-5 relative and
state within ``1e-5 + 1e-4 |ref|`` after the steps.
"""

import types
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.flags as jflags
import paddle_tpu.layers as JL
import paddle_tpu.optimizer as JO
from paddle_tpu.framework import Executor as JExecutor
from paddle_tpu.framework import Program as JProgram
from paddle_tpu.framework import Scope as JScope
from paddle_tpu.framework import program_guard as jguard
from paddle_tpu.framework import unique_name as jun
from paddle_tpu.models.ctr import build_wide_deep_program as jwide
from paddle_tpu.ops import registry as jreg
from paddle_tpu.resilience.injector import fault_scope as jfault_scope

from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch import prng
from paddle_tpu_torch import static as tstatic
from paddle_tpu_torch.framework import (Executor, NanInfError, Program,
                                        Scope, append_backward, gradients,
                                        program_guard, unique_name)
from paddle_tpu_torch.framework import executor as texec
from paddle_tpu_torch.models.convert import scope_from_numpy
from paddle_tpu_torch.models.ctr import build_wide_deep_program as twide
from paddle_tpu_torch.models.static_encoder import build_encoder_program
from paddle_tpu_torch.ops import registry as treg
from paddle_tpu_torch.resilience.injector import fault_scope

JSTATIC = types.SimpleNamespace(layers=JL, Program=JProgram,
                                program_guard=jguard, unique_name=jun,
                                AdamW=JO.AdamW)
ENC = dict(num_layers=2, d_model=128, num_heads=2, d_ffn=256, seq=64)


@pytest.fixture(autouse=True)
def _port_flags():
    """The suite's environment turns on FLAGS_check_program, whose
    verifier the port has not yet (ROADMAP A7.3): off for the port here,
    as every other flag this file sets is put back."""
    saved = tflags.get_flags(["check_program", "use_pallas_layer_norm",
                              "pallas_min_seq", "check_nan_inf"])
    tflags.set_flags({"check_program": False})
    yield
    tflags.set_flags(saved)


def _close(out, ref, tol=(2e-6, 2e-5)):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    if ref.dtype.kind in "biu":
        np.testing.assert_array_equal(out, ref)
    else:
        np.testing.assert_allclose(out.astype(np.float64),
                                   ref.astype(np.float64), atol=tol[0],
                                   rtol=tol[1])


def _scopes(jscope):
    return scope_from_numpy({n: jscope.get_numpy(n)
                             for n in jscope.var_names()}, "cpu")


# ------------------------------------------------------ programs and JSON
def test_programs_serialize_to_the_reference_json_and_load_across():
    kw = dict(num_slots=4, embed_dim=4, hidden_sizes=(8,), host_paced=True)
    jm, js, _, _ = jwide(**kw)
    tm, ts, _, _ = twide(**kw)
    assert jm.to_json() == tm.to_json()
    assert js.to_json() == ts.to_json()
    jm, js, jl = build_encoder_program(**ENC, static=JSTATIC)
    tm, ts, tl = build_encoder_program(**ENC)
    assert jm.to_json() == tm.to_json()
    assert js.to_json() == ts.to_json()
    assert tm.fingerprint() == jm.fingerprint()
    # a JSON saved by either package loads and runs in the other: the
    # encoder's startup (seeded: the same weights) and one step
    t_main, t_start = Program.from_json(jm.to_json()), \
        Program.from_json(js.to_json())
    j_main, j_start = JProgram.from_json(tm.to_json()), \
        JProgram.from_json(ts.to_json())
    jscope, tscope = JScope(), Scope()
    JExecutor().run(j_start, scope=jscope)
    Executor("cpu").run(t_start, scope=tscope)
    assert sorted(jscope.var_names()) == sorted(tscope.var_names())
    for n in jscope.var_names():
        np.testing.assert_array_equal(jscope.get_numpy(n),
                                      tscope.get_numpy(n))
    x = np.random.RandomState(0).randn(2, ENC["seq"], ENC["d_model"]) \
        .astype(np.float32)
    (a,) = JExecutor().run(j_main, feed={"x": x}, fetch_list=[jl.name],
                           scope=jscope)
    (b,) = Executor("cpu").run(t_main, feed={"x": x}, fetch_list=[tl.name],
                               scope=tscope)
    _close(b, a, (1e-6, 1e-5))
    for n in jscope.var_names():
        _close(tscope.get_numpy(n), jscope.get_numpy(n), (1e-5, 1e-4))


@pytest.mark.parametrize("kernels", [False, True])
def test_encoder_steps_match_jax(kernels):
    """Two AdamW steps of the encoder from the JAX startup's scope. With
    ``kernels`` the flash and LayerNorm routes are taken on both sides
    (the Pallas kernels in interpret mode, the CUDA kernels' plain
    versions), their gradients through the generic grad."""
    seq_flag = 64 if kernels else 1024
    saved = jflags.get_flags(["use_pallas_layer_norm", "pallas_min_seq"])
    jflags.set_flags({"use_pallas_layer_norm": kernels,
                      "pallas_min_seq": seq_flag})
    tflags.set_flags({"use_pallas_layer_norm": kernels,
                      "pallas_min_seq": seq_flag})
    try:
        jm, js, jl = build_encoder_program(**ENC, static=JSTATIC)
        tm, _, tl = build_encoder_program(**ENC)
        jscope, jexe = JScope(), JExecutor()
        jexe.run(js, scope=jscope)
        tscope, texe = _scopes(jscope), Executor("cpu")
        x = np.random.RandomState(1).randn(2, ENC["seq"], ENC["d_model"]) \
            .astype(np.float32)
        for _ in range(2):
            (a,) = jexe.run(jm, feed={"x": x}, fetch_list=[jl.name],
                            scope=jscope)
            (b,) = texe.run(tm, feed={"x": x}, fetch_list=[tl.name],
                            scope=tscope)
            np.testing.assert_allclose(b, a, rtol=1e-5)
        for n in jscope.var_names():
            _close(tscope.get_numpy(n), jscope.get_numpy(n), (1e-5, 1e-4))
    finally:
        jflags.set_flags(saved)


# -------------------------------------- counterparts of the core tests
def test_program_build_and_serialize():
    prog = Program()
    blk = prog.global_block()
    x = blk.create_var("x", shape=[2, 3], dtype="float32", is_data=True)
    w = blk.create_parameter("w", shape=[3, 4])
    out = blk.create_var("out", shape=[2, 4])
    blk.append_op("matmul_v2", inputs={"X": x, "Y": w}, outputs={"Out": out})
    prog2 = Program.from_json(prog.to_json())
    assert prog2.global_block().ops[0].type == "matmul_v2"
    assert prog2.global_block().var("w").is_parameter
    assert prog2.fingerprint() == prog.fingerprint()
    assert blk.create_var("i", dtype=torch.int64).dtype == "int64"


def _matmul_scale(P):
    prog = P()
    blk = prog.global_block()
    blk.create_var("x", shape=[2, 3], is_data=True)
    blk.create_var("y", shape=[3, 4], is_data=True)
    blk.append_op("matmul_v2", {"X": "x", "Y": "y"}, {"Out": "xy"})
    blk.create_var("xy")
    blk.append_op("scale", {"X": "xy"}, {"Out": "out"}, {"scale": 2.0})
    blk.create_var("out")
    return prog


def test_executor_matmul_add():
    rng = np.random.RandomState(0)
    feed = {"x": rng.randn(2, 3).astype(np.float32),
            "y": rng.randn(3, 4).astype(np.float32)}
    (a,) = JExecutor().run(_matmul_scale(JProgram), feed=feed,
                           fetch_list=["out"], scope=JScope())
    (b,) = Executor("cpu").run(_matmul_scale(Program), feed=feed,
                               fetch_list=["out"], scope=Scope())
    _close(b, a)
    _close(b, 2.0 * feed["x"] @ feed["y"], (1e-6, 1e-5))


def test_executor_persistable_state_update_in_place():
    """The sgd op's new parameter is written into the scope's own tensor
    (the port's state in place); the values are the reference's."""
    scope = Scope()
    prog = Program()
    blk = prog.global_block()
    blk.create_parameter("p", shape=[4])
    blk.create_var("g", shape=[4], is_data=True)
    blk.create_var("lr", shape=[1], is_data=True)
    blk.append_op("sgd", {"Param": "p", "Grad": "g", "LearningRate": "lr"},
                  {"ParamOut": "p"})
    p = torch.ones(4)
    scope.set_var("p", p)
    exe = Executor("cpu")
    feed = {"g": np.ones(4, np.float32), "lr": np.array([0.1], np.float32)}
    exe.run(prog, feed=feed, fetch_list=[], scope=scope)
    np.testing.assert_allclose(scope.get_numpy("p"), 0.9 * np.ones(4),
                               rtol=1e-6)
    exe.run(prog, feed=feed, fetch_list=[], scope=scope)
    np.testing.assert_allclose(scope.get_numpy("p"), 0.8 * np.ones(4),
                               rtol=1e-6)
    assert scope.find_var("p") is p          # one tensor, written in place


def _linear_prog(P):
    prog = P()
    blk = prog.global_block()
    blk.create_var("x", shape=[2, 3], is_data=True)
    blk.create_parameter("w", shape=[3, 4])
    blk.create_var("xw")
    blk.append_op("matmul_v2", {"X": "x", "Y": "w"}, {"Out": "xw"})
    blk.create_var("loss")
    blk.append_op("mean", {"X": "xw"}, {"Out": "loss"})
    return prog, blk.var("loss")


def _accum_prog(P):
    prog = P()
    blk = prog.global_block()
    blk.create_parameter("w", shape=[3])
    for n, s in (("a", 2.0), ("b", 3.0)):
        blk.create_var(n)
        blk.append_op("scale", {"X": "w"}, {"Out": n}, {"scale": s})
    blk.create_var("s")
    blk.append_op("elementwise_add", {"X": "a", "Y": "b"}, {"Out": "s"})
    blk.create_var("loss")
    blk.append_op("reduce_sum", {"X": "s"}, {"Out": "loss"},
                  {"reduce_all": True})
    return prog, blk.var("loss")


@pytest.mark.parametrize("case", ["linear", "accumulating"])
def test_append_backward_like_the_reference(case):
    from paddle_tpu.framework import append_backward as japp
    make = _linear_prog if case == "linear" else _accum_prog
    jprog, jloss = make(JProgram)
    tprog, tloss = make(Program)
    jpg, tpg = japp(jloss), append_backward(tloss)
    assert [(p.name, g.name) for p, g in jpg] == \
        [(p.name, g.name) for p, g in tpg]
    assert jprog.to_json() == tprog.to_json()
    w = np.random.RandomState(2).randn(*tprog.global_block().var("w")
                                       .shape).astype(np.float32)
    jscope = JScope()
    jscope.set_var("w", jnp.asarray(w))
    feed = ({"x": np.random.RandomState(3).randn(2, 3).astype(np.float32)}
            if case == "linear" else {})
    (a,) = JExecutor().run(jprog, feed=feed, fetch_list=[jpg[0][1].name],
                           scope=jscope)
    (b,) = Executor("cpu").run(tprog, feed=feed,
                               fetch_list=[tpg[0][1].name],
                               scope=_scopes(jscope))
    _close(b, a)
    if case == "accumulating":
        np.testing.assert_allclose(b, 5.0 * np.ones(3))


def test_clone_for_test_and_prune():
    prog = Program()
    blk = prog.global_block()
    blk.create_var("x", is_data=True)
    blk.create_var("y")
    blk.append_op("dropout", {"X": "x"}, {"Out": "y", "Mask": "m"},
                  {"dropout_prob": 0.5, "is_test": False})
    blk.create_var("m")
    t = prog.clone(for_test=True)
    assert t.global_block().ops[0].attrs["is_test"] is True
    assert prog.global_block().ops[0].attrs["is_test"] is False

    # _prune keeps exactly the slice feeding the target and runs alone
    import paddle_tpu_torch.layers as layers
    out = {}
    for name, (L, P, guard, un, exe) in {
            "jax": (JL, JProgram, jguard, jun, JExecutor()),
            "port": (layers, Program, program_guard, unique_name,
                     Executor("cpu"))}.items():
        main, startup = P(), P()
        main.random_seed = startup.random_seed = 3
        with guard(main, startup), un.guard():
            x = L.data("x", [4])
            y = L.data("y", [1])
            pred = L.fc(x, 1)
            loss = L.reduce_mean(L.square(L.elementwise_sub(pred, y)))
            L.mean(loss)
        pruned = main._prune([pred], keep_var_names=["x", "y"])
        types_ = [op.type for op in pruned.global_block().ops]
        assert types_ == ["mul", "elementwise_add"], types_
        assert pruned.global_block().var("y") is not None
        scope = JScope() if name == "jax" else Scope()
        exe.run(startup, scope=scope)
        (out[name],) = exe.run(pruned, feed={"x": np.ones((2, 4),
                                                          np.float32)},
                               fetch_list=[pred.name], scope=scope)
        out[name + "_json"] = pruned.to_json()
    assert out["jax_json"] == out["port_json"]
    _close(out["port"], out["jax"])


def _rng_prog(P, op, attrs):
    prog = P()
    prog.random_seed = 42
    blk = prog.global_block()
    blk.create_var("r")
    blk.append_op(op, {}, {"Out": "r"}, {"shape": [64], **attrs})
    return prog


@pytest.mark.parametrize("op,attrs", [
    ("uniform_random", {"min": -0.3, "max": 0.7}),
    ("gaussian_random", {"mean": 0.5, "std": 2.0}),
    ("truncated_gaussian_random", {"mean": 0.0, "std": 1.0})])
def test_seeded_rng_determinism_and_the_reference_stream(op, attrs):
    """A seeded program draws the same values in two executors, and the
    reference's: ``uniform_random`` bit for bit, the normal ops to a few
    ulps; the second run of one executor draws anew (the counter)."""
    (r1,) = Executor("cpu").run(_rng_prog(Program, op, attrs),
                                fetch_list=["r"], scope=Scope())
    exe = Executor("cpu")
    prog = _rng_prog(Program, op, attrs)
    (r2,) = exe.run(prog, fetch_list=["r"], scope=Scope())
    (r3,) = exe.run(prog, fetch_list=["r"], scope=Scope())
    np.testing.assert_array_equal(r1, r2)
    assert not np.array_equal(r2, r3)
    with jax.enable_x64(False):
        jexe = JExecutor()
        jprog = _rng_prog(JProgram, op, attrs)
        j2 = np.asarray(jexe.run(jprog, fetch_list=["r"],
                                 scope=JScope())[0])
        j3 = np.asarray(jexe.run(jprog, fetch_list=["r"],
                                 scope=JScope())[0])
    for a, b in ((r2, j2), (r3, j3)):
        if op == "uniform_random":
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-5)


def _scale_prog(P):
    prog = P()
    blk = prog.global_block()
    blk.create_var("x", is_data=True)
    blk.create_var("y")
    blk.append_op("scale", {"X": "x"}, {"Out": "y"}, {"scale": 2.0})
    return prog, blk


def test_program_mutation_and_scope_population_invalidate_the_cache():
    prog, blk = _scale_prog(Program)
    exe = Executor("cpu")
    x = np.ones(3, np.float32)
    (y,) = exe.run(prog, feed={"x": x}, fetch_list=["y"], scope=Scope())
    np.testing.assert_allclose(y, 2.0 * x)
    blk.append_op("scale", {"X": "y"}, {"Out": "z"}, {"scale": 5.0})
    blk.create_var("z")
    (z,) = exe.run(prog, feed={"x": x}, fetch_list=["z"], scope=Scope())
    np.testing.assert_allclose(z, 10.0 * x)

    prog = Program()
    blk = prog.global_block()
    blk.create_var("x", is_data=True)
    blk.create_parameter("w", shape=[3])
    blk.create_var("o")
    blk.append_op("elementwise_mul", {"X": "x", "Y": "w"}, {"Out": "o"})
    scope = Scope()
    with pytest.raises(KeyError, match="not defined"):
        exe.run(prog, feed={"x": x}, fetch_list=["o"], scope=scope)
    scope.set_var("w", np.arange(3, dtype=np.float32))
    (o,) = exe.run(prog, feed={"x": x}, fetch_list=["o"], scope=scope)
    np.testing.assert_allclose(o, [0, 1, 2])


def test_gradients_and_partial_grads():
    from paddle_tpu.framework import append_backward as japp
    from paddle_tpu.framework import gradients as jgrads
    out = {}
    for name, (P, app, grads_, exe, S) in {
            "jax": (JProgram, japp, jgrads, JExecutor(), JScope),
            "port": (Program, append_backward, gradients, Executor("cpu"),
                     Scope)}.items():
        prog = P()
        blk = prog.global_block()
        blk.create_var("x", shape=[3], is_data=True)
        blk.vars["x"].stop_gradient = False
        for n, s in (("a", 2.0), ("b", 3.0)):
            blk.create_var(n)
            blk.append_op("scale", {"X": "x"}, {"Out": n}, {"scale": s})
        blk.create_var("s")
        blk.append_op("elementwise_add", {"X": "a", "Y": "b"}, {"Out": "s"})
        blk.create_var("loss")
        blk.append_op("reduce_sum", {"X": "s"}, {"Out": "loss"},
                      {"reduce_all": True})
        (gx,) = grads_(blk.var("loss"), blk.var("x"))
        (out[name],) = exe.run(prog, feed={"x": np.ones(3, np.float32)},
                               fetch_list=[gx.name], scope=S())
        # only split's middle output feeds the loss
        prog = P()
        blk = prog.global_block()
        blk.create_parameter("w", shape=[6])
        for n in ("o1", "o2", "o3"):
            blk.create_var(n)
        blk.append_op("split", {"X": "w"}, {"Out": ["o1", "o2", "o3"]},
                      {"num": 3})
        blk.create_var("loss")
        blk.append_op("reduce_sum", {"X": "o2"}, {"Out": "loss"},
                      {"reduce_all": True})
        pg = app(blk.var("loss"))
        scope = S()
        scope.set_var("w", np.arange(6, dtype=np.float32) if name == "port"
                      else jnp.arange(6, dtype=jnp.float32))
        (out[name + "_split"],) = exe.run(prog, fetch_list=[pg[0][1].name],
                                          scope=scope)
        out[name + "_json"] = prog.to_json()
    np.testing.assert_allclose(out["port"], 5.0 * np.ones(3))
    _close(out["port"], out["jax"])
    np.testing.assert_allclose(out["port_split"], [0, 0, 1, 1, 0, 0])
    assert out["port_json"] == out["jax_json"]


# ----------------------------------------------- every registered op
def _f(rng, *shape, pos=False):
    a = rng.randn(*shape).astype(np.float32)
    return np.abs(a) + 0.5 if pos else a


def _ids(rng, hi, *shape):
    return rng.randint(0, hi, shape).astype(np.int64)


def _opt_ins(rng, **accums):
    ins = {"Param": [_f(rng, 3, 4)], "Grad": [_f(rng, 3, 4)],
           "LearningRate": [np.array([0.01], np.float32)]}
    for slot, kind in accums.items():
        ins[slot] = [{"pos": _f(rng, 3, 4, pos=True) * 0.01,
                      "f": _f(rng, 3, 4) * 0.1,
                      "b1": np.array([0.9], np.float32),
                      "b2": np.array([0.999], np.float32)}[kind]]
    return ins


_ADAM = dict(Moment1="f", Moment2="pos", Beta1Pow="b1", Beta2Pow="b2")
_PROD = (1e-5, 1e-4)

#: case id -> (op type, inputs(rng), attrs, tolerance); a case id holds
#: its op's name before any ":" (variants of one op)
OP_CASES = {
    "abs": ("abs", lambda r: {"X": [_f(r, 3, 4)]}, {}, None),
    "accuracy": ("accuracy", lambda r: {"Out": [_f(r, 4, 1)],
                                        "Indices": [_ids(r, 3, 4, 1)],
                                        "Label": [_ids(r, 3, 4, 1)]},
                 {}, None),
    "adagrad": ("adagrad", lambda r: _opt_ins(r, Moment="pos"),
                {"epsilon": 1e-6}, None),
    "adam": ("adam", lambda r: _opt_ins(r, **_ADAM),
             {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}, None),
    "adamw": ("adamw", lambda r: _opt_ins(r, **_ADAM),
              {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8,
               "coeff": 0.01, "with_decay": True}, None),
    "arg_max": ("arg_max", lambda r: {"X": [_f(r, 3, 5)]}, {"axis": -1},
                None),
    "arg_min": ("arg_min", lambda r: {"X": [_f(r, 3, 5)]},
                {"axis": 0, "keepdims": True}, None),
    "assign": ("assign", lambda r: {"X": [_f(r, 3, 4)]}, {}, None),
    "assign_value": ("assign_value", lambda r: {},
                     {"shape": [2, 3], "dtype": "float32",
                      "values": [0.5, 1.5, -2.0, 3.0, 4.25, -1.0]}, None),
    "batch_norm": ("batch_norm", lambda r: {
        "X": [_f(r, 2, 3, 4, 4)], "Scale": [_f(r, 3)], "Bias": [_f(r, 3)],
        "Mean": [_f(r, 3)], "Variance": [_f(r, 3, pos=True)]},
        {"momentum": 0.9, "epsilon": 1e-5, "is_test": False}, _PROD),
    "cast": ("cast", lambda r: {"X": [_f(r, 3, 4)]},
             {"out_dtype": "float64", "in_dtype": "float32"}, None),
    "clip": ("clip", lambda r: {"X": [_f(r, 3, 4)]},
             {"min": -0.5, "max": 0.5}, None),
    "clip_by_norm": ("clip_by_norm", lambda r: {"X": [_f(r, 3, 4)]},
                     {"max_norm": 1.0}, None),
    "concat": ("concat", lambda r: {"X": [_f(r, 2, 3), _f(r, 2, 4)]},
               {"axis": 1}, None),
    "conv2d": ("conv2d", lambda r: {"Input": [_f(r, 2, 3, 6, 6)],
                                    "Filter": [_f(r, 4, 3, 3, 3)]},
               {"strides": [1, 1], "paddings": [1, 1], "dilations": [1, 1],
                "groups": 1}, _PROD),
    "conv2d:asym": ("conv2d", lambda r: {"Input": [_f(r, 1, 4, 7, 7)],
                                         "Filter": [_f(r, 4, 2, 3, 3)]},
                    {"strides": [2, 1], "paddings": [0, 1, 2, 0],
                     "dilations": [1, 2], "groups": 2}, _PROD),
    "cross_entropy": ("cross_entropy", lambda r: {
        "X": [np.abs(_f(r, 4, 5)) + 0.1], "Label": [_ids(r, 5, 4, 1)]},
        {}, None),
    "dropout": ("dropout", lambda r: {"X": [_f(r, 4, 8)]},
                {"dropout_prob": 0.3, "is_test": False}, None),
    "elementwise_add": ("elementwise_add", lambda r: {
        "X": [_f(r, 2, 3, 4)], "Y": [_f(r, 3)]}, {"axis": 1}, None),
    "elementwise_div": ("elementwise_div", lambda r: {
        "X": [_f(r, 2, 3, 4)], "Y": [_f(r, 3, 4, pos=True)]}, {}, None),
    "elementwise_max": ("elementwise_max", lambda r: {
        "X": [_f(r, 2, 3)], "Y": [_f(r, 2, 3)]}, {}, None),
    "elementwise_min": ("elementwise_min", lambda r: {
        "X": [_f(r, 2, 3)], "Y": [_f(r, 2, 3)]}, {}, None),
    "elementwise_mul": ("elementwise_mul", lambda r: {
        "X": [_f(r, 2, 3, 4)], "Y": [_f(r, 4)]}, {}, None),
    "elementwise_sub": ("elementwise_sub", lambda r: {
        "X": [_f(r, 2, 3)], "Y": [_f(r, 2, 3)]}, {}, None),
    "exp": ("exp", lambda r: {"X": [_f(r, 3, 4)]}, {}, None),
    "fill_constant": ("fill_constant", lambda r: {},
                      {"shape": [2, 3], "dtype": "int64", "value": 3.0},
                      None),
    "fill_constant_like": ("fill_constant_like",
                           lambda r: {"X": [_f(r, 3, 4)]}, {"value": 2.5},
                           None),
    "fill_zeros_like": ("fill_zeros_like", lambda r: {"X": [_f(r, 3)]}, {},
                        None),
    "flatten2": ("flatten2", lambda r: {"X": [_f(r, 2, 3, 4)]},
                 {"axis": 2}, None),
    "ftrl": ("ftrl", lambda r: _opt_ins(r, SquaredAccumulator="pos",
                                        LinearAccumulator="f"),
             {"l1": 0.01, "l2": 0.01, "lr_power": -0.5}, _PROD),
    "fused_attention_qkv": ("fused_attention_qkv", lambda r: {
        "Q": [_f(r, 1, 2, 8, 4)], "K": [_f(r, 1, 2, 8, 4)],
        "V": [_f(r, 1, 2, 8, 4)]}, {"causal": False}, _PROD),
    "fused_attention_qkv:causal_mask": ("fused_attention_qkv", lambda r: {
        "Q": [_f(r, 1, 2, 8, 4)], "K": [_f(r, 1, 2, 8, 4)],
        "V": [_f(r, 1, 2, 8, 4)], "Mask": [_f(r, 1, 1, 8, 8)]},
        {"causal": True}, _PROD),
    "gaussian_random": ("gaussian_random", lambda r: {},
                        {"shape": [3, 4], "mean": 0.5, "std": 2.0},
                        (1e-5, 1e-5)),
    "gelu": ("gelu", lambda r: {"X": [_f(r, 3, 4)]}, {}, None),
    "gelu:tanh": ("gelu", lambda r: {"X": [_f(r, 3, 4)]},
                  {"approximate": True}, None),
    "increment": ("increment", lambda r: {"X": [_ids(r, 9, 1)]},
                  {"step": 1.0}, None),
    "lamb": ("lamb", lambda r: _opt_ins(r, **_ADAM),
             {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-6,
              "weight_decay": 0.01}, _PROD),
    "lars_momentum": ("lars_momentum", lambda r: _opt_ins(r, Velocity="f"),
                      {"mu": 0.9, "lars_coeff": 0.001,
                       "lars_weight_decay": 0.0005}, _PROD),
    "layer_norm": ("layer_norm", lambda r: {
        "X": [_f(r, 2, 3, 16)], "Scale": [_f(r, 16)], "Bias": [_f(r, 16)]},
        {"epsilon": 1e-5, "begin_norm_axis": 2}, _PROD),
    "layer_norm:two_axes": ("layer_norm", lambda r: {
        "X": [_f(r, 2, 3, 4)], "Scale": [_f(r, 12)]},
        {"epsilon": 1e-5, "begin_norm_axis": 1}, _PROD),
    "log": ("log", lambda r: {"X": [_f(r, 3, 4, pos=True)]}, {}, None),
    "log_softmax": ("log_softmax", lambda r: {"X": [_f(r, 3, 5)]},
                    {"axis": -1}, None),
    "logsigmoid": ("logsigmoid", lambda r: {"X": [_f(r, 3, 4)]}, {}, None),
    "lookup_table": ("lookup_table", lambda r: {
        "W": [_f(r, 10, 4)], "Ids": [_ids(r, 10, 5, 1)]}, {}, None),
    "lookup_table_v2": ("lookup_table_v2", lambda r: {
        "W": [_f(r, 10, 4)], "Ids": [_ids(r, 10, 2, 6)]},
        {"padding_idx": 0}, None),
    "matmul": ("matmul", lambda r: {"X": [_f(r, 2, 4, 3)],
                                    "Y": [_f(r, 2, 4, 5)]},
               {"transpose_X": True, "alpha": 2.0}, _PROD),
    "matmul_v2": ("matmul_v2", lambda r: {"X": [_f(r, 3, 4)],
                                          "Y": [_f(r, 5, 4)]},
                  {"trans_y": True}, _PROD),
    "mean": ("mean", lambda r: {"X": [_f(r, 3, 4)]}, {}, None),
    "momentum": ("momentum", lambda r: _opt_ins(r, Velocity="f"),
                 {"mu": 0.9, "use_nesterov": True}, None),
    "mul": ("mul", lambda r: {"X": [_f(r, 2, 3, 4)], "Y": [_f(r, 4, 5)]},
            {"x_num_col_dims": 2, "y_num_col_dims": 1}, _PROD),
    "one_hot": ("one_hot", lambda r: {"X": [_ids(r, 5, 4, 1)]},
                {"depth": 5}, None),
    "one_hot_v2": ("one_hot_v2", lambda r: {"X": [_ids(r, 5, 2, 3)]},
                   {"depth": 5}, None),
    "optimization_barrier": ("optimization_barrier", lambda r: {
        "X": [_f(r, 3), _f(r, 2, 2)]}, {}, None),
    "pool2d": ("pool2d", lambda r: {"X": [_f(r, 2, 3, 6, 6)]},
               {"pooling_type": "max", "ksize": [2, 2], "strides": [2, 2],
                "paddings": [0, 0]}, None),
    "pool2d:avg_pad_ceil": ("pool2d", lambda r: {"X": [_f(r, 1, 2, 7, 7)]},
                            {"pooling_type": "avg", "ksize": [3, 3],
                             "strides": [2, 2], "paddings": [1, 1],
                             "ceil_mode": True, "exclusive": True}, None),
    "pool2d:max_global": ("pool2d", lambda r: {"X": [_f(r, 1, 2, 5, 5)]},
                          {"pooling_type": "max", "global_pooling": True},
                          None),
    "reduce_max": ("reduce_max", lambda r: {"X": [_f(r, 2, 3, 4)]},
                   {"dim": [1], "keep_dim": True}, None),
    "reduce_mean": ("reduce_mean", lambda r: {"X": [_f(r, 2, 3, 4)]},
                    {"dim": [0, 2]}, None),
    "reduce_min": ("reduce_min", lambda r: {"X": [_f(r, 2, 3, 4)]},
                   {"reduce_all": True}, None),
    "reduce_prod": ("reduce_prod", lambda r: {"X": [_f(r, 2, 3, 4)]},
                    {"dim": [-1]}, None),
    "reduce_sum": ("reduce_sum", lambda r: {"X": [_f(r, 2, 3, 4)]},
                   {"reduce_all": True, "keep_dim": True}, None),
    "relu": ("relu", lambda r: {"X": [_f(r, 3, 4)]}, {}, None),
    "relu6": ("relu6", lambda r: {"X": [_f(r, 3, 4) * 4]}, {}, None),
    "reshape": ("reshape", lambda r: {"X": [_f(r, 2, 3, 4)]},
                {"shape": [0, -1]}, None),
    "reshape2": ("reshape2", lambda r: {"X": [_f(r, 2, 3, 4)]},
                 {"shape": [4, -1, 2]}, None),
    "rmsprop": ("rmsprop", lambda r: _opt_ins(r, MeanSquare="pos",
                                              Moment="f"),
                {"decay": 0.9, "epsilon": 1e-6, "momentum": 0.9}, None),
    "rmsprop:centered": ("rmsprop", lambda r: _opt_ins(
        r, MeanSquare="pos", Moment="f", MeanGrad="f"),
        {"decay": 0.9, "epsilon": 1e-6, "momentum": 0.9,
         "centered": True}, _PROD),
    "rsqrt": ("rsqrt", lambda r: {"X": [_f(r, 3, 4, pos=True)]}, {}, None),
    "scale": ("scale", lambda r: {"X": [_f(r, 3, 4)]},
              {"scale": 2.0, "bias": 0.5}, None),
    "scale:bias_first": ("scale", lambda r: {"X": [_f(r, 3, 4)]},
                         {"scale": -1.5, "bias": 0.25,
                          "bias_after_scale": False}, None),
    "sgd": ("sgd", lambda r: _opt_ins(r), {}, None),
    "sigmoid": ("sigmoid", lambda r: {"X": [_f(r, 3, 4)]}, {}, None),
    "sigmoid_cross_entropy_with_logits": (
        "sigmoid_cross_entropy_with_logits", lambda r: {
            "X": [_f(r, 4, 1)],
            "Label": [r.randint(0, 2, (4, 1)).astype(np.float32)]},
        {"normalize": True}, None),
    "sign": ("sign", lambda r: {"X": [_f(r, 3, 4)]}, {}, None),
    "silu": ("silu", lambda r: {"X": [_f(r, 3, 4)]}, {}, None),
    "softmax": ("softmax", lambda r: {"X": [_f(r, 3, 5)]}, {"axis": 0},
                None),
    "softmax_with_cross_entropy": ("softmax_with_cross_entropy",
                                   lambda r: {"Logits": [_f(r, 4, 5)],
                                              "Label": [_ids(r, 5, 4, 1)]},
                                   {"ignore_index": 2}, None),
    "split": ("split", lambda r: {"X": [_f(r, 6, 4)]},
              {"sections": [1, 3, 2], "axis": 0}, None),
    "sqrt": ("sqrt", lambda r: {"X": [_f(r, 3, 4, pos=True)]}, {}, None),
    "square": ("square", lambda r: {"X": [_f(r, 3, 4)]}, {}, None),
    "squared_l2_norm": ("squared_l2_norm", lambda r: {"X": [_f(r, 3, 4)]},
                        {}, None),
    "sum": ("sum", lambda r: {"X": [_f(r, 2, 3), _f(r, 2, 3),
                                    _f(r, 2, 3)]}, {}, None),
    "tanh": ("tanh", lambda r: {"X": [_f(r, 3, 4)]}, {}, None),
    "top_k_v2": ("top_k_v2", lambda r: {"X": [_f(r, 3, 6)]}, {"k": 2},
                 None),
    "transpose": ("transpose", lambda r: {"X": [_f(r, 2, 3, 4)]},
                  {"axis": [2, 0, 1]}, None),
    "transpose2": ("transpose2", lambda r: {"X": [_f(r, 2, 3, 4)]},
                   {"axis": [1, 2, 0]}, None),
    "truncated_gaussian_random": ("truncated_gaussian_random", lambda r: {},
                                  {"shape": [3, 4], "std": 3.0},
                                  (1e-5, 1e-5)),
    "uniform_random": ("uniform_random", lambda r: {},
                       {"shape": [3, 4], "min": -0.3, "max": 0.7}, (0, 0)),
}
#: cases whose JAX side runs with 64-bit types off: the random streams
_X32 = {"dropout", "gaussian_random", "truncated_gaussian_random",
        "uniform_random"}


def test_every_registered_op_has_a_case():
    ops = {c[0] for c in OP_CASES.values()}
    grads = {f"{o}_grad" for o in ops}
    assert set(treg.registered_ops()) <= ops | grads
    assert set(treg.registered_ops()) >= ops
    # every op keeps its version in the reference's order
    vm = treg.op_version_map()
    ref = jreg.op_version_map()
    assert list(vm.items()) == [(k, v) for k, v in ref.items() if k in vm]


def _grad_desc(reg, op_type, ins, outs):
    """The op's grad descs by the package's own ``make_grad_ops``, over
    value names ``<slot>:<i>``."""
    d = reg.get_op_def(op_type)
    fw = types.SimpleNamespace(
        type=op_type, attrs={},
        inputs={s: [f"{s}:{i}" for i in range(len(v))] for s, v in
                ins.items()},
        outputs={s: [f"{s}:{i}" for i in range(len(v))] for s, v in
                 outs.items()})
    out_g = {s: [f"{s}:{i}@G" if np.asarray(v).dtype.kind == "f" and
                 s not in d.nondiff_outputs else None
                 for i, v in enumerate(vals)] for s, vals in outs.items()}
    wanted = {s: [f"{s}:{i}@IG" if np.asarray(v).dtype.kind == "f" else None
                  for i, v in enumerate(vals)] for s, vals in ins.items()}
    return fw, out_g, wanted


def _run(pkg, op_type, ins_np, attrs, cots):
    """Forward outputs and input gradients (numpy) of ``op_type`` in one
    package: ``pkg`` "jax" or "port"."""
    if pkg == "jax":
        reg, conv = jreg, jnp.asarray
        ctx = jreg.LoweringContext(rng=jax.random.PRNGKey(5))
    else:
        reg, conv = treg, (lambda a: torch.tensor(np.asarray(a)))
        ctx = treg.LoweringContext(rng=prng.PRNGKey(5), device="cpu")
    ins = {s: [conv(a) for a in v] for s, v in ins_np.items()}
    execute = reg.execute
    if pkg == "jax" and op_type in _X32:
        # as the reference's executor compiles an op: its attrs are
        # constants, which XLA folds into the random streams' arithmetic
        def execute(c, t, i, a):
            return jax.jit(lambda v: jreg.execute(c, t, v, a))(i)
    outs = execute(ctx, op_type, ins, dict(attrs))
    outs_np = {s: [np.array(v) for v in vals] for s, vals in outs.items()}
    d = reg.get_op_def(op_type)
    if d.not_differentiable or cots is None:
        return outs_np, {}
    fw, out_g, wanted = _grad_desc(reg, op_type, ins_np, outs_np)
    fw.attrs = dict(attrs)
    env = {f"{s}:{i}": v for s, vals in ins.items()
           for i, v in enumerate(vals)}
    env.update({f"{s}:{i}": v for s, vals in outs.items()
                for i, v in enumerate(vals)})
    env.update({k: conv(v) for k, v in cots.items()})
    grads = {}
    for g_type, g_in, g_out, g_attrs in reg.make_grad_ops(fw, out_g,
                                                          wanted):
        res = execute(ctx, g_type, {s: [env[n] for n in names]
                                    for s, names in g_in.items()}, g_attrs)
        for s, names in g_out.items():
            for n, v in zip(names, res[s]):
                grads[n] = np.array(v)
    return outs_np, grads


@pytest.mark.parametrize("case", sorted(OP_CASES))
def test_op_matches_the_jax_lowering(case):
    op_type, make, attrs, tol = OP_CASES[case]
    tol = tol or (2e-6, 2e-5)
    rng = np.random.RandomState(zlib.crc32(case.encode()))
    ins = make(rng)
    with jax.enable_x64(case not in _X32):
        jouts, _ = _run("jax", op_type, ins, attrs, None)
        crng = np.random.RandomState(7)
        cots = {f"{s}:{i}@G": np.asarray(crng.randn(*v.shape), v.dtype)
                for s, vals in jouts.items() for i, v in enumerate(vals)
                if v.dtype.kind == "f"}
        jouts, jgrads = _run("jax", op_type, ins, attrs, cots)
    touts, tgrads = _run("port", op_type, ins, attrs, cots)
    assert set(touts) == set(jouts)
    for s in jouts:
        assert len(touts[s]) == len(jouts[s]), s
        for a, b in zip(touts[s], jouts[s]):
            if s == "XShape":          # carries only its shape
                assert a.shape == b.shape
            else:
                _close(a, b, tol)
    assert set(tgrads) == set(jgrads)
    for n in jgrads:
        _close(tgrads[n], jgrads[n], tol)


# --------------------------------------------- graphs, flags and faults
def test_set_var_copies_into_a_held_tensor_or_drops_the_graph():
    """A name a captured step holds keeps its tensor: a value of its
    shape and dtype is copied in (the next replay reads it); any other
    value drops the graph, whose next run is eager again."""
    scope = Scope()
    lr = torch.tensor([0.1])
    scope.set_var("lr", lr)
    entry = texec._Entry(None, ["lr"], ["lr"], [], None)
    entry.graph, entry.runs = object(), 2
    scope._hold(["lr"], entry)
    scope.set_var("lr", np.array([0.5], np.float32))
    assert scope.find_var("lr") is lr and float(lr) == 0.5
    assert entry.graph is not None
    scope.set_var("lr", torch.tensor([0.5], dtype=torch.float64))
    assert scope.find_var("lr") is not lr
    assert entry.graph is None and entry.runs == 0


def _log_prog(P):
    p = P()
    b = p.global_block()
    b.create_var("x", is_data=True)
    b.create_var("y")
    b.append_op("log", {"X": "x"}, {"Out": "y"})
    return p


def test_check_nan_inf_raises_with_the_reference_text():
    x = np.array([-1.0, 1.0], np.float32)
    saved = jflags.get_flags(["check_nan_inf"])
    jflags.set_flags({"check_nan_inf": True})
    tflags.set_flags({"check_nan_inf": True})
    try:
        with pytest.raises(Exception) as jerr:
            JExecutor().run(_log_prog(JProgram), feed={"x": x},
                            fetch_list=["y"], scope=JScope())
        with pytest.raises(NanInfError) as terr:
            Executor("cpu").run(_log_prog(Program), feed={"x": x},
                                fetch_list=["y"], scope=Scope())
    finally:
        jflags.set_flags(saved)
    text = ("op 'log' output 'y' contains 1 NaN/Inf values "
            "(FLAGS_check_nan_inf=true)")
    assert str(terr.value) == text
    assert text in str(jerr.value)
    tflags.set_flags({"check_nan_inf": False})
    (y,) = Executor("cpu").run(_log_prog(Program), feed={"x": x},
                               fetch_list=["y"], scope=Scope())
    assert np.isnan(y[0])


def test_exec_step_fault_point():
    x = np.ones(2, np.float32)
    for scope_, P, E, S in ((jfault_scope, JProgram, JExecutor, JScope),
                            (fault_scope, Program,
                             lambda: Executor("cpu"), Scope)):
        exe = E()
        with scope_("exec.step:nan@1"):          # the second call (0-based)
            exe.run(_log_prog(P), feed={"x": x}, fetch_list=["y"],
                    scope=S())
            with pytest.raises(FloatingPointError, match="exec.step:nan"):
                exe.run(_log_prog(P), feed={"x": x}, fetch_list=["y"],
                        scope=S())
    with fault_scope("exec.step:nan@0"):
        with pytest.raises(NanInfError):
            Executor("cpu").run(_log_prog(Program), feed={"x": x},
                                fetch_list=["y"], scope=Scope())


def test_waiting_parts_raise_naming_their_items():
    exe = Executor("cpu")
    with pytest.raises(NotImplementedError, match="A7.4"):
        exe.train_from_dataset(Program(), dataset=object())
    with pytest.raises(NotImplementedError, match="A7.3"):
        exe.run(types.SimpleNamespace(_compile_for_executor=None))
    with pytest.raises(NotImplementedError, match="A7.3"):
        Program().verify()
    tflags.set_flags({"check_program": True})
    with pytest.raises(NotImplementedError, match="A7.3"):
        exe.run(_log_prog(Program), feed={"x": np.ones(2, np.float32)},
                scope=Scope())
    tflags.set_flags({"check_program": False})
    prog = Program()
    prog.global_block().append_op("fused_attention_qkv",
                                  {"Q": "q", "K": "k", "V": "v"},
                                  {"Out": "o"}, {"seq_axis": "sp"})
    q = np.ones((1, 1, 4, 2), np.float32)
    with pytest.raises(NotImplementedError, match="A5"):
        exe.run(prog, feed={"q": q, "k": q, "v": q}, fetch_list=["o"],
                scope=Scope())
    with pytest.raises(NotImplementedError, match="A7.2"):
        treg.get_op_def("while")
    with pytest.raises(NotImplementedError, match="A7.4"):
        twide(host_paced=False)
    assert tstatic.nn.fc is not None and tstatic.data is not None


def test_each_new_key_is_one_executor_step_compile_like_the_reference():
    """A key's compile is the reference's ``executor_step`` site: one per
    (program version, feed signature, fetch set, scope names); on the CPU
    the port counts a new key where the reference compiles (on the card
    it counts the key's capture)."""
    from paddle_tpu.observability import compile_tracker as jct
    from paddle_tpu_torch.observability import compile_tracker as tct

    def count(ct):
        return ct.compiles().get("executor_step", {}).get("count", 0)

    runs = {}
    for name, (P, E, S, ct) in {
            "jax": (JProgram, JExecutor(), JScope, jct),
            "port": (Program, Executor("cpu"), Scope, tct)}.items():
        prog, blk = _scale_prog(P)
        before = count(ct)
        scope = S()
        for n in (3, 3, 4, 3):
            E.run(prog, feed={"x": np.ones(n, np.float32)},
                  fetch_list=["y"], scope=scope)
        E.run(prog, feed={"x": np.ones(3, np.float32)}, fetch_list=[],
              scope=scope)
        runs[name] = count(ct) - before
    assert runs["port"] == runs["jax"] == 3
