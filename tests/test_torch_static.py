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
  parts raising with their items (and the parts that waited for A7.4
  running).

Tolerances: f32 results within ``2e-6 + 2e-5 |ref|`` (the two sides
differ in the order of sums), products, normalizations and attention
within ``1e-5 + 1e-4 |ref|``; integer results and ``uniform_random``
bit for bit; the normal draws within ``1e-5 + 1e-5 |ref|`` (torch's
``erfinv`` rounds otherwise than XLA's). Random streams are compared
with JAX's 64-bit types off (``jax.enable_x64(False)``), the streams
the port reproduces. Whole programs: losses within 1e-5 relative and
state within ``1e-5 + 1e-4 |ref|`` after the steps.
"""

import torch_threads  # noqa: F401  (one worker's share of the cores)
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
from paddle_tpu_torch import layers as TLayers
from paddle_tpu_torch import optimizer as TOpt
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
from torch_op_cases import (_EAGER, _NO_GRAD, _PROD, _RAISES, DENSE_CASES,
                            DENSE_X32, _f, _ids, _lens, _probs, _tied)
from torch_op_cases_collective import ONE_RANK_CASES
from torch_op_cases_tail import TAIL_CASES

JSTATIC = types.SimpleNamespace(layers=JL, Program=JProgram,
                                program_guard=jguard, unique_name=jun,
                                AdamW=JO.AdamW)
ENC = dict(num_layers=2, d_model=128, num_heads=2, d_ffn=256, seq=64)


@pytest.fixture(autouse=True)
def _port_flags():
    """Every flag this file sets is put back."""
    saved = tflags.get_flags(["check_program", "use_pallas_layer_norm",
                              "pallas_min_seq", "check_nan_inf"])
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
def _lstm_w(rng, h, inp):
    return [_f(rng, 4 * h, inp), _f(rng, 4 * h, h), _f(rng, 4 * h),
            _f(rng, 4 * h)]


def _gru_w(rng, h, inp):
    return [_f(rng, 3 * h, inp), _f(rng, 3 * h, h), _f(rng, 3 * h),
            _f(rng, 3 * h)]


#: the sequence, structured-prediction and loss ops (and the lowerings
#: their builders emit): the same table's form, case ids as above
OP_CASES.update({
    "rnn": ("rnn", lambda r: {"Input": [_f(r, 2, 4, 3)],
                              "WeightList": _lstm_w(r, 4, 3),
                              "SequenceLength": [_lens(4, 2)]},
            {"mode": "LSTM", "num_layers": 1}, _PROD),
    "rnn:gru_bidirec": ("rnn", lambda r: {
        "Input": [_f(r, 2, 3, 3)],
        "WeightList": _gru_w(r, 2, 3) + _gru_w(r, 2, 3),
        "PreState": [_f(r, 2, 2, 2)]},
        {"mode": "GRU", "is_bidirec": True}, _PROD),
    "dynamic_lstm": ("dynamic_lstm", lambda r: {
        "Input": [_f(r, 2, 5, 16)], "Weight": [_f(r, 4, 16)],
        "Bias": [_f(r, 1, 28)], "Length": [_lens(5, 3)]},
        {"use_peepholes": True}, _PROD),
    "dynamic_lstm:reverse_relu": ("dynamic_lstm", lambda r: {
        "Input": [_f(r, 3, 4, 8)], "Weight": [_f(r, 2, 8)],
        "Bias": [_f(r, 1, 8)], "Length": [_lens(4, 2, 3)]},
        {"use_peepholes": False, "is_reverse": True,
         "candidate_activation": "relu", "cell_activation": "sigmoid"},
        _PROD),
    "sequence_pool": ("sequence_pool", lambda r: {
        "X": [_f(r, 3, 5, 4)], "Length": [_lens(5, 2, 3)]},
        {"pooltype": "SUM"}, None),
    "sequence_pool:average": ("sequence_pool", lambda r: {
        "X": [_f(r, 3, 5, 4)], "Length": [_lens(1, 5, 0)]},
        {"pooltype": "AVERAGE"}, None),
    "sequence_pool:max_ties": ("sequence_pool", lambda r: {
        "X": [_tied(r, 3, 6, 4)], "Length": [_lens(6, 4, 2)]},
        {"pooltype": "MAX"}, None),
    "sequence_pool:last": ("sequence_pool", lambda r: {
        "X": [_f(r, 3, 5, 4)], "Length": [_lens(5, 2, 3)]},
        {"pooltype": "LAST"}, None),
    "sequence_pool:first": ("sequence_pool", lambda r: {
        "X": [_f(r, 3, 5, 4)], "Length": [_lens(5, 2, 3)]},
        {"pooltype": "FIRST"}, None),
    "sequence_mask": ("sequence_mask", lambda r: {"X": [_lens(3, 0, 6)]},
                      {"maxlen": 6, "out_dtype": "float32"}, None),
    "sequence_softmax": ("sequence_softmax", lambda r: {
        "X": [_f(r, 3, 5)], "Length": [_lens(5, 2, 3)]}, {}, None),
    "sequence_reverse": ("sequence_reverse", lambda r: {
        "X": [_f(r, 3, 5, 2)], "Length": [_lens(5, 2, 3)]}, {}, None),
    "sequence_expand": ("sequence_expand", lambda r: {"X": [_f(r, 3, 4)]},
                        {"times": 2}, None),
    "sequence_pad": ("sequence_pad", lambda r: {
        "X": [_f(r, 9, 2)], "Length": [_lens(2, 5, 2)],
        "PadValue": [np.array(-1.0, np.float32)]},
        {"padded_length": 4}, None),
    "sequence_unpad": ("sequence_unpad", lambda r: {
        "X": [_f(r, 3, 4, 2)], "Length": [_lens(2, 4, 1)]}, {}, None),
    "sequence_conv": ("sequence_conv", lambda r: {
        "X": [_f(r, 2, 5, 3)], "Filter": [_f(r, 9, 4)],
        "Length": [_lens(5, 3)]}, {"contextLength": 3}, _PROD),
    "sequence_slice": ("sequence_slice", lambda r: {
        "X": [_f(r, 3, 5, 2)], "Offset": [_lens(1, 0, 3)],
        "Length": [_lens(3, 2, 2)]}, {}, None),
    "sequence_concat": ("sequence_concat", lambda r: {
        "X": [_f(r, 2, 3, 2), _f(r, 2, 4, 2)],
        "Length": [_lens(2, 3), _lens(4, 1)]}, {}, None),
    "sequence_enumerate": ("sequence_enumerate", lambda r: {
        "X": [_ids(r, 9, 2, 5)], "Length": [_lens(5, 3)]},
        {"win_size": 3, "pad_value": 7}, None),
    "sequence_expand_as": ("sequence_expand_as", lambda r: {
        "X": [_f(r, 3, 2)], "Length": [_lens(4, 1, 2)]}, {"maxlen": 4},
        None),
    "gru_unit": ("gru_unit", lambda r: {
        "Input": [_f(r, 2, 12)], "HiddenPrev": [_f(r, 2, 4)],
        "Weight": [_f(r, 4, 12)], "Bias": [_f(r, 1, 12)]},
        {"gate_activation": 1, "activation": 2}, _PROD),
    "gru": ("gru", lambda r: {
        "Input": [_f(r, 2, 3, 12)], "Weight": [_f(r, 4, 12)],
        "Bias": [_f(r, 1, 12)], "H0": [_f(r, 2, 4)]},
        {"is_reverse": True, "origin_mode": True}, _PROD),
    "lstm_unit": ("lstm_unit", lambda r: {"X": [_f(r, 2, 16)],
                                          "C_prev": [_f(r, 2, 4)]},
                  {"forget_bias": 0.5}, None),
    "lstm": ("lstm", lambda r: {
        "Input": [_f(r, 2, 3, 16)], "Weight": [_f(r, 4, 16)],
        "Bias": [_f(r, 1, 28)]}, {"use_peepholes": True}, _PROD),
    "lstmp": ("lstmp", lambda r: {
        "Input": [_f(r, 2, 3, 16)], "Weight": [_f(r, 3, 16)],
        "ProjWeight": [_f(r, 4, 3)], "Bias": [_f(r, 1, 16)]},
        {"use_peepholes": False, "is_reverse": True}, _PROD),
    "warpctc": ("warpctc", lambda r: {
        "Logits": [_f(r, 2, 6, 5)], "Label": [r.randint(1, 5, (2, 3))],
        "LogitsLength": [_lens(6, 5)], "LabelLength": [_lens(3, 2)]},
        {"blank": 0}, _PROD),
    "warpctc:norm_by_times": ("warpctc", lambda r: {
        "Logits": [_f(r, 3, 7, 4)], "Label": [r.randint(0, 3, (3, 2))],
        "LogitsLength": [_lens(7, 4, 6)], "LabelLength": [_lens(2, 1, 2)]},
        {"blank": 3, "norm_by_times": True}, _PROD),
    "linear_chain_crf": ("linear_chain_crf", lambda r: {
        "Emission": [_f(r, 2, 5, 4)], "Transition": [_f(r, 6, 4)],
        "Label": [_ids(r, 4, 2, 5)], "Length": [_lens(5, 3)]}, {}, _PROD),
    "crf_decoding": ("crf_decoding", lambda r: {
        "Emission": [_f(r, 3, 5, 4)], "Transition": [_f(r, 6, 4)],
        "Length": [_lens(5, 3, 1)]}, {}, None),
    "crf_decoding:ties": ("crf_decoding", lambda r: {
        "Emission": [_tied(r, 3, 5, 4) * 0.0 + _tied(r, 3, 5, 1)],
        "Transition": [np.zeros((6, 4), np.float32)],
        "Length": [_lens(5, 4, 2)]}, {}, None),
    "crf_decoding:label": ("crf_decoding", lambda r: {
        "Emission": [_tied(r, 2, 5, 3)], "Transition": [_tied(r, 5, 3)],
        "Length": [_lens(5, 3)], "Label": [_ids(r, 3, 2, 5)]}, {}, None),
    "bce_loss": ("bce_loss", lambda r: {
        "X": [_probs(r, 4, 3)],
        "Label": [r.randint(0, 2, (4, 3)).astype(np.float32)]}, {}, None),
    "nll_loss": ("nll_loss", lambda r: {
        "X": [_f(r, 4, 5)], "Label": [_ids(r, 5, 4)],
        "Weight": [_f(r, 5, pos=True)]}, {"ignore_index": 2}, None),
    "nll_loss:none_4d": ("nll_loss", lambda r: {
        "X": [_f(r, 2, 3, 4)], "Label": [_ids(r, 3, 2, 4)]},
        {"reduction": "none"}, None),
    "log_loss": ("log_loss", lambda r: {
        "Predicted": [_probs(r, 4, 1)],
        "Labels": [r.randint(0, 2, (4, 1)).astype(np.float32)]},
        {"epsilon": 1e-4}, None),
    "rank_loss": ("rank_loss", lambda r: {
        "Label": [_probs(r, 4, 1)], "Left": [_f(r, 4, 1)],
        "Right": [_f(r, 4, 1)]}, {}, None),
    "margin_rank_loss": ("margin_rank_loss", lambda r: {
        "X1": [_f(r, 6, 1)], "X2": [_f(r, 6, 1)],
        "Label": [np.sign(_f(r, 6, 1))]}, {"margin": 0.1}, None),
    "hinge_loss": ("hinge_loss", lambda r: {
        "Logits": [_f(r, 5, 1)],
        "Labels": [r.randint(0, 2, (5, 1)).astype(np.float32)]}, {}, None),
    "sigmoid_focal_loss": ("sigmoid_focal_loss", lambda r: {
        "X": [_f(r, 5, 3)], "Label": [r.randint(-1, 4, (5, 1))],
        "FgNum": [np.array([3], np.int64)]},
        {"gamma": 2.0, "alpha": 0.25}, None),
    "bpr_loss": ("bpr_loss", lambda r: {"X": [_f(r, 4, 5)],
                                        "Label": [_ids(r, 5, 4, 1)]},
                 {}, None),
    "center_loss": ("center_loss", lambda r: {
        "X": [_f(r, 4, 3)], "Label": [_ids(r, 3, 4, 1)],
        "Centers": [_f(r, 3, 3)],
        "CenterUpdateRate": [np.array([0.5], np.float32)]},
        {"cluster_num": 3, "need_update": True}, None),
    "cos_sim": ("cos_sim", lambda r: {"X": [_f(r, 4, 3)],
                                      "Y": [_f(r, 1, 3)]}, {}, None),
    "dist": ("dist", lambda r: {"X": [_f(r, 3, 4)], "Y": [_f(r, 4)]},
             {"p": 3.0}, None),
    "dist:inf": ("dist", lambda r: {"X": [_tied(r, 3, 4)],
                                    "Y": [np.zeros(4, np.float32)]},
                 {"p": float("inf")}, None),
    "minus": ("minus", lambda r: {"X": [_f(r, 3, 4)], "Y": [_f(r, 3, 4)]},
              {}, None),
    "l1_norm": ("l1_norm", lambda r: {"X": [_f(r, 3, 4)]}, {}, None),
    "frobenius_norm": ("frobenius_norm", lambda r: {"X": [_f(r, 2, 3, 4)]},
                       {"dim": [1, 2], "keep_dim": True}, None),
    "frobenius_norm:all": ("frobenius_norm",
                           lambda r: {"X": [_f(r, 2, 3)]},
                           {"reduce_all": True}, None),
    "cross_entropy2": ("cross_entropy2", lambda r: {
        "X": [_probs(r, 4, 5)], "Label": [_ids(r, 5, 4, 1)]},
        {"ignore_index": 1}, None),
    "elementwise_pow": ("elementwise_pow", lambda r: {
        "X": [_f(r, 2, 3, pos=True)], "Y": [_f(r, 2, 3)]}, {}, None),
    "floor": ("floor", lambda r: {"X": [_f(r, 3, 4) * 3]}, {}, None),
    "slice": ("slice", lambda r: {"X": [_f(r, 3, 4, 5)]},
              {"axes": [0, 2], "starts": [1, -3], "ends": [3, 100]}, None),
    "slice:decrease": ("slice", lambda r: {"X": [_f(r, 3, 4, 5)]},
                       {"axes": [1], "starts": [2], "ends": [3],
                        "decrease_axis": [1]}, None),
    "stack": ("stack", lambda r: {"X": [_f(r, 2, 3), _f(r, 2, 3),
                                        _f(r, 2, 3)]}, {"axis": 1}, None),
    "squeeze": ("squeeze", lambda r: {"X": [_f(r, 2, 1, 3, 1)]},
                {"axes": [1]}, None),
    "row_conv": ("row_conv", lambda r: {"X": [_f(r, 2, 5, 3)],
                                        "Filter": [_f(r, 3, 3)]}, {}, None),
    "fill_constant_batch_size_like": (
        "fill_constant_batch_size_like", lambda r: {"Input": [_f(r, 4, 3)]},
        {"shape": [-1, 5], "value": 1.5, "dtype": "float32"}, None),
    "teacher_student_sigmoid_loss": (
        "teacher_student_sigmoid_loss", lambda r: {
            "X": [_f(r, 8, 1)],
            "Label": [np.array([[-2], [-1], [0.3], [1.4], [-1.5], [0.0],
                                [1.0], [1.9]], np.float32)]}, {}, None),
    "edit_distance": ("edit_distance", lambda r: {
        "Hyps": [_ids(r, 3, 3, 5)], "Refs": [_ids(r, 3, 3, 4)],
        "HypsLength": [_lens(5, 2, 0)], "RefsLength": [_lens(4, 3, 2)]},
        {"normalized": True}, None),
    "ctc_align": ("ctc_align", lambda r: {"Input": [np.array(
        [[1, 1, 0, 2, 2, 0, 1], [1, 2, 1, 2, 1, 2, 1],
         [0, 0, 0, 0, 0, 0, 0], [2, 0, 2, 2, 1, 1, 0]], np.int64)]},
        {"blank": 0, "merge_repeated": True}, None),
    "ctc_align:no_merge": ("ctc_align", lambda r: {
        "Input": [_ids(r, 3, 3, 6)]},
        {"blank": 2, "merge_repeated": False}, None),
    "huber_loss": ("huber_loss", lambda r: {"X": [_f(r, 6, 1)],
                                            "Y": [_f(r, 6, 1)]},
                   {"delta": 0.5}, None),
})

OP_CASES.update(DENSE_CASES)

#: cases whose JAX side runs with 64-bit types off: the random streams
_X32 = {"dropout", "gaussian_random", "truncated_gaussian_random",
        "uniform_random"} | DENSE_X32


#: the parameter-server ops, held through their tables elsewhere
PS_OPS = {"distributed_lookup_table", "distributed_lookup_table_grad",
          "send", "recv"}


def test_every_registered_op_has_a_case():
    """Every op of the library (a ``py_func`` builder registers an op of
    its own per call, outside it) has a case, here, in
    ``torch_op_cases_tail.TAIL_CASES`` (run by ``test_torch_ops_tail.py``)
    or in ``torch_op_cases_collective.ONE_RANK_CASES`` (run by
    ``test_torch_collective_one_rank.py``), in the reference's order."""
    ops = {c[0] for c in OP_CASES.values()}
    ops |= {c[0] for c in TAIL_CASES.values()}
    ops |= {c[0] for c in ONE_RANK_CASES.values()}
    grads = {f"{o}_grad" for o in ops}
    # the PS ops read and write host tables: tests/test_torch_ps_rpc.py
    # and test_torch_train_from_dataset.py hold them against the reference
    lib = {o for o in treg.registered_ops() if not o.startswith("py_func_")
           and o not in PS_OPS}
    assert lib <= ops | grads
    assert lib >= ops
    # every op keeps its version in the reference's order
    vm = {k: v for k, v in treg.op_version_map().items() if k in lib}
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


def _run(pkg, op_type, ins_np, attrs, cots, eager=False):
    """Forward outputs and input gradients (numpy) of ``op_type`` in one
    package: ``pkg`` "jax" or "port"; ``eager`` runs it as a dygraph
    call."""
    if pkg == "jax":
        reg, conv = jreg, jnp.asarray
        ctx = jreg.LoweringContext(rng=jax.random.PRNGKey(5), eager=eager)
    else:
        reg, conv = treg, (lambda a: torch.tensor(np.asarray(a)))
        ctx = treg.LoweringContext(rng=prng.PRNGKey(5), device="cpu",
                                   eager=eager)
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
    if case in _RAISES:
        with jax.enable_x64(True), pytest.raises(_RAISES[case]):
            _run("jax", op_type, ins, attrs, None)
        with pytest.raises(_RAISES[case]):
            _run("port", op_type, ins, attrs, None)
        return
    eager = case in _EAGER
    # the cotangents take the port's output shapes (held equal to JAX's
    # below), so JAX runs once per case
    touts, _ = _run("port", op_type, ins, attrs, None, eager)
    crng = np.random.RandomState(7)
    cots = None if case in _NO_GRAD else {
        f"{s}:{i}@G": np.asarray(crng.randn(*v.shape), v.dtype)
        for s, vals in touts.items() for i, v in enumerate(vals)
        if v.dtype.kind == "f"}
    with jax.enable_x64(case not in _X32):
        jouts, jgrads = _run("jax", op_type, ins, attrs, cots, eager)
    touts, tgrads = _run("port", op_type, ins, attrs, cots, eager)
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
    # train_from_dataset (A7.4) is ported: one run per batch, the last
    # batch's fetches back (tests/test_torch_train_from_dataset.py holds
    # it against the reference)
    feeds = [{"x": np.full(2, v, np.float32)} for v in (1.0, np.e)]
    data = types.SimpleNamespace(batch_iterator=lambda: iter(feeds))
    (y,) = exe.train_from_dataset(_log_prog(Program), data, Scope(),
                                  fetch_list=["y"])
    np.testing.assert_allclose(y, [1.0, 1.0], rtol=1e-6)
    # a CompiledProgram runs (tests/test_torch_compiler.py); over more
    # than one rank it waits for A5
    from paddle_tpu_torch.compiler import CompiledProgram
    from paddle_tpu_torch.distributed import env as tenv
    saved = tenv.current_mesh()
    tenv.set_mesh(types.SimpleNamespace(axis_names=("dp",),
                                        shape={"dp": 2}, size=2))
    try:
        with pytest.raises(NotImplementedError, match="A5"):
            exe.run(CompiledProgram(_log_prog(Program)),
                    feed={"x": np.ones(2, np.float32)}, scope=Scope())
    finally:
        tenv.set_mesh(saved)
    # the verifier (A7.3) is ported: a clean program verifies clean and
    # runs under FLAGS_check_program, a broken one raises at its first run
    assert Program().verify().ok()
    tflags.set_flags({"check_program": True})
    (out,) = exe.run(_log_prog(Program), feed={"x": np.ones(2, np.float32)},
                     fetch_list=["y"], scope=Scope())
    np.testing.assert_allclose(out, 0.0)
    broken = _log_prog(Program)
    broken.global_block().ops[0].inputs["X"] = ["ghost"]
    from paddle_tpu_torch.framework import ProgramVerifyError
    with pytest.raises(ProgramVerifyError, match="ghost"):
        exe.run(broken, feed={"x": np.ones(2, np.float32)}, scope=Scope())
    prog = Program()
    prog.global_block().append_op("fused_attention_qkv",
                                  {"Q": "q", "K": "k", "V": "v"},
                                  {"Out": "o"}, {"seq_axis": "sp"})
    q = np.ones((1, 1, 4, 2), np.float32)
    with pytest.raises(NotImplementedError, match="A5"):
        exe.run(prog, feed={"q": q, "k": q, "v": q}, fetch_list=["o"],
                scope=Scope())
    assert treg.get_op_def("subgraph_delegate").not_differentiable
    # dpsgd and the collectives (A5a) are lowered at one rank
    # (tests/test_torch_collective_one_rank.py holds them against the
    # reference); a collective over more than one rank waits for A5b
    ctx = treg.LoweringContext(rng=prng.PRNGKey(0), device="cpu")
    p = torch.ones(3)
    (new,) = treg.execute(ctx, "dpsgd", {
        "Param": [p], "Grad": [torch.zeros(3)],
        "LearningRate": [torch.tensor([0.1])]}, {"sigma": 0.0})["ParamOut"]
    torch.testing.assert_close(new, p)
    x = torch.arange(3.0)
    (out,) = treg.execute(ctx, "c_allreduce_sum", {"X": [x]}, {})["Out"]
    assert torch.equal(out, x)
    wide = treg.LoweringContext(device="cpu", axis_env={0: "dp"},
                                mesh=types.SimpleNamespace(shape={"dp": 2}))
    with pytest.raises(NotImplementedError, match="A5b"):
        treg.execute(wide, "c_allreduce_sum", {"X": [x]}, {})
    # the PS ops (A7.4) are lowered: host ops that split a captured key
    d = treg.get_op_def("distributed_lookup_table")
    assert d.host_op and d.side_effect and d.virtual_param
    assert treg.get_op_def("distributed_lookup_table_grad").host_op
    ops = [op.type for op in twide(host_paced=False)[0].global_block().ops]
    assert ops.count("distributed_lookup_table") == 2
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


# ------------------------------------------------------------- liveness
class _LiveBytes(dict):
    """A run's env that keeps the peak bytes of the tensors it holds
    (state and feeds included)."""

    def __init__(self, *a):
        super().__init__(*a)
        self.peak = self.now = sum(v.numel() * v.element_size()
                                   for v in self.values())

    def __setitem__(self, k, v):
        old = self.get(k)
        if old is not None:
            self.now -= old.numel() * old.element_size()
        self.now += v.numel() * v.element_size()
        self.peak = max(self.peak, self.now)
        super().__setitem__(k, v)

    def pop(self, k, *default):
        v = super().pop(k, *default)
        if isinstance(v, torch.Tensor):
            self.now -= v.numel() * v.element_size()
        return v


def _entry_run(prog, startup, feed, fetch):
    """Run one step through the executor's entry with a ``_LiveBytes``
    env; returns (entry, env, fetches)."""
    scope, exe = Scope(), Executor("cpu")
    exe.run(startup, scope=scope)
    feed = {k: torch.from_numpy(v) for k, v in feed.items()}
    entry = exe._build(prog, feed, fetch, scope)
    env = _LiveBytes({**exe._state(entry, scope), **feed})
    with torch.no_grad():
        entry.runner.run_block(0, env, prng.PRNGKey(0))
    return entry, env, [env[n] for n in fetch]


def _never_read_after_drop(prog, drops):
    ops = prog.global_block().ops
    assert drops
    for i, names in drops.items():
        for j in range(i + 1, len(ops)):
            late = texec._op_touches(prog, ops[j]) & set(names)
            assert not late, (i, ops[j].type, late)


def test_liveness_drops_values_after_their_last_reader():
    """The executor drops each block-0 value after the last op that
    reads or writes it: no later op names a dropped value, state and
    fetches stay, and the recompute backward's live bytes peak below
    the plain backward's (only its checkpoints outlive the forward).
    A value read only inside a ``cond``'s branch, or only by a host op
    that splits a captured key, lives until that op."""
    x = np.random.RandomState(0).randn(2, 64, 64).astype(np.float32)
    peaks, fetched = {}, {}
    for ck in (False, True):
        def minimize(loss, rate, checkpoints, ck=ck):
            opt = TOpt.RecomputeOptimizer(TOpt.SGD(0.1)) if ck \
                else TOpt.SGD(0.1)
            if ck:
                opt._set_checkpoints(checkpoints)
            opt.minimize(loss)
        main, startup, loss = build_encoder_program(
            num_layers=3, d_model=64, num_heads=2, d_ffn=128, seq=64,
            minimize=minimize)
        grads = [p.name + "@GRAD" for p in main.all_parameters()]
        entry, env, out = _entry_run(main, startup, {"x": x},
                                     [loss.name] + grads)
        drops = entry.runner.drops
        _never_read_after_drop(main, drops)
        dropped = {n for ns in drops.values() for n in ns}
        assert not dropped & (set(entry.written) | set(entry.state_in)
                              | {loss.name} | set(grads))
        assert not dropped & set(env)
        peaks[ck], fetched[ck] = env.peak, out
    assert peaks[True] < 0.8 * peaks[False], peaks
    for a, b in zip(fetched[True], fetched[False]):
        assert torch.equal(a, b)

    prog, start = Program(), Program()
    with program_guard(prog, start), unique_name.guard():
        xv = TLayers.data("x", [3])
        p = TLayers.data("p", [1], dtype="bool", append_batch_size=False)
        inner = TLayers.scale(xv, scale=3.0)       # read in a branch only
        host_in = TLayers.scale(xv, scale=5.0)     # read by the host op only
        out = TLayers.cond(p, lambda: TLayers.scale(inner, scale=2.0),
                          lambda: TLayers.scale(inner, scale=-1.0))
        pyout = prog.global_block().create_var("pyout", shape=[-1, 3])
        pyout.dtype = "float32"
        TLayers.py_func(lambda a: a + 1.0, host_in, pyout)
        final = TLayers.elementwise_add(out, pyout)
    types_ = [op.type for op in prog.global_block().ops]
    feed = {"x": np.ones((1, 3), np.float32), "p": np.array([True])}
    entry, env, (got,) = _entry_run(prog, start, feed, [final.name])
    drops = entry.runner.drops
    _never_read_after_drop(prog, drops)
    at = {n: i for i, ns in drops.items() for n in ns}
    assert at[inner.name] == types_.index("cond")
    assert types_[at[host_in.name]].startswith("py_func_")
    assert host_in.name in {n for ns in texec.plan_drops(
        prog, set()).values() for n in ns}
    np.testing.assert_allclose(got.numpy(), [[12.0, 12.0, 12.0]])
