"""The port's ``compiler.py`` against the JAX package's on the CPU: a
``BuildStrategy``'s IR passes applied through ``CompiledProgram`` and
the program run by ``Executor.run`` (the counterpart of
``tests/test_ir_passes.py:196``), ``with_data_parallel``'s fetch form, a
compiled training program stepping like the plain one, and more than
one rank raising with its ROADMAP item.

The JAX side runs on a one-device mesh (the suite forces 8 host
devices; ``paddle_tpu.distributed.env`` gets a one-device mesh and is
put back afterwards). Tolerances: ``1e-6 + 1e-5 |ref|``.
"""

import torch_threads  # noqa: F401  (one worker's share of the cores)
import types

import jax
import numpy as np
import pytest

import paddle_tpu.layers as JL
from paddle_tpu.compiler import BuildStrategy as JBuildStrategy
from paddle_tpu.compiler import CompiledProgram as JCompiledProgram
from paddle_tpu.distributed import env as jenv
from paddle_tpu.framework import Executor as JExecutor
from paddle_tpu.framework import Program as JProgram
from paddle_tpu.framework import Scope as JScope
from paddle_tpu.framework import program_guard as jguard
from paddle_tpu.framework import unique_name as jun
from paddle_tpu.optimizer import SGD as JSGD

import paddle_tpu_torch.layers as TL
from paddle_tpu_torch import static as tstatic
from paddle_tpu_torch.compiler import (BuildStrategy, CompiledProgram,
                                       ExecutionStrategy)
from paddle_tpu_torch.distributed import env as tenv
from paddle_tpu_torch.framework import (Executor, Program, Scope,
                                        program_guard, unique_name)
from paddle_tpu_torch.optimizer import SGD

JAX = types.SimpleNamespace(L=JL, Program=JProgram, guard=jguard, un=jun,
                            BS=JBuildStrategy, CP=JCompiledProgram,
                            Scope=JScope, exe=lambda: JExecutor(), SGD=JSGD)
PORT = types.SimpleNamespace(L=TL, Program=Program, guard=program_guard,
                             un=unique_name, BS=BuildStrategy,
                             CP=CompiledProgram, Scope=Scope,
                             exe=lambda: Executor("cpu"), SGD=SGD)


@pytest.fixture(autouse=True)
def _env():
    envs = [(m, m._mesh, m._data_axis, dict(m._ring_to_axis))
            for m in (jenv, tenv)]
    jenv.set_mesh(jenv.build_mesh(("dp",), devices=jax.devices()[:1]))
    tenv.set_mesh(None)
    yield
    for m, mesh, axis, rings in envs:
        m._mesh, m._data_axis = mesh, axis
        m._ring_to_axis.clear()
        m._ring_to_axis.update(rings)


def _build_mlp(pkg, train=False):
    """``tests/test_ir_passes.py``'s MLP (fc, relu, fc); ``train`` adds
    a loss and SGD."""
    L = pkg.L
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 7
    with pkg.guard(main, startup), pkg.un.guard():
        x = L.data("x", [8])
        h = L.fc(x, 16, act=None)
        h = L.relu(h)
        out = L.fc(h, 4, act=None)
        if train:
            out = L.reduce_mean(L.square(out))
            pkg.SGD(0.1).minimize(out)
    return main, startup, out


def _start(pkg, startup):
    scope, exe = pkg.Scope(), pkg.exe()
    exe.run(startup, scope=scope)
    return scope, exe


def test_build_strategy_applies_passes_via_compiled_program():
    feed = {"x": np.random.RandomState(6).randn(8, 8).astype(np.float32)}
    got = {}
    for pkg in (JAX, PORT):
        main, startup, out = _build_mlp(pkg)
        scope, exe = _start(pkg, startup)
        (ref,) = exe.run(main, feed=feed, fetch_list=[out.name], scope=scope)
        bs = pkg.BS()
        bs.fuse_elewise_add_act_ops = True
        assert bs._ir_passes() == ["fuse_elewise_add_act_pass"]
        compiled = pkg.CP(main, build_strategy=bs)
        (res,) = exe.run(compiled, feed=feed, fetch_list=[out.name],
                         scope=scope)
        fused = [op.type for op in compiled._program.global_block().ops]
        assert "fused_elemwise_activation" in fused
        np.testing.assert_allclose(res, ref, rtol=1e-5, atol=1e-6)
        got[pkg is PORT] = (res, fused, compiled._program.to_json())
    assert got[True][1] == got[False][1]
    assert got[True][2] == got[False][2]
    np.testing.assert_allclose(got[True][0], got[False][0], rtol=1e-5,
                               atol=1e-6)


def test_data_parallel_fetches_and_training_steps_like_the_reference():
    """``with_data_parallel`` at one rank: a training program's fetches
    in the ParallelExecutor form (a scalar loss comes back as ``[1]``),
    its steps equal to the plain program's and to the reference's."""
    rng = np.random.RandomState(2)
    feeds = [{"x": rng.randn(8, 8).astype(np.float32)} for _ in range(3)]
    losses = {}
    for pkg in (JAX, PORT):
        main, startup, loss = _build_mlp(pkg, train=True)
        scope, exe = _start(pkg, startup)
        plain_scope, plain_exe = _start(pkg, startup)
        compiled = pkg.CP(main).with_data_parallel(loss_name=loss.name)
        out = []
        for feed in feeds:
            (a,) = exe.run(compiled, feed=feed, fetch_list=[loss.name],
                           scope=scope)
            (b,) = plain_exe.run(main, feed=feed, fetch_list=[loss.name],
                                 scope=plain_scope)
            assert np.shape(a) == (1,) and np.shape(b) == ()
            np.testing.assert_allclose(a[0], b, rtol=1e-6)
            out.append(float(a[0]))
        losses[pkg is PORT] = out
    np.testing.assert_allclose(losses[True], losses[False], rtol=1e-5)


def test_more_than_one_rank_raises_naming_a5_and_exports():
    main, startup, out = _build_mlp(PORT)
    scope, exe = _start(PORT, startup)
    tenv.set_mesh(types.SimpleNamespace(axis_names=("dp",),
                                        shape={"dp": 2}, size=2))
    with pytest.raises(NotImplementedError, match="A5"):
        exe.run(CompiledProgram(main), feed={"x": np.ones((2, 8),
                                                          np.float32)},
                fetch_list=[out.name], scope=scope)
    assert tstatic.CompiledProgram is CompiledProgram
    assert tstatic.BuildStrategy is BuildStrategy
    assert tstatic.ExecutionStrategy is ExecutionStrategy
    es = ExecutionStrategy()
    assert (es.num_threads, es.num_iteration_per_drop_scope) == (1, 1)
    with pytest.raises(TypeError, match="Program or CompiledProgram"):
        exe.run(object())
