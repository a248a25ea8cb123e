"""Subgraph detection and delegation of the port
(``paddle_tpu_torch/framework/subgraph.py`` and the ``subgraph_delegate``
op of ``ops/delegate_ops.py``) against the JAX package's, on the programs
of ``tests/test_subgraph_delegate.py``.

Each program is built in both packages; the detector finds the same
clusters (op indices and types) in both, the pass rewrites both to the
same op list, and a delegated program's outputs on ``Executor("cpu")``
equal the JAX delegated program's (and the port's undelegated run) within
1e-6 relative, from the JAX startup's parameters. A custom engine runs
once per cluster per run; an unregistered one raises naming itself.
"""

import torch_threads  # noqa: F401  (one worker's share of the cores)
import types

import numpy as np
import pytest
import torch

from paddle_tpu import layers as JL
from paddle_tpu.framework import Executor as JExecutor
from paddle_tpu.framework import Program as JProgram
from paddle_tpu.framework import Scope as JScope
from paddle_tpu.framework import program_guard as jguard
from paddle_tpu.framework import unique_name as jun
from paddle_tpu.framework import ir as jir
from paddle_tpu.framework import subgraph as jsub

from paddle_tpu_torch import layers as TL
from paddle_tpu_torch.framework import (Executor, Program, program_guard,
                                        unique_name)
from paddle_tpu_torch.framework import ir as tir
from paddle_tpu_torch.framework import subgraph as tsub
from paddle_tpu_torch.models.convert import scope_from_numpy

JAX = types.SimpleNamespace(L=JL, P=JProgram, guard=jguard, un=jun, ir=jir,
                            sub=jsub)
PORT = types.SimpleNamespace(L=TL, P=Program, guard=program_guard,
                             un=unique_name, ir=tir, sub=tsub)


def _mixed(p, seed=3):
    """relu -> relu -> sigmoid (unsupported) -> relu -> relu."""
    main, startup = p.P(), p.P()
    main.random_seed = startup.random_seed = seed
    with p.guard(main, startup), p.un.guard():
        h = p.L.relu(p.L.data("x", [8]))
        h = p.L.relu(h)
        h = p.L.sigmoid(h)
        h = p.L.relu(h)
        out = p.L.relu(h)
    return main, startup, out


def _bridge(p):
    main, startup = p.P(), p.P()
    with p.guard(main, startup), p.un.guard():
        a = p.L.relu(p.L.data("x", [4]))
        b = p.L.sigmoid(a)
        c = p.L.relu(b)
        out = p.L.relu(c)
    return main, startup, out


def _fc_relu(p):
    main, startup = p.P(), p.P()
    main.random_seed = startup.random_seed = 7
    with p.guard(main, startup), p.un.guard():
        h = p.L.fc(p.L.data("x", [6]), 5, act=None)
        out = p.L.relu(h)
    return main, startup, out


def _two_relus(p):
    main, startup = p.P(), p.P()
    with p.guard(main, startup), p.un.guard():
        out = p.L.relu(p.L.relu(p.L.data("x", [4])))
    return main, startup, out


def _clusters(p, build, types_):
    main = build(p)[0]
    found = p.sub.SubgraphDetector(
        p.ir.IrGraph(main), lambda n: n.type in types_).detect(min_size=2)
    return [[(n.idx, n.type) for n in c] for c in found]


@pytest.mark.parametrize("build,types_", [
    (_mixed, {"relu"}), (_bridge, {"relu"}),
    (_fc_relu, {"mul", "elementwise_add", "relu"})])
def test_detector_finds_the_reference_clusters(build, types_):
    got = _clusters(PORT, build, types_)
    assert sorted(got) == sorted(_clusters(JAX, build, types_))
    if build is _mixed:
        # the sigmoid bridge splits the relus into two pairs
        assert len(got) == 2 and all(len(c) == 2 for c in got)
    if build is _bridge:
        # a pair joined only through the unsupported op never merges
        assert not any({0, 2} <= {i for i, _ in c} for c in got)


def _delegate(p, main, types_, engine="inline"):
    return p.ir.new_pass("subgraph_delegate_pass", is_supported=types_,
                         min_subgraph_size=2, engine=engine).apply(
        p.ir.IrGraph(main)).to_program()


def _run_both(build, types_, feed):
    """(JAX delegated, port delegated, port plain) outputs from the JAX
    startup's parameters."""
    jmain, jstart, jout = build(JAX)
    tmain, _, tout = build(PORT)
    jscope, jexe = JScope(), JExecutor()
    jexe.run(jstart, scope=jscope)
    start = {n: jscope.get_numpy(n) for n in jscope.var_names()}
    jdel, tdel = _delegate(JAX, jmain, types_), _delegate(PORT, tmain, types_)
    assert [op.type for op in tdel.global_block().ops] == \
        [op.type for op in jdel.global_block().ops]
    assert [op.attrs["sub_ops"] for op in tdel.global_block().ops
            if op.type == "subgraph_delegate"] == \
        [op.attrs["sub_ops"] for op in jdel.global_block().ops
         if op.type == "subgraph_delegate"]
    (ref,) = jexe.run(jdel, feed=feed, fetch_list=[jout.name], scope=jscope)
    texe = Executor("cpu")
    (got,) = texe.run(tdel, feed=feed, fetch_list=[tout.name],
                      scope=scope_from_numpy(start, "cpu"))
    (plain,) = texe.run(tmain, feed=feed, fetch_list=[tout.name],
                        scope=scope_from_numpy(start, "cpu"))
    return tdel, np.asarray(ref), got, plain


def test_delegate_outputs_match_jax_and_the_undelegated_run():
    feed = {"x": np.random.RandomState(0).randn(2, 8).astype(np.float32)}
    tdel, ref, got, plain = _run_both(_mixed, {"relu"}, feed)
    types_ = [op.type for op in tdel.global_block().ops]
    assert types_.count("subgraph_delegate") == 2 and "relu" not in types_
    np.testing.assert_allclose(got, ref, rtol=1e-6)
    np.testing.assert_array_equal(got, plain)


def test_delegate_carries_parameters_across_boundary():
    feed = {"x": np.random.RandomState(1).randn(3, 6).astype(np.float32)}
    tdel, ref, got, plain = _run_both(
        _fc_relu, {"mul", "elementwise_add", "relu"}, feed)
    assert [op.type for op in tdel.global_block().ops].count(
        "subgraph_delegate") == 1
    np.testing.assert_allclose(got, ref, rtol=1e-6)
    np.testing.assert_array_equal(got, plain)


def test_custom_engine_runner_invoked_once_per_cluster_per_run():
    calls = []

    def engine(sub_ops, env, ctx):
        calls.append(len(sub_ops))
        v = env[sub_ops[0]["inputs"]["X"][0]]
        for _ in sub_ops:
            v = torch.clamp_min(v, 0)
        return {sub_ops[-1]["outputs"]["Out"][0]: v}

    tsub.register_delegate_engine("torch_test_engine", engine)
    assert tsub.get_delegate_engine("torch_test_engine") is engine
    main, startup, out = _two_relus(PORT)
    fused = _delegate(PORT, main, {"relu"}, engine="torch_test_engine")
    exe = Executor("cpu")
    feed = {"x": np.array([[-1.0, 2.0, -3.0, 4.0]], np.float32)}
    for run in range(2):
        (got,) = exe.run(fused, feed=feed, fetch_list=[out.name])
        np.testing.assert_allclose(got, [[0.0, 2.0, 0.0, 4.0]])
        assert calls == [2] * (run + 1)


def test_unregistered_engine_raises():
    main, _, out = _two_relus(PORT)
    fused = _delegate(PORT, main, {"relu"}, engine="missing_engine")
    with pytest.raises(RuntimeError, match="missing_engine"):
        Executor("cpu").run(fused, feed={"x": np.zeros((1, 4), np.float32)},
                            fetch_list=[out.name])
