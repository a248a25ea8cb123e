"""The port's quantization plane (``slim.quantization``, the fake-quant
ops) and its IR pass plane (``framework.ir``) against the JAX package on
the CPU: the counterparts of ``tests/test_quantization.py`` and
``tests/test_ir_passes.py``.

Every rewrite runs in both packages: the rewritten programs serialize to
the same JSON, and the port's outputs and training losses are held to
the JAX package's on the same seeded inputs (f32 within ``1e-5 + 1e-5
|ref|``). The quantization-aware Book ``resnet_cifar10``
(``models/book.py``'s ``image_classification(qat=True)``, depth 8, batch
4) trains three Adam steps in float64 in both packages (the scope and
the feeds upcast): in float32 a rounding difference can move an
activation across a quantization level and Adam turns the changed
gradient into a step of up to the lr. Its losses within 1e-10 relative,
every variable within 1e-8 relative Frobenius distance or 1e-9 absolute.
"""

import torch_threads  # noqa: F401  (one worker's share of the cores)
import types

import jax
import numpy as np
import pytest

import paddle_tpu
import paddle_tpu.layers as JL
from paddle_tpu.framework import Executor as JExecutor
from paddle_tpu.framework import Program as JProgram
from paddle_tpu.framework import Scope as JScope
from paddle_tpu.framework import append_backward as japp
from paddle_tpu.framework import program_guard as jguard
from paddle_tpu.framework import unique_name as jun
from paddle_tpu.framework import ir as jir
from paddle_tpu.optimizer import SGD as JSGD
from paddle_tpu.slim import quantization as jq

import paddle_tpu_torch
import paddle_tpu_torch.layers as TL
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch import static as tstatic
from paddle_tpu_torch.framework import Executor, Program, Scope
from paddle_tpu_torch.framework import append_backward as tapp
from paddle_tpu_torch.framework import program_guard as tguard
from paddle_tpu_torch.framework import unique_name as tun
from paddle_tpu_torch.framework import ir as tir
from paddle_tpu_torch.models import book
from paddle_tpu_torch.models.convert import scope_from_numpy
from paddle_tpu_torch.optimizer import SGD as TSGD
from paddle_tpu_torch.slim import quantization as tq

PKGS = {
    "jax": types.SimpleNamespace(L=JL, P=JProgram, guard=jguard, un=jun,
                                 E=JExecutor, S=JScope, ir=jir, q=jq,
                                 SGD=JSGD, app=japp),
    "port": types.SimpleNamespace(L=TL, P=Program, guard=tguard, un=tun,
                                  E=lambda: Executor("cpu"), S=Scope,
                                  ir=tir, q=tq, SGD=TSGD, app=tapp),
}


@pytest.fixture(autouse=True)
def _port_flags():
    """Every flag this file sets is put back."""
    saved = tflags.get_flags(["check_ir_passes"])
    yield
    tflags.set_flags(saved)


def _close(a, b, tol=1e-5):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=tol, atol=tol)


def _both(fn):
    """``fn(pkg)`` in each package: {"jax": ..., "port": ...}."""
    return {k: fn(p) for k, p in PKGS.items()}


def _run_prog(p, prog, startup, fetch, feed, scope=None):
    scope = scope or p.S()
    exe = p.E()
    exe.run(startup, scope=scope)
    return exe.run(prog, feed=feed, fetch_list=[fetch], scope=scope)[0]


def _mlp(p, hidden_act=None, seed=7):
    main, startup = p.P(), p.P()
    main.random_seed = startup.random_seed = seed
    with p.guard(main, startup), p.un.guard():
        x = p.L.data("x", [8])
        h = p.L.relu(p.L.fc(x, 16, act=hidden_act))
        out = p.L.fc(h, 4, act=None)
    return main, startup, out


# ------------------------------------------------------ test_ir_passes.py
def test_graph_roundtrip_preserves_semantics():
    feed = {"x": np.random.RandomState(0).randn(3, 8).astype(np.float32)}

    def go(p):
        main, startup, out = _mlp(p)
        rebuilt = p.ir.IrGraph(main).to_program()
        assert rebuilt.to_json() == main.to_json()
        return (_run_prog(p, main, startup, out.name, feed),
                _run_prog(p, rebuilt, startup, out.name, feed))

    r = _both(go)
    _close(r["port"][0], r["port"][1], 1e-7)
    _close(r["port"][1], r["jax"][1])


def test_graph_producer_consumer_edges():
    main, _, out = _mlp(PKGS["port"])
    g = tir.IrGraph(main)
    assert g.var_producer(out.name).type == "elementwise_add"
    muls = [n for n in g.all_op_nodes() if n.type == "mul"]
    assert len(muls) == 2
    mid = muls[0].op.output("Out")[0]
    assert [c.type for c in g.var_consumers(mid)] == ["elementwise_add"]
    jg = jir.IrGraph(_mlp(PKGS["jax"])[0])
    assert [n.type for n in g.all_op_nodes()] == [
        n.type for n in jg.all_op_nodes()]


def _apply_both(build, name, feed, fetch_of):
    """Build in both packages, apply pass ``name``: the rewritten JSON
    equal, the port's output on ``feed`` against JAX's and against its
    own unrewritten program."""
    def go(p):
        main, startup, out = build(p)
        prog = p.ir.apply_pass(main, name)
        return (prog, _run_prog(p, main, startup, fetch_of(out), feed),
                _run_prog(p, prog, startup, fetch_of(out), feed), main)

    r = _both(go)
    assert r["port"][0].to_json() == r["jax"][0].to_json()
    _close(r["port"][2], r["port"][1], 1e-5)
    _close(r["port"][2], r["jax"][2])
    return [op.type for op in r["port"][0].global_block().ops], r["port"][3]


def test_fuse_elewise_add_act_pass_rewrites_and_matches():
    feed = {"x": np.random.RandomState(1).randn(5, 8).astype(np.float32)}
    types_, main = _apply_both(_mlp, "fuse_elewise_add_act_pass", feed,
                               lambda o: o.name)
    assert "fused_elemwise_activation" in types_
    assert types_.count("elementwise_add") == 1 and "relu" not in types_
    assert "relu" in [op.type for op in main.global_block().ops]


def test_fused_elemwise_activation_trains():
    """The fused op's generic grad trains the fused program, step for
    step with JAX's."""
    def go(p):
        main, startup = p.P(), p.P()
        main.random_seed = startup.random_seed = 11
        with p.guard(main, startup), p.un.guard():
            x = p.L.data("x", [4])
            y = p.L.data("y", [1])
            h = p.L.relu(p.L.fc(x, 8, act=None))
            pred = p.L.fc(h, 1, act=None)
            loss = p.L.reduce_mean(p.L.square(p.L.elementwise_sub(pred, y)))
        fused = p.ir.apply_pass(main, "fuse_elewise_add_act_pass")
        with p.guard(fused, startup):
            p.SGD(learning_rate=0.1).minimize(fused.global_block().var(
                loss.name))
        scope, exe = p.S(), p.E()
        exe.run(startup, scope=scope)
        rng = np.random.RandomState(2)
        losses = []
        for _ in range(30):
            xb = rng.randn(16, 4).astype(np.float32)
            yb = (xb.sum(1, keepdims=True) > 0).astype(np.float32)
            losses.append(float(exe.run(fused, feed={"x": xb, "y": yb},
                                        fetch_list=[loss.name],
                                        scope=scope)[0]))
        return losses

    r = _both(go)
    assert r["port"][-1] < r["port"][0] * 0.8
    _close(r["port"], r["jax"], 1e-4)


def test_single_consumer_constraint_blocks_fusion():
    def go(p):
        main, startup = p.P(), p.P()
        with p.guard(main, startup), p.un.guard():
            x = p.L.data("x", [4])
            a = p.L.elementwise_add(x, x)
            r = p.L.relu(a)
            b = p.L.elementwise_mul(a, a)
            p.L.elementwise_add(r, b)
        return p.ir.apply_pass(main, "fuse_elewise_add_act_pass")

    r = _both(go)
    assert "fused_elemwise_activation" not in [
        op.type for op in r["port"].global_block().ops]
    assert r["port"].to_json() == r["jax"].to_json()


def test_delete_dropout_pass_inference():
    def build(p):
        main, startup = p.P(), p.P()
        main.random_seed = startup.random_seed = 3
        with p.guard(main, startup), p.un.guard():
            x = p.L.data("x", [6])
            d = p.L.dropout(p.L.fc(x, 6), dropout_prob=0.4,
                            dropout_implementation="upscale_in_train")
            out = p.L.fc(d, 2)
        return main.clone(for_test=True), startup, out

    feed = {"x": np.random.RandomState(4).randn(3, 6).astype(np.float32)}
    types_, _ = _apply_both(build, "delete_dropout_op_pass", feed,
                            lambda o: o.name)
    assert "dropout" not in types_


def _bn_net(p, chains, seed):
    main, startup = p.P(), p.P()
    main.random_seed = startup.random_seed = seed
    with p.guard(main, startup), p.un.guard():
        h = p.L.data("x", [3, 8, 8])
        for _ in range(chains):
            c = p.L.conv2d(h, num_filters=4, filter_size=3, padding=1)
            h = p.L.relu(p.L.batch_norm(c))
    return main.clone(for_test=True), startup, h


@pytest.mark.parametrize("chains", [1, 2])
def test_fuse_bn_act_pass_inference_parity(chains):
    feed = {"x": np.random.RandomState(5).randn(2, 3, 8, 8)
            .astype(np.float32)}
    types_, _ = _apply_both(lambda p: _bn_net(p, chains, 9 + 6 * chains),
                            "fuse_bn_act_pass", feed, lambda o: o.name)
    assert types_.count("fused_scale_bias_relu") == chains
    assert "batch_norm" not in types_


def test_custom_pass_registration_and_manager():
    name = "test_torch_count_matmuls_pass"
    if name not in tir.registered_passes():
        @tir.register_pass(name)
        def _count(graph):
            graph.block.create_var("matmul_count")
            graph._matmul_count = sum(1 for op in graph.all_op_nodes()
                                      if op.type in ("mul", "matmul_v2"))
    main, _, _ = _mlp(PKGS["port"])
    g = tir.IrGraph(main)
    tir.new_pass(name).apply(g)
    assert g._matmul_count == 2
    out = tir.PassManager(["fuse_elewise_add_act_pass", name]).apply(main)
    assert "matmul_count" in out.global_block().vars
    with pytest.raises(KeyError, match="unknown pass"):
        tir.new_pass("no_such_pass")


def test_build_strategy_passes_through_the_pass_manager():
    """The reference applies BuildStrategy's fusion through
    CompiledProgram; in the port too (``compiler.py``), and the same
    pipeline through ``PassManager`` gives its program and output, and
    under FLAGS_check_ir_passes the verifier finds it clean before and
    after the pass."""
    from paddle_tpu_torch.compiler import BuildStrategy, CompiledProgram
    feed = {"x": np.random.RandomState(6).randn(8, 8).astype(np.float32)}
    main, startup, out = _mlp(PKGS["port"])
    ref = _run_prog(PKGS["port"], main, startup, out.name, feed)
    fused = tir.PassManager(["fuse_elewise_add_act_pass"]).apply(main)
    assert "fused_elemwise_activation" in [
        op.type for op in fused.global_block().ops]
    _close(_run_prog(PKGS["port"], fused, startup, out.name, feed), ref)
    bs = BuildStrategy()
    bs.fuse_elewise_add_act_ops = True
    compiled = CompiledProgram(main, build_strategy=bs)
    _close(_run_prog(PKGS["port"], compiled, startup, out.name, feed), ref)
    assert compiled._program.to_json() == fused.to_json()
    tflags.set_flags({"check_ir_passes": True})
    checked = tir.apply_pass(main, "fuse_elewise_add_act_pass")
    assert checked.to_json() == fused.to_json()


def test_fuse_pass_multiple_chains():
    def build(p):
        main, startup = p.P(), p.P()
        main.random_seed = startup.random_seed = 13
        with p.guard(main, startup), p.un.guard():
            x = p.L.data("x", [8])
            h = p.L.relu(p.L.fc(x, 16, act=None))
            h = p.L.relu(p.L.fc(h, 16, act=None))
            out = p.L.fc(h, 4, act=None)
        return main, startup, out

    feed = {"x": np.random.RandomState(7).randn(3, 8).astype(np.float32)}
    types_, _ = _apply_both(build, "fuse_elewise_add_act_pass", feed,
                            lambda o: o.name)
    assert types_.count("fused_elemwise_activation") == 2
    assert "relu" not in types_


def test_fuse_preserves_gelu_approximate():
    def build(p):
        main, startup = p.P(), p.P()
        main.random_seed = startup.random_seed = 17
        with p.guard(main, startup), p.un.guard():
            x = p.L.data("x", [8])
            out = p.L.gelu(p.L.fc(x, 8, act=None), approximate=True)
        return main, startup, out

    feed = {"x": 3.0 * np.random.RandomState(9).randn(4, 8)
            .astype(np.float32)}
    types_, _ = _apply_both(build, "fuse_elewise_add_act_pass", feed,
                            lambda o: o.name)
    assert "fused_elemwise_activation" in types_ and "gelu" not in types_


# ---------------------------------------------------- test_quantization.py
def _run_op(op, ins, attrs):
    from paddle_tpu_torch.ops import registry as treg
    import torch
    ctx = treg.LoweringContext(device="cpu")
    tin = {k: [torch.as_tensor(np.asarray(v)) for v in vs]
           for k, vs in ins.items()}
    return {k: [t.numpy() for t in ts]
            for k, ts in treg.execute(ctx, op, tin, attrs).items()}


def _qdq_np(x, scale, bits=8):
    qmax = 2 ** (bits - 1) - 1
    scale = max(scale, 1e-8)
    return np.round(np.clip(x / scale, -1, 1) * qmax) / qmax * scale


def test_fake_qdq_abs_max_matches_numpy():
    x = (np.random.RandomState(0).randn(4, 6) * 3).astype(np.float32)
    out = _run_op("fake_quantize_dequantize_abs_max", {"X": [x]},
                  {"bit_length": 8})
    scale = float(np.abs(x).max())
    np.testing.assert_allclose(out["OutScale"][0], scale, rtol=1e-6)
    np.testing.assert_allclose(out["Out"][0], _qdq_np(x, scale), rtol=1e-5,
                               atol=1e-6)
    assert np.abs(out["Out"][0] - x).max() <= scale / 254 + 1e-6


def test_fake_qdq_channel_wise():
    w = (np.random.RandomState(1).randn(3, 5)
         * np.array([[1.0], [10.0], [0.1]])).astype(np.float32)
    out = _run_op("fake_channel_wise_quantize_dequantize_abs_max",
                  {"X": [w]}, {"bit_length": 8, "quant_axis": 0})
    scales = np.abs(w).max(axis=1)
    np.testing.assert_allclose(out["OutScale"][0], scales, rtol=1e-6)
    for c in range(3):
        np.testing.assert_allclose(out["Out"][0][c], _qdq_np(w[c], scales[c]),
                                   rtol=1e-5, atol=1e-7)


def test_moving_average_state_update_and_test_mode():
    x = np.full((2, 2), 4.0, np.float32)
    ins = {"X": [x], "InScale": [np.float32(2.0)],
           "InState": [np.float32(1.0)], "InAccum": [np.float32(2.0)]}
    out = _run_op("fake_quantize_dequantize_moving_average_abs_max", ins,
                  {"bit_length": 8, "moving_rate": 0.9, "is_test": False})
    np.testing.assert_allclose(out["OutState"][0], 1.9, rtol=1e-6)
    np.testing.assert_allclose(out["OutAccum"][0], 5.8, rtol=1e-6)
    np.testing.assert_allclose(out["OutScale"][0], 5.8 / 1.9, rtol=1e-6)
    np.testing.assert_allclose(out["Out"][0], _qdq_np(x, 5.8 / 1.9),
                               rtol=1e-5)
    out_t = _run_op("fake_quantize_dequantize_moving_average_abs_max", ins,
                    {"bit_length": 8, "is_test": True})
    assert "OutState" not in out_t
    np.testing.assert_allclose(out_t["Out"][0], _qdq_np(x, 2.0), rtol=1e-5)


def test_ste_gradient_passes_through():
    """d(qdq(x))/dx == 1 at the program level, as in the reference."""
    def go(p):
        main, startup = p.P(), p.P()
        with p.guard(main, startup), p.un.guard():
            x = p.L.data("x", [4])
            x.stop_gradient = False
            blk = main.global_block()
            blk.create_var("q", stop_gradient=False)
            blk.create_var("qs")
            blk.append_op("fake_quantize_dequantize_abs_max", {"X": ["x"]},
                          {"Out": ["q"], "OutScale": ["qs"]},
                          {"bit_length": 8})
            p.app(p.L.reduce_sum(blk.var("q")))
        xv = np.random.RandomState(2).randn(2, 4).astype(np.float32)
        return _run_prog(p, main, startup, "x@GRAD", {"x": xv})

    r = _both(go)
    np.testing.assert_array_equal(r["port"], np.ones((2, 4), np.float32))
    np.testing.assert_array_equal(r["port"], r["jax"])


def _qmlp(p, seed):
    main, startup = p.P(), p.P()
    main.random_seed = startup.random_seed = seed
    with p.guard(main, startup), p.un.guard():
        x = p.L.data("x", [8])
        y = p.L.data("y", [1])
        pred = p.L.fc(p.L.fc(x, 16, act="relu"), 1)
        loss = p.L.reduce_mean(p.L.square(p.L.elementwise_sub(pred, y)))
    return main, startup, pred, loss


def test_quant_aware_inserts_ops_and_trains():
    """QAT on the MLP in both packages: the same rewritten program, the
    losses of 60 SGD steps step for step, then ``convert``'s frozen
    program: positive scales, no state drift across runs."""
    def go(p):
        main, startup, pred, loss = _qmlp(p, 7)
        with p.un.guard():
            qprog = p.q.quant_aware(main, startup)
        with p.guard(qprog, startup):
            p.SGD(learning_rate=0.05).minimize(
                qprog.global_block().var(loss.name))
        scope, exe = p.S(), p.E()
        exe.run(startup, scope=scope)
        rng = np.random.RandomState(3)
        W = rng.randn(8, 1).astype(np.float32)
        losses = []
        for _ in range(60):
            xb = rng.randn(16, 8).astype(np.float32)
            losses.append(float(exe.run(qprog, feed={"x": xb, "y": xb @ W},
                                        fetch_list=[loss.name],
                                        scope=scope)[0]))
        frozen, scales = p.q.convert(qprog, scope=scope)
        infer = frozen._prune([pred], keep_var_names=["x"])
        xb = rng.randn(4, 8).astype(np.float32)
        runs = [exe.run(infer, feed={"x": xb}, fetch_list=[pred.name],
                        scope=scope)[0] for _ in range(2)]
        return qprog, main, losses, scales, runs

    r = _both(go)
    qprog, main, losses, scales, runs = r["port"]
    types_ = [op.type for op in qprog.global_block().ops]
    assert types_.count("fake_channel_wise_quantize_dequantize_abs_max") == 2
    assert types_.count(
        "fake_quantize_dequantize_moving_average_abs_max") == 2
    assert "fake_channel_wise_quantize_dequantize_abs_max" not in [
        op.type for op in main.global_block().ops]
    assert losses[-1] < losses[0] * 0.2
    _close(losses, r["jax"][2], 2e-4)
    assert scales and all(s > 0 for s in scales.values())
    assert set(scales) == set(r["jax"][3])
    np.testing.assert_array_equal(runs[0], runs[1])


def test_post_training_quantization_close_to_float():
    def go(p):
        main, startup, pred, _ = _qmlp(p, 11)
        scope, exe = p.S(), p.E()
        exe.run(startup, scope=scope)
        rng = np.random.RandomState(4)
        xb = rng.randn(16, 8).astype(np.float32)
        infer = main._prune([pred], keep_var_names=["x"])
        ref = exe.run(infer, feed={"x": xb}, fetch_list=[pred.name],
                      scope=scope)[0]
        ptq = p.q.PostTrainingQuantization(exe, infer, scope=scope)
        for _ in range(4):
            ptq.collect({"x": rng.randn(16, 8).astype(np.float32)})
        with p.un.guard():
            qprog, scales = ptq.quantize()
        got = exe.run(qprog, feed={"x": xb}, fetch_list=[pred.name],
                      scope=scope)[0]
        return ref, got, scales

    r = _both(go)
    ref, got, scales = r["port"]
    err = np.abs(np.asarray(got) - np.asarray(ref)).max()
    assert err / (np.abs(ref).max() + 1e-6) < 0.05 and err > 0
    _close(got, r["jax"][1])
    assert scales.keys() == r["jax"][2].keys()
    _close([scales[k] for k in sorted(scales)],
           [r["jax"][2][k] for k in sorted(scales)])


def test_quant_aware_pretrained_scope_flow():
    """Fine-tune flow: the scale variables initialized in a scope whose
    weights are trained; the startup is not re-run, the weights survive,
    QAT tracks the float loss."""
    p = PKGS["port"]
    main, startup, _, loss = _qmlp(p, 13)
    rng = np.random.RandomState(5)
    W = rng.randn(8, 1).astype(np.float32)
    train = main.clone()
    with p.guard(train, startup):
        p.SGD(learning_rate=0.05).minimize(train.global_block().var(
            loss.name))
    scope, exe = p.S(), p.E()
    exe.run(startup, scope=scope)
    for _ in range(60):
        xb = rng.randn(16, 8).astype(np.float32)
        exe.run(train, feed={"x": xb, "y": xb @ W}, fetch_list=[],
                scope=scope)
    w_name = [n for n in scope.var_names() if n.endswith(".w_0")][0]
    w_before = scope.get_numpy(w_name).copy()
    qprog = tq.quant_aware(main, scope=scope)
    startup2 = p.P()
    with p.guard(qprog, startup2):
        p.SGD(learning_rate=0.01).minimize(qprog.global_block().var(
            loss.name))
    exe.run(startup2, scope=scope)
    np.testing.assert_array_equal(w_before, scope.get_numpy(w_name))
    for _ in range(20):
        xb = rng.randn(16, 8).astype(np.float32)
        exe.run(qprog, feed={"x": xb, "y": xb @ W}, fetch_list=[loss.name],
                scope=scope)
    xb = rng.randn(16, 8).astype(np.float32)
    (fl,) = exe.run(main, feed={"x": xb, "y": xb @ W},
                    fetch_list=[loss.name], scope=scope)
    (lv,) = exe.run(qprog, feed={"x": xb, "y": xb @ W},
                    fetch_list=[loss.name], scope=scope)
    assert float(lv) < float(fl) + 0.3


def test_static_quantization_is_the_slim_module():
    assert tstatic.quantization is tq
    assert paddle_tpu_torch.slim.quantization is tq
    assert "quantization_freeze_pass" in tir.registered_passes()
    assert "quantization_transform_pass" in tir.registered_passes()


def _up(a):
    return a.astype(np.float64) if a.dtype == np.float32 else a


def test_quant_aware_resnet_cifar10_trains_like_jax():
    """The Book's resnet_cifar10 under quant_aware (depth 8, batch 4):
    the same program in both packages, then three Adam steps in float64
    from the JAX startup's state, per step against JAX."""
    kw = dict(depth=8, batch_size=4, seed=20, qat=True)
    jb = book.image_classification(paddle_tpu, **kw)
    tb = book.image_classification(paddle_tpu_torch, **kw)
    assert tb.main.to_json() == jb.main.to_json()
    assert tb.startup.to_json() == jb.startup.to_json()
    jscope, jexe = JScope(), JExecutor()
    jexe.run(jb.startup, scope=jscope)
    start = {n: _up(jscope.get_numpy(n)) for n in jscope.var_names()}
    jscope = JScope()
    for n, a in start.items():
        jscope.set_var(n, jax.numpy.asarray(a))
    tscope, texe = scope_from_numpy(start, "cpu"), Executor("cpu")
    fetch = [v.name for v in jb.fetches]
    for feed in book.batches(tb, 3):
        feed = {k: _up(v) for k, v in feed.items()}
        a = jexe.run(jb.main, feed=feed, fetch_list=fetch, scope=jscope)
        b = texe.run(tb.main, feed=feed, fetch_list=fetch, scope=tscope)
        np.testing.assert_allclose(b[0], a[0], rtol=1e-10)
        np.testing.assert_array_equal(b[1], a[1])
    scales = [n for n in jscope.var_names() if ".scale" in n]
    assert scales
    for n in jscope.var_names():
        got, ref = tscope.get_numpy(n), np.asarray(jscope.get_numpy(n))
        assert got.shape == ref.shape
        if got.size and got.dtype.kind == "f":
            rel = np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30)
            assert rel <= 1e-8 or np.abs(got - ref).max() <= 1e-9, (n, rel)
