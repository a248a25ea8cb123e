"""The port's inference front door (``paddle_tpu_torch/inference.py``:
``Config``, ``create_predictor``, ``apply_inference_passes``) and typed
errors (``enforce.py``) against the JAX package's, on the CPU.

A model is saved once (``save_inference_model``, by either package: the
format is shared) and loaded by both packages' predictors; their outputs
agree within 1e-5 relative (1e-4 relative and 1e-5 absolute after the
pass pipeline, as ``tests/test_inference_misc.py`` holds the optimized
predictor to the plain one), and the optimized programs hold the same op
lists. ``ExecutorCompilePredictor`` predicts the predictor's executor
keys, one ``executor_step`` per batch size. Without a card a Predictor
made without ``place="cpu"`` raises.
"""

import torch_threads  # noqa: F401  (one worker's share of the cores)
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import enforce as jenforce
from paddle_tpu import inference as jinf
from paddle_tpu import layers as JL
from paddle_tpu.framework import Executor as JExecutor
from paddle_tpu.framework import Program as JProgram
from paddle_tpu.framework import Scope as JScope
from paddle_tpu.framework import program_guard as jguard
from paddle_tpu.framework import unique_name as jun

import paddle_tpu_torch
from paddle_tpu_torch import enforce
from paddle_tpu_torch import framework_io as tio
from paddle_tpu_torch import inference as tinf
from paddle_tpu_torch.analysis import ExecutorCompilePredictor
from paddle_tpu_torch.framework import Executor


def _fc_model(d, seed=3):
    """A small fc model saved by the JAX package; its feed."""
    main, startup = JProgram(), JProgram()
    main.random_seed = startup.random_seed = seed
    with jguard(main, startup), jun.guard():
        x = JL.data("x", [4])
        pred = JL.fc(x, 2)
    scope, exe = JScope(), JExecutor()
    exe.run(startup, scope=scope)
    xv = np.random.RandomState(0).randn(3, 4).astype(np.float32)
    (expected,) = exe.run(main, feed={"x": xv}, fetch_list=[pred.name],
                          scope=scope)
    pt.save_inference_model(d, ["x"], [pred], exe, main, scope=scope)
    return xv, np.asarray(expected)


def test_predictor_matches_jax_on_one_saved_model(tmp_path):
    d = str(tmp_path / "model")
    xv, expected = _fc_model(d)
    jpred = jinf.create_predictor(jinf.Config(d))
    tpred = tinf.create_predictor(tinf.Config(d), place="cpu")
    assert tpred.get_input_names() == jpred.get_input_names() == ["x"]
    assert tpred.get_output_names() == jpred.get_output_names()
    (jout,), (tout,) = jpred.run([xv]), tpred.run([xv])
    np.testing.assert_allclose(tout, np.asarray(jout), rtol=1e-5)
    np.testing.assert_allclose(tout, expected, rtol=1e-5)
    (tout2,) = tpred.run_dict({"x": xv})
    np.testing.assert_array_equal(tout2, tout)
    with pytest.raises(ValueError):
        tpred.run([xv, xv])


def test_port_saved_model_loads_in_the_jax_predictor(tmp_path):
    """The port's ``save_inference_model`` writes what the reference's
    Predictor reads."""
    d = str(tmp_path / "model")
    xv, expected = _fc_model(d)
    tpred = tinf.create_predictor(tinf.Config(d), place="cpu")
    d2 = str(tmp_path / "port_model")
    tio.save_inference_model(d2, ["x"], tpred.get_output_names(),
                             tpred.executor, tpred.program, scope=tpred.scope)
    (jout,) = jinf.create_predictor(jinf.Config(d2)).run([xv])
    np.testing.assert_allclose(np.asarray(jout), expected, rtol=1e-5)


def _bn_model(d):
    main, startup = JProgram(), JProgram()
    main.random_seed = startup.random_seed = 7
    with jguard(main, startup), jun.guard():
        h = JL.fc(JL.data("x", [4]), 8)
        h = JL.dropout(h, dropout_prob=0.3)
        h = JL.batch_norm(h)
        pred = JL.relu(h)
    scope, exe = JScope(), JExecutor()
    exe.run(startup, scope=scope)
    pt.save_inference_model(d, ["x"], [pred], exe, main, scope=scope)
    return np.random.RandomState(1).randn(5, 4).astype(np.float32)


def _types(pred):
    return [op.type for op in pred.program.global_block().ops]


def test_ir_optim_pass_pipeline_matches_jax(tmp_path):
    d = str(tmp_path / "model_ir")
    xv = _bn_model(d)
    preds = {}
    for pkg, mk in (("jax", lambda c: jinf.create_predictor(c)),
                    ("port", lambda c: tinf.create_predictor(c,
                                                             place="cpu"))):
        inf = jinf if pkg == "jax" else tinf
        plain, opt = inf.Config(d), inf.Config(d)
        plain.switch_ir_optim(False)
        opt.switch_ir_optim(True)
        opt.enable_memory_optim(True)
        assert opt.memory_optim_enabled() and not plain.ir_optim()
        preds[pkg] = (mk(plain), mk(opt))
    (jplain, jopt), (tplain, topt) = preds["jax"], preds["port"]
    assert _types(tplain) == _types(jplain)
    assert _types(topt) == _types(jopt)
    assert "dropout" in _types(tplain) and "batch_norm" in _types(tplain)
    assert "dropout" not in _types(topt) and "batch_norm" not in _types(topt)
    assert "fused_scale_bias_relu" in _types(topt)
    assert topt.executor.donate_state and not tplain.executor.donate_state
    (ref,), (got,) = tplain.run([xv]), topt.run([xv])
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(ref, np.asarray(jplain.run([xv])[0]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, np.asarray(jopt.run([xv])[0]),
                               rtol=1e-5, atol=1e-6)
    # the pipeline alone, and an edited pass list
    cfg = tinf.Config(d)
    cfg.pass_builder().remove("fuse_bn_act_pass")
    edited = tinf.create_predictor(cfg, place="cpu")
    jcfg = jinf.Config(d)
    jcfg.pass_builder().remove("fuse_bn_act_pass")
    assert _types(edited) == _types(jinf.create_predictor(jcfg))
    assert tinf.INFERENCE_PASSES == jinf.INFERENCE_PASSES
    assert [op.type for op in tinf.apply_inference_passes(
        tplain.program).global_block().ops] == _types(topt)


def test_compile_predictor_counts_the_predictors_keys(tmp_path):
    from paddle_tpu_torch.observability import compile_tracker as ct
    d = str(tmp_path / "model")
    _fc_model(d)
    pred = tinf.create_predictor(tinf.Config(d), place="cpu")
    cp = ExecutorCompilePredictor()

    def count():
        return ct.compiles().get("executor_step", {}).get("count", 0)

    for rows in (8, 8, 8, 4, 4, 8):
        x = np.zeros((rows, 4), np.float32)
        before = count()
        predicted = cp.would_compile(pred.program, {"x": x},
                                     pred.get_output_names(), pred.scope)
        pred.run([x])
        assert (count() - before == 1) == predicted, rows
    assert cp.predicted_counts() == {"executor_step": 2}


def test_predictor_has_no_cpu_fallback(tmp_path, monkeypatch):
    d = str(tmp_path / "model")
    _fc_model(d)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tinf.create_predictor(tinf.Config(d))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Executor()


def test_enforce_taxonomy_matches_the_reference():
    with pytest.raises(enforce.InvalidArgumentError):
        enforce.enforce_eq(1, 2)
    with pytest.raises(enforce.EnforceNotMet):
        enforce.enforce(False, "custom %s", "reason")
    with pytest.raises(enforce.NotFoundError):
        enforce.enforce_not_none(None, "table")
    assert issubclass(enforce.NotFoundError, KeyError)
    assert issubclass(enforce.UnimplementedError, NotImplementedError)
    enforce.enforce_ge(2, 2)
    enforce.enforce_lt(1, 2)
    for name in ("enforce_ne", "enforce_gt", "enforce_ge", "enforce_lt",
                 "enforce_le", "enforce_eq"):
        for a, b in ((0, 1), (1, 1), (2, 1)):
            def outcome(mod):
                try:
                    getattr(mod, name)(a, b, "ctx %s", "x")
                except mod.EnforceNotMet as e:
                    return type(e).__name__, str(e)
                return None
            assert outcome(enforce) == outcome(jenforce), (name, a, b)
    assert {c.__name__: c.code for c in vars(enforce).values()
            if isinstance(c, type) and issubclass(c, enforce.EnforceNotMet)} \
        == {c.__name__: c.code for c in vars(jenforce).values()
            if isinstance(c, type) and issubclass(c, jenforce.EnforceNotMet)}
    assert paddle_tpu_torch.enforce is enforce
