"""The fluid-era surface of the port against the JAX package on the CPU:
the Book's reader fixtures and ``DataFeeder``, ``DynamicRNN``'s unrolled
Program, the small CTC tagger ``chip_smoke.py`` phase 24 holds on the
card, inference models saved by one package and loaded by the other,
and ``fluid.Executor``'s places.

Tolerances: fixture rows and feed dicts bit for bit; the tagger's loss
within 1e-5 relative, its decoded ids, lengths and edit distances
exactly, its unpadded scores within ``1e-6 + 1e-5 |ref|`` and its
parameters within 1e-4 relative Frobenius distance or 1e-6 absolute;
inference fetches across packages within ``1e-6 + 1e-5 |ref|``.
"""

import torch_threads  # noqa: F401  (one worker's share of the cores)
import os

import numpy as np
import pytest
import torch

import paddle_tpu
from paddle_tpu import framework_io as jio
from paddle_tpu.framework import Executor as JExecutor
from paddle_tpu.framework import Scope as JScope

import paddle_tpu_torch
from paddle_tpu_torch import dataset as tdataset
from paddle_tpu_torch import framework_io as tio
from paddle_tpu_torch import static as tstatic
from paddle_tpu_torch.fluid_compat import TPUPlace
from paddle_tpu_torch.framework import Executor, Scope
from paddle_tpu_torch.models import book
from paddle_tpu_torch.models.convert import scope_from_numpy


def _readers(ds):
    return {"uci_housing.train": ds.uci_housing.train(),
            "uci_housing.test": ds.uci_housing.test(),
            "mnist.train": ds.mnist.train(), "mnist.test": ds.mnist.test(),
            "imikolov.train": ds.imikolov.train(
                ds.imikolov.build_dict(), 5),
            "imikolov.test": ds.imikolov.test(ds.imikolov.build_dict(), 5),
            "cifar.train10": ds.cifar.train10(),
            "cifar.test10": ds.cifar.test10(),
            "conll05.test": ds.conll05.test(),
            "movielens.train": ds.movielens.train(),
            "movielens.test": ds.movielens.test(),
            "wmt14.train": ds.wmt14.train(30000),
            "wmt14.test": ds.wmt14.test(200)}


def test_fixtures_yield_the_reference_rows():
    ref, ours = _readers(paddle_tpu.dataset), _readers(paddle_tpu_torch.dataset)
    assert paddle_tpu_torch.dataset is tdataset
    for name in ref:
        rows_r, rows_t = list(ref[name]()), list(ours[name]())
        assert len(rows_t) == len(rows_r) > 0, name
        for a, b in zip(rows_r, rows_t):
            assert len(a) == len(b)
            for x, y in zip(a, b):
                x, y = np.asarray(x), np.asarray(y)
                assert x.dtype == y.dtype and x.shape == y.shape, name
                np.testing.assert_array_equal(y, x)
    # the dictionaries and tables the Book reads
    for mod in ("conll05", "movielens", "wmt14", "imikolov"):
        r, t = getattr(paddle_tpu.dataset, mod), getattr(tdataset, mod)
        assert sorted(n for n in vars(r) if not n.startswith("_")) == \
            sorted(n for n in vars(t) if not n.startswith("_")), mod
    assert tdataset.conll05.get_dict() == paddle_tpu.dataset.conll05.get_dict()
    assert tdataset.movielens.age_table == paddle_tpu.dataset.movielens.age_table
    assert tdataset.wmt14.get_dict(30) == paddle_tpu.dataset.wmt14.get_dict(30)
    # the shuffled pipeline: one Random(0) stream in both
    rb = paddle_tpu.batch(paddle_tpu.reader.shuffle(
        paddle_tpu.dataset.cifar.train10(), buf_size=64), 16, drop_last=True)
    tb = paddle_tpu_torch.batch(paddle_tpu_torch.reader.shuffle(
        tdataset.cifar.train10(), buf_size=64), 16, drop_last=True)
    for a, b in zip(rb(), tb()):
        assert [s[1] for s in a] == [s[1] for s in b]


@pytest.mark.parametrize("name", ["fit_a_line", "recognize_digits",
                                  "word2vec", "label_semantic_roles"])
def test_data_feeder_equals_the_reference(name):
    """The feed dicts of the Book programs that feed through
    ``DataFeeder``: names, dtypes (int64 ids and labels stay int64),
    shapes and values."""
    kw = {"recognize_digits": dict(batch_size=8)}.get(name, {})
    jb = book.PROGRAMS[name](paddle_tpu, **kw)
    tb = book.PROGRAMS[name](paddle_tpu_torch, **kw)
    for a, b in zip(book.batches(jb, 2), book.batches(tb, 2)):
        assert list(a) == list(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(b[k], a[k])
    if name == "label_semantic_roles":
        assert all(v.dtype == np.int64 for v in b.values())


def _drnn_program(pkg):
    fluid = pkg.fluid
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        seq = fluid.layers.data(name="seq", shape=[3, 4], dtype="float32")
        boot = fluid.layers.data(name="boot", shape=[5], dtype="float32")
        ctx = fluid.layers.data(name="ctx", shape=[2], dtype="float32")
        rnn = fluid.layers.DynamicRNN()
        with rnn.block():
            x = rnn.step_input(seq)
            c = rnn.static_input(ctx)
            mem = rnn.memory(init=boot)
            h = fluid.layers.fc(input=[x, c, mem], size=5, act="tanh")
            rnn.update_memory(mem, h)
            rnn.output(h)
        out = rnn()
        loss = fluid.layers.mean(out)
    return main, startup, out, loss


def test_dynamic_rnn_unrolls_the_reference_program():
    jm, js, jo, _ = _drnn_program(paddle_tpu)
    tm, ts, to, _ = _drnn_program(paddle_tpu_torch)
    assert [op.type for op in tm.global_block().ops] == \
        [op.type for op in jm.global_block().ops]
    assert tm.to_json() == jm.to_json() and ts.to_json() == js.to_json()
    assert tuple(to.shape) == tuple(jo.shape) == (-1, 3, 5)
    # the body's parameters are created once and shared by every step
    assert len(tm.all_parameters()) == 4
    with pytest.raises(TypeError):
        paddle_tpu_torch.fluid.layers.DynamicRNN().memory()
    rng = np.random.RandomState(0)
    feed = {"seq": rng.randn(2, 3, 4).astype(np.float32),
            "boot": rng.randn(2, 5).astype(np.float32),
            "ctx": rng.randn(2, 2).astype(np.float32)}
    jscope = JScope()
    JExecutor().run(js, scope=jscope)
    tscope = scope_from_numpy({n: jscope.get_numpy(n)
                               for n in jscope.var_names()}, "cpu")
    (a,) = JExecutor().run(jm, feed=feed, fetch_list=[jo.name], scope=jscope)
    (b,) = Executor("cpu").run(tm, feed=feed, fetch_list=[to.name],
                               scope=tscope)
    np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6)


def test_ctc_tagger_matches_jax():
    """Phase 24's CTC tagger: ``sequence_pad``, ``row_conv``,
    ``warpctc``, ``ctc_greedy_decoder``, ``edit_distance`` and
    ``sequence_unpad``, three SGD steps from the JAX startup's scope."""
    jb = book.ctc_tagger(paddle_tpu, seed=20)
    tb = book.ctc_tagger(paddle_tpu_torch, seed=20)
    assert tb.main.to_json() == jb.main.to_json()
    jscope, jexe = JScope(), JExecutor()
    jexe.run(jb.startup, scope=jscope)
    tscope = scope_from_numpy({n: jscope.get_numpy(n)
                               for n in jscope.var_names()}, "cpu")
    names = [v.name for v in tb.fetches]
    for feed in book.batches(tb, 3):
        a = jexe.run(jb.main, feed=feed, fetch_list=names, scope=jscope)
        b = Executor("cpu").run(tb.main, feed=feed, fetch_list=names,
                                scope=tscope)
        np.testing.assert_allclose(b[0], a[0], rtol=1e-5)
        for x, y in zip(a[1:], b[1:]):
            x, y = np.asarray(x), np.asarray(y)
            assert x.shape == y.shape
            if x.dtype.kind in "iu":
                np.testing.assert_array_equal(y, x)
            else:
                np.testing.assert_allclose(y, x, rtol=1e-5, atol=1e-6)
    for n in jscope.var_names():
        x = jscope.get_numpy(n).astype(np.float64)
        y = tscope.get_numpy(n).astype(np.float64)
        rel = np.linalg.norm(y - x) / max(np.linalg.norm(x), 1e-30)
        assert rel <= 1e-4 or np.abs(y - x).max() <= 1e-6, n


@pytest.mark.parametrize("saver", ["jax", "port"])
def test_inference_models_cross_between_the_packages(saver, tmp_path):
    """An inference model saved by one package loads in the other; both
    fetch the same outputs from it. ``label_semantic_roles`` after one
    step: its Viterbi path (int64) and the pruned CRF scorer."""
    kw = dict(hidden_dim=16, depth=2, batch_size=4, seed=20)
    jb = book.label_semantic_roles(paddle_tpu, **kw)
    tb = book.label_semantic_roles(paddle_tpu_torch, **kw)
    feed = book.batches(tb, 2)
    jscope, jexe = JScope(), JExecutor()
    jexe.run(jb.startup, scope=jscope)
    jexe.run(jb.main, feed=feed[0], scope=jscope)
    tscope, texe = scope_from_numpy({n: jscope.get_numpy(n)
                                     for n in jscope.var_names()},
                                    "cpu"), Executor("cpu")
    d = str(tmp_path / "srl.inference.model")
    if saver == "jax":
        jio.save_inference_model(d, tb.infer_feeds, [jb.infer_targets[0]],
                                 jexe, jb.main, scope=jscope)
    else:
        tio.save_inference_model(d, tb.infer_feeds, [tb.infer_targets[0]],
                                 texe, tb.main, scope=tscope)
    assert os.path.exists(os.path.join(d, "__model__.json"))
    jprog, jfeeds, jfetch = jio.load_inference_model(d, jexe,
                                                     scope=JScope())
    tload = Scope()
    tprog, tfeeds, tfetch = tstatic.load_inference_model(d, texe,
                                                         scope=tload)
    assert tfeeds == jfeeds == tb.infer_feeds and tfetch == jfetch
    assert tprog.to_json() == jprog.to_json()
    assert all(isinstance(tload.find_var(n), torch.Tensor)
               for n in tload.var_names())
    inf = {k: feed[1][k] for k in tfeeds}
    jscope2 = JScope()
    jio.load_persistables(jexe, d, jprog, scope=jscope2)
    (a,) = jexe.run(jprog, feed=inf, fetch_list=jfetch, scope=jscope2)
    (b,) = texe.run(tprog, feed=inf, fetch_list=tfetch, scope=tload)
    np.testing.assert_array_equal(b, a)
    # and the loaded model equals the trained program's test clone
    (c,) = texe.run(tb.test_program, feed=feed[1], fetch_list=tfetch,
                    scope=tscope)
    np.testing.assert_array_equal(b, c)


def test_fluid_executor_honours_its_place():
    fluid = paddle_tpu_torch.fluid
    assert fluid.Executor(fluid.CPUPlace())._exe.device == torch.device("cpu")
    with pytest.raises(ValueError, match="TPUPlace"):
        fluid.Executor(TPUPlace())
    assert repr(fluid.CUDAPlace(1)) == "CUDAPlace(1)"
    fb = book.fit_a_line()
    scope = Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(fb.startup, scope=scope)
    (loss,) = exe.run(fb.main, feed=book.batches(fb, 1)[0],
                      fetch_list=[fb.loss], scope=scope)
    assert np.isfinite(loss) and \
        scope.find_var(fb.main.all_parameters()[0].name).device.type == "cpu"


def test_both_viterbi_paths_are_shifted_by_one():
    """A fault of the reference the port reproduces (ROADMAP C): its
    backtrack puts the best path's state at t + 1 into position t and
    repeats the last state, so emissions that pick tags 0, 1, 2, 1 under
    zero transitions decode as 1, 2, 1, 1 in both packages."""
    import jax.numpy as jnp
    from paddle_tpu.ops import registry as jreg
    from paddle_tpu_torch.ops import registry as treg
    em = np.full((1, 4, 3), -5.0, np.float32)
    for t, k in enumerate([0, 1, 2, 1]):
        em[0, t, k] = 5.0
    tran = np.zeros((5, 3), np.float32)
    j = jreg.execute(jreg.LoweringContext(), "crf_decoding",
                     {"Emission": [jnp.asarray(em)],
                      "Transition": [jnp.asarray(tran)]}, {})
    t = treg.execute(treg.LoweringContext(device="cpu"), "crf_decoding",
                     {"Emission": [torch.tensor(em)],
                      "Transition": [torch.tensor(tran)]}, {})
    np.testing.assert_array_equal(np.asarray(j["ViterbiPath"][0]),
                                  [[1, 2, 1, 1]])
    np.testing.assert_array_equal(t["ViterbiPath"][0].numpy(),
                                  [[1, 2, 1, 1]])


def test_import_stays_light_and_fluid_is_built_at_first_use():
    """``import paddle_tpu_torch`` loads the readers and the places, not
    the static or serving planes; ``paddle_tpu_torch.fluid`` builds the
    namespace at its first use."""
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys, paddle_tpu_torch as p\n"
            "heavy = ('framework', 'serving', 'layers', 'ops', 'models')\n"
            "bad = [m for m in sys.modules if m.split('.')[0] == "
            "'paddle_tpu_torch' and m.split('.')[1:2] and "
            "m.split('.')[1] in heavy]\n"
            "assert not bad, bad\n"
            "assert p.batch and p.reader.shuffle and p.DataFeeder\n"
            "assert p.dataset.wmt14.train and p.CPUPlace and p.CUDAPlace\n"
            "assert p.fluid.layers.DynamicRNN and p.fluid is p.fluid\n"
            "assert 'paddle_tpu_torch.framework' in sys.modules\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": root})
    assert res.returncode == 0, res.stderr
