"""The eight Paddle Book programs of ``tests/test_book.py`` through
``paddle_tpu_torch.fluid`` against the JAX package on the CPU.

Each program is built by ``paddle_tpu_torch.models.book`` in both
packages (with ``paddle_tpu`` and with ``paddle_tpu_torch``) at
``tests/test_book.py``'s sizes or smaller; both build the same Program,
JSON for JSON. The port's scope is loaded from the JAX startup's, and
both run 3 steps on the same batches, drawn once from the Book's reader
pipeline. Held to the JAX run: every fetch of every step (the loss
within 1e-5 relative, the accuracy and ``label_semantic_roles``'s
Viterbi path exactly, ``exponential_decay``'s lr within 1e-7 relative,
and the lr equal to ``0.01 * 0.5 ** floor(step / 100000)``), and every
variable of the scope after the steps (parameters, optimizer
accumulators, batch-norm statistics, the decay's step counter) within
1e-4 relative Frobenius distance or 1e-6 absolute per element.

The programs that minimize with Adam or Adagrad (``recognize_digits``,
``image_classification``, ``rnn_encoder_decoder``,
``machine_translation``) are held so in float64 (the scope and the feeds upcast, both
packages then compute in float64): losses within 1e-10
relative, every variable within 1e-8 relative Frobenius distance or
1e-9 absolute. In float32 only their first step is held (loss 1e-5,
accuracy exactly): the first convolution's gradient is ill-conditioned
(the batch-norm backward cancels over each channel's N*H*W values), and
XLA's float32 reductions on the CPU leave it 4e-4 to 3.5e-3 relative off
a float64 run of the same step in ``image_classification``, the port's
5e-7 to 1.6e-6 (ROADMAP C); and a convolution bias that a batch norm
follows has an exact gradient of zero, whose rounding noise each
package's Adam normalizes into steps of up to the lr. Adam's next steps
carry both into the parameters; Adagrad's do the same with the
decoders' small gradients.
"""

import torch_threads  # noqa: F401  (one worker's share of the cores)
import jax
import numpy as np
import pytest

import paddle_tpu
from paddle_tpu.framework import Executor as JExecutor
from paddle_tpu.framework import Scope as JScope

import paddle_tpu_torch
from paddle_tpu_torch.framework import Executor
from paddle_tpu_torch.models import book
from paddle_tpu_torch.models.convert import scope_from_numpy

STEPS = 3
#: the startup programs' seed: each run draws the same weights
SEED = 20
#: the programs held in float64: Adam and Adagrad normalize each
#: gradient by its own running size, so their first steps move a
#: parameter by up to the lr whatever the gradient's rounding
F64 = ("recognize_digits", "image_classification", "rnn_encoder_decoder",
       "machine_translation")
#: each program's sizes: ``tests/test_book.py``'s, or smaller
SIZES = {
    "fit_a_line": {},
    "recognize_digits": dict(batch_size=8),
    "word2vec": {},
    "image_classification": dict(depth=8, batch_size=4),
    "label_semantic_roles": dict(hidden_dim=16, depth=2, batch_size=4),
    "recommender_system": dict(batch_size=16),
    "rnn_encoder_decoder": dict(batch_size=4),
    "machine_translation": dict(batch_size=4),
}


def _close_state(got, ref, fro=1e-4, atol=1e-6):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    if not got.size:
        return
    rel = np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30)
    err = np.abs(got - ref).max()
    assert rel <= fro or err <= atol, (rel, err)


def _up(a):
    return a.astype(np.float64) if a.dtype == np.float32 else a


def _run(name, kw, steps=STEPS, f64=False):
    jb = book.PROGRAMS[name](paddle_tpu, seed=SEED, **kw)
    tb = book.PROGRAMS[name](paddle_tpu_torch, seed=SEED, **kw)
    assert tb.main.to_json() == jb.main.to_json()
    assert tb.startup.to_json() == jb.startup.to_json()
    jscope, jexe = JScope(), JExecutor()
    jexe.run(jb.startup, scope=jscope)
    start = {n: jscope.get_numpy(n) for n in jscope.var_names()}
    feeds = book.batches(tb, steps)
    if f64:
        start = {n: _up(a) for n, a in start.items()}
        feeds = [{k: _up(v) for k, v in f.items()} for f in feeds]
        jscope = JScope()
        for n, a in start.items():
            jscope.set_var(n, jax.numpy.asarray(a))
    tscope, texe = scope_from_numpy(start, "cpu"), Executor("cpu")
    jf = [v.name for v in jb.fetches]
    out = []
    for feed in feeds:
        a = jexe.run(jb.main, feed=feed, fetch_list=jf, scope=jscope)
        b = texe.run(tb.main, feed=feed, fetch_list=jf, scope=tscope)
        out.append((a, b))
    return jscope, tscope, out


@pytest.mark.parametrize("name", list(book.PROGRAMS))
def test_book_program_matches_jax(name):
    f64 = name in F64
    if f64:
        _, _, first = _run(name, SIZES[name], steps=1)
        np.testing.assert_allclose(first[0][1][0], first[0][0][0],
                                   rtol=1e-5)
        for x, y in zip(first[0][0][1:], first[0][1][1:]):
            np.testing.assert_array_equal(y, x)
    jscope, tscope, steps = _run(name, SIZES[name], f64=f64)
    loss_rtol, fro, atol = (1e-10, 1e-8, 1e-9) if f64 else (1e-5, 1e-4,
                                                            1e-6)
    for a, b in steps:
        np.testing.assert_allclose(b[0], a[0], rtol=loss_rtol)
        for x, y in zip(a[1:], b[1:]):
            x, y = np.asarray(x), np.asarray(y)
            assert x.shape == y.shape
            if x.dtype.kind in "iu" or name != "label_semantic_roles":
                np.testing.assert_array_equal(y, x)
            else:
                np.testing.assert_allclose(y, x, rtol=1e-7)
    if name == "label_semantic_roles":
        lrs = [float(np.asarray(b[2]).reshape(-1)[0]) for _, b in steps]
        np.testing.assert_allclose(
            lrs, [0.01 * 0.5 ** np.floor(s / 100000) for s in
                  range(1, STEPS + 1)], rtol=1e-7)
        counter = [n for n in jscope.var_names()
                   if n.startswith("lr_decay_step")]
        assert len(counter) == 1 and \
            float(tscope.get_numpy(counter[0])[0]) == STEPS
    assert sorted(tscope.var_names()) == sorted(jscope.var_names())
    for n in jscope.var_names():
        _close_state(tscope.get_numpy(n), jscope.get_numpy(n), fro, atol)
