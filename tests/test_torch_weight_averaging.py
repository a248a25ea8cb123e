"""The port's ExponentialMovingAverage, ModelAverage and
LookaheadOptimizer against the JAX package's on the CPU: the six cases
of ``tests/test_weight_averaging.py``, each run in both packages from
the same startup, each against the same numpy simulation of the update
rule and against the other package; then ``apply`` / ``restore`` when a
captured step holds the parameters (a holder registered on the scope the
way the executor's capture registers one): the parameters come back bit
for bit and the shadows are untouched.

Tolerances: the reference's (``1e-6 + 1e-5 |ref|`` against numpy,
Lookahead ``1e-5 + 1e-4 |ref|``); the two packages within
``1e-6 + 1e-5 |ref|`` of each other.
"""

import torch_threads  # noqa: F401  (one worker's share of the cores)
import types

import numpy as np
import pytest

import paddle_tpu.layers as JL
import paddle_tpu.optimizer as JO
from paddle_tpu.framework import Executor as JExecutor
from paddle_tpu.framework import Program as JProgram
from paddle_tpu.framework import Scope as JScope
from paddle_tpu.framework import program_guard as jguard
from paddle_tpu.framework import unique_name as jun

import paddle_tpu_torch.layers as TL
import paddle_tpu_torch.optimizer as TO
from paddle_tpu_torch.framework import (Executor, Program, Scope,
                                        program_guard, unique_name)
from paddle_tpu_torch.framework import executor as texec

JAX = types.SimpleNamespace(L=JL, O=JO, Program=JProgram, Scope=JScope,
                            guard=jguard, un=jun, exe=lambda: JExecutor())
PORT = types.SimpleNamespace(L=TL, O=TO, Program=Program, Scope=Scope,
                             guard=program_guard, un=unique_name,
                             exe=lambda: Executor("cpu"))


def _build(pkg, seed, wrap):
    """The reference test's linear model; ``wrap(pkg, loss)`` adds the
    optimizer and the averaging inside the name guard."""
    L = pkg.L
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = seed
    with pkg.guard(main, startup), pkg.un.guard():
        x = L.data("x", [2])
        y = L.data("y", [1])
        pred = L.fc(x, 1, bias_attr=False)
        loss = L.reduce_mean(L.square(L.elementwise_sub(pred, y)))
        extra = wrap(pkg, loss)
    return main, startup, loss, extra


def _both(seed, wrap):
    """(pkg, main, startup, loss, extra, scope, exe) for each package,
    the port's scope a copy of the JAX startup's."""
    out = []
    for pkg in (JAX, PORT):
        main, startup, loss, extra = _build(pkg, seed, wrap)
        scope, exe = pkg.Scope(), pkg.exe()
        exe.run(startup, scope=scope)
        out.append([pkg, main, startup, loss, extra, scope, exe])
    jscope, tscope = out[0][5], out[1][5]
    for n in jscope.var_names():
        tscope.set_var(n, jscope.get_numpy(n))
    return out


def _w_name(scope):
    return [n for n in scope.var_names() if n.endswith(".w_0")][0]


def _batches(seed, n, bs=8):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        xb = rng.randn(bs, 2).astype(np.float32)
        out.append({"x": xb, "y": xb.sum(1, keepdims=True)})
    return out


def _close(a, b, tol=(1e-6, 1e-5), msg=""):
    np.testing.assert_allclose(a, b, atol=tol[0], rtol=tol[1], err_msg=msg)


def _sgd_ema(decay):
    def wrap(pkg, loss):
        pkg.O.SGD(learning_rate=0.1).minimize(loss)
        return pkg.O.ExponentialMovingAverage(decay).update()
    return wrap


def test_ema_tracks_numpy_shadow():
    runs = _both(3, _sgd_ema(0.9))
    wname = _w_name(runs[0][5])
    got = {}
    for pkg, main, _, _, ema, scope, exe in runs:
        shadow = scope.get_numpy(wname)
        for feed in _batches(0, 10):
            exe.run(main, feed=feed, fetch_list=[], scope=scope)
            shadow = 0.9 * shadow + 0.1 * scope.get_numpy(wname)
        ema_name = dict(ema._pairs)[wname]
        _close(scope.get_numpy(ema_name), shadow)
        w_before = scope.get_numpy(wname)
        with ema.apply(scope):
            _close(scope.get_numpy(wname), shadow)
        np.testing.assert_array_equal(scope.get_numpy(wname), w_before)
        got[pkg is PORT] = scope.get_numpy(ema_name)
    _close(got[True], got[False])


def test_model_average_matches_trajectory_mean():
    def wrap(pkg, loss):
        pkg.O.SGD(learning_rate=0.1).minimize(loss)
        return pkg.O.ModelAverage().update()
    runs = _both(5, wrap)
    wname = _w_name(runs[0][5])
    got = {}
    for pkg, main, _, _, ma, scope, exe in runs:
        traj = []
        for feed in _batches(1, 7):
            exe.run(main, feed=feed, fetch_list=[], scope=scope)
            traj.append(scope.get_numpy(wname))
        with ma.apply(scope):
            got[pkg is PORT] = scope.get_numpy(wname)
            _close(got[pkg is PORT], np.mean(traj, axis=0))
        np.testing.assert_array_equal(scope.get_numpy(wname), traj[-1])
    _close(got[True], got[False])


def _lookahead(lr, alpha, k):
    def wrap(pkg, loss):
        pkg.O.LookaheadOptimizer(pkg.O.SGD(learning_rate=lr), alpha=alpha,
                                 k=k).minimize(loss)
    return wrap


def test_lookahead_matches_numpy_simulation():
    runs = _both(7, _lookahead(0.1, 0.5, 3))
    wname = _w_name(runs[0][5])
    got = {}
    for pkg, main, _, _, _, scope, exe in runs:
        w = scope.get_numpy(wname)   # fast
        slow = w.copy()
        for step, feed in enumerate(_batches(2, 7), 1):
            exe.run(main, feed=feed, fetch_list=[], scope=scope)
            xb, yb = feed["x"], feed["y"]
            grad = (2.0 / len(xb)) * xb.T @ (xb @ w - yb)
            w = w - 0.1 * grad
            if step % 3 == 0:
                slow = slow + 0.5 * (w - slow)
                w = slow.copy()
            _close(scope.get_numpy(wname), w, (1e-5, 1e-4), f"step {step}")
        got[pkg is PORT] = scope.get_numpy(wname)
    _close(got[True], got[False])


def test_lookahead_still_converges():
    runs = _both(9, _lookahead(0.2, 0.8, 2))
    losses = {}
    for pkg, main, _, loss, _, scope, exe in runs:
        losses[pkg is PORT] = [
            float(exe.run(main, feed=feed, fetch_list=[loss.name],
                          scope=scope)[0])
            for feed in _batches(3, 60, bs=16)]
    assert losses[True][-1] < 1e-3, losses[True][-1]
    _close(losses[True], losses[False], (1e-6, 1e-4))


def test_model_average_window_restarts():
    def wrap(pkg, loss):
        pkg.O.SGD(learning_rate=0.1).minimize(loss)
        return pkg.O.ModelAverage(max_average_window=3).update()
    runs = _both(11, wrap)
    wname = _w_name(runs[0][5])
    for pkg, main, _, _, ma, scope, exe in runs:
        traj = []
        for feed in _batches(4, 5):
            exe.run(main, feed=feed, fetch_list=[], scope=scope)
            traj.append(scope.get_numpy(wname))
        num, ssum = 0, 0.0
        for p in traj:
            num += 1
            reset = (num == 3)
            if reset:
                num = 1
            acc = ssum + p
            ssum = p if reset else acc
        with ma.apply(scope):
            _close(scope.get_numpy(wname), ssum / num)
        assert num < 5


def test_lookahead_respects_parameter_list():
    progs = {}
    for pkg in (JAX, PORT):
        L = pkg.L
        main, startup = pkg.Program(), pkg.Program()
        main.random_seed = startup.random_seed = 13
        with pkg.guard(main, startup), pkg.un.guard():
            x = L.data("x", [2])
            y = L.data("y", [1])
            h = L.fc(x, 4, bias_attr=False)        # frozen from training
            pred = L.fc(h, 1, bias_attr=False)     # trained
            loss = L.reduce_mean(L.square(L.elementwise_sub(pred, y)))
            frozen, trained = [v for v in main.global_block().vars.values()
                               if getattr(v, "is_parameter", False)]
            pkg.O.LookaheadOptimizer(pkg.O.SGD(learning_rate=0.1),
                                     k=2).minimize(
                loss, parameter_list=[trained])
        slow_vars = [n for n in main.global_block().vars if ".slow" in n]
        assert len(slow_vars) == 1
        assert slow_vars[0].startswith(trained.name)
        progs[pkg is PORT] = main.to_json()
    assert progs[True] == progs[False]


def _hold_params(scope, names):
    """What a capture does to the scope: its entry holds the tensors."""
    entry = texec._Entry(None, list(names), list(names), [], None)
    entry.graph, entry.runs = object(), 2
    scope._hold(list(names), entry)
    return entry


@pytest.mark.parametrize("kind", ["ema", "model_average"])
def test_restore_after_the_executor_holds_the_parameters(kind):
    """With the parameters held (``set_var`` then copies into their
    tensors), ``apply`` swaps the averages in and the block's end puts
    the parameters back bit for bit; the shadows do not move. A backup
    that were the parameter's own tensor would come back averaged."""
    def wrap(pkg, loss):
        pkg.O.SGD(learning_rate=0.1).minimize(loss)
        avg = pkg.O.ExponentialMovingAverage(0.9) if kind == "ema" \
            else pkg.O.ModelAverage()
        return avg.update()
    main, startup, loss, avg = _build(PORT, 3, wrap)
    scope, exe = Scope(), Executor("cpu")
    exe.run(startup, scope=scope)
    for feed in _batches(0, 4):
        exe.run(main, feed=feed, fetch_list=[], scope=scope)
    names = [p for p, _ in avg._pairs]
    entry = _hold_params(scope, names)
    tensors = {n: scope.find_var(n) for n in names}
    before = {n: scope.get_numpy(n) for n in names}
    shadows = {a: scope.get_numpy(a) for _, a in avg._pairs}
    with avg.apply(scope):
        for p, a in avg._pairs:
            assert scope.find_var(p) is tensors[p]     # copied in place
            want = shadows[a] if kind == "ema" else \
                shadows[a] / float(scope.get_numpy(avg._num_name)[0])
            np.testing.assert_array_equal(scope.get_numpy(p), want)
    for n in names:
        assert scope.find_var(n) is tensors[n]
        np.testing.assert_array_equal(scope.get_numpy(n), before[n])
    for a, v in shadows.items():
        np.testing.assert_array_equal(scope.get_numpy(a), v)
    assert entry.graph is not None
    # and the next step trains from the restored parameters
    exe.run(main, feed=_batches(5, 1)[0], fetch_list=[], scope=scope)
    assert all(np.isfinite(scope.get_numpy(n)).all() for n in names)
