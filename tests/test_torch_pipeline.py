"""The port's pipeline (``distributed/fleet/pipeline.py`` and
``PipelineOptimizer``) against the JAX package's on the CPU: the split
into per-stage phase programs, the GPipe and 1F1B runners against the
reference's runner and against plain full-batch training, the dispatch
order and its simulated concurrency, the fleet's pipeline strategy, and
the per-microbatch stash.

The stash test shows that each microbatch's boundary values live in
tensors of their own: a runner that stashes by binding the same tensor
under a second name (the reference's way, harmless for immutable arrays)
trains to other parameters in the port, whose executor writes persistable
outputs in place.

Tolerances: parameters within ``1e-5 + 1e-5 |ref|`` of the reference's
runner and within ``1e-5 + 1e-4 |ref|`` of plain training (the
reference's own bound), losses within 1e-5 relative.
"""

import types

import numpy as np
import pytest
import torch

import paddle_tpu.layers as JL
from paddle_tpu.distributed.fleet.pipeline import \
    PipelineRunner as JRunner
from paddle_tpu.framework import Executor as JExecutor
from paddle_tpu.framework import Program as JProgram
from paddle_tpu.framework import Scope as JScope
from paddle_tpu.framework import device_guard as jdevice_guard
from paddle_tpu.framework import program_guard as jguard
from paddle_tpu.framework import unique_name as jun
from paddle_tpu.optimizer import PipelineOptimizer as JPipe
from paddle_tpu.optimizer import SGDOptimizer as JSGD

import paddle_tpu_torch.layers as TL
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch.distributed.fleet import pipeline as tpipe
from paddle_tpu_torch.distributed.fleet.distributed_strategy import \
    DistributedStrategy
from paddle_tpu_torch.distributed.fleet.fleet_base import Fleet
from paddle_tpu_torch.framework import (Executor, Program, Scope,
                                        device_guard, program_guard,
                                        unique_name)
from paddle_tpu_torch.models.convert import scope_from_numpy
from paddle_tpu_torch.optimizer import PipelineOptimizer, SGDOptimizer

JAX = types.SimpleNamespace(L=JL, Program=JProgram, guard=jguard, un=jun,
                            dg=jdevice_guard, Pipe=JPipe, SGD=JSGD)
PORT = types.SimpleNamespace(L=TL, Program=Program, guard=program_guard,
                             un=unique_name, dg=device_guard,
                             Pipe=PipelineOptimizer, SGD=SGDOptimizer)


@pytest.fixture(autouse=True)
def _port_flags():
    saved = tflags.get_flags(["check_program"])
    tflags.set_flags({"check_program": False})
    yield
    tflags.set_flags(saved)


def _staged(pkg, n_stages=2, width=16, seed=11, n_mb=4, lr=0.1,
            pipeline=True):
    """``tests/test_pipeline.py``'s staged MLPs: ``n_stages`` device
    guards (one fc each, the last with the loss); ``pipeline=False``
    builds the plain twin, minimized by SGD."""
    L = pkg.L
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = seed
    with pkg.guard(main, startup), pkg.un.guard():
        h = None
        for s in range(n_stages):
            with pkg.dg(f"gpu:{s}") if pipeline else _null():
                if s == 0:
                    x = L.data("x", [6])
                    y = L.data("y", [1])
                    h = x
                if s < n_stages - 1:
                    h = L.fc(h, width, act="relu")
                else:
                    pred = L.fc(h, 1)
                    loss = L.mean(L.square_error_cost(pred, y))
        opt = pkg.Pipe(pkg.SGD(lr), num_microbatches=n_mb) if pipeline \
            else pkg.SGD(lr)
        opt.minimize(loss)
    return main, startup, loss, opt


class _null:
    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


def _mb_feeds(n_mb, bs=8, seed=0):
    rng = np.random.RandomState(seed)
    W = np.random.RandomState(9).randn(6, 1).astype(np.float32)
    feeds = []
    for _ in range(n_mb):
        x = rng.randn(bs, 6).astype(np.float32)
        feeds.append({"x": x, "y": (x @ W).astype(np.float32)})
    return feeds


def _phase_types(stages):
    return [[[op.type for op in prog.global_block().ops]
             for _, prog in st.phases()] for st in stages]


def test_split_structure_matches_the_reference():
    (jm, _, _, _), (tm, _, _, _) = _staged(JAX), _staged(PORT)
    js, ts = jm._pipeline_stages, tm._pipeline_stages
    assert [s.device for s in ts] == [s.device for s in js] == \
        ["gpu:0", "gpu:1"]
    assert _phase_types(ts) == _phase_types(js)
    for jst, tst in zip(js, ts):
        for (_, jp), (_, tp) in zip(jst.phases(), tst.phases()):
            assert tp.to_json() == jp.to_json()
    o0, o1 = (_phase_types(ts)[s][2] for s in (0, 1))
    assert o0.count("sgd") == 2 and o1.count("sgd") == 2
    assert any("@PACC" in n for n in ts[0].backward.global_block().vars)


def _run_pipe(pkg, schedule, n_stages, steps, feeds, start=None):
    main, startup, loss, opt = _staged(pkg, n_stages)
    if pkg is JAX:
        scope, exe = JScope(), JExecutor()
        exe.run(startup, scope=scope)
    else:
        scope = scope_from_numpy(start, "cpu")
        exe = Executor("cpu")
    runner = opt.runner(schedule=schedule)
    losses = [float(runner.run(exe, scope, feeds,
                               fetch_list=[loss.name])[0])
              for _ in range(steps)]
    params = {p.name: scope.get_numpy(p.name) for p in main.all_parameters()}
    return losses, params, scope, runner


@pytest.mark.parametrize("schedule,n_stages", [("gpipe", 2), ("1f1b", 4)])
def test_runner_matches_the_reference_runner_and_plain_training(
        schedule, n_stages):
    feeds = _mb_feeds(4)
    jl, jp, _, jr = _run_pipe(JAX, schedule, n_stages, 3, feeds)
    # the port from the JAX startup's values
    js0 = JScope()
    JExecutor().run(_staged(JAX, n_stages)[1], scope=js0)
    start = {n: js0.get_numpy(n) for n in js0.var_names()}
    tl, tp, _, tr = _run_pipe(PORT, schedule, n_stages, 3, feeds, start)
    assert tr.dispatch_log == jr.dispatch_log
    for a, b in zip(jl, tl):
        assert abs(b - a) <= 1e-5 * abs(a), (jl, tl)
    for n in jp:
        np.testing.assert_allclose(tp[n], jp[n], rtol=1e-5, atol=1e-5,
                                   err_msg=n)
    # plain SGD on the concatenated batch, from the same start
    pm, _, pl, _ = _staged(PORT, n_stages, pipeline=False)
    pscope, pexe = scope_from_numpy(start, "cpu"), Executor("cpu")
    whole = {k: np.concatenate([f[k] for f in feeds]) for k in feeds[0]}
    for _ in range(3):
        pexe.run(pm, feed=whole, fetch_list=[pl], scope=pscope)
    for n in tp:
        np.testing.assert_allclose(tp[n], pscope.get_numpy(n), rtol=1e-4,
                                   atol=1e-5, err_msg=n)


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_dispatch_log_and_schedule_concurrency_equal_the_reference(
        schedule):
    (jm, _, _, _), (tm, _, _, _) = (_staged(JAX, 4, n_mb=8),
                                    _staged(PORT, 4, n_mb=8))
    jr = JRunner(jm._pipeline_stages, 8, schedule=schedule)
    tr = tpipe.PipelineRunner(tm._pipeline_stages, 8, schedule=schedule)
    assert tr._stage_orders() == jr._stage_orders()
    assert tr._linearize() == jr._linearize()
    assert tr.schedule_concurrency() == jr.schedule_concurrency()
    assert tr.schedule_concurrency() > 2.0


class _AliasingRunner(tpipe.PipelineRunner):
    """The reference's stash on the port's executor: a microbatch's
    entry bound to the scope's own tensor, and bound back."""

    def _put(self, store, key, src):
        store[key] = src

    def _copy_into(self, scope, name, src):
        scope.set_var(name, src)


def test_stash_keeps_each_microbatch_apart():
    """Each microbatch's boundary values have tensors of their own, beside
    the scope (no name of the scope changes after the first step, which
    would key every program anew), filled in place from the second step
    on; a runner whose stash aliases the scope's tensors trains to other
    parameters."""
    feeds = _mb_feeds(4)
    js0 = JScope()
    JExecutor().run(_staged(JAX)[1], scope=js0)
    start = {n: js0.get_numpy(n) for n in js0.var_names()}
    _, good, scope, runner = _run_pipe(PORT, "gpipe", 2, 2, feeds, start)
    stash = runner._stashes[scope]
    assert not [n for n in scope.var_names() if "@MB" in n]
    assert {mb for _, mb in stash} == {0, 1, 2, 3}
    ptrs = [t.untyped_storage().data_ptr() for t in stash.values()]
    ptrs += [scope.find_var(n).untyped_storage().data_ptr()
             for n in {n for n, _ in stash}]
    assert len(set(ptrs)) == len(ptrs)
    # the boundary value of each microbatch differs from the others
    h = sorted({n for n, _ in stash if not n.endswith("@GRAD")})
    assert h
    for n in h:
        vals = [stash[(n, mb)] for mb in range(4)]
        assert all(not torch.equal(vals[0], v) for v in vals[1:]), n
    # a third step reuses the tensors and adds no name to the scope
    before = {k: t.untyped_storage().data_ptr() for k, t in stash.items()}
    names = set(scope.var_names())
    runner.run(Executor("cpu"), scope, feeds, fetch_list=[])
    assert {k: t.untyped_storage().data_ptr()
            for k, t in runner._stashes[scope].items()} == before
    assert set(scope.var_names()) == names
    # the aliasing stash: same program, same start, other parameters
    main, startup, loss, opt = _staged(PORT)
    bad_scope = scope_from_numpy(start, "cpu")
    bad = _AliasingRunner(main._pipeline_stages, 4)
    exe = Executor("cpu")
    for _ in range(2):
        bad.run(exe, bad_scope, feeds, fetch_list=[loss.name])
    diffs = [float(np.abs(bad_scope.get_numpy(n) - good[n]).max())
             for n in good]
    assert max(diffs) > 1e-4, diffs


def test_fleet_pipeline_strategy_trains():
    f = Fleet()
    f.init(is_collective=True)
    strategy = DistributedStrategy()
    strategy.pipeline = True
    strategy.pipeline_configs = {"accumulate_steps": 2}
    main, startup = Program(), Program()
    main.random_seed = startup.random_seed = 11
    with program_guard(main, startup), unique_name.guard():
        with device_guard("gpu:0"):
            x = TL.data("x", [6])
            y = TL.data("y", [1])
            h = TL.fc(x, 16, act="relu")
        with device_guard("gpu:1"):
            pred = TL.fc(h, 1)
            loss = TL.mean(TL.square_error_cost(pred, y))
        f.distributed_optimizer(SGDOptimizer(0.05), strategy).minimize(loss)
    runner = f.pipeline_runner()
    assert f.pipeline_runner(schedule="1f1b").schedule == "1f1b"
    scope, exe = Scope(), Executor("cpu")
    exe.run(startup, scope=scope)
    feeds = _mb_feeds(2)
    first = runner.run(exe, scope, feeds, fetch_list=[loss.name])
    for _ in range(20):
        last = runner.run(exe, scope, feeds, fetch_list=[loss.name])
    assert float(last[0]) < float(first[0])
    rep = runner.overlap_report()
    assert set(rep) == {"schedule_speedup", "host_enqueue_fraction",
                        "enqueue_wall_s", "total_wall_s", "n_dispatches"}
    assert rep["n_dispatches"] == len(runner.dispatch_log)
    assert 0.0 < rep["host_enqueue_fraction"] <= 1.0


def test_stage_devices_and_their_checks():
    main, startup, loss, opt = _staged(PORT)
    with pytest.raises(ValueError, match="call minimize"):
        PipelineOptimizer(SGDOptimizer(0.1)).runner()
    with pytest.raises(ValueError, match="only 1 devices"):
        opt.runner(devices=["cpu"])
    have = torch.cuda.device_count()
    with pytest.raises(ValueError, match="lacks"):
        opt.runner(devices=[f"cuda:{have}", f"cuda:{have + 1}"])
    with pytest.raises(ValueError, match="schedule"):
        opt.runner(schedule="zigzag")
    runner = opt.runner(devices=["cpu", "cpu"])
    scope = Scope()
    Executor("cpu").run(startup, scope=scope)
    out = runner.run(None, scope, _mb_feeds(4), fetch_list=[loss.name])
    assert np.isfinite(out[0])
    with pytest.raises(KeyError, match="forward"):
        runner.run(None, scope, _mb_feeds(4), fetch_list=["no_such"])
