"""The port's host-paced parameter-server tier (``distributed/ps``:
the sparse tables, the pull prefetcher, ``run_host_paced``) and its
Wide&Deep program against the JAX package on the CPU, and the
counterparts of ``tests/test_ps_host_paced.py``.

Parity: Wide&Deep at 8 slots, embed 8, hidden (64, 32), batch 32, five
host-paced steps from one scope (``scope_from_numpy``) and one table
state. Each batch is released to the prefetcher only after the step
before it pushed, so both runs pull the same rows. The losses within
1e-5 relative, the fetched row gradients, the pushed rows and the dense
parameters within ``1e-6 + 1e-5 |ref|``.
"""

import torch_threads  # noqa: F401  (one worker's share of the cores)
import threading

import numpy as np
import pytest

from paddle_tpu.distributed.ps import sparse_table as jst
from paddle_tpu.distributed.ps.host_paced import SparseFeed as JFeed
from paddle_tpu.distributed.ps.host_paced import run_host_paced as jrun
from paddle_tpu.framework import Executor as JExecutor
from paddle_tpu.framework import Scope as JScope
from paddle_tpu.models.ctr import build_wide_deep_program as jbuild

from paddle_tpu_torch.distributed.ps import (REGISTRY, SparseFeed,
                                             SparseTable, run_host_paced)
from paddle_tpu_torch.framework import Executor, Scope
from paddle_tpu_torch.models.convert import scope_from_numpy
from paddle_tpu_torch.models.ctr import build_wide_deep_program

SLOTS, DIM, STEPS = 4, 8, 40


@pytest.fixture(autouse=True)
def _port_flags():
    yield
    REGISTRY.clear()
    jst.REGISTRY.clear()


def _batches(steps=STEPS, n=32, slots=SLOTS, hi=300, seed=3):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(steps):
        ids = rng.randint(1, hi, (n, slots)).astype(np.int64)
        y = (ids[:, 0] % 2 == 0).astype(np.float32)[:, None]
        out.append({"ids": ids, "label": y})
    return out


def _gated(batches, done):
    for i, b in enumerate(batches):
        if i:
            done[i - 1].wait()
        yield b


def _run(run, exe, main, scope, loss, feeds, batches, params):
    """Steps one at a time through the prefetcher: per step the fetches
    and the dense parameters after it."""
    done = [threading.Event() for _ in batches]
    steps = []

    def on_step(i, fetched):
        steps.append((fetched, {n: scope.get_numpy(n) for n in params}))
        done[i].set()

    run(exe, main, scope, _gated(batches, done), feeds,
        fetch_list=[loss.name] + [f.grad_var for f in feeds],
        on_step=on_step, collect=False)
    return steps


def test_wide_deep_host_paced_matches_jax():
    kw = dict(num_slots=8, embed_dim=8, hidden_sizes=(64, 32),
              table_name="wd", sparse_lr=0.05, dense_lr=0.01,
              host_paced=True)
    jm, js, jl, _ = jbuild(**kw)
    tm, _, tl, _ = build_wide_deep_program(**kw)
    assert jm.to_json() == tm.to_json()
    jscope, jexe = JScope(), JExecutor()
    jexe.run(js, scope=jscope)
    tscope = scope_from_numpy({n: jscope.get_numpy(n)
                               for n in jscope.var_names()}, "cpu")
    batches = _batches(steps=5, slots=8, hi=400, seed=5)
    jfeeds = [JFeed("ctr_emb", "wd", 8, lr=0.05),
              JFeed("ctr_wide", "wd_wide", 1, lr=0.05)]
    tfeeds = [SparseFeed("ctr_emb", "wd", 8, lr=0.05),
              SparseFeed("ctr_wide", "wd_wide", 1, lr=0.05)]
    for jf, tf in zip(jfeeds, tfeeds):
        for b in batches:          # every row the steps read, drawn once
            jf.table().pull(b["ids"])
        tf.table().load_state({k: v.copy() for k, v in
                               jf.table().state().items()})
    params = [p.name for p in jm.all_parameters()]
    a = _run(jrun, jexe, jm, jscope, jl, jfeeds, batches, params)
    b = _run(run_host_paced, Executor("cpu"), tm, tscope, tl, tfeeds,
             batches, params)
    assert len(a) == len(b) == 5
    for (fa, pa), (fb, pb) in zip(a, b):
        np.testing.assert_allclose(fb[0], fa[0], rtol=1e-5)
        for x, y in zip(fb[1:], fa[1:]):
            np.testing.assert_allclose(x, y, atol=1e-6, rtol=1e-5)
        for n in params:
            np.testing.assert_allclose(pb[n], pa[n], atol=1e-6, rtol=1e-5)
    for jf, tf in zip(jfeeds, tfeeds):
        js_, ts_ = jf.table().state(), tf.table().state()
        assert sorted(js_) == sorted(ts_)
        for k in js_:
            np.testing.assert_allclose(ts_[k], js_[k], atol=1e-6, rtol=1e-5)


def _build(build, host_paced):
    main, startup, loss, _ = build(
        num_slots=SLOTS, embed_dim=DIM, hidden_sizes=(16,),
        table_name="hp_emb", sparse_lr=5.0, dense_lr=0.05,
        host_paced=host_paced)
    main.random_seed = startup.random_seed = 11
    return main, startup, loss


def test_host_paced_program_has_fetchable_row_grads():
    main, _, _ = _build(build_wide_deep_program, host_paced=True)
    blk = main.global_block()
    assert "ctr_emb@GRAD" in blk.vars and "ctr_wide@GRAD" in blk.vars
    types = [op.type for op in blk.ops]
    assert "distributed_lookup_table" not in types
    assert "distributed_lookup_table_grad" not in types
    # the in-graph transport (A7.4) is the reference's program: the same
    # JSON, the rows pulled and pushed by host ops
    jin, _, _, _ = jbuild(host_paced=False)
    tin, _, _, _ = build_wide_deep_program(host_paced=False)
    assert tin.to_json() == jin.to_json()
    assert "ctr_emb@GRAD" in tin.global_block().vars
    assert [op.type for op in tin.global_block().ops].count(
        "distributed_lookup_table_grad") == 2


def _zero_tables(registry):
    registry.clear()
    registry.get_or_create("hp_emb", DIM, lr=5.0, init="zeros")
    registry.get_or_create("hp_emb_wide", 1, lr=5.0, init="zeros")


def test_host_paced_matches_the_in_graph_trajectory():
    """The port's host-paced loop against the JAX package's in-graph
    transport from the same seeded dense init and zero tables: same
    pulls, same pushes, different transport, so the same losses. The
    in-graph op pulls after the previous push; here each batch reaches
    the prefetcher after the step before it pushed, so the host-paced
    loop does too, and the whole trajectory is held within 1e-4 (the
    reference's test of its own loop lets the prefetcher run ahead and
    holds 8%)."""
    _zero_tables(jst.REGISTRY)
    jm, js, jl = _build(jbuild, host_paced=False)
    jscope, jexe = JScope(), JExecutor()
    jexe.run(js, scope=jscope)
    io_losses = [float(jexe.run(jm, feed=b, fetch_list=[jl.name],
                                scope=jscope)[0])
                 for b in _batches()]
    _zero_tables(REGISTRY)
    tm, ts, tl = _build(build_wide_deep_program, host_paced=True)
    scope, exe = Scope(), Executor("cpu")
    exe.run(ts, scope=scope)
    feeds = [SparseFeed("ctr_emb", "hp_emb", DIM, lr=5.0),
             SparseFeed("ctr_wide", "hp_emb_wide", 1, lr=5.0)]
    hp_losses = [float(f[0]) for f, _ in _run(
        run_host_paced, exe, tm, scope, tl, feeds, _batches(), [])]
    assert len(io_losses) == len(hp_losses) == STEPS
    assert hp_losses[-1] < hp_losses[0] - 0.03
    np.testing.assert_allclose(hp_losses[0], io_losses[0], rtol=1e-5)
    np.testing.assert_allclose(hp_losses, io_losses, rtol=1e-4)


def test_host_paced_rows_actually_update():
    REGISTRY.clear()
    REGISTRY.get_or_create("hp_emb", DIM, lr=5.0, init="random")
    REGISTRY.get_or_create("hp_emb_wide", 1, lr=5.0, init="zeros")
    main, startup, loss = _build(build_wide_deep_program, host_paced=True)
    scope, exe = Scope(), Executor("cpu")
    exe.run(startup, scope=scope)
    ids = _batches(steps=1)[0]["ids"]
    before = REGISTRY.get("hp_emb").pull(ids).copy()
    feeds = [SparseFeed("ctr_emb", "hp_emb", DIM, lr=5.0),
             SparseFeed("ctr_wide", "hp_emb_wide", 1, lr=5.0)]
    run_host_paced(exe, main, scope, _batches(steps=5), feeds,
                   fetch_list=[loss.name])
    assert REGISTRY.get("hp_emb").size() > 0
    assert np.abs(REGISTRY.get("hp_emb").pull(ids) - before).sum() > 0
    assert np.abs(REGISTRY.get("hp_emb_wide").pull(ids)).sum() > 0


def test_tables_of_one_name_draw_the_same_rows_in_one_process():
    """The tables' init stream is ``RandomState(hash(name) % 2**31)``,
    which PYTHONHASHSEED salts per process (ROADMAP C): within one
    process both packages draw the same rows for a name."""
    ids = np.array([[3, 7, 3], [11, 2, 7]], np.int64)
    a = jst.SparseTable("same_name", 6).pull(ids)
    b = SparseTable("same_name", 6).pull(ids)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a[0, 0], a[0, 2])
