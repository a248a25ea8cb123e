"""``Executor.train_from_dataset`` over the in-graph
``distributed_lookup_table`` against the JAX package on the CPU, and the
fleet's PS lifecycle against a server process.

Parity: an in-graph Wide&Deep (4 slots, embed 4, hidden (16, 8), batch
32) from one dense init (``scope_from_numpy``) and one table state, six
batches through both packages' ``train_from_dataset`` (the JAX package's
ordered ``io_callback`` pulls after the previous push; the port's host
ops between the step's graphs do too): losses within 1e-5 relative, the
rows and the dense parameters within ``1e-6 + 1e-5 |ref|``, as
``tests/test_torch_ps_host_paced.py`` holds them. Then hogwild at 4
threads (the loss falls on a second epoch; every row lands), the
``TrainerDesc`` rules (explicit arguments win; ``print_period``) and one
run against the port's native server in a subprocess started through
``fleet.init_server`` / ``run_server``, held against the same run on
in-process tables loaded with the server's rows.
"""

import torch_threads  # noqa: F401  (one worker's share of the cores)
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from paddle_tpu.distributed.ps import sparse_table as jst
from paddle_tpu.framework import Executor as JExecutor
from paddle_tpu.framework import Scope as JScope
from paddle_tpu.models.ctr import build_wide_deep_program as jbuild
from paddle_tpu.trainer_desc import MultiTrainer as JMultiTrainer

from paddle_tpu_torch.distributed.ps import REGISTRY, SparseTable, runtime
from paddle_tpu_torch.distributed.ps.rpc import PSClient
from paddle_tpu_torch.framework import Executor, Scope
from paddle_tpu_torch.framework.executor import plan_pieces
from paddle_tpu_torch.models.convert import scope_from_numpy
from paddle_tpu_torch.models.ctr import build_wide_deep_program
from paddle_tpu_torch.trainer_desc import MultiTrainer

ROOT = Path(__file__).resolve().parents[1]
SLOTS, DIM, HIDDEN = 4, 4, (16, 8)


@pytest.fixture(autouse=True)
def _tables():
    REGISTRY.clear()
    jst.REGISTRY.clear()
    yield
    REGISTRY.clear()
    jst.REGISTRY.clear()


class _Feeds:
    """A Dataset facade over prebuilt feeds (``tools/hogwild_bench.py``'s
    ``_FeedStream``)."""

    def __init__(self, feeds):
        self.feeds = list(feeds)

    def batch_iterator(self, drop_last=False):
        return iter(self.feeds)


def _batches(steps=6, n=32, hi=300, seed=5):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(steps):
        ids = rng.randint(1, hi, (n, SLOTS)).astype(np.int64)
        out.append({"ids": ids,
                    "label": (ids[:, :1] % 2 == 0).astype(np.float32)})
    return out


def _kw(table="tfd", sparse_lr=0.5, dense_lr=0.05):
    return dict(num_slots=SLOTS, embed_dim=DIM, hidden_sizes=HIDDEN,
                table_name=table, sparse_lr=sparse_lr, dense_lr=dense_lr)


def _tables_like(ref_reg, reg, table, ids):
    """``reg``'s tables of ``table`` hold ``ref_reg``'s rows for ``ids``
    (drawn there once)."""
    for name, dim, lr in ((table, DIM, 0.5), (table + "_wide", 1, 0.5)):
        ref = ref_reg.get_or_create(name, dim, lr=lr)
        ref.pull(ids)
        t = SparseTable(name, dim, lr=lr)
        t.load_state({k: v.copy() for k, v in ref.state().items()})
        reg._tables[name] = t


def test_in_graph_program_matches_the_reference_and_splits_at_each_host_op():
    jm, _, _, _ = jbuild(**_kw())
    tm, _, _, _ = build_wide_deep_program(**_kw())
    assert jm.to_json() == tm.to_json()
    types_ = [op.type for op in tm.global_block().ops]
    assert types_.count("distributed_lookup_table") == 2
    assert types_.count("distributed_lookup_table_grad") == 2
    pieces = plan_pieces(tm, on_card=True)
    hosts = [types_[a] for a, b, host in pieces if host]
    assert hosts == ["distributed_lookup_table", "distributed_lookup_table",
                     "distributed_lookup_table_grad",
                     "distributed_lookup_table_grad"]
    assert sum(not h for _, _, h in pieces) == 4 and not pieces[-1][2]


@pytest.mark.parametrize("how", ["args", "desc"])
def test_train_from_dataset_matches_the_jax_package(how):
    batches = _batches()
    jm, js, jl, _ = jbuild(**_kw())
    tm, _, tl, _ = build_wide_deep_program(**_kw())
    jscope, jexe = JScope(), JExecutor()
    jexe.run(js, scope=jscope)
    tscope = scope_from_numpy({n: jscope.get_numpy(n)
                               for n in jscope.var_names()}, "cpu")
    every = np.unique(np.concatenate([b["ids"].ravel() for b in batches]))
    _tables_like(jst.REGISTRY, REGISTRY, "tfd", every)
    # the JAX package returns the last batch's fetches: one batch a call
    ref = [float(jexe.train_from_dataset(jm, _Feeds([b]), jscope,
                                         fetch_list=[jl])[0])
           for b in batches]
    got = []
    exe = Executor("cpu")
    if how == "args":
        last = exe.train_from_dataset(
            tm, _Feeds(batches), tscope, fetch_list=[tl],
            on_step=lambda i, f: got.append(float(f[0])))
    else:
        desc = MultiTrainer()
        desc.set_fetch_var_and_info([tl], ["loss"], 1000)
        last = exe.train_from_dataset(
            tm, _Feeds(batches), tscope, trainer_desc=desc,
            on_step=lambda i, f: got.append(float(f[0])))
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    np.testing.assert_allclose(float(last[0]), ref[-1], rtol=1e-5)
    for name in ("tfd", "tfd_wide"):
        np.testing.assert_allclose(REGISTRY.get(name).pull(every),
                                   jst.REGISTRY.get(name).pull(every),
                                   atol=1e-6, rtol=1e-5)
    for p in jm.all_parameters():
        np.testing.assert_allclose(tscope.get_numpy(p.name),
                                   jscope.get_numpy(p.name),
                                   atol=1e-6, rtol=1e-5)


def test_explicit_arguments_win_over_the_desc_and_print_period(capsys):
    tm, ts, tl, logit = build_wide_deep_program(**_kw())
    scope, exe = Scope(), Executor("cpu")
    exe.run(ts, scope=scope)
    desc = MultiTrainer()
    desc.set_fetch_var_and_info([logit], ["logit"], 2)
    out = exe.train_from_dataset(tm, _Feeds(_batches(5)), scope,
                                 fetch_list=[tl], fetch_info=["the loss"],
                                 trainer_desc=desc)
    assert np.asarray(out[0]).shape == ()
    printed = capsys.readouterr().out
    assert printed.count("[train_from_dataset] step") == 3   # 0, 2, 4
    assert "the loss=" in printed
    exe.train_from_dataset(tm, _Feeds(_batches(3)), scope, fetch_list=[tl],
                           debug=True)
    assert capsys.readouterr().out.count("step 0:") == 1   # period 100
    with pytest.raises(ValueError, match="requires a dataset"):
        exe.train_from_dataset(tm, None, scope)
    inf = exe.infer_from_dataset(tm, _Feeds(_batches(2)), scope,
                                 fetch_list=[logit])
    assert inf[0].shape == (32, 1)


def _epoch(exe, main, scope, loss, data, **kw):
    losses = []
    exe.train_from_dataset(main, data, scope, fetch_list=[loss],
                           on_step=lambda i, f: losses.append(float(f[0])),
                           **kw)
    return losses


def test_hogwild_at_four_threads_converges():
    """Four workers, each with its own key, against one scope and one
    table: the second epoch's loss is below the first's, every batch ran
    once an epoch, every row landed, and (the CPU) nothing captured."""
    main, startup, loss, _ = build_wide_deep_program(**_kw("hog"))
    scope, exe = Scope(), Executor("cpu")
    exe.run(startup, scope=scope)
    data = _Feeds(_batches(steps=24, hi=200, seed=9))
    desc = MultiTrainer()
    desc.set_thread(4)
    l1 = _epoch(exe, main, scope, loss, data, trainer_desc=desc)
    l2 = _epoch(exe, main, scope, loss, data, trainer_desc=desc)
    assert len(l1) == len(l2) == 24
    assert np.all(np.isfinite(l1 + l2))
    assert np.mean(l2) < np.mean(l1) - 0.01
    assert exe.hogwild_stats["warm_steps"] == 1
    assert exe.hogwild_stats["thread_steps"] == 23
    seen = np.unique(np.concatenate([b["ids"].ravel() for b in data.feeds]))
    assert REGISTRY.get("hog").size() == seen.size
    assert exe.captures == 0
    # the reference's hogwild learns the same task
    jm, js, jl, _ = jbuild(**_kw("jhog"))
    jscope, jexe = JScope(), JExecutor()
    jexe.run(js, scope=jscope)
    jdesc = JMultiTrainer()
    jdesc.set_thread(4)
    jexe.train_from_dataset(jm, data, jscope, fetch_list=[jl],
                            trainer_desc=jdesc)
    assert jst.REGISTRY.get("jhog").size() == seen.size


def test_hogwild_surfaces_a_worker_error():
    main, startup, loss, _ = build_wide_deep_program(**_kw("bad"))
    scope, exe = Scope(), Executor("cpu")
    exe.run(startup, scope=scope)
    feeds = _batches(6)
    feeds[3] = {"ids": feeds[3]["ids"]}          # no label
    desc = MultiTrainer()
    desc.set_thread(2)
    with pytest.raises(KeyError, match="label"):
        exe.train_from_dataset(main, _Feeds(feeds), scope,
                               fetch_list=[loss], trainer_desc=desc)
    with pytest.raises(ValueError, match="donate_state"):
        Executor("cpu", donate_state=True).train_from_dataset(
            main, _Feeds(feeds), scope, trainer_desc=desc)


_CHILD = r"""
import json, torch
from paddle_tpu_torch.distributed import fleet
from paddle_tpu_torch.distributed.ps import runtime
fleet.init(is_collective=False)
fleet.init_server()
srv = runtime._server
print(json.dumps({"server": type(srv).__name__, "port": srv.port}),
      flush=True)
fleet.run_server()
print(json.dumps({"cuda_initialized": torch.cuda.is_initialized()}),
      flush=True)
"""


def test_a_run_against_a_server_process_through_the_fleet_lifecycle(
        monkeypatch):
    from paddle_tpu_torch.distributed import fleet
    env = dict(os.environ, TRAINING_ROLE="PSERVER",
               PADDLE_PSERVERS_IP_PORT_LIST="127.0.0.1:0",
               PADDLE_PORT_ID="0", PYTHONPATH=str(ROOT))
    proc = subprocess.Popen([sys.executable, "-c", _CHILD], env=env,
                            stdout=subprocess.PIPE, text=True, cwd=ROOT)
    ep = None
    try:
        info = json.loads(proc.stdout.readline())
        assert info["server"] == "NativePSServer"
        ep = f"127.0.0.1:{info['port']}"
        monkeypatch.setenv("PADDLE_PSERVERS_IP_PORT_LIST", ep)
        monkeypatch.setenv("TRAINING_ROLE", "TRAINER")
        fleet.init(is_collective=False)
        fleet.init_worker()
        assert fleet.server_endpoints() == [ep]
        assert runtime.get_communicator().mode == "sync"
        batches = _batches()
        every = np.unique(np.concatenate([b["ids"].ravel()
                                          for b in batches]))
        main, startup, loss, _ = build_wide_deep_program(**_kw("remote"))
        scope, exe = Scope(), Executor("cpu")
        exe.run(startup, scope=scope)
        start = {n: scope.get_numpy(n) for n in scope.var_names()}
        client = runtime._remote_client
        rows0 = {}
        for name, dim in (("remote", DIM), ("remote_wide", 1)):
            REGISTRY.get_or_create(name, dim, lr=0.5)   # created remotely
            rows0[name] = client.pull(name, every, dim)
        remote = _epoch(exe, main, scope, loss, _Feeds(batches))
        after = {n: client.pull(n, every, d)
                 for n, d in (("remote", DIM), ("remote_wide", 1))}
        fleet.stop_worker()
        assert runtime.get_communicator() is None
        # the same epoch on in-process tables holding the server's rows
        for name, dim in (("remote", DIM), ("remote_wide", 1)):
            t = SparseTable(name, dim, lr=0.5)
            t.load_state({str(int(k)): r for k, r in zip(every,
                                                         rows0[name])})
            REGISTRY._tables[name] = t
        local = _epoch(Executor("cpu"), main, scope_from_numpy(start, "cpu"),
                       loss, _Feeds(batches))
        np.testing.assert_allclose(remote, local, rtol=1e-5)
        for n in after:
            np.testing.assert_allclose(after[n], REGISTRY.get(n).pull(every),
                                       atol=1e-6, rtol=1e-5)
    finally:
        if ep is not None:
            PSClient([ep]).shutdown_servers()
        out, _ = proc.communicate(timeout=60)
    assert proc.returncode == 0
    assert json.loads(out.strip().splitlines()[-1]) == {
        "cuda_initialized": False}
