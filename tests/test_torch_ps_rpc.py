"""The port's PS wire (``distributed/ps/rpc.py``, ``native_server.py``)
and communicator (``runtime.py``) against the JAX package on the CPU.

The wire is the reference's byte for byte: the port's ``PSClient``
against the JAX package's in-thread ``PSServer`` and the JAX
``PSClient`` against the port's servers (Python and native) return the
rows the reference pair returns, identical; the port's native and
Python servers agree as ``tests/test_ps_native.py`` holds them (rtol
1e-5, atol 1e-6: the C++ adagrad rounds its own way). Then the
barrier, heartbeats, an error that keeps the connection, the
``ps.rpc.call`` and ``ps.server.start`` fault sites, and the
communicator's sync, async and geo modes against the reference's on
local tables. Every server a test starts is stopped and every client
closed by the test.
"""

import torch_threads  # noqa: F401  (one worker's share of the cores)
import threading
import time

import numpy as np
import pytest

from paddle_tpu.distributed.ps import rpc as jrpc
from paddle_tpu.distributed.ps import runtime as jruntime
from paddle_tpu.distributed.ps import sparse_table as jst
from paddle_tpu.resilience.injector import fault_scope as jfault_scope

from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch.distributed.ps import REGISTRY, runtime
from paddle_tpu_torch.distributed.ps import native_server as tnative
from paddle_tpu_torch.distributed.ps import rpc as trpc
from paddle_tpu_torch.resilience.injector import fault_scope


def _ep(srv):
    if hasattr(srv, "_tcp"):
        return f"127.0.0.1:{srv._tcp.server_address[1]}"
    return f"127.0.0.1:{srv.port}"


def _server(kind):
    if kind == "jax":
        return jrpc.PSServer("127.0.0.1:0", 0, 1).start()
    if kind == "port":
        return trpc.PSServer("127.0.0.1:0", 0, 1).start()
    return tnative.NativePSServer("127.0.0.1:0", 0, 1)


def _workload(client, name="w", optimizer="adagrad"):
    """Create / pull / push / size / state / load through ``client``:
    every value the wire returns."""
    rng = np.random.RandomState(0)
    client.create_table(name, 4, optimizer=optimizer, lr=0.05,
                        init="zeros")
    out = []
    for _ in range(4):
        ids = rng.randint(0, 40, (6, 3)).astype(np.int64)
        out.append(client.pull(name, ids))
        client.push(name, ids, rng.randn(6, 3, 4).astype(np.float32))
    out.append(client.pull(name, np.arange(40, dtype=np.int64)))
    out.append(np.array([client.size(name)]))
    snap = client.state(name)
    client.load(name, {k: v * 0 + 1 for k, v in snap.items()
                       if not k.startswith("a:")})
    out.append(client.pull(name, np.arange(5, dtype=np.int64)))
    out.append(client.pull(name, np.zeros((0,), np.int64), value_dim=4))
    return out, snap


@pytest.fixture
def reference_rows():
    srv = _server("jax")
    c = jrpc.PSClient([_ep(srv)])
    try:
        yield _workload(c)
    finally:
        c.close()
        srv.stop()


@pytest.mark.parametrize("client_pkg,server", [
    ("port", "jax"), ("jax", "port"), ("port", "port"),
    ("jax", "native"), ("port", "native")])
def test_rows_across_packages_match_the_reference_pair(reference_rows,
                                                       client_pkg, server):
    ref, ref_snap = reference_rows
    srv = _server(server)
    mod = trpc if client_pkg == "port" else jrpc
    c = mod.PSClient([_ep(srv)])
    try:
        got, snap = _workload(c)
    finally:
        c.close()
        srv.stop()
    assert sorted(snap) == sorted(ref_snap)
    for g, r in zip(got, ref):
        assert g.shape == r.shape and g.dtype == r.dtype
        if server == "native":
            np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-6)
        else:
            np.testing.assert_array_equal(g, r)


def test_native_and_python_servers_train_alike():
    """``tests/test_ps_native.py:133`` on the port: one deterministic
    adagrad workload on both of the port's servers."""
    py, nat = _server("port"), _server("native")
    rng = np.random.RandomState(0)
    ids_seq = [rng.randint(0, 50, 32).astype(np.int64) for _ in range(5)]
    grads_seq = [rng.randn(32, 4).astype(np.float32) for _ in range(5)]
    outs = []
    try:
        for ep in (_ep(py), _ep(nat)):
            c = trpc.PSClient([ep])
            c.create_table("w", 4, optimizer="adagrad", lr=0.05,
                           init="zeros")
            for ids, g in zip(ids_seq, grads_seq):
                c.pull("w", ids)
                c.push("w", ids, g)
            outs.append(c.pull("w", np.arange(50, dtype=np.int64)))
            c.close()
    finally:
        py.stop()
        nat.stop()
    np.testing.assert_allclose(outs[0], outs[1], rtol=1e-5, atol=1e-6)


def test_two_servers_route_by_residue():
    srvs = [_server("native"), _server("port")]
    eps = [_ep(s) for s in srvs]
    c = trpc.PSClient(eps)
    try:
        t = trpc.RemoteSparseTable("r", 3, c, init="zeros", lr=1.0)
        ids = np.array([[1, 2], [3, 4]], np.int64)
        np.testing.assert_array_equal(t.pull(ids), np.zeros((2, 2, 3)))
        t.push(ids, np.ones((2, 2, 3), np.float32))
        np.testing.assert_array_equal(t.pull(ids), -np.ones((2, 2, 3)))
        assert t.size() == 4
        per = [trpc.PSClient([e]) for e in eps]
        assert [p.size("r") for p in per] == [2, 2]
        for p in per:
            p.close()
    finally:
        c.shutdown_servers()
        for s in srvs:
            s.stop()


@pytest.mark.parametrize("server", ["port", "native"])
def test_barrier_heartbeat_and_errors_keep_the_connection(server):
    srv = _server(server)
    ep = _ep(srv)
    clients = [trpc.PSClient([ep]) for _ in range(3)]
    try:
        done = []
        ts = [threading.Thread(target=lambda c=c: done.append(c.barrier(3)))
              for c in clients]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=30)
        assert done == [True] * 3
        clients[0].heartbeat(7)
        status = clients[1].worker_status()
        assert status["7"]["alive"] and status["7"]["age_sec"] < 5
        time.sleep(0.05)
        assert not clients[1].worker_status(timeout=0.01)["7"]["alive"]
        with pytest.raises(RuntimeError, match="not created"):
            clients[0].pull("ghost", np.array([1], np.int64))
        clients[0].create_table("ok", 2, init="zeros")
        assert clients[0].pull("ok", np.array([0], np.int64)).shape == (1, 2)
        with pytest.raises(ValueError, match="value_dim"):
            clients[0].pull("ok", np.zeros((0,), np.int64))
    finally:
        for c in clients:
            c.close()
        srv.stop()
    with pytest.raises(RuntimeError, match="closed"):
        clients[0].size("ok")


def test_shutdown_stops_the_native_server():
    srv = _server("native")
    c = trpc.PSClient([_ep(srv)])
    c.create_table("t", 2)
    c.shutdown_servers()
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline and srv._lib.ps_running(
            srv._handle or 0):
        time.sleep(0.05)
    srv.run()           # returns at once after a client's shutdown
    srv.stop()


def test_rpc_fault_site_retries_idempotent_calls_only():
    """``ps.rpc.call:drop@0``: the scope's first call drops; a pull
    retries through RetryPolicy (and re-dials), a push fails fast — the
    reference's rule, the same in both packages."""
    for mod, scope in ((jrpc, jfault_scope), (trpc, fault_scope)):
        srv = mod.PSServer("127.0.0.1:0", 0, 1).start()
        c = mod.PSClient([_ep(srv)])
        try:
            c.create_table("f", 2, init="zeros")
            with scope("ps.rpc.call:drop@0"):
                assert c.pull("f", np.array([3], np.int64)).shape == (1, 2)
            with scope("ps.rpc.call:drop@0"):
                with pytest.raises(ConnectionError):
                    c.push("f", np.array([3], np.int64),
                           np.ones((1, 2), np.float32))
            assert c.size("f") == 1
        finally:
            c.close()
            srv.stop()


def test_make_server_prefers_native_and_falls_back():
    s = tnative.make_server("127.0.0.1:0", 0, 1)
    assert isinstance(s, tnative.NativePSServer)
    s.stop()
    with fault_scope("ps.server.start:error"):
        s = tnative.make_server("127.0.0.1:0", 0, 1)
    assert isinstance(s, trpc.PSServer)
    s.stop()
    s = tnative.make_server("127.0.0.1:0", 0, 1, prefer_native=False)
    assert isinstance(s, trpc.PSServer)
    s.stop()
    tflags.set_flags({"ps_prefer_native": False})
    try:
        s = tnative.make_server("127.0.0.1:0", 0, 1)
        assert isinstance(s, trpc.PSServer)
        s.stop()
    finally:
        tflags.set_flags({"ps_prefer_native": True})


@pytest.fixture
def tables():
    REGISTRY.clear()
    jst.REGISTRY.clear()
    yield
    REGISTRY.clear()
    jst.REGISTRY.clear()


def _pushes(n=12):
    rng = np.random.RandomState(3)
    return [(rng.randint(0, 20, 8).astype(np.int64),
             rng.randn(8, 3).astype(np.float32)) for _ in range(n)]


@pytest.mark.parametrize("mode", ["sync", "geo", "async"])
def test_communicator_modes_match_the_reference(tables, mode):
    """Sync and geo (k 5: two flushes in the loop, one at the end) leave
    the reference's rows exactly; async's thread applies every push once
    its queue drains, so the rows are the same sums."""
    rows = []
    for reg, mod in ((jst.REGISTRY, jruntime), (REGISTRY, runtime)):
        t = reg.get_or_create("c", 3, init="zeros", lr=0.5)
        t.pull(np.arange(20, dtype=np.int64))   # a push updates pulled rows
        comm = mod.Communicator(mode=mode, send_queue_size=64,
                                geo_k_steps=5)
        comm.start()
        for ids, g in _pushes():
            comm.push_sparse("c", ids, g)
        if mode == "geo":
            assert comm._geo_deltas           # two pushes still held
            comm.flush_geo()
        deadline = time.monotonic() + 10
        while mode == "async" and time.monotonic() < deadline and (
                len(comm._q) if mod is runtime else comm._q.qsize()):
            time.sleep(0.01)
        time.sleep(0.05 if mode == "async" else 0)
        comm.stop()
        rows.append(t.pull(np.arange(20, dtype=np.int64)))
    if mode == "async":
        np.testing.assert_allclose(rows[1], rows[0], rtol=1e-6, atol=1e-7)
    else:
        np.testing.assert_array_equal(rows[1], rows[0])
    assert np.abs(rows[1]).sum() > 0


def test_geo_flush_and_stop_worker_without_a_server(tables):
    """The fleet lifecycle with no server endpoints: init_worker makes
    the strategy's communicator over local tables, stop_worker flushes
    geo's deltas and drops it."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet import DistributedStrategy
    st = DistributedStrategy()
    st.a_sync = True
    st.a_sync_configs = {"k_steps": 100}
    fleet.init(is_collective=False, strategy=st)
    fleet.init_worker()
    comm = runtime.get_communicator()
    assert comm.mode == "geo"
    t = REGISTRY.get_or_create("g", 3, init="zeros", lr=1.0)
    t.pull(np.arange(20, dtype=np.int64))
    ids, g = _pushes(1)[0]
    comm.push_sparse("g", ids, g)
    assert np.abs(t.pull(ids)).sum() == 0
    fleet.stop_worker()
    assert runtime.get_communicator() is None
    want = np.zeros((20, 3), np.float32)
    np.add.at(want, ids, -g)
    np.testing.assert_allclose(t.pull(np.arange(20, dtype=np.int64)),
                               want, rtol=1e-6, atol=1e-7)
    st.a_sync_configs = {"k_steps": -1}
    fleet.init(is_collective=False, strategy=st)
    fleet.init_worker()
    assert runtime.get_communicator().mode == "async"
    fleet.stop_worker()
    fleet.init(is_collective=False)
    fleet.init_worker()
    assert runtime.get_communicator().mode == "sync"
    fleet.stop_worker()
    with pytest.raises(RuntimeError, match="init_server"):
        fleet.run_server()


def test_geo_accumulation_loses_no_update_under_threads(tables):
    """Sixteen threads push into one geo communicator (a switch interval
    of 1 µs): every delta lands, flushes included."""
    import sys
    t = REGISTRY.get_or_create("s", 2, init="zeros", lr=1.0)
    t.pull(np.arange(8, dtype=np.int64))
    comm = runtime.Communicator(mode="geo", geo_k_steps=7)
    ids = np.arange(8, dtype=np.int64)
    ones = np.ones((8, 2), np.float32)

    def push():
        for _ in range(50):
            comm.push_sparse("s", ids, ones)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=push) for _ in range(16)]
        for th in ts:
            th.start()
        for th in ts:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in ts)
    finally:
        sys.setswitchinterval(old)
    comm.flush_geo()
    np.testing.assert_array_equal(t.pull(ids), np.full((8, 2), -800.0))
