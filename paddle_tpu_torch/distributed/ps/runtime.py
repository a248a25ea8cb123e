"""Parameter-server runtime — the counterpart of
``paddle_tpu/distributed/ps/runtime.py`` (pure Python and numpy: a
server process imports torch with the package but never touches the
card, so it makes no CUDA context and takes no card memory).

Analog of fleet/runtime/parameter_server_runtime.py:28 + the C++
communicator stack (operators/distributed/communicator.h:180-396:
Async/HalfAsync/Sync/Geo). The dense model runs on the card while the
sparse tables live in host RAM: in the trainer's own process
(:data:`~.sparse_table.REGISTRY`) or on PS server processes reached over
the RPC wire (:func:`connect_workers_to_servers`). The in-graph
``distributed_lookup_table`` pushes through the :class:`Communicator`:

- ``sync``: the push lands before the op returns, so step k's push is
  on the table before step k+1's pull (the reference's ordered
  io_callback);
- ``async``: pushes go to a bounded queue that a background thread
  applies; a pull may read a row before an earlier step's push landed;
- ``geo``: per-row deltas accumulate locally and are pushed every
  ``k_steps`` pushes and at :func:`stop_worker`.

Only sync is deterministic; async and geo keep the reference's
contract (rows move, the loss falls, geo's deltas are flushed at
stop_worker), not its trajectory.
"""

from __future__ import annotations

import collections
import os
import threading
from typing import Dict, Optional

import numpy as np

from ...analysis.concurrency import make_lock
from .sparse_table import REGISTRY


class Communicator:
    """Background push applier (communicator.h:180 AsyncCommunicator)."""

    def __init__(self, mode: str = "sync", send_queue_size: int = 20,
                 geo_k_steps: int = 100):
        self.mode = mode
        self._maxsize = max(1, int(send_queue_size))
        self._q: "collections.deque" = collections.deque()
        self._cv = threading.Condition(make_lock("Communicator._cv"))
        self._running = False
        self._thread: Optional[threading.Thread] = None
        self._geo_k = geo_k_steps
        self._geo_deltas: Dict[str, Dict[int, np.ndarray]] = {}
        self._geo_counter = 0
        self._geo_lock = make_lock("Communicator._geo_lock")

    def start(self):
        if self.mode == "sync":
            return
        self._running = True
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="Communicator")
        self._thread.start()

    def stop(self):
        self._running = False
        if self._thread is not None:
            self._put(None)
            self._thread.join(timeout=5)
            self._thread = None

    def _put(self, item):
        with self._cv:
            while len(self._q) >= self._maxsize:
                self._cv.wait()
            self._q.append(item)
            self._cv.notify_all()

    def _get(self):
        with self._cv:
            while not self._q:
                self._cv.wait()
            item = self._q.popleft()
            self._cv.notify_all()
            return item

    def _loop(self):
        while self._running:
            item = self._get()
            if item is None:
                break
            name, ids, grads = item
            table = REGISTRY.get(name)
            if table is not None:
                table.push(ids, grads)

    def push_sparse(self, name: str, ids, grads):
        if self.mode == "sync":
            table = REGISTRY.get(name)
            if table is not None:
                table.push(ids, grads)
        elif self.mode == "geo":
            self._geo_accumulate(name, ids, grads)
        else:  # async / half_async
            self._put((name, np.asarray(ids), np.asarray(grads)))

    def _geo_accumulate(self, name, ids, grads):
        """GeoCommunicator: accumulate deltas locally, sync every k steps
        (communicator.h:396)."""
        flat = np.asarray(ids).reshape(-1)
        g = np.asarray(grads, np.float32).reshape(flat.size, -1)
        with self._geo_lock:
            d = self._geo_deltas.setdefault(name, {})
            for i, k in enumerate(flat):
                d[int(k)] = d.get(int(k), 0) + g[i]
            self._geo_counter += 1
            due = self._geo_counter >= self._geo_k
        if due:
            self.flush_geo()

    def flush_geo(self):
        with self._geo_lock:
            pending, self._geo_deltas = self._geo_deltas, {}
            self._geo_counter = 0
        for name, deltas in pending.items():
            table = REGISTRY.get(name)
            if table is None or not deltas:
                continue
            ids = np.fromiter(deltas.keys(), np.int64)
            grads = np.stack(list(deltas.values()))
            table.push(ids, grads)


_communicator: Optional[Communicator] = None


def get_communicator() -> Optional[Communicator]:
    return _communicator


def init_worker(fleet):
    global _communicator
    strategy = fleet._strategy
    eps = fleet._role_maker.get_pserver_endpoints()
    if eps:
        connect_workers_to_servers(eps)
    if strategy is not None and strategy.a_sync:
        k = strategy.a_sync_configs.get("k_steps", -1)
        mode = "geo" if k > 0 else "async"
    else:
        mode = "sync"
    _communicator = Communicator(mode=mode,
                                 geo_k_steps=max(
                                     1, strategy.a_sync_configs["k_steps"]
                                     if strategy else 100))
    _communicator.start()


_server = None


def init_server(fleet, *args, **kwargs):
    """Bind this role's PS endpoint and host its table shards (analog of
    listen_and_serv_op setup; fleet_base.py init_server:424). In
    single-process mode (no server endpoints) tables stay in-process."""
    global _server
    eps = fleet._role_maker.get_pserver_endpoints()
    if not eps:
        return  # single-process backend: REGISTRY tables are local
    from .native_server import make_server
    idx = getattr(fleet._role_maker, "_server_id", 0)
    # the C++ server (GIL-free data plane) unless explicitly disabled
    prefer_native = os.environ.get("PADDLE_PS_NATIVE", "1") != "0"
    _server = make_server(eps[idx], idx, len(eps),
                          prefer_native=prefer_native)


def run_server(fleet):
    """Blocking serve loop (fleet.run_server; listen_and_serv
    RunImpl:352)."""
    if _server is None:
        raise RuntimeError("init_server() first (or no "
                           "PADDLE_PSERVERS_IP_PORT_LIST configured)")
    _server.run()


def stop_server():
    global _server
    if _server is not None:
        _server.stop()
        _server = None


_remote_client = None


def connect_workers_to_servers(endpoints):
    """Point the table registry at remote PS servers: every
    get_or_create becomes a RemoteSparseTable over the RPC client
    (parameter_prefetch.cc analog). Returns the client."""
    global _remote_client
    from .rpc import PSClient, RemoteSparseTable
    client = PSClient(endpoints)
    _remote_client = client
    REGISTRY.set_remote_factory(
        lambda name, dim, **kw: RemoteSparseTable(name, dim, client, **kw))
    return client


def stop_worker(fleet):
    global _communicator
    if _communicator is not None:
        if _communicator.mode == "geo":
            _communicator.flush_geo()
        _communicator.stop()
        _communicator = None
    REGISTRY.set_remote_factory(None)
    # drop cached remote tables — they hold connections to servers that
    # may be gone; a later run must get fresh (local or remote) tables
    from .rpc import RemoteSparseTable
    for name, t in list(REGISTRY.tables().items()):
        if isinstance(t, RemoteSparseTable):
            REGISTRY._tables.pop(name, None)
    global _remote_client
    if _remote_client is not None:
        _remote_client.close()
        _remote_client = None
