"""Parameter-server RPC wire — the port's copy of
``paddle_tpu/distributed/ps/rpc.py`` (pure Python and numpy, no torch):
TCP servers hosting sparse-table shards, clients scatter-gathering
pulls/pushes across them. The wire protocol is the reference's byte for
byte, so a client of either package talks to a server of either (and to
the native server, ``native_server.py``).

Capability analog of the reference's PS transport stack:
operators/distributed/grpc/grpc_server.cc + grpc_client.cc (AsyncSendVar
:66 / AsyncGetVar :152), listen_and_serv_op.cc:127 (RunSyncLoop) and the
row sharding of large_scale_kv.h. Transport is a compact length-prefixed
binary protocol over TCP (struct header + raw numpy buffers — no
pickle): the reference serializes LoDTensors into protobuf
(sendrecvop_utils.cc); here a pull is one request/response round trip
carrying int64 ids out and float32 rows back.

Row placement: feasign id -> server ``id % num_servers`` (the
DistributeTranspiler's hash placement); each server owns a full
SparseTable for its residue class.
"""

from __future__ import annotations

import socket
import socketserver
import struct
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ... import flags as _flags
from ...analysis.concurrency import make_lock
from ...resilience.injector import fault_point
from ...resilience.retry import RetryError, RetryPolicy
from .sparse_table import SparseTable

# ops
OP_CREATE = 1
OP_PULL = 2
OP_PUSH = 3
OP_SIZE = 4
OP_STATE = 5
OP_LOAD = 6
OP_BARRIER = 7
OP_SHUTDOWN = 8
OP_HEARTBEAT = 9
OP_WORKER_STATUS = 10
OP_OK = 100
OP_ERR = 101

_HDR = struct.Struct("<BI")          # op, payload length


def _send_msg(sock: socket.socket, op: int, payload: bytes = b""):
    sock.sendall(_HDR.pack(op, len(payload)) + payload)

def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("PS peer closed connection")
        buf += chunk
    return buf


def _recv_msg(sock: socket.socket) -> Tuple[int, bytes]:
    op, ln = _HDR.unpack(_recv_exact(sock, _HDR.size))
    return op, _recv_exact(sock, ln) if ln else b""


def _pack_str(s: str) -> bytes:
    b = s.encode()
    return struct.pack("<H", len(b)) + b


def _unpack_str(buf: bytes, off: int) -> Tuple[str, int]:
    (ln,) = struct.unpack_from("<H", buf, off)
    off += 2
    return buf[off:off + ln].decode(), off + ln


def _pack_array(a: np.ndarray) -> bytes:
    a = np.ascontiguousarray(a)
    dt = _pack_str(str(a.dtype))
    shape = struct.pack("<B", a.ndim) + struct.pack(
        f"<{a.ndim}q", *a.shape)
    return dt + shape + a.tobytes()


def _unpack_array(buf: bytes, off: int) -> Tuple[np.ndarray, int]:
    dts, off = _unpack_str(buf, off)
    (nd,) = struct.unpack_from("<B", buf, off)
    off += 1
    shape = struct.unpack_from(f"<{nd}q", buf, off)
    off += 8 * nd
    dt = np.dtype(dts)
    n = int(np.prod(shape)) * dt.itemsize
    a = np.frombuffer(buf[off:off + n], dtype=dt).reshape(shape)
    return a, off + n


def _pack_rows(rows: Dict[str, np.ndarray]) -> bytes:
    """'<q count, then (str key, array)*' — the ONE encoding of a table
    snapshot, shared by client state/load and server dispatch."""
    out = [struct.pack("<q", len(rows))]
    for k, v in rows.items():
        out.append(_pack_str(k))
        out.append(_pack_array(np.asarray(v, np.float32)))
    return b"".join(out)


def _unpack_rows(buf: bytes, off: int = 0) -> Dict[str, np.ndarray]:
    (n,) = struct.unpack_from("<q", buf, off)
    off += 8
    rows = {}
    for _ in range(n):
        k, off = _unpack_str(buf, off)
        v, off = _unpack_array(buf, off)
        rows[k] = v
    return rows


class _Handler(socketserver.BaseRequestHandler):
    def handle(self):
        server: "PSServer" = self.server.ps_server  # type: ignore
        sock = self.request
        try:
            while True:
                op, payload = _recv_msg(sock)
                try:
                    resp = server.dispatch(op, payload)
                except Exception as e:  # report, keep serving
                    _send_msg(sock, OP_ERR, str(e).encode())
                    continue
                if resp is None:        # shutdown
                    _send_msg(sock, OP_OK)
                    self.server._BaseServer__shutdown_request = True
                    threading.Thread(target=self.server.shutdown,
                                     daemon=True).start()
                    return
                _send_msg(sock, OP_OK, resp)
        except (ConnectionError, OSError):
            return


class _TCPServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True


class PSServer:
    """One parameter server: hosts SparseTables for its residue class of
    the id space (listen_and_serv analog)."""

    def __init__(self, endpoint: str, server_index: int = 0,
                 num_servers: int = 1):
        host, port = endpoint.rsplit(":", 1)
        self.endpoint = endpoint
        self.server_index = server_index
        self.num_servers = num_servers
        self.tables: Dict[str, SparseTable] = {}
        self._barrier_count = 0
        self._barrier_gen = 0
        self._barrier_cv = threading.Condition(
            make_lock("PSServer._barrier_cv"))
        # worker liveness (heart_beat_monitor.cc analog): worker id ->
        # last heartbeat monotonic time
        self._heartbeats: Dict[int, float] = {}
        self._hb_lock = make_lock("PSServer._hb_lock")
        self.heartbeat_timeout = float(
            _flags.get_flag("ps_heartbeat_timeout"))
        self._tcp = _TCPServer((host, int(port)), _Handler)
        self._tcp.ps_server = self
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ---------------------------------------------------------
    def start(self):
        """Serve in a background thread (tests / same-process mode)."""
        self._thread = threading.Thread(target=self._tcp.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def run(self):
        """Blocking serve loop (fleet.run_server: listen_and_serv
        RunImpl). If start() already serves in a background thread,
        park on it instead (shutdown unblocks the join)."""
        if self._thread is not None:
            self._thread.join()
        else:
            self._tcp.serve_forever()

    def stop(self):
        self._tcp.shutdown()
        self._tcp.server_close()

    # -- dispatch ----------------------------------------------------------
    def dispatch(self, op: int, payload: bytes) -> Optional[bytes]:
        if op == OP_CREATE:
            off = 0
            name, off = _unpack_str(payload, off)
            value_dim, lr = struct.unpack_from("<qd", payload, off)
            off += 16
            optimizer, off = _unpack_str(payload, off)
            init = "random"
            if off < len(payload):
                init, off = _unpack_str(payload, off)
            if name not in self.tables:
                self.tables[name] = SparseTable(
                    name, int(value_dim), optimizer=optimizer, lr=lr,
                    initializer=(
                        (lambda rng, d: np.zeros(d, np.float32))
                        if init == "zeros" else None))
            return b""
        if op == OP_PULL:
            name, off = _unpack_str(payload, 0)
            ids, _ = _unpack_array(payload, off)
            rows = self._table(name).pull(ids)
            return _pack_array(rows)
        if op == OP_PUSH:
            name, off = _unpack_str(payload, 0)
            ids, off = _unpack_array(payload, off)
            grads, _ = _unpack_array(payload, off)
            self._table(name).push(ids, grads)
            return b""
        if op == OP_SIZE:
            name, _ = _unpack_str(payload, 0)
            return struct.pack("<q", self._table(name).size())
        if op == OP_STATE:
            name, _ = _unpack_str(payload, 0)
            return _pack_rows(self._table(name).state())
        if op == OP_LOAD:
            name, off = _unpack_str(payload, 0)
            self._table(name).load_state(_unpack_rows(payload, off))
            return b""
        if op == OP_BARRIER:
            # blocking rendezvous: the handler thread parks on a condition
            # variable until `expected` participants arrive (the gloo-
            # barrier analog, framework/fleet/gloo_wrapper.h:167)
            (expected,) = struct.unpack_from("<q", payload, 0)
            with self._barrier_cv:
                self._barrier_count += 1
                if self._barrier_count >= expected:
                    self._barrier_count = 0
                    self._barrier_gen += 1
                    self._barrier_cv.notify_all()
                    return struct.pack("<B", 1)
                gen = self._barrier_gen
                while gen == self._barrier_gen:
                    if not self._barrier_cv.wait(timeout=60):
                        # timed out — but the release may have raced the
                        # timeout (C++ twin's predicated wait_for sees
                        # the gen change; mirror it for wire parity)
                        if gen != self._barrier_gen:
                            break
                        # roll back this waiter's arrival so a later
                        # barrier round can't release early with fewer
                        # than `expected` real participants
                        if self._barrier_count > 0:
                            self._barrier_count -= 1
                        return struct.pack("<B", 0)
            return struct.pack("<B", 1)
        if op == OP_HEARTBEAT:
            import time as _t
            (wid,) = struct.unpack_from("<q", payload, 0)
            with self._hb_lock:
                self._heartbeats[int(wid)] = _t.monotonic()
            return b""
        if op == OP_WORKER_STATUS:
            import json as _json
            import time as _t
            timeout = self.heartbeat_timeout
            if payload:
                (req_timeout,) = struct.unpack_from("<d", payload, 0)
                if req_timeout > 0:
                    timeout = req_timeout
            now = _t.monotonic()
            with self._hb_lock:
                status = {str(w): {"age_sec": round(now - ts, 3),
                                   "alive": (now - ts) < timeout}
                          for w, ts in self._heartbeats.items()}
            return _json.dumps(status).encode()
        if op == OP_SHUTDOWN:
            return None
        raise ValueError(f"unknown PS op {op}")

    def _table(self, name: str) -> SparseTable:
        if name not in self.tables:
            # auto-vivify with dim from first pull is impossible server-
            # side; surface a clear error instead
            raise KeyError(f"table {name!r} not created on server "
                           f"{self.server_index} (call create first)")
        return self.tables[name]


# ops safe to replay on a dropped/ambiguous connection: reads, liveness,
# rendezvous, and create (server-side "if not exists"). PUSH and LOAD
# mutate table state — a replay could apply a gradient twice, so they
# keep fail-fast semantics and leave dedup to a higher tier.
_IDEMPOTENT_OPS = frozenset({OP_CREATE, OP_PULL, OP_SIZE, OP_STATE,
                             OP_BARRIER, OP_HEARTBEAT, OP_WORKER_STATUS})


class PSClient:
    """Scatter-gather client over all servers (grpc_client.cc analog).
    One persistent connection per server, guarded per-connection.
    Idempotent ops retry transparently through RetryPolicy
    (FLAGS_retry_*); connection loss mid-call drops and re-dials the
    socket, so a restarted server is picked up on the next attempt."""

    def __init__(self, endpoints: Sequence[str]):
        self.endpoints = list(endpoints)
        self._socks: List[Optional[socket.socket]] = \
            [None] * len(self.endpoints)
        self._locks = [make_lock(f"PSClient._locks[{i}]")
                       for i in range(len(self.endpoints))]
        self._closed = False

    def _sock(self, i: int) -> socket.socket:
        if self._socks[i] is None:
            host, port = self.endpoints[i].rsplit(":", 1)
            # workers routinely start before their servers finish
            # binding (grpc channels re-dial the same way)
            connect = RetryPolicy(
                max_attempts=1000, base_delay=0.2, max_delay=1.0,
                deadline=float(_flags.get_flag("ps_connect_timeout")),
                retry_on=(ConnectionRefusedError,),
                site="ps.rpc.connect")
            s = connect.call(socket.create_connection,
                             (host, int(port)), timeout=5)
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            # longer than the server's worst-case in-handler park (the
            # 60s barrier wait) so a slow barrier can't strand a reply
            # that the next request would then read as its own
            s.settimeout(float(_flags.get_flag("ps_socket_timeout")))
            self._socks[i] = s
        return self._socks[i]

    def _call(self, i: int, op: int, payload: bytes) -> bytes:
        if op in _IDEMPOTENT_OPS:
            policy = RetryPolicy.from_flags(
                site="ps.rpc.call",
                retry_on=(OSError, EOFError, ConnectionError))
            return policy.call(self._call_once, i, op, payload)
        return self._call_once(i, op, payload)

    def _call_once(self, i: int, op: int, payload: bytes) -> bytes:
        if self._closed:
            raise RuntimeError("PSClient is closed")
        with self._locks[i]:
            sock = self._sock(i)
            try:
                fault_point("ps.rpc.call")
                _send_msg(sock, op, payload)
                rop, resp = _recv_msg(sock)
            except (OSError, EOFError):
                # drop the connection: a timed-out request may still get
                # its reply later, which would desync the next call
                try:
                    sock.close()
                except OSError:
                    pass
                finally:
                    self._socks[i] = None
                raise
        if rop == OP_ERR:
            raise RuntimeError(
                f"PS server {self.endpoints[i]}: {resp.decode()}")
        return resp

    def close(self):
        """Idempotent; safe concurrently with in-flight calls (they
        surface a clean 'PSClient is closed' instead of using a socket
        whose fd may be recycled) and during interpreter shutdown."""
        self._closed = True
        for i, s in enumerate(self._socks):
            if s is not None:
                try:
                    s.close()
                except OSError:
                    pass
                finally:
                    self._socks[i] = None

    def __del__(self):
        # interpreter teardown: modules/attrs may be half-dead — never
        # let a stray OSError escape a finalizer
        try:
            if getattr(self, "_socks", None) is not None:
                self.close()
        except Exception:
            pass

    # -- table ops ---------------------------------------------------------
    def create_table(self, name: str, value_dim: int,
                     optimizer: str = "sgd", lr: float = 0.01,
                     init: str = "random"):
        payload = (_pack_str(name) + struct.pack("<qd", value_dim, lr)
                   + _pack_str(optimizer) + _pack_str(init))
        for i in range(len(self.endpoints)):
            self._call(i, OP_CREATE, payload)

    def _route(self, ids: np.ndarray):
        flat = np.asarray(ids, np.int64).reshape(-1)
        srv = flat % len(self.endpoints)
        return flat, srv

    def pull(self, name: str, ids,
             value_dim: Optional[int] = None) -> np.ndarray:
        ids = np.asarray(ids, np.int64)
        flat, srv = self._route(ids)
        if flat.size == 0:
            if value_dim is None:
                raise ValueError(
                    "PSClient.pull with zero ids needs value_dim to "
                    "shape the empty result")
            return np.zeros(tuple(ids.shape) + (value_dim,), np.float32)
        out: Optional[np.ndarray] = None
        for i in range(len(self.endpoints)):
            mask = srv == i
            if not mask.any():
                continue
            rows, _ = _unpack_array(
                self._call(i, OP_PULL,
                           _pack_str(name) + _pack_array(flat[mask])), 0)
            if out is None:
                out = np.empty((flat.size, rows.shape[-1]), np.float32)
            out[mask] = rows
        return out.reshape(tuple(ids.shape) + (out.shape[-1],))

    def push(self, name: str, ids, grads):
        ids = np.asarray(ids, np.int64)
        flat, srv = self._route(ids)
        g = np.asarray(grads, np.float32).reshape(flat.size, -1)
        for i in range(len(self.endpoints)):
            mask = srv == i
            if not mask.any():
                continue
            self._call(i, OP_PUSH, _pack_str(name)
                       + _pack_array(flat[mask]) + _pack_array(g[mask]))

    def size(self, name: str) -> int:
        total = 0
        for i in range(len(self.endpoints)):
            (n,) = struct.unpack("<q",
                                 self._call(i, OP_SIZE, _pack_str(name)))
            total += n
        return total

    def state(self, name: str) -> Dict[str, np.ndarray]:
        """Full table snapshot gathered from every server (checkpoint
        tier for remote tables; large_scale_kv Save analog).
        Accumulator entries ride under ``a:<key>`` names."""
        rows: Dict[str, np.ndarray] = {}
        for i in range(len(self.endpoints)):
            rows.update(_unpack_rows(
                self._call(i, OP_STATE, _pack_str(name))))
        return rows

    def load(self, name: str, rows: Dict[str, np.ndarray]):
        """Scatter a snapshot back, each row to its residue-class
        server (large_scale_kv Load analog)."""
        per_server: List[Dict[str, np.ndarray]] = [
            {} for _ in self.endpoints]
        for k, v in rows.items():
            key = int(k[2:]) if k.startswith("a:") else int(k)
            per_server[key % len(self.endpoints)][k] = v
        for i, shard in enumerate(per_server):
            self._call(i, OP_LOAD, _pack_str(name) + _pack_rows(shard))
        return self

    def heartbeat(self, worker_id: int):
        """Announce liveness to every server (HeartBeatMonitor feed)."""
        for i in range(len(self.endpoints)):
            self._call(i, OP_HEARTBEAT, struct.pack("<q", worker_id))

    def worker_status(self, server: int = 0,
                      timeout: float = 0.0) -> dict:
        """Server's liveness view: {worker_id: {age_sec, alive}}.
        ``timeout`` > 0 overrides the server's default liveness window
        for this query (monitors can probe with their own SLA)."""
        import json as _json
        payload = struct.pack("<d", timeout) if timeout > 0 else b""
        return _json.loads(self._call(server, OP_WORKER_STATUS, payload))

    def barrier(self, expected: int, server: int = 0) -> bool:
        (done,) = struct.unpack(
            "<B", self._call(server, OP_BARRIER,
                             struct.pack("<q", expected)))
        return bool(done)

    def shutdown_servers(self):
        for i in range(len(self.endpoints)):
            try:
                self._call(i, OP_SHUTDOWN, b"")
            except (ConnectionError, RuntimeError, OSError):
                pass
        self.close()


class RemoteSparseTable:
    """SparseTable-compatible facade routing over a PSClient, so the
    executor's distributed_lookup_table lowering and the Communicator
    work unchanged in multi-node mode (parameter_prefetch.cc analog)."""

    def __init__(self, name: str, value_dim: int, client: PSClient,
                 optimizer: str = "sgd", lr: float = 0.01,
                 init: str = "random", **_):
        self.name = name
        self.value_dim = value_dim
        self._client = client
        client.create_table(name, value_dim, optimizer=optimizer, lr=lr,
                            init=init)

    def pull(self, ids):
        return self._client.pull(self.name, ids,
                                 value_dim=self.value_dim)

    def push(self, ids, grads):
        self._client.push(self.name, ids, grads)

    def size(self) -> int:
        return self._client.size(self.name)
