"""KV HTTP rendezvous server + client; the port's copy of
``paddle_tpu/distributed/fleet/utils/http_server.py`` (host code only).

Analog of the reference's fleet/utils/http_server.py (KVServer/KVHandler)
and the gloo HTTP rendezvous path (framework/fleet/gloo_wrapper.h:45):
a scoped key-value store over plain HTTP that heterogeneous roles
(pserver + collective trainers, or processes outside one launcher's
rendezvous) use to exchange endpoints and barrier on job membership.

Protocol (reference-compatible shape):
  PUT    /<scope>/<key>   body = value        store
  GET    /<scope>/<key>                       200 value | 404
  GET    /<scope>                             200 "k1\nk2..." (keys)
  DELETE /<scope>/<key>                       delete (tracked per scope)
"""

from __future__ import annotations

import http.client
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional

from ....analysis.concurrency import make_lock


class _KVHandler(BaseHTTPRequestHandler):
    server_version = "PaddleTPUKV/1.0"

    def log_message(self, *a):  # quiet
        pass

    def _split(self):
        parts = [p for p in self.path.split("/") if p]
        scope = parts[0] if parts else ""
        key = parts[1] if len(parts) > 1 else None
        return scope, key

    def do_PUT(self):
        scope, key = self._split()
        if key is None:
            self.send_error(400)
            return
        length = int(self.headers.get("Content-Length", 0))
        value = self.rfile.read(length)
        with self.server.kv_lock:
            self.server.kv.setdefault(scope, {})[key] = value
        self.send_response(200)
        self.end_headers()

    do_POST = do_PUT

    def do_GET(self):
        scope, key = self._split()
        # snapshot under the lock, write AFTER releasing it — a stalled
        # client socket must not block every other KV operation
        with self.server.kv_lock:
            if key is None:
                keys = sorted(self.server.kv.get(scope, {}))
            else:
                value = self.server.kv.get(scope, {}).get(key)
        if key is None:
            body = "\n".join(keys).encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return
        if value is None:
            self.send_error(404)
            return
        self.send_response(200)
        self.send_header("Content-Length", str(len(value)))
        self.end_headers()
        self.wfile.write(value)

    def do_DELETE(self):
        scope, key = self._split()
        with self.server.kv_lock:
            s = self.server.kv.get(scope, {})
            if key in s:
                del s[key]
                self.server.deleted.setdefault(scope, set()).add(key)
        self.send_response(200)
        self.end_headers()


class KVServer:
    """fleet/utils/http_server.py KVServer parity.

    Security note: like the reference's fleet KVServer, this speaks
    unauthenticated HTTP and by default binds 0.0.0.0 — the trust
    assumption is a cluster-private network. Pass ``bind_address`` to
    restrict (e.g. "127.0.0.1" for single-host rendezvous).

    >>> srv = KVServer(0)          # port 0 = ephemeral
    >>> srv.start()
    >>> ... clients rendezvous ...
    >>> srv.stop()
    """

    def __init__(self, port: int, size: Optional[Dict[str, int]] = None,
                 bind_address: str = "0.0.0.0"):
        self._httpd = ThreadingHTTPServer((bind_address, port), _KVHandler)
        self._httpd.kv = {}
        self._httpd.kv_lock = make_lock("KVServer.kv_lock")
        self._httpd.deleted = {}
        # scope -> expected membership size (should_stop watches deletes,
        # like the reference's wait-for-all-trainers-done teardown)
        self._size = dict(size or {})
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def start(self):
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True)
        self._thread.start()

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def get_deleted_size(self, scope: str) -> int:
        with self._httpd.kv_lock:
            return len(self._httpd.deleted.get(scope, ()))

    def should_stop(self) -> bool:
        return all(self.get_deleted_size(s) >= n
                   for s, n in self._size.items())


class KVClient:
    """HTTP client half (the reference inlines this into gloo_wrapper)."""

    def __init__(self, endpoint: str):
        # "host:port"
        self.endpoint = endpoint

    def _conn(self):
        return http.client.HTTPConnection(self.endpoint, timeout=10)

    def kv_put(self, scope: str, key: str, value) -> bool:
        if isinstance(value, str):
            value = value.encode()
        c = self._conn()
        try:
            c.request("PUT", f"/{scope}/{key}", body=value)
            return c.getresponse().status == 200
        finally:
            c.close()

    def kv_get(self, scope: str, key: str) -> Optional[bytes]:
        c = self._conn()
        try:
            c.request("GET", f"/{scope}/{key}")
            r = c.getresponse()
            return r.read() if r.status == 200 else None
        finally:
            c.close()

    def kv_keys(self, scope: str):
        c = self._conn()
        try:
            c.request("GET", f"/{scope}")
            r = c.getresponse()
            body = r.read().decode() if r.status == 200 else ""
            return [k for k in body.split("\n") if k]
        finally:
            c.close()

    def kv_delete(self, scope: str, key: str) -> bool:
        c = self._conn()
        try:
            c.request("DELETE", f"/{scope}/{key}")
            return c.getresponse().status == 200
        finally:
            c.close()

    def rendezvous(self, scope: str, rank: int, value: str, world: int,
                   timeout: float = 60.0, poll: float = 0.05):
        """Publish this role's value, wait for all `world` members, and
        return {rank: value} — the cross-role bootstrap a collective
        launcher's rendezvous cannot provide for PS+collective hybrid
        jobs."""
        self.kv_put(scope, str(rank), value)
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            keys = self.kv_keys(scope)
            if len(keys) >= world:
                vals = {k: self.kv_get(scope, k) for k in keys}
                if all(v is not None for v in vals.values()):
                    return {int(k): v.decode() for k, v in vals.items()}
                # a key vanished between list and get (teardown race) —
                # fall through and re-poll rather than crash
            time.sleep(poll)
        raise TimeoutError(
            f"rendezvous {scope!r}: {len(self.kv_keys(scope))}/{world} "
            f"members after {timeout}s")
