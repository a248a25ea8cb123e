"""Native (C++) PS server wrapper — the port's copy of
``paddle_tpu/distributed/ps/native_server.py``: a drop-in PSServer
replacement over the port's copy of ``native/ps_server.cpp``.

The C++ server (native/ps_server.cpp) speaks the exact wire protocol of
rpc.py, so PSClient / RemoteSparseTable / the Communicator work
unchanged; the data plane (pull/push/optimizer updates, barriers,
heartbeats) runs entirely outside the GIL. Falls back cleanly: callers
use ``make_server(...)`` which returns the Python PSServer when the
toolchain is unavailable.
"""

from __future__ import annotations

import ctypes
import time
from typing import Optional

from ...analysis.concurrency import make_lock


class NativePSServer:
    """Lifecycle-compatible with rpc.PSServer (start/run/stop)."""

    def __init__(self, endpoint: str, server_index: int = 0,
                 num_servers: int = 1):
        from ...native import build_and_load
        lib = build_and_load("ps_server")
        if lib is None:
            raise RuntimeError("native ps_server could not be built "
                               "(no g++ toolchain?)")
        lib.ps_start.restype = ctypes.c_void_p
        lib.ps_start.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                 ctypes.c_int, ctypes.c_int]
        lib.ps_port.argtypes = [ctypes.c_void_p]
        lib.ps_running.argtypes = [ctypes.c_void_p]
        lib.ps_stop.argtypes = [ctypes.c_void_p]
        lib.ps_last_error.restype = ctypes.c_char_p
        self._lib = lib
        self.endpoint = endpoint
        self.server_index = int(server_index)
        self.num_servers = int(num_servers)
        host, port = endpoint.rsplit(":", 1)
        self._handle = lib.ps_start(host.encode(), int(port),
                                    self.server_index, self.num_servers)
        if not self._handle:
            raise OSError(lib.ps_last_error().decode())
        self.port = lib.ps_port(self._handle)
        # serializes native calls against stop()'s free of the handle
        self._lock = make_lock("NativePSServer._lock")

    def start(self):
        return self  # C++ accept loop is already running

    def run(self):
        """Blocking serve loop (listen_and_serv RunImpl analog): park
        until a client shutdown (or stop()) ends the native server."""
        while True:
            with self._lock:
                if not self._handle or not self._lib.ps_running(
                        self._handle):
                    return
            time.sleep(0.1)

    def stop(self):
        with self._lock:
            if self._handle:
                self._lib.ps_stop(self._handle)
                self._handle = None

    def __del__(self):
        try:
            self.stop()
        except Exception:
            pass


def make_server(endpoint: str, server_index: int = 0,
                num_servers: int = 1,
                prefer_native: Optional[bool] = None):
    """Native server when the toolchain allows, Python otherwise.
    ``prefer_native`` defaults to FLAGS_ps_prefer_native; the
    ``ps.server.start`` fault site forces the fallback path
    deterministically (an injected error stands in for a missing
    toolchain), so tests cover it on machines WITH g++."""
    from ... import flags as _flags
    from ...resilience.injector import fault_point
    if prefer_native is None:
        prefer_native = bool(_flags.get_flag("ps_prefer_native"))
    if prefer_native:
        try:
            fault_point("ps.server.start")
            return NativePSServer(endpoint, server_index, num_servers)
        except (RuntimeError, OSError):
            pass
    from .rpc import PSServer
    return PSServer(endpoint, server_index, num_servers).start()
