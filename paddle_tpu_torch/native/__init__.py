"""Native (C++) host components of the port — the counterpart of
``paddle_tpu/native/__init__.py``: the slot-file parser
(``slot_datafeed.cpp``) and the parameter server (``ps_server.cpp``),
verbatim copies of the reference's sources (host code, no device code).

Binding is ctypes over a C ABI. Each component compiles with ``g++ -O3
-std=c++17 -shared -fPIC -pthread`` at its first use into
``paddle_tpu_torch/_build/`` (ignored by git), named by a hash of the
source and of the extra flags, so a source edit always rebuilds. Nothing
is compiled when a module is imported. As in the reference, a machine
without the toolchain gets ``None`` and the callers fall back to their
Python versions (``dataset._SlotFileParser._parse_py``,
``distributed.ps.rpc.PSServer``); the callers report which one ran
(``is_native``, the server's class).
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional

from ..analysis.concurrency import make_lock

_HERE = Path(__file__).resolve().parent
BUILD_DIR = _HERE.parent / "_build"

_lock = make_lock("native._lock")
_libs = {}


def build_and_load(name: str, extra_flags=()) -> Optional[ctypes.CDLL]:
    """Compile ``native/<name>.cpp`` -> ``_build/_<name>-<srchash>-<flaghash>.so``
    (if absent) and dlopen it. Returns None when no g++ toolchain is
    available. ``extra_flags`` extends the compile line and takes part in
    the cache key."""
    memo_key = (name, tuple(extra_flags))
    with _lock:
        if memo_key in _libs:
            return _libs[memo_key]
        src = _HERE / f"{name}.cpp"
        try:
            src_digest = hashlib.sha256(src.read_bytes()).hexdigest()[:12]
            flag_digest = hashlib.sha256(
                "\0".join(extra_flags).encode()).hexdigest()[:6]
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            so = BUILD_DIR / f"_{name}-{src_digest}-{flag_digest}.so"
            if not so.exists():
                # compile to a temporary name and rename: a killed g++
                # leaves no truncated library under the final name
                tmp = f"{so}.tmp{os.getpid()}"
                subprocess.run(
                    ["g++", "-O3", "-std=c++17", "-shared", "-fPIC",
                     "-pthread", str(src), "-o", tmp, *extra_flags],
                    check=True, capture_output=True, timeout=120)
                os.replace(tmp, so)
                # drop stale builds of the same component and flag set
                for old in glob.glob(str(BUILD_DIR /
                                         f"_{name}-*-{flag_digest}.so")):
                    if old != str(so):
                        try:
                            os.unlink(old)
                        except OSError:
                            pass
            lib = ctypes.CDLL(str(so))
        except (OSError, subprocess.SubprocessError):
            lib = None
        _libs[memo_key] = lib
        return lib
