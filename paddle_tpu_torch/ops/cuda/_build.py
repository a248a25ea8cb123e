"""Build-and-load of the port's hand-written CUDA kernels — the
counterpart of ``paddle_tpu/ops/pallas/utils.py`` (where the JAX
package decides how its kernels compile and run).

Each kernel is one source ``paddle_tpu_torch/csrc/<name>.cu`` with a
plain C interface. It is compiled at its first launch with ``nvcc`` for
``sm_90a`` into a shared library under ``paddle_tpu_torch/_build/``,
named by a hash of the source, the shared headers (``csrc/*.cuh``) and
the flags, and loaded with
``ctypes``. Nothing is compiled when a module is imported, and a failed
build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: per kernel: {"path", "seconds" (0.0 when the library was cached),
#: "log" (nvcc's output, ptxas register/shared-memory lines included)}
builds: Dict[str, dict] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found on PATH or under CUDA_HOME; the CUDA kernels "
            "are built from source at first use")
    return path


def build_all(names) -> Dict[str, Path]:
    """Compile ``csrc/<name>.cu`` for each name unless a library for the
    same source and flags exists; the ``nvcc`` runs are started together
    and waited for together. Returns each library's path."""
    pending = {}
    paths = {}
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    for name in names:
        src = CSRC / f"{name}.cu"
        digest = hashlib.sha256(src.read_bytes() + headers +
                                " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        lib = BUILD_DIR / f"{name}-{digest}.so"
        log = BUILD_DIR / f"{name}-{digest}.log"
        paths[name] = lib
        if lib.exists():
            builds[name] = {"path": str(lib), "seconds": 0.0,
                            "log": log.read_text() if log.exists() else ""}
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        pending[name] = (proc, cmd, tmp, lib, log, time.perf_counter())
    failed = []
    for name, (proc, cmd, tmp, lib, log, t0) in pending.items():
        out, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed building {name}.cu (rc "
                          f"{proc.returncode}):\n{' '.join(cmd)}\n{out}")
            continue
        log.write_text(out)
        os.replace(tmp, lib)
        builds[name] = {"path": str(lib), "seconds": seconds, "log": out}
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths


def load_all(names) -> Dict[str, ctypes.CDLL]:
    """The loaded libraries of the kernels ``names``; those not built yet
    are compiled concurrently."""
    with _lock:
        missing = [n for n in names if n not in _libs]
        if missing:     # every launch comes here: read no file when loaded
            for name, path in build_all(missing).items():
                _libs[name] = ctypes.CDLL(str(path))
        return {n: _libs[n] for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built on first use."""
    return load_all([name])[name]
