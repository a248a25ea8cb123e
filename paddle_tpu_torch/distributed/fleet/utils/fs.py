"""Filesystem shell — LocalFS + gated HDFS client; the port's copy of
``paddle_tpu/distributed/fleet/utils/fs.py`` (host code only).

Analog of python/paddle/distributed/fleet/utils/fs.py (LocalFS,
HDFSClient over the hadoop CLI). Checkpoint tiers and PS snapshot code
call through this interface so swapping local disk for HDFS/GCS is a
config change, mirroring the reference's fs abstraction. HDFSClient
shells out to ``hadoop fs``; constructing it without a hadoop binary
raises immediately (no silent stub).
"""

from __future__ import annotations

import os
import shutil
import subprocess
from typing import List, Optional, Tuple

from ....resilience.injector import fault_point
from ....resilience.retry import RetryPolicy


class ExecuteError(Exception):
    pass


def _write_guard(fn, *args, retry_on=(OSError, ConnectionError)):
    """Run one mutating fs operation through the shared resilience
    plane: the ``fs.write`` fault site fires first (chaos specs), then
    RetryPolicy absorbs transient failures (flaky NFS/GCS-fuse — the
    checkpoint tiers all write through here). Non-transient OSErrors
    (FileNotFoundError etc.) pass straight through."""
    def attempt():
        fault_point("fs.write")
        return fn(*args)
    return RetryPolicy.from_flags(site="fs.write",
                                  retry_on=retry_on).call(attempt)


class FSFileExistsError(Exception):
    pass


class FSFileNotExistsError(Exception):
    pass


class FS:
    """Interface (fs.py FS abstract base)."""

    def ls_dir(self, path) -> Tuple[List[str], List[str]]:
        raise NotImplementedError

    def is_file(self, path) -> bool:
        raise NotImplementedError

    def is_dir(self, path) -> bool:
        raise NotImplementedError

    def is_exist(self, path) -> bool:
        raise NotImplementedError

    def mkdirs(self, path):
        raise NotImplementedError

    def delete(self, path):
        raise NotImplementedError

    def rename(self, src, dst):
        raise NotImplementedError


class LocalFS(FS):
    """Local-disk implementation (fs.py LocalFS)."""

    def ls_dir(self, path) -> Tuple[List[str], List[str]]:
        """-> (dirs, files), names only (reference contract)."""
        if not self.is_exist(path):
            return [], []
        dirs, files = [], []
        for name in sorted(os.listdir(path)):
            (dirs if os.path.isdir(os.path.join(path, name))
             else files).append(name)
        return dirs, files

    def is_file(self, path) -> bool:
        return os.path.isfile(path)

    def is_dir(self, path) -> bool:
        return os.path.isdir(path)

    def is_exist(self, path) -> bool:
        return os.path.exists(path)

    def mkdirs(self, path):
        _write_guard(lambda: os.makedirs(path, exist_ok=True))

    def delete(self, path):
        def _do():
            if self.is_dir(path):
                shutil.rmtree(path)
            elif self.is_file(path):
                os.remove(path)
        _write_guard(_do)

    def rename(self, src, dst):
        _write_guard(os.rename, src, dst)

    def mv(self, src, dst, overwrite: bool = False):
        if not self.is_exist(src):
            raise FSFileNotExistsError(src)
        if self.is_exist(dst):
            if not overwrite:
                raise FSFileExistsError(dst)
            self.delete(dst)
        _write_guard(shutil.move, src, dst)

    def touch(self, path, exist_ok: bool = True):
        if self.is_exist(path):
            if not exist_ok:
                raise FSFileExistsError(path)
            return
        def _do():
            with open(path, "a"):
                pass
        _write_guard(_do)

    def upload(self, local_path, fs_path):
        _write_guard(shutil.copy, local_path, fs_path)

    def download(self, fs_path, local_path):
        _write_guard(shutil.copy, fs_path, local_path)


class HDFSClient(FS):
    """``hadoop fs`` CLI wrapper (fs.py HDFSClient). Needs a hadoop
    binary; every call shells out like the reference."""

    def __init__(self, hadoop_home: Optional[str] = None, configs=None):
        self._hadoop = (os.path.join(hadoop_home, "bin", "hadoop")
                        if hadoop_home else shutil.which("hadoop"))
        if not self._hadoop or not os.path.exists(self._hadoop):
            raise ExecuteError(
                "HDFSClient requires a hadoop binary (hadoop_home or "
                "PATH); none found on this machine")
        self._config_args = []
        for k, v in (configs or {}).items():
            self._config_args += ["-D", f"{k}={v}"]

    def _run(self, *cmd) -> str:
        full = [self._hadoop, "fs", *self._config_args, *cmd]
        proc = subprocess.run(full, capture_output=True, text=True)
        if proc.returncode != 0:
            raise ExecuteError(
                f"{' '.join(full)} failed: {proc.stderr[-500:]}")
        return proc.stdout

    def ls_dir(self, path):
        out = self._run("-ls", str(path))
        dirs, files = [], []
        for line in out.splitlines():
            parts = line.split()
            if len(parts) < 8:
                continue
            name = parts[-1].rsplit("/", 1)[-1]
            (dirs if parts[0].startswith("d") else files).append(name)
        return dirs, files

    def is_exist(self, path) -> bool:
        try:
            self._run("-test", "-e", str(path))
            return True
        except ExecuteError:
            return False

    def is_file(self, path) -> bool:
        try:
            self._run("-test", "-f", str(path))
            return True
        except ExecuteError:
            return False

    def is_dir(self, path) -> bool:
        try:
            self._run("-test", "-d", str(path))
            return True
        except ExecuteError:
            return False

    def _run_write(self, *cmd) -> str:
        """Mutating commands go through the fs.write site + retry (a
        flaky namenode answer shouldn't abort a checkpoint); probes
        like ``-test`` stay un-retried — their failures ARE answers."""
        return _write_guard(self._run, *cmd,
                            retry_on=(ExecuteError, OSError))

    def mkdirs(self, path):
        self._run_write("-mkdir", "-p", str(path))

    def delete(self, path):
        self._run_write("-rm", "-r", "-f", str(path))

    def rename(self, src, dst):
        self._run_write("-mv", str(src), str(dst))

    def upload(self, local_path, fs_path):
        self._run_write("-put", "-f", str(local_path), str(fs_path))

    def download(self, fs_path, local_path):
        self._run_write("-get", str(fs_path), str(local_path))


__all__ = ["ExecuteError", "FS", "FSFileExistsError",
           "FSFileNotExistsError", "HDFSClient", "LocalFS"]
