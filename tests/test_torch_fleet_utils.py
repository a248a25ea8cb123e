"""The fleet's utilities in the port (``distributed/fleet/utils``): the
filesystem shell (``LocalFS``, ``HDFSClient``, the ``fs.write`` fault
site and its retries) and the KV HTTP server (``KVServer``,
``KVClient``), each against the JAX package's on the CPU: the same calls
on the same trees give the same answers, and a client of either package
talks to a server of either. Every server a test starts is stopped."""

import torch_threads  # noqa: F401  (one worker's share of the cores)
import threading

import pytest

from paddle_tpu.distributed.fleet.utils import fs as jfs
from paddle_tpu.distributed.fleet.utils import http_server as jhttp
from paddle_tpu.resilience.injector import fault_scope as jfault_scope

from paddle_tpu_torch.distributed import fleet as tfleet
from paddle_tpu_torch.distributed.fleet.utils import fs as tfs
from paddle_tpu_torch.distributed.fleet.utils import http_server as thttp
from paddle_tpu_torch.resilience.injector import fault_scope


def _tree(fsmod, root):
    fs = fsmod.LocalFS()
    out = []
    fs.mkdirs(str(root / "a" / "b"))
    fs.touch(str(root / "a" / "f1"))
    out.append(fs.ls_dir(str(root / "a")))
    out.append(fs.ls_dir(str(root / "missing")))
    out.append((fs.is_dir(str(root / "a")), fs.is_file(str(root / "a/f1")),
                fs.is_exist(str(root / "nope"))))
    fs.rename(str(root / "a" / "f1"), str(root / "a" / "f2"))
    (root / "src").write_text("x")
    fs.upload(str(root / "src"), str(root / "a" / "up"))
    fs.download(str(root / "a" / "up"), str(root / "down"))
    fs.mv(str(root / "down"), str(root / "a" / "moved"))
    out.append(fs.ls_dir(str(root / "a")))
    for err, call in (
            (fsmod.FSFileExistsError,
             lambda: fs.mv(str(root / "src"), str(root / "a" / "up"))),
            (fsmod.FSFileNotExistsError,
             lambda: fs.mv(str(root / "ghost"), str(root / "x"))),
            (fsmod.FSFileExistsError,
             lambda: fs.touch(str(root / "src"), exist_ok=False))):
        with pytest.raises(err):
            call()
    fs.mv(str(root / "src"), str(root / "a" / "up"), overwrite=True)
    fs.delete(str(root / "a" / "b"))
    fs.delete(str(root / "a" / "f2"))
    out.append(fs.ls_dir(str(root / "a")))
    return out


def test_local_fs_matches_the_reference(tmp_path):
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    assert _tree(tfs, tmp_path / "t") == _tree(jfs, tmp_path / "j")


def test_fs_write_site_retries_a_transient_fault_like_the_reference(
        tmp_path):
    for mod, scope, d in ((jfs, jfault_scope, "j"), (tfs, fault_scope, "t")):
        with scope("fs.write:error@0"):
            mod.LocalFS().mkdirs(str(tmp_path / d / "x"))
        assert (tmp_path / d / "x").is_dir()
        with scope("fs.write:error"):
            with pytest.raises(Exception):
                mod.LocalFS().mkdirs(str(tmp_path / d / "y"))
        assert not (tmp_path / d / "y").exists()


def test_hdfs_client_needs_hadoop_as_in_the_reference(tmp_path):
    for mod in (jfs, tfs):
        with pytest.raises(mod.ExecuteError, match="hadoop"):
            mod.HDFSClient(hadoop_home=str(tmp_path))
    # a stand-in hadoop CLI: each call is logged, `-test` answers by
    # its exit status, `-ls` prints a listing
    home = tmp_path / "hadoop"
    (home / "bin").mkdir(parents=True)
    log = tmp_path / "calls"
    script = home / "bin" / "hadoop"
    script.write_text(
        "#!/bin/sh\n"
        f"echo \"$@\" >> {log}\n"
        "case \"$*\" in\n"
        "  *-test\\ -e*) exit 0;;\n"
        "  *-test*) exit 1;;\n"
        "  *-ls*) echo 'drwxr-xr-x - u g 0 2020-01-01 00:00 /p/dir1';"
        " echo '-rw-r--r-- 3 u g 9 2020-01-01 00:00 /p/f1';;\n"
        "esac\n")
    script.chmod(0o755)
    calls = []
    for mod in (jfs, tfs):
        log.write_text("")
        c = mod.HDFSClient(hadoop_home=str(home), configs={"k": "v"})
        answers = (c.ls_dir("/p"), c.is_exist("/p"), c.is_file("/p"),
                   c.is_dir("/p"))
        c.mkdirs("/p/new")
        c.delete("/p/old")
        c.rename("/p/a", "/p/b")
        c.upload("/l", "/p/u")
        c.download("/p/u", "/l2")
        calls.append((answers, log.read_text()))
    assert calls[0] == calls[1]
    assert calls[1][0] == ((["dir1"], ["f1"]), True, False, False)
    assert "fs -D k=v -mkdir -p /p/new" in calls[1][1]


@pytest.mark.parametrize("server_pkg,client_pkg", [
    ("port", "port"), ("port", "jax"), ("jax", "port")])
def test_kv_server_and_client_across_packages(server_pkg, client_pkg):
    smod = thttp if server_pkg == "port" else jhttp
    cmod = thttp if client_pkg == "port" else jhttp
    srv = smod.KVServer(0, size={"job": 2}, bind_address="127.0.0.1")
    srv.start()
    try:
        c = cmod.KVClient(f"127.0.0.1:{srv.port}")
        assert c.kv_put("job", "a", "1") and c.kv_put("job", "b", b"2")
        assert c.kv_get("job", "a") == b"1"
        assert c.kv_get("job", "zz") is None
        assert c.kv_keys("job") == ["a", "b"]
        assert not srv.should_stop()
        assert c.kv_delete("job", "a") and c.kv_delete("job", "b")
        assert srv.get_deleted_size("job") == 2 and srv.should_stop()
        assert c.kv_keys("job") == []
        got = {}
        ts = [threading.Thread(target=lambda r=r: got.update(
            {r: cmod.KVClient(f"127.0.0.1:{srv.port}").rendezvous(
                "rdv", r, f"ep{r}", 3, timeout=20)})) for r in range(3)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=30)
        assert got == {r: {0: "ep0", 1: "ep1", 2: "ep2"} for r in range(3)}
        with pytest.raises(TimeoutError, match="1/2"):
            c.rendezvous("lonely", 0, "x", 2, timeout=0.2)
    finally:
        srv.stop()


def test_fleet_utils_namespace_and_what_still_waits():
    util = tfleet.util
    assert util.LocalFS is tfs.LocalFS and util.KVServer is thttp.KVServer
    assert util.fs is tfs and util.http_server is thttp
    with pytest.raises(NotImplementedError, match="A7.5"):
        util.recompute(lambda x: x, 1)
    with pytest.raises(NotImplementedError, match="A8"):
        tfleet.elastic
