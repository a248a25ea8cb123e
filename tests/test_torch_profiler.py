"""The port's profiler (``paddle_tpu_torch/profiler.py``) against the JAX
package's (``paddle_tpu/profiler.py``), on the profiler cases of
``tests/test_profiler_monitor.py``: the same host events, chrome-trace
schema and summary (names, calls, sort orders) from the same scoped
events; with ``trace_dir`` the ``torch.profiler`` trace (CPU here) holds
each ``RecordEvent`` range and the executor's op ranges inside it.
"""

import torch_threads  # noqa: F401  (one worker's share of the cores)
import json
import os
import time

import numpy as np
import pytest

from paddle_tpu import profiler as jprof

from paddle_tpu_torch import profiler
from paddle_tpu_torch.framework import Executor, Program


def _events(prof, path):
    prof.start_profiler()
    with prof.RecordEvent("matmul_phase"):
        np.dot(np.ones((64, 64)), np.ones((64, 64)))
    with prof.RecordEvent("matmul_phase"):
        np.dot(np.ones((64, 64)), np.ones((64, 64)))
    with prof.RecordEvent("io_phase"):
        pass
    return prof.stop_profiler(sorted_key="calls", profile_path=path)


def test_record_event_and_chrome_trace_like_the_reference(tmp_path):
    tsum = _events(profiler, str(tmp_path / "t.json"))
    jsum = _events(jprof, str(tmp_path / "j.json"))
    assert [(s["name"], s["calls"]) for s in tsum] == \
        [(s["name"], s["calls"]) for s in jsum] == \
        [("matmul_phase", 2), ("io_phase", 1)]
    assert set(tsum[0]) == set(jsum[0])
    trace = json.load(open(tmp_path / "t.json"))
    jtrace = json.load(open(tmp_path / "j.json"))
    assert [e["name"] for e in trace["traceEvents"]] == \
        [e["name"] for e in jtrace["traceEvents"]]
    for e in trace["traceEvents"]:
        assert set(e) == {"name", "ph", "ts", "dur", "pid", "tid", "cat"}
        assert e["ph"] == "X" and e["cat"] == "host" and e["pid"] == 0


def test_chrome_trace_durations_are_microseconds(tmp_path):
    path = str(tmp_path / "schema.json")
    profiler.start_profiler()
    with profiler.RecordEvent("one"):
        time.sleep(0.001)
    profiler.stop_profiler(profile_path=path)
    (e,) = json.load(open(path))["traceEvents"]
    assert e["dur"] >= 1000


def test_context_decorator_and_metadata(tmp_path):
    calls = []

    @profiler.RecordEvent("decorated")
    def work(a, b=1):
        """the docstring survives"""
        calls.append(1)
        return a + b

    with profiler.profiler(profile_path=str(tmp_path / "t.json")):
        assert work(2, b=3) == 5
    assert calls == [1]
    assert work.__name__ == "work" and work.__doc__ == \
        "the docstring survives"
    trace = json.load(open(tmp_path / "t.json"))
    assert [e["name"] for e in trace["traceEvents"]] == ["decorated"]


def test_events_off_when_disabled(tmp_path):
    with profiler.RecordEvent("off_event"):
        pass
    profiler.start_profiler()
    summary = profiler.stop_profiler(profile_path=str(tmp_path / "o.json"))
    assert all(s["name"] != "off_event" for s in summary)
    assert json.load(open(tmp_path / "o.json"))["traceEvents"] == []


def test_summarize_sort_keys_match_the_reference():
    events = [{"name": "big", "dur": 9000.0},
              {"name": "hot", "dur": 1000.0},
              {"name": "hot", "dur": 1000.0},
              {"name": "hot", "dur": 1000.0}]
    for key in ("total", "calls", "ave", None):
        assert profiler.summarize(events, key) == jprof.summarize(events, key)
    assert [s["name"] for s in profiler.summarize(events, "calls")] == \
        ["hot", "big"]


def test_device_trace_holds_the_record_event_and_op_ranges(tmp_path,
                                                           capsys):
    prog = Program()
    blk = prog.global_block()
    blk.create_var("x", is_data=True)
    blk.create_var("y")
    blk.append_op("tanh", {"X": "x"}, {"Out": "y"})
    exe = Executor("cpu")
    trace_dir = str(tmp_path / "trace")
    with profiler.profiler("All", profile_path=str(tmp_path / "h.json"),
                           trace_dir=trace_dir):
        for _ in range(2):
            with profiler.RecordEvent("predict"):
                exe.run(prog, feed={"x": np.ones((4, 4), np.float32)},
                        fetch_list=["y"])
    out = capsys.readouterr().out
    assert "predict" in out and "Calls" in out
    path = os.path.join(trace_dir, profiler.DEVICE_TRACE_FILE)
    names = [e.get("name") for e in json.load(open(path))["traceEvents"]]
    assert names.count("predict") == 2
    assert "tanh" in names


def test_a_failure_inside_the_profiler_is_not_swallowed(tmp_path):
    with pytest.raises(ZeroDivisionError):
        with profiler.profiler(profile_path=str(tmp_path / "f.json"),
                               trace_dir=str(tmp_path / "ft")):
            with profiler.RecordEvent("failing"):
                1 / 0
    names = [e["name"] for e in
             json.load(open(tmp_path / "f.json"))["traceEvents"]]
    assert names == ["failing"]
