#!/usr/bin/env python3
"""How many replays of a CUDA graph the host can enqueue behind
``chip_smoke.event_ms``'s sleep kernel before it blocks on the launch
queue, for a graph of IF nodes and for the same work without them.

Builds the two graphs ``chip_smoke.cond_set_kernel`` times (64 taken IF
nodes, each around one small add, through ``ops/cuda/cond_graph.py``;
and the 64 adds bare), then for n replays in 1, 5, 10, 20, 50, 100 and
a sleep of ``chip_smoke.SLEEP_CYCLES`` and four times that, three times
each: enqueues the sleep, a start event, the n replays and an end
event, and prints the host ms the enqueue took, whether the start and
end events had completed by then, and the device ms between them. A
start event already complete means the sleep ended before the host
enqueued the work: the events would have timed the host's pace. A host
that blocks on the queue waits out the sleep, however long it is.

Usage, from the repository root on a machine with a CUDA card:

    python3 tools/torch_launch_queue_probe.py
"""

from __future__ import annotations

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def enqueue(torch, graph, n, cycles):
    """Host ms to enqueue ``n`` replays behind a sleep of ``cycles``,
    whether the start / end events were done by then, device ms."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(cycles)
    t0 = time.perf_counter()
    start.record()
    for _ in range(n):
        graph.replay()
    end.record()
    host_ms = (time.perf_counter() - t0) * 1e3
    start_done, end_done = start.query(), end.query()
    end.synchronize()
    return host_ms, start_done, end_done, start.elapsed_time(end)


def main():
    import torch

    import chip_smoke as cs
    from paddle_tpu_torch import jit
    from paddle_tpu_torch.ops.cuda import _build
    from paddle_tpu_torch.ops.cuda import cond_graph as cg

    if not torch.cuda.is_available():
        raise SystemExit("this probe needs a CUDA card")
    print(cs.card_line(), flush=True)
    _build.load_all(["cond_graph"])
    dev = torch.device("cuda")
    pred = torch.ones((), dtype=torch.bool, device=dev)
    small = torch.zeros(8, device=dev)
    pool = torch.cuda.graph_pool_handle()
    jit.warm_up(dev, lambda: small.add_(0.0))

    def ifs():
        for _ in range(64):
            with cg.if_body(pred):
                small.add_(1.0)

    def adds():
        for _ in range(64):
            small.add_(1.0)

    g_if, _, _ = jit.capture(dev, ifs, [], pool)
    g_add, _, _ = jit.capture(dev, adds, [], pool)
    for name, graph in (("64 IF nodes", g_if), ("64 adds bare", g_add)):
        for n in (1, 5, 10, 20, 50, 100):
            for cycles in (cs.SLEEP_CYCLES, 4 * cs.SLEEP_CYCLES):
                rows = [enqueue(torch, graph, n, cycles) for _ in range(3)]
                print(f"{name}, {n} replays behind {cycles} cycles: " + " | ".join(
                    f"host {h:.2f} ms, start done {s}, end done {e}, "
                    f"device {d:.3f} ms" for h, s, e, d in rows), flush=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda._sleep(cs.SLEEP_CYCLES)
    torch.cuda.synchronize()
    print(f"a sleep of {cs.SLEEP_CYCLES} cycles: "
          f"{(time.perf_counter() - t0) * 1e3:.2f} ms wall")


if __name__ == "__main__":
    main()
