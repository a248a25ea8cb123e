#!/usr/bin/env python3
"""Where the time of the PyTorch port's GPT train step goes, on one CUDA
card.

Runs the train step that ``chip_smoke.py`` phase 7 times
(``chip_smoke.train_step``: ``bench.py``'s step on ``gpt2-medium`` at
full width and depth, random weights from seed 0, batch 8, seq 1024,
AMP O2 bf16, AdamW with bf16 moments, one numpy-seeded batch). After 2
warm-up steps it times 3 steps without the profiler, then traces 3 more
with ``torch.profiler`` and prints, per step:

- wall ms (host clock, card synchronised) without and with the profiler;
- device-busy ms (the union of all kernel, copy and memset intervals)
  and the device's idle share of the unprofiled wall time;
- the same for each part of the step (forward, backward, optimizer):
  in the traced steps the card is synchronised at the end of each part,
  so every device interval falls inside its part's host range;
- kernels launched, and device ms by group (the three flash kernels,
  GEMMs, elementwise, reductions, softmax, indexing, copies, other);
- the top kernels by device time.

Usage, from the repository root on a machine with a CUDA card:

    python3 tools/torch_train_profile.py
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

PART = "train_step/"           # record_function prefix of a step's parts
WARMUP, STEPS, TOP = 2, 3, 15
GROUPS = [  # (group, substrings of the kernel name), first match wins
    # each flash kernel by its prefix: the CUDA-core and the tensor-core
    # (``*_wgmma_kernel``) route alike
    ("flash_fwd", ("flash_fwd_",)),
    ("flash_bwd_dq", ("flash_bwd_dq_",)),
    ("flash_bwd_dkv", ("flash_bwd_dkv_",)),
    ("gemm", ("gemm", "cutlass", "xmma", "nvjet", "cublas")),
    ("softmax", ("softmax",)),
    ("reduce", ("reduce",)),
    ("indexing", ("index", "gather", "scatter", "embedding")),
    ("elementwise", ("elementwise",)),
]


def group_of(name: str, cat: str) -> str:
    if cat != "kernel":
        return cat                  # gpu_memcpy, gpu_memset
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return "other kernels"


def busy_us(intervals) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    total, end = 0.0, -float("inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def main():
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    if not torch.cuda.is_available():
        raise SystemExit("torch_train_profile: no CUDA card")
    from chip_smoke import train_step
    _, _, _, step = train_step(torch)

    @contextlib.contextmanager
    def part(name):
        with record_function(PART + name):
            yield
            torch.cuda.synchronize()

    def timed(n, *part_of):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            step(*part_of)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e3

    for _ in range(WARMUP):
        step()
    wall_ms = timed(STEPS)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prof_wall_ms = timed(STEPS, part)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]

    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    if not dev:
        raise SystemExit("torch_train_profile: the trace holds no device "
                         "events; device time not measured")
    n = STEPS
    by_group = collections.Counter()
    by_name = collections.Counter()
    calls = collections.Counter()
    for e in dev:
        by_group[group_of(e["name"], e["cat"])] += e["dur"] / 1e3 / n
        by_name[e["name"]] += e["dur"] / 1e3 / n
        calls[e["name"]] += 1
    busy_ms = busy_us((e["ts"], e["ts"] + e["dur"]) for e in dev) / 1e3 / n
    kernels = sum(1 for e in dev if e["cat"] == "kernel") / n
    parts = collections.defaultdict(lambda: [0.0, [], 0])
    for r in events:
        # the host range only: the trace repeats each range on the
        # device timeline as a gpu_user_annotation
        if r.get("ph") == "X" and r.get("cat") == "user_annotation" \
                and r.get("name", "").startswith(PART):
            acc = parts[r["name"][len(PART):]]
            acc[0] += r["dur"] / 1e3 / n
            inside = [e for e in dev
                      if r["ts"] <= e["ts"] <= r["ts"] + r["dur"]]
            acc[1] += [(e["ts"], e["ts"] + e["dur"]) for e in inside]
            acc[2] += sum(e["cat"] == "kernel" for e in inside) / n
    card = torch.cuda.get_device_name(0)
    print(f"card {card}, torch {torch.__version__}; gpt2-medium, batch 8, "
          f"seq 1024, O2 bf16, AdamW bf16 moments; {n} steps after "
          f"{WARMUP} warm-up")
    print(f"wall ms/step {wall_ms:.3f} (profiled {prof_wall_ms:.3f}); "
          f"device busy ms/step {busy_ms:.3f}; device idle share "
          f"{1 - busy_ms / wall_ms:.4f} of the unprofiled wall; kernels "
          f"per step {kernels:.0f}")
    for name, (wall, inside, launched) in parts.items():
        b = busy_us(inside) / 1e3 / n
        print(f"  {name:10s} wall ms {wall:9.3f}, device busy ms {b:9.3f}, "
              f"kernels {launched:.0f}")
    print("device ms/step by group:")
    for group, ms in by_group.most_common():
        print(f"  {group:16s} {ms:10.3f}")
    print(f"top {TOP} by device ms/step (calls/step):")
    for name, ms in by_name.most_common(TOP):
        print(f"  {ms:9.3f}  {calls[name] / n:6.0f}  {name[:110]}")
    print(json.dumps({"wall_ms": wall_ms, "profiled_wall_ms": prof_wall_ms,
                      "busy_ms": busy_ms, "kernels_per_step": kernels,
                      "by_group_ms": dict(by_group), "card": card,
                      "parts": {k: {"wall_ms": v[0], "kernels": v[2],
                                    "busy_ms": busy_us(v[1]) / 1e3 / n}
                                for k, v in parts.items()}}))


if __name__ == "__main__":
    main()
