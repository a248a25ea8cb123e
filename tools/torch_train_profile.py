#!/usr/bin/env python3
"""Where the time of the PyTorch port's train step goes, on one CUDA
card.

Runs the train step that ``chip_smoke.py`` times: by default phase 7's
(``chip_smoke.train_step``: ``bench.py``'s step on ``gpt2-medium`` at
full width and depth, random weights from seed 0, batch 8, seq 1024,
AMP O2 bf16, AdamW with bf16 moments, one numpy-seeded batch), with
``--model ernie`` phase 11's (``chip_smoke.ernie_step``: ERNIE-base,
batch 16, seq 512), with ``--model 1p1b`` phase 16's flagship
(``chip_smoke.flagship_step``: gpt2-1p1b with recompute, batch 8, seq
1024; captured with ``retain_grads=False`` as bench.py runs it). After
2 warm-up steps it times 3 steps without the
profiler, then traces 3 more with ``torch.profiler`` and prints, per
step:

- wall ms (host clock, card synchronised) without and with the profiler;
- device-busy ms (the union of all kernel, copy and memset intervals)
  and the device's idle share of the unprofiled wall time;
- the same for each part of the step (forward, backward, optimizer):
  in the traced steps the card is synchronised at the end of each part,
  so every device interval falls inside its part's host range;
- kernels launched, and device ms by group (the three flash kernels,
  the LayerNorm kernels, AdamW, GEMMs, elementwise, reductions, softmax,
  indexing, copies, other);
- the elementwise group split by the operation that launched each
  kernel: the outermost aten op or autograd node around the launch
  (``aten::to`` for a cast, ``aten::add``, ``aten::gelu``,
  ``GeluBackward0``, ...), from the trace's correlation of each kernel
  with its CPU op;
- the top kernels by device time.

``--static`` then runs the same step through ``jit.to_static`` (the
first two calls eager, the third captures the CUDA graph, as
``chip_smoke.captured_run`` does), times and traces its replays, and
prints the same breakdown. A replayed kernel has no CPU op of its own,
so the captured step's elementwise kernels are labelled by the operation
that launched the same kernel (by name) in the eager trace taken first.
``--ln`` turns ``use_pallas_layer_norm`` on (phase 10, and phase 11's
main run).

Usage, from the repository root on a machine with a CUDA card:

    python3 tools/torch_train_profile.py [--model gpt|ernie|1p1b] [--ln]
        [--static]
"""

from __future__ import annotations

import argparse
import bisect
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
MODELS = {  # --model: (chip_smoke's step factory, what it trains)
    "gpt": ("train_step", "gpt2-medium, batch 8, seq 1024"),
    "ernie": ("ernie_step", "ernie-base, batch 16, seq 512"),
    "1p1b": ("flagship_step", "gpt2-1p1b with recompute, batch 8, "
             "seq 1024"),
}
WARMUP, STEPS, TOP = 2, 3, 15
GROUPS = [  # (group, substrings of the kernel name), first match wins
    # each flash kernel by its prefix: the CUDA-core and the tensor-core
    # (``*_wgmma_kernel``) route alike
    ("flash_fwd", ("flash_fwd_",)),
    ("flash_bwd_dq", ("flash_bwd_dq_",)),
    ("flash_bwd_dkv", ("flash_bwd_dkv_",)),
    ("layer_norm", ("ln_fwd_kernel", "ln_bwd_kernel", "ln_bwd_reduce")),
    ("adamw", ("adamw_multi_kernel",)),
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


def launching_ops(events):
    """``{external id: label}``: for each CPU op, the outermost aten op or
    autograd node on its thread whose time range holds it."""
    ops = [e for e in events if e.get("ph") == "X"
           and e.get("cat") == "cpu_op"]
    tops = collections.defaultdict(list)     # tid -> [(start, end, name)]
    for e in sorted(ops, key=lambda e: (e["tid"], e["ts"], -e["dur"])):
        spans = tops[e["tid"]]
        if not spans or e["ts"] >= spans[-1][1]:
            spans.append((e["ts"], e["ts"] + e["dur"], e["name"]))
    starts = {tid: [s[0] for s in spans] for tid, spans in tops.items()}
    out = {}
    for e in ops:
        ext = e.get("args", {}).get("External id")
        if ext is None:
            continue
        spans = tops[e["tid"]]
        i = bisect.bisect_right(starts[e["tid"]], e["ts"]) - 1
        name = spans[i][2] if i >= 0 else e["name"]
        out[ext] = name.replace("autograd::engine::evaluate_function: ",
                                "")
    return out


def trace(torch, run):
    """The chrome-trace events of ``run()`` under ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]


def breakdown(events, n, labels_by_name=None):
    """Per step: device busy ms, kernels, ms by group, the elementwise ms
    by launching op, the top kernels, and the parts' host and device
    ms. ``labels_by_name`` labels kernels that have no CPU op (a graph
    replay's) by kernel name."""
    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    if not dev:
        raise SystemExit("torch_train_profile: the trace holds no device "
                         "events; device time not measured")
    ops = launching_ops(events)
    by_group = collections.Counter()
    by_name = collections.Counter()
    calls = collections.Counter()
    by_op = collections.Counter()
    name_ops = collections.defaultdict(collections.Counter)
    for e in dev:
        ms = e["dur"] / 1e3 / n
        group = group_of(e["name"], e["cat"])
        by_group[group] += ms
        by_name[e["name"]] += ms
        calls[e["name"]] += 1
        op = ops.get(e.get("args", {}).get("External id"))
        if op is not None:
            name_ops[e["name"]][op] += 1
        if group == "elementwise":
            if op is None and labels_by_name is not None:
                op = labels_by_name.get(e["name"], "unlabelled")
            by_op[op or "unlabelled"] += ms
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
    return {
        "busy_ms": busy_us((e["ts"], e["ts"] + e["dur"])
                           for e in dev) / 1e3 / n,
        "kernels_per_step": sum(1 for e in dev if e["cat"] == "kernel") / n,
        "by_group_ms": dict(by_group.most_common()),
        "elementwise_by_op_ms": dict(by_op.most_common()),
        "top": [(ms, calls[name] / n, name)
                for name, ms in by_name.most_common(TOP)],
        "parts": {k: {"wall_ms": v[0], "kernels": v[2],
                      "busy_ms": busy_us(v[1]) / 1e3 / n}
                  for k, v in parts.items()},
        "labels_by_name": {name: c.most_common(1)[0][0]
                           for name, c in name_ops.items()},
    }


def report(title, wall_ms, prof_wall_ms, b):
    print(f"{title}: wall ms/step {wall_ms:.3f} (profiled "
          f"{prof_wall_ms:.3f}); device busy ms/step {b['busy_ms']:.3f}; "
          f"device idle share {1 - b['busy_ms'] / wall_ms:.4f} of the "
          f"unprofiled wall; kernels per step {b['kernels_per_step']:.0f}")
    for name, p in b["parts"].items():
        print(f"  {name:10s} wall ms {p['wall_ms']:9.3f}, device busy ms "
              f"{p['busy_ms']:9.3f}, kernels {p['kernels']:.0f}")
    print("device ms/step by group:")
    for group, ms in b["by_group_ms"].items():
        print(f"  {group:16s} {ms:10.3f}")
    print("elementwise device ms/step by the op that launched it:")
    for op, ms in b["elementwise_by_op_ms"].items():
        print(f"  {ms:9.3f}  {op[:100]}")
    print(f"top {TOP} by device ms/step (calls/step):")
    for ms, c, name in b["top"]:
        print(f"  {ms:9.3f}  {c:6.0f}  {name[:110]}")


def main():
    import torch
    from torch.profiler import record_function
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", choices=tuple(MODELS), default="gpt")
    ap.add_argument("--ln", action="store_true",
                    help="turn use_pallas_layer_norm on")
    ap.add_argument("--static", action="store_true",
                    help="also trace the step captured by jit.to_static")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_train_profile: no CUDA card")
    import chip_smoke
    from paddle_tpu_torch import flags, jit
    flags.set_flags({"use_pallas_layer_norm": args.ln})
    make, shape = MODELS[args.model]
    _, model, _, step = getattr(chip_smoke, make)(torch)

    @contextlib.contextmanager
    def part(name):
        with record_function(PART + name):
            yield
            torch.cuda.synchronize()

    def timed(fn, n, *part_of):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn(*part_of)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e3

    for _ in range(WARMUP):
        step()
    wall_ms = timed(step, STEPS)
    holder = {}
    events = trace(torch, lambda: holder.setdefault(
        "ms", timed(step, STEPS, part)))
    card = torch.cuda.get_device_name(0)
    what = (f"{shape}, O2 bf16, AdamW bf16 moments, use_pallas_layer_norm "
            f"{args.ln}")
    print(f"card {card}, torch {torch.__version__}; {what}; {STEPS} steps "
          f"after {WARMUP} warm-up")
    eager = breakdown(events, STEPS)
    report("eager", wall_ms, holder["ms"], eager)
    result = {"card": card, "model": args.model, "ln": args.ln,
              "eager": {"wall_ms": wall_ms, "profiled_wall_ms": holder["ms"],
                        **{k: v for k, v in eager.items()
                           if k not in ("top", "labels_by_name")}}}
    if args.static:
        model.zero_grad(set_to_none=True)
        retain = args.model != "1p1b"       # as bench.py runs each step
        fast = jit.to_static(step, layers=[model], optimizers=[step.opt],
                             retain_grads=retain)
        for _ in range(3):          # eager (x2 with retain_grads), capture
            fast()
        static_ms = timed(fast, STEPS)
        holder = {}
        events = trace(torch, lambda: holder.setdefault(
            "ms", timed(fast, STEPS)))
        cap = breakdown(events, STEPS, eager["labels_by_name"])
        report("to_static (CUDA graph replays)", static_ms, holder["ms"],
               cap)
        result["static"] = {"wall_ms": static_ms,
                            "profiled_wall_ms": holder["ms"],
                            **{k: v for k, v in cap.items()
                               if k not in ("top", "labels_by_name")}}
    print(json.dumps(result))


if __name__ == "__main__":
    main()
