#!/usr/bin/env python3
"""How often ``torch.profiler`` loses kernel records of a traced train
step, with and without the sleep kernels that open every trace of
``chip_smoke.py`` (``chip_smoke.TRACE_PAD``).

Runs phase 10's step (``chip_smoke.train_step``: gpt2-medium at full
width and depth, batch 8, seq 1024, AMP O2 bf16, AdamW; the LayerNorm
and flash kernels on), then traces one step at a time with
``chip_smoke.trace_once``: ``--traces`` traces without the pad and as
many with it, alternating. For each trace it prints the kernels seen,
the pad kernels seen (of the pad's count), and every counted kernel of
``chip_smoke.TRACE_NAMES`` whose count differs from its launches per
step (49 LayerNorm forward and backward, 24 of each flash kernel, one
AdamW); then, for each mode, the traces that lost a counted kernel and
the totals seen. A pad that absorbs a loss at the start of a trace shows
as fewer pad kernels than launched, with the step's kernels whole.

Usage, from the repository root on a machine with a CUDA card:

    python3 tools/torch_trace_drops.py [--traces N] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

WARMUP = 3


def main():
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--traces", type=int, default=25,
                    help="traces in each mode (default 25)")
    ap.add_argument("--out", help="write every trace's record here (JSON)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_trace_drops: no CUDA card")
    import chip_smoke as cs
    from paddle_tpu_torch import flags
    from paddle_tpu_torch.ops.cuda import _build
    from paddle_tpu_torch.ops.cuda import adamw as aw
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.ops.cuda import flash_pack2 as fp2
    from paddle_tpu_torch.ops.cuda import layer_norm as ln
    from paddle_tpu_torch.ops.cuda import paged_attention as pa

    _build.load_all(["paged_attention", "flash_attention", "layer_norm",
                     "flash_pack2", "adamw"])
    torch.backends.cuda.matmul.allow_tf32 = False
    ctr = cs.Counters(pa, fa, ln, fp2, aw)
    cfg, _, _, step = cs.train_step(torch)
    flags.set_flags({"use_pallas_layer_norm": True})
    for _ in range(WARMUP):
        step()
    torch.cuda.synchronize()
    n_ln, n = 2 * cfg.num_layers + 1, cfg.num_layers
    want = {"ln_fwd": n_ln, "ln_bwd": n_ln, "flash_fwd": n,
            "flash_bwd_dq": n, "flash_bwd_dkv": n, "adamw": 1}
    pad = cs.TRACE_PAD
    load = cs.json.load
    seen = []

    def counting_load(f):   # the pad kernels, before trace_once drops them
        d = load(f)
        seen.append(sum(1 for e in d["traceEvents"]
                        if e.get("ph") == "X" and e.get("cat") == "kernel"
                        and "spin_kernel" in e["name"]))
        return d

    card = cs.card_line()
    print(f"[{card}] {2 * args.traces} traces of one step, "
          f"pad {pad[0]} x {pad[1]} cycles on every other", flush=True)
    runs = []
    cs.json.load = counting_load
    try:
        for i in range(2 * args.traces):
            padded = i % 2 == 1
            cs.TRACE_PAD = pad if padded else (0, 0)
            with ctr.aside():
                _, names = cs.trace_once(torch, step)
            counts = cs.trace_counts(names, 1)
            bad = {k: [counts[k], w] for k, w in want.items()
                   if counts[k] != w}
            runs.append({"pad": padded, "kernels": sum(names.values()),
                         "pad_seen": seen[-1], "bad": bad})
            print(f"  trace {i}: pad {padded}, {runs[-1]['kernels']} "
                  f"kernels, pad kernels seen {seen[-1]}, counted kernels "
                  f"off {bad}", flush=True)
    finally:
        cs.json.load = load
        cs.TRACE_PAD = pad
    summary = {}
    for padded in (False, True):
        rs = [r for r in runs if r["pad"] == padded]
        summary["padded" if padded else "bare"] = {
            "traces": len(rs),
            "lost_a_counted_kernel": sum(bool(r["bad"]) for r in rs),
            "kernel_totals": sorted({r["kernels"] for r in rs}),
            "pad_seen": sorted({r["pad_seen"] for r in rs})}
    print(f"[{card}] " + json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "pad": pad, "runs": runs,
                       "summary": summary}, f)


if __name__ == "__main__":
    main()
