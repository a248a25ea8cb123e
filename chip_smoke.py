#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``paddle_tpu_torch``) on one NVIDIA
GPU: builds the hand-written CUDA paged-attention kernel from this
checkout, holds it against its plain PyTorch version on the card, serves
GPT-2 345M (``gpt2-medium``, full width and depth, random weights from a
seed) through the port's ServingEngine, shows that every attention call
of that run went through the kernel, and times the kernel.

Usage, from the repository root on a machine with a CUDA card and
``nvcc``:

    python3 chip_smoke.py

Every phase raises on failure; the script then exits nonzero without
printing its result. Its last two lines are the ``kernels`` JSON object
and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (NVIDIA data sheet)
F32_FLOPS = 67e12           # H100 SXM f32 outside the tensor cores
# kernel vs plain: f32 and int8 differ only in the order of summation
# (the JAX tests' bound); bf16 pools are upcast the same way on both
# sides, so only that order differs there too, over bf16-rounded values
TOL = {"f32": 2e-5, "int8": 2e-5, "bf16": 1e-4}


def log(msg=""):
    print(msg, flush=True)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


# ------------------------------------------------------------ phase 3
def tables_for(pos, s, bs, T):
    """Each row's live logical blocks on distinct physical blocks; table
    entries past the reservation stay on the trash block 0."""
    tables = np.zeros((len(pos), T), np.int32)
    nxt = 1
    for i, p in enumerate(pos):
        for j in range((p + s - 1) // bs + 1):
            tables[i, j] = nxt
            nxt += 1
    return tables, nxt


def make_inputs(torch, pos, s, d, kv, *, h=16, bs=16, T=16, seed=0,
                copies=1):
    """Kernel inputs on the card. int8 pools are written through the
    port's block_scatter_write_quant (a prefill-sized then a
    decode-sized write). The trash block is poisoned with 100.0 so a
    side that reads table padding fails the comparison."""
    from paddle_tpu_torch.ops.attention_ops import block_scatter_write_quant
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    b = len(pos)
    tables_np, nb = tables_for(pos, s, bs, T)
    tables = torch.from_numpy(tables_np).to(dev)
    posv = torch.tensor(pos, dtype=torch.int32, device=dev)
    q = torch.randn(b, h, s, d, device=dev, generator=g)
    pools = []
    for _ in range(copies):
        if kv == "int8":
            kq = torch.zeros(nb, h, bs, d, dtype=torch.int8, device=dev)
            vq = torch.zeros_like(kq)
            ks = torch.zeros(nb, h, device=dev)
            vs = torch.zeros_like(ks)
            end = max(pos) + s
            split = max(1, end - 1)
            for lo, hi in ((0, split), (split, end)):
                w = hi - lo
                start = torch.full((b,), lo, dtype=torch.int32, device=dev)
                block_scatter_write_quant(
                    kq, ks, torch.randn(b, h, w, d, device=dev, generator=g),
                    start, tables)
                block_scatter_write_quant(
                    vq, vs, torch.randn(b, h, w, d, device=dev, generator=g),
                    start, tables)
            for a in (kq, vq, ks, vs):
                a[0] = 100
            pools.append((kq, vq, ks, vs))
        else:
            dt = torch.float32 if kv == "f32" else torch.bfloat16
            kp = torch.randn(nb, h, bs, d, device=dev, generator=g).to(dt)
            vp = torch.randn(nb, h, bs, d, device=dev, generator=g).to(dt)
            kp[0] = 100.0
            vp[0] = 100.0
            pools.append((kp, vp, None, None))
    return q, pools, tables, posv


def check_kernel(torch, pa):
    """Phase 3: the kernel against its plain version, at the slice's
    shapes (h 16, d 64, bs 16, T 16, b 8) and at d 20 and 128."""
    rng = np.random.RandomState(0)
    dec = [int(p) for p in rng.randint(0, 256, size=8)]
    dec[0], dec[1], dec[2] = 0, 15, 255    # first key; ends on a block
    ver = [min(p, 251) for p in dec]
    ver[1] = 11                            # pos + s = 16: block boundary
    cases = []
    for kv in ("f32", "bf16", "int8"):
        cases += [(f"decode s=1 {kv}", dec, 1, 64, kv),
                  (f"verify s=5 {kv}", ver, 5, 64, kv),
                  (f"prefill s=128 pos=0 {kv}", [0] * 8, 128, 64, kv),
                  (f"prefill s=128 pos=37 {kv}",
                   [37, 0, 16, 100, 5, 64, 127, 90], 128, 64, kv)]
    # bucketed-prefill padding rows: whole table on the trash block,
    # pos 0 (key 0 must still be read so the normalizer is positive)
    cases += [("prefill pad rows s=16 f32", [0] * 8, 16, 64, "f32"),
              ("verify s=3 f32", [min(p, 253) for p in dec], 3, 64, "f32"),
              ("decode s=1 d=20 f32", dec, 1, 20, "f32"),
              ("verify s=5 d=20 int8", ver, 5, 20, "int8"),
              ("decode s=1 d=128 f32", dec, 1, 128, "f32"),
              ("prefill s=128 pos=37 d=128 bf16", [37] * 8, 128, 128,
               "bf16")]
    worst = 0.0
    for i, (name, pos, s, d, kv) in enumerate(cases):
        q, pools, tables, posv = make_inputs(torch, pos, s, d, kv, seed=i)
        if "pad rows" in name:
            tables[4:] = 0
        kp, vp, ks, vs = pools[0]
        out = pa.paged_attention(q, kp, vp, tables, posv, k_scale=ks,
                                 v_scale=vs)
        ref = pa.paged_attention_plain(q, kp, vp, tables, posv, k_scale=ks,
                                       v_scale=vs)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(out).all()):
            raise AssertionError(f"kernel case {name}: non-finite output")
        diff = (out.float() - ref.float()).abs()
        err = float(diff.max())
        # the JAX tests' criterion: |out - ref| <= tol + tol * |ref|
        over = float((diff - TOL[kv] * ref.float().abs()).max())
        log(f"  case {name:34s} max_abs_err {err:.3e} (rtol = atol = "
            f"{TOL[kv]:g})")
        if over > TOL[kv]:
            raise AssertionError(f"kernel case {name}: |out - ref| exceeds "
                                 f"{TOL[kv]} + {TOL[kv]} |ref| (max abs "
                                 f"err {err})")
        worst = max(worst, err)
    return len(cases), worst


# ------------------------------------------------------------ phase 4
def serve(torch, model, prompts, kv, impl, new_tokens=32):
    from paddle_tpu_torch.serving import ServingEngine
    eng = ServingEngine(model, max_slots=8, max_len=256, block_size=16,
                        prefix_cache=True, kv_dtype=kv, attn_impl=impl)
    reqs = [eng.submit(p, max_new_tokens=new_tokens) for p in prompts]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    bad = [r.id for r in reqs if r.state != "done"
           or len(r.tokens) != new_tokens]
    if bad:
        raise AssertionError(f"{kv}/{impl}: requests {bad} did not finish "
                             f"with {new_tokens} tokens")
    vocab = model.cfg.vocab_size
    if any(not 0 <= t < vocab for r in reqs for t in r.tokens):
        raise AssertionError(f"{kv}/{impl}: token outside the vocabulary")
    return eng, reqs, wall


def top2_gap(torch, model, ids):
    """Gap between the two largest last-position logits of a no-cache
    forward over ``ids``."""
    with torch.no_grad():
        lg = model(torch.tensor([ids], device=model.device))[0, -1]
    top = torch.topk(lg.float(), 2).values
    return float(top[0] - top[1])


def check_serving(torch, pa, card):
    """Phase 4: gpt2-medium served through the kernel, the launch count
    checked, the tokens held against the composed oracle, and the bf16
    and int8 pools served too. Returns the main run's numbers."""
    from paddle_tpu_torch.models.gpt import GPT_CONFIGS, GPTForCausalLM
    cfg = GPT_CONFIGS["gpt2-medium"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = GPTForCausalLM(cfg, device="cuda", generator=gen).eval()
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, size=int(n)).tolist()
               for n in rng.randint(4, 65, size=16)]
    # warm-up (CUDA context, cuBLAS handles, the kernel's first load)
    serve(torch, model, prompts[:2], "f32", "kernel", new_tokens=2)

    torch.cuda.reset_peak_memory_stats()
    pa.launches = 0
    eng, reqs, wall = serve(torch, model, prompts, "f32", "kernel")
    launches = pa.launches
    st = eng.stats()
    dispatches = st["prefill_dispatches"] + st["decode_steps"]
    peak = torch.cuda.max_memory_allocated()
    log(f"  kernel f32: {st['prefill_dispatches']} prefill dispatches + "
        f"{st['decode_steps']} decode steps, {launches} kernel launches")
    if launches != cfg.num_layers * dispatches or launches == 0:
        raise AssertionError(f"launches {launches} != {cfg.num_layers} x "
                             f"{dispatches} dispatches")
    tokens = sum(len(r.tokens) for r in reqs)
    if tokens != 512:
        raise AssertionError(f"{tokens} tokens came out, expected 512")

    _, creqs, _ = serve(torch, model, prompts, "f32", "composed")
    for r, c in zip(reqs, creqs):
        if r.tokens == c.tokens:
            continue
        j = next(i for i, (a, b) in enumerate(zip(r.tokens, c.tokens))
                 if a != b)
        gap = top2_gap(torch, model, c.prompt + c.tokens[:j])
        log(f"  request {c.id} diverges at step {j}: composed top-2 "
            f"logit gap {gap:.3e}")
        if gap >= 1e-3:
            raise AssertionError(f"kernel and composed tokens differ at "
                                 f"request {c.id} step {j} with top-2 gap "
                                 f"{gap} >= 1e-3")
    log("  kernel f32 tokens == composed f32 tokens (up to near ties)")

    for kv in ("bf16", "int8"):
        e, _, w = serve(torch, model, prompts, kv, "kernel")
        s2 = e.stats()
        log(f"  kernel {kv}: 512 tokens in {w:.3f} s"
            + (f", kv_quant_max_abs_err {s2['kv_quant_max_abs_err']}"
               if kv == "int8" else ""))
        if kv == "int8" and not s2["kv_quant_max_abs_err"] > 0:
            raise AssertionError("int8 run reported no quantization error")
    return {"launches": launches, "tokens": tokens, "wall_s": wall,
            "tokens_per_s": tokens / wall, "ttft_p50_ms": st["ttft_p50_ms"],
            "tpot_p50_ms": st["tpot_p50_ms"], "peak_bytes": peak,
            "prefix_hit_requests": st["prefix_hit_requests"]}


# ------------------------------------------------------------ phase 5
def decode_work(pos, s, h, d, kv, bs):
    """Bytes the decode call must move (each input read once: q, the
    valid K/V rows, their int8 scales, tables, pos; the output written
    once) and its FLOPs (QK^T and PV)."""
    elem = {"f32": 4, "bf16": 2, "int8": 1}[kv]
    b = len(pos)
    keys = sum(p + s for p in pos)
    nbytes = 2 * b * h * s * d * 4 + 2 * keys * h * d * elem \
        + b * 16 * 4 + b * 4
    if kv == "int8":
        nbytes += 2 * sum(-(-(p + s) // bs) for p in pos) * h * 4
    flops = 4 * h * s * d * keys
    return nbytes, flops


def time_fn(torch, fn, n, copies):
    for i in range(3):
        fn(i % copies)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(n):
        fn(i % copies)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def time_kernel(torch, pa, card):
    """Phase 5: the kernel and its plain version at the serving decode
    shape (b 8, h 16, s 1, d 64, bs 16, T 16, 129 blocks) with pos near
    the end of the 256-token window, cycling over 8 pool copies (> 50 MB
    L2) so each launch finds its pool cold, as a layer of the engine
    does."""
    rng = np.random.RandomState(1)
    pos = [int(p) for p in rng.randint(180, 221, size=8)]
    copies = 8
    out = {}
    for kv in ("f32", "bf16", "int8"):
        q, pools, tables, posv = make_inputs(torch, pos, 1, 64, kv, seed=7,
                                             copies=copies)

        def kern(i):
            kp, vp, ks, vs = pools[i]
            pa.paged_attention(q, kp, vp, tables, posv, k_scale=ks,
                               v_scale=vs)

        def plain(i):
            kp, vp, ks, vs = pools[i]
            pa.paged_attention_plain(q, kp, vp, tables, posv, k_scale=ks,
                                     v_scale=vs)

        saved = pa.launches
        ms = time_fn(torch, kern, 400, copies)
        plain_ms = time_fn(torch, plain, 40, copies)
        pa.launches = saved
        nbytes, flops = decode_work(pos, 1, 16, 64, kv, 16)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / F32_FLOPS * 1e3
        out[kv] = {"ms": ms, "plain_ms": plain_ms,
                   "bound_ms": max(t_bytes, t_ops),
                   "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                   "bytes": nbytes, "flops": flops}
        log(f"  decode {kv}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"{nbytes} bytes -> bound {max(t_bytes, t_ops):.4f} ms "
            f"({out[kv]['bound_by']}) [{card}]")
    return pos, out


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this smoke run needs a CUDA card")
    from paddle_tpu_torch.ops.cuda import _build
    from paddle_tpu_torch.ops.cuda import paged_attention as pa

    t_start = time.perf_counter()
    card = card_line()
    log("== phase 1: device")
    log(f"  {torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}, "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(f"  nvidia-smi: {card}")

    log("== phase 2: build")
    _build.load("paged_attention")
    info = _build.builds["paged_attention"]
    log(f"  {info['path']} built in {info['seconds']:.2f} s")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"  ptxas: {line.strip()}")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    log("== phase 3: kernel vs plain")
    n_cases, worst = check_kernel(torch, pa)
    log(f"  {n_cases} cases passed, max abs err {worst:.3e}")

    log("== phase 4: serve gpt2-medium")
    srv = check_serving(torch, pa, card)
    log(f"  engine [{card}]: {srv['tokens_per_s']:.1f} tokens/s "
        f"({srv['tokens']} tokens in {srv['wall_s']:.3f} s), TTFT p50 "
        f"{srv['ttft_p50_ms']} ms, TPOT p50 {srv['tpot_p50_ms']} ms, "
        f"max_memory_allocated {srv['peak_bytes']} B, prefix hits "
        f"{srv['prefix_hit_requests']}")

    log("== phase 5: time")
    pos, times = time_kernel(torch, pa, card)
    log(f"  decode pos {pos}")
    log(f"  total {time.perf_counter() - t_start:.1f} s")

    main_t = times["f32"]
    kernels = [{
        "name": "paged_attention",
        "route": "cuda",
        "source": "paddle_tpu_torch/csrc/paged_attention.cu",
        "replaces": "paddle_tpu/ops/pallas/paged_attention.py:55",
        "jax_counterpart": "paddle_tpu.ops.pallas.paged_attention."
                           "paged_attention",
        "cases_passed": n_cases,
        "launches": srv["launches"],
        "max_abs_err": worst,
        "ms": main_t["ms"],
        "plain_ms": main_t["plain_ms"],
        "bound_ms": main_t["bound_ms"],
        "bound_by": main_t["bound_by"],
        "library_ms": None,
        "by_kv_dtype": times,
    }]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
