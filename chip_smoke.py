#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``paddle_tpu_torch``) on one NVIDIA
GPU: builds the hand-written CUDA kernels from this checkout (paged
attention; flash attention forward, dQ and dK/dV; LayerNorm forward and
backward; the packed-heads flash forward; the multi-tensor AdamW update),
holds each against its plain PyTorch version on the card, serves GPT-2
345M (``gpt2-medium``, full width and depth, random weights from a seed)
through the port's ServingEngine with every prefill and decode dispatch
the replay of a CUDA graph, greedy, sampled (a threefry stream per
request, bit-equal to ``jax.random``) and speculative (n-gram drafts
verified through the paged kernel at q_len K+1), runs ``bench.py``'s
serving block (the engine against sequential ``greedy_search``, the
dense slotted cache against the paged one, offline ``sample`` and
``beam_search``), trains it (``bench.py``'s step: batch
8, seq 1024, AMP O2 bf16, AdamW with bf16 moments) eagerly and through
``jit.to_static`` as a CUDA graph, with the LayerNorm kernels off and
on, trains ERNIE-base (``bench.py``'s ERNIE step: batch 16, seq 512)
through the LayerNorm kernels, eagerly and captured, trains
``bench.py``'s default flagship (gpt2-1p1b with recompute) through
``jit.to_static_multi_step``, serves gpt2-medium again eagerly, captured
and in decode megasteps and swaps its weights mid-run, runs every eager
optimizer with clipping, a schedule and ``lr_scale`` eagerly and
captured (bit-equal), trains ``bench.py``'s ResNet-50 step uncut and
drives ``GradScaler`` at fp16, shows that every run went through its
kernels (the launch counts, and the kernel names a profiler trace of
the same step sees), reads the device's busy time of each train step
with ``torch.profiler``, and times the kernels. The flash forward, dQ
and dK/dV take the tensor-core (``wgmma``) kernels for bf16 with
head_dim 64 or 128, and the packed forward for bf16 with 64-wide heads:
phase 2 checks that their SASS holds HGMMA instructions, phases 6 and 12
hold them to :func:`close_rounded`, and phases 7, 10, 12 and 16 check
that every counted launch of them took that route.

Phases: 1 device, 2 build, 3 paged kernel vs plain, 4 serve (every
bucket and the decode step captured first, then a timed run that
captures nothing), 5 time the paged kernel (decode, the verify's q_len
5, the prefill, blocks of 8), 5b sampled and speculative
serving (the threefry port against JAX's values; the sampler on the card
against its CPU run; 16 sampled requests captured, eagerly, in reverse
order and at megastep 8, byte-identical; the greedy and sampled decode
graphs' TPOT, kernels and device ms per step; spec K = 4 against K = 0
on bench.py's repetitive prompts), 5c ``bench.py``'s serving block
(the engine's 32 requests against sequential ``greedy_search``,
``vs_baseline``; the dense engine against the paged one at equal pool
bytes on a shared system prompt: tokens, KV bytes per request, peak
concurrency, prefix hit rate; the dense decode step's profile beside the
paged one's; dense spec K = 4; sampled dense requests and offline
``sample`` / ``beam_search`` captured against eager; no port kernel on
the dense path; ``bench.py:539-633``: the kernel route against the
composed one at blocks of 8, int8 against f32 pools of equal bytes, a
concurrency gain of at least 1.8x asserted), 5d the replica fleet
(``bench.py:636-725``'s megastep block: 2 replicas at megastep 1
serially and at megastep 8 from 2 dispatch threads, tokens equal, 0
captures in each timed pass; the router half of ``bench.py:775-799``;
fresh fleets on threads whose first captures run while the other
replica replays; a kill mid-decode, three restarts with flat reserved
memory, a rolling weight swap; B4 against plain at the fleet's shapes),
6 flash kernels vs plain (f32, bf16
and fp16), 7 train GPT (eager, then captured: losses and parameters
bit-equal), 7b train GPT at O1 fp16 with ``GradScaler`` through the
CUDA-core flash kernels, 8 time the flash kernels, 9
LayerNorm kernels vs plain, 10 train GPT with the LayerNorm kernels, 11
train ERNIE-base (eager and captured), 12 packed-heads forward, 13 time
the LayerNorm kernels, 14 AdamW kernel vs plain (f32, bf16 and fp16
parameters and moments), 15 the AdamW kernel vs plain on gpt2-1p1b's and
gpt2-medium's whole parameter sets, then its time, 16 train the
gpt2-1p1b flagship, 17 serve gpt2-medium eagerly (``jit.no_capture()``),
captured and at megastep 8 in one process (tokens/s, TTFT, TPOT, the
decode step's host time against its device busy time, kernels per step,
peak memory; tokens equal across the three, also where eos, stops and
budgets end requests mid-megastep), and swap its weights mid-run, 18 the
optimizer plane, each optimizer captured against eager from the same
weights (gpt2-medium with AdamW, the global-norm clip folded into the
kernel, a warmup/cosine schedule and ``lr_scale`` 0.1 on the
embeddings; LAMB on ERNIE-base; LarsMomentum on ResNet-50; SGD, Nesterov
Momentum, Adagrad, RMSProp, Ftrl and Adam on ResNet-18), and the clip's
norm timed against its bound, 19 ``bench.py``'s ResNet-50 step uncut
(batch 128, 224 x 224, O2, Momentum; eager against captured, then
``to_static_multi_step`` K = 10 timed: images/s, MFU, busy, kernels by
group, memory), 20 ``GradScaler`` on ResNet-50 at O1 fp16 (skipped
updates on inf, the scale's rule, and its refusal under capture).

Usage, from the repository root on a machine with a CUDA card and
``nvcc``:

    python3 chip_smoke.py

Every phase raises on failure; the script then exits nonzero without
printing its result. Its last two lines are the ``kernels`` JSON object
and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (NVIDIA data sheet)
F32_FLOPS = 67e12           # H100 SXM f32 outside the tensor cores
BF16_FLOPS = 989e12         # H100 SXM bf16 tensor cores, dense
# kernel vs plain: f32 and int8 differ only in the order of summation
# (the JAX tests' bound); bf16 pools are upcast the same way on both
# sides, so only that order differs there too, over bf16-rounded values
TOL = {"f32": 2e-5, "int8": 2e-5, "bf16": 1e-4}


def log(msg=""):
    print(msg, flush=True)


class Counters:
    """The launch counts of every kernel wrapper, by kernel name: the
    paged-attention module's integer and the other modules' dicts, and
    the counts by route (``launches_by_route``) of the modules that keep
    them."""

    def __init__(self, pa, *modules):
        self.pa, self.modules = pa, modules

    def read(self):
        out = {"paged_attention": self.pa.launches}
        for m in self.modules:
            out.update(m.launches)
        return out

    def routes(self):
        """``{kernel: {route: launches}}`` of the modules that count
        routes."""
        return {name: dict(by) for m in (self.pa, *self.modules)
                for name, by in getattr(m, "launches_by_route", {}).items()}

    def set(self, values, routes=None):
        self.pa.launches = values.get("paged_attention", 0)
        for m in self.modules:
            for name in m.launches:
                m.launches[name] = values.get(name, 0)
        for m in (self.pa, *self.modules):
            for name, by in getattr(m, "launches_by_route", {}).items():
                for route in by:
                    by[route] = (routes or {}).get(name, {}).get(route, 0)

    def zero(self):
        self.set({})

    @contextlib.contextmanager
    def aside(self):
        """Launches made inside (comparisons, timing) are not counted."""
        saved, saved_routes = self.read(), self.routes()
        try:
            yield
        finally:
            self.set(saved, saved_routes)

    def expect(self, run, want, what):
        """Raise unless ``run`` has exactly ``want`` and nothing else."""
        bad = {k: v for k, v in run.items() if v != want.get(k, 0)}
        if bad:
            raise AssertionError(f"{what}: launch counts {run}, expected "
                                 f"{want} and no other launch")


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


# ------------------------------------------------------------ phase 2
#: the tensor-core kernels by library: csrc/flash_attention.cu (B1, B2,
#: B3) and csrc/flash_pack2.cu (B7)
TC_KERNELS = {"flash_attention": ("flash_fwd_wgmma_kernel",
                                  "flash_bwd_dq_wgmma_kernel",
                                  "flash_bwd_dkv_wgmma_kernel"),
              "flash_pack2": ("flash_pack2_fwd_wgmma_kernel",)}


def ptxas_blocks(log_text):
    """ptxas's lines by kernel: each ``Compiling entry function`` line and
    the lines after it, up to the next kernel's."""
    blocks, fn = {}, None
    for line in log_text.splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1] if "'" in line else line
            blocks[fn] = []
        if fn is not None:
            blocks[fn].append(line.strip())
    return blocks


def sass_hgmma(path):
    """HGMMA (wgmma) instructions per kernel, by mangled name, in the
    SASS of a built library, read with the toolkit's ``cuobjdump``."""
    from paddle_tpu_torch.ops.cuda import _build
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    out = subprocess.run([tool, "-sass", path], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    counts, fn = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            counts[fn] = 0
        elif fn is not None and "HGMMA" in line:
            counts[fn] += 1
    return counts


def check_tc_build(lib, build):
    """Phase 2, the tensor-core kernels of library ``lib``: prints each
    one's ptxas lines (registers, spills, shared memory) and its count of
    HGMMA instructions; raises if any of them has none."""
    blocks = ptxas_blocks(build["log"])
    hgmma = sass_hgmma(build["path"])
    out = {}
    for name in TC_KERNELS[lib]:
        found = {fn: n for fn, n in hgmma.items() if name in fn}
        if not found or not all(found.values()):
            raise AssertionError(f"{name}: no HGMMA instruction in the SASS "
                                 f"of {build['path']} ({found})")
        for fn, n in sorted(found.items()):
            log(f"  {name}: {n} HGMMA instructions in {fn}")
            for line in blocks.get(fn, []):
                if "registers" in line or "spill" in line or "smem" in line:
                    log(f"    ptxas: {line}")
        out[name] = found
    return out


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
    shapes (h 16, d 64, bs 16, T 16, b 8), at d 7, 20, 128 and 320, at
    block sizes 4, 64 and 128, at b 2, h 4, and at phase 5c's paged
    engine (b 32, bs 8, T 32: its decode, its first prefill and its
    prefill of a suffix after a shared prefix, idle rows included). A
    case's optional 7th field is the number of live rows: the rest are
    padding (the whole table on the trash block), as the engine pads a
    batch. Each case checks that the call launched on its plan's
    route."""
    rng = np.random.RandomState(0)
    dec = [int(p) for p in rng.randint(0, 256, size=8)]
    dec[0], dec[1], dec[2] = 0, 15, 255    # first key; ends on a block
    ver = [min(p, 251) for p in dec]
    ver[1] = 11                            # pos + s = 16: block boundary
    cases = []
    for kv in ("f32", "bf16", "int8"):
        cases += [(f"decode s=1 {kv}", dec, 1, 64, kv, 16),
                  (f"verify s=5 {kv}", ver, 5, 64, kv, 16),
                  (f"prefill s=128 pos=0 {kv}", [0] * 8, 128, 64, kv, 16),
                  (f"prefill s=128 pos=37 {kv}",
                   [37, 0, 16, 100, 5, 64, 127, 90], 128, 64, kv, 16)]
    # bucketed-prefill padding rows: whole table on the trash block,
    # pos 0 (key 0 must still be read so the normalizer is positive)
    cases += [("prefill pad rows s=16 f32", [0] * 8, 16, 64, "f32", 16, 4),
              ("verify s=3 f32", [min(p, 253) for p in dec], 3, 64, "f32",
               16),
              ("decode s=1 d=20 f32", dec, 1, 20, "f32", 16),
              ("verify s=5 d=20 int8", ver, 5, 20, "int8", 16),
              ("decode s=1 d=128 f32", dec, 1, 128, "f32", 16),
              ("prefill s=128 pos=37 d=128 bf16", [37] * 8, 128, 128,
               "bf16", 16),
              # block sizes and widths the first design refused
              ("decode s=1 bs=64 d=128 f32", dec, 1, 128, "f32", 64),
              ("verify s=5 bs=64 d=128 bf16", ver, 5, 128, "bf16", 64),
              ("decode s=1 bs=128 d=64 int8", dec, 1, 64, "int8", 128),
              ("verify s=5 d=320 f32", ver, 5, 320, "f32", 16),
              ("decode s=1 d=320 f32", dec, 1, 320, "f32", 16),
              ("prefill pad rows s=64 f32", [0, 0, 0, 0, 0, 0, 0, 0], 64,
               64, "f32", 16, 4),
              # 4-key sub-tiles (8 lanes per key); 64-entry tables, so a
              # range crosses a 32-entry window of the table
              ("verify s=5 bs=4 bf16", ver, 5, 64, "bf16", 4),
              ("verify s=5 bs=4 int8", ver, 5, 64, "int8", 4),
              # 8-byte copies (40-byte rows), element copies (7-byte rows)
              ("decode s=1 d=20 bf16", dec, 1, 20, "bf16", 16),
              ("verify s=3 d=7 int8", [min(p, 253) for p in dec], 3, 7,
               "int8", 16),
              # b x h = 8 blocks, each split across its warps
              ("decode s=1 b=2 h=4 f32", [200, 37], 1, 64, "f32", 16)]
    # phase 5c's paged engine: 28 requests in flight at most (positions
    # 34-65 while decoding), the first prefill at bucket 64, the
    # suffix's at bucket 16 after the 32-token shared prefix
    d32 = [int(p) for p in rng.randint(34, 66, size=32)]
    cases += [("decode s=1 b=32 bs=8 f32", d32, 1, 64, "f32", 8),
              ("decode s=1 b=32 bs=8 28 live f32", d32[:28] + [0] * 4, 1,
               64, "f32", 8, 28),
              ("prefill s=64 b=32 bs=8 28 live f32", [0] * 32, 64, 64,
               "f32", 8, 28),
              ("prefill s=16 pos=32 b=32 bs=8 4 live f32",
               [32] * 4 + [0] * 28, 16, 64, "f32", 8, 4)]
    worst = 0.0
    for i, case in enumerate(cases):
        worst = max(worst, check_kernel_case(torch, pa, i, *case))
    return len(cases), worst


def check_kernel_case(torch, pa, seed, name, pos, s, d, kv, bs, *live):
    """One kernel case against the plain version: the call must launch on
    its plan's route and stay within TOL. Returns the max abs error."""
    elem = {"f32": 4, "bf16": 2, "int8": 1}
    h = 4 if "h=4" in name else 16
    q, pools, tables, posv = make_inputs(torch, pos, s, d, kv, h=h,
                                         bs=bs, T=256 // bs, seed=seed)
    if live:
        tables[live[0]:] = 0
    kp, vp, ks, vs = pools[0]
    pl = pa.plan(*q.shape, bs, tables.shape[1], elem[kv])
    before = dict(pa.launches_by_route["paged_attention"])
    out = pa.paged_attention(q, kp, vp, tables, posv, k_scale=ks,
                             v_scale=vs)
    torch.cuda.synchronize()
    after = pa.launches_by_route["paged_attention"]
    if after[pl["route"]] != before[pl["route"]] + 1:
        raise AssertionError(f"kernel case {name}: not launched on the "
                             f"{pl['route']} route ({before} -> "
                             f"{after})")
    ref = pa.paged_attention_plain(q, kp, vp, tables, posv, k_scale=ks,
                                   v_scale=vs)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(out).all()):
        raise AssertionError(f"kernel case {name}: non-finite output")
    diff = (out.float() - ref.float()).abs()
    err = float(diff.max())
    # the JAX tests' criterion: |out - ref| <= tol + tol * |ref|
    over = float((diff - TOL[kv] * ref.float().abs()).max())
    log(f"  case {name:40s} max_abs_err {err:.3e} (rtol = atol = "
        f"{TOL[kv]:g}); {pl['route']}, ks {pl['ks']}, "
        f"{pl['rows']} rows/block, kt {pl['kt']} x "
        f"{pl['stages']} stages, {pl['smem']} B smem")
    if over > TOL[kv]:
        raise AssertionError(f"kernel case {name}: |out - ref| exceeds "
                             f"{TOL[kv]} + {TOL[kv]} |ref| (max abs "
                             f"err {err})")
    return err


# ------------------------------------------------------------ phase 4
#: prompt lengths whose prefills take each of the engine's buckets (16,
#: 32, 64, 128 and max_len 256): every key's first call, before timing
WARM_PROMPTS = (10, 24, 48, 100, 200)


def serving_engine(model, kv, impl, megastep=1, spec_tokens=0):
    """The JAX bench's engine geometry: 8 slots, ``max_len`` 256, blocks
    of 16, the prefix cache on."""
    from paddle_tpu_torch.serving import ServingEngine
    return ServingEngine(model, max_slots=8, max_len=256, block_size=16,
                         prefix_cache=True, kv_dtype=kv, attn_impl=impl,
                         megastep=megastep, spec_tokens=spec_tokens)


def captures(model) -> int:
    """The specialisations of every step-cache entry of ``model`` (graphs
    captured, on the card)."""
    return sum(e["traces"]["count"]
               for e in getattr(model, "_step_compile_cache", {}).values())


def warm(torch, eng, seed=99):
    """One prompt per prefill bucket and a few decode dispatches: the
    first call of every key the timed run will use, where each captures
    its graph."""
    vocab = eng.model.cfg.vocab_size
    rng = np.random.RandomState(seed)
    reqs = [eng.submit(rng.randint(0, vocab, size=n).tolist(),
                       max_new_tokens=4) for n in WARM_PROMPTS]
    eng.run_until_idle()
    torch.cuda.synchronize()
    assert all(r.done for r in reqs)


def pctl_ms(vals, q):
    return float(np.percentile(vals, q)) * 1e3


def drive(torch, ctr, eng, specs, what, warmed=True):
    """Serve ``specs`` (``(prompt, submit kwargs)``) to the end with every
    launch count zeroed before and read after, the card's peak memory
    reset before: the tokens and the numbers of the run, the peak of
    requests in flight among them. The counts must be exactly
    ``num_layers`` paged-attention launches per prefill or decode
    dispatch (``n`` per megastep dispatch) of a paged engine on the kernel
    route, and none of a composed or a dense one, and with ``warmed`` (every key was warmed) no step may
    capture a graph."""
    model = eng.model
    d0 = (eng.prefill_dispatches, eng.decode_steps, eng.megastep_dispatches)
    cap0 = captures(model)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ctr.zero()
    t0 = time.perf_counter()
    reqs = [eng.submit(p, **kw) for p, kw in specs]
    peak_active = 0
    while not eng.idle:
        eng.step()
        peak_active = max(peak_active, len(eng._active))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    run, routes = ctr.read(), ctr.routes()["paged_attention"]
    peak = torch.cuda.max_memory_allocated()
    reserved = torch.cuda.max_memory_reserved()
    new_captures = captures(model) - cap0
    pre, dec, mega = (a - b for a, b in zip(
        (eng.prefill_dispatches, eng.decode_steps, eng.megastep_dispatches),
        d0))
    vocab = model.cfg.vocab_size
    if any(not r.done for r in reqs):
        raise AssertionError(f"{what}: requests did not finish")
    if any(not 0 <= t < vocab for r in reqs for t in r.tokens):
        raise AssertionError(f"{what}: token outside the vocabulary")
    want = model.cfg.num_layers * (pre + dec + eng.megastep * mega) \
        if eng.paged and eng.attn_impl == "kernel" else 0
    ctr.expect(run, {"paged_attention": want} if want else {}, what)
    if sum(routes.values()) != run["paged_attention"]:
        raise AssertionError(f"{what}: launches by route {routes} do not "
                             f"add up to {run['paged_attention']}")
    if new_captures and warmed:
        raise AssertionError(f"{what}: the timed run captured "
                             f"{new_captures} graphs; every key was warmed")
    tokens = sum(len(r.tokens) for r in reqs)
    ttft = [r.ttft for r in reqs]
    tpot = [r.tpot for r in reqs if r.tpot is not None]
    res = {"tokens": tokens, "wall_s": wall, "tokens_per_s": tokens / wall,
           "ttft_p50_ms": pctl_ms(ttft, 50), "ttft_p99_ms": pctl_ms(ttft, 99),
           "tpot_p50_ms": pctl_ms(tpot, 50), "tpot_p99_ms": pctl_ms(tpot, 99),
           "peak_bytes": peak, "peak_reserved_bytes": reserved,
           "launches": run["paged_attention"], "routes": routes,
           "prefill_dispatches": pre, "decode_steps": dec,
           "megastep_dispatches": mega, "captures_in_run": new_captures,
           "peak_active": peak_active,
           "prefix_hit_requests": eng.stats().get("prefix_hit_requests")}
    log(f"  {what}: {tokens} tokens in {wall:.3f} s, {pre} prefill + "
        f"{dec} decode + {mega} megastep dispatches, "
        f"{run['paged_attention']} paged launches {routes}, peak "
        f"{peak_active} requests in flight, {new_captures} captures")
    return res, [r.tokens for r in reqs]


def top2_gap(torch, model, ids):
    """Gap between the two largest last-position logits of a no-cache
    forward over ``ids``."""
    with torch.no_grad():
        lg = model(torch.tensor([ids], device=model.device))[0, -1]
    top = torch.topk(lg.float(), 2).values
    return float(top[0] - top[1])


def same_tokens(torch, model, prompts, ref, out, what, ties=True):
    """Raise unless ``out`` equals ``ref`` request by request. With
    ``ties``, a request may diverge where the reference's top-2 logits
    (a no-cache forward of the model's current weights) are within 1e-3
    of each other, which is logged: another order of summation may take
    either side of such a tie. Returns the divergences."""
    diverged = []
    for i, (p, a, b) in enumerate(zip(prompts, ref, out)):
        if a == b:
            continue
        j = next((k for k, (x, y) in enumerate(zip(a, b)) if x != y),
                 min(len(a), len(b)))
        gap = top2_gap(torch, model, p + a[:j]) if ties else None
        log(f"  {what}: request {i} diverges at token {j}"
            + (f": reference top-2 logit gap {gap:.3e}" if ties else ""))
        if not ties or gap >= 1e-3:
            raise AssertionError(f"{what}: request {i} differs at token {j}"
                                 + (f" with top-2 gap {gap}" if ties else ""))
        diverged.append({"request": i, "token": j, "gap": gap})
    return diverged


def serving_prompts(vocab, n=16):
    rng = np.random.RandomState(0)
    return [rng.randint(0, vocab, size=int(k)).tolist()
            for k in rng.randint(4, 65, size=n)]


def check_serving(torch, ctr, card):
    """Phase 4: gpt2-medium served through the kernel with every dispatch
    a graph replay: each bucket and the decode step warmed (captured)
    first, then the timed run, which must capture nothing; the launch
    count checked, one graph per entry, the tokens held against the
    composed oracle's, and the bf16 and int8 pools served too. Returns
    the main run's numbers."""
    from paddle_tpu_torch.models import generation
    from paddle_tpu_torch.models.gpt import GPT_CONFIGS, GPTForCausalLM
    cfg = GPT_CONFIGS["gpt2-medium"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = GPTForCausalLM(cfg, device="cuda", generator=gen).eval()
    prompts = serving_prompts(cfg.vocab_size)
    specs = [(p, {"max_new_tokens": 32}) for p in prompts]

    eng = serving_engine(model, "f32", "kernel")
    warm(torch, eng)
    res, toks = drive(torch, ctr, eng, specs, "kernel f32")
    if res["tokens"] != 512:
        raise AssertionError(f"{res['tokens']} tokens came out, expected 512")
    traces = {"decode": generation.decode_step_paged(
        model, "f32", "kernel")["traces"]["count"]}
    traces.update({f"prefill_{b}": e["traces"]["count"]
                   for b, e in sorted(eng._prefill_fns.items())})
    log(f"  kernel f32: graphs per entry {traces}")
    if set(traces.values()) != {1} or len(traces) != 6:
        raise AssertionError(f"expected one graph for the decode step and "
                             f"each of the 5 buckets, got {traces}")

    ctoks = serve_all(torch, serving_engine(model, "f32", "composed"), specs)
    div = same_tokens(torch, model, prompts, ctoks, toks,
                      "kernel vs composed f32")
    log(f"  kernel f32 tokens == composed f32 tokens ({len(div)} near "
        "ties)")

    for kv in ("bf16", "int8"):
        e = serving_engine(model, kv, "kernel")
        t0 = time.perf_counter()
        out = serve_all(torch, e, specs)
        w = time.perf_counter() - t0
        s2 = e.stats()
        log(f"  kernel {kv}: {sum(map(len, out))} tokens in {w:.3f} s "
            "(captures included)"
            + (f", kv_quant_max_abs_err {s2['kv_quant_max_abs_err']}"
               if kv == "int8" else ""))
        if sum(map(len, out)) != 512:
            raise AssertionError(f"{kv}: {sum(map(len, out))} tokens")
        if kv == "int8" and not s2["kv_quant_max_abs_err"] > 0:
            raise AssertionError("int8 run reported no quantization error")
    return {**res, "graphs_per_entry": traces, "composed_near_ties": div}


def serve_all(torch, eng, specs):
    """Serve ``specs`` to the end; the requests' generated tokens."""
    reqs = [eng.submit(p, **kw) for p, kw in specs]
    eng.run_until_idle()
    torch.cuda.synchronize()
    if any(not r.done for r in reqs):
        raise AssertionError("requests did not finish")
    return [r.tokens for r in reqs]


# ------------------------------------------------------------ phase 5
def decode_work(pos, s, h, d, kv, bs, T=16):
    """Bytes the call must move (each input read once: q, the valid K/V
    rows, their int8 scales, the ``[b, T]`` tables, pos; the output
    written once) and its FLOPs (QK^T and PV over the keys each query row
    sees)."""
    elem = {"f32": 4, "bf16": 2, "int8": 1}[kv]
    b = len(pos)
    keys = sum(p + s for p in pos)
    nbytes = 2 * b * h * s * d * 4 + 2 * keys * h * d * elem \
        + b * T * 4 + b * 4
    if kv == "int8":
        nbytes += 2 * sum(-(-(p + s) // bs) for p in pos) * h * 4
    seen = sum(p + i + 1 for p in pos for i in range(s))
    flops = 4 * h * d * seen
    return nbytes, flops


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


def time_fn(torch, fn, n, copies):
    """Device ms per call of ``fn(i % copies)``: after 3 warm-up calls,
    :func:`device_busy_ms` of ``n`` calls, divided by ``n``. The host's
    time between launches is not counted: a kernel of a few tens of
    microseconds launched from Python would otherwise be timed by the
    host's pace, which differs from machine to machine."""
    for i in range(3):
        fn(i % copies)

    def run():
        for i in range(n):
            fn(i % copies)

    return device_busy_ms(torch, run) / n


def device_busy_ms(torch, run):
    """Device ms of ``run()``: :func:`device_trace`'s busy time."""
    return device_trace(torch, run)[0]


def trace_once(torch, run):
    """``(busy_ms, kernels)`` of ``run()``: ``torch.profiler`` traces it;
    busy_ms is the union of its device intervals (kernels, copies,
    memsets), None when there is none; kernels the count of each kernel
    name."""
    import collections

    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    names = collections.Counter(e["name"] for e in dev
                                if e["cat"] == "kernel")
    busy = busy_us((e["ts"], e["ts"] + e["dur"]) for e in dev) / 1e3
    return (busy if dev else None), names


#: traces :func:`device_trace` takes before it gives up
TRACE_ATTEMPTS = 4


def device_trace(torch, run):
    """:func:`trace_once`, raising where it has no device interval at
    all. Such a trace is taken again, after a pause, up to
    :data:`TRACE_ATTEMPTS` times: the profiler has come back empty now
    and then, twice in a row in some runs, for torch's kernels and the
    port's alike."""
    for attempt in range(TRACE_ATTEMPTS):
        busy, names = trace_once(torch, run)
        if busy is not None:
            return busy, names
        log("  the profiler recorded no device activity"
            + ("; tracing again" if attempt + 1 < TRACE_ATTEMPTS else ""))
        time.sleep(0.5)
    raise AssertionError("the profiler recorded no device activity; "
                         "device time not measured")


#: cycles of the sleep kernel that holds the stream while the host
#: enqueues the work :func:`event_ms` times (~50 ms at the H100's clocks)
SLEEP_CYCLES = 100_000_000


def event_ms(torch, run):
    """Device ms of ``run()`` between two CUDA events on the current
    stream. A sleep kernel holds the stream while the host enqueues the
    start event, ``run()``'s work and the end event, so the events time
    that work back to back on the device, not the host's pace."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    run()
    end.record()
    if end.query():
        raise AssertionError("the sleep ended before the host enqueued the "
                             "work: the events would time the host")
    end.synchronize()
    return start.elapsed_time(end)


def time_kernel(torch, pa, ctr, card):
    """Phase 5: the kernel and its plain version at the serving decode
    shape (b 8, h 16, s 1, d 64, bs 16, T 16, 129 blocks) with pos near
    the end of the 256-token window, f32/bf16/int8 pools; at the
    speculative verify's q_len 5 (spec K 4) on the same pools; at the
    engine's 64-row prefill bucket (b 8, s 64, pos 0, f32); and the f32
    decode at blocks of 8 (T 32: phase 5c's paged engine), cycling over
    8 pool copies (> 50 MB L2 at decode) so each launch finds its pool
    cold, as a layer of the engine does. Beside each time, the kernel's
    read probe (the same walk and copies, no math): what moving the
    call's bytes through this design costs."""
    rng = np.random.RandomState(1)
    pos = [int(p) for p in rng.randint(180, 221, size=8)]
    copies = 8
    out = {}
    # (key, kv dtype, positions, q_len, block size, table width)
    rows = [(kv, kv, pos, 1, 16, 16) for kv in ("f32", "bf16", "int8")]
    rows += [(f"verify_{kv}", kv, pos, SPEC_K + 1, 16, 16)
             for kv in ("f32", "bf16", "int8")]
    rows.append(("prefill", "f32", [0] * 8, 64, 16, 16))
    rows.append(("decode_bs8", "f32", pos, 1, 8, 32))
    for key, kv, ps, s, bs, T in rows:
        q, pools, tables, posv = make_inputs(torch, ps, s, 64, kv, bs=bs,
                                             T=T, seed=7, copies=copies)

        def kern(i):
            kp, vp, ks, vs = pools[i]
            pa.paged_attention(q, kp, vp, tables, posv, k_scale=ks,
                               v_scale=vs)

        def plain(i):
            kp, vp, ks, vs = pools[i]
            pa.paged_attention_plain(q, kp, vp, tables, posv, k_scale=ks,
                                     v_scale=vs)

        def probe(i):
            kp, vp, ks, vs = pools[i]
            pa.read_probe(q, kp, vp, tables, posv, k_scale=ks, v_scale=vs)

        with ctr.aside():
            ms = time_fn(torch, kern, 400, copies)
            plain_ms = time_fn(torch, plain, 40, copies)
            probe_ms = time_fn(torch, probe, 400, copies)
        nbytes, flops = decode_work(ps, s, 16, 64, kv, bs, T)
        t = bound(nbytes, flops, F32_FLOPS)
        pl = pa.plan(*q.shape, bs, T, {"f32": 4, "bf16": 2, "int8": 1}[kv])
        out[key] = {"ms": ms, "plain_ms": plain_ms,
                    "read_probe_ms": probe_ms, **t,
                    "shape": [8, 16, s, 64], "block_size": bs,
                    "route": pl["route"], "splits": pl["ks"],
                    "rows_per_block": pl["rows"]}
        log(f"  {key} (q_len {s}, blocks of {bs}) {kv}: kernel {ms:.4f} ms, "
            "read probe "
            f"{probe_ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"{nbytes} bytes -> bound {t['bound_ms']:.4f} ms "
            f"({t['bound_by']}), {ms / t['bound_ms']:.2f}x the bound; "
            f"route {pl['route']}, ks {pl['ks']}, "
            f"{pl['rows']} rows/block [{card}]")
    return pos, out

# ------------------------------------------------------------ phase 5b
#: ``jax.random`` on the CPU (JAX 0.9.0, partitionable threefry, 64-bit
#: types off), written down here because the card has no jax: keys of
#: PRNGKey(seed), split(PRNGKey(7), 2), split(PRNGKey(123456789), 10),
#: bits(PRNGKey(3), (6,)), the float32 bit patterns of
#: uniform(PRNGKey(3), (6,)), and categorical(PRNGKey(s), GOLDEN_LOGITS)
#: for s = 0..7
PRNG_GOLDEN = {
    "keys": {7: [0, 7], 2 ** 32 + 5: [0, 5], -3: [0, 4294967293],
             123456789: [0, 123456789]},
    "split7_2": [[3625411723, 1954958720], [195045567, 4062205631]],
    "split123_10": [[104406182, 1336039183], [3209854053, 248229405],
                    [1967704197, 330388035], [3699939943, 1761669608],
                    [573595209, 1452428385], [4046794860, 868207677],
                    [1949849609, 1811933505], [1743068516, 1170804389],
                    [2069951250, 737666086], [2591804346, 2366352077]],
    "bits3_6": [318053758, 4029299397, 2787249374, 4190260272, 1195623854,
                2503700069],
    "uniform3_6": [1033349344, 1064315450, 1059463692, 1064944204,
                   1049528200, 1058356078],
    "categorical": [10, 6, 3, 3, 8, 4, 4, 1],
}
GOLDEN_LOGITS = [(i % 5) * 0.25 for i in range(12)]
SPEC_K = 4                      # bench.py:398 (BENCH_SERVING_SPEC)
#: the sampled requests' recipe (per request a seed of its own)
SAMPLED = {"temperature": 0.8, "top_k": 50, "top_p": 0.95}
#: sampler rows: (temperature, top_k, top_p), every pairing of 0.7 / 1.0,
#: top-k 0 / 50 and top-p 0 / 0.9 / 1 over 8 rows
SAMPLER_ROWS = [(0.7, 0, 0.0), (0.7, 50, 0.9), (1.0, 0, 1.0),
                (1.0, 50, 0.0), (0.7, 0, 0.9), (1.0, 50, 0.9),
                (0.7, 50, 1.0), (1.0, 0, 0.9)]
#: a token may differ between the card and the CPU only where the two
#: largest perturbed scores (or an accept draw and its probability) lie
#: this close
SAMPLER_TIE = 1e-5


def check_prng(torch):
    """The threefry port on the card against :data:`PRNG_GOLDEN`, bit for
    bit. Returns the number of values compared."""
    from paddle_tpu_torch import prng
    dev = "cuda"
    got = {"keys": {s: prng.PRNGKey(s, device=dev).tolist()
                    for s in PRNG_GOLDEN["keys"]},
           "split7_2": prng.split(prng.PRNGKey(7, device=dev), 2).tolist(),
           "split123_10": prng.split(prng.PRNGKey(123456789, device=dev),
                                     10).tolist(),
           "bits3_6": prng.random_bits(prng.PRNGKey(3, device=dev),
                                       (6,)).tolist(),
           "uniform3_6": (prng.uniform(prng.PRNGKey(3, device=dev), (6,))
                          .view(torch.int32).long() & 0xFFFFFFFF).tolist()}
    keys = torch.stack([prng.PRNGKey(s, device=dev) for s in range(8)])
    logits = torch.tensor([GOLDEN_LOGITS] * 8, device=dev)
    got["categorical"] = prng.categorical(keys, logits).tolist()
    for name, want in PRNG_GOLDEN.items():
        if got[name] != want:
            raise AssertionError(f"prng {name}: card {got[name]}, JAX {want}")
    n = sum(len(np.ravel(v)) for k, v in PRNG_GOLDEN.items() if k != "keys")
    n += 2 * len(PRNG_GOLDEN["keys"])
    log(f"  prng: {n} values bit-equal to jax.random's (PRNGKey of 4 seeds "
        "past 32 bits and negative included, split, bits, uniform, "
        "categorical)")
    return n


def sampler_inputs(torch, dev, vocab, k):
    """Seeded logits ``[8, vocab]`` and ``[8, k+1, vocab]``, drafts (the
    first half the argmax, so some accept), and the samp tuple of
    :data:`SAMPLER_ROWS` with keys of seeds 1000.. on ``dev``."""
    from paddle_tpu_torch.serving import decoding as dec
    rng = np.random.RandomState(0)
    b = len(SAMPLER_ROWS)
    lg = (rng.randn(b, vocab) * 3).astype(np.float32)
    vl = (rng.randn(b, k + 1, vocab) * 3).astype(np.float32)
    drafts = rng.randint(0, vocab, size=(b, k)).astype(np.int32)
    drafts[: b // 2] = vl[: b // 2, :k].argmax(-1)
    temp, top_k, top_p = (np.asarray(c) for c in zip(*SAMPLER_ROWS))
    keys = np.stack([dec.request_key(1000 + i) for i in range(b)])
    samp = (torch.tensor(temp, dtype=torch.float32, device=dev),
            torch.tensor(top_k, dtype=torch.int32, device=dev),
            torch.tensor(top_p, dtype=torch.float32, device=dev),
            torch.from_numpy(keys.astype(np.int64)).to(dev),
            torch.zeros(b, vocab, device=dev))
    return (torch.from_numpy(lg).to(dev), torch.from_numpy(vl).to(dev),
            torch.from_numpy(drafts).to(dev), samp)


def top2_gaps(torch, prng, keys, logits):
    """The gap between the two largest ``gumbel(key) + logits`` of each
    row: how far a categorical draw is from a tie."""
    top = torch.topk(prng.gumbel(keys, logits.shape[-1:]) + logits, 2).values
    return (top[..., 0] - top[..., 1]).tolist()


def check_sampler(torch):
    """``sample_tokens`` and ``verify_tokens`` (K = :data:`SPEC_K`) on the
    card against the same functions on the CPU, on fixed seeded logits
    at gpt2-medium's vocabulary: keys bit-equal; tokens and accept flags
    equal except where the CPU's decision is within
    :data:`SAMPLER_TIE` of a tie (logged). Returns the near ties."""
    from paddle_tpu_torch import prng
    from paddle_tpu_torch.models.gpt import GPT_CONFIGS
    from paddle_tpu_torch.serving import decoding as dec
    vocab, k = GPT_CONFIGS["gpt2-medium"].vocab_size, SPEC_K
    out = {}
    for dev in ("cpu", "cuda"):
        lg, vl, drafts, samp = sampler_inputs(torch, dev, vocab, k)
        toks, keys = dec.sample_tokens(lg, samp)
        chosen, accept, vkeys = dec.verify_tokens(vl, drafts, samp)
        out[dev] = [t.cpu() for t in (toks, keys, chosen, accept, vkeys)]
    cpu, card = out["cpu"], out["cuda"]
    for i in (1, 4):
        if not torch.equal(cpu[i], card[i]):
            raise AssertionError("sampler keys differ between card and CPU")
    lg, vl, drafts, samp = sampler_inputs(torch, "cpu", vocab, k)
    temp, top_k, top_p, keys, mask = samp
    ties = []
    # sample_tokens: row r draws with the sub-key of its split
    sub = dec.split_keys(keys)[1]
    gaps = top2_gaps(torch, prng, sub, dec.process_logits(lg, temp, top_k,
                                                          top_p))
    for r in (cpu[0] != card[0]).nonzero().flatten().tolist():
        ties.append({"fn": "sample_tokens", "row": r, "gap": gaps[r]})
    # verify_tokens: accept draws, resamples and the bonus draw
    rep = lambda x: torch.repeat_interleave(x, k + 1)   # noqa: E731
    proc = dec.process_logits(vl.reshape(-1, vocab), rep(temp), rep(top_k),
                              rep(top_p)).reshape(len(SAMPLER_ROWS), k + 1,
                                                  vocab)
    subs = prng.split(sub, 2 * (k + 1))
    u = prng.uniform(subs[:, :k])
    p = torch.gather(proc[:, :k].softmax(-1), -1, drafts.long()[..., None])
    resid = proc[:, :k].scatter(-1, drafts.long()[..., None], dec.NEG_MASK)
    draw_gaps = np.asarray(top2_gaps(torch, prng, subs[:, k + 1:2 * k + 1],
                                     resid))
    bonus_gaps = top2_gaps(torch, prng, subs[:, 2 * k + 1], proc[:, k])
    acc_gap = (u - p[..., 0]).abs().numpy()
    for r, j in (cpu[3] != card[3]).nonzero().tolist():
        ties.append({"fn": "verify accept", "row": r, "pos": j,
                     "gap": float(acc_gap[r, j])})
    for r, j in (cpu[2] != card[2]).nonzero().tolist():
        gap = bonus_gaps[r] if j == k else float(
            min(draw_gaps[r, j], acc_gap[r, j]))
        ties.append({"fn": "verify token", "row": r, "pos": j, "gap": gap})
    for t in ties:
        log(f"  sampler near tie: {t}")
        if not t["gap"] < SAMPLER_TIE:
            raise AssertionError(f"sampler: the card and the CPU differ "
                                 f"away from a tie: {t}")
    log(f"  sampler: sample_tokens and verify_tokens (K {k}) on [8, {vocab}]"
        f" at temperatures 0.7/1.0, top-k 0/50, top-p 0/0.9/1: keys "
        f"bit-equal to the CPU's, tokens and accept flags equal "
        f"({len(ties)} near ties)")
    return ties


def bench_prompts(vocab, n, seed):
    """``bench.py:407-411``'s prompts: 4 to 64 tokens (max_prompt at its
    serving geometry, max_len 256) from ``RandomState(seed)``."""
    r = np.random.RandomState(seed)
    return [r.randint(1, vocab, size=r.randint(4, 65)).tolist()
            for _ in range(n)]


def rep_prompts(vocab, n, seed):
    """``bench.py:413-423``'s repetitive-suffix prompts: a random pattern
    of period 2-4 repeated to 8-64 tokens, which the n-gram drafter
    predicts."""
    r = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        period = r.randint(2, 5)
        pat = r.randint(1, vocab, size=period).tolist()
        ln = r.randint(8, 65)
        out.append((pat * (ln // period + 1))[:ln])
    return out


def sampled_specs(prompts, seed0=500, **kw):
    return [(p, dict(SAMPLED, seed=seed0 + i, max_new_tokens=32, **kw))
            for i, p in enumerate(prompts)]


def warm_sampled(torch, eng):
    """Greedy warm-up (every bucket, the greedy graphs), then sampled
    requests, which capture the sampled graphs."""
    warm(torch, eng)
    rng = np.random.RandomState(98)
    vocab = eng.model.cfg.vocab_size
    reqs = [eng.submit(rng.randint(0, vocab, size=n).tolist(),
                       max_new_tokens=4 * eng.megastep, seed=i, **SAMPLED)
            for i, n in enumerate((10, 24))]
    eng.run_until_idle()
    torch.cuda.synchronize()
    assert all(r.done for r in reqs)


def same_bytes(a, b, what):
    if a != b:
        bad = [i for i, (x, y) in enumerate(zip(a, b)) if x != y]
        raise AssertionError(f"{what}: requests {bad} differ")


def sampled_serving(torch, ctr, card):
    """Phase 5b: sampled and speculative serving on gpt2-medium (seed 0,
    f32 pools, phase 4's geometry), every engine on one model, so one
    graph pool serves the phase. The threefry port against JAX's golden
    values and the sampler against its CPU run; 16 sampled requests
    (bench.py's prompts, temperature 0.8, top-k 50, top-p 0.95, a seed
    each) captured and eagerly (byte-identical), again in reverse order
    (byte-identical per seed), and at megastep 8 (byte-identical); the
    greedy and the sampled decode graphs profiled in one engine (TPOT
    p50, kernels and device ms per step); bench.py's repetitive prompts
    at spec K = 4 against K = 0 (greedy tokens equal under phase 4's
    top-2 rule; the verify step launches the paged kernel at q_len 5)."""
    from paddle_tpu_torch import jit
    from paddle_tpu_torch.models import generation
    from paddle_tpu_torch.models.gpt import GPT_CONFIGS, GPTForCausalLM
    n_prng = check_prng(torch)
    ties = check_sampler(torch)
    cfg = GPT_CONFIGS["gpt2-medium"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = GPTForCausalLM(cfg, device="cuda", generator=gen).eval()
    prompts = bench_prompts(cfg.vocab_size, 16, 0)
    specs = sampled_specs(prompts)
    res = {}

    eng = serving_engine(model, "f32", "kernel")
    warm_sampled(torch, eng)
    res["sampled"], toks = drive(torch, ctr, eng, specs, "sampled, captured")
    res["greedy"], _ = drive(torch, ctr, eng, [(p, {"max_new_tokens": 32})
                                               for p in prompts],
                             "greedy, captured")
    back, rtoks = drive(torch, ctr, eng, specs[::-1],
                        "sampled, captured, reverse order")
    same_bytes(toks, rtoks[::-1], "sampled in reverse order")
    with jit.no_capture():
        etoks = serve_all(torch, serving_engine(model, "f32", "kernel"),
                          specs)
    same_bytes(toks, etoks, "sampled, eager vs captured")
    meng = serving_engine(model, "f32", "kernel", megastep=MEGASTEP)
    warm_sampled(torch, meng)
    res[f"sampled_megastep{MEGASTEP}"], mtoks = drive(
        torch, ctr, meng, specs, f"sampled, megastep {MEGASTEP}")
    same_bytes(toks, mtoks, f"sampled, megastep {MEGASTEP} vs 1")
    del meng
    log(f"  sampled tokens: captured == eager == reverse order == megastep "
        f"{MEGASTEP}, byte for byte (16 requests, 512 tokens)")

    prof = {}
    for mode, kw in (("greedy", None), ("sampled", SAMPLED)):
        peng = serving_engine(model, "f32", "kernel")
        warm_sampled(torch, peng)
        prof[mode] = decode_profile(torch, ctr, peng, f"{mode} decode",
                                    sampled=kw)
        peng.run_until_idle()
        del peng
    g, sm = prof["greedy"], prof["sampled"]
    sampler = {"kernels_per_step": sm["graph_kernels"] - g["graph_kernels"],
               "busy_ms_per_step": sm["decode_busy_ms"] - g["decode_busy_ms"],
               "host_ms_per_step": sm["decode_step_ms"] - g["decode_step_ms"]}

    rep = rep_prompts(cfg.vocab_size, 16, 2)
    rspecs = [(p, {"max_new_tokens": 32}) for p in rep]
    spec = {}
    for k in (0, SPEC_K):
        seng = serving_engine(model, "f32", "kernel", spec_tokens=k)
        warm(torch, seng)
        # warm's prompts are random: draft once on a periodic one too
        serve_all(torch, seng, rspecs[:2])
        spec[k], stoks = drive(torch, ctr, seng, rspecs, f"spec K {k}")
        spec[k]["tokens_out"] = stoks
        spec[k]["stats"] = seng.stats()
        del seng
    div = same_tokens(torch, model, rep, spec[0].pop("tokens_out"),
                      spec[SPEC_K].pop("tokens_out"),
                      f"spec K {SPEC_K} vs K 0")
    st = spec[SPEC_K]["stats"]
    if not spec[SPEC_K]["launches"] > 0 or st["spec_proposed"] == 0:
        raise AssertionError(f"spec K {SPEC_K}: no verify launches {st}")
    verify_traces = generation.verify_step_paged(
        model, SPEC_K, "f32", "kernel")["traces"]["count"]
    release_graphs(torch, model)
    del eng, model
    gc.collect()
    torch.cuda.empty_cache()
    out = {"prng_values": n_prng, "sampler_near_ties": ties,
           "serving": res, "profile": prof, "sampler": sampler,
           "spec": {str(k): v for k, v in spec.items()},
           "spec_near_ties": div, "verify_graphs": verify_traces,
           "acceptance_rate": st["spec_acceptance_rate"]}
    log(f"  [{card}] spec K {SPEC_K}: {spec[SPEC_K]['tokens_per_s']:.1f} "
        f"tokens/s against K 0 {spec[0]['tokens_per_s']:.1f} "
        f"({spec[SPEC_K]['tokens_per_s'] / spec[0]['tokens_per_s']:.3f}x), "
        f"acceptance rate {st['spec_acceptance_rate']} "
        f"({st['spec_accepted']} of {st['spec_proposed']} drafts), "
        f"{spec[SPEC_K]['decode_steps']} verify dispatches, "
        f"{spec[SPEC_K]['launches']} paged launches {spec[SPEC_K]['routes']};"
        f" greedy tokens == K 0's ({len(div)} near ties)")
    log(f"  [{card}] TPOT p50 greedy {res['greedy']['tpot_p50_ms']:.3f} ms, "
        f"sampled {res['sampled']['tpot_p50_ms']:.3f} ms; kernels per decode "
        f"step: greedy graph {g['graph_kernels']}, sampled "
        f"graph {sm['graph_kernels']} (the sampler "
        f"{sampler['kernels_per_step']:.0f} kernels, "
        f"{sampler['busy_ms_per_step']:.3f} device ms per step); device busy "
        f"per step {g['decode_busy_ms']:.3f} / {sm['decode_busy_ms']:.3f} ms")
    return out


# ------------------------------------------------------------ phase 5c
BENCH_BLOCK = 8        # bench.py:505 (BENCH_SERVING_BLOCK)


def bench_engine(model, **kw):
    """``bench.py:425-429``'s engine: 8 slots, ``max_len`` 256, the
    flags' defaults otherwise (paged, blocks of 16, the prefix cache on,
    the kernel route)."""
    from paddle_tpu_torch.serving import ServingEngine
    return ServingEngine(model, **{"max_slots": 8, "max_len": 256, **kw})


def greedy_outputs(model, prompts, n_new=32):
    """The tokens ``greedy_search(model, [p], n_new, cache_len=256)``
    generates for each prompt, one call per prompt (``bench.py:446-453``
    at its serving geometry)."""
    from paddle_tpu_torch.models import generation
    return [generation.greedy_search(model, np.asarray([p]),
                                     max_new_tokens=n_new,
                                     cache_len=256)[0, len(p):].tolist()
            for p in prompts]


def offline_generation(torch, model, ids, eos):
    """``sample`` (phase 5b's recipe, seed 5) and ``beam_search`` (beam
    4, ``eos``) of ``ids``, 16 new tokens each: ``(sampled ids, beam ids,
    beam scores)``."""
    from paddle_tpu_torch.models import generation
    sm = generation.sample(model, ids, max_new_tokens=16, seed=5, **SAMPLED)
    bids, bscores = generation.beam_search(model, ids, beam_size=4,
                                           max_new_tokens=16,
                                           eos_token_id=eos)
    torch.cuda.synchronize()
    return sm, bids, bscores


def dense_serving(torch, ctr, card):
    """Phase 5c: ``bench.py:338-538``'s serving block on a fresh seeded
    gpt2-medium (8 slots, ``max_len`` 256, f32, prompts of 4-64 tokens,
    32 new tokens), one model and one graph pool for the phase: the
    default (paged) engine's 32 requests timed against sequential
    ``greedy_search`` (``vs_baseline``), every engine token equal to its
    ``greedy_search`` tokens (near ties logged), neither timed run
    capturing a graph; the dense and the paged engine at equal pool bytes
    on a shared 32-token system prompt (tokens equal; KV bytes per
    request, peak concurrency, prefix hit rate; no port kernel on the
    dense engine, ``num_layers`` paged launches per dispatch at blocks
    of 8); the dense and the paged decode step profiled at 8 rows; dense
    spec K 4 against K 0 on bench.py's repetitive prompts; sampled dense
    requests and offline ``sample`` / ``beam_search``, captured against
    eager. Raises on any failure."""
    from paddle_tpu_torch import jit
    from paddle_tpu_torch.models import generation
    from paddle_tpu_torch.models.gpt import GPT_CONFIGS, GPTForCausalLM
    cfg = GPT_CONFIGS["gpt2-medium"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = GPTForCausalLM(cfg, device="cuda", generator=gen).eval()
    vocab = cfg.vocab_size
    out = {}

    # the engine against sequential greedy_search (bench.py:425-454)
    prompts = bench_prompts(vocab, 32, 0)
    eng = bench_engine(model, max_queue=len(prompts) + 8)
    warm(torch, eng)
    res, etoks = drive(torch, ctr, eng, [(p, {"max_new_tokens": 32})
                                         for p in prompts],
                       "paged engine, 32 requests")
    del eng
    greedy_outputs(model, prompts[:1])            # warm: the b = 1 graph
    cap0 = captures(model)
    ctr.zero()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    seq = greedy_outputs(model, prompts[:8])
    torch.cuda.synchronize()
    seq_ms = (time.perf_counter() - t0) / 8 * 1e3
    if captures(model) != cap0:
        raise AssertionError("the timed greedy_search calls captured "
                             f"{captures(model) - cap0} graphs")
    seq += greedy_outputs(model, prompts[8:])
    ctr.expect(ctr.read(), {}, "greedy_search (dense, composed)")
    ties = same_tokens(torch, model, prompts, seq, etoks,
                       "paged engine vs greedy_search")
    eng_ms = res["wall_s"] / len(prompts) * 1e3
    out["vs_sequential"] = {
        "engine": res, "engine_ms_per_request": eng_ms,
        "sequential_ms_per_request": seq_ms,
        "vs_baseline": seq_ms / eng_ms, "near_ties": ties}
    log(f"  [{card}] engine {res['tokens_per_s']:.1f} tokens/s, "
        f"{eng_ms:.3f} ms per request; sequential greedy_search "
        f"{seq_ms:.3f} ms per request; vs_baseline {seq_ms / eng_ms:.3f}; "
        f"32 engine requests == greedy_search ({len(ties)} near ties), 0 "
        "captures in either timed run")

    # paged against dense at equal pool bytes (bench.py:499-538)
    bs = BENCH_BLOCK
    pool_blocks = 8 * -(-256 // bs) + 1
    sys_len = min(64 - 2, 4 * bs)
    mnt = min(32, 256 - sys_len - 2)
    r = np.random.RandomState(4)
    sysp = r.randint(1, vocab, size=sys_len).tolist()
    nshared = 32
    shared = [sysp + r.randint(1, vocab, size=2).tolist()
              for _ in range(nshared)]
    pspecs = [(p, {"max_new_tokens": mnt}) for p in shared]
    dense = bench_engine(model, paged=False, max_queue=nshared + 8)
    d_run, d_toks = drive(torch, ctr, dense, pspecs, "dense, shared prefix",
                          warmed=False)
    del dense
    paged = bench_engine(model, max_slots=32, max_queue=nshared + 8,
                         paged=True, block_size=bs, num_blocks=pool_blocks,
                         prefix_cache=True)
    p_run, p_toks = drive(torch, ctr, paged, pspecs,
                          f"paged (blocks of {bs}), shared prefix",
                          warmed=False)
    d_peak, p_peak = d_run["peak_active"], p_run["peak_active"]
    pties = same_tokens(torch, model, shared, d_toks, p_toks,
                        "paged vs dense, shared prefix")
    pos_bytes = cfg.num_layers * 2 * cfg.num_heads * cfg.head_dim * 4
    dense_bpr = 256 * pos_bytes
    paged_bpr = paged.cache.blocks_allocated_total * bs * pos_bytes / nshared
    st = paged.stats()
    del paged
    out["paged_vs_dense"] = {
        "workload": f"{sys_len}-token shared system prompt + 2-token "
                    f"suffix x{nshared}",
        "pool_kv_positions": (pool_blocks - 1) * bs, "block_size": bs,
        "dense_kv_bytes_per_request": dense_bpr,
        "paged_kv_bytes_per_request": paged_bpr,
        "kv_bytes_saved": 1 - paged_bpr / dense_bpr,
        "dense_max_concurrent": d_peak, "paged_max_concurrent": p_peak,
        "concurrency_gain": p_peak / max(d_peak, 1),
        "prefix_hit_rate": st["prefix_hit_rate"],
        "prefix_hit_requests": st["prefix_hit_requests"],
        "dense": d_run, "paged": p_run, "near_ties": pties}
    log(f"  [{card}] paged vs dense at {(pool_blocks - 1) * bs} pool "
        f"positions: KV bytes per request {paged_bpr:.0f} vs {dense_bpr} "
        f"(saved {1 - paged_bpr / dense_bpr:.4f}), peak concurrency "
        f"{p_peak} vs {d_peak}, prefix hit rate {st['prefix_hit_rate']} "
        f"({st['prefix_hit_requests']} requests); tokens equal "
        f"({len(pties)} near ties)")

    out["attn"], out["kv_quant"] = attn_and_kv_quant(torch, ctr, card, model)

    # the dense and the paged decode step at 8 rows
    prof = {}
    for mode, paged_kv in (("paged", True), ("dense", False)):
        e = bench_engine(model, paged=paged_kv)
        prof[mode] = decode_profile(torch, ctr, e, f"{mode} decode, 8 rows")
        del e
    out["profile"] = prof
    log(f"  [{card}] decode step at 8 rows, dense vs paged: busy "
        f"{prof['dense']['decode_busy_ms']:.3f} vs "
        f"{prof['paged']['decode_busy_ms']:.3f} ms, idle share "
        f"{prof['dense']['decode_idle_share']:.4f} vs "
        f"{prof['paged']['decode_idle_share']:.4f}, kernels per step "
        f"{prof['dense']['graph_kernels']} vs "
        f"{prof['paged']['graph_kernels']} (graph nodes)")

    # dense spec K 4 against K 0 on the repetitive prompts
    rspecs = [(p, {"max_new_tokens": 32})
              for p in rep_prompts(vocab, 16, 2)]
    spec = {}
    for k in (0, SPEC_K):
        seng = bench_engine(model, paged=False, spec_tokens=k)
        warm(torch, seng)
        serve_all(torch, seng, rspecs[:2])
        spec[k], stoks = drive(torch, ctr, seng, rspecs, f"dense spec K {k}")
        spec[k]["tokens_out"] = stoks
        spec[k]["stats"] = seng.stats()
        del seng
    sties = same_tokens(torch, model, [p for p, _ in rspecs],
                        spec[0].pop("tokens_out"),
                        spec[SPEC_K].pop("tokens_out"),
                        f"dense spec K {SPEC_K} vs K 0")
    sst = spec[SPEC_K]["stats"]
    if sst["spec_proposed"] == 0:
        raise AssertionError(f"dense spec K {SPEC_K}: nothing drafted")
    out["spec"] = {str(k): v for k, v in spec.items()}
    out["spec_near_ties"] = sties
    log(f"  [{card}] dense spec K {SPEC_K}: "
        f"{spec[SPEC_K]['tokens_per_s']:.1f} tokens/s against K 0 "
        f"{spec[0]['tokens_per_s']:.1f}, acceptance rate "
        f"{sst['spec_acceptance_rate']} ({sst['spec_accepted']} of "
        f"{sst['spec_proposed']}); tokens == K 0's ({len(sties)} near "
        "ties)")

    # sampled dense requests, captured against eager
    sspecs = sampled_specs(bench_prompts(vocab, 16, 0))
    ceng = bench_engine(model, paged=False)
    warm_sampled(torch, ceng)
    out["sampled"], ctoks = drive(torch, ctr, ceng, sspecs,
                                  "dense sampled, captured")
    del ceng
    ctr.zero()
    with jit.no_capture():
        etoks = serve_all(torch, bench_engine(model, paged=False), sspecs)
    ctr.expect(ctr.read(), {}, "dense sampled, eager")
    same_bytes(ctoks, etoks, "dense sampled, eager vs captured")
    log("  dense sampled tokens: captured == eager, byte for byte (16 "
        "requests, 512 tokens)")

    # offline generation, captured against eager
    ids = np.random.RandomState(7).randint(1, vocab, size=(2, 12))
    eos = int(generation.greedy_search(model, ids, max_new_tokens=16)[0, 18])
    offline_generation(torch, model, ids, eos)    # warm: captures
    cap0 = captures(model)
    ctr.zero()
    sm, bids, bsc = offline_generation(torch, model, ids, eos)
    if captures(model) != cap0:
        raise AssertionError("offline generation captured again")
    with jit.no_capture():
        esm, ebids, ebsc = offline_generation(torch, model, ids, eos)
    ctr.expect(ctr.read(), {}, "offline generation")
    if not (np.array_equal(sm, esm) and np.array_equal(bids, ebids)):
        raise AssertionError("offline generation: captured ids differ "
                             "from eager ones")
    rel = float(np.max(np.abs(bsc - ebsc) / np.abs(ebsc)))
    if not rel <= 1e-5:
        raise AssertionError(f"beam scores: relative difference {rel}")
    # another capacity at batch 2 frees the old cache and its graphs
    cap, old = model._fixed_caches[2]
    ptrs = {a.data_ptr() for layer in old for a in layer}
    generation.greedy_search(model, ids, max_new_tokens=16,
                             cache_len=cap + 8)
    held = {p for st in generation.decode_step(model)["graphs"].values()
            for k in st.graphs for p, *_ in k[1]}
    if model._fixed_caches[2][0] != cap + 8 or held & ptrs:
        raise AssertionError("a new capacity kept the old offline cache "
                             "or its graphs")
    del old
    out["offline"] = {"sample_ids": sm.tolist(), "beam_ids": bids.tolist(),
                      "beam_scores": bsc.tolist(),
                      "beam_scores_rel_diff": rel, "eos": eos}
    log(f"  offline sample and beam_search (b 2, beam 4, 16 tokens, eos "
        f"{eos}): captured == eager ids, beam scores {bsc.tolist()} within "
        f"{rel:.1e} relative; capacity {cap} -> {cap + 8} at batch 2 freed "
        "the old cache and dropped its graphs")
    release_graphs(torch, model)
    for k in ("_fixed_caches", "_zero_masks"):
        model.__dict__.pop(k, None)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def serve_paged(torch, ctr, model, ps, impl, what, kv="f32", slots=8,
                num_blocks=None, mnt=32, warm_ps=None):
    """``bench.py:545-558``'s ``serve_paged``: a fresh paged engine at
    blocks of 8 with the prefix cache off, every request served to its
    end by hand (``drive``, its peak of requests in flight counted).
    With ``warm_ps`` the engine first serves one prompt per bucket and
    ``warm_ps`` (the bench warms a separate engine, whose compiles the
    reference shares; a port graph holds its engine's pools by address),
    and the timed run must capture nothing. Returns ``(numbers, tokens,
    engine)``."""
    eng = bench_engine(model, max_slots=slots,
                       max_queue=len(ps) + len(WARM_PROMPTS) + slots,
                       paged=True, block_size=BENCH_BLOCK,
                       num_blocks=num_blocks, prefix_cache=False,
                       attn_impl=impl, kv_dtype=kv)
    if warm_ps is not None:
        warm(torch, eng)
        serve_all(torch, eng, [(p, {"max_new_tokens": mnt})
                               for p in warm_ps])
    res, toks = drive(torch, ctr, eng, [(p, {"max_new_tokens": mnt})
                                        for p in ps], what,
                      warmed=warm_ps is not None)
    return res, toks, eng


def attn_and_kv_quant(torch, ctr, card, model):
    """``bench.py:539-633`` as the bench runs it: the kernel route against
    the composed one at blocks of 8 (32 requests from ``RandomState(6)``,
    each route's engine warmed first on 8 prompts from ``RandomState(7)``,
    then timed capturing nothing; tokens equal under the top-2 rule; the
    speedup reported,
    the bench's 1.5x target being the TPU's), and int8 against f32 pools
    of equal bytes (48 uniform 16-token prompts from ``RandomState(8)``,
    48 slots, so the pool is the binding cap: the concurrency gain must
    be at least 1.8x, a scheduling fact). The port runs the int8/f32
    comparison on its default route, the kernel (the bench's engine
    default is JAX's composed route); both pools run B4 at blocks of 8.
    Returns ``(attn, kv_quant)``."""
    cfg = model.cfg
    vocab = cfg.vocab_size
    attn_ps = bench_prompts(vocab, 32, 6)
    warm_ps = bench_prompts(vocab, 8, 7)
    runs, toks = {}, {}
    for impl in ("composed", "kernel"):
        runs[impl], toks[impl], _ = serve_paged(
            torch, ctr, model, attn_ps, impl, f"{impl}, blocks of 8, timed",
            warm_ps=warm_ps)
    ties = same_tokens(torch, model, attn_ps, toks["composed"],
                       toks["kernel"], "kernel vs composed, blocks of 8")
    speedup = runs["kernel"]["tokens_per_s"] / runs["composed"]["tokens_per_s"]
    attn = {"composed_tokens_per_sec": runs["composed"]["tokens_per_s"],
            "kernel_tokens_per_sec": runs["kernel"]["tokens_per_s"],
            "speedup": speedup, "near_ties": ties,
            "kernel": runs["kernel"], "composed": runs["composed"]}
    log(f"  [{card}] kernel vs composed at blocks of 8, 32 requests: "
        f"{runs['kernel']['tokens_per_s']:.1f} vs "
        f"{runs['composed']['tokens_per_s']:.1f} tokens/s, speedup "
        f"{speedup:.3f} (the bench's 1.5x target is TPU-only); tokens "
        f"equal ({len(ties)} near ties); 0 captures in either timed run")

    # int8 against f32 at equal pool bytes (bench.py:595-633)
    bs = BENCH_BLOCK
    hd = cfg.hidden_size // cfg.num_heads
    f32_block_bytes = cfg.num_heads * bs * hd * 4
    int8_block_bytes = cfg.num_heads * (bs * hd + 4)
    L = min(64, 2 * bs)
    mnt8 = min(32, 256 - L)
    blocks_per_req = -(-(L + mnt8) // bs)
    f32_blocks = 8 * blocks_per_req + 1
    int8_blocks = (f32_blocks - 1) * f32_block_bytes // int8_block_bytes + 1
    r = np.random.RandomState(8)
    nq8 = max(32, 6 * 8)
    q_ps = [r.randint(1, vocab, size=L).tolist() for _ in range(nq8)]
    f_run, f_toks, _ = serve_paged(torch, ctr, model, q_ps, "kernel",
                                   "f32 pool, equal bytes", slots=nq8,
                                   num_blocks=f32_blocks, mnt=mnt8)
    q_run, q_toks, q_eng = serve_paged(torch, ctr, model, q_ps, "kernel",
                                       "int8 pool, equal bytes", kv="int8",
                                       slots=nq8, num_blocks=int8_blocks,
                                       mnt=mnt8)
    f_peak, q_peak = f_run["peak_active"], q_run["peak_active"]
    gain = q_peak / max(f_peak, 1)
    if gain < 1.8:
        raise AssertionError(f"int8 concurrency gain {gain:.2f}x < 1.8x at "
                             f"equal pool bytes ({f_peak} -> {q_peak})")
    parity = sum(a == b for a, b in zip(f_toks, q_toks))
    qerr = q_eng.stats()["kv_quant_max_abs_err"]
    del q_eng
    kvq = {"pool_bytes": f32_blocks * f32_block_bytes,
           "f32_blocks": f32_blocks, "int8_blocks": int8_blocks,
           "f32_max_concurrent": f_peak, "int8_max_concurrent": q_peak,
           "concurrency_gain": gain,
           "token_parity_requests": f"{parity}/{nq8}",
           "kv_quant_max_abs_err": qerr, "f32": f_run, "int8": q_run}
    log(f"  [{card}] int8 vs f32 at {f32_blocks * f32_block_bytes} pool "
        f"bytes ({int8_blocks} vs {f32_blocks} blocks of 8): peak "
        f"concurrency {q_peak} vs {f_peak}, gain {gain:.3f} (>= 1.8 "
        f"asserted); token parity {parity}/{nq8} requests; "
        f"kv_quant_max_abs_err {qerr}")
    return attn, kvq


# ------------------------------------------------------------ phase 5d
FLEET_SLOTS, FLEET_NEW, FLEET_LEN = 4, 48, 256   # bench.py:651-653
FLEET_MEGASTEP = 8                               # BENCH_SERVING_MEGASTEP


def fleet(model, **kw):
    """``bench.py:659-661``'s fleet: 2 replicas of ``FLEET_SLOTS`` slots
    at ``max_len`` ``FLEET_LEN``, the flags' defaults otherwise."""
    from paddle_tpu_torch.serving import ReplicaRouter
    kw.setdefault("n_replicas", 2)
    return ReplicaRouter(model, **{"max_slots": FLEET_SLOTS,
                                   "max_len": FLEET_LEN, **kw})


def replica_graphs(model, eng):
    """The graphs of ``model``'s step cache that ``eng`` replays: those
    whose first held tensor is its first pool tensor (address, shape and
    dtype; a graph of a freed pool that matches all three replays
    correctly over this one)."""
    a = eng.cache.arrays()[0][0]
    first = (a.data_ptr(), "tensor", tuple(a.shape), a.dtype)
    return sum(1 for ent in getattr(model, "_step_compile_cache",
                                    {}).values()
               for st in ent.get("graphs", {}).values()
               for key in list(st.graphs) if key[1][0] == first)


def serve_fleet(torch, ctr, rt, specs, what, warmed=True):
    """Serve ``specs`` through the router ``rt`` to the end, launch counts
    zeroed before and read after, each replica's ``step`` timed on the
    host: the tokens and the run's numbers. The launches must be exactly
    ``num_layers`` per prefill or decode dispatch (``n`` per megastep
    dispatch) summed over the replicas; with ``warmed``, nothing may be
    captured."""
    model = rt.engines[0].model
    engines = list(rt.engines)
    d0 = [(e.prefill_dispatches, e.decode_steps, e.megastep_dispatches)
          for e in engines]
    routed0 = [len(e._all) for e in engines]
    step_ms = {i: [] for i in range(len(engines))}
    errors = []
    for i, eng in enumerate(engines):
        def timed(i=i, step=eng.step):
            # the router's watchdog turns a raising step into a strike:
            # record it here, so no failure passes unseen
            t = time.perf_counter()
            try:
                return step()
            except BaseException as e:
                errors.append(f"replica {i}: {e!r}")
                raise
            finally:
                step_ms[i].append((time.perf_counter() - t) * 1e3)
        eng.step = timed
    cap0 = captures(model)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ctr.zero()
    t0 = time.perf_counter()
    reqs = [rt.submit(p, **kw) for p, kw in specs]
    steps = rt.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    run, routes = ctr.read(), ctr.routes()["paged_attention"]
    for eng in engines:
        del eng.step
    new_captures = captures(model) - cap0
    if errors or rt.stats()["kills"]:
        raise AssertionError(f"{what}: replica steps raised {errors}")
    if any(r.state != "done" for r in reqs):
        raise AssertionError(f"{what}: requests did not finish")
    want = 0
    for eng, (p0, s0, m0) in zip(engines, d0):
        want += model.cfg.num_layers * (
            eng.prefill_dispatches - p0 + eng.decode_steps - s0 +
            eng.megastep * (eng.megastep_dispatches - m0))
    ctr.expect(run, {"paged_attention": want}, what)
    if sum(routes.values()) != want:
        raise AssertionError(f"{what}: launches by route {routes} do not "
                             f"add up to {want}")
    if new_captures and warmed:
        raise AssertionError(f"{what}: the timed run captured "
                             f"{new_captures} graphs; the fleet was warmed")
    tokens = sum(len(r.tokens) for r in reqs)
    per = [float(np.percentile(v, 50)) if v else None
           for v in step_ms.values()]
    res = {"tokens": tokens, "wall_s": wall, "tokens_per_s": tokens / wall,
           "router_steps": steps, "launches": want, "routes": routes,
           "captures_in_run": new_captures,
           "replica_step_ms_p50": per,
           "routed_per_replica": [len(e._all) - n
                                  for e, n in zip(engines, routed0)],
           "graphs_per_replica": [replica_graphs(model, e)
                                  for e in engines],
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "peak_reserved_bytes": torch.cuda.max_memory_reserved()}
    log(f"  {what}: {tokens} tokens in {wall:.3f} s "
        f"({tokens / wall:.1f} tokens/s), {steps} router steps, replica "
        f"step p50 {per} ms, {want} paged launches {routes}, "
        f"{new_captures} captures, routed {res['routed_per_replica']}, "
        f"graphs per replica {res['graphs_per_replica']}, peak allocated "
        f"{res['peak_bytes']} B, reserved {res['peak_reserved_bytes']} B")
    return res, [r.tokens for r in reqs]


def fleet_serving(torch, ctr, card):
    """Phase 5d: the replica fleet on a fresh seeded gpt2-medium (f32,
    blocks of 16). ``bench.py:636-725``'s megastep block: 16 prompts of 8
    tokens from ``RandomState(9)``, 48 new tokens each, 2 replicas of 4
    slots, through megastep 1 serially and megastep 8 from a 2-thread
    dispatch pool, each arm warmed, then timed; tokens equal exactly. The
    timed pass reuses the warmed fleet: a graph holds its replica's pools
    by address, so a fresh fleet would capture again (the reference's
    compiles are per model). Then the router half of ``bench.py:775-799``
    (2 replicas of 8 slots, 32 prompts from ``RandomState(4)``, tokens
    equal a single engine's); fresh fleets stepped from threads with no
    warm-up (``start()`` / ``results()`` and ``dispatch_threads=2``),
    whose first captures run while the other replica replays; supervision
    (a kill mid-decode with greedy and sampled requests on the victim,
    three restarts with flat reserved memory, a rolling weight swap);
    and B4 against its plain version at the fleet's shapes."""
    from paddle_tpu_torch import flags
    from paddle_tpu_torch.models.gpt import GPT_CONFIGS, GPTForCausalLM
    from paddle_tpu_torch.ops.cuda import paged_attention as pa
    cfg = GPT_CONFIGS["gpt2-medium"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = GPTForCausalLM(cfg, device="cuda", generator=gen).eval()
    vocab = cfg.vocab_size
    out = {}

    # bench.py:636-725, the megastep block
    r9 = np.random.RandomState(9)
    ms_ps = [r9.randint(1, vocab, size=8).tolist()
             for _ in range(4 * FLEET_SLOTS)]
    ms_specs = [(p, {"max_new_tokens": FLEET_NEW}) for p in ms_ps]
    arms, arm_toks = {}, {}
    try:
        for name, n, threads in (("serial", 1, 0),
                                 ("megastep", FLEET_MEGASTEP, 2)):
            flags.set_flags({"serving_megastep": n,
                             "serving_dispatch_ahead": False,
                             "serving_dispatch_threads": threads})
            rt = fleet(model, max_queue=len(ms_ps) + FLEET_SLOTS)
            serve_fleet(torch, ctr, rt, ms_specs, f"{name} arm, warm-up",
                        warmed=False)
            arms[name], arm_toks[name] = serve_fleet(
                torch, ctr, rt, ms_specs,
                f"{name} arm (megastep {n}, {threads} dispatch threads), "
                "timed")
            rt.stop()
            del rt
    finally:
        flags.set_flags({"serving_megastep": 1,
                         "serving_dispatch_ahead": False,
                         "serving_dispatch_threads": 0})
    same_bytes(arm_toks["serial"], arm_toks["megastep"],
               "megastep 8 + threads vs serial megastep 1")
    speedup = arms["megastep"]["tokens_per_s"] / arms["serial"]["tokens_per_s"]
    out["megastep"] = {"arms": arms, "speedup": speedup,
                       "gate_1_2x_met": speedup >= 1.2}
    log(f"  [{card}] megastep block: serial {arms['serial']['tokens_per_s']:.1f}"
        f" tokens/s, megastep {FLEET_MEGASTEP} + 2 threads "
        f"{arms['megastep']['tokens_per_s']:.1f} tokens/s, speedup "
        f"{speedup:.3f} (bench gate 1.2x {'met' if speedup >= 1.2 else 'missed'}"
        f", reported); tokens equal byte for byte")

    # the router half of bench.py:775-799
    tp_ps = bench_prompts(vocab, 32, 4)
    tp_specs = [(p, {"max_new_tokens": 32}) for p in tp_ps]
    single = bench_engine(model, max_queue=len(tp_ps) + 8)
    s_toks = serve_all(torch, single, tp_specs)
    del single
    rt = fleet(model, max_slots=8, max_queue=len(tp_ps) + 8)
    res, r_toks = serve_fleet(torch, ctr, rt, tp_specs,
                              "router, 2 replicas x 8 slots (captures "
                              "included, as the bench times it)",
                              warmed=False)
    rt.stop()
    del rt
    ties = same_tokens(torch, model, tp_ps, s_toks, r_toks,
                       "router vs single engine")
    out["router"] = {**res, "near_ties": ties}
    log(f"  [{card}] router: {res['tokens_per_s']:.1f} tokens/s, "
        f"routed_per_replica {res['routed_per_replica']}; tokens == a "
        f"single engine's ({len(ties)} near ties)")

    # threads with no warm-up: first captures while the other replays
    ref = arm_toks["serial"]
    rt = fleet(model, max_queue=len(ms_ps) + FLEET_SLOTS)
    rt.start()
    try:
        reqs = [rt.submit(p, **kw) for p, kw in ms_specs]
        started = [r.tokens for r in rt.results(reqs, timeout=120)]
    finally:
        rt.stop()
    del rt, reqs
    t_ties = same_tokens(torch, model, ms_ps, ref, started,
                         "fresh fleet on background threads vs serial")
    rt = fleet(model, max_queue=len(ms_ps) + FLEET_SLOTS,
               dispatch_threads=2)
    thr, thr_toks = serve_fleet(torch, ctr, rt, ms_specs,
                                "fresh fleet, 2 dispatch threads, no "
                                "warm-up", warmed=False)
    rt.stop()
    del rt
    d_ties = same_tokens(torch, model, ms_ps, ref, thr_toks,
                         "fresh threaded fleet vs serial")
    out["threads_unwarmed"] = {"start_near_ties": t_ties,
                               "dispatch": thr, "dispatch_near_ties": d_ties}
    log(f"  [{card}] unwarmed fleets: start()/results() and 2 dispatch "
        f"threads == serial tokens ({len(t_ties)} / {len(d_ties)} near "
        f"ties), captured {thr['captures_in_run']} graphs while the "
        "other replica replayed, no capture error")

    out["supervision"] = fleet_supervision(torch, ctr, card, model, ms_ps)

    # B4 at the fleet's shapes against its plain version
    rng = np.random.RandomState(5)
    dec4 = [int(p) for p in rng.randint(8, 56, size=FLEET_SLOTS)]
    dec8 = [int(p) for p in rng.randint(4, 96, size=8)]
    cases = [("fleet decode s=1 b=4 f32", dec4, 1, 64, "f32", 16),
             ("fleet prefill s=16 b=4 f32", [0] * FLEET_SLOTS, 16, 64,
              "f32", 16),
             ("fleet decode s=1 b=8 f32", dec8, 1, 64, "f32", 16),
             ("fleet prefill s=64 b=8 3 live f32", [0] * 8, 64, 64, "f32",
              16, 3)]
    with ctr.aside():
        worst = max(check_kernel_case(torch, pa, 100 + i, *c)
                    for i, c in enumerate(cases))
    out["kernel_cases"] = len(cases)
    out["kernel_max_abs_err"] = worst
    log(f"  B4 vs plain at the fleet's shapes: {len(cases)} cases, max abs "
        f"err {worst:.3e}")
    release_graphs(torch, model)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def fleet_supervision(torch, ctr, card, model, prompts):
    """Kill, restart and swap on the card: a replica killed mid-decode
    with greedy and sampled requests on it (greedy tokens equal an
    unkilled run's under the top-2 rule, sampled ones counted; no block
    leaked on any pool); three ``restart_replica`` cycles, each followed
    by a serve, with ``memory_reserved`` flat after the first (the
    killed replica's pools and graphs are freed); a rolling
    ``swap_weights`` whose tokens equal a fresh fleet's on the new
    weights."""
    specs = [(p, dict(max_new_tokens=FLEET_NEW,
                      **(dict(SAMPLED, seed=700 + i) if i % 2 else {})))
             for i, p in enumerate(prompts[:8])]
    rt = fleet(model, max_queue=24)
    ref = serve_all(torch, rt, specs)
    rt.stop()
    del rt
    rt = fleet(model, max_queue=24)
    reqs = [rt.engines[0].submit(p, **kw) for p, kw in specs]
    for _ in range(6):
        rt.engines[0].step()
    inflight = [len(r.tokens) for r in reqs]
    info = rt.kill_replica(0)
    rt.run_until_idle()
    torch.cuda.synchronize()
    got = [r.tokens for r in reqs]
    greedy = [i for i in range(len(specs)) if i % 2 == 0]
    ties = same_tokens(torch, model, [prompts[i] for i in greedy],
                       [ref[i] for i in greedy], [got[i] for i in greedy],
                       "greedy requests re-homed off a killed replica")
    sampled_equal = sum(got[i] == ref[i] for i in range(1, len(specs), 2))
    for eng in rt.engines + rt._retiring:
        eng.cache.flush_prefix_cache()
        if eng.cache.allocator.leaked() != 1:
            raise AssertionError("a pool leaked blocks after the kill")
    kill = {"info": info, "inflight_tokens": inflight, "near_ties": ties,
            "sampled_equal": f"{sampled_equal}/{len(specs) // 2}"}
    log(f"  [{card}] kill mid-decode (in flight {inflight}): {info}; "
        f"greedy == unkilled ({len(ties)} near ties), sampled equal "
        f"{kill['sampled_equal']}; every pool leaked() == 1")

    # reserved memory after each cycle, the allocator's free cache
    # returned first (every capture empties it too, so only what is held
    # compares): the killed replica's pools and graphs must be freed
    reserved, graphs = [], []
    small = [(p, {"max_new_tokens": 8}) for p in prompts[:4]]
    for cycle in range(3):
        rt.restart_replica(0)
        serve_all(torch, rt, small)
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reserved.append(torch.cuda.memory_reserved())
        graphs.append(sum(len(st.graphs) for ent in
                          model._step_compile_cache.values()
                          for st in ent.get("graphs", {}).values()))
    if max(reserved[1:]) > reserved[0] or max(graphs[1:]) > graphs[0]:
        raise AssertionError(f"restart cycles grew reserved memory "
                             f"{reserved} or graphs {graphs}")
    log(f"  [{card}] three restart_replica cycles: memory_reserved "
        f"{reserved} B, graphs in the step cache {graphs}")

    gen = torch.Generator(device="cuda").manual_seed(11)
    new = {name: p.detach() + 0.01 * torch.randn(p.shape, device=p.device,
                                                 generator=gen)
           for name, p in model.named_parameters()}
    greedy_specs = [(p, {"max_new_tokens": 32}) for p in prompts[:8]]
    versions = rt.swap_weights(new)
    swapped = serve_all(torch, rt, greedy_specs)
    rt.stop()
    del rt
    fresh = fleet(model, max_queue=24)
    fresh_toks = serve_all(torch, fresh, greedy_specs)
    fresh.stop()
    del fresh
    sties = same_tokens(torch, model, prompts[:8], fresh_toks, swapped,
                        "rolling swap vs a fresh fleet")
    log(f"  [{card}] rolling swap_weights: versions {versions}; tokens == "
        f"a fresh fleet's on the new weights ({len(sties)} near ties)")
    return {"kill": kill, "restart_reserved_bytes": reserved,
            "restart_graphs": graphs, "swap_versions": versions,
            "swap_near_ties": sties}


# ------------------------------------------------------------ phase 6
#: half a unit in the last place of each 16-bit output, relative
HALF_ULP = {"bf16": 2.0 ** -8, "f16": 2.0 ** -11}


def close(out, ref, kind, tol):
    """(max abs err, ok), element by element: f32 as the JAX tests hold
    it, |out - ref| <= tol (1 + |ref|). The plain side runs in f32 on
    the same bf16 (fp16) values, and the kernel computes in f32 and
    rounds each output to nearest once, which adds at most half a unit
    in the last place, u |out| with u = 2^-8 (2^-11): so bf16 and fp16
    are held to (1 + u) tol (1 + |ref|) + u |ref|, which a truncated
    output fails."""
    diff = (out.float() - ref.float()).abs()
    mag = ref.float().abs()
    if kind == "f32":
        limit = tol * (1 + mag)
    else:
        u = HALF_ULP[kind]
        limit = (1 + u) * tol * (1 + mag) + u * mag
    return float(diff.max()), bool((diff <= limit).all())


def close_rounded(out, ref, tol, rounding):
    """(max abs err, ok) for a bf16 output of the tensor-core route, which
    rounds P (or dS) to bf16 before the second product, as every
    FlashAttention does: :func:`close`'s bf16 bound plus 2^-8 ``rounding``,
    element by element, where ``rounding`` is that product taken over the
    magnitudes (P @ |V| for O, P^T @ |dO| for dV, |dS|^T @ |scale q| for
    dK; :func:`rounding_terms`). Rounding to nearest moves each element of
    P by at most 2^-9 of itself; 2^-8 leaves room for the online
    softmax's rescale. That bound is wide enough to take a truncated
    output, so the errors must also be unbiased: their mean, signed
    towards |ref| and taken in units of the bound, within +-0.03 (round to
    nearest gives ~0.002; truncating the f32 result gives -0.07 to -0.12
    in ``tests/test_torch_flash_route.py``). A kernel that skips a tile
    or truncates fails."""
    diff = out.float() - ref.float()
    mag = ref.float().abs()
    u = 2.0 ** -8
    limit = (1 + u) * tol * (1 + mag) + u * mag + u * rounding
    bias = float((diff * ref.float().sign() / limit).mean())
    return (float(diff.abs().max()),
            bool((diff.abs() <= limit).all()) and abs(bias) <= 0.03)


def rounding_terms(fa, q, k, v, do, lse, delta, causal, scale):
    """``(P @ |V|, P^T @ |dO|, |dS|^T @ |scale q|, |dS| @ |K| scale)`` in
    f32 from the plain versions' P = exp(S - lse) and dS = P (dO V^T -
    delta): the magnitudes that :func:`close_rounded` scales for O, dV,
    dK and dQ."""
    q, k, v, do = (t.float() for t in (q, k, v, do))
    p = (fa._scores(q, k, causal, scale) - lse[..., None]).exp()
    ds = p * (do @ v.transpose(-1, -2) - delta[..., None])
    return (p @ v.abs(), p.transpose(-1, -2) @ do.abs(),
            ds.abs().transpose(-1, -2) @ (q * scale).abs(),
            ds.abs() @ k.abs() * scale)


def packed_rounding(fa, fp2, q, k, v, causal, scale):
    """P @ |V| of each head of head-pair slabs ``[bh/2, s, 2d]``, in
    their layout: the magnitude that :func:`close_rounded` scales for the
    packed forward's O."""
    q, k, v = (fp2.unpack_pairs(t.float()) for t in (q, k, v))
    p = fa._scores(q, k, causal, scale).softmax(-1)
    return fp2.pack_pairs((p @ v.abs())[None])


def hold(checks, worst, what):
    """Each ``(kernel, name, out, ref, kind, tol[, rounding])`` finite and
    within :func:`close` (or :func:`close_rounded` where a rounding term
    is given), else raise; each kernel's max error is kept in ``worst``.
    Returns the errors for the log."""
    errs = []
    for kernel, name, out, ref, kind, tol, *rounding in checks:
        if not bool(out.isfinite().all()):
            raise AssertionError(f"{what}: non-finite {name}")
        if rounding and rounding[0] is not None:
            err, ok = close_rounded(out, ref, tol, rounding[0])
        else:
            err, ok = close(out, ref, kind, tol)
        if not ok:
            raise AssertionError(f"{what}: {name} off by {err}")
        worst[kernel] = max(worst[kernel], err)
        errs.append(f"{name} {err:.1e}")
    return ", ".join(errs)


def flash_inputs(torch, bh, s_q, s_k, d, dt, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    dtype = {"f32": torch.float32, "bf16": torch.bfloat16,
             "f16": torch.float16}[dt]
    return [torch.randn(bh, s, d, device="cuda", generator=g).to(dtype)
            for s in (s_q, s_k, s_k, s_q)]


def check_flash(torch, fa, ctr):
    """Phase 6: each flash kernel against its plain function: first two
    small cases (bh 2, s 64, bf16, d 64 and 128: the tensor-core kernels'
    first launches, synchronized), then at b 8 x h 16: causal and not,
    f32 and bf16, d 20 / 64 / 128, s 1024 / 1040 (a ragged last 64-row
    tile), non-causal s_q != s_k (1040 x 512 and 512 x 1040 on the
    tensor-core route), and last fp16 on the CUDA-core route, causal and
    not, d 20 / 64 / 128. The backward kernels and their plain versions get
    the same lse and delta. bf16 O, dQ, dK and dV of the tensor-core route
    are held to :func:`close_rounded`, everything else to :func:`close`."""
    cases = [("bf16", True, 64, 64, 64, 2), ("bf16", False, 128, 64, 64, 2)]
    cases += [(dt, causal, d, s, s, 128) for dt in ("f32", "bf16")
              for causal in (True, False) for d in (20, 64, 128)
              for s in (1024, 1040)]
    cases += [("f32", False, 64, 1024, 2048, 128),
              ("bf16", False, 64, 1040, 512, 128),
              ("bf16", False, 64, 512, 1040, 128),
              ("bf16", False, 128, 1040, 512, 128),
              ("bf16", False, 128, 512, 1040, 128)]
    cases += [("f16", True, 64, 1024, 1024, 128),
              ("f16", False, 128, 1040, 1040, 128),
              ("f16", True, 20, 1040, 1040, 128),
              ("f16", False, 64, 1040, 512, 128)]
    # seeds: the 26 cases of PR 2 keep theirs (100 + their index there)
    seeds = [98, 99] + list(range(100, 126)) + [126, 127, 128] + \
        [129, 130, 131, 132]
    worst = {name: 0.0 for name in fa.launches}
    with ctr.aside():
        for i, (case, seed) in enumerate(zip(cases, seeds)):
            check_flash_case(torch, fa, ctr, i, *case, seed, worst)
    return len(cases), worst


def check_flash_case(torch, fa, ctr, i, dt, causal, d, s_q, s_k, bh, seed,
                     worst):
    """One case of phase 6; ``worst`` collects each kernel's max error.
    The library's route rule must agree with the wrapper's, and each
    kernel must launch on that route; the card is synchronized after each
    launch, so a fault shows at the kernel that made it."""
    q, k, v, do = flash_inputs(torch, bh, s_q, s_k, d, dt, seed=seed)
    scale = 1.0 / d ** 0.5
    tc = fa._tc_route(q.dtype, d)
    if bool(fa._lib().flash_tc_route(fa._CODES[q.dtype], d)) != tc:
        raise AssertionError(f"flash case {i}: the library's route for "
                             f"{dt} d={d} differs from _tc_route's {tc}")
    before = ctr.routes()
    o, lse = fa.flash_fwd(q, k, v, causal, scale)
    torch.cuda.synchronize()
    delta = (do.float() * o.float()).sum(-1)
    dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, causal, scale)
    torch.cuda.synchronize()
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal, scale)
    torch.cuda.synchronize()
    route = "wgmma" if tc else "simt"
    after = ctr.routes()
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        if after[name][route] != before[name][route] + 1:
            raise AssertionError(f"flash case {i}: {name} did not launch on "
                                 f"the {route} route ({before} -> {after})")
    f = [t.float() for t in (q, k, v, do)]
    ro, rlse = fa.flash_fwd_plain(*f[:3], causal, scale)
    rdq = fa.flash_bwd_dq_plain(*f, lse, delta, causal, scale)
    rdk, rdv = fa.flash_bwd_dkv_plain(*f, lse, delta, causal, scale)
    r_o = r_dv = r_dk = r_dq = None
    if tc:
        r_o, r_dv, r_dk, r_dq = rounding_terms(fa, q, k, v, do, lse, delta,
                                               causal, scale)
    torch.cuda.synchronize()
    # lse is f32 on both sides whatever the input dtype
    checks = [("flash_fwd", "o", o, ro, dt, 2e-5, r_o),
              ("flash_fwd", "lse", lse, rlse, "f32", 2e-5),
              ("flash_bwd_dq", "dq", dq, rdq, dt, 2e-4, r_dq),
              ("flash_bwd_dkv", "dk", dk, rdk, dt, 2e-4, r_dk),
              ("flash_bwd_dkv", "dv", dv, rdv, dt, 2e-4, r_dv)]
    errs = hold(checks, worst, f"flash case {i} ({dt} causal={causal} "
                f"d={d} s_q={s_q} s_k={s_k} bh={bh})")
    log(f"  case {dt:4s} causal={causal!s:5s} d={d:3d} s_q={s_q} "
        f"s_k={s_k} bh={bh} {route}: {errs}")


# ------------------------------------------------------------ phase 7
GPT_BATCH, GPT_SEQ = 8, 1024        # bench.py's GPT step
ERNIE_BATCH, ERNIE_SEQ = 16, 512    # bench.py's ERNIE step (:1249, :1254)


def model_flops_per_token(h, f, L, V, seq: int) -> float:
    """Forward matmul FLOPs per token x3 (backward = 2x forward): the
    port's copy of ``bench.py:59-65`` (GPT) and ``:175-179`` (ERNIE)."""
    per_layer = 8 * h * h + 4 * h * f + 4 * seq * h  # qkv+out, ffn, attn
    fwd = L * per_layer + 2 * h * V                  # + tied LM head
    return 3.0 * fwd


def _stepper(model, opt, loss_of):
    """``step(part)``: the forward ``loss_of()``, clear, backward and
    AdamW, each inside ``part(name)``; returns the loss."""
    def step(part=lambda name: contextlib.nullcontext()):
        with part("forward"):
            loss = loss_of()
        opt.clear_grad()
        with part("backward"):
            loss.backward()
        with part("optimizer"):
            opt.step()
        return loss.detach()
    step.opt = opt
    return step


def train_step(torch, batch=GPT_BATCH, seq=GPT_SEQ):
    """``bench.py``'s train step on gpt2-medium (random weights from seed
    0) and one numpy-seeded batch: forward with labels under AMP O2 bf16,
    clear, backward, AdamW (lr 1e-4, bf16 moments). Returns ``(cfg,
    model, loss_of, step)``: ``loss_of()`` is the forward alone;
    ``step(part)`` runs one step with its forward, backward and
    optimizer each inside ``part(name)`` and returns the loss.
    ``tools/torch_train_profile.py`` traces this same step."""
    from paddle_tpu_torch.amp import auto_cast
    from paddle_tpu_torch.models.gpt import GPT_CONFIGS, GPTForCausalLM
    from paddle_tpu_torch.optimizer import AdamW
    cfg = GPT_CONFIGS["gpt2-medium"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = GPTForCausalLM(cfg, device="cuda", generator=gen)
    opt = AdamW(learning_rate=1e-4, parameters=model.named_parameters(),
                moment_dtype="bfloat16")
    rng = np.random.RandomState(0)
    ids_np = rng.randint(0, cfg.vocab_size, (batch, seq))
    ids = torch.from_numpy(ids_np).cuda()
    labels = torch.from_numpy(np.roll(ids_np, -1, axis=1)).cuda()

    def loss_of():
        with auto_cast(level="O2"):
            return model(ids, labels=labels)

    return cfg, model, loss_of, _stepper(model, opt, loss_of)


def compare_routes(torch, model, loss_of, flag):
    """One forward+backward with ``flag`` on (the kernel route) and one
    with it off (the composed route) from the same weights; raises unless
    the losses agree within 1e-2 relative and each gradient within 5e-2
    relative Frobenius. A key projection's bias (ERNIE's ``k_proj.bias``)
    shifts every logit of a row alike, so its true gradient is zero and
    both routes hold rounding noise: it is held to 5e-2 of the norm of
    its query bias's gradient. Leaves ``flag`` on."""
    from paddle_tpu_torch import flags
    ref = {}
    for use in (True, False):
        flags.set_flags({flag: use})
        model.zero_grad(set_to_none=True)
        loss = loss_of()
        loss.backward()
        ref[use] = (float(loss.detach()),
                    {n: p.grad.detach().clone()
                     for n, p in model.named_parameters()
                     if p.grad is not None})
    flags.set_flags({flag: True})
    (lf, gf), (lc, gc) = ref[True], ref[False]
    if set(gf) != set(gc):
        raise AssertionError(f"the routes grade other parameters: "
                             f"{sorted(set(gf) ^ set(gc))}")
    rel_loss = abs(lf - lc) / abs(lc)
    rel_grad = {}
    for n in gc:
        den = float(gc[n.replace("k_proj.bias", "q_proj.bias")].norm())
        rel_grad[n] = (float((gf[n] - gc[n]).norm()) / den if den
                       else float(gf[n].norm()))
    worst = max(rel_grad, key=rel_grad.get)
    log(f"  {flag} on vs off (O2, one forward+backward): loss {lf} vs {lc} "
        f"(rel {rel_loss:.2e}); worst grad rel Frobenius "
        f"{rel_grad[worst]:.2e} ({worst})")
    if rel_loss > 1e-2:
        raise AssertionError(f"kernel-route loss {lf} vs composed {lc}")
    bad = {n: e for n, e in rel_grad.items() if e > 5e-2}
    if bad:
        raise AssertionError(f"gradients off by > 5e-2 relative: {bad}")
    del ref, gf, gc
    model.zero_grad(set_to_none=True)
    torch.cuda.empty_cache()
    return {"loss_kernel": lf, "loss_composed": lc, "rel_loss": rel_loss,
            "worst_grad_rel": rel_grad[worst], "worst_grad_param": worst}


#: the kernel each counted launch runs, by the name a profiler trace
#: gives it (the flash kernels on the tensor-core route, which every
#: train step of this script takes)
TRACE_NAMES = {"flash_fwd": "flash_fwd_wgmma_kernel",
               "flash_bwd_dq": "flash_bwd_dq_wgmma_kernel",
               "flash_bwd_dkv": "flash_bwd_dkv_wgmma_kernel",
               "ln_fwd": "ln_fwd_kernel", "ln_bwd": "ln_bwd_kernel",
               "adamw": "adamw_multi_kernel"}


def trace_counts(names, traced):
    """The kernels of :data:`TRACE_NAMES` per step in a profiler trace of
    ``traced`` steps (``names``: kernel name -> count)."""
    return {k: sum(n for name, n in names.items() if pat in name) / traced
            for k, pat in TRACE_NAMES.items()}


def traced_steps(torch, ctr, run, traced, per_step, what):
    """``run()`` (``traced`` steps) under :func:`device_trace`: ``(device
    busy ms per step, kernels per step in all, the kernels of
    :data:`TRACE_NAMES` per step)``. The latter must be the launch counts
    per step ``per_step``: for a captured step this shows that a replay
    runs what the counters (the capture's recorded deltas) say. The
    profiler has dropped a few dozen kernels at the start of a trace (once
    in ~25 traces): a trace that disagrees is logged and taken again,
    once; a second disagreement raises."""
    for attempt in range(2):
        with ctr.aside():
            busy, names = device_trace(torch, run)
        counts = trace_counts(names, traced)
        bad = {k: (counts[k], per_step.get(k, 0)) for k in TRACE_NAMES
               if counts[k] != per_step.get(k, 0)}
        if not bad:
            return busy / traced, sum(names.values()) / traced, counts
        log(f"  {what}: kernels per step in the trace vs the launch counts "
            f"{bad}, {sum(names.values()) / traced:.1f} kernels per step in "
            "all" + ("; tracing again" if attempt == 0 else ""))
    raise AssertionError(f"{what}: kernels per step in two traces differ "
                         f"from the launch counts: {bad}")


def run_steps(torch, ctr, step, warmup, steps, want, what, traced=2,
              keep_final=None):
    """``warmup`` steps, then ``steps`` timed steps with every launch
    count zeroed before and read after: the counts must be exactly
    ``want``, the losses finite and the last below the first. Then
    ``traced`` more steps under ``torch.profiler`` give the device's busy
    ms per step and its idle share of the timed step (the profiler slows
    the host, not the device, so the share is taken against the
    untraced step time), and the kernels the trace saw per step must be
    the counts per step: for a captured step this shows that a replay
    runs what the counters say. ``keep_final``: a module whose
    parameters are cloned after the timed steps (``final``)."""
    for _ in range(warmup):
        step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ctr.zero()
    t0 = time.perf_counter()
    losses = [step() for _ in range(steps)]
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / steps
    run = ctr.read()
    routes = ctr.routes()
    peak = torch.cuda.max_memory_allocated()
    reserved = torch.cuda.max_memory_reserved()
    final = None if keep_final is None else [
        p.detach().clone() for p in keep_final.parameters()]
    losses = [float(x) for x in losses]
    log(f"  {what}: launches in {steps} timed steps: {run}")
    ctr.expect(run, want, what)
    log(f"  {what}: losses {losses}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"{what}: timed losses not finite and falling: "
                             f"{losses}")
    busy, kernels, traced_counts = traced_steps(
        torch, ctr, lambda: [step() for _ in range(traced)], traced,
        {k: v / steps for k, v in run.items() if v}, what)
    idle = 1.0 - busy / (dt * 1e3)
    log(f"  {what}: device busy {busy:.3f} ms per step ({traced} traced "
        f"steps), idle share {idle:.4f} of the {dt * 1e3:.3f} ms step; "
        f"kernels per step in the trace {traced_counts}, "
        f"{kernels:.0f} kernels per step in all")
    return {"step_ms": dt * 1e3, "losses": losses, "launches": run,
            "routes": routes, "peak_bytes": peak,
            "peak_reserved_bytes": reserved, "device_busy_ms": busy,
            "idle_share": idle, "kernels_per_step": kernels,
            "traced_counts": traced_counts, "final": final}


def expect_flash_routes(routes, n, what, n_fwd=None):
    """Raise unless the launches of each flash kernel (``n`` each,
    ``n_fwd`` of the forward when it differs) took the tensor-core
    route, as the train steps' shapes (bf16, d 64 or 128) ask."""
    counts = {"flash_fwd": n if n_fwd is None else n_fwd,
              "flash_bwd_dq": n, "flash_bwd_dkv": n}
    want = {name: {"wgmma": c, "simt": 0} for name, c in counts.items()}
    got = {name: routes.get(name) for name in want}
    log(f"  {what}: flash launches by route {got}")
    if got != want:
        raise AssertionError(f"{what}: flash launches by route {got}, "
                             f"expected {want}")


def captured_run(torch, ctr, model, loss_of, start, want, what, warmup=3,
                 steps=5, retain_grads=True):
    """:func:`run_steps` of the :func:`_stepper` step through
    ``jit.to_static``, from the weights ``start`` and a fresh AdamW (lr
    1e-4, bf16 moments), as the eager run it is compared with began. With
    ``retain_grads`` (``bench.py``'s GPT and ERNIE steps keep their
    gradients) the first two calls run eagerly (the second finds the
    gradients the first left, a new key) and the third captures, so the
    timed calls are replays. The graph is freed on return."""
    from paddle_tpu_torch import jit
    from paddle_tpu_torch.optimizer import AdamW
    with torch.no_grad():
        for p, s in zip(model.parameters(), start):
            p.copy_(s)
    model.zero_grad(set_to_none=True)
    opt = AdamW(learning_rate=1e-4, parameters=model.named_parameters(),
                moment_dtype="bfloat16")
    fast = jit.to_static(_stepper(model, opt, loss_of), layers=[model],
                         optimizers=[opt], retain_grads=retain_grads)
    res = run_steps(torch, ctr, fast, warmup, steps, want, what,
                    keep_final=model)
    res["graphs"] = len(fast._step.graphs)
    del fast, opt
    model.zero_grad(set_to_none=True)
    torch.cuda.empty_cache()
    return res


def compare_runs(torch, eager, captured, what):
    """The captured run against the eager one from the same weights and
    optimizer state: the timed losses and the parameters after them must
    be bit-equal. Were they not (cuBLAS may pick another algorithm for a
    product under capture, and its sums round differently), the largest
    differences are printed and the losses held to 1e-5 relative."""
    la, lb = eager.pop("final"), captured.pop("final")
    same = [torch.equal(a, b) for a, b in zip(la, lb)]
    diff = max(float((a - b).abs().max()) for a, b in zip(la, lb))
    loss_rel = max(abs(a - b) / abs(a) for a, b in zip(eager["losses"],
                                                       captured["losses"]))
    equal = all(same) and eager["losses"] == captured["losses"]
    if equal:
        log(f"  {what}: the captured run's {len(eager['losses'])} losses and "
            f"{len(same)} parameters are bit-equal to the eager run's")
    else:
        log(f"  {what}: captured vs eager NOT bit-equal: {sum(same)} of "
            f"{len(same)} parameters equal, largest parameter difference "
            f"{diff:.3e}, largest loss difference {loss_rel:.3e} relative "
            "(a product under capture may run another cuBLAS algorithm); "
            "held to 1e-5 relative on the loss")
        if loss_rel > 1e-5:
            raise AssertionError(f"{what}: captured losses "
                                 f"{captured['losses']} vs eager "
                                 f"{eager['losses']}")
    return {"bit_equal": equal, "params_equal": sum(same),
            "params": len(same), "max_param_diff": diff,
            "max_loss_rel": loss_rel}


def rate(res, tokens, flops_per_token):
    """Adds tokens/s and MFU (over 989 TFLOP/s bf16 dense) to ``res``."""
    res["tokens_per_s"] = tokens / (res["step_ms"] / 1e3)
    res["mfu"] = flops_per_token * res["tokens_per_s"] / BF16_FLOPS
    return res


def gpt_flops(cfg):
    return model_flops_per_token(cfg.hidden_size, cfg.ffn_hidden_size,
                                 cfg.num_layers, cfg.vocab_size, GPT_SEQ)


def memory_line(res):
    return (f"max_memory_allocated {res['peak_bytes']} B, "
            f"max_memory_reserved {res['peak_reserved_bytes']} B")


def eager_vs_captured(card, what, eager, captured):
    for label, r in (("eager", eager), ("to_static", captured)):
        log(f"  [{card}] {what} {label}: step {r['step_ms']:.3f} ms, device "
            f"busy {r['device_busy_ms']:.3f} ms, idle share "
            f"{r['idle_share']:.4f}, {r['tokens_per_s']:.1f} tokens/s, MFU "
            f"{r['mfu'] * 100:.3f}%, {r['kernels_per_step']:.0f} kernels "
            f"per step, {memory_line(r)}")


def train(torch, ctr, card, gpt, warmup=3, steps=5):
    """Phase 7: the train step of :func:`train_step`. First one
    forward+backward with the flash route against the composed route
    from the same weights; then warm-up steps, the timed steps (each
    flash kernel launched once per layer and step, one AdamW launch per
    step, nothing else), and one step timed by part; then the same
    warm-up and timed steps through ``jit.to_static`` from the same
    starting weights and a fresh optimizer, as a CUDA graph: the same
    launches per replay, and losses and parameters bit-equal to the
    eager run's."""
    cfg, model, loss_of, step = gpt
    cmp = compare_routes(torch, model, loss_of, "use_pallas_attention")
    start = [p.detach().clone() for p in model.parameters()]
    n = cfg.num_layers * steps
    want = {"flash_fwd": n, "flash_bwd_dq": n, "flash_bwd_dkv": n,
            "adamw": steps}
    res = run_steps(torch, ctr, step, warmup, steps, want,
                    "gpt2-medium, eager", keep_final=model)
    expect_flash_routes(res["routes"], n, "gpt2-medium, eager")
    parts = {}

    @contextlib.contextmanager
    def timed_part(name):
        torch.cuda.synchronize()
        t = time.perf_counter()
        yield
        torch.cuda.synchronize()
        parts[f"{name}_ms"] = (time.perf_counter() - t) * 1e3

    with ctr.aside():
        step(timed_part)
    cap = captured_run(torch, ctr, model, loss_of, start, want,
                       "gpt2-medium, to_static", warmup, steps)
    expect_flash_routes(cap["routes"], n, "gpt2-medium, to_static")
    same = compare_runs(torch, res, cap, "gpt2-medium")
    del start
    for r in (res, cap):
        rate(r, GPT_BATCH * GPT_SEQ, gpt_flops(cfg))
    eager_vs_captured(card, "gpt2-medium", res, cap)
    log(f"  [{card}] eager step by part: forward {parts['forward_ms']:.3f} "
        f"ms, backward {parts['backward_ms']:.3f} ms, optimizer "
        f"{parts['optimizer_ms']:.3f} ms")
    return {**res, **cmp, **parts, "captured": cap,
            "captured_vs_eager": same}


# ------------------------------------------------------------ phase 7b
FP16_STEPS = 3


def train_fp16(torch, ctr, card, steps=FP16_STEPS):
    """Phase 7b: gpt2-medium (seed 0) at AMP O1 fp16 with ``GradScaler``
    (initial scale 2^15) and AdamW (f32 moments), eagerly, ``steps``
    steps at bench.py's batch and seq: the attention takes the flash
    kernels at fp16 on the CUDA-core route, one launch of each per layer
    and step, and one AdamW launch per step the scaler does not skip;
    the losses are finite."""
    from paddle_tpu_torch.amp import GradScaler, auto_cast
    from paddle_tpu_torch.models.gpt import GPT_CONFIGS, GPTForCausalLM
    from paddle_tpu_torch.optimizer import AdamW
    cfg = GPT_CONFIGS["gpt2-medium"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = GPTForCausalLM(cfg, device="cuda", generator=gen)
    opt = AdamW(learning_rate=1e-4, parameters=model.named_parameters())
    scaler = GradScaler(init_loss_scaling=2.0 ** 15)
    rng = np.random.RandomState(0)
    ids_np = rng.randint(0, cfg.vocab_size, (GPT_BATCH, GPT_SEQ))
    ids = torch.from_numpy(ids_np).cuda()
    labels = torch.from_numpy(np.roll(ids_np, -1, axis=1)).cuda()
    torch.cuda.synchronize()
    ctr.zero()
    t0 = time.perf_counter()
    losses, skipped = [], []
    for _ in range(steps):
        with auto_cast(level="O1", dtype="float16"):
            loss = model(ids, labels=labels)
        opt.clear_grad()
        scaler.scale(loss).backward()
        scaler.step(opt)
        losses.append(float(loss.detach()))
        skipped.append(bool(scaler._found_inf))
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / steps
    run, routes = ctr.read(), ctr.routes()
    n = cfg.num_layers * steps
    want = {"flash_fwd": n, "flash_bwd_dq": n, "flash_bwd_dkv": n,
            "adamw": steps - sum(skipped)}
    log(f"  gpt2-medium O1 fp16: launches in {steps} steps: {run}")
    ctr.expect(run, want, "gpt2-medium O1 fp16")
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        if routes[name] != {"wgmma": 0, "simt": n}:
            raise AssertionError(f"fp16 {name} launched on {routes[name]}, "
                                 f"expected {n} on simt")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"fp16 losses {losses}")
    log(f"  [{card}] gpt2-medium O1 fp16 + GradScaler (batch {GPT_BATCH}, "
        f"seq {GPT_SEQ}): losses {losses}, skipped updates {skipped}, "
        f"loss scale {scaler.get_loss_scaling()}, {dt * 1e3:.3f} ms per "
        f"eager step (the first included); {n} launches of each flash "
        "kernel, all on simt")
    del model, opt, loss
    torch.cuda.empty_cache()
    return {"losses": losses, "skipped": skipped, "launches": run,
            "routes": {k: routes[k] for k in ("flash_fwd", "flash_bwd_dq",
                                              "flash_bwd_dkv")},
            "step_ms": dt * 1e3, "loss_scale": scaler.get_loss_scaling()}


# ------------------------------------------------------------ phase 8
def flash_work(kernel, bh, s, d, elem):
    """(bytes, FLOPs) one causal call must move and do at [bh, s, d]:
    each input read once and each output written once; the products of
    the (q, k) pairs with k <= q only (what the causal mask leaves)."""
    pairs = s * (s + 1) // 2
    slab = bh * s * d * elem
    stat = bh * s * 4
    if kernel == "flash_fwd":       # q, k, v -> o, lse; QK^T and PV
        return 4 * slab + stat, 4 * pairs * d * bh
    if kernel == "packed_flash_fwd":    # q, k, v -> o; no lse
        return 4 * slab, 4 * pairs * d * bh
    if kernel == "flash_bwd_dq":    # q, k, v, dO, lse, delta -> dq
        return 5 * slab + 2 * stat, 6 * pairs * d * bh
    return 6 * slab + 2 * stat, 8 * pairs * d * bh   # -> dk, dv


def bound(nbytes, flops, peak_flops):
    """The least time (ms) for ``nbytes`` at the HBM rate and ``flops``
    at ``peak_flops``, the larger of the two, and which one it is."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops}


def time_flash(torch, fa, ctr, card, b=8, h=16, s=1024, d=64):
    """Phase 8: the flash kernels, their plain versions and PyTorch's
    scaled_dot_product_attention (forward; backward = dq, dk and dv in
    one call) at the training shape, bf16, causal: each kernel's achieved
    TFLOP/s and the fraction of its bound it reaches. Then, for
    reference, the three kernels at the same shape in f32, which still
    take the CUDA-core kernels."""
    import torch.nn.functional as F
    bh, scale = b * h, 1.0 / d ** 0.5
    q, k, v, do = flash_inputs(torch, bh, s, s, d, "bf16", seed=7)
    qd, kd, vd = (t.reshape(b, h, s, d) for t in (q, k, v))
    q4, k4, v4 = (t.detach().requires_grad_() for t in (qd, kd, vd))
    o4 = F.scaled_dot_product_attention(q4, k4, v4, is_causal=True,
                                        scale=scale)
    do4 = do.reshape(b, h, s, d)
    out = {}
    with ctr.aside():
        o, lse = fa.flash_fwd(q, k, v, True, scale)
        delta = (do.float() * o.float()).sum(-1)
        calls = {
            "flash_fwd": (lambda i: fa.flash_fwd(q, k, v, True, scale),
                          lambda i: fa.flash_fwd_plain(q, k, v, True, scale),
                          lambda i: F.scaled_dot_product_attention(
                              qd, kd, vd, is_causal=True, scale=scale)),
            "flash_bwd_dq": (
                lambda i: fa.flash_bwd_dq(q, k, v, do, lse, delta, True,
                                          scale),
                lambda i: fa.flash_bwd_dq_plain(q, k, v, do, lse, delta,
                                                True, scale), None),
            "flash_bwd_dkv": (
                lambda i: fa.flash_bwd_dkv(q, k, v, do, lse, delta, True,
                                           scale),
                lambda i: fa.flash_bwd_dkv_plain(q, k, v, do, lse, delta,
                                                 True, scale), None),
        }
        sdpa_bwd = time_fn(torch, lambda i: torch.autograd.grad(
            o4, (q4, k4, v4), do4, retain_graph=True), 20, 1)
        for name, (kern, plain, lib) in calls.items():
            before = ctr.routes()[name]
            ms = time_fn(torch, kern, 20, 1)
            route = next(r for r, n in ctr.routes()[name].items()
                         if n > before[r])
            plain_ms = time_fn(torch, plain, 5, 1)
            lib_ms = time_fn(torch, lib, 20, 1) if lib else sdpa_bwd
            b_ = bound(*flash_work(name, bh, s, d, 2), BF16_FLOPS)
            out[name] = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                         "library_call": (
                             "scaled_dot_product_attention" if lib
                             else "scaled_dot_product_attention backward "
                             "(dq, dk and dv together)"),
                         **b_, "tflops_per_s": b_["flops"] / ms / 1e9,
                         "bound_fraction": b_["bound_ms"] / ms,
                         "cuda_route": route}
            log(f"  {name} ({route}): kernel {ms:.4f} ms "
                f"({b_['flops'] / ms / 1e9:.2f} TFLOP/s, "
                f"{b_['bound_ms'] / ms:.3f} of the bound), plain "
                f"{plain_ms:.4f} ms, library {lib_ms:.4f} ms, "
                f"{b_['bytes']} B / {b_['flops']} FLOP -> bound "
                f"{b_['bound_ms']:.4f} ms ({b_['bound_by']}) [{card}]")
        q, k, v, do = flash_inputs(torch, bh, s, s, d, "f32", seed=7)
        o, lse = fa.flash_fwd(q, k, v, True, scale)
        delta = (do * o).sum(-1)
        out["simt_f32"] = {
            "flash_fwd": time_fn(torch, lambda i: fa.flash_fwd(
                q, k, v, True, scale), 10, 1),
            "flash_bwd_dq": time_fn(torch, lambda i: fa.flash_bwd_dq(
                q, k, v, do, lse, delta, True, scale), 10, 1),
            "flash_bwd_dkv": time_fn(torch, lambda i: fa.flash_bwd_dkv(
                q, k, v, do, lse, delta, True, scale), 10, 1)}
        log("  f32 at the same shape (CUDA-core kernels, for reference): "
            + ", ".join(f"{name} {ms:.4f} ms"
                        for name, ms in out["simt_f32"].items())
            + f" [{card}]")
        out["simt_f16"] = time_flash_f16(torch, fa, card, b, h, s, d)
    return out


def time_flash_f16(torch, fa, card, b, h, s, d):
    """The three kernels at fp16 (the CUDA-core route, phase 7b's), their
    plain versions and SDPA's forward at fp16, at phase 8's shape; the
    bound takes the bf16/fp16 dense peak."""
    import torch.nn.functional as F
    bh, scale = b * h, 1.0 / d ** 0.5
    q, k, v, do = flash_inputs(torch, bh, s, s, d, "f16", seed=7)
    o, lse = fa.flash_fwd(q, k, v, True, scale)
    delta = (do.float() * o.float()).sum(-1)
    args = (q, k, v, do, lse, delta, True, scale)
    calls = {"flash_fwd": (lambda i: fa.flash_fwd(q, k, v, True, scale),
                           lambda i: fa.flash_fwd_plain(q, k, v, True,
                                                        scale)),
             "flash_bwd_dq": (lambda i: fa.flash_bwd_dq(*args),
                              lambda i: fa.flash_bwd_dq_plain(*args)),
             "flash_bwd_dkv": (lambda i: fa.flash_bwd_dkv(*args),
                               lambda i: fa.flash_bwd_dkv_plain(*args))}
    out = {}
    for name, (kern, plain) in calls.items():
        ms = time_fn(torch, kern, 10, 1)
        out[name] = {"ms": ms, "plain_ms": time_fn(torch, plain, 5, 1),
                     **bound(*flash_work(name, bh, s, d, 2), BF16_FLOPS)}
    qd, kd, vd = (t.reshape(b, h, s, d) for t in (q, k, v))
    out["flash_fwd"]["library_ms"] = time_fn(
        torch, lambda i: F.scaled_dot_product_attention(
            qd, kd, vd, is_causal=True, scale=scale), 20, 1)
    log("  fp16 at the same shape (CUDA-core kernels): "
        + ", ".join(f"{name} {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, "
                    f"bound {r['bound_ms']:.4f})" for name, r in out.items())
        + f"; SDPA forward at fp16 {out['flash_fwd']['library_ms']:.4f} ms"
        f" [{card}]")
    return out


# ------------------------------------------------------------ phase 9
def ln_inputs(torch, n, h, xdt, gdt, seed):
    """x (mean 0.5, std 2), gamma in [0.5, 1.5), beta, dy on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    dt = {"f32": torch.float32, "bf16": torch.bfloat16}
    x = torch.randn(n, h, device="cuda", generator=g) * 2 + 0.5
    gamma = torch.rand(h, device="cuda", generator=g) + 0.5
    beta = torch.randn(h, device="cuda", generator=g)
    dy = torch.randn(n, h, device="cuda", generator=g)
    return (x.to(dt[xdt]), gamma.to(dt[gdt]), beta.to(dt[gdt]),
            dy.to(dt[xdt]))


def check_ln(torch, ln, ctr):
    """Phase 9: the LayerNorm kernels against their plain functions on the
    same values in f32: x f32 or bf16 with gamma/beta in x's dtype or
    f32; h 768 / 1024 / 4096 (ERNIE-base's and GPT-2 345M's rows and a
    wide one); n 8192 (the train steps' rows), 1 and 37. The backward
    kernels and their plain version get the kernel's mean and rstd. The
    tolerances are the JAX tests' (1e-5 forward, 1e-4 backward)."""
    cases = [(xdt, gdt, h, n)
             for xdt, gdt in (("f32", "f32"), ("bf16", "bf16"),
                              ("bf16", "f32"))
             for h in (768, 1024, 4096) for n in (8192, 1, 37)]
    worst = {"ln_fwd": 0.0, "ln_bwd": 0.0}
    with ctr.aside():
        for i, (xdt, gdt, h, n) in enumerate(cases):
            x, gamma, beta, dy = ln_inputs(torch, n, h, xdt, gdt, 300 + i)
            y, mean, rstd = ln.ln_fwd(x, gamma, beta, 1e-5)
            dx, dg, db = ln.ln_bwd(x, gamma, mean, rstd, dy)
            ry, rmean, rrstd = ln.ln_fwd_plain(x.float(), gamma.float(),
                                               beta.float(), 1e-5)
            rdx, rdg, rdb = ln.ln_bwd_plain(x.float(), gamma.float(), mean,
                                            rstd, dy.float())
            torch.cuda.synchronize()
            if (y.dtype, dx.dtype, dg.dtype, db.dtype, mean.dtype) != (
                    x.dtype, x.dtype, gamma.dtype, gamma.dtype,
                    torch.float32):
                raise AssertionError(f"LayerNorm case {i}: output dtypes")
            checks = [("ln_fwd", "y", y, ry, xdt, 1e-5),
                      ("ln_fwd", "mean", mean, rmean, "f32", 1e-5),
                      ("ln_fwd", "rstd", rstd, rrstd, "f32", 1e-5),
                      ("ln_bwd", "dx", dx, rdx, xdt, 1e-4),
                      ("ln_bwd", "dgamma", dg, rdg, gdt, 1e-4),
                      ("ln_bwd", "dbeta", db, rdb, gdt, 1e-4)]
            errs = hold(checks, worst, f"LayerNorm case {i} (x {xdt}, "
                        f"gamma {gdt}, h {h}, n {n})")
            log(f"  case x {xdt:4s} gamma {gdt:4s} h={h:4d} n={n:4d}: {errs}")
    return len(cases), worst


# ------------------------------------------------------------ phase 10
def train_ln(torch, ctr, card, gpt, warmup=2, steps=5):
    """Phase 10: phase 7's step with ``use_pallas_layer_norm`` on
    (``bench.py``'s ``BENCH_PALLAS_LN=1``): the LayerNorm kernel route
    against the composed one (flash on in both), then the timed steps
    with each LayerNorm kernel launched 2 x 24 + 1 = 49 times per step
    beside the flash kernels' 24 and AdamW's one. Turns the flag off
    again."""
    from paddle_tpu_torch import flags
    cfg, model, loss_of, step = gpt
    cmp = compare_routes(torch, model, loss_of, "use_pallas_layer_norm")
    n = cfg.num_layers * steps
    nl = (2 * cfg.num_layers + 1) * steps
    res = run_steps(torch, ctr, step, warmup, steps,
                    {"flash_fwd": n, "flash_bwd_dq": n, "flash_bwd_dkv": n,
                     "ln_fwd": nl, "ln_bwd": nl, "adamw": steps},
                    "gpt2-medium, LayerNorm kernels")
    expect_flash_routes(res["routes"], n, "gpt2-medium, LayerNorm kernels")
    flags.set_flags({"use_pallas_layer_norm": False})
    rate(res, GPT_BATCH * GPT_SEQ, gpt_flops(cfg))
    log(f"  [{card}] LayerNorm kernels on: step {res['step_ms']:.3f} ms, "
        f"{res['tokens_per_s']:.1f} tokens/s, MFU {res['mfu'] * 100:.3f}%, "
        f"{memory_line(res)}")
    return {**res, **cmp}


# ------------------------------------------------------------ phase 11
def ernie_step(torch, batch=ERNIE_BATCH, seq=ERNIE_SEQ):
    """``bench.py``'s ERNIE step (``:118-192``): ernie-base with both
    dropouts 0 and random weights from seed 0, AMP O2 bf16, AdamW (lr
    1e-4, bf16 moments), run eagerly, on bench.py's first batch (numpy
    ``RandomState(0)``: ids in [3, vocab), MLM labels = ids, random SOP
    labels; no mask, no token types). bench.py draws fresh batches for
    its timed steps; here every step repeats the first, as phase 7 does,
    so that a falling loss shows the optimizer at work and not the
    spread between batches. Returns ``(cfg, model, loss_of, step)`` as
    :func:`train_step` does."""
    import dataclasses

    from paddle_tpu_torch.amp import auto_cast
    from paddle_tpu_torch.models.ernie import (ERNIE_CONFIGS,
                                               ErnieForPretraining)
    from paddle_tpu_torch.optimizer import AdamW
    cfg = dataclasses.replace(ERNIE_CONFIGS["ernie-base"],
                              hidden_dropout_prob=0.0,
                              attention_probs_dropout_prob=0.0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = ErnieForPretraining(cfg, device="cuda", generator=gen)
    opt = AdamW(learning_rate=1e-4, parameters=model.named_parameters(),
                moment_dtype="bfloat16")
    rng = np.random.RandomState(0)
    ids = torch.from_numpy(
        rng.randint(3, cfg.vocab_size, (batch, seq)).astype(np.int32)).cuda()
    ns = torch.from_numpy(
        rng.randint(0, 2, (batch,)).astype(np.int32)).cuda()

    def loss_of():
        with auto_cast(level="O2"):
            return model(ids, masked_lm_labels=ids, next_sentence_label=ns)

    return cfg, model, loss_of, _stepper(model, opt, loss_of)


def train_ernie(torch, ctr, card, warmup=3, steps=5):
    """Phase 11: the ERNIE-base step of :func:`ernie_step`: the
    LayerNorm kernel route against the composed one, then the timed steps
    with ``use_pallas_layer_norm`` on (each LayerNorm kernel launched
    1 + 2 x 12 + 1 = 26 times per step, AdamW once), the same through
    ``jit.to_static`` from the same starting weights (bit-equal, as in
    phase 7), and then eager with the flag off (AdamW alone: at seq 512
    attention composes)."""
    from paddle_tpu_torch import flags
    cfg, model, loss_of, step = ernie_step(torch)
    cmp = compare_routes(torch, model, loss_of, "use_pallas_layer_norm")
    start = [p.detach().clone() for p in model.parameters()]
    nl = (2 * cfg.num_hidden_layers + 2) * steps
    flops = model_flops_per_token(cfg.hidden_size, cfg.intermediate_size,
                                  cfg.num_hidden_layers, cfg.vocab_size,
                                  ERNIE_SEQ)
    want = {"ln_fwd": nl, "ln_bwd": nl, "adamw": steps}
    on = rate(run_steps(torch, ctr, step, warmup, steps, want,
                        "ernie-base, LayerNorm kernels, eager",
                        keep_final=model),
              ERNIE_BATCH * ERNIE_SEQ, flops)
    cap = rate(captured_run(torch, ctr, model, loss_of, start, want,
                            "ernie-base, LayerNorm kernels, to_static",
                            warmup, steps),
               ERNIE_BATCH * ERNIE_SEQ, flops)
    same = compare_runs(torch, on, cap, "ernie-base")
    del start
    flags.set_flags({"use_pallas_layer_norm": False})
    off = rate(run_steps(torch, ctr, step, warmup, steps,
                         {"adamw": steps}, "ernie-base, composed LayerNorm"),
               ERNIE_BATCH * ERNIE_SEQ, flops)
    off.pop("final")
    eager_vs_captured(card, "ernie-base, LayerNorm kernels on", on, cap)
    log(f"  [{card}] LayerNorm kernels off, eager: step "
        f"{off['step_ms']:.3f} ms, {off['tokens_per_s']:.1f} tokens/s, MFU "
        f"{off['mfu'] * 100:.3f}%, {memory_line(off)}")
    return {"on": on, "captured": cap, "captured_vs_eager": same,
            "off": off, **cmp}


# ------------------------------------------------------------ phase 12
def check_packed(torch, fa, fp2, ctr):
    """Phase 12, first part: the packed forward against its plain version:
    first a small bf16 d 64 case (2 head pairs, s 64: the tensor-core
    kernel's first launch, synchronized), then at b 2 x h 16 (16 head
    pairs): f32 and bf16, causal and not, (s 1024, d 64) and (s 1040,
    d 20: a ragged last tile, a narrow head); bf16 d 64 at s 1040 (a
    ragged tile on the tensor-core route); non-causal s_q != s_k (f32
    1024 x 2048, bf16 1040 x 512 and 512 x 1040). The library's route
    rule must agree with the wrapper's and each call must launch on that
    route. bf16 d 64 (the tensor-core route) is held to
    :func:`close_rounded` with P @ |V| per head, everything else to
    :func:`close`."""
    cases = [("bf16", True, 64, 64, 64, 2)]
    cases += [(dt, causal, d, s, s, 16) for dt in ("f32", "bf16")
              for causal in (True, False) for s, d in ((1024, 64), (1040, 20))]
    cases += [("f32", False, 64, 1024, 2048, 16),
              ("bf16", True, 64, 1040, 1040, 16),
              ("bf16", False, 64, 1040, 512, 16),
              ("bf16", False, 64, 512, 1040, 16)]
    # seeds: the 9 cases that came first keep theirs (500 + their index)
    seeds = [499] + list(range(500, 512))
    worst = {"packed_flash_fwd": 0.0}
    with ctr.aside():
        for i, ((dt, causal, d, s_q, s_k, bh2), seed) in enumerate(
                zip(cases, seeds)):
            q, k, v, _ = flash_inputs(torch, bh2, s_q, s_k, 2 * d, dt,
                                      seed=seed)
            scale = 1.0 / d ** 0.5
            what = (f"packed case {i} ({dt} causal={causal} d={d} "
                    f"s_q={s_q} s_k={s_k} pairs={bh2})")
            tc = fp2._tc_route(q.dtype, d)
            lib_tc = fp2._lib().flash_pack2_tc_route(fp2._CODES[q.dtype], d)
            if bool(lib_tc) != tc:
                raise AssertionError(f"{what}: the library's route differs "
                                     f"from _tc_route's {tc}")
            route = "wgmma" if tc else "simt"
            before = ctr.routes()["packed_flash_fwd"][route]
            o = fp2.packed_flash_fwd(q, k, v, causal, scale)
            torch.cuda.synchronize()
            if ctr.routes()["packed_flash_fwd"][route] != before + 1:
                raise AssertionError(f"{what}: no launch on the {route} "
                                     "route")
            ref = fp2.packed_flash_fwd_plain(q.float(), k.float(), v.float(),
                                             causal, scale)
            rnd = packed_rounding(fa, fp2, q, k, v, causal, scale) if tc \
                else None
            torch.cuda.synchronize()
            errs = hold([("packed_flash_fwd", "o", o, ref, dt, 2e-5, rnd)],
                        worst, what)
            log(f"  case {dt:4s} causal={causal!s:5s} d={d:3d} s_q={s_q} "
                f"s_k={s_k} pairs={bh2} {route}: {errs}")
    return len(cases), worst


def packed_path(torch, fa, fp2, ctr, card, worst, b=8, h=16, s=1024, d=64):
    """Phase 12, second part: ``tools/flash_pack2_bench.py``'s run at its
    shape (b 8, h 16, s 1024, d 64, bf16, causal): one packed call with
    the counts zeroed before and read after (it must be one launch on the
    tensor-core route), its output held against the plain version as in
    the first part (``worst`` keeps the error) and compared with
    ``flash_fwd`` on the unpacked heads (the tool's ``max_abs_err``),
    then the packed kernel timed beside ``flash_fwd``, the plain version
    and SDPA."""
    import torch.nn.functional as F
    scale = 1.0 / d ** 0.5
    q, k, v, _ = flash_inputs(torch, b * h, s, s, d, "bf16", seed=9)
    qp, kp, vp = (fp2.pack_pairs(t.reshape(b, h, s, d)).contiguous()
                  for t in (q, k, v))
    ctr.zero()
    o = fp2.packed_flash_fwd(qp, kp, vp, True, scale)
    torch.cuda.synchronize()
    run = ctr.read()
    routes = ctr.routes()["packed_flash_fwd"]
    ctr.expect(run, {"packed_flash_fwd": 1}, "packed forward")
    if routes != {"wgmma": 1, "simt": 0}:
        raise AssertionError(f"packed forward: launches by route {routes}, "
                             "expected the one on wgmma")
    qd, kd, vd = (t.reshape(b, h, s, d) for t in (q, k, v))
    with ctr.aside():
        ref = fp2.packed_flash_fwd_plain(qp.float(), kp.float(), vp.float(),
                                         True, scale)
        rnd = packed_rounding(fa, fp2, qp, kp, vp, True, scale)
        torch.cuda.synchronize()
        errs = hold([("packed_flash_fwd", "o", o, ref, "bf16", 2e-5, rnd)],
                    worst,
                    f"packed forward at the probe's shape {[b, h, s, d]}")
        del ref, rnd
        log(f"  probe's shape {[b, h, s, d]} bf16 causal vs plain: {errs}")
        base, _ = fa.flash_fwd(q, k, v, True, scale)
        err = float((fp2.unpack_pairs(o).float() - base.float()).abs().max())
        packed_ms = time_fn(torch, lambda i: fp2.packed_flash_fwd(
            qp, kp, vp, True, scale), 20, 1)
        base_ms = time_fn(torch, lambda i: fa.flash_fwd(q, k, v, True, scale),
                          20, 1)
        plain_ms = time_fn(torch, lambda i: fp2.packed_flash_fwd_plain(
            qp, kp, vp, True, scale), 5, 1)
        lib_ms = time_fn(torch, lambda i: F.scaled_dot_product_attention(
            qd, kd, vd, is_causal=True, scale=scale), 20, 1)
    b_ = bound(*flash_work("packed_flash_fwd", b * h, s, d, 2), BF16_FLOPS)
    probe = {"metric": "flash_fwd_pack2_speedup", "value": base_ms / packed_ms,
             "unit": "x", "base_ms": base_ms, "packed_ms": packed_ms,
             "shape": [b, h, s, d], "max_abs_err": err,
             "device": torch.cuda.get_device_name(0)}
    log(f"  packed forward: kernel {packed_ms:.4f} ms, flash_fwd {base_ms:.4f} "
        f"ms, plain {plain_ms:.4f} ms, library {lib_ms:.4f} ms, "
        f"{b_['bytes']} B / {b_['flops']} FLOP -> bound "
        f"{b_['bound_ms']:.4f} ms ({b_['bound_by']}) [{card}]")
    log(f"  {json.dumps(probe)}")
    return {"launches": run["packed_flash_fwd"], "routes": routes,
            "ms": packed_ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "probe": probe, **b_}


# ------------------------------------------------------------ phase 13
def ln_work(kernel, n, h, elem, gelem):
    """(bytes, FLOPs) of one call at [n, h]: each input read once and each
    output written once (forward: x, gamma, beta -> y, mean, rstd;
    backward: x, gamma, mean, rstd, dy -> dx, dgamma, dbeta), and 7
    (forward) or 14 (backward) f32 operations per element."""
    if kernel == "ln_fwd":
        return 2 * n * h * elem + 2 * n * 4 + 2 * h * gelem, 7 * n * h
    return 3 * n * h * elem + 2 * n * 4 + 3 * h * gelem, 14 * n * h


def time_ln(torch, ln, ctr, card):
    """Phase 13: the LayerNorm kernels, their plain versions and
    ``torch.nn.functional.layer_norm`` (forward; backward = its autograd
    dx, dgamma and dbeta in one call) at the train steps' f32 rows:
    ERNIE-base [8192, 768] and GPT-2 345M [8192, 1024]."""
    import torch.nn.functional as F
    out = {"ln_fwd": {}, "ln_bwd": {}}
    with ctr.aside():
        for model, h in (("ernie-base", 768), ("gpt2-medium", 1024)):
            n = 8192
            x, gamma, beta, dy = ln_inputs(torch, n, h, "f32", "f32", 11)
            _, mean, rstd = ln.ln_fwd(x, gamma, beta, 1e-5)
            xl, gl, bl = (t.detach().requires_grad_() for t in (x, gamma,
                                                                 beta))
            yl = F.layer_norm(xl, (h,), gl, bl, 1e-5)
            calls = {
                "ln_fwd": (lambda i: ln.ln_fwd(x, gamma, beta, 1e-5),
                           lambda i: ln.ln_fwd_plain(x, gamma, beta, 1e-5),
                           lambda i: F.layer_norm(x, (h,), gamma, beta,
                                                  1e-5)),
                "ln_bwd": (lambda i: ln.ln_bwd(x, gamma, mean, rstd, dy),
                           lambda i: ln.ln_bwd_plain(x, gamma, mean, rstd,
                                                     dy),
                           lambda i: torch.autograd.grad(
                               yl, (xl, gl, bl), dy, retain_graph=True)),
            }
            for kernel, (kern, plain, lib) in calls.items():
                ms = time_fn(torch, kern, 100, 1)
                plain_ms = time_fn(torch, plain, 20, 1)
                lib_ms = time_fn(torch, lib, 100, 1)
                b_ = bound(*ln_work(kernel, n, h, 4, 4), F32_FLOPS)
                out[kernel][model] = {
                    "shape": [n, h], "ms": ms, "plain_ms": plain_ms,
                    "library_ms": lib_ms, **b_,
                    "library_call": ("torch.nn.functional.layer_norm" +
                                     (" backward (dx, dgamma, dbeta)"
                                      if kernel == "ln_bwd" else ""))}
                log(f"  {kernel} f32 [{n}, {h}] ({model}): kernel {ms:.4f} "
                    f"ms, plain {plain_ms:.4f} ms, library {lib_ms:.4f} ms, "
                    f"{b_['bytes']} B -> bound {b_['bound_ms']:.4f} ms "
                    f"({b_['bound_by']}) [{card}]")
    return out


# ------------------------------------------------------------ phase 14
ADAMW_SIZES = (1, 7, 4097, 2 ** 20 + 3)
# (parameter dtype, moment dtype): phase 7's pairing and f32 moments, then
# a bf16 model with its own or f32 moments, and an fp16 one
ADAMW_DTYPES = (("float32", "float32"), ("float32", "bfloat16"),
                ("bfloat16", "bfloat16"), ("bfloat16", "float32"),
                ("float16", "float16"))


def same_values(x, y):
    """``torch.equal``, except that a NaN matches a NaN: fp16 with
    epsilon 1e-8 (below fp16's least subnormal) divides by zero where
    sqrt(m2) underflows, in the per-op path as in the kernel."""
    import torch
    if torch.equal(x, y):
        return True
    nx, ny = x.isnan(), y.isnan()
    return torch.equal(nx, ny) and torch.equal(x[~nx], y[~ny])


def adamw_group(torch, pdtype, mdtype, steps_done, seed, offset=0):
    """A group of :data:`ADAMW_SIZES` on the card: parameters, gradients
    and beta powers in ``pdtype``, moments in ``mdtype``, beta powers
    after ``steps_done`` steps (zero moments and powers 1 at the first).
    ``offset`` 1 places every tensor one element into its storage, off
    the kernel's vector path. Built from a seed, so two calls give equal
    groups."""
    rng = np.random.RandomState(seed)
    cols = [[] for _ in range(6)]

    def put(a, dt):
        t = torch.from_numpy(np.concatenate([np.zeros(offset, np.float32),
                                             a])).cuda().to(dt)
        return t[offset:]

    for n in ADAMW_SIZES:
        m1 = rng.randn(n) * 1e-3 if steps_done else np.zeros(n)
        m2 = rng.rand(n) * 1e-5 if steps_done else np.zeros(n)
        vals = (rng.randn(n), rng.randn(n) * 1e-2, m1, m2)
        for col, v, dt in zip(cols, vals, (pdtype, pdtype, mdtype, mdtype)):
            col.append(put(v.astype(np.float32), dt))
        for col, beta in ((cols[4], 0.9), (cols[5], 0.999)):
            col.append(torch.full((1,), float(np.float32(beta) **
                                              steps_done),
                                  device="cuda").to(pdtype))
    return cols


def hold_adamw(torch, kern, plain, what, sizes):
    """Every p, g, m1, m2, b1p and b2p of ``kern`` equal to ``plain``'s
    (:func:`same_values`); returns the largest difference of the values
    that are not NaN in both (0.0 when they are equal)."""
    worst = 0.0
    for name, a, b in zip(("p", "g", "m1", "m2", "b1p", "b2p"), kern, plain):
        for i, (x, y) in enumerate(zip(a, b)):
            ok = ~(x.isnan() | y.isnan())
            if ok.any():
                worst = max(worst, float((x.float()[ok] - y.float()[ok])
                                         .abs().max()))
            if not same_values(x, y):
                raise AssertionError(
                    f"{what}: {name}[{i}] (n {sizes[i]}) differs from "
                    f"plain by {worst:.3e}")
    return worst


def check_adamw(torch, aw, ctr):
    """Phase 14: the AdamW kernel against its plain version on the card,
    every p, m1, m2, b1p and b2p equal (:func:`same_values`): each
    (parameter, moment) dtype pairing of :data:`ADAMW_DTYPES`, the first
    step (beta powers 1) and a later one, aligned and one element off
    alignment; two steps each (the second checks that the kernel reset
    its arrival counts). Each call is one launch. Returns the case count
    and the largest difference (0.0)."""
    lr = torch.full((1,), 1e-4, device="cuda")
    cases, worst = 0, 0.0
    with ctr.aside():
        for pname, mname in ADAMW_DTYPES:
            pdtype, mdtype = getattr(torch, pname), getattr(torch, mname)
            for steps_done in (0, 9):
                for offset in (0, 1):
                    args = (torch, pdtype, mdtype, steps_done,
                            5 + steps_done, offset)
                    kern, plain = adamw_group(*args), adamw_group(*args)
                    rng = np.random.RandomState(cases)
                    what = (f"adamw {pname} parameters, {mname} moments, "
                            f"step {steps_done} offset {offset}")
                    for _ in range(2):
                        before = aw.launches["adamw"]
                        aw.adamw_multi(*kern, lr)
                        if aw.launches["adamw"] != before + 1:
                            raise AssertionError("one group, not one launch")
                        aw.adamw_multi_plain(*plain, lr)
                        torch.cuda.synchronize()
                        worst = max(worst, hold_adamw(torch, kern, plain,
                                                      what, ADAMW_SIZES))
                        for gk, gp in zip(kern[1], plain[1]):
                            g = torch.from_numpy((rng.randn(gk.numel())
                                                  * 1e-2).astype(
                                np.float32)).cuda().to(pdtype)
                            gk.copy_(g)
                            gp.copy_(g)
                    cases += 1
                    log(f"  case {pname:8s} parameters, {mname:8s} moments, "
                        f"after {steps_done} steps, offset {offset}: 2 steps "
                        "equal")
        for pname, mname in ADAMW_DTYPES:
            for mode in ("lr per entry", "grad scale", "adam"):
                n, w = check_adamw_mode(torch, aw, pname, mname, mode,
                                        cases)
                cases += n
                worst = max(worst, w)
    return cases, worst


def check_adamw_mode(torch, aw, pname, mname, mode, seed):
    """Phase 14's cases of the kernel's per-entry lr and grad scale, two
    steps each from a later step: ``lr per entry`` (three lr_scale slots of one
    ``[3]`` tensor, entry i reading slot i % 3), ``grad scale`` (a
    GradientClipByGlobalNorm factor of 0.37, float32 [1]) against
    :func:`adamw_multi_plain` with the same, and ``adam`` (the kernel at
    ``coeff = 0``) against :func:`adamw_multi_plain` at ``coeff = 0``,
    which is plain Adam per parameter. Every tensor equal
    (:func:`same_values`). Returns ``(1, largest difference)``."""
    pdtype, mdtype = getattr(torch, pname), getattr(torch, mname)
    args = (torch, pdtype, mdtype, 9, 40 + seed, 0)
    kern, plain = adamw_group(*args), adamw_group(*args)
    lr = torch.full((1,), 1e-4, device="cuda")
    slots = torch.tensor([1e-4, 1e-5, 3e-4], device="cuda")
    lrs = [slots[i % 3:i % 3 + 1] for i in range(len(ADAMW_SIZES))]
    scale = torch.full((1,), 0.37, device="cuda")
    rng = np.random.RandomState(seed)
    worst = 0.0
    for _ in range(2):
        before = aw.launches["adamw"]
        if mode == "lr per entry":
            aw.adamw_multi(*kern, lrs)
            aw.adamw_multi_plain(*plain, lrs)
        elif mode == "grad scale":
            aw.adamw_multi(*kern, lr, grad_scale=scale)
            aw.adamw_multi_plain(*plain, lr, grad_scale=scale)
        else:
            aw.adamw_multi(*kern, lr, coeff=0.0)
            aw.adamw_multi_plain(*plain, lr, coeff=0.0)
        if aw.launches["adamw"] != before + 1:
            raise AssertionError("one group, not one launch")
        torch.cuda.synchronize()
        worst = max(worst, hold_adamw(
            torch, kern, plain, f"adamw {mode}, {pname} parameters, "
            f"{mname} moments", ADAMW_SIZES))
        for gk, gp in zip(kern[1], plain[1]):
            g = torch.from_numpy((rng.randn(gk.numel()) * 1e-2).astype(
                np.float32)).cuda().to(pdtype)
            gk.copy_(g)
            gp.copy_(g)
    log(f"  case {mode:12s} {pname:8s} parameters, {mname:8s} moments: 2 "
        "steps equal")
    return 1, worst


def check_adamw_main_path(torch, aw, ctr, ps, what, seed, scaled=(),
                          coeff=0.01, mdtype="bfloat16"):
    """The kernel against its plain version on a model's whole parameter
    set as the main path gives it (``ps``: the model's parameters in the
    optimizer's order, one group, one launch, float32 with ``mdtype``
    moments; AdamW's ``coeff``, or 0 for Adam): two steps from zero
    moments and beta powers 1 on copies of the same state, with random
    gradients (seeded), every tensor held equal. ``scaled``: indices of
    the parameters at ``lr_scale`` 0.1 (their own slot of the lr tensor);
    with any, the steps also take a GradientClipByGlobalNorm factor of
    0.5 (phase 18's path). Returns the largest difference (0.0)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    mdt = getattr(torch, mdtype)
    kern = [[p.detach().clone() for p in ps],
            [torch.randn(p.shape, device="cuda", generator=gen) * 1e-3
             for p in ps],
            [torch.zeros_like(p, dtype=mdt) for p in ps],
            [torch.zeros_like(p, dtype=mdt) for p in ps],
            [torch.ones(1, device="cuda") for _ in ps],
            [torch.ones(1, device="cuda") for _ in ps]]
    plain = [c if i == 1 else [t.clone() for t in c]
             for i, c in enumerate(kern)]
    slots = torch.tensor([1e-4, 1e-5], device="cuda")
    lrs = [slots[1:2] if i in scaled else slots[0:1]
           for i in range(len(ps))]
    scale = torch.full((1,), 0.5, device="cuda") if scaled else None
    table = aw.Table(kern[0], *kern[2:], lrs)
    sizes = [p.numel() for p in ps]
    worst = 0.0
    with ctr.aside():
        for step in range(2):
            before = aw.launches["adamw"]
            aw.adamw_multi(*kern, lrs, coeff=coeff, grad_scale=scale,
                           table=table)
            if aw.launches["adamw"] != before + 1:
                raise AssertionError(f"{what}: one group, not one launch")
            aw.adamw_multi_plain(*plain, lrs, coeff=coeff, grad_scale=scale)
            torch.cuda.synchronize()
            worst = max(worst, hold_adamw(torch, kern, plain,
                                          f"adamw over {what}, step {step}",
                                          sizes))
            for g in kern[1]:
                g.mul_(-0.5)
    log(f"  adamw over {what}'s {len(ps)} tensors, {sum(sizes)} parameters "
        f"(coeff {coeff}, {mdtype} moments; "
        f"{sum(aw.chunk_plan(sizes)[1])} blocks in one launch"
        + (f"; {len(scaled)} at lr_scale 0.1, grad scale 0.5" if scaled
           else "") + f"): 2 steps equal to plain, largest difference "
        f"{worst:.3e}")
    del kern, plain, table
    torch.cuda.empty_cache()
    return worst


# ------------------------------------------------------------ phase 15
def time_adamw(torch, aw, ctr, card):
    """Phase 15: the AdamW kernel at the main path's shapes. First it is
    held equal to its plain version on the whole parameter sets of
    gpt2-medium (phases 7 and 11's group shape: 292 tensors in one launch;
    again with phase 18's lr slots and clip scale), of the gpt2-1p1b
    flagship (phase 16's) and of resnet18 at coeff 0 with f32 moments
    (phase 18's Adam: 62 tensors). Then it is timed over
    gpt2-medium's parameters (f32 parameters and gradients, bf16 moments:
    phase 7's group) against its bound: p read and written, g read, m1
    and m2 read and written, 20 B per parameter over 3.35 TB/s, against
    ~15 f32 operations per parameter over 67 TFLOP/s. Beside it, the
    plain per-parameter loop and, for scale only,
    ``torch.optim.AdamW(fused=True)`` on the same tensors: a different
    update (epsilon added after the bias correction, f32 moments), no
    yardstick of this function."""
    from paddle_tpu_torch.models.gpt import GPT_CONFIGS, GPTForCausalLM
    gen = torch.Generator(device="cuda").manual_seed(0)
    big = GPTForCausalLM(GPT_CONFIGS["gpt2-1p1b"], device="cuda",
                         generator=gen)
    errs = [check_adamw_main_path(
        torch, aw, ctr, [p.detach() for p in big.parameters()], "gpt2-1p1b",
        seed=2)]
    del big
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = GPTForCausalLM(GPT_CONFIGS["gpt2-medium"], device="cuda",
                           generator=gen)
    ps = [p.detach() for p in model.parameters()]
    errs.append(check_adamw_main_path(torch, aw, ctr, ps, "gpt2-medium",
                                      seed=1))
    emb = [i for i, (n, _) in enumerate(model.named_parameters())
           if n.endswith(("wte.weight", "wpe.weight"))]
    errs.append(check_adamw_main_path(
        torch, aw, ctr, ps, "gpt2-medium (phase 18's lr slots and clip)",
        seed=3, scaled=emb))
    rn18 = resnet(torch, "resnet18")
    errs.append(check_adamw_main_path(
        torch, aw, ctr, [p.detach() for p in rn18.parameters()],
        "resnet18 (phase 18's Adam)", seed=4, coeff=0.0, mdtype="float32"))
    del rn18
    g0 = torch.Generator(device="cuda").manual_seed(1)
    gs = [torch.randn(p.shape, device="cuda", generator=g0) * 1e-3
          for p in ps]
    m1s = [torch.zeros_like(p, dtype=torch.bfloat16) for p in ps]
    m2s = [torch.zeros_like(p, dtype=torch.bfloat16) for p in ps]
    b1ps = [torch.ones(1, device="cuda") for _ in ps]
    b2ps = [torch.ones(1, device="cuda") for _ in ps]
    lr = torch.full((1,), 1e-4, device="cuda")
    table = aw.Table(ps, m1s, m2s, b1ps, b2ps, lr)
    scale = torch.full((1,), 0.5, device="cuda")
    n = sum(p.numel() for p in ps)
    with ctr.aside():
        before = aw.launches["adamw"]
        aw.adamw_multi(ps, gs, m1s, m2s, b1ps, b2ps, lr, table=table)
        per_call = aw.launches["adamw"] - before
        ms = time_fn(torch, lambda i: aw.adamw_multi(
            ps, gs, m1s, m2s, b1ps, b2ps, lr, table=table), 20, 1)
        scaled_ms = time_fn(torch, lambda i: aw.adamw_multi(
            ps, gs, m1s, m2s, b1ps, b2ps, lr, grad_scale=scale,
            table=table), 20, 1)
        plain_ms = time_fn(torch, lambda i: aw.adamw_multi_plain(
            ps, gs, m1s, m2s, b1ps, b2ps, lr), 3, 1)
        tp = [torch.nn.Parameter(p.clone()) for p in ps]
        for t, g in zip(tp, gs):
            t.grad = g
        fused = torch.optim.AdamW(tp, lr=1e-4, weight_decay=0.01,
                                  fused=True)
        fused_ms = time_fn(torch, lambda i: fused.step(), 20, 1)
    del tp, fused, model
    b_ = bound(n * (4 * 2 + 4 + 2 * 2 * 2), 15 * n, F32_FLOPS)
    log(f"  adamw over gpt2-medium's {len(ps)} tensors, {n} parameters, "
        f"bf16 moments: kernel {ms:.4f} ms ({per_call:.0f} launch per "
        f"call), plain {plain_ms:.4f} ms, {b_['bytes']} B -> bound "
        f"{b_['bound_ms']:.4f} ms ({b_['bound_by']}), "
        f"{ms / b_['bound_ms']:.2f}x the bound; with a grad scale (the "
        f"clip folded in) {scaled_ms:.4f} ms; torch.optim.AdamW("
        f"fused=True), a different update, {fused_ms:.4f} ms [{card}]")
    torch.cuda.empty_cache()
    return {"ms": ms, "plain_ms": plain_ms, **b_, "library_ms": None,
            "grad_scale_ms": scaled_ms,
            "other_update_ms": fused_ms, "tensors": len(ps),
            "parameters": n, "launches_per_call": per_call,
            "main_path_max_abs_err": max(errs),
            "main_path_cases": len(errs)}


# ------------------------------------------------------------ phase 16
FLAGSHIP_K = 10


def flagship(torch, batch=GPT_BATCH, seq=GPT_SEQ):
    """``bench.py``'s default flagship on the card: gpt2-1p1b with
    ``recompute=True`` (random weights from seed 0), AdamW (lr 1e-4, bf16
    moments) and bench.py's first batch (numpy ``RandomState(0)``).
    Returns ``(cfg, model, opt, ids, labels)``."""
    import dataclasses

    from paddle_tpu_torch.models.gpt import GPT_CONFIGS, GPTForCausalLM
    from paddle_tpu_torch.optimizer import AdamW
    cfg = dataclasses.replace(GPT_CONFIGS["gpt2-1p1b"], recompute=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = GPTForCausalLM(cfg, device="cuda", generator=gen)
    opt = AdamW(learning_rate=1e-4, parameters=model.named_parameters(),
                moment_dtype="bfloat16")
    rng = np.random.RandomState(0)
    ids_np = rng.randint(0, cfg.vocab_size, (batch, seq))
    ids = torch.from_numpy(ids_np).cuda()
    labels = torch.from_numpy(np.roll(ids_np, -1, axis=1)).cuda()
    return cfg, model, opt, ids, labels


def flagship_step(torch, batch=GPT_BATCH, seq=GPT_SEQ):
    """:func:`flagship` as :func:`train_step` returns a model: ``(cfg,
    model, loss_of, step)``, for ``tools/torch_train_profile.py``."""
    from paddle_tpu_torch.amp import auto_cast
    cfg, model, opt, ids, labels = flagship(torch, batch, seq)

    def loss_of():
        with auto_cast(level="O2"):
            return model(ids, labels=labels)

    return cfg, model, loss_of, _stepper(model, opt, loss_of)



def train_flagship(torch, ctr, card, batch=GPT_BATCH, seq=GPT_SEQ,
                   k=FLAGSHIP_K):
    """Phase 16: ``bench.py``'s default flagship, uncut: gpt2-1p1b (h
    2048, 20 layers, 16 heads of 128, ffn 8192, vocab 50304) with
    ``recompute=True``, batch 8, seq 1024, O2 bf16, AdamW lr 1e-4 with
    bf16 moments, ``retain_grads=False``; ``bench.py:1180-1197``'s
    schedule: 2 ``to_static`` steps (the first eager, the second
    captured), then ``to_static_multi_step`` over K = 10, once to warm
    and once timed. bench.py draws a fresh batch for the K steps; here
    each step repeats its first batch, as phase 7 does, so that a
    falling loss shows the optimizer at work. Per step: flash_fwd 40
    (forward plus recomputation), dQ 20, dK/dV 20, all on ``wgmma`` at
    d 128, one AdamW launch, and the kernels a profiler trace of a K = 2
    call sees per step must be those counts; after each call every
    gradient is None."""
    from paddle_tpu_torch import jit
    from paddle_tpu_torch.amp import auto_cast
    cfg, model, opt, ids, labels = flagship(torch, batch, seq)

    def train_step(ids, labels):
        with auto_cast(level="O2"):
            loss = model(ids, labels=labels)
        opt.clear_grad()
        loss.backward()
        opt.step()
        return loss

    step = jit.to_static(train_step, layers=[model], optimizers=[opt],
                         retain_grads=False)
    multi = jit.to_static_multi_step(train_step, layers=[model],
                                     optimizers=[opt], retain_grads=False)
    ids_k = ids.expand(k, batch, seq).contiguous()
    labels_k = labels.expand(k, batch, seq).contiguous()
    n_params = sum(p.numel() for p in model.parameters())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    first = [step(ids, labels) for _ in range(2)]
    warm = multi(ids_k, labels_k)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    ctr.zero()
    t0 = time.perf_counter()
    timed = multi(ids_k, labels_k)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / k
    run, routes = ctr.read(), ctr.routes()
    peak = torch.cuda.max_memory_allocated()
    reserved = torch.cuda.max_memory_reserved()
    losses = [float(x) for x in first] + [float(x) for x in warm] + \
        [float(x) for x in timed]
    L = cfg.num_layers
    want = {"flash_fwd": 2 * L * k, "flash_bwd_dq": L * k,
            "flash_bwd_dkv": L * k, "adamw": k}
    log(f"  gpt2-1p1b: {n_params} parameters; launches in the timed K = {k} "
        f"call: {run}")
    ctr.expect(run, want, "gpt2-1p1b")
    expect_flash_routes(routes, L * k, "gpt2-1p1b", n_fwd=2 * L * k)
    if any(p.grad is not None for p in model.parameters()):
        raise AssertionError("gpt2-1p1b: a gradient survived "
                             "retain_grads=False")
    log(f"  gpt2-1p1b: losses {losses}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"gpt2-1p1b: losses not finite and falling: "
                             f"{losses}")
    two_k = (ids_k[:2], labels_k[:2])
    busy, kernels, traced_counts = traced_steps(
        torch, ctr, lambda: multi(*two_k), 2,
        {n: c / k for n, c in run.items() if c}, "gpt2-1p1b")
    log(f"  gpt2-1p1b: kernels per step in the trace of a K = 2 call "
        f"{traced_counts}")
    fpt = model_flops_per_token(cfg.hidden_size, cfg.ffn_hidden_size, L,
                                cfg.vocab_size, seq)
    res = rate({"step_ms": dt * 1e3, "losses": losses, "launches": run,
                "routes": routes, "peak_bytes": peak,
                "peak_reserved_bytes": reserved, "device_busy_ms": busy,
                "idle_share": 1.0 - busy / (dt * 1e3),
                "kernels_per_step": kernels,
                "traced_counts": traced_counts,
                "parameters": n_params, "warm_s": warm_s},
               batch * seq, fpt)
    log(f"  [{card}] gpt2-1p1b, recompute, to_static_multi_step K = {k}: "
        f"step {res['step_ms']:.3f} ms, {res['tokens_per_s']:.1f} tokens/s, "
        f"MFU {res['mfu'] * 100:.3f}% (bench.py's formula, "
        f"{fpt / 1e9:.3f} GFLOP per token, no credit for recomputation), "
        f"device busy "
        f"{busy:.3f} ms per step, idle share {res['idle_share']:.4f}, "
        f"{res['kernels_per_step']:.0f} kernels per step, "
        f"{memory_line(res)}; 2 to_static steps and the warm K call took "
        f"{warm_s:.1f} s")
    del step, multi, model, opt
    torch.cuda.empty_cache()
    return res



# ------------------------------------------------------------ phase 17
MEGASTEP = 8          # the megastep the serving comparison runs at
PROFILE_TIMED, PROFILE_TRACED = 8, 2
SWAP_AT = 6           # engine steps before the weight swap


def release_graphs(torch, model):
    """Drop every step-cache entry of ``model`` and its graphs (their
    engines must be gone), so the next mode's memory is its own."""
    model.__dict__.pop("_step_compile_cache", None)
    model.__dict__.pop("_step_graph_pool", None)
    gc.collect()
    torch.cuda.empty_cache()


def decode_profile(torch, ctr, eng, what, sampled=None):
    """Eight requests of 32-token prompts in flight (greedy, or with the
    ``sampled`` recipe and a seed each), then
    ``PROFILE_TIMED`` engine steps, each one decode dispatch of every row
    (one megastep at N > 1) and its commit, on the host clock; then
    ``PROFILE_TRACED`` more under the profiler: the device's busy time
    per step, its idle share of the timed step, and the kernels per
    step. The paged-attention kernels the trace sees must be the launch
    counts: ``num_layers x N`` per step of a paged engine, none of a
    dense one (a disagreeing trace is taken again once, as
    :func:`traced_steps` does). Where the steps replay a
    graph, ``graph_kernels`` is the kernel count of that graph, read from
    the graph itself (:func:`decode_graph_kernels`): the profiler now and
    then drops or adds a record (one in ~1,460 kernels has been seen), so
    its count of a step is no exact kernel count."""
    cfg = eng.model.cfg
    rng = np.random.RandomState(5)
    kws = [{} if sampled is None else dict(sampled, seed=600 + i)
           for i in range(8)]
    reqs = [eng.submit(rng.randint(0, cfg.vocab_size, size=32).tolist(),
                       max_new_tokens=200, **kw) for kw in kws]
    eng.step()
    eng.step()
    if sum(r.state == "running" for r in reqs) != 8:
        raise AssertionError(f"{what}: not all 8 requests are decoding")
    cap0 = captures(eng.model)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(PROFILE_TIMED):
        eng.step()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / PROFILE_TIMED * 1e3
    per = cfg.num_layers * eng.megastep if eng.paged else 0
    for attempt in range(2):
        c0 = ctr.read()["paged_attention"]
        busy, names = device_trace(
            torch, lambda: [eng.step() for _ in range(PROFILE_TRACED)])
        launched = ctr.read()["paged_attention"] - c0
        seen = sum(n for name, n in names.items()
                   if "paged_attention_kernel" in name)
        if launched == seen == PROFILE_TRACED * per:
            break
        log(f"  {what}: {seen} paged kernels in the trace, {launched} "
            f"counted, {PROFILE_TRACED * per} expected"
            + ("; tracing again" if attempt == 0 else ""))
    else:
        raise AssertionError(f"{what}: the trace and the launch counts of "
                             "the decode steps disagree")
    graph_k = decode_graph_kernels(eng, sampled is not None)
    if captures(eng.model) != cap0:
        raise AssertionError(f"{what}: the profiled steps captured graphs")
    busy /= PROFILE_TRACED
    kernels = sum(names.values()) / PROFILE_TRACED
    res = {"decode_step_ms": wall, "decode_busy_ms": busy,
           "decode_idle_share": 1.0 - busy / wall,
           "kernels_per_decode_step": kernels,
           "graph_kernels": graph_k,
           "decode_ms_per_token": wall / eng.megastep,
           "paged_kernels_per_step": seen / PROFILE_TRACED}
    log(f"  {what}: decode step {wall:.3f} ms on the host clock "
        f"({eng.megastep} token(s) per row), device busy {busy:.3f} ms, "
        f"idle share {res['decode_idle_share']:.4f}, {kernels:.0f} kernels "
        f"per step, {res['paged_kernels_per_step']:.0f} of them paged "
        f"attention (trace == counts); kernel nodes of the graph replayed: "
        f"{'none, eager' if graph_k is None else graph_k}")
    return res


def decode_graph_kernels(eng, sampled):
    """The kernel nodes of the decode graph (the greedy or the sampled
    one; the megastep's at N > 1) that ``eng``'s last step replayed, or
    None where that step ran eagerly."""
    from paddle_tpu_torch import jit
    from paddle_tpu_torch.models import generation
    if not eng.paged:
        ent = generation.decode_step(eng.model)
    elif eng.megastep > 1:
        ent = generation.decode_megastep_paged(
            eng.model, eng.megastep, eng.kv_dtype, eng.attn_impl)
    else:
        ent = generation.decode_step_paged(eng.model, eng.kv_dtype,
                                           eng.attn_impl)
    last = ent["graphs"]["sampled" if sampled else "greedy"].last
    return None if last is None else jit.graph_kernels(last.graph)


def finish_set(prompts, toks, n):
    """Requests that end in the middle of an N = ``n`` megastep: one on
    its eos, one on a stop sequence (each where the token, or the pair,
    first appears after k decode tokens, k % n != 0), two on budgets of
    13 and 21 tokens, four plain; chosen from greedy outputs ``toks`` of
    the same prompts."""
    eos = stop = None
    for p, t in zip(prompts, toks):
        k = next((k for k in range(1, len(t))
                  if k % n and t[k] not in t[:k]), None)
        if eos is None and k is not None:
            eos = (p, {"max_new_tokens": 32, "eos_token_id": t[k]})
            continue
        pairs = [None] + [tuple(t[j - 1:j + 1]) for j in range(1, len(t))]
        k = next((k for k in range(1, len(t))
                  if k % n and pairs[k] not in pairs[:k]), None)
        if stop is None and k is not None:
            stop = (p, {"max_new_tokens": 32, "stop": [list(pairs[k])]})
        if eos and stop:
            break
    if eos is None or stop is None:
        raise AssertionError("no eos or stop fires mid-megastep in the "
                             "greedy outputs")
    return [eos, stop, (prompts[2], {"max_new_tokens": 13}),
            (prompts[3], {"max_new_tokens": 21})] + \
        [(p, {"max_new_tokens": 32}) for p in prompts[4:8]]


def check_finishes(specs, out, n):
    """Each request of :func:`finish_set` ended where it should, after a
    number of decode tokens that is not a multiple of ``n``."""
    for (p, kw), t in zip(specs, out):
        decoded = len(t) - 1
        if "eos_token_id" in kw:
            ok = t[-1] == kw["eos_token_id"] and len(t) < 32
        elif "stop" in kw:
            ok = t[-2:] == kw["stop"][0] and len(t) < 32
        else:
            ok = len(t) == kw["max_new_tokens"]
        if not ok or decoded % n == 0:
            raise AssertionError(f"request {kw} ended after {len(t)} "
                                 f"tokens, not mid-megastep as built")


def serving_modes(torch, ctr, card):
    """Phase 17: gpt2-medium (full width and depth, f32, phase 4's
    geometry and requests) served eagerly (``jit.no_capture()``),
    captured (megastep 1) and at megastep ``MEGASTEP``, in one process:
    tokens/s, TTFT and TPOT, the decode step's host time against its
    device busy time, kernels per step and peak memory of each. The
    captured tokens must equal the eager ones (near ties as in phase 4),
    the megastep's the captured ones exactly, also on requests whose
    eos, stop sequence and budget end them mid-megastep; then a weight
    swap mid-run captures nothing and gives the tokens an eager engine
    gives when it swaps at the same step."""
    from paddle_tpu_torch import jit
    from paddle_tpu_torch.models.gpt import GPT_CONFIGS, GPTForCausalLM
    cfg = GPT_CONFIGS["gpt2-medium"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = GPTForCausalLM(cfg, device="cuda", generator=gen).eval()
    prompts = serving_prompts(cfg.vocab_size)
    specs = [(p, {"max_new_tokens": 32}) for p in prompts]
    modes = {"eager": (False, 1), "captured": (True, 1),
             f"megastep{MEGASTEP}": (True, MEGASTEP)}
    res, toks = {}, {}
    for mode, (capture, n) in modes.items():
        release_graphs(torch, model)
        with contextlib.nullcontext() if capture else jit.no_capture():
            eng = serving_engine(model, "f32", "kernel", megastep=n)
            warm(torch, eng)
            res[mode], toks[mode] = drive(torch, ctr, eng, specs, mode)
            res[mode].update(decode_profile(torch, ctr, eng, mode))
            res[mode]["graphs"] = captures(model)
        del eng
    release_graphs(torch, model)
    ties = same_tokens(torch, model, prompts, toks["eager"],
                       toks["captured"], "captured vs eager")
    same_tokens(torch, model, prompts, toks["captured"],
                toks[f"megastep{MEGASTEP}"], "megastep vs captured",
                ties=False)
    log(f"  captured tokens == eager tokens ({len(ties)} near ties); "
        f"megastep {MEGASTEP} tokens == captured tokens (every request "
        "ends on its budget mid-megastep)")

    fin = finish_set(prompts, toks["captured"], MEGASTEP)
    out = {n: serve_all(torch, serving_engine(model, "f32", "kernel",
                                              megastep=n), fin)
           for n in (1, MEGASTEP)}
    check_finishes(fin, out[1], MEGASTEP)
    same_tokens(torch, model, [p for p, _ in fin], out[1], out[MEGASTEP],
                "megastep vs captured, mid-megastep finishes", ties=False)
    log(f"  megastep {MEGASTEP} == megastep 1 on requests ending mid-"
        "megastep on an eos, a stop sequence and budgets of 13 and 21")
    release_graphs(torch, model)

    swap = swap_weights_check(torch, model, prompts[:8], toks["captured"])
    for mode, r in res.items():
        log(f"  [{card}] {mode}: {r['tokens_per_s']:.1f} tokens/s, TTFT p50 "
            f"{r['ttft_p50_ms']:.3f} / p99 {r['ttft_p99_ms']:.3f} ms, TPOT "
            f"p50 {r['tpot_p50_ms']:.3f} / p99 {r['tpot_p99_ms']:.3f} ms; "
            f"decode step {r['decode_step_ms']:.3f} ms, busy "
            f"{r['decode_busy_ms']:.3f} ms, idle share "
            f"{r['decode_idle_share']:.4f}, {r['kernels_per_decode_step']:.0f}"
            f" kernels per step; {memory_line(r)}; {r['graphs']} graphs")
    return {"modes": res, "captured_vs_eager_near_ties": ties,
            "swap": swap}


def swap_weights_check(torch, model, prompts, before):
    """A second seeded state swapped in after ``SWAP_AT`` engine steps,
    with all requests in flight: the captured engine (warmed) captures
    nothing and keeps every parameter's address, and its tokens equal
    an eager engine's that swaps at the same step; the swap shows (some
    request's tokens differ from ``before``, the unswapped run)."""
    from paddle_tpu_torch import jit
    from paddle_tpu_torch.models.gpt import GPTForCausalLM
    first = {n: p.detach().clone() for n, p in model.named_parameters()}
    gen = torch.Generator(device="cuda").manual_seed(1)
    second = {n: p.detach().clone() for n, p in GPTForCausalLM(
        model.cfg, device="cuda", generator=gen).named_parameters()}
    specs = [(p, {"max_new_tokens": 32}) for p in prompts]
    out = {}
    for mode in ("eager", "captured"):
        with jit.no_capture() if mode == "eager" else \
                contextlib.nullcontext():
            eng = serving_engine(model, "f32", "kernel")
            warm(torch, eng)
            cap0, keys0 = captures(model), set(model._step_compile_cache)
            ptrs = [p.data_ptr() for p in model.parameters()]
            reqs = [eng.submit(p, **kw) for p, kw in specs]
            for _ in range(SWAP_AT):
                eng.step()
            if any(r.state != "running" for r in reqs):
                raise AssertionError("a request ended before the swap")
            eng.swap_weights(second)
            eng.run_until_idle()
            torch.cuda.synchronize()
            out[mode] = [r.tokens for r in reqs]
            if captures(model) != cap0 or \
                    set(model._step_compile_cache) != keys0 or \
                    [p.data_ptr() for p in model.parameters()] != ptrs or \
                    eng.weight_version != 1:
                raise AssertionError(f"{mode}: the swap captured, built an "
                                     "entry or moved a parameter")
            eng.swap_weights(first)
        del eng
        release_graphs(torch, model)
    same_tokens(torch, model, prompts, out["eager"], out["captured"],
                "swap: captured vs eager", ties=False)
    if out["captured"] == before[:len(prompts)]:
        raise AssertionError("the swap changed no token")
    log(f"  swap_weights after {SWAP_AT} steps: 0 captures, 0 entries, "
        "every parameter in place; tokens == the eager engine's")
    return {"swap_at_step": SWAP_AT, "captures": 0, "requests": len(prompts)}


# ------------------------------------------------------------ phase 18
RESNET_BATCH, RESNET_IMG = 128, 224     # bench.py's ResNet-50 (:1248-1252)
RESNET_K = 10                           # bench.py's BENCH_STEPS
RESNET50_FWD_FLOPS_224 = 4.089e9        # bench.py:263
PLANE_STEPS = 5
#: updates per timing of an optimizer's update alone
UPDATE_REPS = 5


def snapshot(model):
    """Clones of the model's parameters and buffers."""
    return ([p.detach().clone() for p in model.parameters()],
            [b.detach().clone() for b in model.buffers()])


def restore(torch, model, snap):
    """The parameters and buffers of :func:`snapshot`, copied back in
    place; every gradient cleared."""
    with torch.no_grad():
        for p, s in zip(model.parameters(), snap[0]):
            p.copy_(s)
        for b, s in zip(model.buffers(), snap[1]):
            b.copy_(s)
    model.zero_grad(set_to_none=True)


def optimizer_run(torch, ctr, model, make_opt, loss_of, captured,
                  steps=PLANE_STEPS, between=None, traced=0,
                  time_update=False):
    """``steps`` steps of the :func:`_stepper` step with ``make_opt(model)``
    from the model's current state, eagerly or through
    ``jit.to_static`` (calls 1 and 2 warm up eagerly, the second finding
    the gradients the first left; call 3 captures; later calls replay).
    ``between(opt)`` runs after each step (a scheduler's ``step()``).
    Returns the losses, the lr slots each step read (the optimizer's lr
    tensor after the call), the launch counts, the parameters, buffers
    and optimizer state after the steps and, captured, the graphs and
    warmed keys; with ``traced``, the device busy ms per step of that
    many more steps; with ``time_update``, the optimizer's ``step()``
    alone, :data:`UPDATE_REPS` times on the last step's gradients in
    one trace (device ms and kernels per update)."""
    from paddle_tpu_torch import jit
    opt = make_opt(model)
    step = _stepper(model, opt, loss_of)
    fast = jit.to_static(step, layers=[model], optimizers=[opt]) \
        if captured else step
    dev = next(model.parameters()).device
    ctr.zero()
    losses, lrs = [], []
    for _ in range(steps):
        losses.append(fast())
        lrs.append(opt._lr[dev].tolist())
        if between is not None:
            between(opt)
    torch.cuda.synchronize()
    out = {"losses": [float(x) for x in losses], "lrs": lrs,
           "launches": ctr.read(),
           "params": [p.detach().clone() for p in model.parameters()],
           "buffers": [b.detach().clone() for b in model.buffers()],
           "state": {k: v.detach().clone()
                     for k, v in opt.state_dict().items() if k != "_lr"}}
    if captured:
        out["graphs"] = len(fast._step.graphs)
        out["warmed"] = len(fast._step.warmed)
    if traced:
        with ctr.aside():
            out["busy_ms"] = device_busy_ms(
                torch, lambda: [fast() for _ in range(traced)]) / traced
    if time_update:
        out["update"] = time_update_alone(torch, ctr, opt)
    del fast, step, opt
    model.zero_grad(set_to_none=True)
    torch.cuda.empty_cache()
    return out


def time_update_alone(torch, ctr, opt):
    """The optimizer's ``step()`` alone, :data:`UPDATE_REPS` times on the
    last step's gradients: device ms and kernels per update. The ms are
    a trace's busy time, unless the trace holds fewer ``adamw`` kernels
    than the wrapper launched: late in this script the profiler has
    dropped launches of that library (the one launch of a trace in one
    run, two or three of five in others), while it kept every launch in
    a process of its own. Then CUDA events time the updates on the
    device (:func:`event_ms`). Kernels are the trace's others and the
    wrappers' launches."""
    def run():
        for _ in range(UPDATE_REPS):
            opt.step()

    with ctr.aside():
        before = sum(ctr.read().values())
        ms, names = trace_once(torch, run)
        launched = sum(ctr.read().values()) - before
        seen = sum(n for k, n in names.items() if "adamw_multi_kernel" in k)
        if ms is None or seen < launched:
            log(f"  the profiler recorded {seen} of {launched} adamw "
                "launches; CUDA events time the update")
            ms = event_ms(torch, run)
    kernels = sum(names.values()) - seen + launched
    return {"ms": ms / UPDATE_REPS, "kernels": kernels / UPDATE_REPS}


def hold_same(torch, ctr, eager, captured, what, want):
    """The captured run bit-equal to the eager one (losses, parameters,
    buffers, optimizer state, the lr each step read), one graph captured
    and nothing captured after it, the launch counts of each run exactly
    ``want``, the losses finite."""
    bad = []
    if eager["losses"] != captured["losses"]:
        bad.append("losses")
    if eager["lrs"] != captured["lrs"]:
        bad.append("learning rates")
    for kind in ("params", "buffers"):
        n = sum(not torch.equal(a, b)
                for a, b in zip(eager[kind], captured[kind]))
        if n:
            bad.append(f"{n} of {len(eager[kind])} {kind}")
    if set(eager["state"]) != set(captured["state"]):
        bad.append("state keys")
    else:
        n = sum(not torch.equal(v, captured["state"][k])
                for k, v in eager["state"].items())
        if n:
            bad.append(f"{n} of {len(eager['state'])} state tensors")
    if bad:
        raise AssertionError(f"{what}: captured differs from eager in "
                             f"{bad}; losses {eager['losses']} vs "
                             f"{captured['losses']}")
    if captured["graphs"] != 1 or captured["warmed"] != 2:
        raise AssertionError(f"{what}: {captured['graphs']} graphs, "
                             f"{captured['warmed']} warm-ups: a capture "
                             "after the first")
    if not all(np.isfinite(eager["losses"])):
        raise AssertionError(f"{what}: losses {eager['losses']}")
    for label, r in (("eager", eager), ("captured", captured)):
        ctr.expect(r["launches"], want, f"{what}, {label}")
    log(f"  {what}: {len(eager['losses'])} steps, losses "
        f"{eager['losses']}; captured (2 warm-up calls, 1 capture, "
        f"{len(eager['losses']) - 3} replays) bit-equal to eager in losses, "
        f"{len(eager['params'])} parameters, {len(eager['buffers'])} "
        f"buffers and {len(eager['state'])} state tensors; launches per "
        f"run {captured['launches'] or 'none (plain updates)'}")


def lamb_from_powers(torch, opt, model):
    """Zero moments and beta powers beta^1 for every parameter, as
    Paddle's own LAMB initializes them: from the powers 1 that both
    packages create, the reference's ``lamb`` op divides by 1 - 1 = 0 at
    the first step (ROADMAP queue C)."""
    state = {}
    for n, p in model.named_parameters():
        state.update({f"{n}:m1": torch.zeros_like(p),
                      f"{n}:m2": torch.zeros_like(p),
                      f"{n}:b1p": torch.full((1,), 0.9, device=p.device),
                      f"{n}:b2p": torch.full((1,), 0.999, device=p.device)})
    opt.set_state_dict(state)
    return opt


def resnet_inputs(torch, batch=RESNET_BATCH, img=RESNET_IMG):
    """bench.py's first ResNet batch (``:295-297``, numpy
    ``RandomState(0)``) on the card, and the generator left after it."""
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(batch, 3, img, img).astype(
        np.float32)).cuda()
    labels = torch.from_numpy(rng.randint(0, 1000, (batch,)).astype(
        np.int64)).cuda()
    return x, labels, rng


def resnet_loss(model, x, labels, level="O2", dtype="bfloat16"):
    """``bench.py``'s forward: ``CrossEntropyLoss`` of the model's logits
    under ``auto_cast(level)``."""
    from paddle_tpu_torch.amp import auto_cast
    from paddle_tpu_torch.nn.layers_common import CrossEntropyLoss
    ce = CrossEntropyLoss()

    def loss_of():
        with auto_cast(level=level, dtype=dtype):
            return ce(model(x), labels)

    return loss_of


def resnet(torch, name):
    from paddle_tpu_torch import vision
    gen = torch.Generator(device="cuda").manual_seed(0)
    return getattr(vision, name)(num_classes=1000, device="cuda",
                                 generator=gen)


def optimizer_plane(torch, ctr, card, trn):
    """Phase 18: the optimizer plane on the card, each optimizer's
    captured run from the same weights bit-equal to its eager run over
    :data:`PLANE_STEPS` steps (:func:`hold_same`). gpt2-medium at full
    width and depth (phase 7's step) with AdamW, bf16 moments,
    ``GradientClipByGlobalNorm(1.0)`` folded into the kernel, a
    ``LinearWarmup(CosineAnnealingDecay)`` schedule stepped between calls
    (each step reads the lr it was given) and ``lr_scale`` 0.1 on both
    embeddings (a second lr slot): 24 launches of each flash kernel and
    one of ``adamw`` per step; then the clip's norm timed against its
    bound and the captured step's busy time against phase 7's (no
    clip). LAMB on ERNIE-base (phase 11's step, LayerNorm kernels off:
    no launch), LarsMomentum on ResNet-50 (phase 19's batch) and SGD,
    Momentum with Nesterov, Adagrad, RMSProp, Ftrl and Adam (the kernel
    at coeff 0: one launch per step) on ResNet-18 at batch 32, 224 x 224.
    cuDNN runs deterministic here (``torch.backends.cudnn.deterministic``)
    so that the eager and the captured convolutions take the same
    algorithms."""
    from paddle_tpu_torch import optimizer as O
    torch.backends.cudnn.deterministic = True
    out = {}
    cfg, model, loss_of, _ = train_step(torch)
    for n, p in model.named_parameters():
        if n.endswith(("wte.weight", "wpe.weight")):
            p.lr_scale = 0.1
    start = snapshot(model)

    def adamw_clipped(m):
        sched = O.lr.LinearWarmup(O.lr.CosineAnnealingDecay(1e-4, 8), 2,
                                  1e-5, 1e-4)
        return O.AdamW(learning_rate=sched,
                       parameters=m.named_parameters(),
                       moment_dtype="bfloat16",
                       grad_clip=O.GradientClipByGlobalNorm(1.0))

    runs = {}
    for captured in (False, True):
        restore(torch, model, start)
        runs[captured] = optimizer_run(
            torch, ctr, model, adamw_clipped, loss_of, captured,
            between=lambda o: o._learning_rate.step(),
            traced=2 if captured else 0)
    L = cfg.num_layers
    n = PLANE_STEPS
    hold_same(torch, ctr, runs[False], runs[True],
              "gpt2-medium, AdamW + global-norm clip + warmup/cosine + "
              "lr_scale 0.1 on the embeddings",
              {"flash_fwd": L * n, "flash_bwd_dq": L * n,
               "flash_bwd_dkv": L * n, "adamw": n})
    log(f"  gpt2-medium: lr slots [1.0, 0.1] each step read: "
        f"{runs[True]['lrs']}")
    grads = [torch.randn(p.shape, device="cuda",
                         generator=torch.Generator(device="cuda")
                         .manual_seed(7)) * 1e-3 for p in model.parameters()]
    clip = O.GradientClipByGlobalNorm(1.0)
    with ctr.aside():
        norm_ms = time_fn(torch, lambda i: clip.scale(grads), 10, 1)
    n_el = sum(g.numel() for g in grads)
    nb = bound(4 * n_el, 2 * n_el, F32_FLOPS)
    busy_clip, busy_plain = runs[True]["busy_ms"], \
        trn["captured"]["device_busy_ms"]
    log(f"  [{card}] GradientClipByGlobalNorm's norm over gpt2-medium's "
        f"{len(grads)} f32 gradients ({n_el} values): {norm_ms:.4f} ms "
        f"against its bound {nb['bound_ms']:.4f} ms ({nb['bytes']} B read "
        f"once, {nb['bound_by']}), {norm_ms / nb['bound_ms']:.2f}x; captured "
        f"step device busy {busy_clip:.3f} ms with the clip and lr slots "
        f"against phase 7's {busy_plain:.3f} ms without")
    out["gpt2_medium"] = {"losses": runs[True]["losses"],
                          "lrs": runs[True]["lrs"],
                          "launches": runs[True]["launches"],
                          "norm_ms": norm_ms, "norm_bound": nb,
                          "busy_ms_clip": busy_clip,
                          "busy_ms_no_clip": busy_plain}
    del model, start, grads, runs
    torch.cuda.empty_cache()

    _, model, loss_of, _ = ernie_step(torch)
    start = snapshot(model)
    runs = {}
    for captured in (False, True):
        restore(torch, model, start)
        runs[captured] = optimizer_run(
            torch, ctr, model,
            lambda m: lamb_from_powers(torch, O.Lamb(
                learning_rate=1e-4, parameters=m.named_parameters()), m),
            loss_of, captured)
    hold_same(torch, ctr, runs[False], runs[True], "ernie-base, Lamb", {})
    out["ernie_lamb"] = {"losses": runs[True]["losses"]}
    del model, start, runs
    torch.cuda.empty_cache()

    for name, batch, opts in (
            ("resnet50", RESNET_BATCH,
             [("LarsMomentum", lambda m: O.LarsMomentum(
                 0.1, momentum=0.9, parameters=m.named_parameters()), {})]),
            ("resnet18", 32,
             [("SGD", lambda m: O.SGD(0.1, parameters=m.named_parameters()),
               {}),
              ("Momentum, Nesterov", lambda m: O.Momentum(
                  0.1, 0.9, use_nesterov=True,
                  parameters=m.named_parameters()), {}),
              ("Adagrad", lambda m: O.Adagrad(
                  0.01, parameters=m.named_parameters()), {}),
              ("RMSProp", lambda m: O.RMSProp(
                  1e-3, momentum=0.5, parameters=m.named_parameters()), {}),
              ("Ftrl", lambda m: O.Ftrl(
                  0.1, l1=1e-4, l2=1e-4, parameters=m.named_parameters()),
               {}),
              ("Adam", lambda m: O.Adam(
                  1e-3, parameters=m.named_parameters()),
               {"adamw": PLANE_STEPS})])):
        model = resnet(torch, name)
        x, labels, _ = resnet_inputs(torch, batch)
        loss_of = resnet_loss(model, x, labels)
        start = snapshot(model)
        for label, make, want in opts:
            runs = {}
            for captured in (False, True):
                restore(torch, model, start)
                runs[captured] = optimizer_run(
                    torch, ctr, model, make, loss_of, captured,
                    time_update=not captured)
            hold_same(torch, ctr, runs[False], runs[True],
                      f"{name} (batch {batch}, O2), {label}", want)
            upd = runs[False]["update"]
            log(f"  [{card}] {name} {label}: the update alone "
                f"{upd['ms']:.3f} ms, {upd['kernels']:.0f} kernels "
                f"({len(runs[False]['params'])} parameters)")
            out[f"{name}_{label}"] = {"losses": runs[True]["losses"],
                                      "update": upd}
        del model, start, runs, x, labels
        torch.cuda.empty_cache()
    torch.backends.cudnn.deterministic = False
    return out


# ------------------------------------------------------------ phase 19
#: kernel groups of a ResNet step, by a substring of the kernel's name
#: (first match wins)
RESNET_GROUPS = (
    ("batch_norm", ("batch_norm", "batchnorm", "bn_fw", "bn_bw")),
    ("cudnn_conv", ("fprop", "dgrad", "wgrad", "conv", "implicit",
                    "cudnn", "nchwToNhwc", "nhwcToNchw", "xmma_")),
    ("gemm", ("gemm", "gemv", "cutlass")),
    ("reduce", ("reduce",)),
    ("pool", ("pool",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "fill",
                     "copy")),
)


def kernel_groups(names, per):
    """Kernels per step by :data:`RESNET_GROUPS` (``names``: kernel name
    -> count over ``per`` steps)."""
    out = {}
    for name, n in names.items():
        group = next((g for g, pats in RESNET_GROUPS
                      if any(p in name for p in pats)), "other")
        out[group] = out.get(group, 0) + n / per
    return out


def resnet_bench(torch, ctr, card):
    """Phase 19: ``bench.py``'s ResNet-50 step (``child_main_resnet``,
    ``:266-336``), uncut: batch 128, 224 x 224, AMP O2 bf16,
    ``Momentum(0.1, 0.9)``, ``CrossEntropyLoss``, random weights from
    seed 0. First :data:`PLANE_STEPS` eager steps against the same through
    ``jit.to_static`` from the same weights (cuDNN deterministic):
    losses, parameters, BN buffers and velocities bit-equal. Then, with
    cuDNN's defaults (``deterministic`` and ``benchmark`` False),
    bench.py's schedule: 2 ``to_static`` calls on its first batch, K = 10
    batches moved to the card, one warm ``to_static_multi_step`` call and
    one timed; step ms, images/s and MFU by ``bench.py:321-322`` (3 x
    4.089e9 x images/s over 989 TFLOP/s); then a traced K = 2 call: busy
    ms and idle share, kernels per step by group, and Momentum's update
    traced alone (its kernels are elementwise in the replay's trace);
    peak allocated and reserved."""
    from paddle_tpu_torch import jit
    from paddle_tpu_torch import optimizer as O
    model = resnet(torch, "resnet50")
    x1, l1, rng = resnet_inputs(torch)
    loss_of = resnet_loss(model, x1, l1)
    start = snapshot(model)

    def momentum(m):
        return O.Momentum(learning_rate=0.1, momentum=0.9,
                          parameters=m.named_parameters())

    torch.backends.cudnn.deterministic = True
    runs = {}
    for captured in (False, True):
        restore(torch, model, start)
        runs[captured] = optimizer_run(torch, ctr, model, momentum, loss_of,
                                       captured)
    hold_same(torch, ctr, runs[False], runs[True],
              "resnet50 (bench.py's step, cuDNN deterministic), Momentum",
              {})
    del runs
    torch.backends.cudnn.deterministic = False
    restore(torch, model, start)
    opt = momentum(model)
    from paddle_tpu_torch.amp import auto_cast
    from paddle_tpu_torch.nn.layers_common import CrossEntropyLoss
    ce = CrossEntropyLoss()

    def train_step(img_b, lab_b):
        with auto_cast(level="O2"):
            logits = model(img_b)
            loss = ce(logits, lab_b)
        opt.clear_grad()
        loss.backward()
        opt.step()
        return loss

    step = jit.to_static(train_step, layers=[model], optimizers=[opt])
    multi = jit.to_static_multi_step(train_step, layers=[model],
                                     optimizers=[opt])
    k, b = RESNET_K, RESNET_BATCH
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    first = [float(step(x1, l1)) for _ in range(2)]
    xs = torch.from_numpy(rng.randn(k, b, 3, RESNET_IMG, RESNET_IMG)
                          .astype(np.float32)).cuda()
    ls = torch.from_numpy(rng.randint(0, 1000, (k, b)).astype(
        np.int64)).cuda()
    warm = multi(xs, ls)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    ctr.zero()
    t0 = time.perf_counter()
    timed = multi(xs, ls)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / k
    run = ctr.read()
    peak = torch.cuda.max_memory_allocated()
    reserved = torch.cuda.max_memory_reserved()
    ctr.expect(run, {}, "resnet50 timed call")
    losses = first + [float(v) for v in warm] + [float(v) for v in timed]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"resnet50: losses {losses}")
    with ctr.aside():
        busy, names = device_trace(torch, lambda: multi(xs[:2], ls[:2]))
        busy /= 2
        groups = kernel_groups(names, 2)
        for name, n in sorted(names.items(), key=lambda kv: -kv[1])[:12]:
            log(f"    {n / 2:6.1f} per step  {name[:110]}")
        opt_ms, opt_names = device_trace(torch, opt.step)
    imgs = b / dt
    mfu = 3.0 * RESNET50_FWD_FLOPS_224 * imgs / BF16_FLOPS
    # Momentum's least time: each parameter, its gradient and its velocity
    # read once, the parameter and the velocity written once
    upd_bytes = sum(p.numel() * p.element_size() * 5
                    for p in model.parameters())
    res = {"step_ms": dt * 1e3, "images_per_s": imgs, "mfu": mfu,
           "losses": losses, "device_busy_ms": busy,
           "idle_share": 1.0 - busy / (dt * 1e3),
           "kernels_per_step": sum(names.values()) / 2,
           "kernel_groups": groups,
           "momentum_kernels": sum(opt_names.values()),
           "momentum_ms": opt_ms,
           "momentum_bound_ms": upd_bytes / HBM_BYTES_PER_S * 1e3,
           "momentum_bytes": upd_bytes, "peak_bytes": peak,
           "peak_reserved_bytes": reserved, "warm_s": warm_s,
           "cudnn": "deterministic False, benchmark False (defaults)"}
    log(f"  resnet50: losses {losses}")
    log(f"  [{card}] resnet50 (batch {b}, {RESNET_IMG}, O2, Momentum), "
        f"to_static_multi_step K = {k}, cuDNN defaults: step "
        f"{res['step_ms']:.3f} ms, {imgs:.1f} images/s, MFU "
        f"{mfu * 100:.3f}% (bench.py's formula), device busy {busy:.3f} ms "
        f"per step, idle share {res['idle_share']:.4f}, "
        f"{res['kernels_per_step']:.0f} kernels per step by group "
        f"{ {g: round(v, 1) for g, v in groups.items()} }; Momentum's "
        f"update alone {res['momentum_kernels']} kernels, {opt_ms:.3f} ms "
        f"against a {res['momentum_bound_ms']:.4f} ms bound ({upd_bytes} B "
        "moved); "
        f"max_memory_allocated {peak} B, max_memory_reserved {reserved} B; "
        f"2 to_static calls and the warm K call took {warm_s:.1f} s")
    del step, multi, opt, xs, ls
    torch.cuda.empty_cache()
    return res, model, start


# ------------------------------------------------------------ phase 20
def grad_scaler_phase(torch, ctr, model, start):
    """Phase 20: ``GradScaler`` on ResNet-50 at AMP O1 fp16 (batch 128,
    224 x 224, Momentum 0.1/0.9), eagerly. fp16 and not GPT: the port's
    flash kernels take f32 and bf16 only (ROADMAP queue C). From 2^16 the
    scaler first backs off (halving every second overflowing step) until
    a step's gradients are finite; from a quarter of that scale, two
    normal steps update every parameter; two steps with an inf injected into a
    gradient leave every parameter and velocity bit-unchanged, and the
    scale halves after the second (``decr_every_n_nan_or_inf`` 2); a
    normal step then updates again. Last, ``unscale_`` inside a
    ``jit.to_static`` capture raises."""
    from paddle_tpu_torch import jit
    from paddle_tpu_torch import optimizer as O
    from paddle_tpu_torch.amp import GradScaler
    restore(torch, model, start)
    x, labels, _ = resnet_inputs(torch)
    loss_of = resnet_loss(model, x, labels, level="O1", dtype="float16")
    opt = O.Momentum(learning_rate=0.1, momentum=0.9,
                     parameters=model.named_parameters())
    scaler = GradScaler(init_loss_scaling=2.0 ** 16,
                        decr_every_n_nan_or_inf=2)
    first = next(model.parameters())
    ctr.zero()

    def scaled_backward():
        loss = loss_of()
        opt.clear_grad()
        scaler.scale(loss).backward()
        return loss

    backoff = []
    while True:               # the scaler backs off until fp16 holds
        scaled_backward()
        scaler.step(opt)
        backoff.append((scaler.get_loss_scaling(), scaler._found_inf))
        if not scaler._found_inf:
            break
        if len(backoff) == 40:
            raise AssertionError(f"fp16: no finite step in {backoff}")
    start_scale = backoff[-1][0] / 4
    scaler.load_state_dict({"scale": start_scale, "good_steps": 0,
                            "bad_steps": 0})
    scales, losses = [], []
    for i, inject in enumerate((False, False, True, True, False)):
        loss = scaled_backward()
        if inject:
            first.grad.view(-1)[0] = float("inf")
        before = snapshot(model)[0]
        state = {k: v.clone() for k, v in opt.state_dict().items()
                 if k != "_lr"}
        scaler.step(opt)
        torch.cuda.synchronize()
        same = [torch.equal(a, p) for a, p in zip(before,
                                                  model.parameters())]
        same_state = all(torch.equal(v, opt.state_dict()[k])
                         for k, v in state.items())
        if scaler._found_inf != inject:
            raise AssertionError(f"fp16 step {i}: found_inf "
                                 f"{scaler._found_inf}, loss {float(loss)}")
        if inject and not (all(same) and same_state):
            raise AssertionError(f"fp16 step {i}: an inf gradient moved "
                                 f"{len(same) - sum(same)} parameters")
        if not inject and sum(same) > 0:
            raise AssertionError(f"fp16 step {i}: {sum(same)} parameters "
                                 "did not move")
        scales.append(scaler.get_loss_scaling())
        losses.append(float(loss.detach()))
    if scales != [start_scale] * 3 + [start_scale / 2] * 2:
        raise AssertionError(f"loss scales {scales}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"fp16 losses {losses}")
    ctr.expect(ctr.read(), {}, "resnet50 fp16")
    # the last eager loss would keep its autograd graph, and with it the
    # parameters' gradient accumulators on the default stream, which a
    # capture on the side stream must not meet
    del loss

    def scaled_step():
        loss = loss_of()
        opt.clear_grad()
        scaler.scale(loss).backward()
        scaler.step(opt)
        return loss.detach()

    fast = jit.to_static(scaled_step, layers=[model], optimizers=[opt])
    model.zero_grad(set_to_none=True)
    raised = None
    for call in range(3):
        try:
            fast()
        except RuntimeError as e:
            raised = (call, str(e))
            break
    torch.cuda.synchronize()
    if raised is None or raised[0] != 2 or "GradScaler.unscale_" not in \
            raised[1] or fast._step.graphs:
        raise AssertionError(f"unscale_ under capture: {raised}")
    log(f"  resnet50 fp16 O1 + GradScaler: from 2^16 the scale backed off "
        f"over {len(backoff)} steps (scale, found_inf) {backoff}; from a "
        f"quarter of the first finite scale: losses {losses}, loss scale per "
        f"step {scales}: normal steps moved every parameter, the two inf "
        "steps moved none and left every velocity bit-unchanged, the scale "
        "halved after the second; to_static call 3 (the capture) raised: "
        f"{raised[1][:80]}")
    del fast, opt
    torch.cuda.empty_cache()
    return {"backoff": backoff, "losses": losses, "scales": scales,
            "capture_raised": raised[1]}


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this smoke run needs a CUDA card")
    from paddle_tpu_torch.ops.cuda import _build
    from paddle_tpu_torch.ops.cuda import adamw as aw
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.ops.cuda import flash_pack2 as fp2
    from paddle_tpu_torch.ops.cuda import layer_norm as ln
    from paddle_tpu_torch.ops.cuda import paged_attention as pa

    t_start = time.perf_counter()
    ctr = Counters(pa, fa, ln, fp2, aw)
    card = card_line()
    log("== phase 1: device")
    log(f"  {torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}, "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(f"  nvidia-smi: {card}")

    log("== phase 2: build (one nvcc per source, started together)")
    sources = ["paged_attention", "flash_attention", "layer_norm",
               "flash_pack2", "adamw"]
    t_build = time.perf_counter()
    _build.load_all(sources)
    log(f"  {len(sources)} built in {time.perf_counter() - t_build:.2f} s")
    for name in sources:
        info = _build.builds[name]
        log(f"  {info['path']} built in {info['seconds']:.2f} s")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log(f"  ptxas: {line.strip()}")
    log("  shared headers (in every build's key): " + ", ".join(
        sorted(p.name for p in _build.CSRC.glob("*.cuh"))))
    log("  the tensor-core kernels:")
    for lib in TC_KERNELS:
        check_tc_build(lib, _build.builds[lib])

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    log("== phase 3: kernel vs plain")
    with ctr.aside():
        n_cases, worst = check_kernel(torch, pa)
    log(f"  {n_cases} cases passed, max abs err {worst:.3e}")

    log("== phase 4: serve gpt2-medium (CUDA graphs)")
    srv = check_serving(torch, ctr, card)
    log(f"  engine [{card}]: {srv['tokens_per_s']:.1f} tokens/s "
        f"({srv['tokens']} tokens in {srv['wall_s']:.3f} s), TTFT p50 "
        f"{srv['ttft_p50_ms']:.3f} ms, TPOT p50 {srv['tpot_p50_ms']:.3f} ms, "
        f"max_memory_allocated {srv['peak_bytes']} B, prefix hits "
        f"{srv['prefix_hit_requests']}")
    gc.collect()
    torch.cuda.empty_cache()

    log("== phase 5: time the paged kernel")
    pos, times = time_kernel(torch, pa, ctr, card)
    log(f"  decode pos {pos}")
    torch.cuda.empty_cache()

    log("== phase 5b: sampled and speculative serving, gpt2-medium")
    smp = sampled_serving(torch, ctr, card)

    log("== phase 5c: bench.py's serving block, gpt2-medium: the engine "
        "against sequential greedy_search, dense against paged, offline "
        "generation")
    t_dense = time.perf_counter()
    dns = dense_serving(torch, ctr, card)
    log(f"  phase 5c took {time.perf_counter() - t_dense:.1f} s")

    log("== phase 5d: the replica fleet, gpt2-medium: bench.py's megastep "
        "and router blocks, threads with no warm-up, kill / restart / swap")
    t_fleet = time.perf_counter()
    flt = fleet_serving(torch, ctr, card)
    log(f"  phase 5d took {time.perf_counter() - t_fleet:.1f} s")

    log("== phase 6: flash kernels vs plain")
    n_flash, flash_err = check_flash(torch, fa, ctr)
    log(f"  {n_flash} cases passed, max abs err by kernel {flash_err}")
    torch.cuda.empty_cache()

    log(f"== phase 7: train gpt2-medium (batch {GPT_BATCH}, seq {GPT_SEQ}, "
        "O2 bf16, AdamW bf16 moments), eager and through jit.to_static")
    gpt = train_step(torch)
    trn = train(torch, ctr, card, gpt)
    torch.cuda.empty_cache()

    log(f"== phase 7b: train gpt2-medium at O1 fp16 with GradScaler (batch "
        f"{GPT_BATCH}, seq {GPT_SEQ}), eagerly, {FP16_STEPS} steps")
    f16 = train_fp16(torch, ctr, card)

    log("== phase 8: time the flash kernels (b 8, h 16, s 1024, d 64, bf16, "
        "causal)")
    ftimes = time_flash(torch, fa, ctr, card)

    log("== phase 9: LayerNorm kernels vs plain")
    n_ln, ln_err = check_ln(torch, ln, ctr)
    log(f"  {n_ln} cases passed, max abs err by kernel {ln_err}")
    torch.cuda.empty_cache()

    log("== phase 10: train gpt2-medium with use_pallas_layer_norm on")
    trn_ln = train_ln(torch, ctr, card, gpt)
    log(f"  [{card}] step ms: LayerNorm kernels {trn_ln['step_ms']:.3f} vs "
        f"composed {trn['step_ms']:.3f} (phase 7); MFU "
        f"{trn_ln['mfu'] * 100:.3f}% vs {trn['mfu'] * 100:.3f}%")
    del gpt
    torch.cuda.empty_cache()

    log(f"== phase 11: train ernie-base (batch {ERNIE_BATCH}, seq "
        f"{ERNIE_SEQ}, O2 bf16, AdamW bf16 moments), eager and through "
        "jit.to_static")
    ern = train_ernie(torch, ctr, card)
    torch.cuda.empty_cache()

    log("== phase 12: packed-heads flash forward")
    n_packed, packed_err = check_packed(torch, fa, fp2, ctr)
    log(f"  {n_packed} cases passed, max abs err {packed_err}")
    packed = packed_path(torch, fa, fp2, ctr, card, packed_err)
    n_packed += 1
    torch.cuda.empty_cache()

    log("== phase 13: time the LayerNorm kernels (f32 [8192, 768] and "
        "[8192, 1024])")
    ltimes = time_ln(torch, ln, ctr, card)
    torch.cuda.empty_cache()

    log("== phase 14: AdamW kernel vs plain")
    n_adamw, adamw_err = check_adamw(torch, aw, ctr)
    log(f"  {n_adamw} cases passed, every tensor equal (largest difference "
        f"{adamw_err:.3e})")

    log("== phase 15: the AdamW kernel at the main path's shapes "
        "(gpt2-1p1b's and gpt2-medium's parameters) vs plain; its time")
    atimes = time_adamw(torch, aw, ctr, card)
    adamw_err = max(adamw_err, atimes["main_path_max_abs_err"])
    n_adamw += atimes["main_path_cases"]

    log(f"== phase 16: train gpt2-1p1b (bench.py's flagship: batch "
        f"{GPT_BATCH}, seq {GPT_SEQ}, recompute, O2 bf16, AdamW bf16 "
        f"moments, retain_grads=False) through to_static_multi_step")
    flag = train_flagship(torch, ctr, card)

    log(f"== phase 17: serve gpt2-medium eagerly, captured and at megastep "
        f"{MEGASTEP}; swap its weights mid-run")
    modes = serving_modes(torch, ctr, card)
    greedy_k = smp["profile"]["greedy"]["graph_kernels"]
    phase17_k = modes["modes"]["captured"]["graph_kernels"]
    log(f"  kernel nodes of the decode graph: phase 5b's greedy graph "
        f"{greedy_k}, phase 17's captured step {phase17_k}")
    if greedy_k is None or greedy_k != phase17_k:
        raise AssertionError("the greedy decode graph runs another kernel "
                             "count than phase 17's captured step")

    log("== phase 18: the optimizer plane (clip, schedule, lr_scale, every "
        "eager optimizer), eager against captured")
    plane = optimizer_plane(torch, ctr, card, trn)

    log(f"== phase 19: bench.py's ResNet-50 step (batch {RESNET_BATCH}, "
        f"{RESNET_IMG} x {RESNET_IMG}, O2 bf16, Momentum) through to_static "
        f"and to_static_multi_step K = {RESNET_K}")
    rn, rn_model, rn_start = resnet_bench(torch, ctr, card)

    log("== phase 20: GradScaler, ResNet-50 at O1 fp16, eagerly")
    scaler = grad_scaler_phase(torch, ctr, rn_model, rn_start)
    del rn_model, rn_start
    torch.cuda.empty_cache()
    log(f"  total {time.perf_counter() - t_start:.1f} s")

    def entry(name, route_source, replaces, launches, err, t, **extra):
        return {"name": name, "route": "cuda",
                "source": f"paddle_tpu_torch/csrc/{route_source}",
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "library_ms": t["library_ms"], **extra}

    main_t = times["f32"]
    mega = flt["megastep"]["arms"]["megastep"]
    kernels = [entry("paged_attention", "paged_attention.cu",
                     "paddle_tpu/ops/pallas/paged_attention.py:55",
                     srv["launches"], max(worst, flt["kernel_max_abs_err"]),
                     {**main_t, "library_ms": None},
                     cases_passed=n_cases + flt["kernel_cases"],
                     by_kv_dtype={kv: times[kv]
                                  for kv in ("f32", "bf16", "int8")},
                     by_shape={"decode": times["f32"],
                               "prefill": times["prefill"],
                               "verify": times["verify_f32"],
                               "decode_block8": times["decode_bs8"]},
                     verify_by_kv_dtype={kv: times[f"verify_{kv}"]
                                         for kv in ("f32", "bf16", "int8")},
                     launches_by_route=srv["routes"],
                     launches_verify=smp["spec"][str(SPEC_K)]["launches"],
                     launches_by_route_verify=smp["spec"][str(SPEC_K)][
                         "routes"],
                     launches_sampled=smp["serving"]["sampled"]["launches"],
                     launches_block8=dns["paged_vs_dense"]["paged"][
                         "launches"],
                     launches_by_route_block8=dns["paged_vs_dense"][
                         "paged"]["routes"],
                     launches_fleet_serial=flt["megastep"]["arms"][
                         "serial"]["launches"],
                     launches_fleet_megastep=mega["launches"],
                     launches_by_route_fleet_megastep=mega["routes"],
                     launches_fleet_router=flt["router"]["launches"],
                     fleet_max_abs_err=flt["kernel_max_abs_err"])]
    for name, line in (("flash_fwd", 40), ("flash_bwd_dq", 109),
                       ("flash_bwd_dkv", 141)):
        t = ftimes[name]
        kernels.append(entry(
            name, "flash_attention.cu",
            f"paddle_tpu/ops/pallas/flash_attention.py:{line}",
            trn["launches"][name], flash_err[name], t, cases_passed=n_flash,
            library_call=t["library_call"],
            tflops_per_s=t["tflops_per_s"],
            bound_fraction=t["bound_fraction"], cuda_route=t["cuda_route"],
            launches_by_route=trn["routes"][name],
            launches_captured=trn["captured"]["launches"][name],
            launches_flagship=flag["launches"][name],
            launches_by_route_flagship=flag["routes"][name],
            simt_f16=ftimes["simt_f16"][name],
            launches_fp16_gpt=f16["launches"][name],
            launches_by_route_fp16_gpt=f16["routes"][name]))
    for name, line in (("ln_fwd", 27), ("ln_bwd", 40)):
        t = ltimes[name]["ernie-base"]
        kernels.append(entry(
            name, "layer_norm.cu",
            f"paddle_tpu/ops/pallas/layer_norm.py:{line}",
            ern["on"]["launches"][name], ln_err[name], t, cases_passed=n_ln,
            library_call=t["library_call"], by_shape=ltimes[name],
            launches_gpt_step=trn_ln["launches"][name],
            launches_captured=ern["captured"]["launches"][name]))
    kernels.append(entry(
        "packed_flash_fwd", "flash_pack2.cu", "tools/flash_pack2_bench.py:48",
        packed["launches"], packed_err["packed_flash_fwd"], packed,
        cases_passed=n_packed,
        library_call="scaled_dot_product_attention", probe=packed["probe"],
        cuda_route=max(packed["routes"], key=packed["routes"].get),
        launches_by_route=packed["routes"]))

    kernels.append(entry(
        "adamw", "adamw.cu", "paddle_tpu/ops/optimizer_ops.py:61",
        trn["launches"]["adamw"], adamw_err, atimes, cases_passed=n_adamw,
        other_update_call="torch.optim.AdamW(fused=True): a different "
        "update (epsilon after the bias correction, f32 moments), for "
        "scale only", other_update_ms=atimes["other_update_ms"],
        shape={"tensors": atimes["tensors"],
               "parameters": atimes["parameters"]},
        launches_captured=trn["captured"]["launches"]["adamw"],
        launches_flagship=flag["launches"]["adamw"],
        grad_scale_ms=atimes["grad_scale_ms"],
        launches_optimizer_plane=plane["gpt2_medium"]["launches"]["adamw"]))

    def summary(r):
        return {k: summary(v) if isinstance(v, dict) and k != "routes"
                else v for k, v in r.items()
                if k not in ("launches", "final")}

    print(json.dumps({"serving": summary(srv), "serving_modes": modes,
                      "sampled_serving": summary(smp),
                      "dense_serving": summary(dns),
                      "fleet_serving": summary(flt), "fp16_gpt": f16,
                      "train": summary(trn), "train_ln": summary(trn_ln),
                      "ernie": summary(ern), "flagship": summary(flag),
                      "adamw": atimes, "optimizer_plane": plane,
                      "resnet50": rn, "grad_scaler": scaler}), flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
