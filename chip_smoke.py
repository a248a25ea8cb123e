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
``beam_search``), its replica fleet, and its load generator's goodput
under a TTFT SLO (SLO admission, priorities, faults, hedged prefill,
cancel and hard deadlines; a disaggregated prefill/decode fleet, its
KV handoff and its worker kills) and its HTTP front end, multi-tenant
LoRA traffic and returning users on the host KV tier, JSON-constrained
requests and the device-cost observatory, soaks a fleet through hours of
simulated traffic with replica kills (one arm under the lock
sanitizer), trains it
(``bench.py``'s step: batch
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
5e ``bench.py``'s loadgen block (``bench.py:847-1065``: calibration,
then one seeded bursty trace at 3x capacity through depth-only and
SLO-aware admission, the SLO engine under injected faults, and a
3-replica router, and D's other half, a 1 x 2 ``DisaggRouter`` warmed by
role (handoffs adopted, graphs per worker, TTFT against the symmetric
half); every engine warmed, no capture in a timed run, no leaked block,
no exception, B4 launched in every phase, completed tokens equal an
unloaded engine's; B4 held to its plain version on the tables a handoff
spliced; a hedged 2-replica fleet against a straggler, the hedge firing,
winning and canceling its loser; a cancel mid-decode whose row the next
request takes, a cancel while queued, a hard deadline ending its request
within one step; at 4 layers, a 1 x 2 fleet across pools whose decode
worker is killed mid-decode (every row re-homed by ``adopt_row``, its
blocks copied bit for bit, f32 and int8, tokens equal an unloaded
engine's, greedy and sampled, B4 on the copied tables, reserved memory
flat) and a 2 x 2 load-generator run with a ``kill_prefill`` and a
``kill_decode``; B4 timed at the loadgen geometry), 5f the HTTP front
end over a started 1 x 2 fleet at 4 layers (generate, the request's
trace, DELETE, 429 with Retry-After, health, Prometheus metrics; no
capture, no leak), 5g tenants (``tools/ci.sh``'s multi-tenant trace
through a rank-8 LoRA pool of two adapters at megastep 1 and 8: no
capture, leak or exception, ``per_tenant`` over base / acme / zeta,
greedy tokens equal single-tenant engines'; three outputs of one prompt;
a reload, an evict and a load mid-service capturing nothing, an evict
refused while pinned; the decode step's busy time and graph kernels
with and without LoRA), 5h returning users on the host KV tier
(``tools/ci.sh``'s returning-users trace: sessions resumed, more parked
than the pool holds, no leak in either tier; a two-block round trip
per pool dtype, int8 bit-exact, B4 on the promoted tables; at 4 layers
a killed prefill worker's chains promoted by the survivor and a
resumed tenant session), 5i JSON-constrained decoding (phase 5e's
geometry at megastep 8 with a grammar over the model's vocabulary:
greedy and sampled constrained rows beside plain ones on the kernel and
the plain route, greedy tokens equal; then a 2-replica router, a 1 x 2
disaggregated fleet and HTTP at 4 layers; every constrained completion
JSON, no capture, B4 on the run's tables, the single-step fallback taken
while a cursor is active; TPOT of constrained against plain rows and the
host ms per mask row), 5j the device-cost observatory on phase 5e's
engine at sample 1.0 (per entry: device ms from CUDA events, FLOPs,
bytes, MFU and HBM share against the H100's data sheet, host-overhead
share; the decode entry's event time against the traced busy time, the
blame identity, captures and sample-0 tokens equal devprof off, a
ledger row gated against itself), 5k the chaos soak (``tools/ci.sh``'s
three soak arms through the port's ``tools/soak.py`` on a 2-replica
gpt2-medium fleet on the virtual clock: 2 simulated hours with 2 kills,
closed-loop abandonment with hedging, and 1 kill from 2 dispatch threads
at megastep 8 with dispatch-ahead in a child process under
``FLAGS_sanitize_locks=1``; the accounting
identity, goodput in every window, no leak or exception, the
predictor's no-op, no capture by a warmed engine and at most a warmed
engine's graphs per replacement, B4 launched per dispatch, reserved
memory flat, sampled tokens equal an unloaded engine's, the sanitizer
clean), 5l dispatch-ahead megasteps (phase 4's engine at megastep 8,
one seeded request set with it off and on per pool dtype: tokens equal,
hits, no capture or leak, B4 per megastep enqueued, the same graph
kernels; the host's commit ms against the device ms of a megastep in
each arm; an admission, a cancel and a weight swap forcing misses on
int8 pools, the committed codes and scales equal the arm without it
after every step), 6 flash kernels vs plain (f32, bf16
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
updates on inf, the scale's rule, and its refusal under capture), 21
Transformer-base (``nn.Transformer()``'s defaults, batch 8, src = tgt =
1024, O2 bf16, AdamW): the kernel routes against the composed ones, 5
steps with 12 non-causal launches of each flash kernel (the encoder's
self-attentions and the cross-attentions) and 30 of each LayerNorm
kernel per step, the device's busy time, the flash kernels at this
shape against SDPA and their bound, and greedy incremental decoding
through ``gen_cache`` equal to the full decoder at every step, 22
``bench.py``'s widedeep step through the static executor (Criteo's 26
slots, embed 16, a 400 x 400 x 400 tower, batch 512, the host-paced
sparse tables with the pull prefetcher): the startup program, 3 steps
each held against the port on the CPU from the card's scope and tables
before it (losses, pre-activations, pushed row gradients, dense
parameters; a ReLU tied at its kink held to its own recomputation), one
capture (the
second run) and none in 50 timed replays, ``set_lr(scope=)`` taken at
the next replay; examples/s, the host's pull and push against the
device's busy time, rows live, peak memory; 23 a Transformer-base
encoder built as a static Program with the ``layers`` builders (6
layers, d 512, 8 heads, FFN 2048, batch 8, seq 1024, f32, AdamW) through
the executor: 3 steps through the flash and LayerNorm kernels against 3
composed ones from one seeded scope, the first step's gradients against
a float64 run, per step 12 / 6 / 6 flash launches (all f32 ``simt``),
24 / 12 LayerNorm launches (the generic grad re-runs the forward) and
96 AdamW launches (one per parameter), one capture; the replayed step's
busy time and the f32 flash kernels at this shape against SDPA; 24 the
Paddle Book: ``tests/test_book.py``'s eight programs built through
``paddle_tpu_torch.fluid`` (``models/book.py``) and run by
``fluid.Executor(fluid.CUDAPlace(0))``, label_semantic_roles at the
upstream chapter's width (hidden 512, depth 8, batch 10), resnet_cifar10
at depth 32 and batch 128, rnn_encoder_decoder at a 30,000-word
vocabulary, then a CTC tagger: 5 steps each, every step held against the
same step on ``fluid.CPUPlace()`` from a copy of the card's state, one
capture per program, the replayed step's time, busy time, idle share and
graph kernels, the AdamW kernel once per ``adam`` op and step, and each
inference model saved and loaded back on the card equal to the trained
program's test clone; 25 control flow and the dense ops: (a) every case
of ``tests/torch_op_cases.py`` (the dense lowerings, forward and grad)
on the card against the port on the CPU, eagerly and captured, the
value-shaped ones raising, and the control-flow programs through the
executor; the ``cond_set`` kernel (``csrc/cond_graph.cu``, an IF node's
condition) against the host's reading and timed; (b) phase 23's encoder
with Transformer-base's warm-up built in the Program (``layers.case``)
for 6 steps through both branches: one capture, phase 23's launches per
step, the lr within 1 ulp of the closed form, bit-equal to a twin fed
that lr; (c) one encoder layer under ``while_loop``: forward at fed trip
counts, the key split at the loop (trip + 1 host reads), bit-equal to
the unrolled twins; trained with ``max_iters`` (IF nodes with the flash
and LayerNorm kernels inside) against the unrolled twins; 26 images,
detection and quantization: (a) every case of
``tests/torch_op_cases_tail.py`` on the card against the CPU, eagerly
and captured, the proposal host ops through the executor's key split;
(b) the YOLOv3 head at ``configs/yolov3_darknet.yml``'s geometry (batch
8 at 608 x 608, 80 classes, 50 ground-truth slots): 3 float64 training
steps against the CPU, one capture, then the float32 inference program
(``yolo_box`` x 3, ``multiclass_nms`` over 22,743 boxes without an M x M
matrix) with the card's NMS rows equal to the CPU's NMS on the card's
boxes and scores;
(c) Faster R-CNN's RPN and RoIAlign at ``configs/faster_rcnn_r50_1x.yml``'s
geometry: 3 float64 steps against the CPU, one capture split into three
graphs at the three host ops, three host reads per run; (d)
``slim.quant_aware`` on resnet_cifar10 (depth 32, batch 128): 3 steps
against the CPU (the loss within the flipped codes' bound), ``convert``
and post-training quantization within 5% of float; 27 the Program
rewrites on phase 23's encoder at full width, flash and LayerNorm
kernels on: (a) ``RecomputeOptimizer(AdamW)`` checkpointed at the six
layer outputs against plain AdamW, 3 steps each, bit-equal (else within
1e-6), the peak allocated memory of the eager run and of the capture
lower with recompute (the executor's liveness), 18 / 6 / 6 flash
launches per step; (b) gradient merge (k 4, avg) under SGD over four
[2, 1024] slices: the parameters unchanged bit for bit through step 3,
then within 1e-5 of one SGD step on the whole batch; (c)
``fleet.distributed_optimizer`` with amp, recompute and gradient merge
around AdamW, 8 steps: every flash launch on the bf16 ``wgmma`` route,
the LayerNorm kernels on f32 inputs, the first loss within 1e-2 of
f32's, one capture; (d) ``PipelineOptimizer(AdamW)``, two stages split
after layer 3, 4 microbatches, 2 steps of GPipe and of 1F1B: one capture
per (stage, phase) program, against each other and against one plain
step; (e) EMA, ModelAverage and Lookahead around AdamW, 6 steps: each
shadow within 1 ulp of a torch recurrence of the same operations,
``ema.apply`` on a captured test clone, the parameters bit-equal after
the block; (f) ``CompiledProgram`` with a ``BuildStrategy`` through
``exe.run``, its losses within 1e-6 of the plain program's.

Usage, from the repository root on a machine with a CUDA card and
``nvcc``:

    python3 chip_smoke.py

Every phase raises on failure; the script then exits nonzero without
printing its result. Its last two lines are the ``kernels`` JSON object
and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import http.client
import json
import os
import subprocess
import sys
import tempfile
import threading
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
    prefill of a suffix after a shared prefix, idle rows included), and
    at phase 5e's loadgen engine (b 4, bs 16, T 4: its decode and its
    prefill buckets 16 and 32, padding rows included). A
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
    # phase 5e's loadgen engine: 4 rows of 64 positions (T 4, blocks of
    # 16), its decode and its prefill buckets 16 and 32, padding rows too
    lg_dec = [int(p) for p in rng.randint(4, 64, size=4)]
    lg_dec[0], lg_dec[1] = 63, 15
    lg_cases = [("loadgen decode s=1 b=4 T=4 f32", lg_dec, 1, 64, "f32",
                 16),
                ("loadgen prefill s=16 b=4 T=4 f32", [0] * 4, 16, 64,
                 "f32", 16),
                ("loadgen prefill s=16 b=4 T=4 1 live f32", [0] * 4, 16,
                 64, "f32", 16, 1),
                ("loadgen prefill s=32 b=4 T=4 f32", [0] * 4, 32, 64,
                 "f32", 16),
                ("loadgen prefill s=32 pos=16 b=4 T=4 3 live f32",
                 [16] * 3 + [0], 32, 64, "f32", 16, 3)]
    for i, case in enumerate(lg_cases):
        worst = max(worst, check_kernel_case(torch, pa, len(cases) + i,
                                             *case, T=4))
    return len(cases) + len(lg_cases), worst


def check_kernel_case(torch, pa, seed, name, pos, s, d, kv, bs, *live,
                      T=None):
    """One kernel case against the plain version: the call must launch on
    its plan's route and stay within TOL. ``T`` is the table width
    (default a 256-token row). Returns the max abs error."""
    elem = {"f32": 4, "bf16": 2, "int8": 1}
    h = 4 if "h=4" in name else 16
    q, pools, tables, posv = make_inputs(
        torch, pos, s, d, kv, h=h, bs=bs, T=256 // bs if T is None else T,
        seed=seed)
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
        model, kv_dtype="f32", attn_impl="kernel")["traces"]["count"]}
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


#: sleep kernels, and the cycles of each, that open every trace before
#: the traced work: the profiler has lost the first few kernels of a
#: trace (a LayerNorm launch of a train step's first layer, in one trace
#: of two in a row), so these take that place and are left out
TRACE_PAD = (16, 20_000)


def trace_once(torch, run):
    """``(busy_ms, kernels)`` of ``run()``: ``torch.profiler`` traces it;
    busy_ms is the union of its device intervals (kernels, copies,
    memsets), None when there is none; kernels the count of each kernel
    name. The trace opens with :data:`TRACE_PAD`'s sleep kernels, done
    before ``run()`` starts: every device interval that ends by the last
    of them is left out."""
    import collections

    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(TRACE_PAD[0]):
            torch.cuda._sleep(TRACE_PAD[1])
        torch.cuda.synchronize()
        run()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    pad_end = max((e["ts"] + e["dur"] for e in dev
                   if e["cat"] == "kernel" and "spin_kernel" in e["name"]),
                  default=None)
    if pad_end is not None:
        dev = [e for e in dev if e["ts"] + e["dur"] > pad_end]
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
    # (key, kv dtype, positions, q_len, block size, table width)
    rows = [(kv, kv, pos, 1, 16, 16) for kv in ("f32", "bf16", "int8")]
    rows += [(f"verify_{kv}", kv, pos, SPEC_K + 1, 16, 16)
             for kv in ("f32", "bf16", "int8")]
    rows.append(("prefill", "f32", [0] * 8, 64, 16, 16))
    rows.append(("decode_bs8", "f32", pos, 1, 8, 32))
    return pos, time_paged_rows(torch, pa, ctr, card, rows)


def time_paged_rows(torch, pa, ctr, card, rows, copies=8):
    """The kernel, its plain version and its read probe timed at each
    row ``(key, kv dtype, positions, q_len, block size, table width)``
    (h 16, d 64) over ``copies`` pool copies, beside the row's bound."""
    out = {}
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
                    "shape": [len(ps), 16, s, 64], "block_size": bs,
                    "table_width": T, "route": pl["route"],
                    "splits": pl["ks"], "rows_per_block": pl["rows"]}
        log(f"  {key} (q_len {s}, blocks of {bs}) {kv}: kernel {ms:.4f} ms, "
            "read probe "
            f"{probe_ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"{nbytes} bytes -> bound {t['bound_ms']:.4f} ms "
            f"({t['bound_by']}), {ms / t['bound_ms']:.2f}x the bound; "
            f"route {pl['route']}, ks {pl['ks']}, "
            f"{pl['rows']} rows/block [{card}]")
    return out

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
        model, SPEC_K, kv_dtype="f32", attn_impl="kernel")["traces"]["count"]
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


# ------------------------------------------------------------ phase 5e
#: bench.py's loadgen block (``child_main_loadgen``, bench.py:847-1065)
#: at batch 4 and seq 64: 4 slots, ``max_len`` 64, buckets
#: ``[max(4, seq // 4), max(8, seq // 2)]`` (64 the terminal one), a
#: queue of 64, f32 pools in blocks of 16, the kernel route
LOADGEN_SLOTS, LOADGEN_LEN, LOADGEN_QUEUE = 4, 64, 64
LOADGEN_BUCKETS = [max(4, LOADGEN_LEN // 4), max(8, LOADGEN_LEN // 2)]
LOADGEN_SEED = 0                  # BENCH_LOADGEN_SEED
LOADGEN_OVERLOAD = 3.0            # BENCH_LOADGEN_OVERLOAD
LOADGEN_DURATION = 2.0            # BENCH_LOADGEN_DURATION
LOADGEN_FAULTS = "serving.submit:skip@0.1;serving.alloc:skip@0.05"
#: the hedged fleet's fixed threshold and delay, and its straggler's
#: pinned prefill prediction and real pace in ms (the load generator's
#: ``--straggler``: each step takes that long, over three calls)
HEDGE_MS, STRAGGLER_MS = 5.0, 60.0
#: the phases' keys bench.py prints (bench.py:1024-1030)
LOADGEN_KEYS = ("offered", "offered_rate", "completed", "shed",
                "shed_total", "exceptions", "slo_attainment",
                "goodput_per_s", "throughput_per_s", "ttft_ms_p50",
                "ttft_ms_p95", "leaked_kv_blocks", "makespan_s")


def loadgen_geometry(**kw):
    return {"max_slots": LOADGEN_SLOTS, "max_len": LOADGEN_LEN,
            "buckets": LOADGEN_BUCKETS, "max_queue": LOADGEN_QUEUE,
            "block_size": 16, "kv_dtype": "f32", "attn_impl": "kernel",
            **kw}


def loadgen_engine(model, **kw):
    from paddle_tpu_torch.serving import ServingEngine
    return ServingEngine(model, **loadgen_geometry(**kw))


def dispatches(eng):
    return eng.prefill_dispatches + eng.decode_steps + \
        eng.megastep * eng.megastep_dispatches


def release_engines(engines):
    """Free each engine's pools and the graphs captured over them."""
    for eng in engines:
        if eng.paged:
            eng.cache.flush_prefix_cache()
        with eng._step_lock:
            eng._release_device()


def timed_loadgen(torch, ctr, target, lg, what, **run_kw):
    """One timed ``LoadGen.run`` of warmed ``target`` with the launch
    counts zeroed before and read after: the launches must be exactly
    ``num_layers`` per prefill or decode dispatch summed over the
    engines, and none may be captured. Raises on a replica step that
    raised (the router's watchdog would take it for a strike), an
    unexpected exception, a leaked block or no B4 launch. Returns the
    report's bench.py keys with the launches and captures, and the
    requests the run submitted (hedge copies left out)."""
    from paddle_tpu_torch.tools.loadgen import LoadGen
    engines = LoadGen._engines(target)
    model = engines[0].model
    n0 = {id(e): len(e._all) for e in engines}
    d0 = {id(e): dispatches(e) for e in engines}
    errors = []
    for i, eng in enumerate(engines):
        def checked(i=i, step=eng.step):
            try:
                return step()
            except BaseException as e:
                errors.append(f"engine {i}: {e!r}")
                raise
        eng.step = checked
    cap0 = captures(model)
    torch.cuda.synchronize()
    ctr.zero()
    try:
        rep = lg.run(target, **run_kw)
    finally:
        for eng in engines:
            del eng.step
    torch.cuda.synchronize()
    run, routes = ctr.read(), ctr.routes()["paged_attention"]
    new_captures = captures(model) - cap0
    engines = LoadGen._engines(target)
    want = model.cfg.num_layers * sum(dispatches(e) - d0.get(id(e), 0)
                                      for e in engines)
    ctr.expect(run, {"paged_attention": want}, what)
    if errors or rep["exceptions"]:
        raise AssertionError(f"{what}: {rep['exceptions']} exceptions, "
                             f"steps raised {errors}")
    if rep["leaked_kv_blocks"]:
        raise AssertionError(f"{what}: {rep['leaked_kv_blocks']} KV "
                             "blocks leaked")
    if not want:
        raise AssertionError(f"{what}: no paged-attention launch")
    if new_captures:
        raise AssertionError(f"{what}: the timed run captured "
                             f"{new_captures} graphs; every engine was "
                             "warmed")
    reqs = {}
    for e in engines:
        for r in e._all[n0.get(id(e), 0):]:
            if not r._hedge_clone:
                reqs.setdefault(r.id, r)
    res = {k: rep[k] for k in LOADGEN_KEYS}
    res.update(launches=want, routes=routes, captures_in_run=new_captures,
               steps=rep["steps"], rehomed=rep["rehomed"],
               canceled_total=rep["canceled_total"],
               chaos_applied=rep["chaos_applied"],
               invalid=sum(1 for d in rep["decisions"] if d[0] == "invalid"))
    for k in ("disagg", "per_tenant", "leaked_lora_pages", "sessions"):
        if k in rep:
            res[k] = rep[k]
    log(f"  {what}: offered {rep['offered']} ({rep['offered_rate']}/s), "
        f"completed {rep['completed']}, shed {rep['shed']}, goodput "
        f"{rep['goodput_per_s']}/s, TTFT p50/p95 {rep['ttft_ms_p50']} / "
        f"{rep['ttft_ms_p95']} ms, makespan {rep['makespan_s']} s, "
        f"leaked {rep['leaked_kv_blocks']}, {want} paged launches "
        f"{routes}, {new_captures} captures")
    return res, [reqs[k] for k in sorted(reqs)]


def check_greedy(torch, model, reqs, what):
    """Every completed request's tokens against the same prompt's tokens
    from an unloaded engine (32 rows, one request per prompt at the
    largest budget it was given), under the top-2 rule."""
    done = [r for r in reqs if r.state == "done"]
    budget = {}
    for r in done:
        key = tuple(r.prompt)
        budget[key] = max(budget.get(key, 0), r.max_new_tokens)
    keys = sorted(budget)
    ref_eng = bench_engine(model, max_slots=32, max_len=LOADGEN_LEN,
                           buckets=LOADGEN_BUCKETS,
                           max_queue=len(keys) + 1)
    toks = serve_all(torch, ref_eng,
                     [(list(k), {"max_new_tokens": budget[k]})
                      for k in keys])
    release_engines([ref_eng])
    ref = dict(zip(keys, toks))
    ties = same_tokens(torch, model, [r.prompt for r in done],
                       [ref[tuple(r.prompt)][:len(r.tokens)] for r in done],
                       [r.tokens for r in done], what)
    log(f"  {what}: {len(done)} completed requests ({len(keys)} prompts) "
        f"== an unloaded engine's tokens ({len(ties)} near ties)")
    return {"checked": len(done), "near_ties": len(ties)}


def straggle(eng):
    """Make ``eng`` the load generator's straggler
    (``paddle_tpu_torch/tools/loadgen.py --straggler``): its predicted
    prefill pinned to ``STRAGGLER_MS``, so the hedge gate sees it coming,
    and each of its steps stretched to that long over three calls (two
    idle, then the step), so the watchdog, which kills a replica after
    three unproductive calls with work, keeps it alive. (A straggler
    that only idles its first steps, as ``tests/test_serving_cancel.py``
    makes one, costs no time, and unhedged the watchdog restarts it and
    the replacement captures its graphs inside the race.)"""
    eng._prefill_ms_pin = STRAGGLER_MS
    orig, state = eng.step, {"n": 0}

    def slow_step():
        time.sleep(STRAGGLER_MS / 3e3)
        state["n"] += 1
        if state["n"] % 3:
            return False
        return orig()
    eng.step = slow_step


def first_token_seen(rt, req):
    """Whether ``req`` or its hedge copy has its first token (a winning
    copy's tokens reach the caller's handle when the copy ends)."""
    if req.first_token_at is not None:
        return True
    h = rt._hedges.get(req.id)
    return bool(h and h["clone"] is not None and
                h["clone"].first_token_at is not None)


def hedge_race(torch, ctr, model, prompt):
    """Two warmed replicas, replica 0 the straggler, one request routed
    to it, with hedging off and at ``HEDGE_MS``: router steps to the
    first token and its TTFT. Neither may capture or leave a block on a
    replica; hedged, the clone must fire, win and cancel its loser with
    reason "hedge_lose"."""
    from paddle_tpu_torch.serving import ReplicaRouter
    from paddle_tpu_torch.tools.loadgen import warmup
    out, reqs = {}, []
    for hedge_ms in (0.0, HEDGE_MS):
        rt = ReplicaRouter(model, n_replicas=2, hedge_ms=hedge_ms,
                           **loadgen_geometry())
        warmup(rt)
        straggle(rt.engines[0])
        cap0 = captures(model)
        d0 = sum(dispatches(e) for e in rt.engines)
        torch.cuda.synchronize()
        ctr.zero()
        req = rt.submit(prompt, max_new_tokens=8)
        time.sleep(2 * HEDGE_MS / 1e3)      # past the hedge delay
        steps = 0
        while not first_token_seen(rt, req):
            rt.step()
            steps += 1
            if steps > 400:
                raise AssertionError("hedge race: no first token")
        rt.run_until_idle()
        torch.cuda.synchronize()
        engines = rt.engines + rt._retiring
        launches = ctr.read()["paged_attention"]
        st = rt.stats()
        leaks = []
        for eng in engines:
            eng.cache.flush_prefix_cache()
            leaks.append(eng.cache.allocator.leaked() - 1)
        arm = {"steps_to_first_token": steps, "ttft_ms": req.ttft * 1e3,
               "state": req.state, "hedges": st.get("hedges"),
               "canceled": st["canceled"], "kills": st["kills"],
               "restarts": st["restarts"],
               "captures": captures(model) - cap0, "launches": launches,
               "leaked_kv_blocks": sum(leaks)}
        if req.state != "done" or any(leaks) or not launches or \
                arm["captures"] or st["kills"]:
            raise AssertionError(f"hedge race at {hedge_ms} ms: {arm}")
        if hedge_ms:
            h = st["hedges"]
            if not (h["fired"] == 1 and h["wins"] == 1 and
                    h["pending"] == 0 and
                    st["canceled"] == {"hedge_lose": 1}):
                raise AssertionError(f"the hedge did not fire, win and "
                                     f"cancel its loser: {arm}")
            want = model.cfg.num_layers * (
                sum(dispatches(e) for e in rt.engines) - d0)
            ctr.expect(ctr.read(), {"paged_attention": want},
                       "the hedged race")
        out["hedged" if hedge_ms else "unhedged"] = arm
        reqs.append(req)
        release_engines(engines)
        del rt
    return out, reqs


def cancel_and_deadlines(torch, ctr, model, ps):
    """One warmed engine on a manual clock: its 4 rows busy and 2
    requests queued; a cancel mid-decode (the row back on the trash
    block, and the next queued request admitted into it at the next
    step), a cancel while queued, and a ``deadline_ms`` that passes
    mid-decode and ends its request within one step."""
    from paddle_tpu_torch.serving import BlockKVCache
    from paddle_tpu_torch.tools.loadgen import warmup
    clk = {"t": 0.0}
    eng = loadgen_engine(model, clock=lambda: clk["t"])
    warmup(eng)
    d0 = dispatches(eng)
    torch.cuda.synchronize()
    ctr.zero()
    busy = [eng.submit(p, max_new_tokens=8) for p in ps[:4]]
    waiting = eng.submit(ps[4], max_new_tokens=8)
    queued = eng.submit(ps[5], max_new_tokens=8)
    for _ in range(2):
        eng.step()
        clk["t"] += 0.005
    victim = busy[0]
    row = victim.slot
    c_decode = eng.cancel(victim.id)
    table = set(eng.cache.tables[row].tolist())
    c_queued = eng.cancel(queued.id)
    eng.step()
    clk["t"] += 0.005
    if c_decode is None or c_decode["stage"] != "decode" or \
            table != {BlockKVCache.TRASH}:
        raise AssertionError(f"cancel mid-decode: {c_decode}, table row "
                             f"{table}")
    if c_queued is None or c_queued["stage"] != "queued":
        raise AssertionError(f"cancel while queued: {c_queued}")
    if waiting.slot != row or waiting.first_token_at is None:
        raise AssertionError(f"the canceled row {row} was not reused by "
                             f"the next queued request (row "
                             f"{waiting.slot})")
    dl = eng.submit(ps[6], max_new_tokens=8, deadline_ms=20.0)
    while dl.first_token_at is None or len(dl.tokens) < 2:
        eng.step()
        clk["t"] += 0.001
    clk["t"] = dl.hard_deadline + 0.001
    before = len(dl.tokens)
    eng.step()
    if dl.state != "canceled" or dl.shed_reason != "deadline" or \
            len(dl.tokens) != before:
        raise AssertionError(f"the hard deadline did not end its request "
                             f"within one step: {dl}")
    while not eng.idle:
        eng.step()
        clk["t"] += 0.005
    torch.cuda.synchronize()
    want = model.cfg.num_layers * (dispatches(eng) - d0)
    ctr.expect(ctr.read(), {"paged_attention": want},
               "cancel and hard deadlines")
    eng.cache.flush_prefix_cache()
    leaked = eng.cache.allocator.leaked() - 1
    st = eng.stats()
    if leaked or st["canceled"] != {"client": 2, "deadline": 1}:
        raise AssertionError(f"cancel and hard deadlines: leaked {leaked},"
                             f" canceled {st['canceled']}")
    reqs = busy + [waiting, queued, dl]
    release_engines([eng])
    out = {"canceled": st["canceled"], "cancel_decode_row": row,
           "deadline_tokens": before, "launches": want,
           "leaked_kv_blocks": leaked}
    return out, reqs


#: the depth of gpt2-medium (full width) in the cross-pool fleet, its
#: chaos run and phase 5f
DISAGG_LAYERS = 4


def medium_at_depth(torch, layers, seed):
    """A seeded gpt2-medium cut to ``layers`` layers (full width)."""
    from paddle_tpu_torch.models.gpt import GPT_CONFIGS, GPTForCausalLM
    cfg = dataclasses.replace(GPT_CONFIGS["gpt2-medium"], num_layers=layers)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return GPTForCausalLM(cfg, device="cuda", generator=gen).eval()


def worker_graphs(model, rt):
    """Per worker of a disaggregated fleet: its role, its pool (index of
    the fleet's distinct pools) and the graphs of ``model``'s step cache
    over that pool, by step kind. A graph's key holds pools, not workers:
    co-located workers share their pool's graphs, so one decode graph
    serves both decode workers of a 1 x 2 fleet."""
    pools, out = [], []
    for eng in rt.engines:
        idx = next((i for i, p in enumerate(pools) if p is eng.cache.pool),
                   None)
        if idx is None:
            pools.append(eng.cache.pool)
            idx = len(pools) - 1
        a = eng.cache.arrays()[0][0]
        first = (a.data_ptr(), "tensor", tuple(a.shape), a.dtype)
        kinds = {}
        for key, ent in getattr(model, "_step_compile_cache", {}).items():
            n = sum(1 for st in ent.get("graphs", {}).values()
                    for k in list(st.graphs) if k[1][0] == first)
            if n:
                kinds[key[0]] = kinds.get(key[0], 0) + n
        out.append({"role": eng.trace_role, "pool": idx, "graphs": kinds})
    return out


def check_handoff_tables(torch, pa, eng, what, seed=0):
    """B4 against its plain version over ``eng``'s live rows, on the block
    tables a handoff produced (spliced, or copied by ``adopt_row``): one
    query row per live row at its last committed position, so every key
    it reads is committed KV. The call must launch on its plan's route
    and stay within TOL. Returns the max abs error."""
    cache = eng.cache
    rows = sorted(eng._active)
    dev = cache.pool.device
    tables = torch.as_tensor(cache.tables[rows], device=dev)
    pos = torch.as_tensor(cache.lengths[rows] - 1, device=dev)
    kv = cache.kv_dtype
    g = torch.Generator(device=dev).manual_seed(seed)
    errs = []
    for li, layer in enumerate(cache.layers):
        kp, vp = layer[0], layer[1]
        ks, vs = (layer[2], layer[3]) if kv == "int8" else (None, None)
        q = torch.randn(len(rows), kp.shape[1], 1, kp.shape[3], device=dev,
                        generator=g)
        elem = {"f32": 4, "bf16": 2, "int8": 1}[kv]
        pl = pa.plan(*q.shape, cache.block_size, tables.shape[1], elem)
        before = pa.launches_by_route["paged_attention"][pl["route"]]
        out = pa.paged_attention(q, kp, vp, tables, pos, k_scale=ks,
                                 v_scale=vs)
        torch.cuda.synchronize()
        if pa.launches_by_route["paged_attention"][pl["route"]] != \
                before + 1:
            raise AssertionError(f"{what}: not launched on the "
                                 f"{pl['route']} route")
        ref = pa.paged_attention_plain(q, kp, vp, tables, pos, k_scale=ks,
                                       v_scale=vs)
        if not bool(torch.isfinite(out).all()):
            raise AssertionError(f"{what}: non-finite output")
        diff = (out.float() - ref.float()).abs()
        over = float((diff - TOL[kv] * ref.float().abs()).max())
        if over > TOL[kv]:
            raise AssertionError(f"{what}, layer {li}: |out - ref| exceeds "
                                 f"{TOL[kv]} + {TOL[kv]} |ref|")
        errs.append(float(diff.max()))
    log(f"  B4 on {what} ({kv}, {len(rows)} rows, tables "
        f"{cache.tables[rows].tolist()}): max abs err {max(errs):.3e} over "
        f"{len(errs)} layers")
    return max(errs)


def unloaded_tokens(torch, model, specs, kv="f32"):
    """The tokens an unloaded engine of the loadgen geometry gives
    ``specs`` (one request per spec, all in flight together)."""
    ref = loadgen_engine(model, kv_dtype=kv)
    toks = serve_all(torch, ref, specs)
    release_engines([ref])
    return toks


def cross_pool_kill(torch, ctr, pa, model, kv, card):
    """A 1 x 2 fleet with a pool per worker (``colocate=False``): greedy
    and seeded sampled requests adopted by decode worker 0 (a copy across
    pools), one decode, then ``kill_decode_worker(0)``: every row
    re-homes through ``adopt_row``. Each copied block must equal its
    source block bit for bit (the int8 codes and scales too), B4 must
    agree with its plain version on the re-homed tables, the tokens must
    equal an unloaded engine's (greedy by the top-2 rule, sampled byte
    for byte), every pool must hold only its trash block after a flush,
    and the reserved memory must not grow across the kill (the dead pool
    and its graphs are freed)."""
    from paddle_tpu_torch.serving import DisaggRouter
    from paddle_tpu_torch.tools.loadgen import warmup
    rt = DisaggRouter(model, n_prefill=1, n_decode=2, colocate=False,
                      **loadgen_geometry(kv_dtype=kv))
    warmup(rt)
    rng = np.random.RandomState(40)
    vocab = model.cfg.vocab_size
    specs = []
    for i in range(LOADGEN_SLOTS):
        kw = {"max_new_tokens": 12}
        if i % 2:
            kw.update(temperature=0.8, top_k=20, top_p=0.9, seed=100 + i)
        specs.append((rng.randint(1, vocab, size=6 + 3 * i).tolist(), kw))
    d0 = sum(dispatches(e) for e in rt.engines)
    torch.cuda.synchronize()
    ctr.zero()
    reqs = [rt.submit(p, **kw) for p, kw in specs]
    dead = rt.decodes[0]
    for _ in range(20):
        rt.step()
        if len(dead._active) == len(reqs):
            break
    rt.step()
    if len(dead._active) != len(reqs):
        raise AssertionError(f"cross-pool {kv}: decode worker 0 holds "
                             f"{len(dead._active)} of {len(reqs)} rows")
    snap = {}
    for row, req in dead._active.items():
        n = dead.cache.blocks_needed(int(dead.cache.lengths[row]))
        idx = torch.as_tensor(dead.cache.tables[row, :n].tolist(),
                              dtype=torch.int64, device=dead.cache.pool.device)
        snap[req.id] = [[a.index_select(0, idx).clone() for a in layer]
                        for layer in dead.cache.layers]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved0 = torch.cuda.memory_reserved()
    torch.cuda.reset_peak_memory_stats()
    info = rt.kill_decode_worker(0)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_reserved()
    survivor = rt.decodes[0]
    blocks = 0
    for req in reqs:
        src = snap[req.id]
        n = src[0][0].shape[0]
        idx = torch.as_tensor(survivor.cache.tables[req.slot, :n].tolist(),
                              dtype=torch.int64,
                              device=survivor.cache.pool.device)
        for layer, src_layer in zip(survivor.cache.layers, src):
            for a, sa in zip(layer, src_layer):
                if not torch.equal(a.index_select(0, idx), sa):
                    raise AssertionError(f"cross-pool {kv}: request "
                                         f"{req.id}'s copied blocks differ "
                                         "from their source")
        blocks += n
    del snap
    with ctr.aside():
        err = check_handoff_tables(torch, pa, survivor,
                                   f"rows adopt_row copied across pools")
    rt.run_until_idle()
    torch.cuda.synchronize()
    run, routes = ctr.read(), ctr.routes()["paged_attention"]
    want = model.cfg.num_layers * (sum(dispatches(e) for e in
                                       rt.engines + rt._retiring) - d0)
    ctr.expect(run, {"paged_attention": want}, f"cross-pool kill ({kv})")
    torch.cuda.empty_cache()
    reserved1 = torch.cuda.memory_reserved()
    st = rt.stats()
    leaks = []
    for pool_cache in {id(e.cache.pool): e.cache
                       for e in rt.engines + rt._retiring}.values():
        pool_cache.flush_prefix_cache()
        leaks.append(pool_cache.allocator.leaked())
    if info != {"rehomed": len(reqs), "shed": 0, "decodes_left": 1} or \
            any(r.state != "done" or not r.rehomed for r in reqs) or \
            leaks != [1, 1, 1] or st["handoffs_copied"] < len(reqs):
        raise AssertionError(f"cross-pool kill ({kv}): {info}, leaks "
                             f"{leaks}, {st}")
    if peak > reserved0 + (4 << 20) or reserved1 > reserved0:
        raise AssertionError(f"cross-pool kill ({kv}): reserved {reserved0}"
                             f" B before, peak {peak} B during, "
                             f"{reserved1} B after")
    ref = unloaded_tokens(torch, model, specs, kv)
    greedy = [i for i, (_, kw) in enumerate(specs) if "seed" not in kw]
    sampled = [i for i in range(len(specs)) if i not in greedy]
    ties = same_tokens(torch, model, [specs[i][0] for i in greedy],
                       [ref[i] for i in greedy],
                       [reqs[i].tokens for i in greedy],
                       f"cross-pool kill ({kv}), greedy")
    same_tokens(torch, model, [specs[i][0] for i in sampled],
                [ref[i] for i in sampled], [reqs[i].tokens for i in sampled],
                f"cross-pool kill ({kv}), sampled", ties=False)
    release_engines(rt.engines + rt._retiring)
    res = {"rehomed": info["rehomed"], "blocks_copied_bit_equal": blocks,
           "handoffs_copied": st["handoffs_copied"],
           "kernel_max_abs_err": err, "reserved_before": reserved0,
           "peak_reserved_during": peak, "reserved_after": reserved1,
           "near_ties": len(ties), "launches": want, "routes": routes}
    log(f"  [{card}] cross-pool kill ({kv}): {info['rehomed']} rows "
        f"re-homed, {blocks} blocks copied bit for bit, tokens == an "
        f"unloaded engine's ({len(greedy)} greedy, {len(sampled)} sampled; "
        f"{len(ties)} near ties), reserved {reserved0} -> peak {peak} -> "
        f"{reserved1} B, {want} paged launches")
    return res


def disagg_chaos(torch, ctr, model, lg_kw):
    """One load-generator run through a warmed 2 x 2 fleet across pools
    with a ``kill_prefill`` and a ``kill_decode`` fired mid-run: both
    applied, every request accounted for, nothing leaked or captured."""
    from paddle_tpu_torch.serving import DisaggRouter
    from paddle_tpu_torch.tools.loadgen import LoadGen, warmup
    rt = DisaggRouter(model, n_prefill=2, n_decode=2, colocate=False,
                      **loadgen_geometry())
    warmup(rt)
    lg = LoadGen(**lg_kw)
    lg.chaos = [{"t": 0.25 * LOADGEN_DURATION, "kind": "kill_prefill",
                 "index": 0},
                {"t": 0.5 * LOADGEN_DURATION, "kind": "kill_decode",
                 "index": 1}]
    res, reqs = timed_loadgen(torch, ctr, rt, lg,
                              "disaggregated 2 x 2 with kill_prefill and "
                              "kill_decode")
    st = rt.stats()
    if res["chaos_applied"] != 2 or res["completed"] + res["rehomed"] + \
            res["shed_total"] + res["canceled_total"] + res["invalid"] != \
            res["offered"] or (st["prefill_workers"],
                               st["decode_workers"]) != (1, 1):
        raise AssertionError(f"disaggregated chaos run: {res}, {st}")
    res["stats_rehomed"] = st["rehomed"]
    release_engines(rt.engines + rt._retiring)
    return res, reqs


def http_serving(torch, ctr, card):
    """Phase 5f: the HTTP front end over a started, warmed 1 x 2
    DisaggRouter (gpt2-medium at ``DISAGG_LAYERS``) on 127.0.0.1: POST
    /v1/generate (tokens == an unloaded engine's), GET
    /v1/requests/<id> (marks with the export and the adoption), a DELETE
    of a long request with the scheduler parked (200 at stage decode,
    then 404), a 429 with Retry-After against a full queue, GET /health,
    GET /metrics (the port's Prometheus validator), no capture, and no
    leaked block after ``stop()``."""
    from paddle_tpu_torch.observability import validate_prometheus_text
    from paddle_tpu_torch.serving import DisaggRouter, ServingHTTPServer
    from paddle_tpu_torch.tools.loadgen import warmup
    model = medium_at_depth(torch, DISAGG_LAYERS, seed=2)
    vocab = model.cfg.vocab_size
    rt = DisaggRouter(model, n_prefill=1, n_decode=2,
                      **loadgen_geometry(max_queue=4))
    warmup(rt)
    cap0 = captures(model)
    d0 = sum(dispatches(e) for e in rt.engines)
    rng = np.random.RandomState(60)
    prompts = [rng.randint(1, vocab, size=6 + 2 * i).tolist()
               for i in range(4)]
    torch.cuda.synchronize()
    ctr.zero()
    srv = ServingHTTPServer(rt, port=0)
    srv.start()
    conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=120)
    statuses = []

    def call(method, path, body=None):
        conn.request(method, path,
                     body=None if body is None else json.dumps(body))
        r = conn.getresponse()
        text = r.read().decode()
        statuses.append((method, "/v1/requests/<id>" if "requests" in path
                         else path, r.status))
        payload = (json.loads(text) if "json" in
                   r.getheader("Content-Type", "") else text)
        return r.status, r.getheader("Retry-After"), payload

    try:
        outs = []
        for p in prompts:
            status, _, out = call("POST", "/v1/generate",
                                  {"ids": p, "max_new_tokens": 8})
            if status != 200 or out["state"] != "done":
                raise AssertionError(f"phase 5f: POST -> {status} {out}")
            outs.append(out)
        status, _, info = call("GET", f"/v1/requests/{outs[0]['id']}")
        kinds = [m["kind"] for m in info["marks"]]
        if status != 200 or not {"export", "adopt"} <= set(kinds):
            raise AssertionError(f"phase 5f: the trace's marks {kinds}")
        rt.stop()                    # park the scheduler
        long = rt.submit(prompts[0], max_new_tokens=LOADGEN_LEN -
                         len(prompts[0]) - 1)
        rt.step()
        rt.step()
        deleted = [call("DELETE", f"/v1/requests/{long.id}")
                   for _ in range(2)]
        if [d[0] for d in deleted] != [200, 404] or \
                deleted[0][2]["stage"] != "decode" or \
                long.state != "canceled":
            raise AssertionError(f"phase 5f: DELETE -> {deleted}")
        fill = [rt.submit(p, max_new_tokens=4) for p in prompts]
        status, retry, refused = call("POST", "/v1/generate",
                                      {"ids": prompts[1],
                                       "max_new_tokens": 4})
        if status != 429 or retry is None or int(retry) < 1:
            raise AssertionError(f"phase 5f: a full queue -> {status}, "
                                 f"Retry-After {retry}, {refused}")
        rt.start()
        rt.results(fill, timeout=120)
        status, _, health = call("GET", "/health")
        status_m, _, text = call("GET", "/metrics")
        samples = validate_prometheus_text(text)
        if status != 200 or not health["ok"] or status_m != 200 or \
                "serving_handoff_queue_depth" not in text:
            raise AssertionError(f"phase 5f: /health {health}, /metrics "
                                 f"{status_m}")
    finally:
        conn.close()
        srv.stop()
    torch.cuda.synchronize()
    run, routes = ctr.read(), ctr.routes()["paged_attention"]
    want = model.cfg.num_layers * (sum(dispatches(e) for e in rt.engines)
                                   - d0)
    ctr.expect(run, {"paged_attention": want}, "phase 5f")
    new_captures = captures(model) - cap0
    leaks = []
    for cache in {id(e.cache.pool): e.cache for e in rt.engines}.values():
        cache.flush_prefix_cache()
        leaks.append(cache.allocator.leaked() - 1)
    if any(leaks) or new_captures or not want:
        raise AssertionError(f"phase 5f: leaked {leaks}, {new_captures} "
                             f"captures, {want} launches")
    ref = unloaded_tokens(torch, model, [(p, {"max_new_tokens": 8})
                                         for p in prompts])
    ties = same_tokens(torch, model, prompts, ref,
                       [o["output_ids"][len(p):] for p, o in
                        zip(prompts, outs)], "phase 5f's POSTs")
    st = rt.stats()
    release_engines(rt.engines)
    release_graphs(torch, model)
    res = {"statuses": statuses, "retry_after_s": int(retry),
           "metrics_samples": samples, "health": health,
           "trace_marks": kinds, "canceled": st["canceled"],
           "handoffs_adopted": st["handoffs_adopted"], "launches": want,
           "routes": routes, "captures": new_captures,
           "near_ties": len(ties)}
    log(f"  [{card}] HTTP over a 1 x 2 fleet: {len(prompts)} POSTs == an "
        f"unloaded engine's tokens ({len(ties)} near ties), marks "
        f"{kinds}, DELETE 200 (stage decode) then 404, 429 with "
        f"Retry-After {retry} s, /metrics {samples} samples valid, "
        f"{want} paged launches, 0 captures, 0 leaked blocks")
    return res


def loadgen_serving(torch, ctr, card):
    """Phase 5e: ``bench.py``'s loadgen block (bench.py:847-1065) on a
    fresh seeded gpt2-medium (f32 pools): calibration (calm TTFT over 4
    lone requests; capacity from 8 x slots saturated requests; the SLO
    max(25, 3 x calm p50) ms; the prefill and TPOT pins from the learned
    EWMAs), then the same seeded bursty trace at 3x capacity through
    phase A (depth-only, scored afterwards against the SLO), B
    (SLO-aware, pinned), C (B under ``fault_scope``) and D's symmetric
    half (a 3-replica ``ReplicaRouter``, scored afterwards); every
    engine warmed first (every bucket and the decode step), each timed
    run capturing nothing. Then a hedged 2-replica fleet against a
    straggler, and cancel and hard deadlines on one engine. Every
    completed greedy request's tokens equal an unloaded engine's (top-2
    rule). The 1.2x goodput gate of bench.py is reported, not asserted:
    it is a wall-clock number on a shared host."""
    from paddle_tpu_torch.models.gpt import GPT_CONFIGS, GPTForCausalLM
    from paddle_tpu_torch.ops.cuda import paged_attention as pa
    from paddle_tpu_torch.resilience import fault_scope
    from paddle_tpu_torch.serving import DisaggRouter, ReplicaRouter
    from paddle_tpu_torch.tools.loadgen import LoadGen, warmup
    torch.cuda.reset_peak_memory_stats()
    cfg = GPT_CONFIGS["gpt2-medium"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = GPTForCausalLM(cfg, device="cuda", generator=gen).eval()
    vocab = cfg.vocab_size
    lo, hi = 4, max(4, LOADGEN_BUCKETS[0] - 1)   # bucket 0 prompts
    lg_kw = dict(mode="bursty", rate=1.0, duration=LOADGEN_DURATION,
                 seed=LOADGEN_SEED, vocab_size=vocab,
                 prompt_tokens=(lo, hi), new_tokens=(2, 8),
                 priority_mix={0: 0.2, 1: 0.6, 2: 0.2})
    out, all_reqs = {}, []

    # calibrate: capacity, calm latency, step costs
    cal = loadgen_engine(model)
    warmup(cal)
    rng = np.random.RandomState(LOADGEN_SEED)
    calm = []
    for _ in range(4):
        r = cal.submit(rng.randint(1, vocab, size=6).tolist(),
                       max_new_tokens=4)
        cal.run_until_idle()
        calm.append(r.ttft * 1e3)
    sat = [cal.submit(rng.randint(1, vocab,
                                  size=rng.randint(lo, hi + 1)).tolist(),
                      max_new_tokens=4)
           for _ in range(8 * LOADGEN_SLOTS)]
    t0 = time.perf_counter()
    cal.run_until_idle()
    torch.cuda.synchronize()
    capacity = len(sat) / (time.perf_counter() - t0)
    slo_ms = max(25.0, 3.0 * float(np.median(calm)))
    prefill_pin = cal._prefill_cost_ms(LOADGEN_BUCKETS[0]) or 1.0
    tpot_pin = cal._tpot_cost_ms() or 0.5
    lg_kw["rate"] = max(2.0, LOADGEN_OVERLOAD * capacity)
    release_engines([cal])
    del cal
    out["calibration"] = {"calm_ttft_ms": calm, "capacity_per_s": capacity,
                          "slo_ttft_ms": slo_ms,
                          "slo_prefill_ms": prefill_pin,
                          "slo_tpot_ms": tpot_pin,
                          "offered_rate": lg_kw["rate"]}
    log(f"  [{card}] calibration: calm TTFT {[round(c, 3) for c in calm]} "
        f"ms, capacity {capacity:.2f} req/s, SLO {slo_ms:.3f} ms, pins "
        f"prefill {prefill_pin:.4f} ms / TPOT {tpot_pin:.4f} ms, offered "
        f"{lg_kw['rate']:.2f} req/s (x{LOADGEN_OVERLOAD:g})")

    slo_kw = dict(slo_ttft_ms=slo_ms, slo_prefill_ms=prefill_pin,
                  slo_tpot_ms=tpot_pin)
    phases = (("depth_only", "phase A, depth-only", {}, {"slo_ttft_ms":
                                                           slo_ms}),
              ("slo_aware", "phase B, SLO-aware", slo_kw, {}),
              ("chaos", "phase C, SLO-aware under faults", slo_kw, {}))
    for key, what, kw, run_kw in phases:
        scope = (fault_scope(LOADGEN_FAULTS, seed=LOADGEN_SEED)
                 if key == "chaos" else contextlib.nullcontext())
        with scope:
            eng = loadgen_engine(model, **kw)
            warmup(eng)
            out[key], reqs = timed_loadgen(torch, ctr, eng,
                                           LoadGen(**lg_kw), what,
                                           **run_kw)
        all_reqs += reqs
        release_engines([eng])
        del eng
    rep_c = out["chaos"]
    if not rep_c["shed"].get("fault") or rep_c["completed"] + \
            rep_c["shed_total"] + rep_c["invalid"] != rep_c["offered"]:
        raise AssertionError(f"phase C: no fault shed, or requests "
                             f"unaccounted for: {rep_c}")
    out["chaos"]["fault_spec"] = LOADGEN_FAULTS
    sym = ReplicaRouter(model, n_replicas=3, **loadgen_geometry())
    warmup(sym)
    out["symmetric_router"], reqs = timed_loadgen(
        torch, ctr, sym, LoadGen(**lg_kw), "phase D, 3 replicas",
        slo_ttft_ms=slo_ms)
    out["symmetric_router"]["workers"] = 3
    all_reqs += reqs
    release_engines(sym.engines + sym._retiring)
    del sym

    # D's disaggregated half (bench.py:988-1004): 1 prefill + 2 decode
    # workers on one pool, warmed by role
    dis = DisaggRouter(model, n_prefill=1, n_decode=2,
                       **loadgen_geometry())
    cap0 = captures(model)
    warmup(dis)
    warm_graphs = captures(model) - cap0
    out["disagg_router"], reqs = timed_loadgen(
        torch, ctr, dis, LoadGen(**lg_kw), "phase D, disaggregated 1 x 2",
        slo_ttft_ms=slo_ms)
    all_reqs += reqs
    d, st = out["disagg_router"], dis.stats()
    if st["handoffs_adopted"] < 1 or d["completed"] < 1:
        raise AssertionError(f"phase D's disaggregated half: {d}, {st}")
    d.update(workers="1x2", graphs_captured_in_warmup=warm_graphs,
             graphs_per_worker=worker_graphs(model, dis),
             handoffs_adopted=st["handoffs_adopted"],
             handoffs_copied=st["handoffs_copied"],
             affinity_hits=st["affinity_hits"],
             affinity_misses=st["affinity_misses"])
    sy = out["symmetric_router"]
    log(f"  [{card}] phase D: TTFT p50 / p95 disaggregated "
        f"{d['ttft_ms_p50']} / {d['ttft_ms_p95']} ms vs symmetric "
        f"{sy['ttft_ms_p50']} / {sy['ttft_ms_p95']} ms (bench.py asserts "
        f"p95 only on a TPU; reported), goodput {d['goodput_per_s']} vs "
        f"{sy['goodput_per_s']} /s, handoffs adopted "
        f"{d['handoffs_adopted']} (copied {d['handoffs_copied']}), "
        f"affinity hits / misses {d['affinity_hits']} / "
        f"{d['affinity_misses']}, {warm_graphs} graphs captured in the "
        f"warm-up, per worker {d['graphs_per_worker']}")
    # B4 against its plain version on the tables the handoff spliced
    hp = [np.random.RandomState(50 + i).randint(1, vocab, size=9 + i)
          .tolist() for i in range(LOADGEN_SLOTS)]
    with ctr.aside():
        live = [dis.submit(p, max_new_tokens=8) for p in hp]
        dis.step()
        d["kernel_on_handoff_tables"] = [
            check_handoff_tables(torch, pa, e, f"spliced rows, decode "
                                 f"worker {i}")
            for i, e in enumerate(dis.decodes) if e._active]
        dis.run_until_idle()
    if not d["kernel_on_handoff_tables"]:
        raise AssertionError("no decode worker adopted the handoffs")
    all_reqs += live
    release_engines(dis.engines + dis._retiring)
    del dis

    goodput_a = out["depth_only"]["goodput_per_s"] or 0.0
    goodput_b = out["slo_aware"]["goodput_per_s"] or 0.0
    ratio = goodput_b / goodput_a if goodput_a else None
    out["vs_baseline"] = ratio
    out["gate_1_2x_met"] = ratio is not None and ratio >= 1.2
    log(f"  [{card}] vs_baseline (goodput B / A) "
        f"{'n/a' if ratio is None else f'{ratio:.3f}'} (bench gate 1.2x "
        f"{'met' if out['gate_1_2x_met'] else 'missed'}, reported)")

    hp = np.random.RandomState(21).randint(1, vocab, size=8).tolist()
    out["hedge"], reqs = hedge_race(torch, ctr, model, hp)
    all_reqs += reqs
    log(f"  [{card}] hedge race: unhedged TTFT "
        f"{out['hedge']['unhedged']['ttft_ms']:.3f} ms in "
        f"{out['hedge']['unhedged']['steps_to_first_token']} steps, hedged "
        f"{out['hedge']['hedged']['ttft_ms']:.3f} ms in "
        f"{out['hedge']['hedged']['steps_to_first_token']} steps; hedges "
        f"{out['hedge']['hedged']['hedges']}")
    cp = [np.random.RandomState(30 + i).randint(1, vocab, size=8).tolist()
          for i in range(7)]
    out["cancel"], reqs = cancel_and_deadlines(torch, ctr, model, cp)
    all_reqs += reqs
    log(f"  cancel mid-decode (row {out['cancel']['cancel_decode_row']} "
        f"reused by the next queued request), cancel while queued, a hard "
        f"deadline ended within one step: canceled "
        f"{out['cancel']['canceled']}, leaked 0")
    out["tokens"] = check_greedy(torch, model, all_reqs,
                                 "phase 5e's completed requests")
    launches = {k: out[k]["launches"] for k in
                ("depth_only", "slo_aware", "chaos", "symmetric_router",
                 "disagg_router")}
    launches["hedge"] = out["hedge"]["hedged"]["launches"]
    launches["cancel"] = out["cancel"]["launches"]
    out["launches"] = launches
    out["routes"] = {k: out[k]["routes"] for k in
                     ("depth_only", "slo_aware", "chaos",
                      "symmetric_router", "disagg_router")}

    # the disaggregated fleet across pools, at DISAGG_LAYERS: a decode
    # worker killed mid-decode, then kill_prefill / kill_decode chaos
    small = medium_at_depth(torch, DISAGG_LAYERS, seed=1)
    out["cross_pool_kill"] = {kv: cross_pool_kill(torch, ctr, pa, small,
                                                  kv, card)
                              for kv in ("f32", "int8")}
    out["disagg_chaos"], reqs = disagg_chaos(torch, ctr, small, lg_kw)
    launches["cross_pool_kill"] = {
        kv: r["launches"] for kv, r in out["cross_pool_kill"].items()}
    launches["disagg_chaos"] = out["disagg_chaos"]["launches"]
    out["routes"]["disagg_chaos"] = out["disagg_chaos"]["routes"]
    release_graphs(torch, small)
    del small

    # B4 at the loadgen geometry against its plain version, and its time
    rng = np.random.RandomState(13)
    dec = [int(p) for p in rng.randint(6, 60, size=LOADGEN_SLOTS)]
    rows = [("loadgen_decode", "f32", dec, 1, 16, 4),
            ("loadgen_prefill16", "f32", [0] * LOADGEN_SLOTS, 16, 16, 4)]
    out["kernel_times"] = time_paged_rows(torch, pa, ctr, card, rows)
    release_graphs(torch, model)
    del model
    gc.collect()
    torch.cuda.synchronize()
    out["max_memory_reserved"] = torch.cuda.max_memory_reserved()
    log(f"  max_memory_reserved during phase 5e (peaks reset by the "
        f"cross-pool kills): "
        f"{out['max_memory_reserved']} B")
    return out


# ------------------------------------------------------------ phase 5g
#: the multi-tenant leg of ``tools/ci.sh:275-283`` at gpt2-medium on
#: phase 5e's geometry: rank-8 adapters of two tenants over a base share
#: of half the traffic, half the rows sampled
LORA_RANK = 8
TENANT_MIX = {"base": 0.5, "acme": 0.3, "zeta": 0.2}
TENANT_SEEDS = {"acme": 1, "zeta": 2}


def tenant_engine(model, megastep=1, **kw):
    """Phase 5e's loadgen engine with a rank-8 adapter pool of two pages,
    ``acme`` and ``zeta`` loaded (``make_adapter`` seeds 1 and 2)."""
    from paddle_tpu_torch.serving import make_adapter
    eng = loadgen_engine(model, lora_rank=LORA_RANK, lora_max_adapters=2,
                         megastep=megastep, **kw)
    for name, seed in TENANT_SEEDS.items():
        eng.load_adapter(name, make_adapter(model.cfg, LORA_RANK, seed=seed))
    return eng


def lora_top2_gap(torch, model, pool, tenant, ids):
    """Gap between the two largest last-position logits of one composed
    paged forward over ``ids`` with ``tenant``'s adapter page (the
    no-cache forward carries no adapter)."""
    bs = 16
    nb = -(-len(ids) // bs)
    kv = model.gpt.gen_block_pool(nb + 1, bs)
    tables = torch.arange(1, nb + 1, dtype=torch.int32,
                          device=model.device)[None]
    pages = np.asarray([pool.page_of(tenant)], np.int32)
    with torch.no_grad():
        lg, _ = model(torch.tensor([ids], device=model.device), cache=kv,
                      cache_pos=0, block_tables=tables,
                      attn_impl="composed", lora=(pages, pool.arrays))
    top = torch.topk(lg[0, -1].float(), 2).values
    return float(top[0] - top[1])


def same_tenant_tokens(torch, model, pool, reqs, ref, what):
    """Every request's tokens against ``ref`` (its prompt's tokens from
    an unloaded engine with the same tenant), under the top-2 rule with
    the tenant's adapter applied. Returns the near ties."""
    ties = []
    for r in reqs:
        a, b = ref[(r.tenant, tuple(r.prompt))][:len(r.tokens)], r.tokens
        if a == b:
            continue
        j = next((k for k, (x, y) in enumerate(zip(a, b)) if x != y),
                 min(len(a), len(b)))
        gap = lora_top2_gap(torch, model, pool, r.tenant, r.prompt + a[:j])
        log(f"  {what}: request {r.id} ({r.tenant or 'base'}) diverges at "
            f"token {j}: reference top-2 logit gap {gap:.3e}")
        if gap >= 1e-3:
            raise AssertionError(f"{what}: request {r.id} differs at token "
                                 f"{j} with top-2 gap {gap}")
        ties.append({"request": r.id, "token": j, "gap": gap})
    return ties


def single_tenant_tokens(torch, ref_eng, specs):
    """``specs`` (``(tenant, prompt, max_new_tokens)``) served on
    ``ref_eng`` one tenant at a time, each tenant's requests alone in the
    engine: ``{(tenant, prompt): tokens}``."""
    out = {}
    for tenant in sorted({t for t, _, _ in specs}):
        mine = [(p, n) for t, p, n in specs if t == tenant]
        reqs = [ref_eng.submit(list(p), max_new_tokens=n, tenant=tenant)
                for p, n in mine]
        ref_eng.run_until_idle()
        torch.cuda.synchronize()
        for (p, _), r in zip(mine, reqs):
            out[(tenant, tuple(p))] = r.tokens
    return out


def tenant_tpot(reqs):
    """TPOT p50 ms of the completed requests, by tenant."""
    by = {}
    for r in reqs:
        if r.state == "done" and r.tpot is not None:
            by.setdefault(r.tenant or "base", []).append(r.tpot)
    return {k: pctl_ms(v, 50) for k, v in sorted(by.items())}


def tenant_serving(torch, ctr, card):
    """Phase 5g: ``tools/ci.sh:275-283``'s multi-tenant leg on a fresh
    seeded gpt2-medium at phase 5e's geometry, the engine built with a
    rank-8 pool of two adapters: bursty at 20/s for 2 s (seed 0),
    4-16-token prompts, 2-8 new tokens, half the rows sampled, tenants
    base 0.5, acme 0.3, zeta 0.2; warmed (greedy and sampled graphs),
    then timed at megastep 1 and 8: 0 exceptions, leaked blocks or
    pages, 0 captures, ``per_tenant`` over the three tenants summing to
    ``completed``, every completed greedy request equal to an unloaded
    single-tenant engine (top-2 rule, the adapter applied). One prompt
    gives three outputs for base, acme and zeta. Live changes: ``acme``
    reloaded (seed 3), ``zeta`` evicted, ``third`` loaded (seed 4): 0
    captures, the next requests equal an engine loaded with the new
    factors from the start, and an evict refused while a request pins
    its page. Reported: the decode step's device busy ms and graph
    kernel nodes with and without LoRA, TPOT p50 by tenant, graphs per
    engine, B4 launches by route."""
    from paddle_tpu_torch.models.gpt import GPT_CONFIGS, GPTForCausalLM
    from paddle_tpu_torch.serving import make_adapter
    from paddle_tpu_torch.tools.loadgen import LoadGen, warmup
    cfg = GPT_CONFIGS["gpt2-medium"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = GPTForCausalLM(cfg, device="cuda", generator=gen).eval()
    lg_kw = dict(mode="bursty", rate=20.0, duration=2.0, seed=0,
                 vocab_size=cfg.vocab_size, prompt_tokens=(4, 16),
                 new_tokens=(2, 8), sample_frac=0.5, tenant_mix=TENANT_MIX)
    out, greedy, launches, routes = {}, [], {}, {}
    engines = {}
    for n in (1, 8):
        eng = tenant_engine(model, megastep=n)
        cap0 = captures(model)
        warmup(eng, sampled=True)
        what = f"tenants, megastep {n}"
        res, reqs = timed_loadgen(torch, ctr, eng, LoadGen(**lg_kw), what)
        pt = res["per_tenant"]
        if set(pt) != set(TENANT_MIX) or \
                sum(t["completed"] for t in pt.values()) != res["completed"]:
            raise AssertionError(f"{what}: per_tenant {pt} against "
                                 f"completed {res['completed']}")
        if res["leaked_lora_pages"] or eng.lora_pool.leaked():
            raise AssertionError(f"{what}: adapter pages leaked")
        res.update(graphs_captured_in_warmup=captures(model) - cap0,
                   graphs_per_engine=replica_graphs(model, eng),
                   tpot_p50_ms_by_tenant=tenant_tpot(reqs))
        log(f"  {what}: per tenant {pt}, TPOT p50 by tenant "
            f"{res['tpot_p50_ms_by_tenant']} ms, {res['graphs_per_engine']} "
            f"graphs over this engine's pools")
        out[f"megastep{n}"] = res
        launches[f"megastep{n}"] = res["launches"]
        routes[f"megastep{n}"] = res["routes"]
        greedy += [r for r in reqs if r.state == "done"
                   and r.decode.is_greedy]
        engines[n] = eng
    release_engines([engines.pop(8)])

    # the single-tenant oracle: one engine, each tenant's prompts alone
    ref_eng = tenant_engine(model, max_slots=32, max_queue=256)
    specs = {}
    for r in greedy:
        key = (r.tenant, tuple(r.prompt))
        specs[key] = max(specs.get(key, 0), r.max_new_tokens)
    ref = single_tenant_tokens(torch, ref_eng, [(t, p, n) for (t, p), n in
                                                specs.items()])
    ties = same_tenant_tokens(torch, model, ref_eng.lora_pool, greedy, ref,
                              "tenant runs vs single-tenant engines")
    out["tokens"] = {"checked": len(greedy), "near_ties": len(ties)}
    log(f"  {len(greedy)} completed greedy requests of both runs == an "
        f"unloaded single-tenant engine's ({len(ties)} near ties)")
    # one prompt, three tenants, three outputs (the first of four seeded
    # prompts where they all differ; none of four fails the phase)
    rng = np.random.RandomState(40)
    for _ in range(4):
        shared = rng.randint(1, cfg.vocab_size, size=12).tolist()
        three = [ref_eng.submit(shared, max_new_tokens=16, tenant=t)
                 for t in ("", "acme", "zeta")]
        ref_eng.run_until_idle()
        if len({tuple(r.tokens) for r in three}) == 3:
            break
    else:
        raise AssertionError(f"one prompt, three tenants, outputs "
                             f"{[r.tokens for r in three]}: not all differ")
    log(f"  one prompt: base / acme / zeta generate "
        f"{[r.tokens[:4] for r in three]}... (all different)")

    # live adapter changes on the warmed megastep-1 engine
    eng = engines.pop(1)
    new = {"acme": make_adapter(cfg, LORA_RANK, seed=3),
           "third": make_adapter(cfg, LORA_RANK, seed=4)}
    cap0 = captures(model)
    ptrs = [a.data_ptr() for a in eng.lora_pool.arrays]
    eng.load_adapter("acme", new["acme"])
    eng.evict_adapter("zeta")
    eng.load_adapter("third", new["third"])
    rng = np.random.RandomState(41)
    live = [(t, rng.randint(1, cfg.vocab_size,
                            size=int(rng.randint(4, 16))).tolist(), 8)
            for t in ("acme", "third", "", "acme", "third", "")]
    reqs = [eng.submit(p, max_new_tokens=n, tenant=t) for t, p, n in live]
    eng.run_until_idle()
    torch.cuda.synchronize()
    pinned = eng.submit(live[0][1], max_new_tokens=8, tenant="acme")
    eng.step()
    try:
        eng.evict_adapter("acme")
        raise AssertionError("evict_adapter ignored a pinned page")
    except ValueError as e:
        if "pinned" not in str(e):
            raise
    eng.run_until_idle()
    added = captures(model) - cap0
    if added or [a.data_ptr() for a in eng.lora_pool.arrays] != ptrs:
        raise AssertionError(f"live adapter changes captured {added} graphs "
                             "or moved the pool")
    ref_eng.load_adapter("acme", new["acme"])
    ref_eng.evict_adapter("zeta")
    ref_eng.load_adapter("third", new["third"])
    ref2 = single_tenant_tokens(torch, ref_eng, live)
    ties2 = same_tenant_tokens(torch, model, ref_eng.lora_pool, reqs, ref2,
                               "after the live changes")
    out["live_changes"] = {"captures": added, "requests": len(reqs),
                           "near_ties": len(ties2),
                           "pinned_evict_refused": True,
                           "pinned_request_state": pinned.state}
    log(f"  live changes (acme reloaded, zeta evicted, third loaded): "
        f"{added} captures, the pool in place, {len(reqs)} requests == an "
        f"engine loaded with the new factors ({len(ties2)} near ties); evict "
        f"refused while a request pinned the page")
    if eng.lora_pool.leaked() or ref_eng.lora_pool.leaked():
        raise AssertionError("adapter pages leaked after the live changes")
    release_engines([eng, ref_eng])
    del eng, ref_eng
    release_graphs(torch, model)

    # the decode step with and without LoRA (phase 17's profile, 8 rows)
    prof = {}
    for name, kw in (("base", {}), ("lora", {"lora_rank": LORA_RANK,
                                             "lora_max_adapters": 2})):
        from paddle_tpu_torch.serving import ServingEngine
        e = ServingEngine(model, max_slots=8, max_len=256, block_size=16,
                          kv_dtype="f32", attn_impl="kernel", **kw)
        e.submit(list(range(1, 25)), max_new_tokens=4)   # bucket 32, decode
        e.run_until_idle()
        prof[name] = decode_profile(torch, ctr, e, f"decode, {name}")
        release_engines([e])
    out["decode_profile"] = prof
    log(f"  [{card}] decode step with LoRA: busy "
        f"{prof['lora']['decode_busy_ms']:.3f} ms, "
        f"{prof['lora']['graph_kernels']} graph kernels; without: "
        f"{prof['base']['decode_busy_ms']:.3f} ms, "
        f"{prof['base']['graph_kernels']}")
    release_graphs(torch, model)
    del model
    out["launches"], out["routes"] = launches, routes
    return out


# ------------------------------------------------------------ phase 5h
#: ``tools/ci.sh:384-389``'s returning-users leg
HOST_BLOCKS = 64
SESSION_LG = dict(mode="poisson", rate=20.0, duration=2.0, seed=3,
                  prompt_tokens=(4, 8), new_tokens=(2, 4),
                  returning_frac=0.9, turns_per_session=(2, 3))


def host_tier(model, blocks=HOST_BLOCKS, idle_ms=0.0):
    from paddle_tpu_torch.serving import HostBlockStore, TierManager
    cfg = model.cfg
    return TierManager(HostBlockStore(cfg.num_layers, cfg.num_heads,
                                      cfg.head_dim, block_size=16,
                                      num_blocks=blocks),
                       demote_idle_ms=idle_ms)


def chain_blocks(torch, cache, prompt):
    """The device prefix entries of ``prompt``'s full blocks, and their
    contents per layer and tensor (cloned)."""
    from paddle_tpu_torch.serving.kv_cache import prefix_chain_keys
    ents = [cache.pool._prefix[k]
            for k in prefix_chain_keys(prompt, cache.block_size)
            if k in cache.pool._prefix]
    idx = torch.as_tensor([e.block for e in ents], device=cache.pool.device)
    return ents, [[t[idx].clone() for t in layer] for layer in cache.layers]


def round_trip(torch, ctr, pa, model, kv):
    """One session on a tiered engine: turn 1 (a 34-token prompt, 6 new
    tokens: a two-block chain), demoted by hand, the device prefix cache
    flushed, turn 2 resumed. Promoted int8 blocks must equal the demoted
    ones bit for bit and turn 2's tokens the never-demoted
    conversation's exactly; promoted f32/bf16 blocks must equal numpy's
    ``dequantize(quantize(block))`` cast to the pool's dtype bit for bit,
    and the tokens follow the top-2 rule. B4 is held to its plain
    version on the promoted tables."""
    from paddle_tpu_torch.serving import kv_tier
    from paddle_tpu_torch.serving.kv_cache import prefix_chain_keys
    tier = host_tier(model, blocks=8, idle_ms=1e12)   # demoted by hand
    geo = dict(max_slots=2, buckets=[16, 32], kv_dtype=kv)
    eng = loadgen_engine(model, kv_tier=tier, **geo)
    rng = np.random.RandomState(60)
    t1 = rng.randint(1, model.cfg.vocab_size, size=34).tolist()
    t2 = rng.randint(1, model.cfg.vocab_size, size=5).tolist()
    r1 = eng.submit(t1, max_new_tokens=6, session="s")
    eng.run_until_idle()
    ctx = r1.output_ids
    ents, before = chain_blocks(torch, eng.cache, ctx)
    if len(ents) != 2:
        raise AssertionError(f"{kv}: {len(ents)} chain blocks, expected 2")
    torch.cuda.synchronize()
    entries, copied = tier.demote(eng.cache)
    if (entries, copied) != (2, 2):
        raise AssertionError(f"{kv}: demoted {entries} entries, {copied} "
                             "blocks")
    eng.cache.flush_prefix_cache()
    r2 = eng.submit(t2, max_new_tokens=6, session="s")
    with ctr.aside():
        eng.step()
        err = check_handoff_tables(torch, pa, eng, f"promoted {kv} rows")
    ents2, after = chain_blocks(torch, eng.cache, ctx)
    for li in range(len(after)):
        for j, (a, b) in enumerate(zip(before[li], after[li])):
            if kv == "int8":
                want = a
            else:
                hb = [tier.store.get(k).block
                      for k in prefix_chain_keys(ctx, 16)]
                codes = tier.store.codes[hb][:, li, j % 2]
                sc = tier.store.scales[hb][:, li, j % 2]
                want = torch.from_numpy(kv_tier._np_dequantize(
                    codes, sc[:, :, None, None])).to(a.dtype).to(a.device)
            if not torch.equal(b, want):
                raise AssertionError(f"{kv}: promoted layer {li} tensor {j} "
                                     "differs from the demoted block")
    eng.run_until_idle()
    # the never-demoted conversation: the same turns, the chain kept
    ref = loadgen_engine(model, **geo)
    q1 = ref.submit(t1, max_new_tokens=6)
    ref.run_until_idle()
    q2 = ref.submit(q1.output_ids + t2, max_new_tokens=6)
    ref.run_until_idle()
    ties = same_tokens(torch, model, [ctx + t2], [q2.tokens], [r2.tokens],
                       f"resumed {kv} session", ties=kv != "int8")
    st = tier.stats()
    if st["migrated_promote_blocks"] != 2 or st["sessions_resumed"] != 1:
        raise AssertionError(f"{kv}: {st}")
    for e in (eng, ref):
        e.cache.flush_prefix_cache()
        if e.cache.allocator.leaked() != 1:
            raise AssertionError(f"{kv}: device blocks leaked")
    tier.flush()
    if tier.leaked():
        raise AssertionError(f"{kv}: host blocks leaked")
    release_engines([eng, ref])
    log(f"  {kv} round trip: 2 blocks demoted and promoted "
        f"({'bit-equal' if kv == 'int8' else 'equal to the numpy round trip'}"
        f"), turn 2 == the never-demoted conversation "
        f"({'exactly' if kv == 'int8' else f'{len(ties)} near ties'}), B4 on "
        f"the promoted tables within {err:.3e}")
    return {"kernel_max_abs_err": err, "near_ties": len(ties),
            "demote_ms": tier.migrate_ms["demote"] / 2,
            "promote_ms": tier.migrate_ms["promote"] / 2}


def tier_fleet(torch, model):
    """At 4 layers: ``tests/test_kv_tier.py:291``'s case, a 2 x 1
    ``DisaggRouter`` over a shared tier whose prefill worker 0 is killed
    after serving a 36-token prompt: its chains stay routable as the
    host-tier marker, the survivor promotes instead of re-prefilling,
    the tokens are equal (top-2 rule: the survivor prefills a shorter
    suffix, other GEMM shapes), nothing leaks. Then
    ``tests/test_kv_tier.py:126``'s resumed session that keeps its
    tenant's pin, against the never-demoted conversation of that tenant.
    Int8 pools, whose round trip through the tier is lossless, so only
    the order of summation differs."""
    from paddle_tpu_torch.serving import DisaggRouter, make_adapter
    from paddle_tpu_torch.serving.disagg import _HOST_TIER
    tier = host_tier(model)
    rt = DisaggRouter(model, n_prefill=2, n_decode=1, prefix_affinity=True,
                      kv_tier=tier, **loadgen_geometry(kv_dtype="int8"))
    prompt = np.random.RandomState(61).randint(
        1, model.cfg.vocab_size, size=36).tolist()
    r1 = rt.submit(prompt, max_new_tokens=4)
    rt.run_until_idle()
    info = rt.kill_prefill_worker(0)
    markers = sum(1 for v in rt._affinity.values() if v is _HOST_TIER)
    r2 = rt.submit(prompt, max_new_tokens=4)
    rt.run_until_idle()
    promoted = tier.stats()["migrated_promote_blocks"]
    if info["affinity_kept"] < 1 or markers != info["affinity_kept"] or \
            promoted < 1:
        raise AssertionError(f"killed prefill worker: {info}, markers "
                             f"{markers}, promoted {promoted}")
    ties = same_tokens(torch, model, [prompt], [r1.tokens], [r2.tokens],
                       "after the prefill worker's kill")
    for e in rt.engines:
        e.cache.flush_prefix_cache()
        if e.cache.allocator.leaked() != 1:
            raise AssertionError("the fleet leaked device blocks")
    tier.flush()
    if tier.leaked():
        raise AssertionError("the fleet leaked host blocks")
    release_engines(rt.engines + rt._retiring)
    log(f"  2 x 1 int8 fleet, prefill worker 0 killed: affinity kept "
        f"{info['affinity_kept']}, {promoted} blocks promoted by the "
        f"survivor, tokens equal ({len(ties)} near ties), 0 leaks")

    tier = host_tier(model)
    eng = loadgen_engine(model, kv_tier=tier, lora_rank=LORA_RANK,
                         lora_max_adapters=2, kv_dtype="int8")
    ad = make_adapter(model.cfg, LORA_RANK, seed=1)
    eng.load_adapter("acme", ad)
    rng = np.random.RandomState(62)
    t1 = rng.randint(1, model.cfg.vocab_size, size=20).tolist()
    t2 = rng.randint(1, model.cfg.vocab_size, size=5).tolist()
    s1 = eng.submit(t1, max_new_tokens=5, session="s", tenant="acme")
    eng.run_until_idle()
    eng.cache.flush_prefix_cache()
    s2 = eng.submit(t2, max_new_tokens=5, session="s", tenant="acme")
    eng.run_until_idle()
    ref = loadgen_engine(model, lora_rank=LORA_RANK, lora_max_adapters=2,
                         kv_dtype="int8")
    ref.load_adapter("acme", ad)
    q1 = ref.submit(t1, max_new_tokens=5, tenant="acme")
    ref.run_until_idle()
    q = ref.submit(q1.output_ids + t2, max_new_tokens=5, tenant="acme")
    ref.run_until_idle()
    ties += same_tenant_tokens(torch, model, ref.lora_pool, [s2],
                               {("acme", tuple(s2.prompt)): q.tokens},
                               "resumed tenant session")
    if eng.lora_pool.leaked() or not tier.stats()["sessions_resumed"]:
        raise AssertionError("the resumed tenant session leaked its pin or "
                             "did not resume")
    release_engines([eng, ref])
    log(f"  a resumed acme session == the never-demoted acme conversation "
        f"({len(ties)} near ties in both checks), its pin released")
    return {"affinity_kept": info["affinity_kept"],
            "promoted_blocks": promoted, "tenant_session_near_ties":
            len(ties)}


def host_tier_serving(torch, ctr, pa, card):
    """Phase 5h: ``tools/ci.sh:384-389``'s returning-users leg on a fresh
    seeded gpt2-medium (1 slot, ``max_len`` 64, buckets 8/16/32, blocks
    of 16, 4-8-token prompts, 2-4 new tokens, 90% of arrivals opening
    sessions of 2-3 turns, 64 host blocks demoting at every step, a
    virtual clock at 5 ms a step, Poisson at 20/s for 2 s, seed 3):
    sessions resumed, more sessions parked than the pool has blocks,
    demoted >= promoted >= 1 blocks, 0 leaks in both tiers, 0 captures,
    0 exceptions. Then a direct round trip per pool dtype (f32, bf16,
    int8), and at 4 layers the fleet checks. Reported: demote and
    promote ms per block (host clock), the bytes each way, the pinned
    host bytes."""
    from paddle_tpu_torch.models.gpt import GPT_CONFIGS, GPTForCausalLM
    from paddle_tpu_torch.tools.loadgen import LoadGen, VirtualClock, warmup
    cfg = GPT_CONFIGS["gpt2-medium"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = GPTForCausalLM(cfg, device="cuda", generator=gen).eval()
    vc = VirtualClock()
    tier = host_tier(model)
    if not tier.store.pinned:
        raise AssertionError("the host store is not in page-locked memory")
    eng = loadgen_engine(model, max_slots=1, buckets=[8, 16, 32],
                         kv_tier=tier, clock=vc.now)
    warmup(eng)
    with tier._lock:
        tier.migrate_ms = {"demote": 0.0, "promote": 0.0}
    res, _ = timed_loadgen(torch, ctr, eng,
                           LoadGen(vocab_size=cfg.vocab_size, **SESSION_LG),
                           "returning users", clock=vc, step_cost_ms=5.0)
    s = res["sessions"]
    if s["sessions_resumed"] < 1 or \
            s["sessions_peak"] <= s["device_blocks"] or \
            not s["migrated_demote_blocks"] >= \
            s["migrated_promote_blocks"] >= 1 or s["leaked_host_blocks"]:
        raise AssertionError(f"returning users: {s}")
    L, H, D, bs = cfg.num_layers, cfg.num_heads, cfg.head_dim, 16
    dev_block = 2 * L * H * bs * D * 4
    host_block = 2 * L * H * (bs * D + 4)
    res["per_block"] = {
        "demote_ms": tier.migrate_ms["demote"] /
        max(1, s["migrated_demote_blocks"]),
        "promote_ms": tier.migrate_ms["promote"] /
        max(1, s["migrated_promote_blocks"]),
        "device_bytes_f32": dev_block, "host_bytes_at_rest": host_block}
    res["pinned_host_bytes"] = tier.store.nbytes
    log(f"  [{card}] sessions: peak {s['sessions_peak']} on "
        f"{s['device_blocks']} device blocks, {s['sessions_resumed']} "
        f"resumed, {s['migrated_demote_blocks']} / "
        f"{s['migrated_promote_blocks']} blocks demoted / promoted "
        f"({s['demote_dedup_entries']} dedup), 0 leaks in both tiers; per "
        f"block demote {res['per_block']['demote_ms']:.3f} ms "
        f"({dev_block} B off the device, {host_block} B at rest), promote "
        f"{res['per_block']['promote_ms']:.3f} ms ({host_block} B up); "
        f"{tier.store.nbytes} B pinned")
    release_engines([eng])
    del eng
    out = {"returning_users": res}
    out["round_trip"] = {kv: round_trip(torch, ctr, pa, model, kv)
                         for kv in ("f32", "bf16", "int8")}
    release_graphs(torch, model)
    del model
    small = medium_at_depth(torch, DISAGG_LAYERS, seed=2)
    out["fleet"] = tier_fleet(torch, small)
    release_graphs(torch, small)
    del small
    out["launches"], out["routes"] = res["launches"], res["routes"]
    return out


# ------------------------------------------------------------ phase 5i
#: phase 5i's requests: greedy and sampled constrained rows beside plain
#: ones, two of each, their budgets within the loadgen geometry's rows
JSON_NEW = 24
JSON_SAMPLED = {"temperature": 0.8, "top_k": 50, "top_p": 0.95}
#: a number with leading zeros (``00``, ``-01``): the reference grammar
#: admits them and ``json.loads`` refuses them (ROADMAP C)
LEADING_ZEROS = r"(?<![0-9.])(-?)0+(?=[0-9])"


def json_specs(vocab, seed=70):
    rng = np.random.RandomState(seed)
    specs = []
    for i, kind in enumerate(("json", "json_s", "plain", "plain_s") * 2):
        kw = {"max_new_tokens": JSON_NEW}
        if kind.startswith("json"):
            kw["json_mode"] = True
        if kind.endswith("_s"):
            kw.update(JSON_SAMPLED, seed=700 + i)
        specs.append((rng.randint(1, vocab, size=6 + i).tolist(), kw))
    return specs


def json_text_ok(grammar, tokens):
    """``json.loads`` of a constrained completion; one that holds a
    number with leading zeros (the reference grammar's fault) must pass
    once they are dropped. Returns whether it passed as it is."""
    import re
    text = grammar.decode(tokens)
    try:
        json.loads(text)
        return True
    except json.JSONDecodeError:
        if not re.search(LEADING_ZEROS, text):
            raise AssertionError(f"not JSON: {text!r}")
        json.loads(re.sub(LEADING_ZEROS, r"\1", text))
        return False


def warm_json(torch, target):
    """The loadgen warm-up with the sampled graphs, then one greedy and
    one sampled constrained request run to idle: at megastep > 1 a
    constrained row takes the single-step sampled graph, which the
    megastep warm-up leaves cold."""
    from paddle_tpu_torch.tools.loadgen import warmup
    warmup(target, sampled=True)
    reqs = [target.submit([1] * 4, max_new_tokens=6, json_mode=True,
                          _log_request=False),
            target.submit([2] * 4, max_new_tokens=6, json_mode=True,
                          _log_request=False, **JSON_SAMPLED, seed=1)]
    target.run_until_idle()
    torch.cuda.synchronize()
    for eng in getattr(target, "engines", [target]):
        eng.reset_cost_estimates()
        eng.cache.flush_prefix_cache()
    return reqs


def masked_top2_gap(torch, model, grammar, req_like, prefix):
    """The top-2 gap of the last-position logits plus the grammar's mask
    row after ``prefix`` (a no-cache forward of ``prompt + prefix``)."""
    prompt, budget = req_like
    cur = grammar.start()
    for t in prefix:
        cur.advance(t)
    mask = torch.as_tensor(cur.mask_row(budget - len(prefix)),
                           device=model.device)
    with torch.no_grad():
        lg = model(torch.tensor([prompt + prefix],
                                device=model.device))[0, -1]
    top = torch.topk(lg.float() + mask, 2).values
    return float(top[0] - top[1])


def same_json_tokens(torch, model, grammar, specs, ref, out, what):
    """Greedy rows of ``specs`` (constrained or plain) token-equal in
    ``ref`` and ``out``, or diverging only at a near tie (top-2 gap under
    1e-3 of the logits, masked for a constrained row). Returns the
    divergences."""
    diverged = []
    for i, ((p, kw), a, b) in enumerate(zip(specs, ref, out)):
        if kw.get("temperature") or a == b:
            continue
        j = next((k for k, (x, y) in enumerate(zip(a, b)) if x != y),
                 min(len(a), len(b)))
        gap = (masked_top2_gap(torch, model, grammar,
                               (p, kw["max_new_tokens"]), a[:j])
               if kw.get("json_mode") else top2_gap(torch, model, p + a[:j]))
        log(f"  {what}: request {i} diverges at token {j}: top-2 gap "
            f"{gap:.3e}")
        if gap >= 1e-3:
            raise AssertionError(f"{what}: request {i} differs at token "
                                 f"{j} with top-2 gap {gap}")
        diverged.append({"request": i, "token": j, "gap": gap})
    return diverged


def json_run(torch, ctr, pa, target, specs, grammar, what, check_b4=True):
    """Serve ``specs`` through warmed ``target`` with every launch count
    zeroed before and read after: exactly ``num_layers`` paged launches
    per dispatch (``n`` per megastep), no capture, every request done,
    every constrained completion JSON; the single-step fallback taken
    while a cursor is active (on a megastep engine). On the composed
    route no launch at all. With ``check_b4``
    B4 is held to its plain version on the block tables of the engine
    holding rows after the second step."""
    engines = list(getattr(target, "engines", [target]))
    model = engines[0].model
    d0 = sum(dispatches(e) for e in engines)
    s0 = sum(e.decode_steps for e in engines)
    cap0 = captures(model)
    torch.cuda.synchronize()
    ctr.zero()
    reqs = [target.submit(p, **kw) for p, kw in specs]
    b4 = None
    steps = 0
    while not all(r.done for r in reqs):
        target.step()
        steps += 1
        if check_b4 and b4 is None and steps >= 2:
            # a decode worker's rows where a fleet has roles
            live = sorted((e for e in engines if e._active),
                          key=lambda e: e.trace_role == "prefill")
            if live:
                with ctr.aside():
                    b4 = check_handoff_tables(torch, pa, live[0],
                                              f"{what}'s tables")
    torch.cuda.synchronize()
    run, routes = ctr.read(), ctr.routes()["paged_attention"]
    want = model.cfg.num_layers * (sum(dispatches(e) for e in engines) - d0)
    if engines[0].attn_impl != "kernel":
        want = 0
    ctr.expect(run, {"paged_attention": want} if want else {}, what)
    new_captures = captures(model) - cap0
    if new_captures:
        raise AssertionError(f"{what}: {new_captures} captures in the "
                             "timed run")
    if any(r.state != "done" for r in reqs):
        raise AssertionError(f"{what}: {[r.state for r in reqs]}")
    as_is = [json_text_ok(grammar, r.tokens)
             for r, (_, kw) in zip(reqs, specs) if kw.get("json_mode")]
    fallback = sum(e.decode_steps for e in engines) - s0
    if engines[0].megastep > 1 and not fallback:
        raise AssertionError(f"{what}: no single-step fallback while a "
                             "cursor was active")
    if check_b4 and b4 is None:
        raise AssertionError(f"{what}: no live rows to hold B4 on")
    tpot = {"json": [r.tpot for r, (_, kw) in zip(reqs, specs)
                     if kw.get("json_mode") and r.tpot is not None],
            "plain": [r.tpot for r, (_, kw) in zip(reqs, specs)
                      if not kw.get("json_mode") and r.tpot is not None]}
    res = {"launches": want, "routes": routes, "captures": new_captures,
           "fallback_steps": fallback, "b4_max_abs_err": b4,
           "json_as_is": sum(as_is), "json_leading_zeros":
           len(as_is) - sum(as_is),
           "tpot_p50_ms": {k: pctl_ms(v, 50) if v else None
                           for k, v in tpot.items()},
           "texts": [grammar.decode(r.tokens)
                     for r, (_, kw) in zip(reqs, specs)
                     if kw.get("json_mode")]}
    log(f"  {what}: {len(reqs)} requests, {len(as_is)} constrained, each "
        f"JSON ({res['json_leading_zeros']} only without leading zeros); "
        f"{fallback} single-step fallbacks; {want} paged launches "
        f"{routes}; 0 captures; TPOT p50 constrained "
        f"{res['tpot_p50_ms']['json']} ms, plain "
        f"{res['tpot_p50_ms']['plain']} ms")
    return res, [r.tokens for r in reqs]


def mask_row_ms(grammar, vocab, n=200):
    """Host ms per ``mask_row`` at the model's vocabulary (the host work
    a constrained row adds per token), over ``n`` rows of a cursor
    inside a string (the widest allowed set)."""
    cur = grammar.start()
    cur.advance(int(grammar._char_ids['"'][0]))
    buf = np.empty(vocab, np.float32)
    t0 = time.perf_counter()
    for _ in range(n):
        cur.mask_row(16, out=buf)
    return (time.perf_counter() - t0) / n * 1e3


def json_serving(torch, ctr, pa, card):
    """Phase 5i: JSON-constrained decoding on a fresh seeded gpt2-medium
    with phase 5e's engine geometry at megastep 8 and a grammar over the
    model's own vocabulary (``JsonGrammar(json_token_strings(50257))``):
    greedy and sampled constrained requests mixed in one batch with plain
    ones, on the kernel route and on the plain (composed) route (greedy
    tokens equal, top-2 rule over the masked logits), each run capturing
    nothing, its paged launches counted, B4 held to its plain version on
    its tables, the single-step fallback taken while a cursor is active;
    then at ``DISAGG_LAYERS`` layers through a 2-replica ``ReplicaRouter``,
    a 1 x 2 ``DisaggRouter`` (the cursor crosses the handoff) and HTTP,
    each against a single engine's greedy tokens. Every constrained
    completion must be JSON."""
    from paddle_tpu_torch.models.gpt import GPT_CONFIGS, GPTForCausalLM
    from paddle_tpu_torch.serving import (DisaggRouter, JsonGrammar,
                                          ReplicaRouter, ServingHTTPServer,
                                          json_token_strings)
    cfg = GPT_CONFIGS["gpt2-medium"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = GPTForCausalLM(cfg, device="cuda", generator=gen).eval()
    grammar = JsonGrammar(json_token_strings(cfg.vocab_size))
    specs = json_specs(cfg.vocab_size)
    out, launches = {}, 0
    toks = {}
    for impl in ("kernel", "composed"):
        eng = loadgen_engine(model, megastep=FLEET_MEGASTEP, grammar=grammar,
                             attn_impl=impl)
        warm_json(torch, eng)
        res, toks[impl] = json_run(torch, ctr, pa, eng, specs, grammar,
                                   f"megastep {FLEET_MEGASTEP}, {impl} route",
                                   check_b4=impl == "kernel")
        out[impl] = res
        release_engines([eng])
        del eng
    launches += out["kernel"]["launches"]
    ties = same_json_tokens(torch, model, grammar, specs, toks["composed"],
                            toks["kernel"], "kernel vs plain route")
    out["kernel_vs_plain_near_ties"] = len(ties)
    out["mask_row_ms"] = mask_row_ms(grammar, cfg.vocab_size)
    log(f"  [{card}] greedy rows kernel == plain route ({len(ties)} near "
        f"ties); TPOT p50 constrained {out['kernel']['tpot_p50_ms']['json']}"
        f" ms vs plain {out['kernel']['tpot_p50_ms']['plain']} ms (kernel "
        f"route); host {out['mask_row_ms']:.4f} ms per mask row at V = "
        f"{cfg.vocab_size}")
    release_graphs(torch, model)
    del model

    small = medium_at_depth(torch, DISAGG_LAYERS, seed=2)
    grammar = JsonGrammar(json_token_strings(small.cfg.vocab_size))
    ref_eng = loadgen_engine(small, grammar=grammar)
    warm_json(torch, ref_eng)
    _, ref = json_run(torch, ctr, pa, ref_eng, specs, grammar,
                      f"one engine at {DISAGG_LAYERS} layers",
                      check_b4=False)
    release_engines([ref_eng])
    del ref_eng
    fleets = {"router": lambda: ReplicaRouter(
                  small, n_replicas=2, grammar=grammar,
                  **loadgen_geometry()),
              "disagg": lambda: DisaggRouter(
                  small, n_prefill=1, n_decode=2, grammar=grammar,
                  **loadgen_geometry())}
    for name, make in fleets.items():
        rt = make()
        warm_json(torch, rt)
        res, got = json_run(torch, ctr, pa, rt, specs, grammar,
                            f"{name} at {DISAGG_LAYERS} layers")
        res["near_ties"] = len(same_json_tokens(
            torch, small, grammar, specs, ref, got, f"{name} vs one engine"))
        if name == "disagg" and not rt.stats()["handoffs_adopted"]:
            raise AssertionError("disagg: no handoff adopted")
        out[name] = res
        launches += res["launches"]
        release_engines(rt.engines)
        del rt
    rt = DisaggRouter(small, n_prefill=1, n_decode=2, grammar=grammar,
                      **loadgen_geometry())
    warm_json(torch, rt)
    cap0 = captures(small)
    d0 = sum(dispatches(e) for e in rt.engines)
    ctr.zero()
    srv = ServingHTTPServer(rt, port=0)
    srv.start()
    conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=120)
    try:
        got = []
        for p, kw in specs:
            body = {"ids": p, **kw}
            conn.request("POST", "/v1/generate", body=json.dumps(body))
            r = conn.getresponse()
            payload = json.loads(r.read().decode())
            if r.status != 200 or payload["state"] != "done":
                raise AssertionError(f"HTTP: {r.status} {payload}")
            got.append(payload["output_ids"][len(p):])
        conn.request("POST", "/v1/generate", body=json.dumps(
            {"ids": [1, 2], "json_mode": True, "max_new_tokens": 4,
             "temperature": 0.5, "top_k": -1}))
        bad = conn.getresponse()
        bad.read()
        if bad.status != 400:
            raise AssertionError(f"HTTP: a bad top_k -> {bad.status}")
    finally:
        conn.close()
        srv.stop()
    torch.cuda.synchronize()
    run = ctr.read()
    want = small.cfg.num_layers * (sum(dispatches(e) for e in rt.engines)
                                   - d0)
    ctr.expect(run, {"paged_attention": want}, "HTTP")
    if captures(small) != cap0:
        raise AssertionError("HTTP: the run captured graphs")
    as_is = [json_text_ok(grammar, t) for t, (_, kw) in zip(got, specs)
             if kw.get("json_mode")]
    out["http"] = {"launches": want, "json_as_is": sum(as_is),
                   "near_ties": len(same_json_tokens(
                       torch, small, grammar, specs, ref, got,
                       "HTTP vs one engine"))}
    launches += want
    log(f"  [{card}] HTTP over a 1 x 2 fleet: {len(specs)} POSTs, "
        f"{len(as_is)} constrained, each JSON; {want} paged launches, 0 "
        f"captures")
    release_engines(rt.engines)
    del rt
    release_graphs(torch, small)
    del small
    out["launches"] = launches
    return out


# ------------------------------------------------------------ phase 5j
def devprof_serving(torch, ctr, pa, card):
    """Phase 5j: the device-cost observatory on phase 5e's engine
    (gpt2-medium, f32 pools, the kernel route) at ``devprof_sample``
    1.0: the counted cost of each entry, its device ms from the CUDA
    events, MFU and HBM share against the H100's data-sheet peaks, and
    the host-overhead share. Checks: the decode entry's event time is at
    least 0.9 x the device busy time ``traced_steps`` measures for the
    same steps; the blame identity is exact on every finished trace; the
    captures equal a devprof-off engine's; greedy tokens at sample 0
    equal devprof off; a ledger row appended to a temporary file passes
    ``perf_regress`` against a baseline written from itself."""
    from paddle_tpu_torch import flags as tflags
    from paddle_tpu_torch.models.gpt import GPT_CONFIGS, GPTForCausalLM
    from paddle_tpu_torch.observability import devprof, tracing
    from paddle_tpu_torch.tools import perf_ledger, perf_regress
    from paddle_tpu_torch.tools.loadgen import LoadGen, warmup
    cfg = GPT_CONFIGS["gpt2-medium"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = GPTForCausalLM(cfg, device="cuda", generator=gen).eval()
    rng = np.random.RandomState(80)
    prompts = [rng.randint(1, cfg.vocab_size, size=8 + i).tolist()
               for i in range(LOADGEN_SLOTS)]
    specs = [(p, {"max_new_tokens": 40}) for p in prompts]
    out = {}

    def run_arm(**kw):
        cap0 = captures(model)
        eng = loadgen_engine(model, **kw)
        warmup(eng)
        res, got = drive(torch, ctr, eng, specs, f"devprof {kw or 'off'}")
        return eng, res, got, captures(model) - cap0

    off, res_off, toks_off, cap_off = run_arm()
    release_engines([off])
    zero, _, toks_zero, cap_zero = run_arm(devprof=True, devprof_sample=0.0)
    if toks_zero != toks_off or zero.stats()["devprof"]["samples"]:
        raise AssertionError("devprof at sample 0 moved the greedy tokens "
                             "or timed a dispatch")
    release_engines([zero])
    devprof.reset()
    tracing.reset()
    tflags.set_flags({"serving_devprof": True})
    try:
        eng, res_on, toks_on, cap_on = run_arm(devprof=True,
                                               devprof_sample=1.0)
        if not cap_on == cap_zero == cap_off:
            raise AssertionError(f"captures with devprof {cap_on} / "
                                 f"{cap_zero}, without {cap_off}")
        # the decode entry's event time against the trace's busy time
        reqs = [eng.submit(p, max_new_tokens=LOADGEN_LEN - len(p) - 1)
                for p in prompts]
        eng.step()
        eng.step()
        agg = eng._devprof._entries["decode_step_paged"]
        for attempt in range(2):
            n0, dev0 = agg[0], agg[1]
            c0 = ctr.read()["paged_attention"]
            busy, names = device_trace(
                torch, lambda: [eng.step() for _ in range(PROFILE_TRACED)])
            launched = ctr.read()["paged_attention"] - c0
            seen = sum(n for name, n in names.items()
                       if "paged_attention_kernel" in name)
            if launched == seen == PROFILE_TRACED * cfg.num_layers:
                break
            log(f"  devprof decode steps: {seen} paged kernels in the "
                f"trace, {launched} counted"
                + ("; tracing again" if attempt == 0 else ""))
        else:
            raise AssertionError("devprof decode steps: the trace and the "
                                 "launch counts disagree")
        busy /= PROFILE_TRACED
        event_ms_ = (agg[1] - dev0) / (agg[0] - n0) * 1e3
        if event_ms_ < 0.9 * busy:
            raise AssertionError(f"decode event time {event_ms_:.4f} ms < "
                                 f"0.9 x busy {busy:.4f} ms")
        for r in reqs:
            eng.cancel(r.id)
        eng.run_until_idle()
        # blame on every finished trace
        finished = [tr.rid for tr in tracing.store().finished()]
        split = 0
        for rid in finished:
            info = tracing.get(rid)
            if info is None or info["outcome"] != "done":
                continue
            bl = info["blame_ms"]
            if abs(sum(bl.values()) - info["e2e_ms"]) > 1e-6:
                raise AssertionError(f"blame of {rid}: {bl} vs e2e "
                                     f"{info['e2e_ms']}")
            split += "decode_device" in bl
        if not split:
            raise AssertionError("no trace split decode into device/host")
        # a loadgen report through the ledger and the regress gate
        lg = LoadGen(mode="poisson", rate=40.0, duration=0.5, seed=1,
                     vocab_size=cfg.vocab_size, prompt_tokens=(4, 12),
                     new_tokens=(4, 12))
        report = lg.run(eng)
        with tempfile.TemporaryDirectory() as tmp:
            ledger = os.path.join(tmp, "ledger.jsonl")
            base = os.path.join(tmp, "baseline.json")
            row = perf_ledger.append_report(ledger, report, run="loadgen",
                                            label="chip_smoke 5j")
            perf_regress.write_baseline(base, row)
            gate = perf_regress.main([ledger, "--baseline", base])
        if gate != 0:
            raise AssertionError("perf_regress failed on its own baseline")
        st = eng.stats()["devprof"]
    finally:
        tflags.set_flags({"serving_devprof": False})
    costs = devprof.cost_table()
    entries = []
    for e in st["entries"]:
        c = costs.get(e["entry"], {})
        entries.append({**e, "out_bytes": c.get("out_bytes"),
                        "host_share": (e["host_ms_mean"] /
                                       (e["host_ms_mean"] +
                                        e["device_ms_mean"]))})
        log(f"  [{card}] {e['entry']}: {e['samples']} samples, device "
            f"{e['device_ms_mean']:.4f} ms (CUDA events), host "
            f"{e['host_ms_mean']:.4f} ms, {e['flops']:.4e} FLOPs, "
            f"{e['hbm_bytes']:.4e} B, MFU {e['mfu']}, HBM share "
            f"{e['hbm_util']}, {e['verdict']}")
    out.update({
        "entries": entries, "device_frac": st["device_frac"],
        "host_overhead_share": st["host_overhead_share"], "mfu": st["mfu"],
        "peak_flops": eng._devprof.peak_flops,
        "peak_bytes_per_s": eng._devprof.peak_bytes_per_s,
        "decode_event_ms": event_ms_, "decode_busy_ms": busy,
        "blame_split_traces": split, "ledger_row": row,
        "captures": {"off": cap_off, "sample0": cap_zero, "on": cap_on},
        "cost_digest": devprof.cost_digest(),
        "launches": res_on["launches"], "routes": res_on["routes"]})
    log(f"  [{card}] devprof: device share {st['device_frac']}, host "
        f"overhead share {st['host_overhead_share']}, MFU {st['mfu']} "
        f"(peaks {eng._devprof.peak_flops:.3e} FLOP/s, "
        f"{eng._devprof.peak_bytes_per_s:.3e} B/s); decode events "
        f"{event_ms_:.4f} ms vs busy {busy:.4f} ms per step; {split} "
        f"traces split, identity exact; captures off / 0 / 1.0: "
        f"{cap_off} / {cap_zero} / {cap_on}; sample-0 tokens == off; "
        f"ledger row gated against itself")
    release_engines([eng])
    del eng
    devprof.reset()
    release_graphs(torch, model)
    del model
    return out


# ------------------------------------------------------------ phase 5k
#: ``tools/ci.sh``'s three soak arms (its lines 471-475, 516-520 and
#: 493-497) as ``python3 -m paddle_tpu_torch.tools.soak`` arguments, and
#: the kills and restarts each schedule injects; every arm runs at the
#: soak's default geometry (4 slots, ``max_len`` 64, buckets 16 and 32:
#: phase 5e's loadgen engine) on a 2-replica ``ReplicaRouter`` on the
#: virtual clock, the kernel route on
SOAK_ARMS = {
    "primary": ("--hours 2 --rate 0.02 --kills 2 --replicas 2 --seed 0 "
                "--windows 8", 2),
    "sanitized": ("--hours 0.5 --rate 0.02 --kills 1 --replicas 2 --seed 0 "
                  "--windows 4 --dispatch-threads 2 --megastep 8", 1),
    "abandon": ("--hours 0.5 --rate 0.02 --kills 0 --replicas 2 --seed 3 "
                "--windows 4 --closed-loop 4 --abandon-frac 0.15 "
                "--hedge-ms 50 --hedge-budget 0.3", 0),
}
#: completed requests per arm held to an unloaded engine's tokens
SOAK_TOKEN_SAMPLE = 24
#: the locks the sanitized arm must have instrumented: the serving
#: fleet's, the metrics registry's, and the port's own around a replay
#: and a capture
SOAK_LOCKS = ("engine._lock", "engine._step_lock", "router._lock",
              "metrics.registry", "model_trace_lock", "jit._capture_lock",
              "launches.lock")


def soak_arm(torch, ctr, model, name, card):
    """One arm of ``SOAK_ARMS`` through ``tools/soak.py``'s port
    (``soak.soak``: the warm-up, the traffic under the kill schedule, the
    windows, the predictor's proof, the sanitizer's report) on ``model``,
    the launch counts zeroed after the warm-up and read after the run.
    Raises unless: the accounting identity holds; every window that
    offered load completed some; the schedule's kills and restarts
    happened; no KV block or LoRA page leaked and no exception escaped;
    the predictor's chaos counts equal its plain ones; hedges stayed in
    their budget and every abandonment ended as a ``disconnect`` cancel;
    the paged kernel launched ``num_layers`` times per dispatch, each on
    a named route; no engine present at the warm-up captured, and no
    replacement captured more graphs than a warmed engine holds; memory
    is flat within 4 MiB: allocated after the drain against the start of
    the traffic (each replacement's pools and graphs take the place of
    the killed engine's), reserved once the fleet is released against
    the start of the arm (the caching allocator may keep one more
    segment while the fleet lives, whose blocks a replacement's pools
    fragment); and a sample of completed requests' tokens equal an
    unloaded engine's (top-2 rule). Returns the arm's numbers."""
    from paddle_tpu_torch import flags as _fl
    from paddle_tpu_torch.tools import soak
    argv, kills = SOAK_ARMS[name]
    args = soak.build_parser().parse_args(
        argv.split() + ["--model", "gpt2-medium"])
    # an arm at megastep > 1 runs its engines with dispatch-ahead; the
    # flags are what the soak's command line would set
    _fl.set_flags({"serving_dispatch_threads": args.dispatch_threads,
                   "serving_megastep": args.megastep,
                   "serving_dispatch_ahead": args.megastep > 1})
    what = f"phase 5k, {name} arm"
    seen = {}

    def on_fleet(rt):
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        seen.update(rt=rt, reserved0=torch.cuda.memory_reserved(),
                    allocated0=torch.cuda.memory_allocated(),
                    d0={id(e): dispatches(e) for e in rt.engines},
                    graphs=[replica_graphs(model, e) for e in rt.engines])
        torch.cuda.reset_peak_memory_stats()
        ctr.zero()
        seen["t0"] = time.perf_counter()

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved_start = torch.cuda.memory_reserved()
    t_arm = time.perf_counter()
    try:
        rec = soak.soak(model, args, on_fleet=on_fleet)
    finally:
        _fl.set_flags({"serving_dispatch_threads": 0, "serving_megastep": 1,
                       "serving_dispatch_ahead": False})
    torch.cuda.synchronize()
    run_s = time.perf_counter() - seen["t0"]
    run, routes = ctr.read(), ctr.routes()["paged_attention"]
    rt, rep, wins = seen["rt"], rec["report"], rec["windows"]
    engines = rt.engines + rt._retiring
    want = model.cfg.num_layers * sum(
        dispatches(e) - seen["d0"].get(id(e), 0) for e in engines)
    ctr.expect(run, {"paged_attention": want}, what)
    if not want or sum(routes.values()) != want:
        raise AssertionError(f"{what}: {want} paged launches, by route "
                             f"{routes}")
    gc.collect()
    torch.cuda.synchronize()
    allocated1 = torch.cuda.memory_allocated()
    torch.cuda.empty_cache()
    reserved1 = torch.cuda.memory_reserved()
    peak = torch.cuda.max_memory_reserved()
    release_engines(rt.engines)
    gc.collect()
    torch.cuda.empty_cache()
    reserved_end = torch.cuda.memory_reserved()
    bad = []
    if not rec["identity_ok"]:
        bad.append("the accounting identity")
    if any(w["offered"] and not w["completed"] for w in wins):
        bad.append(f"goodput in every window {wins}")
    if rep["kills"] < kills or rep["restarts"] < kills:
        bad.append(f"{rep['kills']} kills, {rep['restarts']} restarts")
    if rep["leaked_kv_blocks"] or rep.get("leaked_lora_pages") or \
            rep["exceptions"]:
        bad.append(f"{rep['leaked_kv_blocks']} leaked blocks, "
                   f"{rep.get('leaked_lora_pages')} LoRA pages, "
                   f"{rep['exceptions']} exceptions")
    if not rec["predictor_noop"]:
        bad.append("the predictor's no-op")
    if not soak.compiles_ok(rep, "cuda") or \
            rep["warm_engine_graphs"] != max(seen["graphs"]):
        bad.append(f"captures: {rep['captures_warm_engines']} by engines "
                   f"present at warm-up, {rep['captures_replacements']} "
                   f"by replacements, warmed engines hold "
                   f"{seen['graphs']} graphs, ledger "
                   f"{rep['warm_engine_graphs']}")
    if allocated1 > seen["allocated0"] + (4 << 20) or \
            reserved_end > reserved_start + (4 << 20):
        bad.append(f"allocated {seen['allocated0']} B at the start of the "
                   f"traffic, {allocated1} B after the drain; reserved "
                   f"{reserved_start} B at the start of the arm, "
                   f"{reserved_end} B with the fleet released")
    if args.hedge_ms and not rec["hedge_budget_ok"]:
        bad.append(f"hedges {rep.get('hedges')} over their budget")
    if args.abandon_frac and (
            not rep["abandoned"] or
            rep["canceled"].get("disconnect", 0) != rep["abandoned"]):
        bad.append(f"{rep['abandoned']} abandoned, canceled "
                   f"{rep['canceled']}")
    san = rec["sanitizer"]
    if args.dispatch_threads and (not san["enabled"] or
                                  not san["lock_acquires"] or
                                  san["cycles"] or san["violations"]):
        bad.append(f"sanitizer {san}")
    if bad:
        raise AssertionError(f"{what}: " + "; ".join(bad))
    done = sorted({r.id: r for e in engines for r in e._all
                   if not r._hedge_clone and r.state == "done"}.items())
    pick = np.random.RandomState(0).permutation(len(done))
    sample = [done[i][1] for i in sorted(pick[:SOAK_TOKEN_SAMPLE])]
    tokens = check_greedy(torch, model, sample, f"{what}'s sample")
    out = {"wall_s": time.perf_counter() - t_arm, "run_s": run_s,
           "steps": rep["steps"], "simulated_hours": args.hours,
           "offered": rep["offered"], "completed": rep["completed"],
           "rehomed": rep["rehomed"], "canceled": rep["canceled_total"],
           "abandoned": rep["abandoned"], "kills": rep["kills"],
           "restarts": rep["restarts"], "goodput_per_s": rep["goodput_per_s"],
           "hedges": rep.get("hedges", {}).get("fired"),
           "launches": want, "routes": routes,
           "new_compiles": rep["new_compiles_after_warmup"],
           "captures_warm_engines": rep["captures_warm_engines"],
           "captures_replacements": rep["captures_replacements"],
           "replacement_dispatches": [
               dispatches(e) for e in sorted(
                   (e for e in engines if id(e) not in seen["d0"]),
                   key=lambda e: int(e._eid))],
           "warm_engine_graphs": rep["warm_engine_graphs"],
           "allocated_bytes": [seen["allocated0"], allocated1],
           "reserved_bytes": [reserved_start, seen["reserved0"], reserved1,
                              reserved_end],
           "peak_reserved_bytes": peak,
           "sanitizer": {k: (len(v) if isinstance(v, list) else v)
                         for k, v in san.items()},
           "tokens_checked": tokens}
    log(f"  [{card}] {name}: {out['wall_s']:.1f} s wall ({run_s:.1f} s of "
        f"traffic), {rep['steps']} steps, {args.hours} simulated hours, "
        f"offered {rep['offered']}, completed {rep['completed']}, "
        f"re-homed {rep['rehomed']}, canceled {rep['canceled_total']} "
        f"({rep['abandoned']} abandoned), {rep['kills']} kills / "
        f"{rep['restarts']} restarts, goodput {rep['goodput_per_s']}/s, "
        f"{want} paged launches {routes}, captures by warm engines "
        f"{rep['captures_warm_engines']}, by replacements "
        f"{rep['captures_replacements']} over "
        f"{out['replacement_dispatches']} dispatches (a warmed engine "
        f"holds {rep['warm_engine_graphs']}), allocated "
        f"{seen['allocated0']} -> {allocated1} B, reserved {reserved_start} "
        f"(arm) / {seen['reserved0']} (traffic) -> {reserved1} (drained, "
        f"peak {peak}) -> {reserved_end} B (fleet released)")
    if san["enabled"]:
        log(f"  [{card}] {name}: sanitizer {san['lock_acquires']} acquires "
            f"over {san['locks_tracked']} locks, {san['order_edges']} order "
            f"edges, {len(san['cycles'])} cycles, {len(san['violations'])} "
            "violations")
    return out


def prime_fleet(torch, model, name):
    """What a fresh process allocates once and keeps, on its first fleet:
    cuBLAS's workspace per thread and stream (the dispatch threads', the
    capture stream's). A fleet of the arm's geometry, warmed from its
    dispatch threads, then released with its graphs, pays it before the
    arm takes its memory baseline, as the earlier phases have in the
    parent process."""
    from paddle_tpu_torch import flags as _fl
    from paddle_tpu_torch.serving import ReplicaRouter
    from paddle_tpu_torch.tools import soak
    from paddle_tpu_torch.tools.loadgen import warmup
    args = soak.build_parser().parse_args(SOAK_ARMS[name][0].split())
    _fl.set_flags({"serving_dispatch_threads": args.dispatch_threads,
                   "serving_megastep": args.megastep,
                   "serving_dispatch_ahead": args.megastep > 1})
    try:
        rt = ReplicaRouter(model, n_replicas=args.replicas,
                           max_slots=args.slots, max_len=args.max_len,
                           max_queue=args.max_queue,
                           buckets=[int(b) for b in args.buckets.split(",")],
                           megastep=args.megastep, device=model.device)
        warmup(rt)
    finally:
        _fl.set_flags({"serving_dispatch_threads": 0, "serving_megastep": 1,
                       "serving_dispatch_ahead": False})
    release_engines(rt.engines)
    release_graphs(torch, model)


def soak_child(name):
    """The sanitized arm's process (``python3 -c "import chip_smoke;
    chip_smoke.soak_child('sanitized')"`` with ``FLAGS_sanitize_locks=1``
    in its environment, so the locks made at import, the capture lock
    and the metrics registry among them, are instrumented): builds the
    seeded gpt2-medium, loads the paged kernel (built by the parent),
    primes the process (:func:`prime_fleet`), runs the arm, checks that
    every lock of ``SOAK_LOCKS`` is a sanitized one and prints the arm's
    numbers as the last line, one JSON object."""
    import torch
    from paddle_tpu_torch.analysis import concurrency as ccz
    from paddle_tpu_torch.models.gpt import GPT_CONFIGS, GPTForCausalLM
    from paddle_tpu_torch.ops.cuda import _build
    from paddle_tpu_torch.ops.cuda import adamw as aw
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.ops.cuda import flash_pack2 as fp2
    from paddle_tpu_torch.ops.cuda import layer_norm as ln
    from paddle_tpu_torch.ops.cuda import paged_attention as pa
    if not ccz.enabled():
        raise SystemExit("soak_child: FLAGS_sanitize_locks is off")
    _build.load_all(["paged_attention"])
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = GPTForCausalLM(GPT_CONFIGS["gpt2-medium"], device="cuda",
                           generator=gen).eval()
    prime_fleet(torch, model, name)
    out = soak_arm(torch, Counters(pa, fa, ln, fp2, aw), model, name,
                   card_line())
    out["locks"] = sorted({n.split("#")[0] for n in ccz._names.values()})
    missing = set(SOAK_LOCKS) - set(out["locks"])
    if missing:
        raise AssertionError(f"phase 5k: locks not instrumented {missing}")
    print(json.dumps(out), flush=True)


def soak_serving(torch, ctr, card):
    """Phase 5k: the chaos soak (``tools/soak.py``'s port) on a fresh
    seeded gpt2-medium at full width and depth, ``tools/ci.sh``'s three
    arms (``SOAK_ARMS``): the primary gate (2 simulated hours, 2 kills),
    the abandonment arm (closed-loop clients who hang up, hedged
    prefill), both here, and the sanitized arm (1 kill, 2 dispatch
    threads, megastep 8 with dispatch-ahead) in a child process with ``FLAGS_sanitize_locks=1`` in its
    environment, where real threads contend for the engine, router,
    capture and trace locks. Each arm's checks are
    :func:`soak_arm`'s."""
    from paddle_tpu_torch.models.gpt import GPT_CONFIGS, GPTForCausalLM
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = GPTForCausalLM(GPT_CONFIGS["gpt2-medium"], device="cuda",
                           generator=gen).eval()
    out = {name: soak_arm(torch, ctr, model, name, card)
           for name in ("primary", "abandon")}
    release_graphs(torch, model)
    del model
    t0 = time.perf_counter()
    child = subprocess.run(
        [sys.executable, "-c",
         "import chip_smoke; chip_smoke.soak_child('sanitized')"],
        cwd=ROOT, env={**os.environ, "FLAGS_sanitize_locks": "1"},
        capture_output=True, text=True, timeout=600)
    lines = child.stdout.strip().splitlines()
    for line in lines[:-1]:
        log(f"  (child) {line}")
    if child.returncode:
        raise AssertionError(f"phase 5k: the sanitized arm's process exited "
                             f"{child.returncode}: {child.stderr[-4000:]}")
    out["sanitized"] = json.loads(lines[-1])
    out["sanitized"]["process_s"] = time.perf_counter() - t0
    log(f"  [{card}] sanitized arm's process {out['sanitized']['process_s']:.1f}"
        f" s; instrumented locks {out['sanitized']['locks']}")
    out["launches"] = sum(out[k]["launches"] for k in SOAK_ARMS)
    routes = {}
    for k in SOAK_ARMS:
        for r, n in out[k]["routes"].items():
            routes[r] = routes.get(r, 0) + n
    out["routes"] = routes
    return out


# ------------------------------------------------------------ phase 5l
#: phase 5l: requests (two waves of the engine's 8 slots) and their new
#: tokens; the step before which a forced-miss event comes
AHEAD_REQUESTS, AHEAD_NEW, AHEAD_EVENT_AT = 16, 48, 3


def ahead_engine(model, kv, ahead):
    """Phase 4's engine geometry (8 slots, ``max_len`` 256, blocks of 16,
    the prefix cache on) at megastep ``MEGASTEP`` on the kernel route,
    with dispatch-ahead on or off."""
    from paddle_tpu_torch.serving import ServingEngine
    return ServingEngine(model, max_slots=8, max_len=256, block_size=16,
                         prefix_cache=True, kv_dtype=kv, attn_impl="kernel",
                         megastep=MEGASTEP, dispatch_ahead=ahead)


def commit_times(eng):
    """Record, per megastep of ``eng``, the host's commit ms: from the
    moment the megastep's outputs are on the host (the wait on its event,
    or its blocking copy) to the end of the decode round. Returns the
    list the times go to."""
    rec, seen = [], {}
    host_copy, decode = eng._host_copy, eng._decode_megastep

    def timed_copy(out):
        wait = host_copy(out)

        def timed_wait():
            host = wait()
            seen["t"] = time.perf_counter()
            return host
        return timed_wait

    def timed_decode(n):
        seen.pop("t", None)
        produced = decode(n)
        if "t" in seen:
            rec.append((time.perf_counter() - seen["t"]) * 1e3)
        return produced

    eng._host_copy, eng._decode_megastep = timed_copy, timed_decode
    return rec


def megastep_device_ms(torch, eng):
    """Device ms of one replay of the megastep graph ``eng`` replayed
    last (CUDA events around the replay alone, its inputs as they are),
    and the graph's kernel nodes. The replay writes the engine's pools,
    so the engine serves nothing afterwards."""
    from paddle_tpu_torch import jit
    from paddle_tpu_torch.models import generation
    ent = generation.decode_megastep_paged(
        eng.model, eng.megastep, kv_dtype=eng.kv_dtype, attn_impl="kernel")
    last = ent["graphs"]["greedy"].last
    if last is None:
        raise AssertionError("phase 5l: the last megastep ran no graph")
    ms = min(event_ms(torch, last.graph.replay) for _ in range(3))
    return ms, jit.graph_kernels(last.graph)


def committed_kv(torch, eng, order):
    """Each active request's committed KV on the card, by its submission
    index: per layer the codes of the positions below its length and the
    scales of the blocks holding them. A stored speculation's writes are
    left out, as its restore would leave the pools."""
    from paddle_tpu_torch.serving.kv_cache import TailSnapshot
    cache = eng.cache
    bs = cache.block_size
    pools = cache.arrays()
    snap = (eng._ahead or {}).get("undo")
    if isinstance(snap, TailSnapshot):
        pools = [tuple(a.clone().index_copy_(0, snap.idx, sv)
                       for a, sv in zip(layer, saved))
                 for layer, saved in zip(pools, snap.saved)]
    out = {}
    for req in list(eng._active.values()):
        n = int(cache.lengths[req.slot])
        idx = torch.as_tensor(cache.tables[req.slot, :-(-n // bs)].astype(
            np.int64), device=cache.pool.device)
        rows = []
        for layer in pools:
            for a in layer[:2]:
                blk = a.index_select(0, idx)             # [nb, h, bs, d]
                rows.append(blk.transpose(0, 1).reshape(
                    blk.shape[1], -1, blk.shape[3])[:, :n])
            rows += [a.index_select(0, idx) for a in layer[2:]]
        out[order[req]] = (n, rows)
    return out


def forced_miss(torch, model, case, prompts, new_state):
    """An int8 engine with dispatch-ahead and one without, stepped in
    lockstep over the same requests, with the same event before step
    ``AHEAD_EVENT_AT`` (``case``: an admission of half the requests, a
    cancel of two, or a weight swap); after every step the two engines'
    committed KV must be equal bit for bit, and at the end their tokens.
    Returns the dispatch-ahead engine's hits and misses and the steps."""
    engines = {a: ahead_engine(model, "int8", a) for a in (True, False)}
    reqs = {a: [] for a in engines}
    order = {a: {} for a in engines}
    first = prompts if case != "admission" else prompts[:len(prompts) // 2]
    saved = [p.detach().clone() for p in model.parameters()]

    def submit(ps):
        for a, eng in engines.items():
            for p in ps:
                r = eng.submit(p, max_new_tokens=AHEAD_NEW)
                order[a][r] = len(reqs[a])
                reqs[a].append(r)

    submit(first)
    steps = 0
    while any(not e.idle for e in engines.values()):
        if steps == AHEAD_EVENT_AT:
            for a, eng in engines.items():
                if case == "cancel":
                    for r in reqs[a][:2]:
                        eng.cancel(r.id)
                if case == "swap_weights":
                    eng.swap_weights(new_state)
            if case == "admission":
                submit(prompts[len(prompts) // 2:])
        for eng in engines.values():
            eng.step()
        steps += 1
        kv = {a: committed_kv(torch, e, order[a])
              for a, e in engines.items()}
        if sorted(kv[True]) != sorted(kv[False]):
            raise AssertionError(f"phase 5l, {case}: other rows active")
        for i in kv[True]:
            (n1, r1), (n0, r0) = kv[True][i], kv[False][i]
            if n1 != n0 or not all(torch.equal(x, y)
                                   for x, y in zip(r1, r0)):
                raise AssertionError(
                    f"phase 5l, {case}: request {i}'s committed int8 KV "
                    f"differs after step {steps}")
    with torch.no_grad():
        for p, v in zip(model.parameters(), saved):
            p.copy_(v)
    toks = {a: [r.tokens for r in reqs[a]] for a in engines}
    if toks[True] != toks[False]:
        raise AssertionError(f"phase 5l, {case}: tokens differ with "
                             "dispatch-ahead on and off")
    st = engines[True].stats()
    release_engines(engines.values())
    if not st["ahead_misses"]:
        raise AssertionError(f"phase 5l, {case}: no speculation missed")
    return {"hits": st["ahead_hits"], "misses": st["ahead_misses"],
            "steps": steps}


def dispatch_ahead_serving(torch, ctr, card):
    """Phase 5l: dispatch-ahead megasteps on a fresh seeded gpt2-medium at
    full width and depth, phase 4's engine geometry at megastep 8, one
    seeded request set (16 requests, 48 new tokens) with it off and on,
    per pool dtype (f32, bf16, int8): each engine warmed, then a timed
    run that must capture nothing, launch B4 ``num_layers`` times per
    megastep enqueued (speculations included) and leak no block; tokens
    equal on and off (the top-2 rule), hits >= 1 on the steady batch, the
    megastep graph's kernel nodes the same in both arms. Printed, per
    arm: hits and misses, TPOT p50, tokens/s, the host's commit ms per
    megastep and the device ms of one megastep replay (whether the commit
    hides behind the next megastep). Then forced misses on int8 pools (an
    admission, a cancel, a weight swap), each stepped in lockstep against
    an engine without dispatch-ahead: committed int8 blocks and tokens
    equal (:func:`forced_miss`)."""
    from paddle_tpu_torch.models.gpt import GPT_CONFIGS, GPTForCausalLM
    cfg = GPT_CONFIGS["gpt2-medium"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = GPTForCausalLM(cfg, device="cuda", generator=gen).eval()
    rng = np.random.RandomState(21)
    prompts = [rng.randint(0, cfg.vocab_size, size=int(k)).tolist()
               for k in rng.randint(8, 65, size=AHEAD_REQUESTS)]
    specs = [(p, {"max_new_tokens": AHEAD_NEW}) for p in prompts]
    out = {"arms": {}}
    for kv in ("f32", "bf16", "int8"):
        toks, kernels = {}, {}
        for ahead in (False, True):
            what = f"phase 5l, {kv}, dispatch-ahead {'on' if ahead else 'off'}"
            eng = ahead_engine(model, kv, ahead)
            warm(torch, eng)
            commits = commit_times(eng)
            res, toks[ahead] = drive(torch, ctr, eng, specs, what)
            st = eng.stats()
            eng.cache.flush_prefix_cache()
            leaked = eng.cache.allocator.leaked()
            if leaked != 1:
                raise AssertionError(f"{what}: {leaked - 1} blocks leaked")
            with ctr.aside():
                dev_ms, kernels[ahead] = megastep_device_ms(torch, eng)
            release_engines([eng])
            arm = {k: res[k] for k in ("tokens", "wall_s", "tokens_per_s",
                                       "tpot_p50_ms", "ttft_p50_ms",
                                       "launches", "routes",
                                       "megastep_dispatches",
                                       "captures_in_run")}
            arm.update(hits=st.get("ahead_hits"),
                       misses=st.get("ahead_misses"),
                       commit_ms_p50=float(np.median(commits)),
                       commit_ms_mean=float(np.mean(commits)),
                       megasteps_committed=len(commits),
                       megastep_device_ms=dev_ms,
                       graph_kernels=kernels[ahead])
            out["arms"][f"{kv}_{'on' if ahead else 'off'}"] = arm
            log(f"  [{card}] {what}: hits {arm['hits']}, misses "
                f"{arm['misses']}, TPOT p50 {arm['tpot_p50_ms']:.3f} ms, "
                f"{arm['tokens_per_s']:.1f} tokens/s; host commit "
                f"{arm['commit_ms_p50']:.3f} ms (p50 of "
                f"{len(commits)} megasteps) against {dev_ms:.3f} ms of "
                f"device time per megastep")
        if not out["arms"][f"{kv}_on"]["hits"]:
            raise AssertionError(f"phase 5l, {kv}: no speculation hit")
        if kernels[True] != kernels[False]:
            raise AssertionError(f"phase 5l, {kv}: the megastep graph holds "
                                 f"{kernels[True]} kernels with dispatch-"
                                 f"ahead, {kernels[False]} without")
        div = same_tokens(torch, model, prompts, toks[False], toks[True],
                          f"phase 5l, {kv}: dispatch-ahead on vs off")
        out["arms"][f"{kv}_on"]["near_ties"] = div
        release_graphs(torch, model)
    g = torch.Generator(device="cuda").manual_seed(1)
    new_state = {n: p.detach() + 0.01 * torch.randn(
        p.shape, device="cuda", generator=g)
        for n, p in model.named_parameters()}
    out["forced"] = {}
    for case in ("admission", "cancel", "swap_weights"):
        out["forced"][case] = forced_miss(torch, model, case, prompts[:8],
                                          new_state)
        release_graphs(torch, model)
        log(f"  phase 5l, forced {case} (int8): committed KV and tokens "
            f"equal with dispatch-ahead on and off; {out['forced'][case]}")
    out["launches"] = sum(a["launches"] for a in out["arms"].values())
    out["routes"] = {}
    for a in out["arms"].values():
        for r, n in a["routes"].items():
            out["routes"][r] = out["routes"].get(r, 0) + n
    del model
    torch.cuda.empty_cache()
    return out


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
    # phase 21's shape: Transformer-base's non-causal bf16 attention, b 8
    # x h 8 at s 1024, d 64
    cases += [("bf16", False, 64, 1024, 1024, 64)]
    # seeds: the 26 cases of PR 2 keep theirs (100 + their index there)
    seeds = [98, 99] + list(range(100, 126)) + [126, 127, 128] + \
        [129, 130, 131, 132, 133]
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
    """One forward+backward with ``flag`` (a flag's name, or a tuple of
    them) on (the kernel route) and one with it off (the composed route)
    from the same weights; raises unless
    the losses agree within 1e-2 relative and each gradient within 5e-2
    relative Frobenius. A key projection's bias (ERNIE's ``k_proj.bias``)
    shifts every logit of a row alike, so its true gradient is zero and
    both routes hold rounding noise: it is held to 5e-2 of the norm of
    its query bias's gradient. Leaves ``flag`` on."""
    from paddle_tpu_torch import flags
    names = (flag,) if isinstance(flag, str) else tuple(flag)
    ref = {}
    for use in (True, False):
        flags.set_flags({n: use for n in names})
        model.zero_grad(set_to_none=True)
        loss = loss_of()
        loss.backward()
        ref[use] = (float(loss.detach()),
                    {n: p.grad.detach().clone()
                     for n, p in model.named_parameters()
                     if p.grad is not None})
    flags.set_flags({n: True for n in names})
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
    log(f"  {' + '.join(names)} on vs off (O2, one forward+backward): "
        f"loss {lf} vs {lc} "
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
def flash_work(kernel, bh, s, d, elem, causal=True):
    """(bytes, FLOPs) one call must move and do at [bh, s, d]: each input
    read once and each output written once; the products of the (q, k)
    pairs the mask leaves (k <= q only for a causal call)."""
    pairs = s * (s + 1) // 2 if causal else s * s
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
    bh, scale = b * h, 1.0 / d ** 0.5
    out = time_flash_bf16(torch, fa, ctr, card, b, h, s, d, True)
    with ctr.aside():
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


def time_flash_bf16(torch, fa, ctr, card, b, h, s, d, causal, dt="bf16"):
    """The three flash kernels in bf16 (or ``dt`` "f32") at ``[b, h, s,
    d]``, causal or not, their plain versions and PyTorch's
    scaled_dot_product_attention (forward; backward = dq, dk and dv in
    one call): ms per call, the bound of the work the mask leaves (at the
    dtype's element size and peak), TFLOP/s, the fraction of the bound
    and the route each launch took. Launches are not counted."""
    import torch.nn.functional as F
    bh, scale = b * h, 1.0 / d ** 0.5
    elem, peak = (2, BF16_FLOPS) if dt == "bf16" else (4, F32_FLOPS)
    q, k, v, do = flash_inputs(torch, bh, s, s, d, dt, seed=7)
    qd, kd, vd = (t.reshape(b, h, s, d) for t in (q, k, v))
    q4, k4, v4 = (t.detach().requires_grad_() for t in (qd, kd, vd))
    o4 = F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal,
                                        scale=scale)
    do4 = do.reshape(b, h, s, d)
    out = {}
    with ctr.aside():
        o, lse = fa.flash_fwd(q, k, v, causal, scale)
        delta = (do.float() * o.float()).sum(-1)
        args = (q, k, v, do, lse, delta, causal, scale)
        calls = {
            "flash_fwd": (lambda i: fa.flash_fwd(q, k, v, causal, scale),
                          lambda i: fa.flash_fwd_plain(q, k, v, causal,
                                                       scale),
                          lambda i: F.scaled_dot_product_attention(
                              qd, kd, vd, is_causal=causal, scale=scale)),
            "flash_bwd_dq": (lambda i: fa.flash_bwd_dq(*args),
                             lambda i: fa.flash_bwd_dq_plain(*args), None),
            "flash_bwd_dkv": (lambda i: fa.flash_bwd_dkv(*args),
                              lambda i: fa.flash_bwd_dkv_plain(*args),
                              None),
        }
        sdpa_bwd = time_fn(torch, lambda i: torch.autograd.grad(
            o4, (q4, k4, v4), do4, retain_graph=True), 20, 1)
        kind = "causal" if causal else "non-causal"
        for name, (kern, plain, lib) in calls.items():
            before = ctr.routes()[name]
            ms = time_fn(torch, kern, 20, 1)
            route = next(r for r, n in ctr.routes()[name].items()
                         if n > before[r])
            plain_ms = time_fn(torch, plain, 5, 1)
            lib_ms = time_fn(torch, lib, 20, 1) if lib else sdpa_bwd
            b_ = bound(*flash_work(name, bh, s, d, elem, causal), peak)
            out[name] = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                         "library_call": (
                             "scaled_dot_product_attention" if lib
                             else "scaled_dot_product_attention backward "
                             "(dq, dk and dv together)"),
                         **b_, "tflops_per_s": b_["flops"] / ms / 1e9,
                         "bound_fraction": b_["bound_ms"] / ms,
                         "cuda_route": route, "causal": causal,
                         "shape": [b, h, s, d]}
            log(f"  {name} {dt} {kind} [{b}, {h}, {s}, {d}] ({route}): "
                f"kernel {ms:.4f} ms ({b_['flops'] / ms / 1e9:.2f} TFLOP/s, "
                f"{b_['bound_ms'] / ms:.3f} of the bound), plain "
                f"{plain_ms:.4f} ms, library {lib_ms:.4f} ms, "
                f"{b_['bytes']} B / {b_['flops']} FLOP -> bound "
                f"{b_['bound_ms']:.4f} ms ({b_['bound_by']}) [{card}]")
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
    # phase 21's rows: Transformer-base's f32 [8192, 512] under O2
    cases += [("f32", "f32", 512, 8192), ("f32", "f32", 512, 37)]
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
    ERNIE-base [8192, 768], GPT-2 345M [8192, 1024] and Transformer-base
    [8192, 512] (phase 21's rows)."""
    import torch.nn.functional as F
    out = {"ln_fwd": {}, "ln_bwd": {}}
    with ctr.aside():
        for model, h in (("ernie-base", 768), ("gpt2-medium", 1024),
                         ("transformer-base", 512)):
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
# a bf16 model with its own or f32 moments, an fp16 one, and a float64
# program (phase 26 (d)'s card-against-CPU steps; its first cases read a
# float64 lr, as that program's upcast scope holds it)
ADAMW_DTYPES = (("float32", "float32"), ("float32", "bfloat16"),
                ("bfloat16", "bfloat16"), ("bfloat16", "float32"),
                ("float16", "float16"), ("float64", "float64"))


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
    cases, worst = 0, 0.0
    with ctr.aside():
        for pname, mname in ADAMW_DTYPES:
            pdtype, mdtype = getattr(torch, pname), getattr(torch, mname)
            lr = torch.full((1,), 1e-4, device="cuda",
                            dtype=torch.promote_types(pdtype, torch.float32))
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
            eng.model, eng.megastep, kv_dtype=eng.kv_dtype,
            lora_shape=eng._lora_shape, attn_impl=eng.attn_impl)
    else:
        ent = generation.decode_step_paged(
            eng.model, kv_dtype=eng.kv_dtype, lora_shape=eng._lora_shape,
            attn_impl=eng.attn_impl)
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


# ------------------------------------------------------------ phase 21
TB_BATCH, TB_SEQ = 8, 1024     # Transformer-base at src = tgt = 1024
TB_DECODE = 32                 # greedy incremental decoding steps
#: kernel launches per Transformer-base train step: the flash kernels
#: in the 6 encoder self-attentions and the 6 cross-attentions (the
#: decoder's masked self-attention composes), the LayerNorm kernels in
#: 2 norms per encoder layer and 3 per decoder layer, one AdamW
TB_PER_STEP = {"flash_fwd": 12, "flash_bwd_dq": 12, "flash_bwd_dkv": 12,
               "ln_fwd": 30, "ln_bwd": 30, "adamw": 1}


#: phase 21's shared source/target vocabulary (WMT14 En-De's joint BPE
#: of the Transformer paper: 37000 tokens)
TB_VOCAB = 37000


def sinusoid(torch, seq, d):
    """The Transformer paper's fixed position encoding ``[seq, d]``."""
    pos = np.arange(seq)[:, None]
    div = np.exp(np.arange(0, d, 2) * (-np.log(10000.0) / d))
    pe = np.zeros((seq, d), np.float32)
    pe[:, 0::2], pe[:, 1::2] = np.sin(pos * div), np.cos(pos * div)
    return torch.from_numpy(pe).cuda()


def transformer_step(torch, batch=TB_BATCH, seq=TB_SEQ, vocab=TB_VOCAB):
    """``nn.Transformer()`` at its defaults (Transformer-base: d_model 512,
    8 heads, 6 + 6 post-LN layers, FFN 2048) with dropout 0 and random
    weights from seed 0, as the translation model of the Transformer
    paper: one token table ``[vocab, 512]`` (N(0, 512^-1/2)) embeds
    source and target (times sqrt(512), plus the sinusoidal positions)
    and, tied, scores the decoder's output; the loss is the cross-entropy
    of each next target token, the decoder under the square subsequent
    mask. AMP O2 bf16, AdamW (lr 1e-4, bf16 moments); token ids from numpy
    ``RandomState(0)``. Returns ``(model, loss_of, step)`` as
    :func:`ernie_step` does; ``model.embed`` is the table."""
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.amp import auto_cast
    from paddle_tpu_torch.optimizer import AdamW
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = nn.Transformer(dropout=0.0, device="cuda", generator=gen)
    d = model.d_model
    model.embed = nn.Embedding(vocab, d, std=d ** -0.5, device="cuda",
                               generator=gen)
    opt = AdamW(learning_rate=1e-4, parameters=model.named_parameters(),
                moment_dtype="bfloat16")
    rng = np.random.RandomState(0)
    src, tgt = (torch.from_numpy(rng.randint(0, vocab, (batch, seq + 1))
                                 .astype(np.int64)).cuda()
                for _ in range(2))
    pe = sinusoid(torch, seq, d)
    mask = nn.Transformer.generate_square_subsequent_mask(seq, device="cuda")

    def embed(ids):
        return model.embed(ids) * d ** 0.5 + pe

    def loss_of(level="O2"):
        with auto_cast(level=level):
            out = model(embed(src[:, :-1]), embed(tgt[:, :-1]),
                        tgt_mask=mask)
            logits = nn.functional.matmul(out, model.embed.weight.T)
            return nn.functional.cross_entropy(logits, tgt[:, 1:])

    return model, loss_of, _stepper(model, opt, loss_of)


#: phase 21's bound on the attention query and key projections'
#: gradients against the f32 step (see :func:`compare_routes_f32`)
QK_TOL = 0.5


def compare_routes_f32(torch, model, loss_of, names, tol=5e-2):
    """Phase 21's training gate: one O2 forward+backward with ``names``
    on (the kernel routes), one with them off (the composed routes) and
    an f32 one (O0, composed) from the same weights. The O2 losses must
    agree within 1e-2 relative, and every gradient within ``tol``
    relative Frobenius of the composed route's (:func:`compare_routes`'
    gate, the key-bias rule included) or, where the O2 rounding of the
    composed route itself puts it farther than that from the f32
    gradient, no farther from the f32 gradient than ``max(tol, 1.25 x)``
    the composed route is. The attention query and key projections'
    gradients are held to the f32 gradient within ``QK_TOL``.
    They come from dS = P (dO V^T - delta) alone, and at an initialized
    model's near-uniform attention that difference is mostly bf16
    rounding: the composed O2 route is itself up to ~20% off f32 there,
    and the flash route, whose delta = rowsum(dO O) is taken from the
    bf16 output (the JAX kernel's algorithm), more (CPU measurement at d
    512, PR 18). A wrong dQ or dK kernel is off by O(1); phase 6 holds the
    three kernels to their plain versions element by element at this
    path's shape. All three distances are logged for the worst
    gradients. Leaves ``names`` on."""
    from paddle_tpu_torch import flags
    runs = {}
    for key, on, level in (("kernel", True, "O2"), ("composed", False, "O2"),
                           ("f32", False, "O0")):
        flags.set_flags({n: on for n in names})
        model.zero_grad(set_to_none=True)
        loss = loss_of(level)
        loss.backward()
        runs[key] = (float(loss.detach()),
                     {n: p.grad.detach().float().clone()
                      for n, p in model.named_parameters()
                      if p.grad is not None})
    flags.set_flags({n: True for n in names})
    model.zero_grad(set_to_none=True)
    (lk, gk), (lc, gc), (lf, gf) = (runs[k] for k in ("kernel", "composed",
                                                       "f32"))

    def rel(a, b):
        out = {}
        for n in b:
            den = float(b[n.replace("k_proj.bias", "q_proj.bias")].norm())
            out[n] = float((a[n] - b[n]).norm()) / den if den else \
                float(a[n].norm())
        return out

    kc, cf, kf = rel(gk, gc), rel(gc, gf), rel(gk, gf)
    rel_loss = abs(lk - lc) / abs(lc)
    qk = {n for n in kc if "_attn.q_proj." in n or "_attn.k_proj." in n}
    bad = {n: (kc[n], cf[n], kf[n]) for n in kc
           if (kf[n] > QK_TOL if n in qk else
               kc[n] > tol and kf[n] > max(tol, 1.25 * cf[n]))}
    rest = max((kc[n], n) for n in kc if n not in qk)
    worst_qk = max((kf[n], n) for n in qk)
    log(f"  {' + '.join(names)} on vs off (O2, one forward+backward): loss "
        f"{lk} vs {lc} (rel {rel_loss:.2e}; f32 {lf}); worst gradient "
        f"kernel vs composed {rest[0]:.3e} ({rest[1]}); query/key "
        f"projections: worst kernel vs f32 {worst_qk[0]:.3e} "
        f"({worst_qk[1]}; composed vs f32 {cf[worst_qk[1]]:.3e})")
    for n in sorted(kc, key=kc.get)[-4:]:
        log(f"    {n}: kernel vs composed {kc[n]:.3e}, composed vs f32 "
            f"{cf[n]:.3e}, kernel vs f32 {kf[n]:.3e}")
    if rel_loss > 1e-2:
        raise AssertionError(f"kernel-route loss {lk} vs composed {lc}")
    if bad:
        raise AssertionError(f"gradients off (kernel vs composed, composed "
                             f"vs f32, kernel vs f32): {bad}")
    del runs, gk, gc, gf
    torch.cuda.empty_cache()
    return {"loss_kernel": lk, "loss_composed": lc, "loss_f32": lf,
            "rel_loss": rel_loss,
            "worst_grad_rel": rest[0], "worst_grad_param": rest[1],
            "worst_qk_vs_f32": worst_qk[0], "worst_qk_param": worst_qk[1],
            "worst_qk_composed_vs_f32": cf[worst_qk[1]],
            "max_composed_vs_f32": max(cf.values())}


def incremental_decode(torch, model, card, steps=TB_DECODE):
    """Greedy decoding of ``steps`` tokens (f32, eval) over a memory of
    ``TB_SEQ`` tokens: a token table ``E [V, 512]`` (V 1024, seed 2) embeds
    each token and ``h @ E^T`` scores the next; the decoder runs one token
    per step through ``gen_cache`` (a growing self-attention ``Cache``,
    the cross-attention's ``StaticCache`` of the memory). Each step's
    token must equal the full decoder's over the prefix (square mask)
    where that decoder's top-2 scores are more than 1e-3 apart, and its
    scores agree within 1e-3 absolute. Returns the decode's numbers."""
    from paddle_tpu_torch import nn
    model.eval()
    g = torch.Generator(device="cuda").manual_seed(2)
    table = torch.randn(1024, model.d_model, device="cuda",
                        generator=g) * 0.05
    rng = np.random.RandomState(3)
    src = torch.from_numpy(rng.randn(TB_BATCH, TB_SEQ, model.d_model)
                           .astype(np.float32)).cuda()
    near, worst = [], 0.0
    with torch.no_grad():
        memory = model.encoder(src)
        cache = model.decoder.gen_cache(memory)
        toks = torch.zeros(TB_BATCH, 1, dtype=torch.long, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(steps):
            h, cache = model.decoder(table[toks[:, -1:]], memory,
                                     cache=cache)
            scores = h[:, -1] @ table.T
            full = model.decoder(
                table[toks], memory,
                nn.Transformer.generate_square_subsequent_mask(
                    t + 1, device="cuda"))[:, -1] @ table.T
            worst = max(worst, float((scores - full).abs().max()))
            nxt, ref = scores.argmax(-1), full.argmax(-1)
            for row in torch.nonzero(nxt != ref).flatten().tolist():
                top = torch.topk(full[row], 2).values
                gap = float(top[0] - top[1])
                near.append({"step": t, "row": row, "gap": gap})
                if gap >= 1e-3:
                    raise AssertionError(
                        f"phase 21: incremental token {int(nxt[row])} vs "
                        f"full decoder's {int(ref[row])} at step {t}, row "
                        f"{row} (top-2 gap {gap})")
            toks = torch.cat([toks, ref[:, None]], dim=1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if worst > 1e-3:
        raise AssertionError(f"phase 21: incremental scores off the full "
                             f"decoder's by {worst}")
    model.train()
    log(f"  [{card}] incremental greedy decoding, {steps} tokens x "
        f"{TB_BATCH} rows over a {TB_SEQ}-token memory: equal to the full "
        f"decoder at every step ({len(near)} near ties), scores within "
        f"{worst:.2e}; {wall:.3f} s with the full decoder re-run each step")
    return {"steps": steps, "near_ties": near, "max_abs_score_diff": worst,
            "wall_s": wall}


def train_transformer(torch, fa, ctr, card, warmup=2, steps=5):
    """Phase 21: the Transformer-base step of :func:`transformer_step`.
    The kernel routes (``use_pallas_attention`` and
    ``use_pallas_layer_norm`` on) against the composed ones and an f32
    step from the same weights (:func:`compare_routes_f32`); ``steps``
    timed eager steps with exactly
    ``TB_PER_STEP`` launches per step, every flash launch on ``wgmma``,
    the losses finite and falling; the device's busy ms per step and its
    idle share, peak memory; the flash kernels at this shape
    (non-causal, b 8, h 8, s 1024, d 64) against SDPA and their bound;
    then greedy incremental decoding (:func:`incremental_decode`)."""
    from paddle_tpu_torch import flags
    names = ("use_pallas_attention", "use_pallas_layer_norm")
    saved = flags.get_flags(list(names))
    try:
        model, loss_of, step = transformer_step(torch)
        cmp = compare_routes_f32(torch, model, loss_of, names)
        want = {k: v * steps for k, v in TB_PER_STEP.items()}
        res = run_steps(torch, ctr, step, warmup, steps, want,
                        "Transformer-base, kernel routes, eager")
    finally:
        flags.set_flags(saved)
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        if any(n for r, n in res["routes"][name].items() if r != "wgmma"):
            raise AssertionError(f"phase 21: {name} launches by route "
                                 f"{res['routes'][name]}")
    tokens = TB_BATCH * TB_SEQ
    log(f"  [{card}] Transformer-base: {res['step_ms']:.3f} ms per step "
        f"({tokens * 2 / res['step_ms'] * 1e3:.0f} src+tgt tokens/s), "
        f"device busy {res['device_busy_ms']:.3f} ms, idle share "
        f"{res['idle_share']:.4f}; max_memory_allocated "
        f"{res['peak_bytes']} B, max_memory_reserved "
        f"{res['peak_reserved_bytes']} B")
    times = time_flash_bf16(torch, fa, ctr, card, TB_BATCH, model.nhead,
                            TB_SEQ, model.d_model // model.nhead, False)
    dec = incremental_decode(torch, model, card)
    del model, step
    torch.cuda.empty_cache()
    return {**res, "routes_vs_composed": cmp, "flash": times,
            "decode": dec}


# ------------------------------------------------------------ phase 22
#: bench.py's widedeep config (``child_main_widedeep``, bench.py:195-257):
#: the Criteo geometry, batch 512, ids uniform over [1, 1,000,000)
WD_SLOTS, WD_DIM, WD_HIDDEN, WD_BATCH = 26, 16, (400, 400, 400), 512
WD_IDS = 1_000_000
WD_WARMUP, WD_STEPS, WD_CHECKED = 3, 50, 3
#: phase 22's tolerances, card against the port on the CPU (f32 matmuls
#: on both, TF32 off): the loss within 1e-5 relative; each pushed row
#: gradient and each dense parameter within 1e-4 relative Frobenius
#: distance and 1e-6 absolute per element (each ReLU layer's
#: pre-activation and its gradient too; a ReLU tied at its kink as
#: ``wd_step_close`` says)
WD_LOSS_RTOL, WD_FRO, WD_ATOL = 1e-5, 1e-4, 1e-6


def wd_batches(rng, n):
    """``n`` batches of bench.py's stream (``batches`` in
    ``child_main_widedeep``): ids uniform over [1, WD_IDS) from ``rng``,
    the label the parity of the first slot's id."""
    out = []
    for _ in range(n):
        ids = rng.randint(1, WD_IDS, (WD_BATCH, WD_SLOTS)).astype(np.int64)
        y = (ids[:, 0] % 2 == 0).astype(np.float32)[:, None]
        out.append({"ids": ids, "label": y})
    return out


def gated(batches, done):
    """Yield ``batches`` in turn, each after the step before it pushed
    (``done[i]`` set by ``on_step``): the prefetcher then pulls no row
    before the push it could depend on, so a run is deterministic."""
    for i, b in enumerate(batches):
        if i:
            done[i - 1].wait()
        yield b


def wd_layers(main):
    """The deep tower's ReLU layers, ``[(h, w, b, z)]`` bottom up: the
    layer's input ``h``, weight ``w`` and bias ``b`` and its
    pre-activation ``z = h w + b`` (``elementwise_add(mul(h, w), b)``)."""
    ops = main.global_block().ops
    made = {o: op for op in ops for vs in op.outputs.values() for o in vs}
    out = []
    for op in ops:
        if op.type == "relu":
            z = op.input("X")[0]
            add = made[z]
            mul = made[add.input("X")[0]]
            out.append((mul.input("X")[0], mul.input("Y")[0],
                        add.input("Y")[0], z))
    return out


def wd_step_close(i, layers, lr, pre, fd, fc, pd, pc):
    """Step ``i`` of phase 22's check, card (``fd``, ``pd``) against the
    CPU (``fc``, ``pc``) from the same state ``pre`` (the dense
    parameters before the step). The fetches are the loss, both rows'
    gradients, then ``h``, ``z`` and ``z@GRAD`` of each of ``layers``
    (:func:`wd_layers`).

    A ReLU whose pre-activation lies within rounding of 0 can take the
    other side on the card than on the CPU (a tie at the kink, as a
    quantization code flips in phase 26 (d)); the gradient of that
    sample then differs by what passes that unit (up to 1e-5 in a row,
    2 of 16 fresh startups on an H100 80GB HBM3). So: the loss, the
    pre-activations, every row gradient and ``z@GRAD`` of every sample
    with no flipped unit, and the wide rows, are held to phase 22's
    tolerances; a flipped unit must lie within ``WD_ATOL`` of 0 on both
    sides, with ``z@GRAD`` 0 on the side whose ReLU is off; a flipped
    sample's ``z@GRAD`` below its top layer and its embedding rows'
    gradient are held to their float64 recomputation from the card's own
    gradient above them, weights and ReLU masks (``(g w^T) * (z > 0)``),
    and its top layer's ``z@GRAD`` to the CPU's on the units both sides
    pass; the dense parameters are held after taking out the flipped
    samples' terms of the card's and the CPU's gradients (``lr h^T
    z@GRAD`` and ``lr sum z@GRAD`` of those samples, SGD). Returns the
    largest differences and the flipped units."""
    lo_d, lo_c = float(fd[0]), float(fc[0])
    if not np.isfinite(lo_d) or abs(lo_d - lo_c) > \
            WD_LOSS_RTOL * max(1.0, abs(lo_c)):
        raise AssertionError(f"phase 22: step {i} loss card {lo_d!r} "
                             f"vs CPU {lo_c!r}")
    f64 = [np.asarray(a, np.float64) for a in fd]
    c64 = [np.asarray(a, np.float64) for a in fc]
    n = f64[1].shape[0]
    hs = [(f64[3 + 3 * k], c64[3 + 3 * k]) for k in range(len(layers))]
    zs = [(f64[4 + 3 * k], c64[4 + 3 * k]) for k in range(len(layers))]
    gs = [(f64[5 + 3 * k], c64[5 + 3 * k]) for k in range(len(layers))]
    on = [(zd > 0, zc > 0) for zd, zc in zs]
    flipped = np.zeros(n, bool)
    units = 0
    for k, ((zd, zc), (md, mc), (gd, gc)) in enumerate(zip(zs, on, gs)):
        wd_close(f"step {i} {layers[k][3]}", zd, zc)
        fl = md != mc
        if fl.any():
            if max(np.abs(zd[fl]).max(), np.abs(zc[fl]).max()) > WD_ATOL:
                raise AssertionError(f"phase 22: step {i} "
                                     f"{layers[k][3]}: a ReLU flipped "
                                     "away from its kink")
            off = np.where(md[fl], gc[fl], gd[fl])
            if np.any(off != 0):
                raise AssertionError(f"phase 22: step {i} "
                                     f"{layers[k][3]}@GRAD passes a "
                                     "ReLU that is off")
        units += int(fl.sum())
        flipped |= fl.any(1)
    ok = ~flipped
    worst = {"row_grads": 0.0, "dense": 0.0, "recomputed": 0.0}
    for g_d, g_c, name in zip(f64[1:3], c64[1:3], ("ctr_emb", "ctr_wide")):
        rows = ok if name == "ctr_emb" else slice(None)
        worst["row_grads"] = max(worst["row_grads"], wd_close(
            f"step {i} {name}@GRAD", g_d[rows], g_c[rows]))
    for k, (gd, gc) in enumerate(gs):
        wd_close(f"step {i} {layers[k][3]}@GRAD", gd[ok], gc[ok])
    f = np.flatnonzero(flipped)
    if f.size:
        top_d, top_c = gs[-1][0][f], gs[-1][1][f]
        both = on[-1][0][f] == on[-1][1][f]
        worst["recomputed"] = wd_close(f"step {i} flipped samples' top "
                                       "z@GRAD", top_d[both], top_c[both])
        for k in range(len(layers) - 1, -1, -1):
            w = pre[layers[k][1]].astype(np.float64)
            up = gs[k][0][f] @ w.T
            if k:
                want, got = up * on[k - 1][0][f], gs[k - 1][0][f]
            else:
                want, got = up, f64[1][f].reshape(f.size, -1)
            worst["recomputed"] = max(worst["recomputed"], wd_close(
                f"step {i} flipped samples' "
                f"{layers[k - 1][3] + '@GRAD' if k else 'ctr_emb@GRAD'}",
                got, want))
    fix = {}
    for (h, w, b, _), (hd, hc), (gd, gc) in zip(layers, hs, gs):
        fix[w] = lr * (hd[f].T @ gd[f] - hc[f].T @ gc[f])
        fix[b] = lr * (gd[f].sum(0) - gc[f].sum(0))
    for name in pc:
        got = np.asarray(pd[name], np.float64) + fix.get(name, 0.0)
        worst["dense"] = max(worst["dense"], wd_close(
            f"step {i} {name}", got, pc[name]))
    worst["loss"] = abs(lo_d - lo_c)
    worst["flipped_units"] = units
    worst["flipped_samples"] = int(f.size)
    return worst


def wd_close(what, got, ref, fro=WD_FRO, atol=WD_ATOL):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    err = float(np.abs(got - ref).max()) if got.size else 0.0
    rel = float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30))
    if got.shape != ref.shape or not np.isfinite(got).all() or \
            (rel > fro and err > atol):
        raise AssertionError(f"phase 22: {what} card vs CPU: max abs "
                             f"{err:.3e}, relative Frobenius {rel:.3e}")
    return err


def wd_run(exe, main, scope, fetch, feeds, batches):
    """The host-paced loop over ``batches`` one step at a time (gated),
    fetching ``fetch``: per step ``(fetches, {dense parameter:
    value})``."""
    from paddle_tpu_torch.distributed.ps import run_host_paced
    params = [p.name for p in main.all_parameters()]
    done = [threading.Event() for _ in batches]
    steps = []

    def on_step(i, fetched):
        steps.append((fetched, {n: scope.get_numpy(n) for n in params}))
        done[i].set()

    run_host_paced(exe, main, scope, gated(batches, done), feeds,
                   fetch_list=fetch,
                   on_step=on_step, collect=False)
    return steps


def widedeep(torch, ctr, card):
    """Phase 22: ``bench.py``'s widedeep step, uncut
    (``build_wide_deep_program(26, 16, (400, 400, 400), sparse_lr 0.05,
    dense_lr 0.01, host_paced=True)``, batch 512, the two SparseFeeds of
    ``bench.py:219-220``, ``run_host_paced`` with its prefetcher) through
    the port's static executor on the card. The startup program, then
    ``WD_WARMUP`` steps, each held against the port on the CPU from a
    copy of the card's scope and tables before it (loss, pre-activations,
    pushed row gradients and dense parameters, within phase 22's
    tolerances; a ReLU tied at its kink as :func:`wd_step_close` holds
    it); the step's key captures once (the second run) and the
    ``WD_STEPS`` timed
    steps capture nothing and launch no port kernel; ``set_lr(scope=)``
    between replays is taken at the next step. Prints examples/s, step
    ms, host pull / push ms beside the device's busy ms per step and its
    idle share, rows live and peak memory."""
    from paddle_tpu_torch.distributed.ps import (REGISTRY, SparseFeed,
                                                  run_host_paced)
    from paddle_tpu_torch.framework import Executor, Scope
    from paddle_tpu_torch.models.convert import scope_from_numpy
    from paddle_tpu_torch.models.ctr import build_wide_deep_program
    from paddle_tpu_torch.optimizer import SGD
    REGISTRY.clear()
    main, startup, loss, _ = build_wide_deep_program(
        num_slots=WD_SLOTS, embed_dim=WD_DIM, hidden_sizes=WD_HIDDEN,
        table_name="bench_emb", sparse_lr=0.05, dense_lr=0.01,
        host_paced=True)
    scope, exe = Scope(), Executor()
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(0)
    warm = wd_batches(rng, WD_WARMUP)
    lr_name = next(op.input("LearningRate")[0]
                   for op in main.global_block().ops if op.type == "sgd")
    layers = wd_layers(main)
    # one fetch list for every run (run_host_paced adds the rows'
    # gradients to it), so every step has the one key: the loss, the
    # rows' gradients, and for the check each ReLU layer's input,
    # pre-activation and its gradient (~7.5 MB more per step from the
    # card)
    fetch = [loss.name, "ctr_emb@GRAD", "ctr_wide@GRAD"] + [
        v for h, _, _, z in layers for v in (h, z, z + "@GRAD")]

    def feeds(prefix=""):
        return [SparseFeed("ctr_emb", prefix + "bench_emb", WD_DIM,
                           lr=0.05),
                SparseFeed("ctr_wide", prefix + "bench_emb_wide", 1,
                           lr=0.05)]

    # the checked steps' rows exist before the first step; each CPU step
    # starts from the card's tables and dense state before it
    for f in feeds():
        for b in warm:
            f.table().pull(b["ids"])
    cpu_exe = Executor("cpu")
    lr = float(scope.get_numpy(lr_name).reshape(-1)[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ctr.zero()
    worst, losses_warm = {}, []
    for i, b in enumerate(warm):
        for f, c in zip(feeds(), feeds("cpu_")):
            # state() hands out the rows themselves: copy them
            c.table().load_state({k: v.copy()
                                  for k, v in f.table().state().items()})
        pre = {n: scope.get_numpy(n) for n in scope.var_names()}
        cpu_scope = scope_from_numpy(pre, "cpu")
        (fc, pc), = wd_run(cpu_exe, main, cpu_scope, fetch, feeds("cpu_"),
                           [b])
        (fd, pd), = wd_run(exe, main, scope, fetch, feeds(), [b])
        step = wd_step_close(i, layers, lr, pre, fd, fc, pd, pc)
        for k, v in step.items():
            worst[k] = worst.get(k, 0) + v if k.startswith("flipped") \
                else max(worst.get(k, 0.0), v)
        losses_warm.append(float(fd[0]))
    log(f"  {WD_WARMUP} steps card vs CPU, each from the card's state "
        f"before it: losses {losses_warm}; max abs differences and "
        f"flipped ReLUs {worst}")
    if exe.captures != 1:
        raise AssertionError(f"phase 22: {exe.captures} captures in the "
                             "warm-up steps, expected 1 (the second run)")

    # set_lr(scope=) between replays: lr 0 leaves the dense parameters
    # as they are, the restored lr moves them again
    opt = SGD(learning_rate=main.global_block().var(lr_name))
    opt._create_lr_var()
    params = [p.name for p in main.all_parameters()]
    for lr_, moves in ((0.0, False), (0.01, True)):
        opt.set_lr(lr_, scope=scope)
        before = {n: scope.get_numpy(n) for n in params}
        run_host_paced(exe, main, scope, wd_batches(rng, 1), feeds(),
                       fetch_list=fetch)
        moved = any(not np.array_equal(before[n], scope.get_numpy(n))
                    for n in params)
        if moved != moves:
            raise AssertionError(f"phase 22: after set_lr({lr_}, scope=) "
                                 f"the next replay {'moved' if moved else 'left'}"
                                 " the dense parameters")
    log("  set_lr(scope=) between replays: lr 0 left every dense parameter "
        "as it was, lr 0.01 moved them")

    timed = wd_batches(rng, WD_STEPS)
    losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_host_paced(exe, main, scope, timed, feeds(), fetch_list=fetch,
                   on_step=lambda i, out: losses.append(float(out[0])),
                   collect=False)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / WD_STEPS
    if not np.all(np.isfinite(losses)):
        raise AssertionError(f"phase 22: timed losses {losses}")
    if exe.captures != 1:
        raise AssertionError(f"phase 22: {exe.captures} captures after the "
                             "timed steps, expected 1")
    run = ctr.read()
    ctr.expect(run, {}, "phase 22 (the widedeep step runs no port kernel)")
    peak = torch.cuda.max_memory_allocated()
    reserved = torch.cuda.max_memory_reserved()

    # the host's share: a pull (a prefetcher's gather of a batch's rows,
    # both tables) and a push, against the device's busy time per step
    probe = wd_batches(rng, 3)
    tables = [f.table() for f in feeds()]
    t_pull = time.perf_counter()
    for b in probe:
        for t in tables:
            t._pull_now(b["ids"])
    pull_ms = (time.perf_counter() - t_pull) / len(probe) * 1e3
    grads = [np.zeros((WD_BATCH, WD_SLOTS, t.value_dim), np.float32)
             for t in tables]
    t_push = time.perf_counter()
    for b in probe:
        for t, g in zip(tables, grads):
            t.push(b["ids"], g)
    push_ms = (time.perf_counter() - t_push) / len(probe) * 1e3
    traced = wd_batches(rng, 2)
    with ctr.aside():
        busy, names = device_trace(torch, lambda: run_host_paced(
            exe, main, scope, traced, feeds(), fetch_list=fetch))
    busy /= len(traced)
    idle = 1.0 - busy / (dt * 1e3)
    rows = REGISTRY.get("bench_emb").size()
    log(f"  [{card}] widedeep host-paced, batch {WD_BATCH}: "
        f"{WD_BATCH / dt:.1f} examples/s, {dt * 1e3:.3f} ms per step "
        f"({WD_STEPS} timed steps, 0 captures); host pull "
        f"{pull_ms:.3f} ms and push {push_ms:.3f} ms per step (both tables) "
        f"against device busy {busy:.3f} ms per step, idle share "
        f"{idle:.4f}; {sum(names.values()) / len(traced):.0f} kernels per "
        f"step; rows live {rows}; max_memory_allocated {peak} B, "
        f"max_memory_reserved {reserved} B; losses {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}")
    REGISTRY.clear()
    return {"examples_per_s": WD_BATCH / dt, "step_ms": dt * 1e3,
            "host_pull_ms": pull_ms, "host_push_ms": push_ms,
            "device_busy_ms": busy, "idle_share": idle,
            "kernels_per_step": sum(names.values()) / len(traced),
            "rows_live": rows, "peak_bytes": peak,
            "peak_reserved_bytes": reserved, "captures": exe.captures,
            "card_vs_cpu_max_abs": worst, "loss_first": losses[0],
            "loss_last": losses[-1], "launches": run}


# ------------------------------------------------------------ phase 23
#: the static encoder at Transformer-base's encoder widths, f32
SE_LAYERS, SE_D, SE_HEADS, SE_FFN = 6, 512, 8, 2048
SE_BATCH, SE_SEQ, SE_STEPS, SE_TIMED = 8, 1024, 3, 5
#: launches per step of the kernel route: per layer the forward of each
#: op, and its generic grad re-runs the forward before the backward (1
#: attention and 2 LayerNorm ops per layer); one AdamW launch per
#: parameter (16 per layer)
SE_PER_STEP = {"flash_fwd": 12, "flash_bwd_dq": 6, "flash_bwd_dkv": 6,
               "ln_fwd": 24, "ln_bwd": 12, "adamw": 96}
#: phase 23's tolerances, kernel routes against the composed ones from
#: one seeded scope, f32: each step's loss within 1e-5 relative; each
#: parameter after step k within 2 k lr + 1e-6 per element (Adam's steps
#: are near lr x sign(g), so a gradient element rounded across zero moves
#: its parameter by up to 2 lr); and the first step's gradients against
#: a float64 run of the composed route (the program pruned to its
#: gradients): each within SE_GRAD_FRO relative Frobenius distance of it,
#: or no farther than SE_GRAD_FACTOR x the composed f32 route is. The
#: loss is the mean square of a LayerNorm output, so its gradients are
#: differences of nearly equal terms (~1e-5 of their size) and carry
#: f32 rounding of ~1e-2 relative in either route
SE_LOSS_RTOL, SE_LR = 1e-5, 1e-4
SE_GRAD_FRO, SE_GRAD_FACTOR = 1e-3, 1.5


def se_run(torch, exe, main, scope, loss, feed, grads, steps):
    out = []
    for _ in range(steps):
        f = exe.run(main, feed=feed, fetch_list=[loss.name] + grads,
                    scope=scope, return_numpy=False)
        out.append(([float(f[0])] + f[1:],
                    {n[:-5]: scope.find_var(n[:-5]).clone() for n in grads}))
    torch.cuda.synchronize()
    return out


def se_grad_scale(torch, ref, name):
    """The norm a gradient's distance is taken relative to: its own
    float64 norm, and for a key projection's bias (``fc_<6 i + 1>.w_1``:
    q, k, v, out, FFN in, FFN out are each layer's six fc) the query
    bias's: the key bias's true gradient is zero (it shifts each query's
    logits alike), so its own norm is rounding."""
    fc, _, w = name[:-len("@GRAD")].partition(".")
    scale = float(torch.linalg.norm(ref[name]))
    idx = int(fc.split("_")[1]) if fc.startswith("fc_") else -1
    if w == "w_1" and idx % 6 == 1:
        scale = max(scale, float(torch.linalg.norm(
            ref[f"fc_{idx - 1}.w_1@GRAD"])))
    return max(scale, 1e-300)


def se_f64_grads(torch, main, start, grads, x):
    """The parameters' gradients at the scope ``start`` in float64 through
    the composed routes: the program pruned to ``grads`` (no update op)
    run on the scope's values cast to float64."""
    from paddle_tpu_torch import flags
    from paddle_tpu_torch.framework import Executor, Scope
    prog = main._prune(grads)
    scope = Scope()
    for n in start.var_names():
        scope.set_var(n, start.find_var(n).double())
    saved = flags.get_flags(["use_pallas_attention",
                             "use_pallas_layer_norm"])
    flags.set_flags({k: False for k in saved})
    try:
        out = Executor().run(prog, feed={"x": x.astype(np.float64)},
                             fetch_list=grads, scope=scope,
                             return_numpy=False)
    finally:
        flags.set_flags(saved)
    return dict(zip(grads, out))


def static_encoder(torch, fa, ctr, card, ltimes):
    """Phase 23: a Transformer-base encoder built with the ported
    ``layers`` as a static Program (``models/static_encoder.py``: d_model
    512, 8 heads, FFN 2048, 6 layers, batch 8, seq 1024, f32, AdamW)
    through the executor: ``SE_STEPS`` steps with
    ``use_pallas_attention`` and ``use_pallas_layer_norm`` on against as
    many with the composed routes, from one seeded scope (phase 23's
    tolerances); per step exactly ``SE_PER_STEP`` launches, every flash
    launch on the f32 ``simt`` route; one capture (the second run) and
    none after; then ``SE_TIMED`` timed replays, the device's busy ms per
    step and its idle share, and each kernel at this shape beside its
    bound (flash: SDPA's time for the same call)."""
    from paddle_tpu_torch import flags
    from paddle_tpu_torch.framework import Executor, Scope
    from paddle_tpu_torch.models.static_encoder import build_encoder_program
    names = ("use_pallas_attention", "use_pallas_layer_norm")
    saved = flags.get_flags(list(names) + ["pallas_min_seq"])
    main, startup, loss = build_encoder_program(
        SE_LAYERS, SE_D, SE_HEADS, SE_FFN, SE_SEQ, lr=SE_LR)
    grads = [p.name + "@GRAD" for p in main.all_parameters()]
    start, exe0 = Scope(), Executor()
    exe0.run(startup, scope=start)
    x = np.random.RandomState(23).randn(SE_BATCH, SE_SEQ, SE_D) \
        .astype(np.float32)
    feed = {"x": x}
    runs = {}
    # before the routes' runs: it sets flags, which would key them anew
    ref = se_f64_grads(torch, main, start, grads, x)
    try:
        # the kernel route last: its flags stay set, so the timed replays
        # below run under the key its steps captured
        for key, on in (("composed", False), ("kernel", True)):
            flags.set_flags({n: on for n in names})
            scope = Scope()
            for n in start.var_names():
                scope.set_var(n, start.find_var(n).clone())
            exe = Executor()
            ctr.zero()
            runs[key] = se_run(torch, exe, main, scope, loss, feed, grads,
                               SE_STEPS)
            launched, routes = ctr.read(), ctr.routes()
            want = ({k: v * SE_STEPS for k, v in SE_PER_STEP.items()}
                    if on else {"adamw": SE_PER_STEP["adamw"] * SE_STEPS})
            log(f"  {key} routes: launches in {SE_STEPS} steps {launched}")
            ctr.expect(launched, want, f"phase 23 ({key} routes)")
            if exe.captures != 1:
                raise AssertionError(f"phase 23 ({key}): {exe.captures} "
                                     "captures, expected 1 (the second run)")
            if on:
                flash_routes = {n: routes[n] for n in
                                ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
                if any(by["wgmma"] for by in flash_routes.values()):
                    raise AssertionError(f"phase 23: flash launches by route "
                                         f"{flash_routes}, expected simt")
                kernel = (exe, scope, launched, flash_routes)
        k_exe, k_scope, launched, flash_routes = kernel
        worst = {"loss": 0.0, "grad_vs_f64": {}, "param": 0.0}

        def fro(a, n):
            return float(torch.linalg.norm(a.double() - ref[n])
                         / se_grad_scale(torch, ref, n))

        for n, gk, gc in zip(grads, runs["kernel"][0][0][1:],
                             runs["composed"][0][0][1:]):
            rk, rc = fro(gk, n), fro(gc, n)
            if not rk <= max(SE_GRAD_FRO, SE_GRAD_FACTOR * rc):
                raise AssertionError(
                    f"phase 23: {n} at the first step: kernel route "
                    f"{rk:.3e} from the f64 gradient, composed {rc:.3e}")
            if rk > worst["grad_vs_f64"].get("kernel", 0.0):
                worst["grad_vs_f64"] = {"name": n, "kernel": rk,
                                        "composed": rc}
        for i, ((fk, pk), (fc, pc)) in enumerate(zip(runs["kernel"],
                                                     runs["composed"])):
            if not np.isfinite(fk[0]) or abs(fk[0] - fc[0]) > \
                    SE_LOSS_RTOL * abs(fc[0]):
                raise AssertionError(f"phase 23: step {i} loss kernel "
                                     f"{fk[0]!r} vs composed {fc[0]!r}")
            worst["loss"] = max(worst["loss"], abs(fk[0] - fc[0]))
            tol = 2 * (i + 1) * SE_LR + 1e-6
            for n in pk:
                err = float((pk[n] - pc[n]).abs().max())
                if not err <= tol:
                    raise AssertionError(f"phase 23: step {i} {n} kernel vs "
                                         f"composed max abs {err:.3e} > "
                                         f"{tol:.1e}")
                worst["param"] = max(worst["param"], err)
        log(f"  losses kernel {[f[0] for f, _ in runs['kernel']]}, composed "
            f"{[f[0] for f, _ in runs['composed']]}; worst {worst}")
        log(f"  flash launches by route {flash_routes}")
        del runs
        fetch = [loss.name] + grads      # the compared steps' key

        def replay():
            k_exe.run(main, feed=feed, fetch_list=fetch, scope=k_scope,
                      return_numpy=False)

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(SE_TIMED):
            replay()
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / SE_TIMED
        if k_exe.captures != 1:
            raise AssertionError(f"phase 23: {k_exe.captures} captures "
                                 "after the timed steps, expected 1")
        with ctr.aside():
            busy, names_ = device_trace(torch, lambda: [replay()
                                                        for _ in range(2)])
        busy /= 2
        idle = 1.0 - busy / (dt * 1e3)
        log(f"  [{card}] static encoder, kernel routes, replayed: "
            f"{dt * 1e3:.3f} ms per step, device busy {busy:.3f} ms, idle "
            f"share {idle:.4f}, {sum(names_.values()) / 2:.0f} kernels per "
            f"step")
    finally:
        flags.set_flags(saved)
    times = time_flash_bf16(torch, fa, ctr, card, SE_BATCH, SE_HEADS,
                            SE_SEQ, SE_D // SE_HEADS, False, dt="f32")
    for name in ("ln_fwd", "ln_bwd"):
        t = ltimes[name]["transformer-base"]
        log(f"  {name} f32 {t['shape']} (this phase's rows, phase 13): "
            f"kernel {t['ms']:.4f} ms, bound {t['bound_ms']:.4f} ms, plain "
            f"{t['plain_ms']:.4f} ms, library {t['library_ms']:.4f} ms "
            f"[{card}]")
    del k_exe, k_scope, start, exe0
    torch.cuda.empty_cache()
    return {"launches": launched, "routes": flash_routes,
            "per_step": SE_PER_STEP, "step_ms": dt * 1e3,
            "device_busy_ms": busy, "idle_share": idle,
            "kernel_vs_composed": worst, "flash_f32": times}


# ------------------------------------------------------------ phase 24
#: the Book's programs on the card (paddle_tpu_torch/models/book.py, as
#: tests/test_book.py writes them): label_semantic_roles at the upstream
#: chapter's width (test_label_semantic_roles.py: word_dim 32, mark_dim
#: 5, hidden_dim 512, depth 8, BATCH_SIZE 10), resnet_cifar10 at the
#: upstream depth 32 and batch 128 (tests/test_book.py cuts it to 8),
#: rnn_encoder_decoder at the upstream dict_size 30000, the others at
#: tests/test_book.py's own constants
BOOK_SIZES = {
    "fit_a_line": {}, "recognize_digits": {}, "word2vec": {},
    "image_classification": dict(depth=32, batch_size=128),
    "label_semantic_roles": dict(word_dim=32, mark_dim=5, hidden_dim=512,
                                 depth=8, batch_size=10),
    "recommender_system": {},
    "rnn_encoder_decoder": dict(dict_size=30000),
    "machine_translation": {},
}
#: steps per program (the first eager, the second captures, the rest
#: replay and are timed), replays traced for the device's busy time
BOOK_STEPS, BOOK_TRACED = 5, 2
#: phase 22's tolerances, card against the port on the CPU, each step
#: from a copy of the card's state before it: the loss within 1e-5
#: relative, every other fetch exactly (ids, paths, accuracies) or within
#: 1e-5 relative and 1e-6 absolute, and each parameter after the step
#: within 1e-4 relative Frobenius distance or 1e-6 absolute. Under Adam
#: and Adagrad a parameter may instead be within 2 lr + 1e-6 per element
#: (phase 23's bound for a step: an update is near lr x sign(g), so a
#: gradient element whose exact value is zero, such as a convolution bias
#: a batch norm follows, moves by +-lr on rounding alone). From one start
#: carried through all steps instead, such flips change resnet_cifar10's
#: second loss by 1.8e-4 relative (an H100 80GB HBM3 at 700 W). So the
#: optimizers' accumulators and the batch norms' statistics after each
#: step (Adam's moment1 gains (1 - beta1) g from the same start, Adagrad's
#: accumulator g^2: the gradient itself) are held within 1e-2 relative
#: Frobenius distance or 1e-7 absolute: f32 gradients of a batch-norm net
#: are ill-conditioned (the port's resnet_cifar10 on the CPU within
#: 5e-7-8.8e-4 of a float64 run, XLA's within 4e-4-3.5e-3; ROADMAP C)
BOOK_FETCH_RTOL, BOOK_FETCH_ATOL = 1e-5, 1e-6
BOOK_STATE_FRO, BOOK_STATE_ATOL = 1e-2, 1e-7


def book_param_close(what, got, ref, step_bound, fro=WD_FRO, atol=WD_ATOL):
    """Phase 22's test of a parameter (or, with ``fro`` / ``atol``, of
    another state variable); else, under Adam or Adagrad, every element
    within ``step_bound``. Returns (max abs difference, whether the step
    bound was needed)."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    if got.shape != ref.shape or not np.isfinite(got).all():
        raise AssertionError(f"phase 24: {what} card {got.shape} vs CPU "
                             f"{ref.shape}, or not finite")
    err = float(np.abs(got - ref).max()) if got.size else 0.0
    rel = float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30))
    if rel <= fro or err <= atol:
        return err, False
    if step_bound is not None and err <= step_bound:
        return err, True
    raise AssertionError(f"phase 24: {what} card vs CPU: max abs {err:.3e}, "
                         f"relative Frobenius {rel:.3e}")


def book_fetches_close(what, got, ref):
    worst = 0.0
    for i, (g, r) in enumerate(zip(got, ref)):
        g, r = np.asarray(g), np.asarray(r)
        if g.shape != r.shape:
            raise AssertionError(f"phase 24: {what} fetch {i} shape "
                                 f"{g.shape} vs {r.shape}")
        if r.dtype.kind in "biu":
            if not np.array_equal(g, r):
                raise AssertionError(f"phase 24: {what} fetch {i} differs "
                                     f"(ids): {g.ravel()[:8]} vs "
                                     f"{r.ravel()[:8]}")
            continue
        rtol = WD_LOSS_RTOL if i == 0 else BOOK_FETCH_RTOL
        diff = np.abs(g.astype(np.float64) - r)
        if not np.isfinite(g).all() or (diff > BOOK_FETCH_ATOL * (i > 0)
                                        + rtol * np.abs(r)).any():
            raise AssertionError(f"phase 24: {what} fetch {i} card "
                                 f"{g.ravel()[:4]} vs CPU {r.ravel()[:4]}")
        worst = max(worst, float(diff.max()) if diff.size else 0.0)
    return worst


def book_program(torch, ctr, card, b):
    """One program of phase 24: the startup on the card, then
    ``BOOK_STEPS`` steps, each on the card and on the CPU from a copy of
    the card's state before it and the same batch, held to phase 24's
    tolerances; one capture (the second run);
    the replayed steps' time, the device's busy time per replay and its
    idle share, the graph's kernels; then the inference model saved from
    the card's trained scope, loaded into a fresh scope on the card, and
    its fetch against the trained program's test clone."""
    import paddle_tpu_torch
    from paddle_tpu_torch import framework_io, jit
    from paddle_tpu_torch.framework import Scope
    from paddle_tpu_torch.models import book
    from paddle_tpu_torch.models.convert import scope_from_numpy
    fluid = paddle_tpu_torch.fluid
    card_exe = fluid.Executor(fluid.CUDAPlace(0))
    cpu_exe = fluid.Executor(fluid.CPUPlace())
    card_scope = Scope()
    card_exe.run(b.startup, scope=card_scope)
    feeds = book.batches(b, BOOK_STEPS)
    fetch = [v.name for v in b.fetches]
    params = [p.name for p in b.main.all_parameters()]
    bound = (2 * b.lr + 1e-6 if b.optimizer in ("adam", "adagrad")
             else None)
    worst_fetch, worst_param, worst_state, by_bound = 0.0, 0.0, 0.0, set()
    dev, secs, launched = [], [], {}
    for i, f in enumerate(feeds):
        # the CPU takes each step from a copy of the card's state before it
        cpu_scope = scope_from_numpy({n: card_scope.get_numpy(n)
                                      for n in card_scope.var_names()},
                                     "cpu")
        torch.cuda.synchronize()
        before = ctr.read()
        t0 = time.perf_counter()
        dev.append(card_exe.run(b.main, feed=f, fetch_list=fetch,
                                scope=card_scope))
        secs.append(time.perf_counter() - t0)
        for k, v in ctr.read().items():
            if v != before.get(k, 0):
                launched[k] = launched.get(k, 0) + v - before.get(k, 0)
        cpu = cpu_exe.run(b.main, feed=f, fetch_list=fetch, scope=cpu_scope)
        worst_fetch = max(worst_fetch, book_fetches_close(
            f"{b.name} step {i}", dev[-1], cpu))
        for n in params:
            err, stepped = book_param_close(
                f"{b.name} step {i} {n}", card_scope.get_numpy(n),
                cpu_scope.get_numpy(n), bound)
            worst_param = max(worst_param, err)
            if stepped:
                by_bound.add(n)
        for n in sorted(set(cpu_scope.var_names()) - set(params)):
            worst_state = max(worst_state, book_param_close(
                f"{b.name} step {i} {n}", card_scope.get_numpy(n),
                cpu_scope.get_numpy(n), None, BOOK_STATE_FRO,
                BOOK_STATE_ATOL)[0])
    by_bound = sorted(by_bound)
    captures = card_exe._exe.captures
    if captures != 1:
        raise AssertionError(f"phase 24: {b.name}: {captures} captures in "
                             f"{BOOK_STEPS} steps, expected 1 (the second "
                             "run)")
    if b.name == "label_semantic_roles":
        lrs = [float(np.asarray(c[2]).reshape(-1)[0]) for c in dev]
        counter = [n for n in card_scope.var_names()
                   if n.startswith("lr_decay_step")]
        if lrs != [float(np.float32(0.01))] * BOOK_STEPS or \
                float(card_scope.get_numpy(counter[0])[0]) != BOOK_STEPS:
            raise AssertionError(f"phase 24: exponential_decay's lr {lrs}, "
                                 f"counter {card_scope.get_numpy(counter[0])}")
    entry = next(e for e in card_exe._exe._cache.values()
                 if e._refs[0] is b.main and e.graph is not None)
    kernels = entry.graph.kernels()
    step_ms = float(np.mean(secs[2:])) * 1e3
    with ctr.aside():
        busy, _ = device_trace(torch, lambda: [card_exe.run(
            b.main, feed=feeds[-1], fetch_list=fetch, scope=card_scope)
            for _ in range(BOOK_TRACED)])
    busy /= BOOK_TRACED
    if card_exe._exe.captures != 1:
        raise AssertionError(f"phase 24: {b.name}: captures after the "
                             "traced replays")
    # the inference model: saved from the card, loaded on the card
    with tempfile.TemporaryDirectory() as d:
        framework_io.save_inference_model(d, b.infer_feeds, b.infer_targets,
                                          card_exe._exe, b.main,
                                          scope=card_scope)
        fresh = Scope()
        prog, feed_names, fetch_names = framework_io.load_inference_model(
            d, card_exe._exe, scope=fresh)
    if any(t.device.type != "cuda" for t in
           (fresh.find_var(n) for n in fresh.var_names())):
        raise AssertionError(f"phase 24: {b.name}: a loaded variable is "
                             "not on the card")
    last = feeds[-1]
    got = card_exe.run(prog, feed={k: last[k] for k in feed_names},
                       fetch_list=fetch_names, scope=fresh)
    ref = card_exe.run(b.test_program, feed=last, fetch_list=fetch_names,
                       scope=card_scope)
    infer_err = book_fetches_close(f"{b.name} inference model", got, ref)
    res = {"step_ms": step_ms, "device_busy_ms": busy,
           "idle_share": 1.0 - busy / step_ms, "graph_kernels": kernels,
           "captures": captures, "launches": launched,
           "loss_first": float(dev[0][0]), "loss_last": float(dev[-1][0]),
           "card_vs_cpu_max_abs": {"fetch": worst_fetch,
                                   "param": worst_param,
                                   "state": worst_state},
           "params_by_step_bound": by_bound,
           "inference_round_trip_max_abs": infer_err}
    log(f"  [{card}] {b.name}: replayed {step_ms:.3f} ms per step, device "
        f"busy {busy:.3f} ms, idle share {res['idle_share']:.4f}, "
        f"{kernels} graph kernels per step, {captures} capture; losses "
        f"{[round(float(c[0]), 5) for c in dev]}; card vs CPU max abs "
        f"fetch {worst_fetch:.3e} param {worst_param:.3e} state "
        f"{worst_state:.3e}"
        + (f" ({len(by_bound)} parameters within the Adam/Adagrad step "
           f"bound: {by_bound})" if by_bound else "")
        + f"; launches {launched}; inference round trip max abs "
        f"{infer_err:.3e}")
    return res


def book_phase(torch, ctr, card):
    """Phase 24: the eight Book programs of ``tests/test_book.py`` built
    through ``paddle_tpu_torch.fluid`` at ``BOOK_SIZES`` and run by
    ``fluid.Executor(fluid.CUDAPlace(0))``, each held against the same
    Program on ``fluid.CPUPlace()`` (:func:`book_program`), then the CTC
    tagger the same way. Convolutions under ``cudnn.deterministic``. The
    AdamW kernel launches once per ``adam`` op (one per trainable
    parameter) and step in the two programs that minimize with Adam, and
    no other port kernel runs."""
    from paddle_tpu_torch.models import book
    det = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    out, want = {}, {}
    try:
        ctr.zero()
        for name, make in book.PROGRAMS.items():
            b = make(seed=24, **BOOK_SIZES[name])
            out[name] = book_program(torch, ctr, card, b)
            adam_ops = sum(op.type == "adam"
                           for op in b.main.global_block().ops)
            if adam_ops:
                want["adamw"] = want.get("adamw", 0) + BOOK_STEPS * adam_ops
            del b
            torch.cuda.empty_cache()
        launched = ctr.read()
        ctr.expect(launched, want, "phase 24 (the Book)")
        out["ctc_tagger"] = book_program(torch, ctr, card,
                                         book.ctc_tagger(seed=24))
        ctr.expect(ctr.read(), want, "phase 24 (the CTC tagger runs no "
                   "port kernel)")
    finally:
        torch.backends.cudnn.deterministic, \
            torch.backends.cudnn.benchmark = det
    out["launches"] = launched
    return out



# ------------------------------------------------------------ phase 25
#: (a): the card against the port on the CPU on the cases of
#: tests/torch_op_cases.py (the dense half of the op library and the
#: control-flow ops, the OP_CASES that tests/test_torch_static.py holds
#: against the JAX package): integers and booleans exactly, NaN and inf
#: where the CPU has them, floats within ``1e-5 + 1e-4 |cpu|`` (other
#: kernels, other orders of summation, transcendental routines a few
#: ulps apart)
CF_SWEEP_TOL = (1e-5, 1e-4)
#: (b): the warm-up's length W and the steps (3 warm-up, 3 decay)
CF_WARMUP, CF_STEPS, CF_TIMED = 3, 6, 5
#: (c): the forward loop's fed trip counts; the trained loop's bound and
#: its trip count per step
CF_TRIPS, CF_MAX_ITERS, CF_TRAIN_TRIPS = (6, 3, 6), 6, (6, 6, 6, 4)
#: (c): launches of one live iteration of the trained loop: the forward
#: (flash_fwd, 2 ln_fwd), the grad's recompute of it, and the VJP's
#: forward under autograd and backward; one AdamW launch per parameter
#: (16) per step
CF_PER_ITER = {"flash_fwd": 3, "flash_bwd_dq": 1, "flash_bwd_dkv": 1,
               "ln_fwd": 6, "ln_bwd": 2}
CF_PARAMS = 16
#: cond_set launches per replay: 2 IF nodes for the warm-up's case; the
#: trained loop's max_iters IF nodes forward, and again in its grad's
#: recompute and reverse
CF_SET_WARMUP, CF_SET_LOOP = 2, 3 * CF_MAX_ITERS


def _op_cases():
    """tests/torch_op_cases.py, which imports numpy only."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "torch_op_cases", os.path.join(ROOT, "tests", "torch_op_cases.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _case_fn(torch, reg, op_type, ins, attrs, cots, key, dev, eager):
    """A function running one op's lowering on ``ins`` and then the grad
    ops its ``make_grad_ops`` gives, fed ``cots``: ``(outs, grads)``."""
    import types as _t

    def fn():
        ctx = reg.LoweringContext(rng=key, device=dev, eager=eager)
        outs = reg.execute(ctx, op_type, ins, dict(attrs))
        d = reg.get_op_def(op_type)
        if cots is None or d.not_differentiable:
            return outs, {}
        names = {s: [f"{s}:{i}" for i in range(len(v))]
                 for s, v in list(ins.items()) + list(outs.items())}
        fw = _t.SimpleNamespace(
            type=op_type, attrs=dict(attrs),
            inputs={s: names[s] for s in ins},
            outputs={s: names[s] for s in outs})
        out_g = {s: [f"{s}:{i}@G" if v.is_floating_point()
                     and s not in d.nondiff_outputs else None
                     for i, v in enumerate(vals)]
                 for s, vals in outs.items()}
        wanted = {s: [f"{s}:{i}@IG" if v.is_floating_point() else None
                      for i, v in enumerate(vals)]
                  for s, vals in ins.items()}
        env = {f"{s}:{i}": v for s, vals in list(ins.items())
               + list(outs.items()) for i, v in enumerate(vals)}
        env.update(cots)
        grads = {}
        for g_type, g_in, g_out, g_attrs in reg.make_grad_ops(fw, out_g,
                                                              wanted):
            res = reg.execute(ctx, g_type, {s: [env[n] for n in ns]
                                            for s, ns in g_in.items()},
                              g_attrs)
            for s, ns in g_out.items():
                for n, v in zip(ns, res[s]):
                    grads[n] = v
        return outs, grads
    return fn


def _cf_err(a, b, what, tol=CF_SWEEP_TOL):
    """Max abs difference of ``a`` (card) and ``b`` (the CPU) over the
    finite elements; raises unless within ``tol`` (integers, booleans,
    NaN and inf exactly)."""
    a, b = a.detach().cpu(), b.detach().cpu()
    if a.is_floating_point():
        a, b = a.double(), b.double()
    a, b = a.numpy(), b.numpy()
    if a.shape != b.shape:
        raise AssertionError(f"phase 25: {what}: shape {a.shape} vs the "
                             f"CPU's {b.shape}")
    if b.dtype.kind in "biu":
        if not np.array_equal(a, b):
            raise AssertionError(f"phase 25: {what}: {a} vs the CPU's {b}")
        return 0.0
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    fin = np.isfinite(b64)
    if not np.array_equal(np.isnan(a64), np.isnan(b64)) or not \
            np.array_equal(a64[np.isinf(b64)], b64[np.isinf(b64)]):
        raise AssertionError(f"phase 25: {what}: NaN / inf at other places "
                             "than the CPU's")
    if not fin.any():
        return 0.0
    err = np.abs(a64[fin] - b64[fin])
    if not (err <= tol[0] + tol[1] * np.abs(b64[fin])).all():
        raise AssertionError(f"phase 25: {what}: max abs err "
                             f"{float(err.max()):.3e} against the CPU")
    return float(err.max())


def _cf_programs(L):
    """The control-flow ops' programs for the sweep (tests/
    test_torch_control_flow.py's, the port's builders): ``[(name, build,
    feeds)]``, ``build()`` giving the fetch names inside a guard."""
    def cond_prog():
        x = L.data("x", shape=[3], dtype="float32")
        p = L.data("p", shape=[1], dtype="bool", append_batch_size=False)
        return [L.cond(p, lambda: L.scale(x, scale=2.0),
                       lambda: L.scale(x, scale=-1.0)).name]

    def switch_prog():
        idx = L.data("idx", shape=[1], dtype="int32",
                     append_batch_size=False)
        x = L.data("x", shape=[2], dtype="float32")
        return [L.switch_case(idx, [lambda: L.scale(x, scale=1.0),
                                    lambda: L.scale(x, scale=10.0)],
                              default=lambda: L.scale(x, 100.0)).name]

    def grad_prog():
        blk = L.data("p", shape=[1], dtype="bool",
                     append_batch_size=False).block
        w = blk.create_parameter("w", shape=[4])
        p = blk.var("p")
        i = L.fill_constant([1], "int64", 0)
        three = L.fill_constant([1], "int64", 3)
        y = L.cond(p, lambda: L.scale(w, scale=2.0), lambda: L.square(w))
        _, y = L.while_loop(lambda i, h: L.less_than(i, three),
                            lambda i, h: (L.increment(i, 1.0),
                                          L.scale(h, scale=1.5)),
                            [i, y], max_iters=5)
        loss = L.reduce_sum(y)
        from paddle_tpu_torch.framework import append_backward
        g = dict((a.name, b.name) for a, b in append_backward(loss))["w"]
        return [loss.name, g]

    def loop_prog():
        step = L.data("step", shape=[1], dtype="float32",
                      append_batch_size=False)
        n = L.data("n", shape=[1], dtype="int64", append_batch_size=False)
        i = L.fill_constant([1], "int64", 0)
        acc = L.fill_constant([1], "float32", 0.0)
        _, acc = L.while_loop(lambda i, a: L.less_than(i, n),
                              lambda i, a: (L.increment(i, 1.0),
                                            L.elementwise_add(a, step)),
                              [i, acc])
        return [acc.name]

    def py_func_prog():
        x = L.data("x", shape=[3], dtype="float32")
        out = x.block.create_var("host_out", shape=[-1, 3])
        out.dtype = "float32"
        L.py_func(lambda a: a * 3.0 + 1.0, x, out)
        return [L.scale(out, scale=2.0).name]

    x3 = np.array([[1.0, -2.0, 3.0]], np.float32)
    x2 = np.array([[1.0, 2.0]], np.float32)
    return [
        ("cond", cond_prog, [{"x": x3, "p": np.array([v])}
                             for v in (True, False, True, False)]),
        ("switch_case", switch_prog, [{"idx": np.array([v], np.int32),
                                       "x": x2} for v in (0, 1, 7, -1)]),
        ("cond + bounded while, grads", grad_prog,
         [{"p": np.array([v])} for v in (True, False, True)]),
        ("dynamic while", loop_prog,
         [{"step": np.array([2.5], np.float32), "n": np.array([v])}
          for v in (4, 0, 2)]),
        ("py_func", py_func_prog, [{"x": x3 * v} for v in (1.0, -1.0, 2.0)])]


def op_sweep(torch, ctr):
    """Phase 25 (a): every case of tests/torch_op_cases.py on the card
    against the port on the CPU, forward and grad: eagerly, then
    captured and replayed once (a case the reference runs only eagerly,
    eagerly); the cases that raise, raising on the card too; then the
    control-flow ops' programs through the executor on the card (eager,
    capture, replays) against the CPU. Returns the counts and the
    largest error per family (the lowering's module)."""
    import zlib

    from paddle_tpu_torch import jit, prng
    from paddle_tpu_torch.framework import (Executor, Program, Scope,
                                            program_guard, unique_name)
    from paddle_tpu_torch.ops import registry as reg
    import paddle_tpu_torch.layers as L
    cases = _op_cases()
    dev = torch.device("cuda")
    pool = torch.cuda.graph_pool_handle()
    worst, n = {}, {"eager": 0, "captured": 0, "raised": 0, "programs": 0}

    def note(fam, err):
        worst[fam] = max(worst.get(fam, 0.0), err)

    for cid in sorted(cases.DENSE_CASES):
        op_type, make, attrs, _ = cases.DENSE_CASES[cid]
        ins_np = make(np.random.RandomState(zlib.crc32(cid.encode())))
        fam = reg.get_op_def(op_type).lowering.__module__.rsplit(".", 1)[1]

        def tensors(d):
            return {s: [torch.as_tensor(np.asarray(a)).to(d) for a in v]
                    for s, v in ins_np.items()}

        if cid in cases._RAISES:
            fn = _case_fn(torch, reg, op_type, tensors(dev), attrs, None,
                          prng.PRNGKey(5, device=dev), dev, False)
            try:
                fn()
            except cases._RAISES[cid]:
                n["raised"] += 1
                continue
            raise AssertionError(f"phase 25: {cid} did not raise on the card")
        eager = cid in cases._EAGER
        cpu = torch.device("cpu")
        outs, _ = _case_fn(torch, reg, op_type, tensors(cpu), attrs, None,
                           prng.PRNGKey(5), cpu, eager)()
        crng = np.random.RandomState(7)
        cots = None if cid in cases._NO_GRAD else {
            f"{s}:{i}@G": torch.as_tensor(crng.randn(*v.shape)).to(v.dtype)
            for s, vals in outs.items() for i, v in enumerate(vals)
            if v.is_floating_point()}
        ref = _case_fn(torch, reg, op_type, tensors(cpu), attrs, cots,
                       prng.PRNGKey(5), cpu, eager)()
        fn = _case_fn(torch, reg, op_type, tensors(dev), attrs,
                      None if cots is None else
                      {k: v.to(dev) for k, v in cots.items()},
                      prng.PRNGKey(5, device=dev), dev, eager)
        runs = [fn()]
        n["eager"] += 1
        if not eager:
            jit.warm_up(dev, fn)
            graph, got, _ = jit.capture(dev, fn, [], pool)
            graph.replay()
            torch.cuda.synchronize()
            runs.append(got)
            n["captured"] += 1
        for k, (o, g) in enumerate(runs):
            what = f"{cid} ({'eager' if k == 0 else 'captured'})"
            for s, vals in ref[0].items():
                for a, b in zip(o[s], vals):
                    if s == "XShape":
                        if tuple(a.shape) != tuple(b.shape):
                            raise AssertionError(f"phase 25: {what} XShape")
                        continue
                    note(fam, _cf_err(a, b, f"{what} {s}"))
            if set(g) != set(ref[1]):
                raise AssertionError(f"phase 25: {what}: grads {sorted(g)} "
                                     f"vs the CPU's {sorted(ref[1])}")
            for name, b in ref[1].items():
                note(fam, _cf_err(g[name], b, f"{what} {name}"))
    for name, build, feeds in _cf_programs(L):
        out = {}
        for place in ("cpu", "cuda"):
            prog, start = Program(), Program()
            with program_guard(prog, start), unique_name.guard():
                fetch = build()
            scope, exe = Scope(), Executor(place)
            exe.run(start, scope=scope)
            if scope.find_var("w") is None and "w" in \
                    prog.global_block().vars:
                scope.set_var("w", torch.tensor([1.0, -2.0, 0.5, 3.0],
                                                device=place))
            out[place] = [exe.run(prog, feed=f, fetch_list=fetch,
                                  scope=scope, return_numpy=False)
                          for f in feeds]
            if place == "cuda" and exe.captures != 1:
                raise AssertionError(f"phase 25: {name}: {exe.captures} "
                                     "captures, expected 1")
        for got, want in zip(out["cuda"], out["cpu"]):
            for a, b in zip(got, want):
                note("control_flow_ops", _cf_err(a, b, name))
        n["programs"] += 1
    return n, worst


def cond_set_kernel(torch, cg, card):
    """The IF node's condition kernel held against its plain version
    (the host's reading of the predicate) and timed: a graph of 64 IF
    nodes, each around one small add, against the same adds without IF
    nodes (CUDA events over 50 replays each), per node; the host read
    per selection."""
    from paddle_tpu_torch import jit
    dev = torch.device("cuda")
    pred = torch.zeros((), dtype=torch.bool, device=dev)
    out = torch.zeros(1, device=dev)
    pool = torch.cuda.graph_pool_handle()

    def two_branch():
        with cg.if_body(pred):
            out.fill_(1.0)
        with cg.if_body(pred, negate=True):
            out.fill_(2.0)

    jit.warm_up(dev, lambda: out.fill_(0.0))
    g, _, _ = jit.capture(dev, two_branch, [], pool)
    err = 0.0
    for v in np.random.RandomState(25).rand(16) > 0.5:
        pred.fill_(bool(v))
        g.replay()
        plain = 1.0 if cg.plain_select(pred) else 2.0
        err = max(err, abs(float(out) - plain))
    small = torch.zeros(8, device=dev)

    def ifs():
        for _ in range(64):
            with cg.if_body(pred):
                small.add_(1.0)

    def adds():
        for _ in range(64):
            small.add_(1.0)

    g_if, _, _ = jit.capture(dev, ifs, [], pool)
    g_add, _, _ = jit.capture(dev, adds, [], pool)
    pred.fill_(True)
    t_if = event_ms(torch, lambda: [g_if.replay() for _ in range(50)]) / 50
    t_add = event_ms(torch, lambda: [g_add.replay() for _ in range(50)]) / 50
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        cg.plain_select(pred)
    plain_ms = (time.perf_counter() - t0) / 200 * 1e3
    ms = max(t_if - t_add, 0.0) / 64
    bound = 1 / HBM_BYTES_PER_S * 1e3        # one byte read
    log(f"  [{card}] cond_set: {ms:.5f} ms per IF node (64 taken IF nodes "
        f"{t_if:.4f} ms, the same adds bare {t_add:.4f} ms per replay); "
        f"plain (a host read of the predicate) {plain_ms:.5f} ms; bound "
        f"{bound:.2e} ms (1 byte); 16 selections equal to plain")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": "bytes", "library_ms": None, "max_abs_err": err,
            "graph_64_if_ms": t_if, "graph_64_adds_ms": t_add}


def _same_bits(a, b):
    """Equal bit for bit (shape, dtype and every value)."""
    import torch
    return a.dtype == b.dtype and bool(torch.equal(a, b))


def warmup_encoder(torch, ctr, cg, card, sen):
    """Phase 25 (b): phase 23's encoder (kernel routes) with its lr built
    in the Program: Transformer-base's warm-up (``NoamLR``: a step
    counter and ``layers.case``, W = CF_WARMUP), CF_STEPS steps taking
    both branches: one capture (at step 2), SE_PER_STEP launches per
    step and CF_SET_WARMUP cond_set per replay, each step's lr within 1
    float32 ulp of the closed form; a straight-line twin fed that lr per
    step from the same state: losses and every variable bit for bit;
    then timed replays."""
    from paddle_tpu_torch import flags
    from paddle_tpu_torch.framework import Executor, Scope
    from paddle_tpu_torch.models import static_encoder as se
    names = ("use_pallas_attention", "use_pallas_layer_norm")
    saved = flags.get_flags(list(names))
    flags.set_flags({n: True for n in names})
    try:
        sched, fed = se.NoamLR(CF_WARMUP), se.FedLR()
        main, startup, loss = se.build_encoder_program(
            SE_LAYERS, SE_D, SE_HEADS, SE_FFN, SE_SEQ, lr=sched)
        tmain, tstart, tloss = se.build_encoder_program(
            SE_LAYERS, SE_D, SE_HEADS, SE_FFN, SE_SEQ, lr=fed)
        scope, tscope = Scope(), Scope()
        Executor().run(startup, scope=scope)
        Executor().run(tstart, scope=tscope)
        shared = [n for n in tscope.var_names() if scope.find_var(n)
                  is not None]
        for n in shared:
            tscope.set_var(n, scope.find_var(n).clone())
        x = np.random.RandomState(25).randn(SE_BATCH, SE_SEQ, SE_D) \
            .astype(np.float32)
        exe, texe = Executor(), Executor()
        ctr.zero()
        set0 = cg.launches
        lrs, losses, caps = [], [], []
        for _ in range(CF_STEPS):
            f = exe.run(main, feed={"x": x},
                        fetch_list=[loss.name, sched.var.name], scope=scope,
                        return_numpy=False)
            losses.append(f[0].clone())
            lrs.append(np.float32(f[1].reshape(-1)[0].item()))
            caps.append(exe.captures)
        torch.cuda.synchronize()
        launched, routes = ctr.read(), ctr.routes()
        sets = cg.launches - set0
        ctr.expect(launched, {k: v * CF_STEPS for k, v in
                              SE_PER_STEP.items()}, "phase 25 (b)")
        if caps != [0] + [1] * (CF_STEPS - 1):
            raise AssertionError(f"phase 25 (b): captures after each step "
                                 f"{caps}, expected one at step 2")
        if sets != CF_SET_WARMUP * (CF_STEPS - 1):
            raise AssertionError(f"phase 25 (b): {sets} cond_set launches, "
                                 f"expected {CF_SET_WARMUP} per replay")
        ulps = []
        for step, lr in enumerate(lrs, 1):
            want = np.float32(sched.closed_form(step, SE_D))
            ulps.append(float(abs(lr - want) / np.spacing(want)))
            if ulps[-1] > 1:
                raise AssertionError(f"phase 25 (b): step {step} lr {lr!r} "
                                     f"vs the closed form {want!r}")
        with ctr.aside():
            for step, lr in enumerate(lrs):
                (tl,) = texe.run(tmain, feed={"x": x, "lr": np.array(
                    [lr], np.float32)}, fetch_list=[tloss.name],
                    scope=tscope, return_numpy=False)
                if not _same_bits(tl, losses[step]):
                    raise AssertionError(
                        f"phase 25 (b): step {step + 1} loss "
                        f"{float(losses[step])!r} vs the fed-lr twin's "
                        f"{float(tl)!r}")
        diff = [n for n in shared if not _same_bits(scope.find_var(n),
                                                    tscope.find_var(n))]
        if diff:
            raise AssertionError(f"phase 25 (b): {len(diff)} variables "
                                 f"differ from the twin's, e.g. {diff[:3]}")
        if texe.captures != 1:
            raise AssertionError("phase 25 (b): the twin did not capture once")

        def replay():
            exe.run(main, feed={"x": x}, fetch_list=[loss.name,
                                                     sched.var.name],
                    scope=scope, return_numpy=False)

        with ctr.aside():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(CF_TIMED):
                replay()
            torch.cuda.synchronize()
            dt = (time.perf_counter() - t0) / CF_TIMED
            busy, _ = device_trace(torch, lambda: [replay()
                                                   for _ in range(2)])
        busy /= 2
        if exe.captures != 1:
            raise AssertionError("phase 25 (b): captures after the timed "
                                 "replays")
        entry = next(e for e in exe._cache.values() if e.graph is not None
                     and e._refs[0] is main)
        log(f"  (b) lr per step {[float(v) for v in lrs]} (within "
            f"{max(ulps):.0f} ulp of the closed form), losses "
            f"{[float(v) for v in losses]}, bit-equal to the fed-lr twin "
            f"(losses and {len(shared)} variables)")
        log(f"  (b) [{card}] replayed step {dt * 1e3:.3f} ms (phase 23 "
            f"{sen['step_ms']:.3f} ms), device busy {busy:.3f} ms, idle "
            f"share {1 - busy / (dt * 1e3):.4f}; IF bodies' kernel nodes "
            f"{[b.kernels for b in entry.graph.bodies]}")
    finally:
        flags.set_flags(saved)
    return {"launches": launched, "routes": routes, "cond_set": sets,
            "lr": [float(v) for v in lrs], "lr_ulps": max(ulps),
            "step_ms": dt * 1e3, "phase23_step_ms": sen["step_ms"],
            "device_busy_ms": busy, "idle_share": 1 - busy / (dt * 1e3),
            "body_kernels": [b.kernels for b in entry.graph.bodies]}


def loop_encoder(torch, ctr, cg, card):
    """Phase 25 (c): one encoder layer of (b)'s widths, its weights
    shared, under ``while_loop``: forward at fed trip counts CF_TRIPS
    (the key split at the loop: the body a graph of its own replayed
    while the host reads the condition, trip + 1 reads per run), each
    output bit-equal to the unrolled twin of that depth; then with
    ``max_iters`` (CF_MAX_ITERS IF nodes on the live flag, forward and in
    the grad) trained at trip counts CF_TRAIN_TRIPS, one capture, against
    the unrolled twins trained from the same state."""
    from paddle_tpu_torch import flags, jit
    from paddle_tpu_torch.framework import Executor, Scope
    from paddle_tpu_torch.models import static_encoder as se
    names = ("use_pallas_attention", "use_pallas_layer_norm")
    saved = flags.get_flags(list(names))
    flags.set_flags({n: True for n in names})
    kw = dict(d_model=SE_D, num_heads=SE_HEADS, d_ffn=SE_FFN, seq=SE_SEQ)
    x = np.random.RandomState(26).randn(SE_BATCH, SE_SEQ, SE_D) \
        .astype(np.float32)
    res = {}
    try:
        main, startup, out, _ = se.build_loop_program(**kw)
        scope, exe = Scope(), Executor()
        exe.run(startup, scope=scope)
        twins = {}
        fwd = []
        for t in CF_TRIPS:
            ctr.zero()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            f = exe.run(main, feed={"x": x, "n": np.array([t], np.int64)},
                        fetch_list=[out.name], scope=scope,
                        return_numpy=False)[0]
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            launched = ctr.read()
            ctr.expect(launched, {"flash_fwd": t, "ln_fwd": 2 * t},
                       f"phase 25 (c) forward, trip count {t}")
            if exe.host_syncs != t + 1:
                raise AssertionError(f"phase 25 (c): {exe.host_syncs} host "
                                     f"reads at trip count {t}, expected "
                                     f"{t + 1}")
            with ctr.aside():
                if t not in twins:
                    twins[t] = se.build_unrolled_program(t, **kw) + (
                        Executor(),)
                um, _, uout, _, uexe = twins[t]
                u = uexe.run(um, feed={"x": x}, fetch_list=[uout.name],
                             scope=scope, return_numpy=False)[0]
            if not _same_bits(f, u):
                raise AssertionError(f"phase 25 (c): trip count {t}: the "
                                     "loop's output differs from the "
                                     "unrolled twin's")
            fwd.append({"trip": t, "host_reads": exe.host_syncs,
                        "launches": launched, "ms": ms})
        if exe.captures != 1:
            raise AssertionError(f"phase 25 (c): {exe.captures} captures "
                                 "of the forward loop, expected 1")
        entry = next(e for e in exe._cache.values() if e.graph is not None)
        body = next(p[4].state[3] for p in entry.graph.pieces
                    if p[0] == "host")
        res["forward"] = {"runs": fwd, "graphs": exe.graphs,
                          "body_graph_kernels": jit.graph_kernels(body[0])}
        log(f"  (c) forward at trip counts {CF_TRIPS}: bit-equal to the "
            f"unrolled twins; host reads {[r['host_reads'] for r in fwd]}; "
            f"[{card}] ms per run (host clock; eager, capture, replay) "
            f"{[round(r['ms'], 3) for r in fwd]}; "
            f"{exe.graphs} graphs (the pieces and the body, "
            f"{res['forward']['body_graph_kernels']} kernel nodes)")
        del main, scope, exe, twins

        main, startup, _, loss = se.build_loop_program(
            **kw, max_iters=CF_MAX_ITERS, lr=SE_LR)
        scope, exe = Scope(), Executor()
        exe.run(startup, scope=scope)
        tw = {d: se.build_unrolled_program(d, **kw, train=True, lr=SE_LR)
              for d in sorted(set(CF_TRAIN_TRIPS))}
        tscope = Scope()
        Executor().run(tw[CF_MAX_ITERS][1], scope=tscope)
        shared = [n for n in tscope.var_names() if scope.find_var(n)
                  is not None]
        for n in shared:
            tscope.set_var(n, scope.find_var(n).clone())
        texe = {d: Executor() for d in tw}
        bit_equal, worst = True, {"loss": 0.0, "param": 0.0}
        steps, set0 = [], cg.launches
        for k, t in enumerate(CF_TRAIN_TRIPS, 1):
            ctr.zero()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            (lv,) = exe.run(main, feed={"x": x, "n": np.array([t], np.int64)},
                            fetch_list=[loss.name], scope=scope,
                            return_numpy=False)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            launched, routes = ctr.read(), ctr.routes()
            want = {n_: v * t for n_, v in CF_PER_ITER.items()}
            want["adamw"] = CF_PARAMS
            ctr.expect(launched, want, f"phase 25 (c) step {k}")
            with ctr.aside():
                um, _, _, uloss = tw[t]
                (lu,) = texe[t].run(um, feed={"x": x},
                                    fetch_list=[uloss.name], scope=tscope,
                                    return_numpy=False)
            if not _same_bits(lv, lu):
                bit_equal = False
            d = abs(float(lv) - float(lu))
            worst["loss"] = max(worst["loss"], d)
            if not d <= SE_LOSS_RTOL * abs(float(lu)):
                raise AssertionError(f"phase 25 (c) step {k}: loss "
                                     f"{float(lv)!r} vs the twin's "
                                     f"{float(lu)!r}")
            tol = 2 * k * SE_LR + 1e-6
            for n_ in shared:
                a, b = scope.find_var(n_), tscope.find_var(n_)
                if not _same_bits(a, b):
                    bit_equal = False
                    err = float((a.double() - b.double()).abs().max())
                    worst["param"] = max(worst["param"], err)
                    if not err <= tol:
                        raise AssertionError(f"phase 25 (c) step {k}: {n_} "
                                             f"max abs {err:.3e} > {tol:.1e}")
            steps.append({"trip": t, "loss": float(lv), "ms": ms,
                          "launches": launched,
                          "routes": {n_: routes[n_] for n_ in
                                     ("flash_fwd", "flash_bwd_dq",
                                      "flash_bwd_dkv")}})
        sets = cg.launches - set0
        if exe.captures != 1:
            raise AssertionError(f"phase 25 (c): {exe.captures} captures of "
                                 "the trained loop, expected 1")
        if sets != CF_SET_LOOP * (len(CF_TRAIN_TRIPS) - 1):
            raise AssertionError(f"phase 25 (c): {sets} cond_set launches, "
                                 f"expected {CF_SET_LOOP} per replay")
        entry = next(e for e in exe._cache.values() if e.graph is not None)
        bodies = entry.graph.bodies
        inside = {}
        for b in bodies:
            for (mod, kern, route), v in b.delta.items():
                if route is None:
                    inside[kern or mod] = inside.get(kern or mod, 0) + v
        res["train"] = {"steps": steps, "cond_set": sets,
                        "bit_equal_to_twin": bit_equal, "worst": worst,
                        "if_bodies": len(bodies),
                        "body_kernels": [b.kernels for b in bodies],
                        "launches_inside_if_bodies_per_live_run": inside}
        if not all(inside.get(n_) for n_ in ("flash_fwd", "ln_fwd",
                                              "flash_bwd_dq", "ln_bwd")):
            raise AssertionError(f"phase 25 (c): kernels inside the IF "
                                 f"bodies {inside}")
        log(f"  (c) [{card}] trained at trip counts {CF_TRAIN_TRIPS}: ms per "
            f"step (host clock; eager, capture, replays) "
            f"{[round(s['ms'], 3) for s in steps]}; losses "
            f"{[s['loss'] for s in steps]}; "
            + ("bit-equal to the unrolled twins" if bit_equal else
               f"within phase 23's tolerances of the unrolled twins (worst "
               f"{worst}): the grad sums the shared weights' gradients "
               f"iteration by iteration, the twin's backward in its own "
               f"order"))
        log(f"  (c) flash launches by route per step "
            f"{[s['routes'] for s in steps]}; {len(bodies)} IF bodies, "
            f"kernel nodes {[b.kernels for b in bodies]}; counted launches "
            f"inside the IF bodies (per run of each) {inside}")
    finally:
        flags.set_flags(saved)
    return res


def control_flow_phase(torch, ctr, card, sen):
    """Phase 25: (a) the sweep, the cond_set kernel, (b) the warm-up
    encoder, (c) the shared-layer loop."""
    from paddle_tpu_torch.ops.cuda import cond_graph as cg
    api = hasattr(torch.cuda.CUDAGraph, "begin_capture_to_if_node")
    log(f"  torch {torch.__version__}: begin_capture_to_if_node "
        f"{'present' if api else 'absent'}; the IF nodes are made through "
        f"the CUDA runtime (csrc/cond_graph.cu) either way")
    with ctr.aside():
        counts, worst = op_sweep(torch, ctr)
    log(f"  (a) {counts['eager']} cases on the card against the CPU "
        f"eagerly, {counts['captured']} of them captured and replayed, "
        f"{counts['raised']} raising as the reference's do, "
        f"{counts['programs']} control-flow programs through the executor; "
        f"largest error per family {worst}")
    with ctr.aside():
        kern = cond_set_kernel(torch, cg, card)
    set0 = cg.launches
    warm = warmup_encoder(torch, ctr, cg, card, sen)
    torch.cuda.empty_cache()
    loop = loop_encoder(torch, ctr, cg, card)
    torch.cuda.empty_cache()
    launches = {}
    for r in [warm["launches"]] + [s["launches"]
                                   for s in loop["train"]["steps"]] + \
            [r["launches"] for r in loop["forward"]["runs"]]:
        for k, v in r.items():
            launches[k] = launches.get(k, 0) + v
    launches["cond_set"] = cg.launches - set0
    for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "ln_fwd",
              "ln_bwd", "adamw", "cond_set"):
        if not launches.get(k):
            raise AssertionError(f"phase 25: {k} never launched")
    return {"sweep": {"counts": counts, "worst": worst}, "cond_set": kern,
            "warmup": warm, "loop": loop, "launches": launches}

# ------------------------------------------------------------ phase 26
#: (a): the card against the port on the CPU on the cases of
#: tests/torch_op_cases_tail.py (the image, detection and quantization
#: half of the op library), phase 25's tolerance
#: (b): configs/yolov3_darknet.yml: batch 8 at 608 x 608, 80 classes,
#: DarkNet-53's three feature maps fed, 50 ground-truth slots
YOLO_BATCH, YOLO_IMAGE, YOLO_CLASSES, YOLO_GT = 8, 608, 80, 50
#: (c): configs/faster_rcnn_r50_1x.yml: batch 2, the C4 feature of an
#: 800 x 1344 padded image at stride 16, 81 classes; 8 ground-truth
#: boxes per image (synthetic)
RPN_BATCH, RPN_C, RPN_H, RPN_W, RPN_GT = 2, 1024, 50, 84, 8
#: (d): the Book's resnet_cifar10 at phase 24's size under quant_aware
QAT_DEPTH, QAT_BATCH = 32, 128
#: steps of (b), (c) and (d): the first eager, the second captures, the
#: third replays
DET_STEPS = 3
#: (b) and (c) train in float64 (scope and feeds upcast, as
#: tests/test_torch_detection.py runs them): (c)'s proposals sort 63,000
#: scores per image and sample with numpy's RandomState, (b)'s loss
#: thresholds IoUs, so a float32 rounding difference between the card
#: and the CPU can change which boxes a step takes. Held per step, the
#: CPU from a copy of the card's state: losses within 1e-9 relative, or
#: 1e-9 absolute for (c)'s terms of order 1 (its RoI mean sums 2e8
#: values, which two summation orders leave 2.6e-10 apart), feat@GRAD and
#: every variable after the step within 1e-9 relative Frobenius distance,
#: RoIs within 1e-3 absolute (float32 outputs of the host ops from
#: float64 inputs 1e-16 apart), counts exactly
DET_LOSS_RTOL, DET_LOSS_ATOL, DET_FRO = 1e-9, 1e-9, 1e-9
#: (c)'s feat@GRAD is small (its RoI-mean term spreads 1 over 2e8 pooled
#: values): within DET_FRO, or every element within 1e-12 absolute (it
#: came 4.7e-13 apart at a relative distance above 1e-9: float64
#: contractions of 1e4 terms summed in other orders)
DET_GRAD_ATOL = 1e-12


def _tail_cases():
    """tests/torch_op_cases_tail.py, which imports numpy only."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "torch_op_cases_tail",
        os.path.join(ROOT, "tests", "torch_op_cases_tail.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def tail_sweep(torch):
    """Phase 26 (a): every case of tests/torch_op_cases_tail.py on the
    card against the port on the CPU, forward and grad, eagerly and
    then captured and replayed once; a host op's case eagerly and then
    as a one-op Program through the executor on the card (three runs:
    eager, the capture that splits at it, a replay), its host reads
    counted. Every case runs; the failures are raised together. Returns
    the counts and the largest error per family."""
    from paddle_tpu_torch import jit, prng
    from paddle_tpu_torch.framework import Executor, Program, Scope
    from paddle_tpu_torch.ops import registry as reg
    cases = _tail_cases()
    dev, cpu = torch.device("cuda"), torch.device("cpu")
    pool = torch.cuda.graph_pool_handle()
    worst, failed = {}, {}
    n = {"cases": 0, "captured": 0, "host_op_programs": 0, "host_syncs": 0}
    for cid in sorted(cases.TAIL_CASES):
        try:
            _tail_case(torch, jit, prng, Executor, Program, Scope, reg, cases,
                       cid, dev, cpu, pool, worst, n)
        except Exception as e:  # every case runs; all failures are raised
            failed[cid] = f"{type(e).__name__}: {str(e)[:300]}"
            torch.cuda.synchronize()
    if failed:
        raise AssertionError(f"phase 26 (a): {len(failed)} cases failed: "
                             f"{failed}")
    return n, worst


def _tail_case(torch, jit, prng, Executor, Program, Scope, reg, cases, cid,
               dev, cpu, pool, worst, n):
    """One case of :func:`tail_sweep`."""
    import zlib
    op_type, make, attrs, _ = cases.TAIL_CASES[cid]
    ins_np = make(np.random.RandomState(zlib.crc32(cid.encode())))
    d = reg.get_op_def(op_type)
    fam = d.lowering.__module__.rsplit(".", 1)[1]

    def tensors(where):
        return {s: [torch.as_tensor(np.asarray(a)).to(where) for a in v]
                for s, v in ins_np.items()}

    outs, _ = _case_fn(torch, reg, op_type, tensors(cpu), attrs, None,
                       prng.PRNGKey(5), cpu, False)()
    crng = np.random.RandomState(7)
    cots = {f"{s}:{i}@G": torch.as_tensor(crng.randn(*v.shape)).to(
        v.dtype) for s, vals in outs.items() for i, v in enumerate(vals)
        if v.is_floating_point()}
    ref = _case_fn(torch, reg, op_type, tensors(cpu), attrs, cots,
                   prng.PRNGKey(5), cpu, False)()
    fn = _case_fn(torch, reg, op_type, tensors(dev), attrs,
                  {k: v.to(dev) for k, v in cots.items()},
                  prng.PRNGKey(5, device=dev), dev, False)
    runs = [("eager", fn())]
    if d.host_op:
        prog = Program()
        blk = prog.global_block()
        for s, vals in ins_np.items():
            for i in range(len(vals)):
                blk.create_var(f"{s}{i}", is_data=True)
        fetch = [f"o_{s}{i}" for s, vals in outs.items()
                 for i in range(len(vals))]
        for name in fetch:
            blk.create_var(name)
        blk.append_op(op_type, {s: [f"{s}{i}" for i in range(len(v))]
                                for s, v in ins_np.items()},
                      {s: [f"o_{s}{i}" for i in range(len(v))]
                       for s, v in outs.items()}, dict(attrs))
        exe, scope = Executor("cuda"), Scope()
        feed = {f"{s}{i}": a for s, v in ins_np.items()
                for i, a in enumerate(v)}
        for k in range(3):
            got = exe.run(prog, feed=feed, fetch_list=fetch, scope=scope,
                          return_numpy=False)
            n["host_syncs"] += exe.host_syncs
            if exe.host_syncs != 1:
                raise AssertionError(f"phase 26: {cid} run {k}: "
                                     f"{exe.host_syncs} host reads, "
                                     "expected 1")
        if exe.captures != 1 or exe.graphs != 1:
            raise AssertionError(f"phase 26: {cid}: {exe.captures} "
                                 f"captures, {exe.graphs} graphs")
        it = iter(got)
        runs.append(("executor", ({s: [next(it) for _ in v]
                                   for s, v in outs.items()}, {})))
        n["host_op_programs"] += 1
    else:
        jit.warm_up(dev, fn)
        graph, got, _ = jit.capture(dev, fn, [], pool)
        graph.replay()
        torch.cuda.synchronize()
        runs.append(("captured", got))
        n["captured"] += 1
    n["cases"] += 1
    for how, (o, g) in runs:
        what = f"{cid} ({how})"
        for s, vals in ref[0].items():
            for a, b in zip(o[s], vals):
                worst[fam] = max(worst.get(fam, 0.0),
                                 _cf_err(a, b, f"{what} {s}"))
        if how == "executor":
            continue
        if set(g) != set(ref[1]):
            raise AssertionError(f"phase 26: {what}: grads {sorted(g)} "
                                 f"vs the CPU's {sorted(ref[1])}")
        for name, b in ref[1].items():
            worst[fam] = max(worst.get(fam, 0.0),
                             _cf_err(g[name], b, f"{what} {name}"))


def _f64(a):
    a = np.asarray(a)
    return a.astype(np.float64) if a.dtype == np.float32 else a


def _det_close(what, got, ref, fro=DET_FRO, rtol=None, atol=0.0):
    """Float64 card result against the CPU's: the relative Frobenius
    distance within ``fro`` (or, with ``rtol``, every element within
    ``atol + rtol |ref|``); integers exactly. Returns the max abs
    difference."""
    got, ref = np.asarray(got), np.asarray(ref)
    if got.shape != ref.shape:
        raise AssertionError(f"phase 26: {what}: shape {got.shape} vs the "
                             f"CPU's {ref.shape}")
    if ref.dtype.kind in "biu":
        if not np.array_equal(got, ref):
            raise AssertionError(f"phase 26: {what}: {got.ravel()[:8]} vs "
                                 f"the CPU's {ref.ravel()[:8]}")
        return 0.0
    g, r = got.astype(np.float64), ref.astype(np.float64)
    if not np.isfinite(g).all():
        raise AssertionError(f"phase 26: {what}: not finite on the card")
    err = float(np.abs(g - r).max()) if g.size else 0.0
    if rtol is not None:
        ok = (np.abs(g - r) <= atol + rtol * np.abs(r)).all()
    else:
        ok = (np.linalg.norm(g - r) <= fro * max(np.linalg.norm(r), 1e-30)
              or err <= atol)
    if not ok:
        raise AssertionError(f"phase 26: {what}: card vs CPU max abs "
                             f"{err:.3e}")
    return err


def _train_card_cpu(torch, prog, startup, feeds, fetch, what, close):
    """``len(feeds)`` steps on the card, each also on the CPU from a
    copy of the card's state before it (float64): ``close(step, card
    fetches, cpu fetches, card executor)`` per step and every variable
    held to DET_FRO; returns (card fetches per step, the card executor,
    step seconds, the card scope, the state's max abs difference)."""
    from paddle_tpu_torch.framework import Executor, Scope
    from paddle_tpu_torch.models.convert import scope_from_numpy
    card_exe, cpu_exe = Executor("cuda"), Executor("cpu")
    boot = Scope()
    Executor("cpu").run(startup, scope=boot)
    card_scope = scope_from_numpy({n: _f64(boot.get_numpy(n))
                                   for n in boot.var_names()}, "cuda")
    feeds = [{k: _f64(v) for k, v in f.items()} for f in feeds]
    out, secs, worst = [], [], 0.0
    for i, f in enumerate(feeds):
        cpu_scope = scope_from_numpy({n: card_scope.get_numpy(n)
                                      for n in card_scope.var_names()}, "cpu")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = card_exe.run(prog, feed=f, fetch_list=fetch, scope=card_scope)
        secs.append(time.perf_counter() - t0)
        ref = cpu_exe.run(prog, feed=f, fetch_list=fetch, scope=cpu_scope)
        close(i, got, ref, card_exe)
        for n_ in cpu_scope.var_names():
            worst = max(worst, _det_close(f"{what} step {i} {n_}",
                                          card_scope.get_numpy(n_),
                                          cpu_scope.get_numpy(n_),
                                          atol=1e-12))
        out.append(got)
    return out, card_exe, secs, card_scope, worst


#: the NMS kernel against its plain version: rows x candidates, dtype,
#: normalized, IoU threshold (then the (b) inference's own rows)
NMS_CASES = [(8, 1, "f32", True, 0.5), (16, 7, "f32", False, 0.3),
             (64, 64, "f32", True, 0.45), (32, 300, "f32", False, 0.7),
             (640, 1064, "f32", False, 0.45), (16, 257, "f64", True, 0.5),
             (4, 2048, "f32", True, 0.2)]


def _nms_rows(torch, rng, r, w, dtype, dev):
    """Sorted candidate rows: boxes in a 608-pixel image (a fifth of them
    copies of an earlier box: exact ties), descending scores, a -inf
    tail in half the rows."""
    xy = rng.rand(r, w, 2) * 500
    box = np.concatenate([xy, xy + rng.rand(r, w, 2) * 150 + 2], -1)
    dup = rng.rand(r, w) < 0.2
    src = (rng.rand(r, w) * np.arange(w)).astype(np.int64)
    rows, cols = np.nonzero(dup)
    box[rows, cols] = box[rows, src[rows, cols]]
    sc = -np.sort(-rng.rand(r, w), axis=1)
    cut = rng.randint(1, w + 1, r)
    tail = (np.arange(w)[None, :] >= cut[:, None]) & \
        (rng.rand(r)[:, None] < 0.5)
    sc[tail] = -np.inf
    dt = torch.float32 if dtype == "f32" else torch.float64
    return (torch.as_tensor(box, dtype=dt).to(dev),
            torch.as_tensor(sc, dtype=dt).to(dev))


def nms_kernel(torch, det_ops, nms):
    """The NMS kernel (``csrc/nms.cu``) against its plain version on the
    card (NMS_CASES, then the rows (b)'s inference gave it), equal flag
    for flag; then both timed on those rows (device time of a graph's
    replay by CUDA events), beside the bound: the rows' bytes once, or
    17 operations per IoU the greedy loop must evaluate (every kept pair,
    one per suppressed candidate) at the f32 peak."""
    from paddle_tpu_torch import jit
    from paddle_tpu_torch.ops.cuda import nms as nk
    dev = torch.device("cuda")
    rng = np.random.RandomState(26)
    n = 0
    for r, w, dtype, normalized, thresh in NMS_CASES:
        boxes, scores = _nms_rows(torch, rng, r, w, dtype, dev)
        got = nk.nms_keep(boxes, scores, thresh, normalized)
        ref = nk.nms_keep_plain(boxes, scores, thresh, normalized)
        if not torch.equal(got, ref):
            raise AssertionError(f"phase 26: nms_keep [{r}, {w}] {dtype}: "
                                 f"{int((got != ref).sum())} flags differ "
                                 "from the plain version")
        n += 1
    seen = []
    orig = det_ops.nms_keep

    def spy(*a):
        seen.append(a)
        return orig(*a)

    det_ops.nms_keep = spy
    try:
        nms()
    finally:
        det_ops.nms_keep = orig
    boxes, scores, thresh, normalized = seen[0]
    boxes, scores = boxes.contiguous(), scores.contiguous()
    got = nk.nms_keep(boxes, scores, thresh, normalized)
    ref = nk.nms_keep_plain(boxes, scores, thresh, normalized)
    if not torch.equal(got, ref):
        raise AssertionError("phase 26: nms_keep differs from the plain "
                             "version on (b)'s rows")
    n += 1
    pool = torch.cuda.graph_pool_handle()
    g_k, _, _ = jit.capture(dev, lambda: nk.nms_keep(
        boxes, scores, thresh, normalized), [], pool)
    g_p, _, _ = jit.capture(dev, lambda: nk.nms_keep_plain(
        boxes, scores, thresh, normalized), [], pool)
    reps = 20
    ms = event_ms(torch, lambda: [g_k.replay() for _ in range(reps)]) / reps
    plain_ms = event_ms(torch, g_p.replay)
    del g_k, g_p
    keep = got.cpu().numpy()
    alive = np.isfinite(scores.cpu().numpy())
    before = np.cumsum(keep, axis=1) - keep
    ious = int((before * keep).sum()) + int((alive & ~keep).sum())
    r, w = scores.shape
    nbytes = r * w * (4 * boxes.element_size() + scores.element_size() + 1)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 17 * ious / F32_FLOPS * 1e3
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None, "max_abs_err": 0.0, "cases_passed": n,
            "shape": [r, w], "ious": ious, "bytes": nbytes}


def yolo_phase(torch, ctr, card):
    """Phase 26 (b): the YOLOv3 head (models/detection.py's
    yolov3_programs) at configs/yolov3_darknet.yml's geometry: three
    steps of the float64 training program card against CPU (one
    capture), then the inference program in float32 from the trained
    weights (yolo_box x 3, concat, multiclass_nms) eager, captured and
    replayed, and the card's NMS rows and counts against the port's NMS
    on the CPU on the card's own boxes and scores; the NMS alone timed
    on the card, its peak memory beside the M x M matrix it avoids."""
    from paddle_tpu_torch import jit
    from paddle_tpu_torch.framework import Executor
    from paddle_tpu_torch.models import detection as det
    from paddle_tpu_torch.models.convert import scope_from_numpy
    from paddle_tpu_torch.ops import detection_ops as det_ops
    from paddle_tpu_torch.ops import registry as reg
    p = det.yolov3_programs(image=YOLO_IMAGE, class_num=YOLO_CLASSES,
                            gt_slots=YOLO_GT, seed=26)
    rng = np.random.RandomState(26)
    feeds = det.yolo_feeds(rng, DET_STEPS, YOLO_BATCH, YOLO_IMAGE,
                       (1024, 512, 256), YOLO_GT, YOLO_CLASSES)
    losses = []

    def close(i, got, ref, exe):
        _det_close(f"(b) step {i} loss", got[0], ref[0], rtol=DET_LOSS_RTOL,
                   atol=1e-12)
        losses.append(float(got[0]))

    t0 = time.perf_counter()
    _, exe, secs, scope, worst = _train_card_cpu(
        torch, p.main, p.startup, feeds, [p.loss.name], "(b)", close)
    if exe.captures != 1:
        raise AssertionError(f"phase 26 (b): {exe.captures} captures")
    train_s = time.perf_counter() - t0
    # inference in float32 from the trained weights
    state = {n: scope.get_numpy(n).astype(np.float32)
             for n in scope.var_names() if n.startswith("yolo_out")}
    iscope = scope_from_numpy(state, "cuda")
    f = {k: v for k, v in feeds[0].items() if k.startswith("feat")}
    f["img_size"] = np.array([[YOLO_IMAGE, YOLO_IMAGE]] * YOLO_BATCH,
                             np.int32)
    fetch = [p.boxes.name, p.scores.name, p.out.name, p.num.name]
    iexe = Executor("cuda")
    t0 = time.perf_counter()
    runs = []
    ctr.zero()
    for _ in range(3):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        runs.append(iexe.run(p.infer, feed=f, fetch_list=fetch, scope=iscope,
                             return_numpy=False))
        torch.cuda.synchronize()
        secs_i = time.perf_counter() - t1
    launched = ctr.read()
    ctr.expect(launched, {"nms_keep": 3}, "phase 26 (b) inference (the NMS "
               "kernel once per run: eager, capture and replay, replay)")
    if iexe.captures != 1:
        raise AssertionError(f"phase 26 (b): inference {iexe.captures} "
                             "captures")
    boxes, scores, rows, num = runs[-1]
    for k in (2, 3):
        if not torch.equal(runs[0][k], runs[-1][k]):
            raise AssertionError("phase 26 (b): the replayed NMS differs "
                                 "from the eager run")
    m = boxes.shape[1]
    attrs = {"score_threshold": 0.01, "nms_top_k": 1000, "keep_top_k": 100,
             "nms_threshold": 0.45, "normalized": False,
             "background_label": -1}
    ctx = reg.LoweringContext(device="cpu")
    cpu = reg.execute(ctx, "multiclass_nms", {"BBoxes": [boxes.cpu()],
                                              "Scores": [scores.cpu()]},
                      attrs)
    if not torch.equal(cpu["Out"][0], rows.cpu()) or \
            not torch.equal(cpu["NumDetected"][0], num.cpu()):
        raise AssertionError("phase 26 (b): the card's NMS rows or counts "
                             "differ from the CPU's on the same inputs")
    if int(num.min()) <= 0:
        raise AssertionError(f"phase 26 (b): NumDetected {num.tolist()}")
    gctx = reg.LoweringContext(device="cuda")
    ins = {"BBoxes": [boxes], "Scores": [scores]}

    def nms():
        return reg.execute(gctx, "multiclass_nms", ins, attrs)

    with ctr.aside():
        kern = nms_kernel(torch, det_ops, nms)

    nms()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t1 = time.perf_counter()
    nms()
    torch.cuda.synchronize()
    eager_ms = (time.perf_counter() - t1) * 1e3
    peak = torch.cuda.max_memory_allocated() - base
    graph, _, _ = jit.capture(torch.device("cuda"), nms, [],
                              torch.cuda.graph_pool_handle())
    nms_ms = event_ms(torch, graph.replay)
    del graph
    mm_bytes = m * m * 4
    width = min(m, 1000 + 64)
    res = {"train_step_s": secs, "train_losses": losses,
           "train_state_max_abs": worst, "train_s": train_s,
           "infer_replay_s": secs_i, "boxes_per_image": m,
           "num_detected": num.tolist(), "nms_ms": nms_ms,
           "nms_eager_ms": eager_ms, "kernel": kern, "launches": launched,
           "nms_peak_bytes": peak, "nms_candidates_per_class": width,
           "mxm_iou_bytes_per_class": mm_bytes}
    log(f"  [{card}] (b) YOLOv3 batch {YOLO_BATCH} at {YOLO_IMAGE}: train "
        f"steps (float64) {[round(s, 3) for s in secs]} s, losses "
        f"{[round(v, 4) for v in losses]}, card vs CPU state max abs "
        f"{worst:.3e}, 1 capture; inference replay {secs_i * 1e3:.2f} ms "
        f"(host clock), M = {m} boxes, NMS rows and NumDetected "
        f"{num.tolist()} equal to the CPU's NMS on the card's boxes and "
        f"scores; multiclass_nms alone "
        f"{nms_ms:.3f} ms replayed (device time), {eager_ms:.3f} ms eagerly "
        f"(host clock), peak {peak / 2**20:.1f} MiB over its inputs "
        f"({width} candidates per class; one class's M x M IoU would be "
        f"{mm_bytes / 2**30:.2f} GiB); launches {launched}; nms_keep "
        f"(csrc/nms.cu) equal to plain in {kern['cases_passed']} cases, on "
        f"(b)'s rows [{kern['shape'][0]}, {kern['shape'][1]}] "
        f"{kern['ms']:.4f} ms against plain {kern['plain_ms']:.3f} ms, bound "
        f"{kern['bound_ms']:.5f} ms ({kern['bound_by']}: {kern['ious']} "
        f"IoUs, {kern['bytes']} B)")
    return res


def rpn_phase(torch, card):
    """Phase 26 (c): Faster R-CNN's RPN and RoIAlign (models/
    detection.py's rpn_program) at configs/faster_rcnn_r50_1x.yml's
    geometry: three float64 steps card against CPU; one capture, the key
    split at the three host ops into three graphs, three host reads per
    run."""
    from paddle_tpu_torch.models import detection as det
    p = det.rpn_program(channels=RPN_C, height=RPN_H, width=RPN_W,
                        gt_slots=RPN_GT, batch=RPN_BATCH, seed=26)
    feeds = det.rpn_feeds(np.random.RandomState(26), DET_STEPS, RPN_BATCH,
                          RPN_C, RPN_H, RPN_W, RPN_GT)
    stats = {"losses": [], "host_syncs": [], "rois": [], "fg": []}

    def close(i, got, ref, exe):
        for k, name in enumerate(("loss", "rpn cls", "rpn bbox",
                                  "roi mean")):
            _det_close(f"(c) step {i} {name}", got[k], ref[k],
                       rtol=DET_LOSS_RTOL, atol=DET_LOSS_ATOL)
        _det_close(f"(c) step {i} feat@GRAD", got[4], ref[4],
                   atol=DET_GRAD_ATOL)
        stats["grad_norm"] = float(np.linalg.norm(got[4]))
        _det_close(f"(c) step {i} RoIs", got[5], ref[5], rtol=0.0, atol=1e-3)
        for k, name in ((6, "RoisNum"), (7, "RpnRoisNum"), (8, "FgNum")):
            _det_close(f"(c) step {i} {name}", got[k], ref[k])
        stats["losses"].append(float(got[0]))
        stats["host_syncs"].append(exe.host_syncs)
        stats["rois"].append(np.asarray(got[6]).tolist())
        stats["fg"].append(np.asarray(got[8]).tolist())

    t0 = time.perf_counter()
    _, exe, secs, _, worst = _train_card_cpu(
        torch, p.main, p.startup, feeds, p.fetch, "(c)", close)
    if exe.captures != 1 or exe.graphs != 3:
        raise AssertionError(f"phase 26 (c): {exe.captures} captures, "
                             f"{exe.graphs} graphs; expected 1 capture of 3 "
                             "graph pieces")
    if stats["host_syncs"] != [3] * DET_STEPS:
        raise AssertionError(f"phase 26 (c): host reads per run "
                             f"{stats['host_syncs']}, expected 3")
    res = {"step_s": secs, "losses": stats["losses"],
           "host_syncs": stats["host_syncs"], "graphs": exe.graphs,
           "rois_num": stats["rois"], "fg_num": stats["fg"],
           "state_max_abs": worst, "feat_grad_norm": stats["grad_norm"],
           "s": time.perf_counter() - t0}
    log(f"  [{card}] (c) Faster R-CNN RPN + RoIAlign, batch {RPN_BATCH}, "
        f"C4 [{RPN_C}, {RPN_H}, {RPN_W}] (float64): steps "
        f"{[round(s, 3) for s in secs]} s, losses "
        f"{[round(v, 5) for v in stats['losses']]}, host reads per run "
        f"{stats['host_syncs']}, 1 capture of {exe.graphs} graphs, RoIs per "
        f"image {stats['rois']}, fg anchors {stats['fg']}, |feat@GRAD| "
        f"{stats['grad_norm']:.3e}; card vs CPU state max abs {worst:.3e}")
    return res


#: (d): quantization-aware training in float32 is chaotic between the
#: card and the CPU: a rounding difference flips a code (moves an
#: activation by one quantum, scale / 127), the next convolution turns one
#: flip into tens of changed outputs near their own code boundaries, and
#: through 32 quantized layers 5.2-7.7 million of the step's 38,674,432
#: activation codes flip, the loss 0.03-0.16% apart (on an H100 80GB
#: HBM3). So the float32 steps are the card's alone (time, one capture, the
#: AdamW kernel), and the card is held against the CPU in float64 from the
#: same start (scope and feeds upcast; Adam through the AdamW kernel's
#: float64 instantiation, once per adam op and step, against its plain
#: version on the CPU): no code flips there
#: unless an activation lies within ~1e-14 of a boundary, so the loss,
#: every parameter and every state variable are held to 1e-9 (relative,
#: Frobenius, or absolute: a convolution bias a batch norm follows has an
#: exact gradient of zero, whose rounding noise Adam's epsilon of 1e-8
#: turns into steps of lr x noise / 1e-8, 2.9e-12 on the H100). Each
#: flipped code still counted: the loss may then move by
#: q |dL/da| per flip (the card's gradient of that activation), twice
#: that added to its bound, and the state is held as in float32 (the
#: parameters within Adam's 2 lr + 1e-6 per element; a quantizer's
#: accumulator within its input's largest card-CPU difference)
QAT_LOSS_RTOL, QAT_STATE_RTOL = 1e-9, 1e-9


def qat_phase(torch, ctr, card):
    """Phase 26 (d): slim.quant_aware on the Book's resnet_cifar10 (depth
    32, batch 128, Adam): three float32 steps on the card (one capture,
    the AdamW kernel once per ``adam`` op and step, the replay timed);
    three float64 steps on the card, each against the CPU from a copy of
    the card's state (QAT_* above); ``convert``: every scale positive,
    two runs of the frozen, pruned inference program equal;
    PostTrainingQuantization of the float net within 5% of the float
    prediction and not equal to it."""
    from paddle_tpu_torch.framework import Executor, Scope
    from paddle_tpu_torch.models import book
    from paddle_tpu_torch.models.convert import scope_from_numpy
    from paddle_tpu_torch.slim import quantization as quant
    b = book.image_classification(depth=QAT_DEPTH, batch_size=QAT_BATCH,
                                  seed=26, qat=True)
    blk = b.main.global_block()
    qops = [op for op in blk.ops
            if op.type == "fake_quantize_dequantize_moving_average_abs_max"]
    outs = [op.output("Out")[0] for op in qops]
    grads = [o + "@GRAD" if o + "@GRAD" in blk.vars else None for o in outs]
    base = [v.name for v in b.fetches]
    fetch = base + outs + [g for g in grads if g] + \
        [op.input("X")[0] for op in qops]
    quant_state = {}
    for k, op in enumerate(qops):
        for slot in ("InScale", "InState", "InAccum"):
            quant_state[op.input(slot)[0]] = (k, slot)
    n_adam = sum(op.type == "adam" for op in blk.ops)
    params = [p_.name for p_ in b.main.all_parameters()]
    feeds = book.batches(b, DET_STEPS)
    # float32 on the card alone
    exe32, scope = Executor("cuda"), Scope()
    exe32.run(b.startup, scope=scope)
    start = {n: scope.get_numpy(n) for n in scope.var_names()}
    ctr.zero()
    secs, losses32 = [], []
    for f in feeds:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = exe32.run(b.main, feed=f, fetch_list=base, scope=scope)
        secs.append(time.perf_counter() - t0)
        losses32.append(float(got[0]))
    launched = ctr.read()
    ctr.expect(launched, {"adamw": DET_STEPS * n_adam},
               "phase 26 (d) (the AdamW kernel once per adam op and step)")
    if exe32.captures != 1 or not np.isfinite(losses32).all():
        raise AssertionError(f"phase 26 (d): {exe32.captures} captures, "
                             f"losses {losses32}")
    # float64: the card against the CPU
    exe64, cpu_exe = Executor("cuda"), Executor("cpu")
    scope64 = scope_from_numpy({n: _f64(a) for n, a in start.items()},
                               "cuda")
    info = []
    with ctr.aside():
        ctr.zero()
        for i, f in enumerate(feeds):
            f = {k: _f64(v) for k, v in f.items()}
            cpu_scope = scope_from_numpy({n: scope64.get_numpy(n)
                                          for n in scope64.var_names()},
                                         "cpu")
            got = exe64.run(b.main, feed=f, fetch_list=fetch, scope=scope64)
            ref = cpu_exe.run(b.main, feed=f, fetch_list=fetch,
                              scope=cpu_scope)
            info.append(_qat_step(i, b, qops, outs, grads, quant_state,
                                  params, base, fetch, got, ref, scope64,
                                  cpu_scope))
        launched64 = ctr.read()
    ctr.expect(launched64, {"adamw": DET_STEPS * n_adam},
               "phase 26 (d) float64 (the AdamW kernel once per adam op "
               "and step)")
    if exe64.captures != 1:
        raise AssertionError(f"phase 26 (d): float64 {exe64.captures} "
                             "captures")
    frozen, scales = quant.convert(b.main, scope=scope)
    if not scales or min(scales.values()) <= 0:
        raise AssertionError(f"phase 26 (d): convert's scales {scales}")
    infer = frozen._prune(b.infer_targets, keep_var_names=["pixel"])
    x = feeds[-1]["pixel"]
    tgt = b.infer_targets[0].name
    r1, r2 = (exe32.run(infer, feed={"pixel": x}, fetch_list=[tgt],
                        scope=scope, return_numpy=False)[0]
              for _ in range(2))
    if not torch.equal(r1, r2):
        raise AssertionError("phase 26 (d): two runs of the frozen program "
                             "differ")
    # post-training quantization of the float net
    fb = book.image_classification(depth=QAT_DEPTH, batch_size=QAT_BATCH,
                                   seed=26)
    fscope = Scope()
    exe32.run(fb.startup, scope=fscope)
    finfer = fb.test_program._prune(fb.infer_targets,
                                    keep_var_names=["pixel"])
    ftgt = fb.infer_targets[0].name
    ref_p = exe32.run(finfer, feed={"pixel": x}, fetch_list=[ftgt],
                      scope=fscope)[0]
    ptq = quant.PostTrainingQuantization(exe32, finfer, scope=fscope)
    for f in book.batches(fb, 4):
        ptq.collect({"pixel": f["pixel"]})
    qprog, pscales = ptq.quantize()
    got_p = exe32.run(qprog, feed={"pixel": x}, fetch_list=[ftgt],
                      scope=fscope)[0]
    err = float(np.abs(got_p - ref_p).max())
    rel = err / (float(np.abs(ref_p).max()) + 1e-6)
    if not (rel < 0.05 and err > 0):
        raise AssertionError(f"phase 26 (d): PTQ max abs {err:.3e}, "
                             f"{rel:.3e} of the float prediction")
    res = {"step_s": secs, "losses_f32": losses32, "steps_f64": info,
           "captures": exe32.captures, "launches": launched,
           "scales": len(scales), "min_scale": min(scales.values()),
           "ptq_max_abs": err, "ptq_rel": rel, "ptq_scales": len(pscales)}
    log(f"  [{card}] (d) QAT resnet_cifar10 depth {QAT_DEPTH} batch "
        f"{QAT_BATCH}: float32 steps {[round(s, 4) for s in secs]} s, "
        f"losses {[round(v, 5) for v in losses32]}, 1 capture, launches "
        f"{launched}; float64 against the CPU ({launched64['adamw']} "
        f"AdamW launches): losses "
        f"{[round(s['loss'], 6) for s in info]}, loss diffs "
        f"{[format(s['loss_diff'], '.2e') for s in info]} within {[format(s['allowed'], '.2e') for s in info]}, flipped "
        f"codes {[s['flipped_codes'] for s in info]}, parameters max abs "
        f"{[format(s['param_max_abs'], '.2e') for s in info]}, state max "
        f"abs {[format(s['state_max_abs'], '.2e') for s in info]}; "
        f"convert: {len(scales)} scales, min {min(scales.values()):.3e}, two "
        f"frozen runs equal; PTQ {rel:.3e} of float (max abs {err:.3e})")
    return res


def _qat_step(i, b, qops, outs, grads, quant_state, params, base, fetch,
              got, ref, scope, cpu_scope):
    """One float64 step of (d) against the CPU (QAT_* above)."""
    xs = len(fetch) - len(qops)
    dx = [float(np.abs(got[xs + k] - ref[xs + k]).max())
          for k in range(len(qops))]
    gi = iter(got[len(base) + len(outs):xs])
    flips, bound = 0, 0.0
    for k, (out, g) in enumerate(zip(outs, grads)):
        q = float(scope.get_numpy(qops[k].input("InScale")[0])) / 127.0
        flipped = np.abs(got[len(base) + k] - ref[len(base) + k]) > q / 2
        gv = next(gi) if g else None
        if flipped.any():
            if gv is None:
                raise AssertionError(f"phase 26 (d): step {i}: "
                                     f"{int(flipped.sum())} codes of {out} "
                                     "(no gradient) flipped")
            flips += int(flipped.sum())
            bound += q * float(np.abs(gv[flipped]).sum())
    loss, rloss = float(got[0]), float(ref[0])
    allowed = QAT_LOSS_RTOL * abs(rloss) + 2 * bound
    if not np.isfinite(loss) or abs(loss - rloss) > allowed:
        raise AssertionError(f"phase 26 (d): step {i} loss card {loss} CPU "
                             f"{rloss}, allowed {allowed:.3e} ({flips} "
                             "flipped codes)")
    pworst, sworst = 0.0, 0.0
    for n_ in params:
        if flips:
            err = book_param_close(f"(d) step {i} {n_}", scope.get_numpy(n_),
                                   cpu_scope.get_numpy(n_),
                                   2 * b.lr + 1e-6)[0]
        else:
            err = _det_close(f"(d) step {i} {n_}", scope.get_numpy(n_),
                             cpu_scope.get_numpy(n_), fro=QAT_STATE_RTOL,
                             atol=QAT_STATE_RTOL)
        pworst = max(pworst, err)
    for n_ in sorted(set(cpu_scope.var_names()) - set(params)):
        got_s, ref_s = scope.get_numpy(n_), cpu_scope.get_numpy(n_)
        if not flips:
            sworst = max(sworst, _det_close(f"(d) step {i} {n_}", got_s,
                                            ref_s, fro=QAT_STATE_RTOL,
                                            atol=QAT_STATE_RTOL))
        elif "_moment" in n_:
            if got_s.shape != ref_s.shape or not np.isfinite(got_s).all():
                raise AssertionError(f"phase 26 (d): step {i} {n_}")
        elif n_ in quant_state:
            k, slot = quant_state[n_]
            st = float(scope.get_numpy(qops[k].input("InState")[0]))
            g_, r_ = float(got_s), float(ref_s)
            lim = QAT_STATE_RTOL * abs(r_) + (
                0.0 if slot == "InState" else
                dx[k] / st if slot == "InScale" else dx[k])
            if not abs(g_ - r_) <= lim:
                raise AssertionError(
                    f"phase 26 (d): step {i} {n_}: card {g_} CPU {r_}, "
                    f"allowed {lim:.3e} (input max abs diff {dx[k]:.3e})")
            sworst = max(sworst, abs(g_ - r_))
        else:
            sworst = max(sworst, book_param_close(
                f"(d) step {i} {n_}", got_s, ref_s, None, BOOK_STATE_FRO,
                BOOK_STATE_ATOL)[0])
    if not got[1] == ref[1]:
        raise AssertionError(f"phase 26 (d): step {i} accuracy {got[1]} "
                             f"vs the CPU's {ref[1]}")
    return {"loss": loss, "cpu_loss": rloss, "loss_diff": abs(loss - rloss),
            "allowed": allowed, "flipped_codes": flips,
            "param_max_abs": pworst, "state_max_abs": sworst}


def detection_phase(torch, ctr, card):
    """Phase 26: (a) the tail op sweep, (b) the YOLOv3 head, (c) Faster
    R-CNN's RPN and RoIAlign, (d) quantization-aware training."""
    det_flags = (torch.backends.cudnn.deterministic,
                 torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    out, secs = {}, {}
    try:
        t0 = time.perf_counter()
        with ctr.aside():
            counts, worst = tail_sweep(torch)
        secs["a"] = time.perf_counter() - t0
        log(f"  (a) {counts['cases']} cases on the card against the CPU "
            f"eagerly, {counts['captured']} captured and replayed, "
            f"{counts['host_op_programs']} host ops through the executor's "
            f"split ({counts['host_syncs']} host syncs); largest error per "
            f"family {worst}; {secs['a']:.1f} s")
        out["sweep"] = {"counts": counts, "worst": worst}
        for key, fn in (("b", lambda: yolo_phase(torch, ctr, card)),
                        ("c", lambda: rpn_phase(torch, card))):
            t0 = time.perf_counter()
            with ctr.aside():
                out[key] = fn()
            secs[key] = time.perf_counter() - t0
            log(f"  ({key}) took {secs[key]:.1f} s")
            gc.collect()
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        out["d"] = qat_phase(torch, ctr, card)
        secs["d"] = time.perf_counter() - t0
        log(f"  (d) took {secs['d']:.1f} s")
    finally:
        torch.backends.cudnn.deterministic, \
            torch.backends.cudnn.benchmark = det_flags
    out["seconds"] = secs
    out["launches"] = {**out["d"]["launches"],
                       "nms_keep": out["b"]["launches"]["nms_keep"]}
    return out


# ------------------------------------------------------------ phase 27
#: phase 23's encoder at full width for the Program rewrites: steps per
#: arm (recompute, the fleet chain, weight averaging, CompiledProgram),
#: gradient merge's k and SGD learning rate, the pipeline's microbatches,
#: split and steps per schedule
ST_STEPS, ST_CHAIN_STEPS, ST_AVG_STEPS = 3, 8, 6
ST_K, ST_SGD_LR, ST_MB, ST_SPLIT, ST_PIPE_STEPS = 4, 1e-3, 4, 3, 2
#: flash launches per step with recompute: phase 23's 12 forwards plus
#: the six segments' recomputed attention; LayerNorm likewise (12 more)
ST_RECOMPUTE_PER_STEP = dict(SE_PER_STEP, flash_fwd=18, ln_fwd=36)
#: tolerances (each stated in PERF.md): the recompute arm bit-equal, else
#: its parameters within 1e-6 relative Frobenius (all together); the
#: merged SGD step's parameters within 1e-5 of one whole-batch step and
#: its update within 1e-3; the chain's first loss within 1e-2 of f32's;
#: the pipeline's first step against one plain step: the loss within
#: 1e-5, the parameters within 1e-4 and their update within ST_UPD_RTOL;
#: GPipe against 1F1B (their microbatch gradients sum in opposite orders):
#: the first losses equal, the parameters within 1e-6 and their updates
#: within ST_UPD_RTOL; every AdamW parameter also within 2 k lr + 1e-6 per
#: element; a shadow within 1 ulp of its torch recurrence; CompiledProgram's
#: losses within 1e-6 relative of the plain program's
ST_MERGE_RTOL, ST_MERGE_UPDATE, ST_AMP_RTOL = 1e-5, 1e-3, 1e-2
ST_PIPE_LOSS, ST_PIPE_RTOL, ST_SCHED_RTOL, ST_CP_RTOL = 1e-5, 1e-4, 1e-6, 1e-6
ST_UPD_RTOL = 1e-2


def st_params_close(torch, got, ref, base, k, rtol, utol, what):
    """``got``'s parameters against ``ref``'s after ``k`` AdamW steps from
    ``base``: all parameters together within ``rtol`` relative Frobenius,
    their updates from ``base`` within ``utol``, and every element within
    ``2 k lr + 1e-6`` (an Adam step is near ``lr x sign(g)``: where the
    true gradient is near zero, as for the key projection's bias, its sign
    is rounding). Returns the distances and the parameter whose update
    differs most, relatively."""
    rel, upd = st_joint_rel(torch, got, ref), \
        st_joint_rel(torch, got, ref, base)
    worst = (-1.0, "")
    for n, r in ref.items():
        d = got[n].double() - r.double()
        err = float(d.abs().max())
        if not err <= 2 * k * SE_LR + 1e-6:
            raise AssertionError(f"phase 27 {what}: {n} off by {err:.3e} "
                                 f"> 2 k lr")
        u = float(torch.linalg.norm(r.double() - base[n].double()))
        worst = max(worst, (float(torch.linalg.norm(d)) / max(u, 1e-30), n))
    if not (rel <= rtol and upd <= utol):
        raise AssertionError(f"phase 27 {what}: parameters {rel:.3e} (limit "
                             f"{rtol:.0e}), updates {upd:.3e} (limit "
                             f"{utol:.0e}) relative Frobenius")
    return {"params_rel": rel, "updates_rel": upd, "worst_update": worst}


def st_joint_rel(torch, got, ref, base=None):
    """Relative Frobenius distance over all parameters together (of the
    updates from ``base`` when given)."""
    num = den = 0.0
    for n, r in ref.items():
        a, b = got[n].double(), r.double()
        if base is not None:
            a, b = a - base[n].double(), b - base[n].double()
        num += float(torch.linalg.norm(a - b)) ** 2
        den += float(torch.linalg.norm(b)) ** 2
    return (num / max(den, 1e-300)) ** 0.5


def st_scope(start):
    from paddle_tpu_torch.framework import Scope
    scope = Scope()
    for n in start.var_names():
        scope.set_var(n, start.find_var(n).clone())
    return scope


def st_params(scope, main):
    return {p.name: scope.find_var(p.name).clone()
            for p in main.all_parameters()}


def st_build(minimize=None, **kw):
    """Phase 23's encoder, its startup run into a scope of its own."""
    from paddle_tpu_torch.framework import Executor, Scope
    from paddle_tpu_torch.models.static_encoder import build_encoder_program
    main, startup, loss = build_encoder_program(
        SE_LAYERS, SE_D, SE_HEADS, SE_FFN, SE_SEQ, lr=SE_LR,
        minimize=minimize, **kw)
    start = Scope()
    Executor().run(startup, scope=start)
    return main, startup, loss, start


def st_steps(torch, exe, main, scope, loss, feeds, peaks=None, fetch=(),
             program=None):
    """Run ``feeds`` through ``exe`` (``program``: ``main`` compiled, or
    ``main``); the losses, each step's parameters and extra fetches, and
    (``peaks``) the peak allocated bytes above the start of the first
    and the second run (eager, capture)."""
    out = []
    for i, feed in enumerate(feeds):
        if peaks is not None and i < 2:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
        f = exe.run(program or main, feed=feed,
                    fetch_list=[loss.name, *fetch], scope=scope,
                    return_numpy=False)
        if peaks is not None and i < 2:
            torch.cuda.synchronize()
            peaks.append(torch.cuda.max_memory_allocated() - base)
        out.append((float(f[0].reshape(-1)[0]), st_params(scope, main),
                    f[1:]))
    torch.cuda.synchronize()
    return out


def st_recompute(torch, ctr, x, card):
    """(a) RecomputeOptimizer(AdamW) with checkpoints at the six layer
    outputs against the plain AdamW program."""
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.framework import Executor

    def recompute(loss, rate, ckpts):
        opt = optimizer.RecomputeOptimizer(
            optimizer.AdamW(learning_rate=rate, weight_decay=0.01))
        opt._set_checkpoints(ckpts)
        opt.minimize(loss)

    runs, out = {}, {}
    for key, fn in (("plain", None), ("recompute", recompute)):
        main, _, loss, start = st_build(fn)
        scope, exe, peaks = st_scope(start), Executor(), []
        gc.collect()
        ctr.zero()
        runs[key] = st_steps(torch, exe, main, scope, loss,
                             [{"x": x}] * ST_STEPS, peaks)
        launched = ctr.read()
        want = ST_RECOMPUTE_PER_STEP if key == "recompute" else SE_PER_STEP
        ctr.expect(launched, {k: v * ST_STEPS for k, v in want.items()},
                   f"phase 27 (a) {key}")
        if exe.captures != 1:
            raise AssertionError(f"phase 27 (a) {key}: {exe.captures} "
                                 "captures, expected 1")
        out[key] = {"peak_eager_bytes": peaks[0],
                    "peak_capture_bytes": peaks[1],
                    "losses": [r[0] for r in runs[key]],
                    "launches_per_step": {k: v // ST_STEPS
                                          for k, v in launched.items() if v},
                    "routes": ctr.routes()}
        if key == "plain":
            out["plain_first"] = (runs[key][0][0], runs[key][0][1],
                                  st_params(start, main))
        log(f"  (a) {key}: losses {out[key]['losses']}, peak allocated "
            f"{peaks[0] / 2**20:.1f} MiB eager, {peaks[1] / 2**20:.1f} MiB "
            f"capturing [{card}]; per step {out[key]['launches_per_step']}")
        del scope, exe, start
    bit = all(a[0] == b[0] and all(torch.equal(a[1][n], b[1][n])
                                   for n in a[1])
              for a, b in zip(runs["recompute"], runs["plain"]))
    worst = None
    if not bit:
        base = out["plain_first"][2]
        for k, ((lr_, pr, _), (lp, pp, _)) in enumerate(
                zip(runs["recompute"], runs["plain"]), 1):
            if abs(lr_ - lp) > 1e-6 * abs(lp):
                raise AssertionError(f"phase 27 (a): loss {lr_!r} vs "
                                     f"{lp!r}")
            worst = st_params_close(torch, pr, pp, base, k, 1e-6, 1.0,
                                    "(a)")
    for phase in ("peak_eager_bytes", "peak_capture_bytes"):
        if not out["recompute"][phase] < out["plain"][phase]:
            raise AssertionError(f"phase 27 (a): recompute's {phase} "
                                 f"{out['recompute'][phase]} not below "
                                 f"plain's {out['plain'][phase]}")
    out["bit_equal"], out["worst_rel"] = bit, worst
    log(f"  (a) recompute vs plain: bit-equal {bit}, worst {worst}; peak "
        f"saved {(out['plain']['peak_capture_bytes'] - out['recompute']['peak_capture_bytes']) / 2**20:.1f} MiB "
        f"capturing, {(out['plain']['peak_eager_bytes'] - out['recompute']['peak_eager_bytes']) / 2**20:.1f} MiB eager")
    return out


def st_strategy(**flags):
    from paddle_tpu_torch.distributed.fleet import DistributedStrategy
    s = DistributedStrategy()
    for k, v in flags.items():
        setattr(s, k, v)
    return s


def st_merge(torch, ctr, x, card):
    """(b) gradient merge (k 4, avg) under SGD over four [2, seq] slices
    against one SGD step on the whole batch."""
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.framework import Executor
    strategy = st_strategy(gradient_merge=True,
                           gradient_merge_configs={"k_steps": ST_K,
                                                   "avg": True})
    fl = fleet.fleet
    fl.init(is_collective=True)

    def merged(loss, rate, ckpts):
        fl.distributed_optimizer(optimizer.SGD(ST_SGD_LR),
                                 strategy).minimize(loss)

    main, _, loss, start = st_build(merged)
    compiled = fleet.main_program
    scope, exe = st_scope(start), Executor()
    base = st_params(start, main)
    slices = np.split(x, ST_K)
    ctr.zero()
    for i, xs in enumerate(slices):
        exe.run(compiled, feed={"x": xs}, fetch_list=[loss.name],
                scope=scope)
        if i < ST_K - 1:
            for n, p in st_params(scope, main).items():
                if not torch.equal(p, base[n]):
                    raise AssertionError(f"phase 27 (b): {n} moved at the "
                                         f"frozen step {i + 1}")
    launched = ctr.read()
    got = st_params(scope, main)
    if exe.captures != 1:
        raise AssertionError(f"phase 27 (b): {exe.captures} captures")

    def whole(loss, rate, ckpts):
        optimizer.SGD(ST_SGD_LR).minimize(loss)

    pm, _, pl, pstart = st_build(whole)
    pscope = st_scope(pstart)
    Executor().run(pm, feed={"x": x}, fetch_list=[pl.name], scope=pscope)
    ref = st_params(pscope, pm)
    rel, upd = st_joint_rel(torch, got, ref), \
        st_joint_rel(torch, got, ref, base)
    if not (rel <= ST_MERGE_RTOL and upd <= ST_MERGE_UPDATE):
        raise AssertionError(f"phase 27 (b): merged step {rel:.3e} from "
                             f"the whole-batch step, update {upd:.3e}")
    log(f"  (b) gradient merge k {ST_K}: steps 1-{ST_K - 1} bit-equal to "
        f"the start; after step {ST_K} {rel:.3e} relative Frobenius from "
        f"one whole-batch SGD step, update {upd:.3e}; launches {launched}")
    return {"rel": rel, "update_rel": upd, "launches": launched,
            "captures": exe.captures}


def st_chain(torch, ctr, ln, x, plain_loss, card):
    """(c) the fleet chain: AMP, recompute and gradient merge (k 4)
    around AdamW through fleet.distributed_optimizer."""
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.framework import Executor
    from paddle_tpu_torch.models.static_encoder import build_encoder_program

    def chain(loss, rate, ckpts):
        strategy = st_strategy(
            amp=True, recompute=True, gradient_merge=True,
            recompute_configs={"checkpoints": [c.name for c in ckpts]},
            gradient_merge_configs={"k_steps": ST_K, "avg": True})
        fleet.init(is_collective=True)
        fleet.distributed_optimizer(
            optimizer.AdamW(learning_rate=rate, weight_decay=0.01),
            strategy).minimize(loss)

    main, _, loss, start = st_build(chain)
    compiled = fleet.main_program
    again = build_encoder_program(SE_LAYERS, SE_D, SE_HEADS, SE_FFN, SE_SEQ,
                                  lr=SE_LR, minimize=chain)[0]
    if again.to_json() != main.to_json():
        raise AssertionError("phase 27 (c): the rewritten program differs "
                             "between two builds")
    types_ = [op.type for op in main.global_block().ops]
    for t in ("cast", "optimization_barrier", "elementwise_mod", "adamw"):
        if t not in types_:
            raise AssertionError(f"phase 27 (c): no {t} op in the chain")
    seen = []
    orig = ln.ln_fwd

    def ln_fwd(x2, *a, **k):
        seen.append(x2.dtype)
        return orig(x2, *a, **k)

    scope, exe = st_scope(start), Executor()
    ln.ln_fwd = ln_fwd
    try:
        ctr.zero()
        runs = st_steps(torch, exe, main, scope, loss,
                        [{"x": x}] * ST_CHAIN_STEPS, program=compiled)
        launched, routes = ctr.read(), ctr.routes()
    finally:
        ln.ln_fwd = orig
    losses = [r[0] for r in runs]
    flash = {n: routes[n] for n in ("flash_fwd", "flash_bwd_dq",
                                    "flash_bwd_dkv")}
    if not all(launched[n] and by["wgmma"] == launched[n]
               for n, by in flash.items()):
        raise AssertionError(f"phase 27 (c): flash launches by route "
                             f"{flash}, expected all on wgmma")
    if not launched["ln_fwd"] or set(seen) != {torch.float32}:
        raise AssertionError(f"phase 27 (c): LayerNorm inputs {set(seen)}, "
                             f"{launched['ln_fwd']} launches: expected f32")
    if not all(np.isfinite(losses)) or \
            abs(losses[0] - plain_loss) > ST_AMP_RTOL * abs(plain_loss):
        raise AssertionError(f"phase 27 (c): losses {losses} vs the f32 "
                             f"plain program's first {plain_loss!r}")
    if exe.captures != 1:
        raise AssertionError(f"phase 27 (c): {exe.captures} captures")
    log(f"  (c) fleet chain (amp, recompute, gradient merge k {ST_K}): "
        f"{types_.count('cast')} casts; losses {losses} (f32 first "
        f"{plain_loss!r}); launches {launched}; flash routes {flash}; "
        f"LayerNorm inputs f32 [{card}]")
    return {"losses": losses, "launches": launched, "routes": flash,
            "casts": types_.count("cast"), "captures": exe.captures}


def st_pipeline(torch, ctr, x, plain_first, card):
    """(d) PipelineOptimizer(AdamW, 4 microbatches) on the encoder split
    after layer 3: GPipe and 1F1B from one startup against each other and
    against one plain whole-batch AdamW step."""
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.framework import Executor
    holder = {}

    def pipe(loss, rate, ckpts):
        holder["opt"] = optimizer.PipelineOptimizer(
            optimizer.AdamW(learning_rate=rate, weight_decay=0.01),
            num_microbatches=ST_MB)
        holder["opt"].minimize(loss)

    main, _, loss, start = st_build(pipe, split_after=ST_SPLIT)
    stages = main._pipeline_stages
    if [s.device for s in stages] != ["gpu:0", "gpu:1"]:
        raise AssertionError(f"phase 27 (d): stages {stages}")
    feeds = [{"x": xs} for xs in np.split(x, ST_MB)]
    out, params = {}, {}
    for schedule in ("gpipe", "1f1b"):
        runner = holder["opt"].runner(schedule=schedule)
        scope, exe = st_scope(start), Executor()
        ctr.zero()
        losses, after = [], []
        for _ in range(ST_PIPE_STEPS):
            losses.append(float(runner.run(exe, scope, feeds,
                                           fetch_list=[loss.name])[0]))
            after.append(st_params(scope, main))
        torch.cuda.synchronize()
        n_programs = 3 * len(stages)
        if exe.captures != n_programs:
            raise AssertionError(f"phase 27 (d) {schedule}: {exe.captures} "
                                 f"captures, expected {n_programs}")
        out[schedule] = {"losses": losses, "launches": ctr.read(),
                         "captures": exe.captures,
                         "overlap_report": runner.overlap_report()}
        params[schedule] = after
        log(f"  (d) {schedule}: losses {losses}, {exe.captures} captures, "
            f"launches {out[schedule]['launches']}; overlap_report "
            f"{out[schedule]['overlap_report']}")
    g, f = out["gpipe"]["losses"], out["1f1b"]["losses"]
    if g[0] != f[0] or abs(g[1] - f[1]) > ST_SCHED_RTOL * abs(g[1]):
        raise AssertionError(f"phase 27 (d): GPipe losses {g} vs 1F1B {f}")
    plain_loss, plain_params, base = plain_first
    sched = st_params_close(torch, params["1f1b"][-1], params["gpipe"][-1],
                            base, ST_PIPE_STEPS, ST_SCHED_RTOL, ST_UPD_RTOL,
                            "(d) 1f1b")
    if abs(g[0] - plain_loss) > ST_PIPE_LOSS * abs(plain_loss):
        raise AssertionError(f"phase 27 (d): first loss {g[0]!r} vs plain "
                             f"{plain_loss!r}")
    vs_plain = st_params_close(torch, params["gpipe"][0], plain_params,
                               base, 1, ST_PIPE_RTOL, ST_UPD_RTOL,
                               "(d) vs plain")
    sched_bit = all(torch.equal(params["gpipe"][-1][n],
                                params["1f1b"][-1][n])
                    for n in params["gpipe"][-1])
    log(f"  (d) GPipe vs 1F1B: bit-equal {sched_bit}, worst {sched}; "
        f"GPipe's first step vs one plain step: loss {g[0]!r} vs "
        f"{plain_loss!r}, worst {vs_plain}")
    out.update(schedules_bit_equal=sched_bit, worst_1f1b=sched,
               worst_vs_plain=vs_plain)
    return out


def st_averaging(torch, ctr, x, card):
    """(e) EMA (0.999), ModelAverage (window 4) and Lookahead (k 3,
    alpha 0.5) around AdamW: each shadow against a torch recurrence of
    the same operations on the fetched values, ``apply`` on a captured
    test clone, the parameters bit-equal after the block."""
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.framework import Executor
    held = {}

    def averaged(loss, rate, ckpts):
        optimizer.LookaheadOptimizer(
            optimizer.AdamW(learning_rate=rate, weight_decay=0.01),
            alpha=0.5, k=3).minimize(loss)
        held["ema"] = optimizer.ExponentialMovingAverage(0.999).update()
        held["ma"] = optimizer.ModelAverage(max_average_window=4).update()

    main, _, loss, start = st_build(averaged)
    ema, ma = held["ema"], held["ma"]
    names = [p.name for p in main.all_parameters()]
    # Lookahead's fast - slow (fetched) and slow weight, per parameter
    subs = {op.input("X")[0]: op for op in main.global_block().ops
            if op.type == "elementwise_sub"
            and ".la_diff" in op.output("Out")[0]}
    diffs = [subs[n].output("Out")[0] for n in names]
    slow = {n: subs[n].input("Y")[0] for n in names}
    scope, exe = st_scope(start), Executor()
    ctr.zero()
    runs = st_steps(torch, exe, main, scope, loss,
                    [{"x": x}] * ST_AVG_STEPS, fetch=diffs)
    launched = ctr.read()
    e_ref = {p: start.find_var(a).clone() for p, a in ema._pairs}
    s_ref = {n: start.find_var(slow[n]).clone() for n in names}
    m_ref = {p: start.find_var(a).clone() for p, a in ma._pairs}
    num, x_dev = 0, runs[0][1][names[0]].device
    for step, (_, params, fetched) in enumerate(runs, 1):
        mask = torch.tensor([float(step % 3 == 0)], device=x_dev)
        for n, d in zip(names, fetched):
            s_ref[n] = s_ref[n] + (d * 0.5 + 0.0) * mask
        for p in e_ref:
            e_ref[p] = (e_ref[p] * 0.999 + 0.0) + \
                (params[p] * (1.0 - 0.999) + 0.0)
        num += 1
        reset = num == 4
        num = 1 if reset else num
        maskf = torch.tensor([float(reset)], device=x_dev)
        inv = maskf * -1.0 + 1.0
        for p in m_ref:
            m_ref[p] = (m_ref[p] + params[p]) * inv + params[p] * maskf

    def ulp_close(a, b):
        return bool(((a - b).abs() <= b.abs() * 2.0 ** -23 + 1e-45).all())

    worst = {}
    for what, ref, var in (("ema", e_ref, dict(ema._pairs)),
                           ("lookahead", s_ref, slow),
                           ("model_average", m_ref, dict(ma._pairs))):
        eq = 0
        for p, r in ref.items():
            got = scope.find_var(var[p])
            if not ulp_close(got, r):
                raise AssertionError(f"phase 27 (e): {what} shadow of {p} "
                                     f"off its recurrence by "
                                     f"{float((got - r).abs().max()):.3e}")
            eq += int(torch.equal(got, r))
        worst[what] = f"{eq}/{len(ref)} bit-equal, the rest within 1 ulp"
    # apply on a captured test clone
    test = main.clone(for_test=True)._prune([loss.name])
    texe = Executor()
    for _ in range(2):
        texe.run(test, feed={"x": x}, fetch_list=[loss.name], scope=scope)
    before = st_params(scope, main)
    with ema.apply(scope):
        (l_ema,) = texe.run(test, feed={"x": x}, fetch_list=[loss.name],
                            scope=scope, return_numpy=False)
    after = st_params(scope, main)
    if not all(torch.equal(after[n], before[n]) for n in names):
        raise AssertionError("phase 27 (e): parameters not restored bit "
                             "for bit after ema.apply")
    for p, a in ema._pairs:
        scope.find_var(p).copy_(scope.find_var(a))
    (l_hand,) = texe.run(test, feed={"x": x}, fetch_list=[loss.name],
                         scope=scope, return_numpy=False)
    for n in names:
        scope.find_var(n).copy_(before[n])
    if not torch.equal(l_ema, l_hand) or texe.captures != 1:
        raise AssertionError(f"phase 27 (e): apply's loss {l_ema} vs the "
                             f"shadows copied by hand {l_hand}; "
                             f"{texe.captures} test captures")
    if exe.captures != 1:
        raise AssertionError(f"phase 27 (e): {exe.captures} captures")
    log(f"  (e) shadows vs their recurrences: {worst}; apply's loss "
        f"{float(l_ema)!r} equals the hand copy's; parameters restored bit "
        f"for bit; launches {launched}")
    return {"shadows": worst, "launches": launched,
            "loss_ema": float(l_ema)}


def st_compiled(torch, ctr, x, plain_losses, card):
    """(f) CompiledProgram(main, BuildStrategy(fuse_elewise_add_act_ops))
    through exe.run against the plain program."""
    from paddle_tpu_torch.compiler import BuildStrategy, CompiledProgram
    from paddle_tpu_torch.framework import Executor
    main, _, loss, start = st_build()
    bs = BuildStrategy()
    bs.fuse_elewise_add_act_ops = True
    compiled = CompiledProgram(main, bs)
    scope, exe = st_scope(start), Executor()
    ctr.zero()
    losses = []
    for _ in range(ST_STEPS):
        (f,) = exe.run(compiled, feed={"x": x}, fetch_list=[loss.name],
                       scope=scope, return_numpy=False)
        losses.append(float(f.reshape(-1)[0]))
    launched = ctr.read()
    fused = [op.type for op in compiled._program.global_block().ops] \
        .count("fused_elemwise_activation")
    if exe.captures != 1 or any(
            abs(a - b) > ST_CP_RTOL * abs(b)
            for a, b in zip(losses, plain_losses)):
        raise AssertionError(f"phase 27 (f): losses {losses} vs plain "
                             f"{plain_losses}, {exe.captures} captures")
    log(f"  (f) CompiledProgram: {fused} fused ops, losses {losses} (plain "
        f"{plain_losses}), one capture; launches {launched}")
    return {"losses": losses, "fused_ops": fused, "launches": launched}


def strategy_phase(torch, ctr, ln, card):
    """Phase 27: the Program rewrites on phase 23's encoder at full width
    (6 layers, d 512, 8 heads, FFN 2048, [8, 1024] tokens), flash and
    LayerNorm kernels on, one seeded startup per arm: (a) recompute, (b)
    gradient merge, (c) the fleet chain with AMP, (d) the pipeline, (e)
    weight averaging, (f) CompiledProgram."""
    from paddle_tpu_torch import flags
    from paddle_tpu_torch.distributed import env as dist_env
    names = ("use_pallas_attention", "use_pallas_layer_norm")
    saved = flags.get_flags(list(names))
    flags.set_flags({n: True for n in names})
    x = np.random.RandomState(27).randn(SE_BATCH, SE_SEQ, SE_D) \
        .astype(np.float32)
    out, secs = {}, {}
    try:
        for key, fn in (
                ("a", lambda: st_recompute(torch, ctr, x, card)),
                ("b", lambda: st_merge(torch, ctr, x, card)),
                ("c", lambda: st_chain(torch, ctr, ln, x,
                                       out["a"]["plain"]["losses"][0],
                                       card)),
                ("d", lambda: st_pipeline(torch, ctr, x,
                                          out["a"]["plain_first"], card)),
                ("e", lambda: st_averaging(torch, ctr, x, card)),
                ("f", lambda: st_compiled(torch, ctr, x,
                                          out["a"]["plain"]["losses"],
                                          card))):
            t0 = time.perf_counter()
            out[key] = fn()
            secs[key] = time.perf_counter() - t0
            log(f"  ({key}) took {secs[key]:.1f} s")
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        flags.set_flags(saved)
        dist_env.set_mesh(None)
    del out["a"]["plain_first"]
    out["seconds"] = secs
    out["launches"] = {
        "flash_static_amp": {n: out["c"]["launches"][n]
                             for n in ("flash_fwd", "flash_bwd_dq",
                                       "flash_bwd_dkv")},
        "adamw": {"recompute": out["a"]["recompute"]["launches_per_step"]
                  ["adamw"] * ST_STEPS,
                  "chain": out["c"]["launches"]["adamw"],
                  "pipeline": out["d"]["gpipe"]["launches"]["adamw"],
                  "averaging": out["e"]["launches"]["adamw"],
                  "compiled": out["f"]["launches"]["adamw"]}}
    return out


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
    from paddle_tpu_torch.ops.cuda import nms as nk
    from paddle_tpu_torch.ops.cuda import paged_attention as pa

    t_start = time.perf_counter()
    ctr = Counters(pa, fa, ln, fp2, aw, nk)
    card = card_line()
    log("== phase 1: device")
    log(f"  {torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}, "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(f"  nvidia-smi: {card}")

    log("== phase 2: build (one nvcc per source, started together)")
    sources = ["paged_attention", "flash_attention", "layer_norm",
               "flash_pack2", "adamw", "cond_graph", "nms"]
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

    log("== phase 5e: bench.py's loadgen block, gpt2-medium: calibration, "
        "depth-only, SLO-aware, chaos, a 3-replica router and a 1 x 2 "
        "disaggregated fleet on one seeded bursty trace; a hedged fleet; "
        "cancel and hard deadlines; a decode worker killed across pools "
        "and kill_prefill / kill_decode chaos")
    t_lg = time.perf_counter()
    lgs = loadgen_serving(torch, ctr, card)
    log(f"  phase 5e took {time.perf_counter() - t_lg:.1f} s")

    log(f"== phase 5f: the HTTP front end over a started 1 x 2 "
        f"disaggregated fleet, gpt2-medium at {DISAGG_LAYERS} layers")
    t_http = time.perf_counter()
    web = http_serving(torch, ctr, card)
    log(f"  phase 5f took {time.perf_counter() - t_http:.1f} s")

    log("== phase 5g: tenants, gpt2-medium: a rank-8 adapter pool under "
        "tools/ci.sh's multi-tenant trace at megastep 1 and 8, tokens "
        "against single-tenant engines, live adapter changes, the decode "
        "step with and without LoRA")
    t_ten = time.perf_counter()
    ten = tenant_serving(torch, ctr, card)
    log(f"  phase 5g took {time.perf_counter() - t_ten:.1f} s")

    log("== phase 5h: returning users on the host KV tier, gpt2-medium: "
        "tools/ci.sh's returning-users trace, a round trip per pool dtype, "
        f"a killed prefill worker and a tenant session at {DISAGG_LAYERS} "
        "layers")
    t_tier = time.perf_counter()
    tie = host_tier_serving(torch, ctr, pa, card)
    log(f"  phase 5h took {time.perf_counter() - t_tier:.1f} s")

    log(f"== phase 5i: JSON-constrained decoding, gpt2-medium at megastep "
        f"{FLEET_MEGASTEP}: greedy and sampled constrained rows beside "
        f"plain ones, kernel against plain route; a router, a 1 x 2 "
        f"disaggregated fleet and HTTP at {DISAGG_LAYERS} layers")
    t_json = time.perf_counter()
    jsn = json_serving(torch, ctr, pa, card)
    log(f"  phase 5i took {time.perf_counter() - t_json:.1f} s")

    log("== phase 5j: the device-cost observatory on phase 5e's engine, "
        "gpt2-medium, devprof_sample 1.0")
    t_dp = time.perf_counter()
    dpf = devprof_serving(torch, ctr, pa, card)
    log(f"  phase 5j took {time.perf_counter() - t_dp:.1f} s")

    log("== phase 5k: the chaos soak, gpt2-medium on a 2-replica fleet: "
        "tools/ci.sh's primary, abandonment and sanitized arms")
    t_soak = time.perf_counter()
    sok = soak_serving(torch, ctr, card)
    log(f"  phase 5k took {time.perf_counter() - t_soak:.1f} s")
    torch.cuda.empty_cache()

    log(f"== phase 5l: dispatch-ahead megasteps, gpt2-medium at megastep "
        f"{MEGASTEP}: off against on per pool dtype, forced misses on int8 "
        "pools")
    t_ahead = time.perf_counter()
    ahd = dispatch_ahead_serving(torch, ctr, card)
    log(f"  phase 5l took {time.perf_counter() - t_ahead:.1f} s")

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

    log(f"== phase 21: Transformer-base (nn.Transformer() defaults, batch "
        f"{TB_BATCH}, src = tgt = {TB_SEQ}, O2 bf16, AdamW) through the "
        "non-causal flash kernels and the LayerNorm kernels; incremental "
        "decoding")
    t_tb = time.perf_counter()
    tfm = train_transformer(torch, fa, ctr, card)
    log(f"  phase 21 took {time.perf_counter() - t_tb:.1f} s")

    log(f"== phase 22: bench.py's widedeep step through the static executor "
        f"(26 slots, embed 16, 400 x 400 x 400, batch {WD_BATCH}, "
        f"host-paced PS tier with the pull prefetcher), card against CPU")
    t_wd = time.perf_counter()
    wdp = widedeep(torch, ctr, card)
    log(f"  phase 22 took {time.perf_counter() - t_wd:.1f} s")

    log(f"== phase 23: a static Transformer-base encoder ({SE_LAYERS} "
        f"layers, d {SE_D}, {SE_HEADS} heads, FFN {SE_FFN}, batch "
        f"{SE_BATCH}, seq {SE_SEQ}, f32, AdamW) through the executor: flash "
        "and LayerNorm kernels against the composed routes")
    t_se = time.perf_counter()
    sen = static_encoder(torch, fa, ctr, card, ltimes)
    log(f"  phase 23 took {time.perf_counter() - t_se:.1f} s")

    log("== phase 24: the Book (tests/test_book.py's eight programs through "
        "paddle_tpu_torch.fluid: SRL at hidden 512 / depth 8, resnet_cifar10 "
        "at depth 32, batch 128) and a CTC tagger, card against CPU")
    t_book = time.perf_counter()
    bk = book_phase(torch, ctr, card)
    log(f"  phase 24 took {time.perf_counter() - t_book:.1f} s")

    log(f"== phase 25: control flow and the dense ops: (a) the op sweep, "
        f"card against CPU, eager and captured; (b) phase 23's encoder with "
        f"Transformer-base's warm-up in the Program (layers.case, W "
        f"{CF_WARMUP}) against a fed-lr twin; (c) one encoder layer under "
        f"while_loop, forward at trip counts {CF_TRIPS} and trained with "
        f"max_iters {CF_MAX_ITERS}, against unrolled twins")
    t_cf = time.perf_counter()
    cfl = control_flow_phase(torch, ctr, card, sen)
    log(f"  phase 25 took {time.perf_counter() - t_cf:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()

    log(f"== phase 26: images, detection and quantization: (a) the tail op "
        f"sweep, card against CPU, eager and captured, host ops through the "
        f"executor's split; (b) the YOLOv3 head (configs/yolov3_darknet.yml: "
        f"batch {YOLO_BATCH} at {YOLO_IMAGE}, {YOLO_CLASSES} classes); (c) "
        f"Faster R-CNN's RPN and RoIAlign (configs/faster_rcnn_r50_1x.yml: "
        f"batch {RPN_BATCH}, C4 [{RPN_C}, {RPN_H}, {RPN_W}]); (d) quant_aware "
        f"on resnet_cifar10 (depth {QAT_DEPTH}, batch {QAT_BATCH}), convert, "
        f"post-training quantization")
    t_det = time.perf_counter()
    dtp = detection_phase(torch, ctr, card)
    log(f"  phase 26 took {time.perf_counter() - t_det:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()

    log(f"== phase 27: the Program rewrites on phase 23's encoder ("
        f"{SE_LAYERS} layers, d {SE_D}, batch {SE_BATCH}, seq {SE_SEQ}): "
        f"(a) RecomputeOptimizer against plain AdamW, peak memory; (b) "
        f"gradient merge k {ST_K} under SGD against one whole-batch step; "
        f"(c) fleet.distributed_optimizer with amp, recompute and gradient "
        f"merge (bf16 flash on wgmma); (d) PipelineOptimizer, 2 stages x "
        f"{ST_MB} microbatches, GPipe and 1F1B; (e) EMA, ModelAverage and "
        f"Lookahead; (f) CompiledProgram with a BuildStrategy")
    t_st = time.perf_counter()
    stg = strategy_phase(torch, ctr, ln, card)
    log(f"  phase 27 took {time.perf_counter() - t_st:.1f} s [{card}]")
    log(f"  total {time.perf_counter() - t_start:.1f} s [{card}]")

    def entry(name, route_source, replaces, launches, err, t, **extra):
        return {"name": name, "route": "cuda",
                "source": f"paddle_tpu_torch/csrc/{route_source}",
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "library_ms": t["library_ms"], **extra}

    main_t = times["f32"]
    mega = flt["megastep"]["arms"]["megastep"]
    handoff_errs = lgs["disagg_router"]["kernel_on_handoff_tables"] + [
        r["kernel_max_abs_err"] for r in lgs["cross_pool_kill"].values()]
    promoted_errs = [r["kernel_max_abs_err"]
                     for r in tie["round_trip"].values()]
    json_errs = [jsn[k]["b4_max_abs_err"]
                 for k in ("kernel", "router", "disagg")]
    kernels = [entry("paged_attention", "paged_attention.cu",
                     "paddle_tpu/ops/pallas/paged_attention.py:55",
                     srv["launches"], max(worst, flt["kernel_max_abs_err"],
                                          *handoff_errs, *promoted_errs,
                                          *json_errs),
                     {**main_t, "library_ms": None},
                     cases_passed=n_cases + flt["kernel_cases"] +
                     len(handoff_errs) + len(promoted_errs) +
                     len(json_errs),
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
                     fleet_max_abs_err=flt["kernel_max_abs_err"],
                     launches_loadgen=lgs["launches"],
                     launches_by_route_loadgen=lgs["routes"],
                     by_shape_loadgen=lgs["kernel_times"],
                     launches_disagg=lgs["launches"]["disagg_router"],
                     launches_by_route_disagg=lgs["routes"][
                         "disagg_router"],
                     launches_disagg_cross_pool_kill=lgs["launches"][
                         "cross_pool_kill"],
                     launches_disagg_chaos=lgs["launches"]["disagg_chaos"],
                     launches_http=web["launches"],
                     launches_by_route_http=web["routes"],
                     handoff_tables_max_abs_err=max(handoff_errs),
                     launches_tenants=ten["launches"],
                     launches_by_route_tenants=ten["routes"],
                     launches_host_tier=tie["launches"],
                     launches_by_route_host_tier=tie["routes"],
                     promoted_tables_max_abs_err=max(promoted_errs),
                     launches_json=jsn["launches"],
                     json_tables_max_abs_err=max(json_errs),
                     launches_devprof=dpf["launches"],
                     launches_by_route_devprof=dpf["routes"],
                     launches_soak=sok["launches"],
                     launches_by_route_soak=sok["routes"],
                     launches_dispatch_ahead=ahd["launches"],
                     launches_by_route_dispatch_ahead=ahd["routes"])]
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
            launches_by_route_fp16_gpt=f16["routes"][name],
            noncausal_transformer_base=tfm["flash"][name],
            launches_transformer=tfm["launches"][name],
            launches_by_route_transformer=tfm["routes"][name],
            f32_static_encoder=sen["flash_f32"][name],
            launches_static_encoder=sen["launches"][name],
            launches_by_route_static_encoder=sen["routes"][name],
            launches_control_flow=cfl["launches"][name],
            launches_static_amp=stg["launches"]["flash_static_amp"][name],
            launches_by_route_static_amp=stg["c"]["routes"][name],
            launches_recompute=stg["a"]["recompute"]["launches_per_step"][
                name] * ST_STEPS))
    for name, line in (("ln_fwd", 27), ("ln_bwd", 40)):
        t = ltimes[name]["ernie-base"]
        kernels.append(entry(
            name, "layer_norm.cu",
            f"paddle_tpu/ops/pallas/layer_norm.py:{line}",
            ern["on"]["launches"][name], ln_err[name], t, cases_passed=n_ln,
            library_call=t["library_call"], by_shape=ltimes[name],
            launches_gpt_step=trn_ln["launches"][name],
            launches_captured=ern["captured"]["launches"][name],
            launches_transformer=tfm["launches"][name],
            launches_static_encoder=sen["launches"][name],
            launches_control_flow=cfl["launches"][name]))
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
        launches_optimizer_plane=plane["gpt2_medium"]["launches"]["adamw"],
        launches_transformer=tfm["launches"]["adamw"],
        launches_static_encoder=sen["launches"]["adamw"],
        launches_book=bk["launches"]["adamw"],
        launches_control_flow=cfl["launches"]["adamw"],
        launches_qat=dtp["launches"]["adamw"],
        launches_strategy=stg["launches"]["adamw"]))
    kernels.append(entry(
        "cond_set", "cond_graph.cu", "paddle_tpu/ops/control_flow_ops.py:142",
        cfl["launches"]["cond_set"], cfl["cond_set"]["max_abs_err"],
        cfl["cond_set"], cases_passed=16,
        plain="a host read of the predicate (the path of a run that "
        "captures nothing)", per="IF node",
        launches_warmup_encoder=cfl["warmup"]["cond_set"],
        launches_loop=cfl["loop"]["train"]["cond_set"]))
    nkt = dtp["b"]["kernel"]
    kernels.append(entry(
        "nms_keep", "nms.cu", "paddle_tpu/ops/detection_ops.py:280",
        dtp["launches"]["nms_keep"], nkt["max_abs_err"], nkt,
        cases_passed=nkt["cases_passed"],
        plain="nms_keep_plain: the greedy loop as torch ops over an "
        "overlap mask (the route before this kernel)", shape=nkt["shape"],
        ious=nkt["ious"]))

    def summary(r):
        return {k: summary(v) if isinstance(v, dict) and k != "routes"
                else v for k, v in r.items()
                if k not in ("launches", "final")}

    print(json.dumps({"serving": summary(srv), "serving_modes": modes,
                      "sampled_serving": summary(smp),
                      "dense_serving": summary(dns),
                      "fleet_serving": summary(flt),
                      "loadgen_serving": summary(lgs),
                      "http_serving": summary(web),
                      "tenant_serving": summary(ten),
                      "host_tier_serving": summary(tie),
                      "json_serving": summary(jsn),
                      "devprof_serving": summary(dpf),
                      "dispatch_ahead": summary(ahd), "fp16_gpt": f16,
                      "train": summary(trn), "train_ln": summary(trn_ln),
                      "ernie": summary(ern), "flagship": summary(flag),
                      "adamw": atimes, "optimizer_plane": plane,
                      "resnet50": rn, "grad_scaler": scaler,
                      "transformer_base": summary(tfm),
                      "widedeep": summary(wdp),
                      "static_encoder": summary(sen),
                      "book": summary(bk),
                      "control_flow": summary(cfl),
                      "detection": summary(dtp),
                      "strategy": summary(stg)}), flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
