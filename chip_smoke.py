#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``paddle_tpu_torch``) on one NVIDIA
GPU: builds the hand-written CUDA kernels from this checkout (paged
attention; flash attention forward, dQ and dK/dV), holds each against
its plain PyTorch version on the card, serves GPT-2 345M
(``gpt2-medium``, full width and depth, random weights from a seed)
through the port's ServingEngine and trains it (``bench.py``'s step:
batch 8, seq 1024, AMP O2 bf16, AdamW with bf16 moments), shows that
every attention call of each run went through its kernels, and times
the kernels.

Phases: 1 device, 2 build, 3 paged kernel vs plain, 4 serve, 5 time the
paged kernel, 6 flash kernels vs plain, 7 train, 8 time the flash
kernels.

Usage, from the repository root on a machine with a CUDA card and
``nvcc``:

    python3 chip_smoke.py

Every phase raises on failure; the script then exits nonzero without
printing its result. Its last two lines are the ``kernels`` JSON object
and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
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
BF16_FLOPS = 989e12         # H100 SXM bf16 tensor cores, dense
# kernel vs plain: f32 and int8 differ only in the order of summation
# (the JAX tests' bound); bf16 pools are upcast the same way on both
# sides, so only that order differs there too, over bf16-rounded values
TOL = {"f32": 2e-5, "int8": 2e-5, "bf16": 1e-4}


def log(msg=""):
    print(msg, flush=True)


def counts(pa, fa):
    """Every kernel's launch count, by kernel name."""
    return {"paged_attention": pa.launches, **fa.launches}


def zero_counts(pa, fa):
    pa.launches = 0
    for name in fa.launches:
        fa.launches[name] = 0


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


def check_serving(torch, pa, fa, card):
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
    zero_counts(pa, fa)
    eng, reqs, wall = serve(torch, model, prompts, "f32", "kernel")
    run = counts(pa, fa)
    launches = run["paged_attention"]
    if any(run[name] for name in fa.launches):
        raise AssertionError(f"serving launched flash kernels: {run}")
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

# ------------------------------------------------------------ phase 6
def close(out, ref, kind, tol):
    """(max abs err, ok), element by element: f32 as the JAX tests hold
    it, |out - ref| <= tol (1 + |ref|). The plain side runs in f32 on
    the same bf16 values, and the kernel computes in f32 and rounds each
    bf16 output to nearest once, which adds at most half a unit in the
    last place, 2^-8 |out|: so bf16 is held to (1 + 2^-8) tol (1 + |ref|)
    + 2^-8 |ref|, which a truncated output fails."""
    diff = (out.float() - ref.float()).abs()
    mag = ref.float().abs()
    if kind == "f32":
        limit = tol * (1 + mag)
    else:
        u = 2.0 ** -8
        limit = (1 + u) * tol * (1 + mag) + u * mag
    return float(diff.max()), bool((diff <= limit).all())


def flash_inputs(torch, bh, s_q, s_k, d, dt, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    dtype = {"f32": torch.float32, "bf16": torch.bfloat16}[dt]
    return [torch.randn(bh, s, d, device="cuda", generator=g).to(dtype)
            for s in (s_q, s_k, s_k, s_q)]


def check_flash(torch, fa):
    """Phase 6: each flash kernel against its plain function at b 8 x h 16:
    causal and not, f32 and bf16, d 20 / 64 / 128, s 1024 / 1040 (a ragged
    last 64-row tile), and non-causal s_q != s_k. The backward kernels and
    their plain versions get the same lse and delta."""
    cases = [(dt, causal, d, s, s) for dt in ("f32", "bf16")
             for causal in (True, False) for d in (20, 64, 128)
             for s in (1024, 1040)]
    cases += [("f32", False, 64, 1024, 2048), ("bf16", False, 64, 1040, 512)]
    worst = {name: 0.0 for name in fa.launches}
    saved = dict(fa.launches)
    for i, (dt, causal, d, s_q, s_k) in enumerate(cases):
        q, k, v, do = flash_inputs(torch, 128, s_q, s_k, d, dt, seed=100 + i)
        scale = 1.0 / d ** 0.5
        o, lse = fa.flash_fwd(q, k, v, causal, scale)
        delta = (do.float() * o.float()).sum(-1)
        dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, causal, scale)
        dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal, scale)
        f = [t.float() for t in (q, k, v, do)]
        ro, rlse = fa.flash_fwd_plain(*f[:3], causal, scale)
        rdq = fa.flash_bwd_dq_plain(*f, lse, delta, causal, scale)
        rdk, rdv = fa.flash_bwd_dkv_plain(*f, lse, delta, causal, scale)
        torch.cuda.synchronize()
        # lse is f32 on both sides whatever the input dtype
        checks = [("flash_fwd", "o", o, ro, dt, 2e-5),
                  ("flash_fwd", "lse", lse, rlse, "f32", 2e-5),
                  ("flash_bwd_dq", "dq", dq, rdq, dt, 2e-4),
                  ("flash_bwd_dkv", "dk", dk, rdk, dt, 2e-4),
                  ("flash_bwd_dkv", "dv", dv, rdv, dt, 2e-4)]
        errs = []
        for kernel, what, out, ref, kind, tol in checks:
            if not bool(torch.isfinite(out).all()):
                raise AssertionError(f"flash case {i}: non-finite {what}")
            err, ok = close(out, ref, kind, tol)
            if not ok:
                raise AssertionError(
                    f"flash case {i} ({dt} causal={causal} d={d} s_q={s_q} "
                    f"s_k={s_k}): {what} off by {err}")
            worst[kernel] = max(worst[kernel], err)
            errs.append(f"{what} {err:.1e}")
        log(f"  case {dt:4s} causal={causal!s:5s} d={d:3d} s_q={s_q} "
            f"s_k={s_k}: " + ", ".join(errs))
    fa.launches.update(saved)
    return len(cases), worst


# ------------------------------------------------------------ phase 7
def model_flops_per_token(cfg, seq: int) -> float:
    """Forward matmul FLOPs per token x3 (backward = 2x forward): the
    port's copy of ``bench.py:59-65``."""
    h, f, L, V = (cfg.hidden_size, cfg.ffn_hidden_size, cfg.num_layers,
                  cfg.vocab_size)
    per_layer = 8 * h * h + 4 * h * f + 4 * seq * h  # qkv+out, ffn, attn
    fwd = L * per_layer + 2 * h * V                  # + tied LM head
    return 3.0 * fwd


def train_step(torch, batch=8, seq=1024):
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

    def step(part=lambda name: contextlib.nullcontext()):
        with part("forward"):
            loss = loss_of()
        opt.clear_grad()
        with part("backward"):
            loss.backward()
        with part("optimizer"):
            opt.step()
        return loss.detach()

    return cfg, model, loss_of, step


def train(torch, pa, fa, card, batch=8, seq=1024, warmup=2, steps=5):
    """Phase 7: the train step of :func:`train_step`. First one
    forward+backward with the flash route against the composed route
    from the same weights; then warm-up steps, the timed steps with
    every launch count zeroed before and read after, and one step timed
    by part."""
    from paddle_tpu_torch import flags
    cfg, model, loss_of, step = train_step(torch, batch, seq)

    ref = {}
    for use in (True, False):
        flags.set_flags({"use_pallas_attention": use})
        model.zero_grad(set_to_none=True)
        loss = loss_of()
        loss.backward()
        ref[use] = (float(loss.detach()), {n: p.grad.detach().clone()
                                  for n, p in model.named_parameters()})
    flags.set_flags({"use_pallas_attention": True})
    (lf, gf), (lc, gc) = ref[True], ref[False]
    rel_loss = abs(lf - lc) / abs(lc)
    rel_grad = {}
    for n in gc:
        den = float(gc[n].norm())
        rel_grad[n] = (float((gf[n] - gc[n]).norm()) / den if den
                       else float(gf[n].norm()))
    worst_name = max(rel_grad, key=rel_grad.get)
    log(f"  flash vs composed (O2, one forward+backward): loss {lf} vs {lc} "
        f"(rel {rel_loss:.2e}); worst grad rel Frobenius "
        f"{rel_grad[worst_name]:.2e} ({worst_name})")
    if rel_loss > 1e-2:
        raise AssertionError(f"flash loss {lf} vs composed {lc}")
    bad = {n: e for n, e in rel_grad.items() if e > 5e-2}
    if bad:
        raise AssertionError(f"gradients off by > 5e-2 relative: {bad}")
    del ref, gf, gc
    model.zero_grad(set_to_none=True)
    torch.cuda.empty_cache()

    for _ in range(warmup):
        step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(pa, fa)
    t0 = time.perf_counter()
    losses = [step() for _ in range(steps)]
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / steps
    run = counts(pa, fa)
    peak = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in losses]
    log(f"  launches in {steps} timed steps: {run}")
    want = cfg.num_layers * steps
    if any(run[name] != want for name in fa.launches) or \
            run["paged_attention"]:
        raise AssertionError(f"launch counts {run}: expected {want} of each "
                             "flash kernel and no paged attention")
    log(f"  losses {losses}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"timed losses not finite and falling: {losses}")

    parts = {}

    @contextlib.contextmanager
    def timed_part(name):
        torch.cuda.synchronize()
        t = time.perf_counter()
        yield
        torch.cuda.synchronize()
        parts[f"{name}_ms"] = (time.perf_counter() - t) * 1e3

    step(timed_part)
    fa.launches.update(run)
    tokens_per_s = batch * seq / dt
    mfu = model_flops_per_token(cfg, seq) * tokens_per_s / BF16_FLOPS
    out = {"step_ms": dt * 1e3, "tokens_per_s": tokens_per_s, "mfu": mfu,
           "peak_bytes": peak, "losses": losses, "launches": run,
           "loss_flash": lf, "loss_composed": lc, "rel_loss": rel_loss,
           "worst_grad_rel": rel_grad[worst_name],
           "worst_grad_param": worst_name, **parts}
    log(f"  [{card}] step {out['step_ms']:.3f} ms, {tokens_per_s:.1f} "
        f"tokens/s, MFU {mfu * 100:.3f}% of {BF16_FLOPS:.0f} FLOP/s, "
        f"max_memory_allocated {peak} B; one step by part: forward "
        f"{parts['forward_ms']:.3f} ms, backward {parts['backward_ms']:.3f} "
        f"ms, optimizer {parts['optimizer_ms']:.3f} ms")
    return out


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
    if kernel == "flash_bwd_dq":    # q, k, v, dO, lse, delta -> dq
        return 5 * slab + 2 * stat, 6 * pairs * d * bh
    return 6 * slab + 2 * stat, 8 * pairs * d * bh   # -> dk, dv


def time_flash(torch, fa, card, b=8, h=16, s=1024, d=64):
    """Phase 8: the flash kernels, their plain versions and PyTorch's
    scaled_dot_product_attention (forward; backward = dq, dk and dv in
    one call) at the training shape, bf16, causal."""
    import torch.nn.functional as F
    bh, scale = b * h, 1.0 / d ** 0.5
    q, k, v, do = flash_inputs(torch, bh, s, s, d, "bf16", seed=7)
    o, lse = fa.flash_fwd(q, k, v, True, scale)
    delta = (do.float() * o.float()).sum(-1)
    qd, kd, vd = (t.reshape(b, h, s, d) for t in (q, k, v))
    q4, k4, v4 = (t.detach().requires_grad_() for t in (qd, kd, vd))
    o4 = F.scaled_dot_product_attention(q4, k4, v4, is_causal=True,
                                        scale=scale)
    do4 = do.reshape(b, h, s, d)
    saved = dict(fa.launches)
    calls = {
        "flash_fwd": (lambda i: fa.flash_fwd(q, k, v, True, scale),
                      lambda i: fa.flash_fwd_plain(q, k, v, True, scale),
                      lambda i: F.scaled_dot_product_attention(
                          qd, kd, vd, is_causal=True, scale=scale)),
        "flash_bwd_dq": (
            lambda i: fa.flash_bwd_dq(q, k, v, do, lse, delta, True, scale),
            lambda i: fa.flash_bwd_dq_plain(q, k, v, do, lse, delta, True,
                                            scale), None),
        "flash_bwd_dkv": (
            lambda i: fa.flash_bwd_dkv(q, k, v, do, lse, delta, True, scale),
            lambda i: fa.flash_bwd_dkv_plain(q, k, v, do, lse, delta, True,
                                             scale), None),
    }
    sdpa_bwd = time_fn(torch, lambda i: torch.autograd.grad(
        o4, (q4, k4, v4), do4, retain_graph=True), 20, 1)
    out = {}
    for name, (kern, plain, lib) in calls.items():
        ms = time_fn(torch, kern, 20, 1)
        plain_ms = time_fn(torch, plain, 5, 1)
        lib_ms = time_fn(torch, lib, 20, 1) if lib else sdpa_bwd
        nbytes, flops = flash_work(name, bh, s, d, 2)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / BF16_FLOPS * 1e3
        out[name] = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                     "library_call": ("scaled_dot_product_attention" if lib
                                      else "scaled_dot_product_attention "
                                      "backward (dq, dk and dv together)"),
                     "bound_ms": max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                     "bytes": nbytes, "flops": flops,
                     "tflops_per_s": flops / ms / 1e9}
        log(f"  {name}: kernel {ms:.4f} ms ({flops / ms / 1e9:.2f} TFLOP/s), "
            f"plain {plain_ms:.4f} ms, library {lib_ms:.4f} ms, {nbytes} B / "
            f"{flops} FLOP -> bound {max(t_bytes, t_ops):.4f} ms "
            f"({out[name]['bound_by']}) [{card}]")
    fa.launches.update(saved)
    return out


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this smoke run needs a CUDA card")
    from paddle_tpu_torch.ops.cuda import _build
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.ops.cuda import paged_attention as pa

    t_start = time.perf_counter()
    card = card_line()
    log("== phase 1: device")
    log(f"  {torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}, "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(f"  nvidia-smi: {card}")

    log("== phase 2: build (one nvcc per source, started together)")
    t_build = time.perf_counter()
    _build.load_all(["paged_attention", "flash_attention"])
    log(f"  both built in {time.perf_counter() - t_build:.2f} s")
    for name in ("paged_attention", "flash_attention"):
        info = _build.builds[name]
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
    srv = check_serving(torch, pa, fa, card)
    log(f"  engine [{card}]: {srv['tokens_per_s']:.1f} tokens/s "
        f"({srv['tokens']} tokens in {srv['wall_s']:.3f} s), TTFT p50 "
        f"{srv['ttft_p50_ms']} ms, TPOT p50 {srv['tpot_p50_ms']} ms, "
        f"max_memory_allocated {srv['peak_bytes']} B, prefix hits "
        f"{srv['prefix_hit_requests']}")

    log("== phase 5: time")
    pos, times = time_kernel(torch, pa, card)
    log(f"  decode pos {pos}")
    torch.cuda.empty_cache()

    log("== phase 6: flash kernels vs plain")
    n_flash, flash_err = check_flash(torch, fa)
    log(f"  {n_flash} cases passed, max abs err by kernel {flash_err}")
    torch.cuda.empty_cache()

    log("== phase 7: train gpt2-medium (batch 8, seq 1024, O2 bf16, AdamW "
        "bf16 moments)")
    trn = train(torch, pa, fa, card)
    torch.cuda.empty_cache()

    log("== phase 8: time the flash kernels (b 8, h 16, s 1024, d 64, bf16, "
        "causal)")
    ftimes = time_flash(torch, fa, card)
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
    for name, line in (("flash_fwd", 40), ("flash_bwd_dq", 109),
                       ("flash_bwd_dkv", 141)):
        t = ftimes[name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "paddle_tpu_torch/csrc/flash_attention.cu",
            "replaces": f"paddle_tpu/ops/pallas/flash_attention.py:{line}",
            "cases_passed": n_flash,
            "launches": trn["launches"][name],
            "max_abs_err": flash_err[name],
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "library_call": t["library_call"],
            "tflops_per_s": t["tflops_per_s"],
        })
    print(json.dumps({"train": {k: v for k, v in trn.items()
                                if k != "launches"}}), flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
