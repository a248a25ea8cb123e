"""Times this checkout's flash-attention kernels
(``csrc/flash_attention.cu``) or its paged-attention kernel
(``csrc/paged_attention.cu``, ``--kernel paged``) against those of
another checkout of the port, in one process on one card. Both libraries
are built with the same nvcc flags, get the same inputs and are timed
with ``chip_smoke.time_fn`` in the order other, this, this, other, twice.
Prints each build's ptxas register and spill lines, each kernel's device
ms per side and round with this side's speedup (other / this), and the
largest difference between the two sides' outputs; the last line is the
same as one JSON object.

Flash (the default): the GPT training shape (b 8, h 16, s 1024, d 64,
bf16, causal; the backward kernels get one lse and delta); also the route
each side's kernels ran on (``wgmma`` when the device kernel that ran, by
name in a ``torch.profiler`` trace, is a tensor-core one, else ``simt``)
and which outputs are bit-equal (a kernel whose code did not change gives
bit-equal outputs; a redesigned one differs by its rounding).

Paged: ``chip_smoke.py`` phase 5's shapes, decode (b 8, h 16, s 1, d 64,
blocks of 16, pos 180-220) with f32, bf16 and int8 pools over 8 cold
pool copies, and the 64-row prefill bucket (s 64, pos 0, f32). The other
side may be a checkout with the first design's C interface (its wrapper
has no ``plan()``), which is called directly, or one with this
checkout's, which runs through this wrapper. Outputs are not bit-equal
across designs that sum in another order. Beside each shape it times
this checkout's read probe (``paged_attention.read_probe``: the same
plan, table walk and copies of every valid K/V row, no math) and
``torch.sum`` over a float32 tensor of the bytes the call must move (8
copies, cold): what moving those bytes costs through this design and
through one plain reduction, yardsticks for the bound, not the same
function.

Usage, from the repository root on a machine with a CUDA card and nvcc,
with the other checkout unpacked at OTHER (for example ``git archive`` of
an earlier commit):

    python3 -m paddle_tpu_torch.tools.kernel_ab OTHER [--kernel paged]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from pathlib import Path

import numpy as np
import torch

from chip_smoke import (F32_FLOPS, bound, card_line, decode_work,
                        flash_inputs, make_inputs, time_fn)
from torch.profiler import ProfilerActivity, profile

from ..ops.cuda import _build
from ..ops.cuda import flash_attention as fa
from ..ops.cuda import paged_attention as pa

NAME = "flash_attention"
KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")


def ptxas_lines(log):
    return [line.strip() for line in log.splitlines()
            if "registers" in line or "spill" in line or "Compiling" in line]


def kernels_run(fn):
    """Names of the device kernels that ``fn()`` ran."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.key for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def build_other(root, name=NAME):
    """Starts nvcc on the other checkout's source of kernel ``name``;
    returns the process and the library's path."""
    src = Path(root).resolve() / "paddle_tpu_torch" / "csrc" / f"{name}.cu"
    if not src.exists():
        raise SystemExit(f"kernel_ab: no {src}")
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = _build.BUILD_DIR / f"{name}-other.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), lib


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", help="root of the other checkout")
    ap.add_argument("--kernel", choices=("flash", "paged"), default="flash")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: torch.cuda.is_available() is false")
    if args.kernel == "paged":
        return paged_ab(args.other)
    proc, path = build_other(args.other)
    libs = {"this": _build.load(NAME)}
    fa._lib()           # sets the C signatures on this library
    log, _ = proc.communicate()
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on the other {NAME}.cu:\n{log}")
    libs["other"] = ctypes.CDLL(str(path))
    for fn in ("flash_fwd_launch", "flash_bwd_dq_launch",
               "flash_bwd_dkv_launch", "flash_error_string"):
        getattr(libs["other"], fn).argtypes = getattr(libs["this"],
                                                      fn).argtypes
        getattr(libs["other"], fn).restype = getattr(libs["this"], fn).restype
    logs = {"this": _build.builds[NAME]["log"], "other": log}
    card = card_line()
    for side in ("other", "this"):
        for line in ptxas_lines(logs[side]):
            print(f"{side} ptxas: {line}", flush=True)

    def use(side):      # every launch of the wrappers loads _libs[NAME]
        _build._libs[NAME] = libs[side]

    b, h, s, d = 8, 16, 1024, 64
    scale = 1.0 / d ** 0.5
    q, k, v, do = flash_inputs(torch, b * h, s, s, d, "bf16", seed=7)
    use("this")
    o, lse = fa.flash_fwd(q, k, v, True, scale)
    delta = (do.float() * o.float()).sum(-1)
    calls = {
        "flash_fwd": lambda i: fa.flash_fwd(q, k, v, True, scale),
        "flash_bwd_dq": lambda i: fa.flash_bwd_dq(q, k, v, do, lse, delta,
                                                  True, scale),
        "flash_bwd_dkv": lambda i: fa.flash_bwd_dkv(q, k, v, do, lse, delta,
                                                    True, scale),
    }
    outs, routes = {}, {}
    for side in libs:
        use(side)
        fwd = calls["flash_fwd"](0)
        outs[side] = [*fwd, calls["flash_bwd_dq"](0),
                      *calls["flash_bwd_dkv"](0)]
        routes[side] = {}
        for kern in KERNELS:
            names = kernels_run(lambda: calls[kern](0))
            routes[side][kern] = ("wgmma" if any("wgmma" in n for n in names)
                                  else "simt")
        print(f"{side} routes: {routes[side]}", flush=True)
    torch.cuda.synchronize()
    diff = {name: float((a.float() - c.float()).abs().max())
            for name, a, c in zip(("o", "lse", "dq", "dk", "dv"),
                                  outs["this"], outs["other"])}
    equal = [name for name, a, c in zip(("o", "lse", "dq", "dk", "dv"),
                                        outs["this"], outs["other"])
             if torch.equal(a, c)]
    print(f"max |this - other| by output: {diff}; bit-equal: {equal}",
          flush=True)

    ms = {side: {kern: [] for kern in KERNELS} for side in libs}
    for r, side in enumerate(("other", "this", "this", "other") * 2):
        use(side)
        for kern in KERNELS:
            ms[side][kern].append(time_fn(torch, calls[kern], 20, 1))
        print(f"round {r} {side}: " + ", ".join(
            f"{kern} {ms[side][kern][-1]:.4f} ms" for kern in KERNELS)
            + f" [{card}]", flush=True)
    use("this")
    for kern in KERNELS:
        a = sum(ms["this"][kern]) / len(ms["this"][kern])
        c = sum(ms["other"][kern]) / len(ms["other"][kern])
        print(f"{kern}: this {a:.4f} ms, other {c:.4f} ms, this / other "
              f"{a / c:.4f}, speedup {c / a:.2f}x [{card}]", flush=True)
    print(json.dumps({"card": card, "shape": [b, h, s, d], "ms": ms,
                      "max_abs_diff": diff, "bit_equal": equal,
                      "routes": routes,
                      "ptxas": {side: ptxas_lines(logs[side])
                                for side in logs}}), flush=True)


PAGED = "paged_attention"


def _first_design_launcher(lib):
    """A call of the first design's ``paged_attention_launch`` (no plan
    arguments)."""
    fn = lib.paged_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 +
                   [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                    ctypes.c_void_p])
    fn.restype = ctypes.c_int

    def run(q, kp, vp, tables, posv, k_scale=None, v_scale=None):
        b, h, s, d = q.shape
        out = torch.empty_like(q)
        rc = fn(q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                k_scale.data_ptr() if k_scale is not None else None,
                v_scale.data_ptr() if v_scale is not None else None,
                tables.data_ptr(), posv.data_ptr(), out.data_ptr(), b, h, s,
                d, kp.shape[0], kp.shape[2], tables.shape[1], d ** -0.5,
                pa._Q_CODES[q.dtype], pa._KV_CODES[kp.dtype],
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"the other paged_attention_launch failed "
                               f"({rc})")
        return out

    return run


def paged_ab(other_root):
    """The paged-attention kernel of this checkout against the other's."""
    proc, path = build_other(other_root, PAGED)
    this = _build.load(PAGED)
    pa._lib()           # sets the C signatures on this library
    log, _ = proc.communicate()
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on the other {PAGED}.cu:\n{log}")
    other = ctypes.CDLL(str(path))
    logs = {"this": _build.builds[PAGED]["log"], "other": log}
    card = card_line()
    for side in ("other", "this"):
        for line in ptxas_lines(logs[side]):
            print(f"{side} ptxas: {line}", flush=True)

    def through_wrapper(lib):
        def run(*args, **kw):
            _build._libs[PAGED] = lib
            return pa.paged_attention(*args, **kw)
        return run

    wrapper = (Path(other_root) / "paddle_tpu_torch" / "ops" / "cuda" /
               "paged_attention.py")
    interface = ("this" if "\ndef plan(" in wrapper.read_text()
                 else "first design")
    print(f"other side's C interface: {interface}", flush=True)
    call = {"this": through_wrapper(this),
            "other": (through_wrapper(other) if interface == "this"
                      else _first_design_launcher(other))}
    rng = np.random.RandomState(1)
    pos = [int(p) for p in rng.randint(180, 221, size=8)]
    copies = 8
    shapes = [(f"decode {kv}", kv, pos, 1) for kv in ("f32", "bf16", "int8")]
    shapes.append(("prefill f32", "f32", [0] * 8, 64))
    ms, diff, bounds, floor, probe = {}, {}, {}, {}, {}
    for name, kv, ps, s in shapes:
        q, pools, tables, posv = make_inputs(torch, ps, s, 64, kv, seed=7,
                                             copies=copies)
        kp, vp, ks, vs = pools[0]
        outs = {side: call[side](q, kp, vp, tables, posv, k_scale=ks,
                                 v_scale=vs) for side in call}
        torch.cuda.synchronize()
        diff[name] = float((outs["this"].float()
                            - outs["other"].float()).abs().max())
        nbytes, flops = decode_work(ps, s, 16, 64, kv, 16)
        bounds[name] = bound(nbytes, flops, F32_FLOPS)["bound_ms"]
        xs = [torch.randn(nbytes // 4, device="cuda") for _ in range(copies)]
        floor[name] = time_fn(torch, lambda i: xs[i].sum(), 200, copies)
        del xs

        def read(i):
            kp, vp, ks, vs = pools[i]
            _build._libs[PAGED] = this
            pa.read_probe(q, kp, vp, tables, posv, k_scale=ks, v_scale=vs)
        probe[name] = time_fn(torch, read, 200, copies)
        ms[name] = {"this": [], "other": []}
        for r, side in enumerate(("other", "this", "this", "other") * 2):
            def fn(i, side=side):
                kp, vp, ks, vs = pools[i]
                call[side](q, kp, vp, tables, posv, k_scale=ks, v_scale=vs)
            ms[name][side].append(time_fn(torch, fn, 200, copies))
            print(f"{name} round {r} {side}: {ms[name][side][-1]:.4f} ms "
                  f"[{card}]", flush=True)
    _build._libs[PAGED] = this
    for name in ms:
        a = sum(ms[name]["this"]) / len(ms[name]["this"])
        c = sum(ms[name]["other"]) / len(ms[name]["other"])
        print(f"{name}: this {a:.4f} ms, other {c:.4f} ms, bound "
              f"{bounds[name]:.4f} ms, read probe {probe[name]:.4f} ms, "
              f"torch.sum over the same bytes {floor[name]:.4f} ms, "
              f"speedup {c / a:.2f}x, max |this - other| "
              f"{diff[name]:.3e} [{card}]", flush=True)
    print(json.dumps({"card": card, "kernel": PAGED, "pos": pos, "ms": ms,
                      "bound_ms": bounds, "read_probe_ms": probe,
                      "sum_same_bytes_ms": floor,
                      "max_abs_diff": diff,
                      "other_interface": interface,
                      "ptxas": {side: ptxas_lines(logs[side])
                                for side in logs}}), flush=True)


if __name__ == "__main__":
    main()
