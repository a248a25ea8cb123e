"""Times the flash-attention kernels (``csrc/flash_attention.cu``) of this
checkout against those of another checkout of the port, in one process on
one card. Both libraries are built with the same nvcc flags, get the same
inputs (the GPT training shape: b 8, h 16, s 1024, d 64, bf16, causal; the
backward kernels get one lse and delta) and are timed with
``chip_smoke.time_fn`` in the order other, this, this, other, twice.
Prints each build's ptxas register and spill lines, the route each
side's kernels ran on (``wgmma`` when the device kernel that ran, by
name in a ``torch.profiler`` trace, is a tensor-core one, else
``simt``), each kernel's device ms per side and round with this side's
speedup (other / this), the largest difference between the two sides'
outputs and which outputs are bit-equal (a kernel whose code did not
change gives bit-equal outputs; a redesigned one differs by its
rounding); the last line is the same as one JSON object.

Usage, from the repository root on a machine with a CUDA card and nvcc,
with the other checkout unpacked at OTHER (for example ``git archive`` of
an earlier commit):

    python3 -m paddle_tpu_torch.tools.kernel_ab OTHER
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from pathlib import Path

import torch

from chip_smoke import card_line, flash_inputs, time_fn
from torch.profiler import ProfilerActivity, profile

from ..ops.cuda import _build
from ..ops.cuda import flash_attention as fa

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


def build_other(root):
    """Starts nvcc on the other checkout's source; returns the process and
    the library's path."""
    src = Path(root).resolve() / "paddle_tpu_torch" / "csrc" / f"{NAME}.cu"
    if not src.exists():
        raise SystemExit(f"kernel_ab: no {src}")
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = _build.BUILD_DIR / f"{NAME}-other.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), lib


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", help="root of the other checkout")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: torch.cuda.is_available() is false")
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


if __name__ == "__main__":
    main()
