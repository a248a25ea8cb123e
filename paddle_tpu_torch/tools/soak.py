#!/usr/bin/env python
"""Virtual-clock chaos soak: hours of diurnal fleet traffic, with a
seeded kill/restart schedule, in seconds of wall time; the port's own
copy of ``tools/soak.py``.

The harness composes three replayable pieces:

- :class:`~paddle_tpu_torch.tools.loadgen.LoadGen` in ``diurnal`` mode
  on a :class:`~paddle_tpu_torch.tools.loadgen.VirtualClock` — a whole
  traffic "day" (``--hours``) compresses into seconds because the loop
  jumps idle gaps and only pays real time per scheduler step;
- the fault injector's virtual-time triggers: the kill schedule is a
  plain ``FLAGS_fault_spec`` string of ``serving.replica:error@t>Ns``
  clauses with the injector's clock pointed at the *same* virtual
  clock (``resilience.fault_scope(time_source=)``), so a given
  ``--seed`` + ``--hours`` + ``--kills`` replays the exact same crashes
  at the exact same virtual instants;
- the :class:`~paddle_tpu_torch.serving.ReplicaRouter` fault-tolerance
  plane: each injected crash kills a replica mid-flight (queued work
  re-homes, in-flight decodes re-prefill from committed tokens on
  survivors) and — under ``FLAGS_serving_auto_restart`` — brings a
  replacement up at the same geometry.

Throughout, the harness asserts the reference's **graceful degradation
contract**:

- goodput stays > 0 in every traffic window that offered load
  (``--windows`` equal slices of the run);
- the accounting identity ``completed + rehomed + shed + canceled ==
  offered`` holds;
- zero leaked KV blocks and zero leaked LoRA pages after the fleet
  drains (dead replicas included);
- zero unhandled exceptions;
- zero new compiles after warm-up, and
  :func:`~paddle_tpu_torch.analysis.recompile.predict_serving_compiles`
  proves statically that the kill/restart/re-home/cancel/hedge counts
  are no-ops (``predictor_noop``);
- with hedged prefill on (``--hedge-ms``) fired hedges stay inside the
  token-bucket envelope ``1 + budget * offered``; with abandonment on
  (``--closed-loop N --abandon-frac F``) the canceled bucket joins the
  identity and the fleet still drains leak-free;
- under ``FLAGS_sanitize_locks=1`` (+ ``--expect-sanitizer-clean``),
  zero lock-order cycles and zero guarded-state violations; the record
  carries ``analysis.sanitizer_report()`` either way. The flag must be
  in the environment at start, so the locks made at import (the
  capture lock, the metrics registry) are sanitized too.

Compiles, in the port: on the CPU a compile is a new input signature of
the model's shared step cache, so the reference's rule holds as it is
(0 new compiles after warm-up, fleet-wide). On the card it is a
captured CUDA graph, held over one engine's pools, so a restarted or
autoscaled replica (new pools) captures graphs of its own. Each arm
therefore attributes every compile to the engine whose pools the step
held: ``captures_warm_engines`` (engines present at warm-up; must be
0), ``captures_replacements`` (one count per engine built after it;
each at most ``warm_engine_graphs``, the most any engine captured in
the warm-up). ``--expect-zero-new-compiles`` checks both, and on the
CPU the total too.

``--sweep`` reruns the identical workload + kill schedule across
:class:`~paddle_tpu_torch.serving.AutoscalePolicy` bounds and emits the
cost-vs-goodput frontier (replica-seconds provisioned vs SLO-met
completions/s), written with the rest of the record to ``--out`` when
given (nothing is written otherwise). Every request carries a trace
(virtual-clock timestamps), so the per-window report also includes the
SLO burn rate and TTFT percentiles, the record the fleet blame summary,
and ``--trace-out`` exports the arm as Perfetto-loadable chrome-trace
JSON, identical across same-seed runs.

CLI, from the repository root (on the card; ``--device cpu`` runs on
the CPU, for a small model); ``--expect-*`` gates exit nonzero::

    python3 -m paddle_tpu_torch.tools.soak --device cpu --hours 2 \\
        --kills 2 --replicas 2 --seed 0 --json --expect-kills-min 2 \\
        --expect-goodput-every-window --expect-zero-leaks \\
        --expect-zero-new-compiles --expect-identity
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional, Tuple

_SERVING = ("serving_", "decode_", "verify_")


def kill_spec(duration: float, kills: int,
              site: str = "serving.replica") -> str:
    """The seeded kill schedule as a fault-spec string: ``kills``
    crashes spread evenly across the run (at 1/(k+1), 2/(k+1), ...
    of ``duration``), each a one-shot virtual-time trigger."""
    ts = [int(duration * (i + 1) / (kills + 1))
          for i in range(kills)]
    return ";".join(f"{site}:error@t>{t}s" for t in ts)


def _hedge_budget_flag() -> float:
    from .. import flags as _fl
    return float(_fl.get_flags(["serving_hedge_budget"])
                 ["serving_hedge_budget"])


def _windows(report: dict, n: int) -> List[dict]:
    """Per-window offered/completed/goodput over [0, makespan]: the
    continuous form of the degradation contract. Completions land in
    the window their ``done_t`` falls in."""
    span = max(report["makespan_s"], 1e-9)
    w = span / n
    out = [{"window": i, "t0": round(i * w, 3),
            "t1": round((i + 1) * w, 3), "offered": 0,
            "completed": 0, "goodput_per_s": 0.0}
           for i in range(n)]
    for rec in report["trace"]:
        wi = min(int(rec["t"] / w), n - 1)
        out[wi]["offered"] += 1
        if rec["outcome"] == "done" and rec.get("done_t") is not None:
            wj = min(int(rec["done_t"] / w), n - 1)
            out[wj]["completed"] += 1
    for row in out:
        row["goodput_per_s"] = round(row["completed"] / w, 4)
    return out


class _CaptureLedger:
    """Compiles attributed to the engine whose KV pool the compiling
    step held (the first held tensor), resolved among the router's live
    engines at the moment of the compile: a pool freed by a kill may be
    reused at the same address by its replacement."""

    def __init__(self, rt):
        from ..analysis import concurrency as _ccz
        self.rt = rt
        self.by_engine = {}          # id(engine) -> compiles
        self._lock = _ccz.make_lock("soak.captures")

    def note(self, name, labels, args):
        held = args[-1] if args else None
        if not held or not held[0]:
            return
        ptr = held[0][0].data_ptr()
        for eng in list(self.rt.engines):
            arrays = eng.cache.arrays()
            if arrays and arrays[0][0].data_ptr() == ptr:
                with self._lock:
                    self.by_engine[id(eng)] = \
                        self.by_engine.get(id(eng), 0) + 1
                return

    def count(self, eng) -> int:
        with self._lock:
            return self.by_engine.get(id(eng), 0)


def run_arm(model, lg, args, *,
            autoscale: Optional[Tuple[int, int]] = None,
            fault_spec: str = "", on_fleet=None) -> dict:
    """One soak arm: fresh fleet, same schedule, same kill times. The
    fleet runs on the model's device. ``on_fleet(router)`` is called
    after the warm-up, just before the traffic starts (a caller that
    counts what the run launches zeroes its counts there)."""
    from .. import observability as _obs
    from ..observability import compile_tracker as _ct
    from ..observability import tracing as _tracing
    from ..resilience import fault_scope
    from ..serving import AutoscalePolicy, ReplicaRouter
    from .loadgen import VirtualClock, warmup

    # fresh trace store per arm: every span in the export belongs to
    # THIS run, and two same-seed soaks export identical traces
    _tracing.reset()
    vc = VirtualClock()
    rt = ReplicaRouter(
        model, n_replicas=args.replicas,
        autoscale=(None if autoscale is None else AutoscalePolicy(
            min_replicas=autoscale[0], max_replicas=autoscale[1])),
        max_slots=args.slots, max_len=args.max_len,
        max_queue=args.max_queue,
        buckets=[int(b) for b in args.buckets.split(",")],
        clock=vc.now, slo_ttft_ms=args.slo_ttft_ms,
        slo_prefill_ms=args.slo_prefill_ms,
        slo_tpot_ms=args.slo_tpot_ms,
        hedge_ms=args.hedge_ms, hedge_budget=args.hedge_budget,
        device=model.device)
    # (virtual time, live replicas) samples -> provisioned-cost
    # integral; gap jumps charge the count at the previous sample
    samples: List[Tuple[float, int]] = []

    def on_step(_i):
        samples.append((vc.now(), len(rt.engines)))

    ledger = _CaptureLedger(rt)
    with fault_scope(fault_spec, seed=args.fault_seed,
                     time_source=vc.now), _ct.watch(ledger.note):
        # warmup INSIDE the scope: entering it bumps the flag-plane
        # version, which retires every step entry — warming up outside
        # would hand the run a cold step cache. Safe because the virtual
        # clock doesn't advance during warmup, so @t>Ns triggers stay
        # dormant. The port's sampled rows replay graphs of their own,
        # warmed too when the trace samples.
        warmup(rt, sampled=any(a.temperature > 0 for a in lg.schedule()))
        base = {k: v["count"] for k, v in _obs.compiles().items()
                if k.startswith(_SERVING)}
        warm = list(rt.engines)
        warm_graphs = max(ledger.count(e) for e in warm)
        warm_base = {id(e): ledger.count(e) for e in warm}
        samples.append((vc.now(), len(rt.engines)))
        if on_fleet is not None:
            on_fleet(rt)
        report = lg.run(rt, clock=vc, step_cost_ms=args.step_ms,
                        slo_ttft_ms=args.slo_ttft_ms or None,
                        include_trace=True,
                        max_steps=args.max_steps, on_step=on_step)
    report["new_compiles_after_warmup"] = sum(
        v["count"] - base.get(k, 0)
        for k, v in _obs.compiles().items() if k.startswith(_SERVING))
    warm_ids = set(warm_base)
    report["captures_warm_engines"] = sum(
        ledger.count(e) - warm_base[id(e)] for e in warm)
    report["captures_replacements"] = [
        ledger.count(e) for e in sorted(
            (e for e in rt.engines + rt._retiring
             if id(e) not in warm_ids), key=lambda e: int(e._eid))]
    report["warm_engine_graphs"] = warm_graphs
    samples.append((vc.now(), len(rt.engines)))
    cost = sum((samples[i + 1][0] - samples[i][0]) * samples[i][1]
               for i in range(len(samples) - 1))
    st = rt.stats()
    report["replica_seconds"] = round(cost, 3)
    report["kills"] = st["kills"]
    report["restarts"] = st["restarts"]
    report["fleet_rehomed"] = st["rehomed"]
    report["health"] = st["health"]
    report["replicas_final"] = st["replicas"]
    return report


def compiles_ok(report: dict, device_type: str) -> bool:
    """The zero-new-compiles gate: every compile of the run is
    attributed to an engine, no engine present at warm-up compiled, no
    replacement compiled more than a warmed engine did, and on the CPU
    (one signature set per fleet) nothing compiled at all."""
    reps = report["captures_replacements"]
    if report["new_compiles_after_warmup"] != \
            report["captures_warm_engines"] + sum(reps):
        return False
    if report["captures_warm_engines"] != 0:
        return False
    if any(c > report["warm_engine_graphs"] for c in reps):
        return False
    return device_type == "cuda" or report["new_compiles_after_warmup"] == 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="virtual-clock chaos soak for the serving fleet")
    ap.add_argument("--model", default="gpt2-tiny")
    ap.add_argument("--device", default=None,
                    help="'cpu' runs on the CPU; default the CUDA card "
                    "(raises without one)")
    ap.add_argument("--hours", type=float, default=2.0,
                    help="simulated traffic span (virtual hours)")
    ap.add_argument("--rate", type=float, default=0.02,
                    help="mean arrival rate, requests per VIRTUAL "
                    "second (0.02 over 2h ~ 144 requests)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fault-seed", type=int, default=0)
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--kills", type=int, default=2,
                    help="replica crashes injected, spread evenly "
                    "across the run (serving.replica@t>Ns triggers)")
    ap.add_argument("--fault-spec", default=None,
                    help="override the generated kill schedule with "
                    "an explicit FLAGS_fault_spec string")
    ap.add_argument("--windows", type=int, default=8,
                    help="equal traffic windows the degradation "
                    "contract is asserted over")
    ap.add_argument("--sweep", default="",
                    metavar="MIN:MAX,MIN:MAX",
                    help="autoscale bounds to sweep for the cost-vs-"
                    "goodput frontier (e.g. '1:2,2:2,2:4')")
    ap.add_argument("--prompt-tokens", default="4:16", metavar="LO:HI")
    ap.add_argument("--new-tokens", default="2:8", metavar="LO:HI")
    ap.add_argument("--sample-frac", type=float, default=0.0)
    ap.add_argument("--closed-loop", type=int, default=0,
                    help="> 0 runs N closed-loop clients instead of "
                    "open-loop release (needed for --abandon-frac)")
    ap.add_argument("--abandon-frac", type=float, default=0.0,
                    help="fraction of closed-loop clients that hang "
                    "up mid-decode (fleet cancels; the canceled "
                    "bucket joins the accounting identity)")
    ap.add_argument("--hedge-ms", type=float, default=0.0,
                    help="router hedged prefill threshold/delay in "
                    "virtual ms (> 0 fixed, -1 auto TTFT p95, 0 off)")
    ap.add_argument("--hedge-budget", type=float, default=None,
                    help="hedge token-bucket refill per offered "
                    "request (default FLAGS_serving_hedge_budget)")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--max-queue", type=int, default=32)
    ap.add_argument("--buckets", default="16,32")
    ap.add_argument("--megastep", type=int, default=1, metavar="N",
                    help="> 1 soaks with decode megasteps "
                    "(FLAGS_serving_megastep): N decode iterations per "
                    "dispatch, one host commit per megastep; tokens "
                    "stay identical to N=1")
    ap.add_argument("--dispatch-threads", type=int, default=0,
                    metavar="T", help="> 0 steps the fleet from a "
                    "bounded pool of T threads "
                    "(FLAGS_serving_dispatch_threads); 0 keeps the "
                    "serial deterministic loop")
    ap.add_argument("--step-ms", type=float, default=5.0,
                    help="virtual cost per scheduler step")
    ap.add_argument("--slo-ttft-ms", type=float, default=60000.0,
                    help="TTFT SLO in virtual ms (goodput numerator)")
    ap.add_argument("--slo-prefill-ms", type=float, default=20.0)
    ap.add_argument("--slo-tpot-ms", type=float, default=5.0)
    ap.add_argument("--max-steps", type=int, default=500_000)
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--out", default="",
                    help="write the soak record (windows + frontier) "
                    "to this path; nothing is written without it")
    ap.add_argument("--ledger", default="", metavar="PATH",
                    help="append the primary arm's headline metrics "
                    "as one perf-ledger JSONL row")
    ap.add_argument("--trace-out", default="", metavar="PATH",
                    help="export the primary arm's per-request span "
                    "traces as Perfetto-loadable chrome-trace JSON "
                    "(virtual-clock timestamps: identical across "
                    "same-seed runs)")
    ap.add_argument("--slo-target", type=float, default=0.99,
                    help="SLO attainment target the per-window burn "
                    "rate is measured against (burn = (1 - "
                    "attainment) / (1 - target); default 0.99)")
    ap.add_argument("--expect-kills-min", type=int, default=None,
                    help="exit 1 unless the primary arm killed+"
                    "restarted at least this many replicas")
    ap.add_argument("--expect-goodput-every-window",
                    action="store_true",
                    help="exit 1 if any window that offered load "
                    "completed nothing")
    ap.add_argument("--expect-zero-leaks", action="store_true")
    ap.add_argument("--expect-zero-new-compiles", action="store_true")
    ap.add_argument("--expect-identity", action="store_true",
                    help="exit 1 unless completed + rehomed + shed + "
                    "canceled (+ rejects/errors) == offered")
    ap.add_argument("--expect-hedge-budget-respected",
                    action="store_true",
                    help="exit 1 unless fired hedges <= 1 + "
                    "hedge_budget * offered (the token-bucket "
                    "envelope; requires --hedge-ms)")
    ap.add_argument("--expect-sanitizer-clean", action="store_true",
                    help="exit 1 unless FLAGS_sanitize_locks was on, "
                    "the sanitizer instrumented lock traffic, and it "
                    "recorded zero lock-order cycles and zero "
                    "guarded-state violations")
    return ap


def fresh_lg(args, vocab_size: int):
    """One load generator per arm (records are per run) from the CLI's
    traffic options; the same seed, so every arm fights the identical
    schedule."""
    from .loadgen import LoadGen

    def parse_range(s):
        lo, hi = (int(p) for p in s.split(":"))
        return lo, hi

    return LoadGen(
        mode="diurnal", rate=args.rate, duration=args.hours * 3600.0,
        seed=args.seed, vocab_size=vocab_size,
        prompt_tokens=parse_range(args.prompt_tokens),
        new_tokens=parse_range(args.new_tokens),
        sample_frac=args.sample_frac,
        closed_loop=args.closed_loop,
        abandon_frac=args.abandon_frac)


def soak(model, args, *, on_fleet=None) -> dict:
    """The whole soak of the CLI on ``model``: the primary arm under the
    kill schedule (``on_fleet`` as :func:`run_arm`'s), its windows, burn
    rates and blame, the predictor's no-op proof, the ``--sweep`` arms
    and the sanitizer's report. Returns the record (``--json`` prints
    it); a sweep arm that broke the contract raises."""
    from ..analysis import concurrency as _ccz
    from ..analysis import predict_serving_compiles
    from ..observability import tracing as _tracing

    duration = args.hours * 3600.0
    vocab = model.cfg.vocab_size
    spec = (args.fault_spec if args.fault_spec is not None
            else kill_spec(duration, args.kills))

    # ---- primary arm: fixed fleet under the kill schedule ----------
    lg = fresh_lg(args, vocab)
    report = run_arm(model, lg, args, fault_spec=spec, on_fleet=on_fleet)
    windows = _windows(report, args.windows)

    # ---- tracing view of the same arm: burn rate + blame -----------
    # (snapshot BEFORE the sweep arms reset the trace store)
    snaps = _tracing.window_snapshots(
        args.windows, max(report["makespan_s"], 1e-9),
        slo_ttft_ms=args.slo_ttft_ms, slo_target=args.slo_target)
    for row, snap in zip(windows, snaps):
        row["attainment"] = snap["attainment"]
        row["burn_rate"] = snap["burn_rate"]
        row["ttft_ms_p50"] = snap["ttft_ms_p50"]
        row["ttft_ms_p95"] = snap["ttft_ms_p95"]
    blame = _tracing.blame_summary()
    if args.trace_out:
        _tracing.export_chrome_trace(args.trace_out)
    report.pop("trace")
    errored = sum(1 for d in report["decisions"]
                  if d[0] in ("invalid", "error"))
    report.pop("decisions")
    identity_ok = (report["completed"] + report["rehomed"] +
                   report["shed_total"] + report["canceled_total"] +
                   errored == report["offered"])

    # ---- the static half of the zero-new-compiles proof ------------
    lg_workload = [[(list(a.prompt), a.max_new_tokens)
                    for a in lg.schedule()]]
    pkw = dict(buckets=[int(b) for b in args.buckets.split(",")],
               max_len=args.max_len, n_replicas=args.replicas,
               slo_ttft_ms=args.slo_ttft_ms,
               megastep=args.megastep)
    plain_pred = predict_serving_compiles(lg_workload, **pkw)
    hedges_fired = int(report.get("hedges", {}).get("fired", 0))
    chaos_pred = predict_serving_compiles(
        lg_workload, replica_kills=report["kills"],
        restarts=report["restarts"], rehomed=report["rehomed"],
        cancel=report["canceled_total"], hedge=hedges_fired,
        **pkw)

    # ---- autoscale sweep: cost-vs-goodput frontier -----------------
    frontier = [{
        "arm": f"fixed-{args.replicas}",
        "autoscale": None,
        "replica_seconds": report["replica_seconds"],
        "goodput_per_s": report["goodput_per_s"],
        "slo_attainment": report["slo_attainment"],
        "completed": report["completed"],
        "rehomed": report["rehomed"],
        "shed_total": report["shed_total"],
        "kills": report["kills"],
        "restarts": report["restarts"],
    }]
    device_type = model.device.type
    for bounds_s in [b for b in args.sweep.split(",") if b]:
        lo, hi = (int(p) for p in bounds_s.split(":"))
        arm = run_arm(model, fresh_lg(args, vocab), args,
                      autoscale=(lo, hi), fault_spec=spec)
        arm.pop("trace")
        arm.pop("decisions")
        frontier.append({
            "arm": f"auto-{lo}:{hi}", "autoscale": [lo, hi],
            "replica_seconds": arm["replica_seconds"],
            "goodput_per_s": arm["goodput_per_s"],
            "slo_attainment": arm["slo_attainment"],
            "completed": arm["completed"],
            "rehomed": arm["rehomed"],
            "shed_total": arm["shed_total"],
            "kills": arm["kills"],
            "restarts": arm["restarts"],
        })
        if arm["exceptions"] or arm["leaked_kv_blocks"] or \
                not compiles_ok(arm, device_type):
            raise RuntimeError(
                f"sweep arm {bounds_s} broke the contract: "
                f"{arm['exceptions']} exceptions, "
                f"{arm['leaked_kv_blocks']} leaked blocks, "
                f"{arm['new_compiles_after_warmup']} new compiles "
                f"({arm['captures_warm_engines']} by warm engines, "
                f"{arm['captures_replacements']} by replacements)")

    out = {
        "bench": "soak_fleet_fault_tolerance",
        "model": args.model,
        "simulated_hours": args.hours,
        "seed": args.seed,
        "fault_spec": spec,
        "report": report,
        "windows": windows,
        "blame": blame,
        "slo_target": args.slo_target,
        "burn_rate": [row["burn_rate"] for row in windows],
        "predictor_noop": chaos_pred == plain_pred,
        "identity_ok": identity_ok,
        "hedge_budget_ok": (
            hedges_fired <= 1 + (args.hedge_budget if args.hedge_budget
                                 is not None else _hedge_budget_flag())
            * report["offered"]) if args.hedge_ms != 0.0 else None,
        "frontier": frontier,
        # the concurrency sanitizer's verdict over every arm
        "sanitizer": _ccz.sanitizer_report(),
    }
    if args.trace_out:
        out["trace_out"] = args.trace_out
    return out


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import torch

    from .. import flags as _fl
    from ..device import resolve_device
    from ..models.gpt import GPT_CONFIGS, GPTForCausalLM

    if args.megastep < 1:
        print("FAIL: --megastep must be >= 1", file=sys.stderr)
        return 1
    if args.dispatch_threads < 0:
        print("FAIL: --dispatch-threads must be >= 0", file=sys.stderr)
        return 1
    device = resolve_device(args.device)
    if args.megastep > 1 or args.dispatch_threads > 0:
        # flags reach every engine the arms construct, including
        # watchdog-restarted replicas mid-soak
        _fl.set_flags({"serving_megastep": args.megastep,
                       "serving_dispatch_threads": args.dispatch_threads})

    cfg = GPT_CONFIGS[args.model]
    gen = torch.Generator(device=device).manual_seed(0)
    model = GPTForCausalLM(cfg, device=device, generator=gen).eval()

    try:
        out = soak(model, args)
    except RuntimeError as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    report, windows = out["report"], out["windows"]
    frontier, san = out["frontier"], out["sanitizer"]
    blame = out["blame"]
    if args.ledger:
        from . import perf_ledger
        out["ledger_row"] = perf_ledger.append_report(
            args.ledger, report, run="soak")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1, sort_keys=True)
            f.write("\n")
    if args.json:
        print(json.dumps(out))
    else:
        for k in ("offered", "completed", "rehomed", "shed_total",
                  "canceled_total", "abandoned",
                  "kills", "restarts", "goodput_per_s",
                  "slo_attainment", "replica_seconds",
                  "leaked_kv_blocks", "exceptions",
                  "new_compiles_after_warmup", "captures_warm_engines",
                  "captures_replacements", "warm_engine_graphs"):
            print(f"{k}: {report[k]}")
        for row in windows:
            burn = row.get("burn_rate")
            print(f"window {row['window']} "
                  f"[{row['t0']:>8.1f}s..{row['t1']:>8.1f}s): "
                  f"offered {row['offered']:>3} completed "
                  f"{row['completed']:>3} goodput "
                  f"{row['goodput_per_s']}/s burn "
                  f"{'-' if burn is None else burn}")
        if blame["requests"]:
            print(f"tail blame: {blame['tail_dominant']} dominates "
                  f"the E2E p95 tail ({blame['e2e_ms_p95']} ms over "
                  f"{blame['requests']} traced requests)")
        for row in frontier:
            print(f"frontier {row['arm']}: "
                  f"{row['replica_seconds']} replica-s -> "
                  f"{row['goodput_per_s']}/s goodput")
        if san["enabled"]:
            print(f"sanitizer: {san['lock_acquires']} acquires over "
                  f"{san['locks_tracked']} locks, "
                  f"{san['order_edges']} order edges, "
                  f"{len(san['cycles'])} cycles, "
                  f"{len(san['violations'])} violations")
    return 0 if gates_pass(out, args, device.type) else 1


def gates_pass(out: dict, args, device_type: str) -> bool:
    """The CLI's ``--expect-*`` gates over a :func:`soak` record; each
    failure is printed to stderr."""
    report, windows, san = out["report"], out["windows"], out["sanitizer"]
    hedges_fired = int(report.get("hedges", {}).get("fired", 0))
    ok = True
    if args.expect_kills_min is not None and \
            report["kills"] < args.expect_kills_min:
        print(f"FAIL: kills {report['kills']} < "
              f"{args.expect_kills_min}", file=sys.stderr)
        ok = False
    if args.expect_goodput_every_window:
        for row in windows:
            if row["offered"] > 0 and row["completed"] == 0:
                print(f"FAIL: window {row['window']} offered "
                      f"{row['offered']} but completed 0",
                      file=sys.stderr)
                ok = False
    if args.expect_zero_leaks:
        if report["leaked_kv_blocks"] != 0:
            print(f"FAIL: leaked_kv_blocks = "
                  f"{report['leaked_kv_blocks']}", file=sys.stderr)
            ok = False
        if report.get("leaked_lora_pages"):
            print(f"FAIL: leaked_lora_pages = "
                  f"{report['leaked_lora_pages']}", file=sys.stderr)
            ok = False
    if args.expect_zero_new_compiles:
        if not compiles_ok(report, device_type):
            print(f"FAIL: new_compiles_after_warmup = "
                  f"{report['new_compiles_after_warmup']} "
                  f"({report['captures_warm_engines']} by engines "
                  f"present at warm-up, "
                  f"{report['captures_replacements']} by replacements "
                  f"against {report['warm_engine_graphs']} graphs of a "
                  f"warmed engine)", file=sys.stderr)
            ok = False
        if not out["predictor_noop"]:
            print("FAIL: predictor says kills/restarts/re-homes "
                  "change compile counts", file=sys.stderr)
            ok = False
    if args.expect_sanitizer_clean:
        if not san["enabled"] or san["lock_acquires"] == 0:
            print("FAIL: --expect-sanitizer-clean needs "
                  "FLAGS_sanitize_locks=1 and instrumented lock "
                  f"traffic (enabled={san['enabled']}, acquires="
                  f"{san['lock_acquires']})", file=sys.stderr)
            ok = False
        if san["cycles"] or san["violations"]:
            print(f"FAIL: sanitizer saw {len(san['cycles'])} lock-"
                  f"order cycle(s), {len(san['violations'])} guarded-"
                  f"state violation(s): {san['cycles']} "
                  f"{san['violations']}", file=sys.stderr)
            ok = False
    if args.expect_identity and not out["identity_ok"]:
        print(f"FAIL: completed {report['completed']} + rehomed "
              f"{report['rehomed']} + shed {report['shed_total']} + "
              f"canceled {report['canceled_total']} (+ errors) != "
              f"offered {report['offered']}",
              file=sys.stderr)
        ok = False
    if args.expect_hedge_budget_respected:
        if args.hedge_ms == 0.0 or "hedges" not in report:
            print("FAIL: --expect-hedge-budget-respected needs "
                  "--hedge-ms (no hedging ran)", file=sys.stderr)
            ok = False
        else:
            frac = (args.hedge_budget if args.hedge_budget is not None
                    else _hedge_budget_flag())
            cap = 1 + frac * report["offered"]
            if hedges_fired > cap:
                print(f"FAIL: {hedges_fired} hedges fired > budget "
                      f"envelope 1 + {frac} * {report['offered']} = "
                      f"{cap}", file=sys.stderr)
                ok = False
    if report["exceptions"]:
        print(f"FAIL: {report['exceptions']} unhandled exceptions",
              file=sys.stderr)
        ok = False
    return ok


if __name__ == "__main__":
    sys.exit(main())
