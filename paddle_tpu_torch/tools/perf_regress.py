"""Perf-regression gate: latest ledger row vs a baseline; the port's own
copy of ``tools/perf_regress.py``.

Reads the newest row of a :mod:`paddle_tpu_torch.tools.perf_ledger`
JSONL ledger and
compares it metric-by-metric against a baseline JSON, with a noise
tolerance. Direction-aware: goodput-like metrics (higher is better)
fail when the row drops below ``baseline * (1 - tol)``; latency-like
metrics (lower is better) fail when the row rises above
``baseline * (1 + tol)``. Exit status is the CI contract — 0 on a
clean run, 1 on any regression.

    python -m paddle_tpu_torch.tools.perf_regress LEDGER.jsonl \\
        --baseline BASELINE.json

``--baseline`` is required: the reference's ``tools/perf_baseline.json``
holds the JAX package's numbers, not the port's. Write a baseline from
a seeded VirtualClock loadgen row with ``--write-baseline``; gated
metrics of such a run are deterministic, so the default tolerance only
has to absorb schema drift, not timer noise.

Baseline format::

    {"schema": 1,
     "metrics": {"goodput_per_s": 24.5,
                 "ttft_ms_p95": {"value": 31.0, "tolerance": 0.2}},
     "cost_digest": "0123abcd...",     # or null
     "source": {...}}                  # provenance, not compared

A metric present in the baseline but missing (or null) on the row is
itself a failure — a report that silently stopped carrying a gated
number must not pass. A ``cost_digest`` mismatch prints a warning
(the counted cost changed — often intentional) and fails only under
``--strict-digest``.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List, Optional, Tuple

SCHEMA = 1

#: metrics where bigger numbers are better; everything else gated is
#: treated as latency-like (smaller is better)
HIGHER_BETTER = {"goodput_per_s", "slo_attainment", "completed",
                 "mfu", "offered"}

DEFAULT_TOLERANCE = 0.10


def _spec(v) -> Tuple[Optional[float], Optional[float], float]:
    """Baseline metric entry -> (value, per-metric tolerance or None,
    absolute slack). Accepts a bare number or {"value":,
    "tolerance":, "slack":}; slack widens the bound by an absolute
    amount — the escape hatch for zero-valued baselines, where any
    relative tolerance still collapses to zero."""
    if isinstance(v, dict):
        val = v.get("value")
        tol = v.get("tolerance")
        slack = v.get("slack")
        return (float(val) if isinstance(val, (int, float)) else None,
                float(tol) if isinstance(tol, (int, float)) else None,
                float(slack) if isinstance(slack, (int, float))
                else 0.0)
    if isinstance(v, (int, float)) and not isinstance(v, bool):
        return float(v), None, 0.0
    return None, None, 0.0


def compare(row: Dict[str, Any], baseline: Dict[str, Any],
            tolerance: float = DEFAULT_TOLERANCE,
            strict_digest: bool = False
            ) -> Tuple[List[str], List[str]]:
    """Returns (failures, notes). Empty failures == gate passes."""
    failures: List[str] = []
    notes: List[str] = []
    metrics = baseline.get("metrics") or {}
    if not isinstance(metrics, dict) or not metrics:
        failures.append("baseline has no metrics to gate on")
        return failures, notes
    for name in sorted(metrics):
        base, tol, slack = _spec(metrics[name])
        if base is None:
            failures.append(f"{name}: malformed baseline entry "
                            f"{metrics[name]!r}")
            continue
        tol = tolerance if tol is None else tol
        got = row.get(name)
        if isinstance(got, bool) or not isinstance(got, (int, float)):
            failures.append(
                f"{name}: baseline {base:g} but the row carries no "
                f"value (got {got!r})")
            continue
        got = float(got)
        if name in HIGHER_BETTER:
            floor = base * (1.0 - tol) - slack
            if got < floor:
                failures.append(
                    f"{name}: {got:g} < {floor:g} "
                    f"(baseline {base:g} - {tol:.0%})")
            else:
                notes.append(f"{name}: {got:g} ok "
                             f"(baseline {base:g}, floor {floor:g})")
        else:
            ceil = base * (1.0 + tol) + slack
            if got > ceil:
                failures.append(
                    f"{name}: {got:g} > {ceil:g} "
                    f"(baseline {base:g} + {tol:.0%})")
            else:
                notes.append(f"{name}: {got:g} ok "
                             f"(baseline {base:g}, ceiling {ceil:g})")
    base_digest = baseline.get("cost_digest")
    row_digest = row.get("cost_digest")
    if base_digest and row_digest and base_digest != row_digest:
        msg = (f"cost_digest changed: {base_digest} -> {row_digest} "
               "(cost table moved — regenerate the baseline if "
               "intentional)")
        (failures if strict_digest else notes).append(
            msg if strict_digest else "WARNING: " + msg)
    return failures, notes


def write_baseline(path: str, row: Dict[str, Any],
                   metrics: Optional[List[str]] = None):
    """Freeze the given row's gated metrics as the new baseline."""
    gate = metrics or ["goodput_per_s", "ttft_ms_p95", "tpot_ms_p95"]
    doc = {
        "schema": SCHEMA,
        "metrics": {},
        "cost_digest": row.get("cost_digest"),
        "source": {k: row.get(k)
                   for k in ("ts", "git_rev", "run", "label")
                   if row.get(k) is not None},
    }
    for name in gate:
        v = row.get(name)
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            if name not in HIGHER_BETTER and v == 0:
                # a zero latency baseline makes every relative bound
                # zero-width; give it 1 unit of absolute slack
                doc["metrics"][name] = {"value": v, "slack": 1.0}
            else:
                doc["metrics"][name] = v
    if not doc["metrics"]:
        raise SystemExit(
            f"refusing to write an empty baseline: row has none of "
            f"{gate}")
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")
    return doc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="compare the latest perf-ledger row against a "
                    "committed baseline; exit 1 on regression")
    ap.add_argument("ledger", help="JSONL ledger "
                    "(paddle_tpu_torch.tools.perf_ledger output)")
    ap.add_argument("--baseline", required=True,
                    help="baseline JSON (written by --write-baseline)")
    ap.add_argument("--tolerance", type=float,
                    default=DEFAULT_TOLERANCE,
                    help="relative noise tolerance for metrics "
                         "without a per-metric override "
                         f"(default {DEFAULT_TOLERANCE})")
    ap.add_argument("--strict-digest", action="store_true",
                    help="treat a cost_digest mismatch as a failure, "
                         "not a warning")
    ap.add_argument("--write-baseline", action="store_true",
                    help="freeze the latest row as the new baseline "
                         "instead of comparing")
    ap.add_argument("--metrics", default="",
                    help="comma list of row keys to gate when "
                         "writing a baseline (default goodput_per_s,"
                         "ttft_ms_p95,tpot_ms_p95)")
    args = ap.parse_args(argv)

    if not (0.0 <= args.tolerance < 1.0):
        ap.error(f"--tolerance must be in [0, 1), got {args.tolerance}")

    from . import perf_ledger

    row = perf_ledger.latest(args.ledger)
    if row is None:
        print(f"FAIL: {args.ledger}: empty ledger", file=sys.stderr)
        return 1

    if args.write_baseline:
        gate = [m for m in args.metrics.split(",") if m] or None
        doc = write_baseline(args.baseline, row, gate)
        print(f"wrote {args.baseline}: "
              f"{json.dumps(doc['metrics'], sort_keys=True)}")
        return 0

    try:
        with open(args.baseline, "r", encoding="utf-8") as f:
            baseline = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        print(f"FAIL: cannot read baseline {args.baseline}: {e}",
              file=sys.stderr)
        return 1

    failures, notes = compare(row, baseline,
                              tolerance=args.tolerance,
                              strict_digest=args.strict_digest)
    for n in notes:
        print(n)
    if failures:
        for msg in failures:
            print(f"FAIL: {msg}", file=sys.stderr)
        print(f"perf regression vs {args.baseline} "
              f"(row ts={row.get('ts')}, rev={row.get('git_rev')})",
              file=sys.stderr)
        return 1
    print(f"perf gate ok vs {args.baseline} "
          f"(row ts={row.get('ts')}, rev={row.get('git_rev')})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
