"""Perf-regression ledger: one schema'd JSONL row per loadgen run; the
port's own copy of ``tools/perf_ledger.py``.

The device-cost observatory (``paddle_tpu_torch/observability/
devprof.py``) measures a run; this module *remembers* it. Every row
carries the serving headline metrics (goodput, TTFT/TPOT p95, SLO
attainment), the devprof roofline summary (MFU, host-overhead share)
when the run profiled, the cost-table digest (so a cost change is
visible even when a virtual clock hides it from wall metrics), and the
git revision: an append-only perf trajectory that
:mod:`paddle_tpu_torch.tools.perf_regress` enforces against a baseline.

Usage, in-process (the port's loadgen ``--ledger``)::

    from paddle_tpu_torch.tools import perf_ledger
    perf_ledger.append_report("perf_ledger.jsonl", report,
                              run="loadgen", label="ci-seeded")

or offline from a saved ``--json`` report::

    python -m paddle_tpu_torch.tools.perf_ledger LEDGER.jsonl \\
        --from-report REPORT.json
    python -m paddle_tpu_torch.tools.perf_ledger LEDGER.jsonl --show

Rows gate on metrics a seeded VirtualClock run reproduces exactly
(goodput / latency percentiles); MFU and the host share ride along as
informational fields because they sample wall time.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import subprocess
import sys
from typing import Any, Dict, List, Optional

SCHEMA = 1

#: report keys copied verbatim into a row when present and numeric —
#: the deterministic headline metrics perf_regress.py can gate on
METRIC_KEYS = ("goodput_per_s", "ttft_ms_p95", "tpot_ms_p95",
               "slo_attainment", "completed", "offered", "shed_total",
               "new_compiles_after_warmup")

#: devprof-section keys carried as informational fields (wall-clock
#: sampled — never gated by default)
DEVPROF_KEYS = ("mfu", "host_overhead_share", "device_frac",
                "samples", "dispatches")


def git_rev() -> Optional[str]:
    """Short HEAD revision of the repo this file lives in, or None
    outside a checkout (rows stay appendable from exported trees)."""
    try:
        out = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=10)
        rev = out.stdout.strip()
        return rev if out.returncode == 0 and rev else None
    except Exception:
        return None


def _num(v) -> Optional[float]:
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        return None
    return v


def _live_cost_digest() -> Optional[str]:
    """The in-process cost-table digest, when the observatory has
    captured anything this process (None otherwise — e.g. the offline
    ``--from-report`` path, which falls back to the report's copy)."""
    try:
        from paddle_tpu_torch.observability import devprof
        return devprof.cost_digest()
    except Exception:
        return None


def make_row(report: Dict[str, Any], run: str = "loadgen",
             label: str = "", ts: Optional[str] = None,
             rev: Optional[str] = None) -> Dict[str, Any]:
    """Fold a loadgen report dict into one ledger row."""
    row: Dict[str, Any] = {
        "schema": SCHEMA,
        "ts": ts if ts is not None else datetime.datetime.now(
            datetime.timezone.utc).isoformat(timespec="seconds"),
        "git_rev": rev if rev is not None else git_rev(),
        "run": str(run),
    }
    if label:
        row["label"] = str(label)
    for k in METRIC_KEYS:
        v = _num(report.get(k))
        if v is not None:
            row[k] = v
    dp = report.get("devprof")
    if isinstance(dp, dict):
        for k in DEVPROF_KEYS:
            v = _num(dp.get(k))
            if v is not None:
                row[k] = v
    digest = _live_cost_digest()
    if digest is None and isinstance(dp, dict):
        digest = dp.get("cost_digest")
    row["cost_digest"] = digest
    return row


def append_row(path: str, row: Dict[str, Any]) -> Dict[str, Any]:
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "a", encoding="utf-8") as f:
        f.write(json.dumps(row, sort_keys=True) + "\n")
    return row


def append_report(path: str, report: Dict[str, Any],
                  run: str = "loadgen", label: str = ""
                  ) -> Dict[str, Any]:
    """The one-call hook the drivers use: make a row, append it,
    return it (so reports can embed what they logged)."""
    return append_row(path, make_row(report, run=run, label=label))


def read_rows(path: str) -> List[Dict[str, Any]]:
    rows = []
    with open(path, "r", encoding="utf-8") as f:
        for ln, line in enumerate(f, start=1):
            line = line.strip()
            if not line:
                continue
            try:
                row = json.loads(line)
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{ln}: bad ledger line: {e}")
            if not isinstance(row, dict):
                raise ValueError(f"{path}:{ln}: row is not an object")
            rows.append(row)
    return rows


def latest(path: str) -> Optional[Dict[str, Any]]:
    rows = read_rows(path)
    return rows[-1] if rows else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="append to / inspect the perf-regression ledger")
    ap.add_argument("ledger", help="JSONL ledger path")
    ap.add_argument("--from-report", default="", metavar="REPORT.json",
                    help="append one row folded from a saved --json "
                         "report ('-' reads stdin)")
    ap.add_argument("--run", default="loadgen",
                    help="run kind recorded on the row "
                         "(loadgen | soak | bench; default loadgen)")
    ap.add_argument("--label", default="",
                    help="free-form scenario label for the row")
    ap.add_argument("--show", action="store_true",
                    help="print every row, one JSON object per line")
    args = ap.parse_args(argv)

    if args.from_report:
        if args.from_report == "-":
            report = json.load(sys.stdin)
        else:
            with open(args.from_report, "r", encoding="utf-8") as f:
                report = json.load(f)
        row = append_report(args.ledger, report, run=args.run,
                            label=args.label)
        print(json.dumps(row, sort_keys=True))
        return 0
    if args.show:
        for row in read_rows(args.ledger):
            print(json.dumps(row, sort_keys=True))
        return 0
    ap.error("nothing to do: pass --from-report or --show")
    return 2


if __name__ == "__main__":
    sys.exit(main())
