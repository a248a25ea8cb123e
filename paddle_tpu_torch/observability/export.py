"""Exporters: Prometheus text exposition and a JSON snapshot of the
port's metrics registry; the counterpart of
``paddle_tpu/observability/export.py``.

``prometheus_text()`` renders the whole registry in the Prometheus text
format (served at ``GET /metrics`` by ``ServingHTTPServer``);
``snapshot()`` gives a JSON-safe dict of it; ``validate_prometheus_text()``
is the strict-enough parser the reference's CI gate uses.

STAT names may hold characters Prometheus forbids (the fault sites are
dotted, e.g. ``STAT_fault_serving.handoff``); they stay verbatim in the
registry and are sanitized only here, at render time.

The snapshot also carries the compile tracker's records (a captured
graph on the card, a new input signature on the CPU: the port's compile,
under the reference's ``xla_*`` names) and devprof's cost table, as the
reference's does; the compile and devprof families live in the registry,
so ``/metrics`` renders them with the rest.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional, Tuple

from . import compile_tracker as _ct
from . import metrics as _metrics

_NAME_OK = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_OK = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")
# label values may hold any escaped text, '}' included, so the label
# block is parsed quote-aware, not up to the first brace
_SAMPLE_RE = re.compile(
    r'^([a-zA-Z_:][a-zA-Z0-9_:]*)'
    r'(\{(?:[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|\\.)*",?)*\})?'
    r'\s+(-?[0-9.eE+-]+|NaN|\+Inf|-Inf)$')


def sanitize_name(name: str) -> str:
    out = re.sub(r"[^a-zA-Z0-9_:]", "_", str(name))
    if not out or not _NAME_OK.match(out):
        out = "_" + out
    return out


def _sanitize_label(name: str) -> str:
    out = re.sub(r"[^a-zA-Z0-9_]", "_", str(name))
    if not out or not _LABEL_OK.match(out):
        out = "_" + out
    return out


def _escape_value(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt(v) -> str:
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, int):
        return str(v)
    return format(float(v), ".10g")


def _label_str(pairs: Tuple[Tuple[str, str], ...], extra: str = "") -> str:
    parts = [f'{_sanitize_label(k)}="{_escape_value(v)}"' for k, v in pairs]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def prometheus_text(registry: Optional[_metrics.MetricsRegistry] = None) -> str:
    """Render every instrument in the registry as Prometheus text."""
    reg = registry if registry is not None else _metrics.DEFAULT
    lines: List[str] = []
    for name in sorted(reg.instruments()):
        inst = reg.get(name)
        if inst is None:
            continue
        sname = sanitize_name(name)
        if inst.help:
            lines.append(f"# HELP {sname} {_escape_value(inst.help)}")
        lines.append(f"# TYPE {sname} {inst.kind}")
        for key, series in sorted(inst.series()):
            if inst.kind == "histogram":
                cum = 0
                for bound, c in zip(inst.buckets_bounds, series.buckets):
                    cum += c
                    le = 'le="%s"' % _fmt(bound)
                    lines.append(f"{sname}_bucket{_label_str(key, le)} {cum}")
                cum += series.buckets[-1]
                le_inf = 'le="+Inf"'
                lines.append(f"{sname}_bucket{_label_str(key, le_inf)} {cum}")
                lines.append(f"{sname}_sum{_label_str(key)} "
                             f"{_fmt(series.sum)}")
                lines.append(f"{sname}_count{_label_str(key)} {series.count}")
            else:
                lines.append(f"{sname}{_label_str(key)} "
                             f"{_fmt(series.value)}")
    return "\n".join(lines) + "\n"


def validate_prometheus_text(text: str) -> int:
    """Parse Prometheus exposition text strictly enough to catch real
    breakage (bad metric names, malformed samples, histogram bucket
    counts that don't reconcile). Returns the number of samples parsed;
    raises ValueError on malformed input."""
    samples = 0
    bucket_last: Dict[str, int] = {}  # series key -> +Inf cumulative
    counts: Dict[str, int] = {}
    for ln, line in enumerate(text.splitlines(), start=1):
        if not line.strip():
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) < 3 or parts[1] not in ("HELP", "TYPE"):
                raise ValueError(f"line {ln}: malformed comment {line!r}")
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            raise ValueError(f"line {ln}: malformed sample {line!r}")
        name, labelstr, value = m.groups()
        float(value)  # +Inf/NaN accepted by float()
        samples += 1
        labelstr = labelstr or ""
        if name.endswith("_bucket") and 'le="' in labelstr:
            base = name[:-len("_bucket")]
            series = base + re.sub(r',?le="[^"]*"', "", labelstr)
            if 'le="+Inf"' in labelstr:
                bucket_last[series] = int(float(value))
        elif name.endswith("_count"):
            counts[name[:-len("_count")] + labelstr] = int(float(value))
    for series, inf_cum in bucket_last.items():
        # normalise "{}" left over after stripping the le label
        key = series.replace("{}", "")
        if key in counts and counts[key] != inf_cum:
            raise ValueError(
                f"histogram {series}: +Inf bucket {inf_cum} != "
                f"count {counts[key]}")
    if samples == 0:
        raise ValueError("no samples")
    return samples


def snapshot(registry: Optional[_metrics.MetricsRegistry] = None
             ) -> Dict[str, Any]:
    """JSON-safe snapshot: counters/gauges by value, histograms by
    count/sum/min/max + derived p50/p95/p99, plus the compile records
    and the devprof cost table. No raw samples anywhere, so it is always
    small."""
    reg = registry if registry is not None else _metrics.DEFAULT

    def skey(name: str, labels) -> str:
        if not labels:
            return name
        inner = ",".join(f"{k}={v}" for k, v in labels)
        return f"{name}{{{inner}}}"

    out: Dict[str, Any] = {"counters": {}, "gauges": {}, "histograms": {}}
    for name, inst in sorted(reg.instruments().items()):
        for key, series in sorted(inst.series()):
            k = skey(name, key)
            if inst.kind == "histogram":
                out["histograms"][k] = {
                    "count": series.count,
                    "sum": series.sum,
                    "min": series.min,
                    "max": series.max,
                    "p50": inst.quantile(0.50, key),
                    "p95": inst.quantile(0.95, key),
                    "p99": inst.quantile(0.99, key),
                }
            elif inst.kind == "gauge":
                out["gauges"][k] = series.value
            else:
                out["counters"][k] = series.value
    out["compiles"] = {
        qual: {"count": rec["count"], "total_ms": rec["total_ms"],
               "last_signature": rec["last_signature"]}
        for qual, rec in _ct.compiles().items()}
    # the devprof cost table rides every snapshot (an empty dict while
    # the observatory is off)
    from . import devprof as _devprof
    out["device_costs"] = _devprof.cost_table()
    return out
