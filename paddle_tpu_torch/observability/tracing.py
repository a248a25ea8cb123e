"""Per-request distributed tracing with tail-latency blame attribution,
the counterpart of ``paddle_tpu/observability/tracing.py``, kept equal
to it line for line in what it computes and exports, the device-cost
observatory's roofline rows included.

Every request admitted by the serving plane carries a trace: an ordered
list of **marks** ``(kind, t, track)`` recorded host-side on the
engine's clock (wall ``time.perf_counter`` or a ``VirtualClock``) as it
moves through submit → admit → (prefill wave) → handoff queue → decode
→ re-home → finish/shed. The trace id *is* the request id — a single
process-unique integer that travels with the :class:`Request` object
across replicas and roles, so a kill and re-home stitches the
survivor's marks onto the original trace instead of starting a new
one.

**Blame attribution is an accounting identity, not an estimate.** The
interval between two consecutive marks is a named latency component
(``_PHASE_AFTER``: the mark a span *starts at* names it — submit→admit
is ``queue``, admit→first_token is ``prefill``, export→adopt is
``handoff``, kill→admit is ``rehome``, everything after a token is
``decode``), and the component sums telescope: their total is exactly
``finished_at - submitted_at`` and the prefix up to the ``first_token``
mark is exactly the measured TTFT. ``blame()`` decomposes one request;
``blame_summary()`` aggregates the fleet view, including which
component dominates the E2E p95 tail.

**Mark granularity under decode megasteps.** With
``FLAGS_serving_megastep`` N > 1 the engine commits tokens once per
megastep, so marks land at *commit boundaries*, not per device token:
``first_token`` is untouched (the first output token comes from the
prefill dispatch and is marked at prefill commit — TTFT has megastep-
independent granularity), but a request that finishes on token k of a
megastep is marked finished when that megastep's batch commits, up to
N-1 token-times after the device-side early-exit froze its slot. The
blame identity is unaffected — it telescopes over whatever marks
exist — and every timestamp still comes off the engine clock at the
commit, so seeded replays stay byte-identical at any fixed N. The
decode component simply has coarser resolution at larger N; compare
like with like when diffing blame summaries across megastep settings.

Everything here is host-side bookkeeping: no step graph is touched,
timestamps come only from the engine clock so a
seeded virtual-clock run exports **byte-identical** traces on every
replay (request ids are normalized to submission order at export
time — the module-level id counter is process-unique, the export is
not), and ``FLAGS_serving_trace`` / ``FLAGS_serving_trace_keep``
bound the overhead: deterministic per-request-id sampling and a
finished-trace ring like the runlog's rotation.

Exports:

- :func:`export_chrome_trace` — Perfetto-loadable chrome-trace JSON:
  one track (pid/tid + thread_name metadata) per replica/role, one
  ``X`` duration event per component span, one flow (``s``/``t``/``f``
  events) per request stitching its spans across tracks;
- :func:`export_spans_jsonl` — one JSON line per span, the
  ``tools/trace_summary.py --blame`` input format;
- :func:`window_snapshots` — per-window TTFT percentiles, SLO
  attainment and **burn rate** ((1 - attainment) / (1 - target), the
  SRE error-budget consumption speed), published on the
  ``serving_slo_burn_rate`` gauge.

The chrome trace's process keeps the reference's name,
``paddle_tpu.serving``, so both packages export the same bytes.
"""

from __future__ import annotations

import json
import math
import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

#: the latency component a span STARTING at this mark kind belongs to
#: (a span runs from one mark to the next; the chrome export attributes
#: it to the track of its *ending* mark — where the time was spent)
_PHASE_AFTER = {
    "submit": "queue",        # waiting to be admitted (incl. routing)
    "admit": "prefill",       # admission -> first/next token
    "first_token": "decode",  # steady-state token production
    "resume": "decode",       # decode after a re-home re-prefill
    "export": "handoff",      # prefill/decode role boundary queue
    "adopt": "decode",        # decode-side adoption -> tokens
    "kill": "rehome",         # crash -> re-admission on a survivor
}

#: every component name blame() can emit, in display order. The
#: ``decode_device`` / ``decode_host`` pair appears instead of
#: ``decode`` on traces annotated with a sampled device fraction
#: (``meta["decode_device_frac"]``, written by the engine's device-cost
#: observatory — see observability/devprof.py): decode_device =
#: decode * frac and decode_host = decode - decode_device, so the
#: accounting identity sum(components) == e2e survives the split
#: exactly, by construction.
COMPONENTS = ("queue", "prefill", "decode", "decode_device",
              "decode_host", "handoff", "rehome")

#: point-in-time annotations, not span boundaries: these marks record
#: lifecycle *events* (a cancel landing, a hedge firing/resolving) on
#: the timeline without starting a latency component, so the blame
#: identity (sum(components) == e2e) and the COMPONENTS vocabulary are
#: untouched by the cancellation and hedging edges. They still appear
#: in get()'s mark list — visible in the timeline, invisible to blame.
ANNOTATION_KINDS = frozenset({"cancel", "hedge", "hedge_win",
                              "hedge_lose"})


def _span_marks(marks):
    """Marks that bound spans: the timeline minus pure annotations."""
    return [m for m in marks if m[0] not in ANNOTATION_KINDS]


def _device_frac(meta: dict) -> Optional[float]:
    """The sampled decode device fraction, if the engine's devprof
    annotated one onto this trace; clamped to [0, 1]. None (no split)
    when absent or non-numeric — e.g. a virtual-clock run whose
    samples all measured zero never annotates, keeping its exports
    byte-identical to a devprof-off run."""
    v = meta.get("decode_device_frac")
    if not isinstance(v, (int, float)):
        return None
    return min(1.0, max(0.0, float(v)))


def _split_decode(comp: Dict[str, float], frac: Optional[float]):
    """Replace the ``decode`` component with the ``decode_device`` +
    ``decode_host`` pair. Exact by construction: device = decode *
    frac, host = decode - device, so the pair sums to the original
    float bit-for-bit and the blame identity telescopes unchanged."""
    if frac is None or "decode" not in comp:
        return comp
    decode = comp.pop("decode")
    device = decode * frac
    comp["decode_device"] = device
    comp["decode_host"] = decode - device
    return comp


class Trace:
    """One request's mark timeline. Marks are ``(kind, t, track)``
    tuples — plain data on the engine clock, nothing wall-clock."""

    __slots__ = ("rid", "marks", "meta", "outcome", "reason")

    def __init__(self, rid: int, t: float, track: str, **meta):
        self.rid = int(rid)
        self.marks: List[Tuple[str, float, str]] = [
            ("submit", float(t), str(track))]
        self.meta = meta
        self.outcome: Optional[str] = None
        self.reason: Optional[str] = None


def blame(trace: Trace) -> dict:
    """Decompose one finished trace into named latency components.

    The identity is structural: spans are the gaps between consecutive
    marks, so ``sum(components) == e2e_s`` exactly (float addition
    aside) and the prefix ending at the ``first_token`` mark is
    exactly the measured TTFT. ``ANNOTATION_KINDS`` marks are
    timeline events, not span boundaries, and are skipped here."""
    marks = _span_marks(trace.marks)
    comp: Dict[str, float] = {}
    ttft = None
    elapsed = 0.0
    for (k0, t0, _tr0), (k1, t1, _tr1) in zip(marks, marks[1:]):
        name = _PHASE_AFTER.get(k0, k0)
        comp[name] = comp.get(name, 0.0) + (t1 - t0)
        elapsed += t1 - t0
        if k1 == "first_token":
            ttft = t1 - marks[0][1]
    _split_decode(comp, _device_frac(trace.meta))
    return {
        "components": comp,
        "e2e_s": marks[-1][1] - marks[0][1],
        "ttft_s": ttft,
        "outcome": trace.outcome,
    }


def _pctl(vals: List[float], q: float) -> Optional[float]:
    """Nearest-rank percentile — deterministic, numpy-free."""
    if not vals:
        return None
    s = sorted(vals)
    idx = min(len(s) - 1, max(0, int(math.ceil(q / 100.0 * len(s))) - 1))
    return s[idx]


class TraceStore:
    """Thread-safe store of active + finished traces.

    Finished traces live in a bounded ring (``FLAGS_serving_trace_
    keep``, like the runlog's rotation): the debug endpoint serves the
    most recent N completions and evicted ids 404. ``reset()`` clears
    everything — the byte-identity tests call it between replays."""

    def __init__(self):
        self._lock = threading.Lock()
        self._active: Dict[int, Trace] = {}
        self._finished: "OrderedDict[int, Trace]" = OrderedDict()
        self.dropped = 0          # finished traces evicted off the ring
        self._traced_counter = None

    # ------------------------------------------------------- recording
    @staticmethod
    def _flags() -> dict:
        from .. import flags as _flags
        return _flags.get_flags(["serving_trace", "serving_trace_keep"])

    def sampled(self, rid: int, frac: Optional[float] = None) -> bool:
        """Deterministic per-request sampling decision: a Knuth-hash of
        the request id against ``FLAGS_serving_trace`` — the same id is
        always in or always out, with no RNG stream consumed (seeded
        workloads keep their byte-identical traces)."""
        if frac is None:
            frac = float(self._flags()["serving_trace"])
        if frac >= 1.0:
            return True
        if frac <= 0.0:
            return False
        return ((int(rid) * 2654435761) % (2 ** 32)) / (2 ** 32) < frac

    def begin(self, rid: int, t: float, track: str, **meta) -> bool:
        """Open a trace at the submit mark; False = not sampled."""
        if not self.sampled(rid):
            return False
        if self._traced_counter is None:
            from .. import observability as _obs
            self._traced_counter = _obs.counter(
                "serving_traced_total",
                "requests that carried a trace (sampled in by "
                "FLAGS_serving_trace)")
        tr = Trace(rid, t, track, **meta)
        with self._lock:
            self._active[int(rid)] = tr
        self._traced_counter.add(1)
        return True

    def mark(self, rid: int, kind: str, t: float, track: str) -> bool:
        """Append one mark; no-op (False) for unsampled/unknown ids,
        so call sites never need their own sampling guard."""
        with self._lock:
            tr = self._active.get(int(rid))
            if tr is None:
                return False
            tr.marks.append((str(kind), float(t), str(track)))
            return True

    def annotate(self, rid: int, **meta) -> bool:
        """Merge metadata onto an active trace — point data that is
        not a timeline mark (e.g. the devprof-sampled
        ``decode_device_frac`` the engine writes just before finish,
        which blame() uses to split ``decode``). No-op (False) for
        unsampled/unknown ids, like :meth:`mark`."""
        with self._lock:
            tr = self._active.get(int(rid))
            if tr is None:
                return False
            tr.meta.update(meta)
            return True

    def has_mark(self, rid: int, kind: str) -> bool:
        with self._lock:
            tr = self._active.get(int(rid))
            return tr is not None and any(k == kind
                                          for k, _t, _tr in tr.marks)

    def finish(self, rid: int, t: float, track: str, outcome: str,
               reason: Optional[str] = None) -> bool:
        """Close a trace (outcome ``done`` | ``shed`` | ``canceled``)
        and move it to the finished ring, evicting beyond the keep
        bound. Only ``done`` traces feed blame/TTFT aggregates."""
        keep = max(1, int(self._flags()["serving_trace_keep"]))
        with self._lock:
            tr = self._active.pop(int(rid), None)
            if tr is None:
                return False
            tr.marks.append(("finish", float(t), str(track)))
            tr.outcome = str(outcome)
            tr.reason = reason
            self._finished[tr.rid] = tr
            while len(self._finished) > keep:
                self._finished.popitem(last=False)
                self.dropped += 1
            return True

    def discard(self, rid: int) -> bool:
        """Forget one trace, active or finished (warm-up traffic a
        caller keeps out of the record); False for an unknown id."""
        with self._lock:
            return (self._active.pop(int(rid), None) is not None or
                    self._finished.pop(int(rid), None) is not None)

    def reset(self):
        with self._lock:
            self._active.clear()
            self._finished.clear()
            self.dropped = 0

    # --------------------------------------------------------- queries
    def get(self, rid: int) -> Optional[dict]:
        """One request's timeline + blame — the debug-endpoint payload.
        None for unknown / unsampled / ring-evicted ids."""
        with self._lock:
            tr = self._finished.get(int(rid)) or \
                self._active.get(int(rid))
            if tr is None:
                return None
            marks = list(tr.marks)
            snap = Trace(tr.rid, marks[0][1], marks[0][2], **tr.meta)
            snap.marks = marks
            snap.outcome = tr.outcome
            snap.reason = tr.reason
        b = blame(snap)
        return {
            "id": snap.rid,
            "outcome": snap.outcome or "in_flight",
            "reason": snap.reason,
            "meta": dict(snap.meta),
            "marks": [{"kind": k, "t": round(t, 9), "track": trk}
                      for k, t, trk in marks],
            "blame_ms": {k: round(v * 1e3, 6)
                         for k, v in sorted(b["components"].items())},
            "e2e_ms": round(b["e2e_s"] * 1e3, 6),
            "ttft_ms": (None if b["ttft_s"] is None
                        else round(b["ttft_s"] * 1e3, 6)),
        }

    def finished(self) -> List[Trace]:
        with self._lock:
            return list(self._finished.values())

    def blame_summary(self) -> dict:
        """Fleet-wide blame over finished ``done`` traces: per-component
        totals, shares and p95s, plus which component dominates the
        E2E p95 tail — "where does the tail latency come from"."""
        rows = [blame(tr) for tr in self.finished()
                if tr.outcome == "done"]
        if not rows:
            return {"requests": 0, "components": {},
                    "tail_dominant": None, "e2e_ms_p95": None}
        e2es = [r["e2e_s"] for r in rows]
        p95 = _pctl(e2es, 95)
        tail = [r for r in rows if r["e2e_s"] >= p95]
        comp_stats: Dict[str, dict] = {}
        total_e2e = sum(e2es)
        for name in COMPONENTS:
            vals = [r["components"].get(name, 0.0) for r in rows]
            tot = sum(vals)
            if tot == 0.0 and not any(name in r["components"]
                                      for r in rows):
                continue
            comp_stats[name] = {
                "total_ms": round(tot * 1e3, 6),
                "share": round(tot / total_e2e, 6) if total_e2e else 0.0,
                "p95_ms": round(_pctl(vals, 95) * 1e3, 6),
            }
        tail_means = {
            name: sum(r["components"].get(name, 0.0)
                      for r in tail) / len(tail)
            for name in comp_stats}
        dominant = (max(sorted(tail_means), key=lambda n: tail_means[n])
                    if tail_means else None)
        return {
            "requests": len(rows),
            "e2e_ms_p95": round(p95 * 1e3, 6),
            "components": comp_stats,
            "tail_dominant": dominant,
        }

    def ttft_p95_ms(self) -> Optional[float]:
        """Fleet TTFT p95 (ms) over finished ``done`` traces — the
        auto-derivation source for the hedge threshold
        (``FLAGS_serving_hedge_ms < 0``): a hedge should fire only
        when a request's predicted TTFT is already in the observed
        tail. None until at least one traced request finished with a
        first token."""
        ttfts = []
        for tr in self.finished():
            if tr.outcome != "done":
                continue
            b = blame(tr)
            if b["ttft_s"] is not None:
                ttfts.append(b["ttft_s"] * 1e3)
        p = _pctl(ttfts, 95)
        return None if p is None else round(p, 6)

    # --------------------------------------------------------- exports
    def _export_rows(self):
        """Finished traces in submission (= request id) order with
        normalized sequential ids — the byte-identity surface: the
        process-unique id counter never leaks into exported bytes."""
        traces = sorted(self.finished(), key=lambda tr: tr.rid)
        return [(i, tr) for i, tr in enumerate(traces)]

    @staticmethod
    def _trace_spans(tr: Trace) -> List[Tuple[str, float, float, str]]:
        """One trace's ``(component, t0, t1, track)`` spans, with
        ``decode`` spans split at ``t0 + (t1 - t0) * frac`` into the
        ``decode_device`` / ``decode_host`` pair when the trace
        carries a devprof device fraction — the export-side mirror of
        :func:`_split_decode`, so rendered timelines and blame()
        totals tell one story."""
        smarks = _span_marks(tr.marks)
        frac = _device_frac(tr.meta)
        spans: List[Tuple[str, float, float, str]] = []
        for (k0, t0, _tr0), (k1, t1, trk1) in zip(smarks, smarks[1:]):
            name = _PHASE_AFTER.get(k0, k0)
            if name == "decode" and frac is not None:
                t_mid = t0 + (t1 - t0) * frac
                spans.append(("decode_device", t0, t_mid, trk1))
                spans.append(("decode_host", t_mid, t1, trk1))
            else:
                spans.append((name, t0, t1, trk1))
        return spans

    @staticmethod
    def _devprof_entries() -> List[dict]:
        """Roofline rows of the device-cost observatory, embedded in
        both export formats (none while nothing sampled, so a
        devprof-off export's bytes are unchanged)."""
        from . import devprof as _devprof
        return _devprof.roofline_entries()

    @staticmethod
    def _track_names(rows) -> Dict[str, str]:
        """Normalize track names for export: the engine-id suffix is
        process-unique (like the request ids), so each distinct track
        is renumbered within its role prefix in order of first
        appearance — ``prefill7``/``decode9`` become
        ``prefill0``/``decode0`` on every seeded replay."""
        out: Dict[str, str] = {}
        counts: Dict[str, int] = {}
        for _i, tr in rows:
            for _k, _t, trk in _span_marks(tr.marks):
                if trk in out:
                    continue
                role = trk.rstrip("0123456789") or "track"
                out[trk] = f"{role}{counts.get(role, 0)}"
                counts[role] = counts.get(role, 0) + 1
        return out

    def export_chrome_trace(self, path: Optional[str] = None) -> dict:
        """Perfetto-loadable chrome-trace JSON: one tid (with a
        ``thread_name`` metadata event) per replica/role track, one
        ``X`` duration event per component span attributed to the
        track of the span's ending mark, and one ``s``/``t``/``f``
        flow per request stitching its spans across tracks (a re-homed
        request draws an arrow from the dead replica to the survivor).
        Timestamps are engine-clock microseconds; with ``path`` the
        doc is also written as canonical sorted-key JSON."""
        rows = self._export_rows()
        names = self._track_names(rows)
        tracks: "OrderedDict[str, int]" = OrderedDict()
        for _i, tr in rows:
            for _k, _t, trk in _span_marks(tr.marks):
                if trk not in tracks:
                    tracks[trk] = len(tracks)

        def us(t: float) -> int:
            return int(round(t * 1e6))

        events: List[dict] = [
            {"ph": "M", "name": "process_name", "pid": 1, "tid": 0,
             "args": {"name": "paddle_tpu.serving"}}]
        for trk, tid in tracks.items():
            events.append({"ph": "M", "name": "thread_name", "pid": 1,
                           "tid": tid, "args": {"name": names[trk]}})
        for idx, tr in rows:
            spans = self._trace_spans(tr)
            for si, (name, t0, t1, trk) in enumerate(spans):
                tid = tracks[trk]
                events.append({
                    "ph": "X", "name": name, "cat": "request",
                    "pid": 1, "tid": tid, "ts": us(t0),
                    "dur": max(0, us(t1) - us(t0)),
                    "args": {"request": idx,
                             "outcome": tr.outcome or "?"}})
                flow = {"id": idx, "cat": "request", "name": "request",
                        "pid": 1, "tid": tid}
                if si == 0:
                    events.append(dict(flow, ph="s", ts=us(t0)))
                elif si == len(spans) - 1:
                    events.append(dict(flow, ph="f", bp="e",
                                       ts=us(t1)))
                else:
                    events.append(dict(flow, ph="t", ts=us(t0)))
            if len(spans) == 1:
                trk = spans[0][3]
                events.append({"id": idx, "cat": "request",
                               "name": "request", "pid": 1,
                               "tid": tracks[trk], "ph": "f",
                               "bp": "e", "ts": us(spans[0][2])})
        for entry in self._devprof_entries():
            events.append({"ph": "M", "name": "devprof", "pid": 1,
                           "tid": 0, "args": entry})
        doc = {"displayTimeUnit": "ms", "traceEvents": events}
        if path:
            with open(path, "w", encoding="utf-8") as f:
                f.write(json.dumps(doc, sort_keys=True,
                                   separators=(",", ":")))
                f.write("\n")
        return doc

    def export_spans_jsonl(self, path: Optional[str] = None) -> str:
        """One canonical JSON line per span — the JSONL input of
        ``tools/trace_summary.py --blame``. Returns the text; with
        ``path`` it is also written."""
        lines = []
        rows = self._export_rows()
        names = self._track_names(rows)
        for idx, tr in rows:
            for name, t0, t1, trk1 in self._trace_spans(tr):
                lines.append(json.dumps(
                    {"trace": idx,
                     "span": name,
                     "track": names[trk1],
                     "t0": round(t0, 9), "t1": round(t1, 9),
                     "dur_ms": round((t1 - t0) * 1e3, 6),
                     "outcome": tr.outcome or "?"},
                    sort_keys=True, separators=(",", ":")))
        # devprof roofline rows ride along as bare {"devprof": ...}
        # lines — no "span"/"trace" keys, so blame collectors that key
        # on those skip them without special-casing
        for entry in self._devprof_entries():
            lines.append(json.dumps({"devprof": entry},
                                    sort_keys=True,
                                    separators=(",", ":")))
        text = "\n".join(lines) + ("\n" if lines else "")
        if path:
            with open(path, "w", encoding="utf-8") as f:
                f.write(text)
        return text

    def window_snapshots(self, n_windows: int, span_s: float,
                         slo_ttft_ms: float = 0.0,
                         slo_target: float = 0.99,
                         t0: float = 0.0) -> List[dict]:
        """Windowed histogram snapshots + SLO burn rate over finished
        traces, bucketed by submit time into ``n_windows`` equal
        slices of ``[t0, t0 + span_s)``.

        ``burn_rate`` is the SRE error-budget consumption speed:
        ``(1 - attainment) / (1 - slo_target)`` — 1.0 burns the budget
        exactly at the allowed rate, >1 eats into it, 0 is a clean
        window. Published per window on the ``serving_slo_burn_rate``
        gauge. Windows with no finished requests report None rates."""
        if n_windows < 1:
            raise ValueError(f"n_windows must be >= 1, got {n_windows}")
        if span_s <= 0:
            raise ValueError(f"span_s must be > 0, got {span_s}")
        if not (0.0 <= slo_target < 1.0):
            raise ValueError(
                f"slo_target must be in [0, 1), got {slo_target}")
        w = span_s / n_windows
        rows = [{"window": i, "t0": round(t0 + i * w, 6),
                 "t1": round(t0 + (i + 1) * w, 6), "finished": 0,
                 "done": 0, "shed": 0, "slo_met": 0, "ttfts": []}
                for i in range(n_windows)]
        for tr in self.finished():
            wi = min(n_windows - 1,
                     max(0, int((tr.marks[0][1] - t0) / w)))
            row = rows[wi]
            row["finished"] += 1
            if tr.outcome == "done":
                row["done"] += 1
                b = blame(tr)
                if b["ttft_s"] is not None:
                    ttft_ms = b["ttft_s"] * 1e3
                    row["ttfts"].append(ttft_ms)
                    if slo_ttft_ms and ttft_ms <= slo_ttft_ms:
                        row["slo_met"] += 1
            else:
                row["shed"] += 1
        from .. import observability as _obs
        for row in rows:
            ttfts = row.pop("ttfts")
            row["ttft_ms_p50"] = (None if not ttfts else
                                  round(_pctl(ttfts, 50), 6))
            row["ttft_ms_p95"] = (None if not ttfts else
                                  round(_pctl(ttfts, 95), 6))
            if slo_ttft_ms and row["done"]:
                att = row["slo_met"] / row["done"]
                burn = (1.0 - att) / max(1e-9, 1.0 - slo_target)
                row["attainment"] = round(att, 6)
                row["burn_rate"] = round(burn, 6)
            else:
                row["attainment"] = None
                row["burn_rate"] = None
            _obs.gauge(
                "serving_slo_burn_rate",
                "per-window SLO error-budget burn rate: (1 - window "
                "attainment) / (1 - SLO target); 1.0 burns the budget "
                "exactly at the allowed rate, 0 is a clean window"
                ).labels(window=str(row["window"])).set(
                    row["burn_rate"] if row["burn_rate"] is not None
                    else 0.0)
        return rows


#: the process-wide store every engine/router records into (tests and
#: replays call ``reset()`` between runs)
_STORE = TraceStore()


def store() -> TraceStore:
    return _STORE


def begin(rid: int, t: float, track: str, **meta) -> bool:
    return _STORE.begin(rid, t, track, **meta)


def mark(rid: int, kind: str, t: float, track: str) -> bool:
    return _STORE.mark(rid, kind, t, track)


def annotate(rid: int, **meta) -> bool:
    return _STORE.annotate(rid, **meta)


def finish(rid: int, t: float, track: str, outcome: str,
           reason: Optional[str] = None) -> bool:
    return _STORE.finish(rid, t, track, outcome, reason)


def get(rid: int) -> Optional[dict]:
    return _STORE.get(rid)


def reset():
    _STORE.reset()


def blame_summary() -> dict:
    return _STORE.blame_summary()


def ttft_p95_ms() -> Optional[float]:
    return _STORE.ttft_p95_ms()


def export_chrome_trace(path: Optional[str] = None) -> dict:
    return _STORE.export_chrome_trace(path)


def export_spans_jsonl(path: Optional[str] = None) -> str:
    return _STORE.export_spans_jsonl(path)


def window_snapshots(n_windows: int, span_s: float,
                     slo_ttft_ms: float = 0.0,
                     slo_target: float = 0.99,
                     t0: float = 0.0) -> List[dict]:
    return _STORE.window_snapshots(n_windows, span_s, slo_ttft_ms,
                                   slo_target, t0)
