"""The device-cost observatory — the counterpart of
``paddle_tpu/observability/devprof.py``: cost capture, sampled device
timing and the decode blame split, off by default
(``FLAGS_serving_devprof``).

- **Cost capture.** When a serving step specialises (a CUDA graph
  captured on the card, a new input signature on the CPU: the
  :mod:`.compile_tracker`'s compile), the step reports its entry's cost
  through :func:`note_cost`: ``flops``, ``hbm_bytes`` and ``out_bytes``
  per site and signature, into :func:`cost_table` and the
  ``xla_cost{fn,metric}`` gauges. The reference lowers the function out
  of band and reads XLA's ``cost_analysis()``; the port has no XLA and
  counts from the entry's input shapes and the model's configuration
  instead (``models/generation.py:_entry_cost``), as a roofline counts:
  the FLOPs of every matmul (2 x rows x in x out per linear, the two
  attention products over every position the block tables name, the
  logits), and the bytes of every input read once (parameters, the
  named KV blocks, the small inputs) and every output written once.
  Nothing is replayed, captured or written for it.

- **Sampled timing.** An engine owns a :class:`DevProfiler`; the
  reference's deterministic hash of the dispatch counter picks which
  dispatches are timed, so both packages sample the same dispatches for
  the same fraction. A :class:`StepTimer` splits a sampled step into
  device and host time. On the card the device time is a pair of CUDA
  events around the graph's replay on the engine's stream
  (:func:`~paddle_tpu_torch.jit.timed_replays`), read after the host's
  read of the step's tokens (which already waited), so a sample adds no
  synchronize; the host time is the rest of the step's wall time. On
  the CPU, or under a clock other than ``time.perf_counter`` (a
  ``VirtualClock``), the split is the reference's arithmetic on the
  engine clock, so virtual-clock runs stay deterministic.

- **Blame split.** :meth:`DevProfiler.device_frac` is the sampled device
  share; the engine annotates it onto each finished trace and
  ``tracing.blame()`` splits ``decode`` into ``decode_device`` +
  ``decode_host`` with the exact reconciliation identity.

Peaks: pinned flags win; otherwise the CPU takes the reference's CPU
nominals (1e11 FLOP/s, 50 GB/s), an H100 its data sheet (3.35 TB/s; 989
TFLOP/s for bf16/fp16 matmuls, 495 for TF32, 67 for f32), and any other
card raises until the flags are pinned.

``paddle_tpu_torch/tools/perf_ledger.py`` / ``perf_regress.py`` persist
the numbers (plus a cost-table digest) as a perf trajectory.
"""

from __future__ import annotations

import hashlib
import json
import threading
from typing import Any, Dict, List, Optional

import torch

from .. import flags as _flags
from .compile_tracker import _qualname

#: the CPU's nominal peaks (the reference's)
_CPU_FLOPS, _CPU_HBM_GBPS = 1e11, 50.0
#: one H100 SXM (NVIDIA's data sheet, dense rates): FLOP/s by the dtype
#: an entry's matmuls run in, and HBM GB/s
_H100_FLOPS = {"bf16": 989e12, "fp16": 989e12, "tf32": 495e12,
               "f32": 67e12}
_H100_HBM_GBPS = 3350.0

_lock = threading.Lock()
#: qualified site name -> {"signature", "flops", "hbm_bytes",
#: "out_bytes", "captures", "supported"} (latest signature wins)
_COSTS: Dict[str, Dict[str, Any]] = {}
#: live DevProfiler instances with >= 1 sample feed the export embeds
_PROFILERS: List["DevProfiler"] = []


def enabled() -> bool:
    """The master switch: FLAGS_serving_devprof."""
    return bool(_flags.get_flag("serving_devprof"))


def note_cost(name: str, labels: Optional[Dict[str, str]], signature: str,
              cost: Dict[str, float]) -> Optional[dict]:
    """Record the counted cost (``flops``, ``hbm_bytes``, ``out_bytes``)
    of site ``(name, labels)`` at ``signature``, the call that made the
    step specialise. No-op unless FLAGS_serving_devprof. Returns the
    recorded entry."""
    if not enabled():
        return None
    qual = _qualname(name, dict(labels or {}))
    entry = {"flops": float(cost["flops"]),
             "hbm_bytes": float(cost["hbm_bytes"]),
             "out_bytes": float(cost["out_bytes"]),
             "signature": signature, "supported": True}
    with _lock:
        rec = _COSTS.setdefault(qual, {"captures": 0})
        rec.update(entry)
        rec["captures"] += 1
    from . import metrics as _metrics
    g = _metrics.DEFAULT.gauge(
        "xla_cost",
        "XLA cost_analysis() of the latest compile per tracked site "
        "(metric: flops | hbm_bytes | out_bytes)")
    for metric in ("flops", "hbm_bytes", "out_bytes"):
        g.labels(fn=qual, metric=metric).set(entry[metric])
    from . import runlog as _runlog
    if _runlog.enabled():
        _runlog.log_event("devprof_cost", fn=qual, flops=entry["flops"],
                          hbm_bytes=entry["hbm_bytes"],
                          out_bytes=entry["out_bytes"])
    with _lock:
        return dict(_COSTS[qual])


def cost_table() -> Dict[str, Dict[str, Any]]:
    """Snapshot of captured costs, keyed by qualified site name
    (``decode_step_paged``, ``decode_megastep_paged{n=4}``,
    ``serving_prefill_paged{bucket=16}``, ...)."""
    with _lock:
        return {k: dict(v) for k, v in sorted(_COSTS.items())}


def cost_digest() -> Optional[str]:
    """Stable short digest of the cost table (flops/bytes per site,
    signatures excluded); the perf ledger stores it, so a cost change
    shows as a digest change even where wall-clock metrics hide it."""
    with _lock:
        if not _COSTS:
            return None
        doc = {k: [v.get("flops"), v.get("hbm_bytes"),
                   v.get("out_bytes")]
               for k, v in sorted(_COSTS.items())}
    return hashlib.sha256(
        json.dumps(doc, sort_keys=True).encode()).hexdigest()[:16]


def _dtype_key(dtype) -> str:
    """The matmul rate class of ``dtype``: f32 matmuls run as TF32 where
    torch allows it."""
    if dtype in (torch.bfloat16, torch.float16):
        return "bf16" if dtype == torch.bfloat16 else "fp16"
    return "tf32" if torch.backends.cuda.matmul.allow_tf32 else "f32"


def peaks(device=None, dtype=None) -> Dict[str, float]:
    """The roofline peaks for an engine on ``device`` (None: the CPU)
    whose matmuls run in ``dtype``: the pinned flags when set, else the
    CPU nominals or, on an H100, its data sheet. Any other card raises
    until both flags are pinned."""
    g = _flags.get_flags(["devprof_peak_flops", "devprof_peak_hbm_gbps"])
    flops = float(g["devprof_peak_flops"])
    hbm = float(g["devprof_peak_hbm_gbps"])
    if flops <= 0 or hbm <= 0:
        dev = torch.device(device if device is not None else "cpu")
        if dev.type == "cpu":
            nominal = (_CPU_FLOPS, _CPU_HBM_GBPS)
        else:
            name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                    else str(dev))
            if "H100" not in name:
                raise RuntimeError(
                    f"devprof has no nominal peaks for {name!r}: pin "
                    "FLAGS_devprof_peak_flops and FLAGS_devprof_peak_hbm_gbps "
                    "to its data sheet")
            nominal = (_H100_FLOPS[_dtype_key(dtype or torch.float32)],
                       _H100_HBM_GBPS)
        flops = flops if flops > 0 else nominal[0]
        hbm = hbm if hbm > 0 else nominal[1]
    return {"peak_flops": flops, "peak_bytes_per_s": hbm * 1e9}


class DevProfiler:
    """One engine's sampled device timer and roofline aggregator.

    The engine calls :meth:`tick` once per step dispatch (under its
    step lock); True means this dispatch is timed (a
    :class:`StepTimer`, whose :meth:`StepTimer.finish` calls
    :meth:`note_step`). A False costs one integer hash. ``device`` and
    ``dtype`` (the engine's device and its matmuls' dtype) pick the
    nominal peaks when ``peak_flops`` / ``peak_bytes_per_s`` are not
    given (:func:`peaks`)."""

    def __init__(self, sample: Optional[float] = None,
                 peak_flops: Optional[float] = None,
                 peak_bytes_per_s: Optional[float] = None,
                 gauge_labels: Optional[Dict[str, str]] = None, *,
                 device=None, dtype=None):
        if sample is None:
            sample = float(_flags.get_flag("serving_devprof_sample"))
        if not (0.0 <= sample <= 1.0):
            raise ValueError(
                f"devprof sample must be in [0, 1], got {sample}")
        if peak_flops is None or peak_bytes_per_s is None:
            nominal = peaks(device, dtype)
            peak_flops = (nominal["peak_flops"] if peak_flops is None
                          else peak_flops)
            peak_bytes_per_s = (nominal["peak_bytes_per_s"]
                                if peak_bytes_per_s is None
                                else peak_bytes_per_s)
        self.sample = float(sample)
        self.peak_flops = float(peak_flops)
        self.peak_bytes_per_s = float(peak_bytes_per_s)
        self._labels = dict(gauge_labels or {})
        self._lock = threading.Lock()
        self._dispatches = 0
        self._samples = 0
        self._device_s = 0.0
        self._host_s = 0.0
        #: per-entry aggregates: name -> [samples, device_s, host_s]
        self._entries: Dict[str, List[float]] = {}
        self._registered = False
        self._gauges = None

    # ------------------------------------------------------- sampling
    def tick(self) -> bool:
        """Advance the dispatch counter; True = time this dispatch. The
        reference's Knuth-hash decision, a pure function of the counter,
        so two same-seed runs sample the same step indices."""
        with self._lock:
            i = self._dispatches
            self._dispatches += 1
        if self.sample <= 0.0:
            return False
        if self.sample >= 1.0:
            return True
        return ((i * 2654435761) % (2 ** 32)) / (2 ** 32) < self.sample

    # ------------------------------------------------------ recording
    def _gauge_handles(self):
        if self._gauges is None:
            from . import metrics as _metrics
            reg = _metrics.DEFAULT
            self._gauges = {
                "mfu": reg.gauge(
                    "serving_mfu",
                    "model FLOPs utilization of sampled step "
                    "dispatches: captured cost_analysis flops / "
                    "(sampled device seconds * peak FLOP/s)"
                    ).labels(**self._labels),
                "hbm": reg.gauge(
                    "serving_hbm_util",
                    "HBM bandwidth utilization of sampled step "
                    "dispatches: cost_analysis bytes accessed / "
                    "(sampled device seconds * peak bytes/s)"
                    ).labels(**self._labels),
                "host": reg.gauge(
                    "serving_host_overhead_share",
                    "host share of sampled step wall time: host_s / "
                    "(host_s + device_s) — the number decode "
                    "megasteps exist to shrink"
                    ).labels(**self._labels),
                "hist": reg.histogram(
                    "serving_device_step_ms",
                    "sampled device ms per step dispatch, per "
                    "compiled entry"),
            }
        return self._gauges

    def note_step(self, entry: str, device_s: float, host_s: float):
        """Record one sampled dispatch's device and host seconds; feeds
        the per-entry histogram and the live roofline gauges."""
        device_s = max(0.0, float(device_s))
        host_s = max(0.0, float(host_s))
        with self._lock:
            self._samples += 1
            self._device_s += device_s
            self._host_s += host_s
            agg = self._entries.setdefault(entry, [0, 0.0, 0.0])
            agg[0] += 1
            agg[1] += device_s
            agg[2] += host_s
        with _lock:
            if not self._registered:
                self._registered = True
                _PROFILERS.append(self)
        g = self._gauge_handles()
        g["hist"].labels(fn=entry).observe(device_s * 1e3)
        g["host"].set(self.host_share() or 0.0)
        roof = self.roofline(entry)
        if roof["mfu"] is not None:
            g["mfu"].set(roof["mfu"])
        if roof["hbm_util"] is not None:
            g["hbm"].set(roof["hbm_util"])

    # -------------------------------------------------------- queries
    def device_frac(self) -> Optional[float]:
        """Sampled device share of step time, the decode blame-split
        fraction. None until a sample with nonzero time exists (a
        virtual-clock run whose samples are all zero stays
        unannotated)."""
        with self._lock:
            tot = self._device_s + self._host_s
            if self._samples == 0 or tot <= 0.0:
                return None
            return self._device_s / tot

    def host_share(self) -> Optional[float]:
        f = self.device_frac()
        return None if f is None else 1.0 - f

    def roofline(self, entry: str) -> Dict[str, Any]:
        """One entry's roofline verdict from its sampled device time
        joined against its captured cost: ``compute-bound`` vs
        ``hbm-bound`` by which utilization dominates, ``host-bound``
        when the sampled host share exceeds the device share,
        ``unattributed`` without a cost capture."""
        with self._lock:
            agg = self._entries.get(entry)
            samples, dev_s, host_s = (agg if agg else (0, 0.0, 0.0))
        with _lock:
            cost = dict(_COSTS.get(entry, {}))
        flops, hbm = cost.get("flops"), cost.get("hbm_bytes")
        mfu = hbm_util = None
        if samples and dev_s > 0:
            per_dispatch = dev_s / samples
            if flops:
                mfu = flops / (per_dispatch * self.peak_flops)
            if hbm:
                hbm_util = hbm / (per_dispatch * self.peak_bytes_per_s)
        if samples and host_s > dev_s:
            verdict = "host-bound"
        elif mfu is None and hbm_util is None:
            verdict = "unattributed"
        elif (mfu or 0.0) >= (hbm_util or 0.0):
            verdict = "compute-bound"
        else:
            verdict = "hbm-bound"
        return {
            "entry": entry,
            "samples": samples,
            "device_ms_mean": (round(dev_s / samples * 1e3, 6)
                               if samples else None),
            "host_ms_mean": (round(host_s / samples * 1e3, 6)
                             if samples else None),
            "flops": flops,
            "hbm_bytes": hbm,
            "mfu": None if mfu is None else round(mfu, 6),
            "hbm_util": (None if hbm_util is None
                         else round(hbm_util, 6)),
            "verdict": verdict,
        }

    def entries(self) -> List[str]:
        with self._lock:
            return sorted(self._entries)

    def stats(self) -> dict:
        """The ``/v1/stats`` devprof section."""
        with self._lock:
            dispatches, samples = self._dispatches, self._samples
        frac = self.device_frac()
        return {
            "sample": self.sample,
            "dispatches": dispatches,
            "samples": samples,
            "device_frac": (None if frac is None
                            else round(frac, 6)),
            "host_overhead_share": (None if frac is None
                                    else round(1.0 - frac, 6)),
            "mfu": self.mfu(),
            "entries": [self.roofline(e) for e in self.entries()],
        }

    def mfu(self) -> Optional[float]:
        """Aggregate MFU over every sampled entry with a cost: total
        sampled flops / (total sampled device seconds * peak)."""
        costs = cost_table()
        flops_total = dev_total = 0.0
        with self._lock:
            items = [(e, list(a)) for e, a in self._entries.items()]
        for entry, (samples, dev_s, _h) in items:
            f = costs.get(entry, {}).get("flops")
            if f and dev_s > 0:
                flops_total += f * samples
                dev_total += dev_s
        if dev_total <= 0.0:
            return None
        return round(flops_total / (dev_total * self.peak_flops), 6)


def roofline_entries() -> List[dict]:
    """Every registered profiler's per-entry roofline rows, the trace
    exports' embed (chrome ``devprof`` metadata events / JSONL
    ``{"devprof": ...}`` lines). Empty when nothing sampled, so
    devprof-off exports are byte-identical to before."""
    with _lock:
        profs = list(_PROFILERS)
    out = []
    for p in profs:
        out.extend(p.roofline(e) for e in p.entries())
    return out


def reset():
    """Drop captured costs and registered profilers (tests)."""
    with _lock:
        _COSTS.clear()
        _PROFILERS.clear()


class StepTimer:
    """The split of one sampled step::

        timer = StepTimer(profiler, entry, clock, device=...)
        with jit.timed_replays(timer):
            ... dispatch ...     # card: begin() / end() around the replay
        ... the host reads the step's tokens ...
        timer.device_done(out)   # card: read the events; else stamp
        ... host commit work ...
        timer.finish()           # records the split

    With a CUDA ``device`` (the engine passes one only with the real
    clock) the device time is that of the event pair the replay recorded;
    the host time is the rest of the step's wall time on ``clock``.
    Otherwise, or where no replay ran (the dispatch captured its graph),
    ``device_done`` stamps ``clock`` and the split is the reference's:
    dispatch to device-done, device-done to finish."""

    def __init__(self, profiler: DevProfiler, entry: str, clock, *,
                 device=None):
        self._p = profiler
        self._entry = entry
        self._clock = clock
        self._events = None
        self._replayed = False
        if device is not None and torch.device(device).type == "cuda":
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
        self._t0 = clock()
        self._t_dev: Optional[float] = None
        self._device_s: Optional[float] = None

    def begin(self):
        """Just before the replay, on its stream."""
        if self._events is not None:
            self._events[0].record()

    def end(self):
        """Just after the replay, on its stream."""
        if self._events is not None:
            self._events[1].record()
            self._replayed = True

    def device_done(self, out):
        if self._replayed:
            # the host has read the step's tokens, which the stream
            # produced after the end event: both events are complete
            self._device_s = self._events[0].elapsed_time(
                self._events[1]) / 1e3
        else:
            self._t_dev = self._clock()
        return out

    def finish(self):
        t_end = self._clock()
        if self._device_s is not None:
            device_s = self._device_s
            host_s = (t_end - self._t0) - device_s
        else:
            t_dev = self._t_dev if self._t_dev is not None else t_end
            device_s, host_s = t_dev - self._t0, t_end - t_dev
        self._p.note_step(self._entry, device_s=device_s, host_s=host_s)

