#!/usr/bin/env python
"""Open-loop load generator for the port's serving plane, the port's own
copy of ``tools/loadgen.py``: it drives a
:class:`~paddle_tpu_torch.serving.ServingEngine`,
:class:`~paddle_tpu_torch.serving.ReplicaRouter` or
:class:`~paddle_tpu_torch.serving.DisaggRouter` directly with a
replayable synthetic arrival process and reports goodput under the TTFT
SLO. The schedule is drawn from ``np.random.RandomState(seed)`` exactly
as the reference draws it, so one seed gives the same arrivals, the same
``trace_bytes()`` and, on a :class:`VirtualClock` with pinned predictor
costs, the same admit/shed decisions in both packages.

Arrival processes: ``poisson`` (constant rate), ``bursty`` (a two-state
Markov-modulated Poisson process: calm at ``rate``, bursts at ``rate *
burst_factor``) and ``diurnal`` (a sinusoidal rate). Each arrival
carries a prompt and a new-token budget from a mixed length distribution
(70% on the lower half of the range, 30% on the upper half), a priority
class from ``priority_mix``, with ``sample_frac`` seeded sampling
parameters and with ``tenant_mix`` (``base:0.5,acme:0.3,zeta:0.2``) a
LoRA tenant; the report then counts outcomes per tenant and the leaked
adapter pages. Returning users (``returning_frac`` with
``turns_per_session``, the host KV tier on): a seeded fraction of
arrivals open a multi-turn session whose later turns arrive after idle
gaps and submit with ``session=<id>``; the report gains a ``sessions``
section (offered, turns, resumed, the host tier's peaks and migrations,
its leaked blocks). Every such draw comes from a stream of its own, so
seeds without them keep their traces byte for byte.

Execution: on the wall clock (the target is stepped between releases)
or on a :class:`VirtualClock` (the engines built with ``clock=vc.now``;
each step advances it ``step_cost_ms``; fully deterministic). Release:
open loop, or ``closed_loop`` clients that wait for their request, think
for a seeded time and may abandon it mid-decode (a fleet
``cancel(reason="disconnect")``). A trace may carry a chaos schedule of
``kill`` / ``restart`` events (a replica router's) and ``kill_decode`` /
``kill_prefill`` events (a disaggregated fleet's) fired on the run's
clock. The report counts offered load, goodput, throughput, attainment,
sheds and cancels by reason, latency percentiles, leaked KV blocks (after
a prefix-cache flush, each pool once) and unexpected exceptions, with a
hedging router the hedges and with a disaggregated fleet its roles,
handoffs and affinity counters.

``--devprof`` turns the device-cost observatory on for every engine the
run builds (the report gains its ``devprof`` section) and ``--ledger``
appends the run's headline metrics as one
:mod:`~paddle_tpu_torch.tools.perf_ledger` row. :func:`warmup` warms
every engine of a target (the reference's warms those its requests land
on): a graph holds its
replica's pools. A disaggregated fleet's workers are warmed by role:
every prefill worker at every bucket, every decode worker's decode
through a handoff it adopts. A LoRA engine's steps are its own graphs,
warmed the same way (base rows suffice: pages are data); with
``sampled=True`` the sampled graphs are warmed too.

CLI, from the repository root (on the card; ``--device cpu`` runs on
the CPU, for a small model):

    python3 -m paddle_tpu_torch.tools.loadgen --model gpt2-medium \
        --mode bursty --rate 40 --duration 2 --seed 0 --slots 4 \
        --max-len 64 --buckets 16,32 --prompt-tokens 4:15 \
        --new-tokens 2:8 --slo-ttft-ms 100 --json --expect-zero-leaks
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
from typing import List, NamedTuple, Optional, Tuple

import numpy as np

class Arrival(NamedTuple):
    t: float               # seconds since the run started
    prompt: Tuple[int, ...]
    max_new_tokens: int
    priority: int
    # per-request decoding fields (sampling-as-data; the defaults
    # reproduce the pre-decoding greedy trace byte for byte)
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0
    tenant: str = ""       # "" = base weights (no LoRA adapter)
    # client patience: > 0 means the closed-loop client hangs up
    # (fleet cancel) once this fraction of the new-token budget has
    # been produced — the abandonment workload; 0 = patient client
    abandon_after: float = 0.0
    # returning-user conversation id ("" = one-shot request): turns
    # sharing a session submit with session=<id> so the host KV tier
    # resumes the stored context after an idle gap
    session: str = ""


class VirtualClock:
    """Deterministic time source for replayable runs: pass ``vc.now``
    as the engine's ``clock`` and let the loadgen loop ``advance`` it
    a fixed cost per scheduler step."""

    def __init__(self, start: float = 0.0):
        self.t = float(start)

    def now(self) -> float:
        return self.t

    def advance(self, dt: float):
        if dt < 0:
            raise ValueError(f"cannot rewind the clock by {dt}")
        self.t += dt


class LoadGen:
    """Replayable open-loop traffic source; see the module docstring.

    ``rate`` is the calm/mean arrival rate in requests/s (``bursty``
    exceeds it during bursts, ``diurnal`` oscillates around it);
    ``duration`` is the arrival window in seconds — the run itself
    continues until the target drains. ``prompt_tokens`` /
    ``new_tokens`` are inclusive (lo, hi) ranges; ``priority_mix``
    maps priority class -> weight (default: everything class 1).
    """

    MODES = ("poisson", "bursty", "diurnal")

    def __init__(self, mode: str = "poisson", rate: float = 8.0,
                 duration: float = 4.0, seed: int = 0,
                 vocab_size: int = 1024,
                 prompt_tokens: Tuple[int, int] = (4, 24),
                 new_tokens: Tuple[int, int] = (2, 16),
                 priority_mix: Optional[dict] = None,
                 burst_factor: float = 8.0,
                 burst_fraction: float = 0.25,
                 switch_every: float = 1.0,
                 diurnal_period: Optional[float] = None,
                 diurnal_amplitude: float = 0.8,
                 sample_frac: float = 0.0,
                 tenant_mix: Optional[dict] = None,
                 closed_loop: int = 0,
                 think_time_ms: Tuple[float, float] = (0.0, 0.0),
                 abandon_frac: float = 0.0,
                 returning_frac: float = 0.0,
                 turns_per_session: Tuple[int, int] = (2, 4)):
        if mode not in self.MODES:
            raise ValueError(f"mode must be one of {self.MODES}, "
                             f"got {mode!r}")
        if rate <= 0 or duration <= 0:
            raise ValueError("rate and duration must be > 0")
        if not (0 < diurnal_amplitude < 1) and mode == "diurnal":
            raise ValueError("diurnal_amplitude must be in (0, 1)")
        for lo, hi, name in [(prompt_tokens[0], prompt_tokens[1],
                              "prompt_tokens"),
                             (new_tokens[0], new_tokens[1],
                              "new_tokens")]:
            if lo < 1 or hi < lo:
                raise ValueError(f"{name} must satisfy 1 <= lo <= hi")
        self.mode = mode
        self.rate = float(rate)
        self.duration = float(duration)
        self.seed = int(seed)
        self.vocab_size = int(vocab_size)
        self.prompt_tokens = (int(prompt_tokens[0]),
                              int(prompt_tokens[1]))
        self.new_tokens = (int(new_tokens[0]), int(new_tokens[1]))
        mix = priority_mix if priority_mix else {1: 1.0}
        total = float(sum(mix.values()))
        if total <= 0 or any(w < 0 for w in mix.values()):
            raise ValueError("priority_mix weights must be >= 0 with a "
                             "positive sum")
        self._pri_vals = sorted(int(p) for p in mix)
        self._pri_probs = [float(mix[p]) / total for p in self._pri_vals]
        self.burst_factor = float(burst_factor)
        self.burst_fraction = float(burst_fraction)
        self.switch_every = float(switch_every)
        self.diurnal_period = float(diurnal_period if diurnal_period
                                    else duration)
        self.diurnal_amplitude = float(diurnal_amplitude)
        # Per-request decoding mix. The decode-field draws are gated on
        # the feature being on at all so a plain greedy generator
        # consumes the RNG stream exactly as before — old seeds keep
        # producing old traces byte for byte.
        if not (0.0 <= float(sample_frac) <= 1.0):
            raise ValueError("sample_frac must be in [0, 1]")
        self.sample_frac = float(sample_frac)
        tmix = dict(tenant_mix) if tenant_mix else {}
        tt = float(sum(tmix.values()))
        if tmix and (tt <= 0 or any(w < 0 for w in tmix.values())):
            raise ValueError("tenant_mix weights must be >= 0 with a "
                             "positive sum")
        # "base" / "" both mean the base weights (no adapter page)
        self._tenant_vals = sorted(
            "" if n in ("", "base") else str(n) for n in tmix)
        self._tenant_probs = [float(tmix[n]) / tt for n in sorted(
            tmix, key=lambda n: "" if n in ("", "base") else str(n))]
        self._decoded = bool(tmix) or self.sample_frac > 0
        if closed_loop < 0:
            raise ValueError("closed_loop must be >= 0 "
                             "(0 = open loop)")
        lo, hi = (float(think_time_ms[0]), float(think_time_ms[1]))
        if lo < 0 or hi < lo:
            raise ValueError("think_time_ms must satisfy 0 <= lo <= hi")
        self.closed_loop = int(closed_loop)
        self.think_time_ms = (lo, hi)
        # Abandonment draws come from their own RandomState (like the
        # think times), so abandon-free seeds keep producing their old
        # traces byte for byte.
        if not (0.0 <= float(abandon_frac) <= 1.0):
            raise ValueError("abandon_frac must be in [0, 1]")
        self.abandon_frac = float(abandon_frac)
        self._abandon = self.abandon_frac > 0
        # Returning users: a seeded fraction of arrivals open a
        # multi-turn session — follow-up turns arrive after an idle
        # gap and submit with session=<id> so the host KV tier resumes
        # the stored context. All draws come from a dedicated
        # RandomState, so session-free seeds keep their byte-identical
        # traces.
        if not (0.0 <= float(returning_frac) <= 1.0):
            raise ValueError("returning_frac must be in [0, 1]")
        ta, tb = (int(turns_per_session[0]), int(turns_per_session[1]))
        if ta < 1 or tb < ta:
            raise ValueError(
                "turns_per_session must satisfy 1 <= A <= B")
        self.returning_frac = float(returning_frac)
        self.turns_per_session = (ta, tb)
        self._returning = self.returning_frac > 0
        #: chaos schedule replayed alongside the arrivals: dicts of
        #: {"t", "kind", "index"}; populated by from_trace or by hand
        self.chaos: List[dict] = []
        self._schedule: Optional[List[Arrival]] = None

    @classmethod
    def from_trace(cls, trace) -> "LoadGen":
        """Build a generator that replays a recorded trace instead of
        sampling one: ``trace`` is a path or a dict shaped like
        ``tools/trace_convert.py`` output (or ``trace_bytes()``) —
        ``{"arrivals": [[t, prompt, max_new_tokens, priority], ...]}``
        plus optional ``mode``/``rate``/``duration``/``seed`` metadata
        (nested under ``"meta"`` or top-level). The schedule is
        installed verbatim, so ``run()`` re-fights the recorded
        workload deterministically."""
        if isinstance(trace, (str, os.PathLike)):
            with open(trace) as f:
                trace = json.load(f)
        meta = dict(trace.get("meta") or {})
        for k in ("mode", "rate", "duration", "seed"):
            if k not in meta and k in trace:
                meta[k] = trace[k]
        arrivals = []
        for row in trace["arrivals"]:
            t, prompt, mnt, pri = row[:4]
            extra = ()
            if len(row) > 4:   # decode-bearing rows: 5 more fields
                extra = (float(row[4]), int(row[5]), float(row[6]),
                         int(row[7]), str(row[8]))
            if len(row) > 9:   # abandonment-bearing rows: col 10
                extra = extra + (float(row[9]),)
            if len(row) > 10:  # session-bearing rows: col 11
                extra = extra + (str(row[10]),)
            arrivals.append(Arrival(float(t),
                                    tuple(int(x) for x in prompt),
                                    int(mnt), int(pri), *extra))
        last_t = max((a.t for a in arrivals), default=0.0)
        duration = float(meta.get("duration") or 0.0)
        if duration <= 0:
            # metadata-free trace: synthesize a window covering the
            # recorded arrivals (session follow-up turns legitimately
            # land past the recorded window, so a recorded duration is
            # kept verbatim — byte-identical re-serialization)
            duration = last_t + 1e-6 if arrivals else 1.0
        rate = float(meta.get("rate") or 0.0)
        if rate <= 0:
            rate = max(len(arrivals) / duration, 1e-9)
        mode = meta.get("mode", "poisson")
        if mode not in cls.MODES:   # replayed traces keep MODES closed
            mode = "poisson"
        lg = cls(mode=mode, rate=rate, duration=duration,
                 seed=int(meta.get("seed", 0)))
        lg._schedule = arrivals
        # decode-bearing traces re-serialize with their decode fields
        lg._decoded = any(len(r) > 4 for r in trace["arrivals"])
        # abandonment-bearing traces re-serialize byte-identically too
        lg._abandon = any(len(r) > 9 for r in trace["arrivals"])
        if lg._abandon:
            lg.abandon_frac = 1.0   # marker; the schedule rows govern
        # session-bearing traces re-serialize byte-identically too
        lg._returning = any(len(r) > 10 for r in trace["arrivals"])
        if lg._returning:
            lg.returning_frac = 1.0   # marker; the rows govern
        # chaos rows ([t, kind, index]) replay kill/restart schedules
        lg.chaos = [{"t": float(r[0]), "kind": str(r[1]),
                     "index": int(r[2])}
                    for r in trace.get("chaos", [])]
        return lg

    # ---------------------------------------------------------- schedule
    def _burst_segments(self, rng) -> List[Tuple[float, float]]:
        """Alternating (start_time, rate) segments covering the
        arrival window — the modulating Markov chain, sampled once."""
        segs, t, calm = [], 0.0, True
        while t < self.duration:
            segs.append((t, self.rate if calm
                         else self.rate * self.burst_factor))
            mean = (self.switch_every if calm
                    else self.switch_every * self.burst_fraction)
            t += float(rng.exponential(mean))
            calm = not calm
        return segs

    def _sample_span(self, rng, lo: int, hi: int) -> int:
        """Mixed length distribution: 70% uniform on [lo, mid] (the
        chat-short mode), 30% uniform on [mid, hi] (doc-long)."""
        mid = (lo + hi) // 2
        if rng.uniform() < 0.7:
            return int(rng.randint(lo, mid + 1))
        return int(rng.randint(mid, hi + 1))

    def schedule(self) -> List[Arrival]:
        """The full arrival trace (cached; same seed => same trace).
        Arrivals are generated by thinning a peak-rate Poisson stream,
        consuming the RNG identically whether a candidate is kept or
        thinned — replayability does not depend on acceptance."""
        if self._schedule is not None:
            return self._schedule
        rng = np.random.RandomState(self.seed)
        ab_rng = np.random.RandomState(
            (self.seed * 2654435761 + 131) % (2 ** 32))
        if self.mode == "poisson":
            peak = self.rate
            segs = None
        elif self.mode == "bursty":
            peak = self.rate * self.burst_factor
            segs = self._burst_segments(rng)
        else:  # diurnal
            peak = self.rate * (1.0 + self.diurnal_amplitude)
            segs = None

        def rate_at(t: float) -> float:
            if self.mode == "poisson":
                return self.rate
            if self.mode == "diurnal":
                return self.rate * (1.0 + self.diurnal_amplitude *
                                    math.sin(2.0 * math.pi * t /
                                             self.diurnal_period))
            r = segs[0][1]
            for start, seg_rate in segs:
                if start > t:
                    break
                r = seg_rate
            return r

        out: List[Arrival] = []
        t = 0.0
        while True:
            t += float(rng.exponential(1.0 / peak))
            if t >= self.duration:
                break
            keep = float(rng.uniform()) * peak <= rate_at(t)
            plen = self._sample_span(rng, *self.prompt_tokens)
            mnt = self._sample_span(rng, *self.new_tokens)
            prompt = tuple(int(x) for x in
                           rng.randint(1, self.vocab_size, size=plen))
            pri = int(self._pri_vals[int(
                rng.choice(len(self._pri_vals), p=self._pri_probs))])
            extra = ()
            if self._decoded:
                # fixed draw count per candidate (kept or thinned,
                # sampled or greedy) — the same invariant as above
                u = float(rng.uniform())
                temp = round(0.5 + 0.5 * float(rng.uniform()), 3)
                tk = int(rng.choice([0, 8, 16]))
                tp = float(rng.choice([1.0, 0.95, 0.9]))
                sd = int(rng.randint(0, 2 ** 31 - 1))
                if u >= self.sample_frac:
                    temp, tk, tp, sd = 0.0, 0, 1.0, 0
                ten = ""
                if self._tenant_vals:
                    ten = self._tenant_vals[int(rng.choice(
                        len(self._tenant_vals), p=self._tenant_probs))]
                extra = (temp, tk, tp, sd, ten)
            ab = 0.0
            if self._abandon:
                # fixed draw count per candidate (kept or thinned):
                # u1 decides whether this client abandons, u2 picks how
                # far into the token budget it hangs up (25%..75%) —
                # always past the first token, so abandonment lands
                # mid-decode, never pre-admission
                u1 = float(ab_rng.uniform())
                u2 = float(ab_rng.uniform())
                if u1 < self.abandon_frac:
                    ab = round(0.25 + 0.5 * u2, 6)
            if keep:
                out.append(Arrival(round(t, 9), prompt, mnt, pri,
                                   *extra, abandon_after=ab))
        if self._returning and out:
            # A seeded fraction of arrivals open a session: the
            # arrival itself becomes turn 1 and T-1 follow-up turns
            # arrive after idle gaps long enough for the demotion
            # sweep to park the context in the host tier. Every draw
            # comes from this dedicated stream, so returning-free
            # seeds keep their byte-identical traces.
            sess_rng = np.random.RandomState(
                (self.seed * 2654435761 + 163) % (2 ** 32))
            followups: List[Arrival] = []
            sid = 0
            for j, a in enumerate(out):
                if float(sess_rng.uniform()) >= self.returning_frac:
                    continue
                sid += 1
                lo, hi = self.turns_per_session
                turns = int(sess_rng.randint(lo, hi + 1))
                out[j] = a._replace(session=str(sid))
                t = a.t
                for _ in range(turns - 1):
                    gap = float(sess_rng.uniform(0.25, 1.0)) * \
                        max(self.duration, 1e-3)
                    t = t + gap
                    plen = self._sample_span(sess_rng,
                                             *self.prompt_tokens)
                    mnt = self._sample_span(sess_rng,
                                            *self.new_tokens)
                    prompt = tuple(int(x) for x in sess_rng.randint(
                        1, self.vocab_size, size=plen))
                    followups.append(Arrival(
                        round(t, 9), prompt, mnt, a.priority,
                        session=str(sid)))
            out = sorted(out + followups, key=lambda a: a.t)
        self._schedule = out
        return out

    def trace_bytes(self) -> bytes:
        """Canonical JSON of the arrival schedule — the byte-identity
        surface of the determinism contract."""
        rows = []
        for a in self.schedule():
            row = [a.t, list(a.prompt), a.max_new_tokens, a.priority]
            if self._decoded or self._abandon or self._returning:
                # decode-bearing rows carry 5 more; abandonment and
                # session rows pad them (greedy defaults) so col 10
                # stays col 10
                row += [a.temperature, a.top_k, a.top_p, a.seed,
                        a.tenant]
            if self._abandon or self._returning:
                # abandonment-bearing rows add col 10; session rows
                # pad it so col 11 stays col 11
                row.append(a.abandon_after)
            if self._returning:   # session-bearing rows add col 11
                row.append(a.session)
            rows.append(row)
        payload = {
            "mode": self.mode, "rate": self.rate,
            "duration": self.duration, "seed": self.seed,
            "arrivals": rows,
        }
        if self.chaos:   # only chaos-bearing traces grow the key, so
            # chaos-free seeds keep their byte-identical traces
            payload["chaos"] = [
                [e["t"], e["kind"], e["index"]]
                for e in sorted(self.chaos, key=lambda e: e["t"])]
        return json.dumps(payload, sort_keys=True,
                          separators=(",", ":")).encode()

    # --------------------------------------------------------------- run
    @staticmethod
    def _engines(target) -> list:
        engs = getattr(target, "engines", None)
        if engs is None:
            return [target]
        return list(engs) + list(getattr(target, "_retiring", []))

    def run(self, target, clock: Optional[VirtualClock] = None,
            step_cost_ms: float = 0.0,
            slo_ttft_ms: Optional[float] = None,
            include_trace: bool = False,
            max_steps: int = 200_000,
            on_step=None) -> dict:
        """Release the schedule open-loop into ``target`` and drive it
        to drain; returns the report dict.

        With ``clock`` the run is virtual: the target's engines must
        share the same clock (``clock=vc.now`` at construction) and
        each scheduler step advances it ``step_cost_ms``. Without it,
        arrivals ride the wall clock. ``slo_ttft_ms`` sets a post-hoc
        SLO for goodput when the engines run without one (the
        depth-only baseline); engines with their own SLO use their
        deadline verdicts. ``on_step`` (called with the 0-based step
        index after each scheduler step) is the deterministic
        mid-burst hook — hot-swap-under-load tests fire
        ``swap_weights`` from it at an exact step."""
        arrivals = self.schedule()
        records = [{"i": i, "t": a.t, "prompt_tokens": len(a.prompt),
                    "max_new_tokens": a.max_new_tokens,
                    "priority": a.priority,
                    "sampled": a.temperature > 0,
                    "tenant": a.tenant,
                    "abandon_after": a.abandon_after,
                    "session": a.session,
                    "abandoned": False, "outcome": None,
                    "reason": None, "req": None}
                   for i, a in enumerate(arrivals)]
        from ..serving import QueueFullError
        exceptions = 0
        t0 = clock.now() if clock is not None else time.perf_counter()

        def now_s() -> float:
            return ((clock.now() if clock is not None
                     else time.perf_counter()) - t0)

        def release(rec, arr):
            nonlocal exceptions
            kw = {}
            if arr.temperature > 0:   # sampled row: full decode params
                kw.update(temperature=arr.temperature, top_k=arr.top_k,
                          top_p=arr.top_p, seed=arr.seed)
            if arr.tenant:
                kw["tenant"] = arr.tenant
            if arr.session:
                kw["session"] = arr.session
            try:
                rec["req"] = target.submit(
                    list(arr.prompt), max_new_tokens=arr.max_new_tokens,
                    priority=arr.priority, **kw)
                rec["outcome"] = "admitted"
            except QueueFullError as e:
                rec["outcome"] = "rejected"
                rec["reason"] = getattr(e, "reason", "queue_full")
            except ValueError as e:
                rec["outcome"] = "invalid"
                rec["reason"] = str(e)
            except Exception as e:   # graceful degradation: count, go on
                exceptions += 1
                rec["outcome"] = "error"
                rec["reason"] = f"{type(e).__name__}: {e}"

        chaos = sorted(self.chaos, key=lambda e: (e["t"], e["kind"]))
        ci = 0
        chaos_applied = 0

        def fire_chaos():
            nonlocal ci, chaos_applied
            while ci < len(chaos) and chaos[ci]["t"] <= now_s():
                chaos_applied += int(
                    self._apply_chaos(target, chaos[ci]))
                ci += 1

        i, steps = 0, 0
        if self.closed_loop:
            # N clients, each: wait for completion, think (a separate
            # RandomState — the open-loop schedule stream is untouched,
            # so open-loop seeds stay byte-identical), release the next
            # scheduled arrival's content at the loop's own pace
            think_rng = np.random.RandomState(
                (self.seed * 2654435761 + 97) % (2 ** 32))
            lo, hi = self.think_time_ms

            def think_s() -> float:
                return (lo + (hi - lo) *
                        float(think_rng.uniform())) / 1e3

            free_at = [0.0] * self.closed_loop
            pending: List[Optional[dict]] = [None] * self.closed_loop
            while True:
                fire_chaos()
                now = now_s()
                for c in range(self.closed_loop):
                    rec = pending[c]
                    if rec is not None:
                        req = rec["req"]
                        if req is not None and \
                                req.state not in ("done", "shed",
                                                  "canceled"):
                            # impatient client: once enough of the
                            # token budget has landed, hang up — a
                            # fleet-wide cancel that must reclaim every
                            # block (the abandonment workload)
                            if rec["abandon_after"] > 0 and \
                                    not rec["abandoned"] and \
                                    req.first_token_at is not None and \
                                    len(req.tokens) >= max(1, math.ceil(
                                        rec["abandon_after"] *
                                        rec["max_new_tokens"])):
                                rec["abandoned"] = True
                                target.cancel(req.id,
                                              reason="disconnect")
                            continue
                        done_at = now
                        if req is not None and \
                                req.finished_at is not None:
                            done_at = max(0.0, req.finished_at - t0)
                        free_at[c] = done_at + think_s()
                        pending[c] = None
                    if i < len(arrivals) and free_at[c] <= now:
                        rec = records[i]
                        rec["t"] = round(now, 9)  # actual release time
                        release(rec, arrivals[i])
                        i += 1
                        if rec["outcome"] == "admitted":
                            pending[c] = rec
                        else:
                            free_at[c] = now + think_s()
                if i >= len(arrivals) and target.idle and \
                        all(p is None for p in pending):
                    break
                if target.idle:
                    nxt = min((free_at[c]
                               for c in range(self.closed_loop)
                               if pending[c] is None), default=now)
                    gap = nxt - now
                    if gap > 0:
                        if clock is not None:
                            clock.advance(gap)
                        else:
                            time.sleep(min(gap, 0.05))
                    continue
                target.step()
                if on_step is not None:
                    on_step(steps)
                if clock is not None:
                    clock.advance(step_cost_ms / 1e3)
                steps += 1
                if steps >= max_steps:
                    raise RuntimeError(
                        f"loadgen target not drained after "
                        f"{max_steps} steps")
        else:
            while i < len(arrivals) or not target.idle:
                fire_chaos()
                while i < len(arrivals) and arrivals[i].t <= now_s():
                    release(records[i], arrivals[i])
                    i += 1
                if target.idle:
                    if i >= len(arrivals):
                        break
                    gap = arrivals[i].t - now_s()
                    if clock is not None:
                        clock.advance(max(0.0, gap))
                    else:
                        time.sleep(min(max(gap, 0.0), 0.05))
                    continue
                target.step()
                if on_step is not None:
                    on_step(steps)
                if clock is not None:
                    clock.advance(step_cost_ms / 1e3)
                steps += 1
                if steps >= max_steps:
                    raise RuntimeError(
                        f"loadgen target not drained after "
                        f"{max_steps} steps")
        makespan = max(now_s(), 1e-9)
        return self._report(records, makespan, steps, slo_ttft_ms,
                            target, exceptions, include_trace,
                            t0=t0, chaos_applied=chaos_applied)

    @staticmethod
    def _apply_chaos(target, ev: dict) -> bool:
        """Fire one recorded chaos event against the target; returns
        whether it applied. A fleet whose shape diverged from the
        recording (fewer replicas, different roles) skips events it
        cannot map rather than crashing the replay."""
        kind, idx = ev["kind"], int(ev["index"])
        try:
            if kind == "restart":
                target.restart_replica(idx)
            elif kind == "kill":
                target.kill_replica(idx)
            elif kind == "kill_decode":
                target.kill_decode_worker(idx)
            elif kind == "kill_prefill":
                target.kill_prefill_worker(idx)
            else:
                return False
        except (AttributeError, IndexError, ValueError):
            return False
        return True

    def _report(self, records, makespan, steps, slo_ttft_ms, target,
                exceptions, include_trace, t0: float = 0.0,
                chaos_applied: int = 0) -> dict:
        shed: dict = {}
        canceled: dict = {}
        abandoned = 0
        decisions: List[List] = []
        ttfts, tpots = [], []
        completed = rehomed_done = slo_met = slo_known = 0
        per_tenant: dict = {}
        for rec in records:
            tstats = per_tenant.setdefault(
                rec["tenant"] or "base",
                {"offered": 0, "completed": 0, "sampled": 0,
                 "slo_met": 0, "_slo_known": 0})
            tstats["offered"] += 1
            tstats["sampled"] += int(rec["sampled"])
            req = rec.pop("req")
            if req is not None:
                rec["outcome"] = ("done" if req.state == "done"
                                  else req.state)
                rec["reason"] = req.shed_reason
                rec["ttft_ms"] = (None if req.ttft is None
                                  else round(req.ttft * 1e3, 3))
                rec["tpot_ms"] = (None if req.tpot is None
                                  else round(req.tpot * 1e3, 3))
                rec["rehomed"] = bool(getattr(req, "rehomed", False))
                rec["done_t"] = (
                    None if req.finished_at is None
                    else round(max(0.0, req.finished_at - t0), 6))
                met = req.deadline_met
                if met is None and slo_ttft_ms and req.ttft is not None:
                    met = req.ttft * 1e3 <= slo_ttft_ms
                rec["deadline_met"] = met
                if req.state == "done":
                    # a re-homed completion lands in its own bucket so
                    # completed + shed + rehomed == offered (modulo
                    # rejects/errors) survives a kill; its latency and
                    # SLO verdict still count below — recovered work
                    # is goodput
                    if rec["rehomed"]:
                        rehomed_done += 1
                    else:
                        completed += 1
                    tstats["completed"] += 1
                    if req.ttft is not None:
                        ttfts.append(req.ttft * 1e3)
                    if req.tpot is not None:
                        tpots.append(req.tpot * 1e3)
                    if met is not None:
                        slo_known += 1
                        slo_met += int(met)
                        tstats["_slo_known"] += 1
                        tstats["slo_met"] += int(met)
            if rec["outcome"] in ("shed", "rejected"):
                key = rec["reason"] or "unknown"
                shed[key] = shed.get(key, 0) + 1
            elif rec["outcome"] == "canceled":
                key = rec["reason"] or "unknown"
                canceled[key] = canceled.get(key, 0) + 1
            abandoned += int(rec["abandoned"])
            decisions.append([rec["outcome"], rec.get("reason")])

        leaked = 0
        seen_allocs = set()   # co-located disagg roles share one pool
        for eng in self._engines(target):
            if getattr(eng, "paged", False):
                alloc = eng.cache.allocator
                if id(alloc) in seen_allocs:
                    continue
                seen_allocs.add(id(alloc))
                eng.cache.flush_prefix_cache()
                leaked += max(0, alloc.leaked() - 1)

        def pct(vals, q):
            return (round(float(np.percentile(vals, q)), 3)
                    if vals else None)

        engine_slo = next((e.slo_ttft_ms
                           for e in self._engines(target)
                           if e.slo_ttft_ms), 0.0)
        report = {
            "mode": self.mode, "seed": self.seed, "rate": self.rate,
            "duration_s": self.duration,
            "offered": len(records),
            "offered_rate": round(len(records) / self.duration, 3),
            "makespan_s": round(makespan, 6),
            "steps": steps,
            "admitted": sum(1 for d in decisions
                            if d[0] in ("done", "shed", "canceled")),
            "completed": completed,
            "rehomed": rehomed_done,
            "canceled": canceled,
            "canceled_total": sum(canceled.values()),
            "abandoned": abandoned,
            "closed_loop": self.closed_loop,
            "chaos_applied": chaos_applied,
            "shed": shed,
            "shed_total": sum(shed.values()),
            "exceptions": exceptions,
            "slo_ttft_ms": engine_slo or slo_ttft_ms or None,
            "slo_met": slo_met if slo_known else None,
            "slo_attainment": (round(slo_met / slo_known, 4)
                               if slo_known else None),
            "goodput_per_s": (round(slo_met / makespan, 4)
                              if slo_known else None),
            "throughput_per_s": round(
                (completed + rehomed_done) / makespan, 4),
            "ttft_ms_p50": pct(ttfts, 50),
            "ttft_ms_p95": pct(ttfts, 95),
            "ttft_ms_p99": pct(ttfts, 99),
            "tpot_ms_p50": pct(tpots, 50),
            "tpot_ms_p95": pct(tpots, 95),
            "tpot_ms_p99": pct(tpots, 99),
            "leaked_kv_blocks": leaked,
            "decisions": decisions,
        }
        if self._decoded:
            # per-tenant goodput: who got served, who met the SLO,
            # straight from the loadgen's own records (the target's
            # stats()["tenants"] view must agree — CI cross-checks)
            for name, ts in per_tenant.items():
                known = ts.pop("_slo_known")
                ts["slo_attainment"] = (round(ts["slo_met"] / known, 4)
                                        if known else None)
                ts["goodput_per_s"] = (round(ts["slo_met"] / makespan, 4)
                                       if known else None)
            report["per_tenant"] = dict(sorted(per_tenant.items()))
            leaked_pages = 0
            seen_pools = set()
            for eng in self._engines(target):
                pool = getattr(eng, "lora_pool", None)
                if pool is not None and id(pool) not in seen_pools:
                    seen_pools.add(id(pool))
                    leaked_pages += pool.leaked()
            report["leaked_lora_pages"] = leaked_pages
        if self._returning:
            # returning-users section: session volume straight from
            # the records, residency/migration/resume accounting from
            # the fleet-shared tier, and the zero-leak identity for
            # the host half (flush first, like the device pools above)
            tier = next(
                (e.kv_tier for e in self._engines(target)
                 if getattr(e, "kv_tier", None) is not None), None)
            sess: dict = {
                "sessions_offered": len({r["session"] for r in records
                                         if r["session"]}),
                "session_turns": sum(1 for r in records
                                     if r["session"]),
            }
            dev_blocks = next(
                (e.cache.allocator.num_blocks
                 for e in self._engines(target)
                 if getattr(e, "paged", False)), 0)
            sess["device_blocks"] = dev_blocks
            if tier is not None:
                ts = tier.stats()
                sess.update(
                    sessions_resumed=ts["sessions_resumed"],
                    sessions_peak=ts["sessions_peak"],
                    host_blocks=ts["host_blocks"],
                    host_blocks_peak=ts["host_blocks_peak"],
                    host_evictions=ts["host_evictions"],
                    migrated_demote_blocks=ts["migrated_demote_blocks"],
                    migrated_promote_blocks=ts[
                        "migrated_promote_blocks"],
                    demote_dedup_entries=ts["demote_dedup_entries"])
                tier.flush()
                sess["leaked_host_blocks"] = tier.leaked()
            report["sessions"] = sess
        stats = getattr(target, "stats", None)
        st = stats() if callable(stats) else {}
        if "hedges" in st:
            # hedged-prefill section: volume (rate vs offered, budget
            # tokens left), outcome split, and the duplicated-token
            # cost of racing
            h = dict(st["hedges"])
            fired = int(h.get("fired", 0))
            h["hedge_rate"] = round(fired / max(1, len(records)), 4)
            h["win_rate"] = (round(int(h.get("wins", 0)) / fired, 4)
                             if fired else None)
            report["hedges"] = h
        if "devprof" in st:
            # the device-cost observatory's section: the sampled
            # device/host split and per-entry rooflines (zeros on a
            # VirtualClock run; the perf ledger stores it beside the
            # goodput numbers)
            report["devprof"] = st["devprof"]
        if "prefill_workers" in st:
            report["disagg"] = {k: st[k] for k in (
                "prefill_workers", "decode_workers", "colocated",
                "handoffs_adopted", "handoffs_copied", "prefix_affinity",
                "affinity_hits", "affinity_misses",
                "fleet_prefix_hit_rate")}
        if include_trace:
            report["trace"] = records
        return report


def warmup(target, max_new_tokens: int = 2, sampled: bool = False):
    """Pay the captures before any measured traffic, then drop each
    engine's learned cost EWMAs and flush its prefix cache, so
    predictions reflect steady-state dispatch costs.

    First the reference's warm-up: one request per prefill bucket
    through ``target``, run to idle. A graph holds its replica's pools
    by address, so a replica those requests left cold would capture
    inside the measured run: each engine then gets one request of every
    bucket it has not prefilled yet (a replica the router skipped, or a
    bucket a prefix-cache hit cut short), stepped on that engine alone
    from a flushed prefix cache. Those extra requests are taken out of
    the engine's books (completions, SLO and shed counts, its request
    list) and the trace store, and never pass through the router, so
    the measured run starts from the reference's state. Under an active
    fault spec they do draw from the injector's stream.

    A :class:`~paddle_tpu_torch.serving.DisaggRouter`'s workers are warmed
    by role instead (:func:`_warm_roles`): a decode worker takes no
    submission, and a prefill worker's request ends in the fleet's
    handoff queue.

    ``sampled`` also warms each engine's sampled graphs (the decode
    step's, or the megastep's or the verify's when configured) with one
    sampled request per engine taken out of the books the same way: the
    reference computes both branches in one compiled step, the port keeps
    a graph per branch. A fleet-shared host tier is flushed at the end,
    so measured traffic starts from an empty tier."""
    from ..serving import QueueFullError
    engines = LoadGen._engines(target)
    eng = engines[0]
    for b in eng.buckets:
        plen = _warm_len(eng, b, max_new_tokens)
        for _ in range(50):   # ride out injected submit faults
            try:
                target.submit([1] * plen, max_new_tokens=max_new_tokens,
                              _log_request=False)
                break
            except QueueFullError:
                target.run_until_idle()
    target.run_until_idle()
    if hasattr(target, "prefills"):
        _warm_roles(target, max_new_tokens, sampled)
    else:
        for e in engines:
            for b in e.buckets:
                plen = _warm_len(e, b, max_new_tokens)
                if e._bucket_for(plen) not in e._prefill_fns:
                    _warm_alone(e, plen, max_new_tokens)
            if sampled:
                _warm_alone(e, _warm_len(e, e.buckets[0], max_new_tokens),
                            max_new_tokens, _SAMPLED_WARM)
    tiers = set()
    for e in engines:
        e.reset_cost_estimates()
        if e.paged:
            e.cache.flush_prefix_cache()
        tier = getattr(e, "kv_tier", None)
        if tier is not None and id(tier) not in tiers:
            # warm-up chains the sweep demoted sit in the (shared) host
            # store: flush it once
            tiers.add(id(tier))
            tier.flush()


#: the sampled warm-up request's decoding fields (any sampled row takes
#: the sampled graphs)
_SAMPLED_WARM = {"temperature": 0.8, "top_k": 8, "top_p": 0.95, "seed": 1}


def _warm_len(eng, bucket: int, max_new_tokens: int) -> int:
    """The warm-up prompt length of ``bucket``: the bucket itself, cut
    to what the row holds beside the new tokens."""
    return max(1, min(bucket, eng.max_len - max_new_tokens -
                      eng.spec_tokens))


def _warm_alone(eng, plen: int, max_new_tokens: int,
                decode_kw: Optional[dict] = None):
    """One warm-up request on ``eng`` alone (with ``decode_kw``'s
    decoding fields), run to idle (resubmitted while an injected fault
    sheds it), then taken out of the engine's books and the trace
    store."""
    from ..serving import QueueFullError
    if eng.paged:
        eng.cache.flush_prefix_cache()
    if getattr(eng, "kv_tier", None) is not None:
        # a promoted chain would shorten the warm-up's prefill
        eng.kv_tier.flush()
    saved = _books(eng)
    eng._devprof = None
    for _ in range(50):
        # costs learned from the captures must not shed the warm-up at
        # the SLO gate (the warm-up resets them at its end anyway)
        eng.reset_cost_estimates()
        try:
            req = eng.submit([1] * plen, max_new_tokens=max_new_tokens,
                             _log_request=False, **(decode_kw or {}))
        except QueueFullError:
            eng.run_until_idle()
            continue
        eng.run_until_idle()
        if req.state == "done":
            break
    _restore_books(eng, saved)


def _warm_roles(rt, max_new_tokens: int, sampled: bool = False):
    """Warm a disaggregated fleet by role: every prefill worker at every
    bucket it has not prefilled, and every decode worker that has not
    decoded (its decode step, or its megastep or verify when configured),
    each through a handoff from a prefill worker to a decode worker, the
    two stepped alone. A decode worker prefers a prefill worker on its
    own pool and the reverse, so a co-located pair splices. The warm-up
    requests leave both workers' books, the decode worker's adoption
    counts and the trace store, and the handoff queue ends empty. With
    ``sampled`` every decode worker also decodes one sampled request."""
    def partner(eng, peers):
        return next((p for p in peers if p.cache.pool is eng.cache.pool),
                    peers[0])

    for pw in rt.prefills:
        for b in pw.buckets:
            plen = _warm_len(pw, b, max_new_tokens)
            if pw._bucket_for(plen) not in pw._prefill_fns:
                _warm_handoff(pw, partner(pw, rt.decodes), plen,
                              max_new_tokens)
    for dw in rt.decodes:
        pw = partner(dw, rt.prefills)
        plen = _warm_len(pw, pw.buckets[0], max_new_tokens)
        if not dw.decode_steps + dw.megastep_dispatches:
            _warm_handoff(pw, dw, plen, max_new_tokens)
        if sampled:
            _warm_handoff(pw, dw, plen, max_new_tokens,
                          decode_kw=_SAMPLED_WARM)


def _tier_books(tier):
    """A host tier's migration, session and store counters."""
    return (dict(tier._migrated), tier._dedup_blocks, tier._resumed,
            tier.sessions_peak, tier.store.peak_used, tier.store.evictions)


def _books(eng):
    """What a warm-up request changes in ``eng``'s books: its outcome
    counts, its request list, its adoption counts (a decode worker), its
    prefix-cache counters and those of its pool, and its host tier's
    counters; and its devprof profiler, which the warm-up detaches so
    that its dispatches tick no sample (the reference's warm-up makes no
    such extra dispatches)."""
    pool = eng.cache.pool if eng.paged else None
    tier = getattr(eng, "kv_tier", None)
    with eng._lock:
        return (None if tier is None else _tier_books(tier),
                eng._completed, eng._slo_met,
                {k: list(v) for k, v in eng._tenant_stats.items()},
                dict(eng._shed_by_reason), len(eng._all),
                getattr(eng, "adopted", 0),
                getattr(eng, "adopted_copies", 0),
                eng._prefix_hit_reqs, eng._prefix_miss_reqs,
                None if pool is None else (pool.prefix_hits,
                                           pool.prefix_misses,
                                           pool.blocks_allocated_total),
                eng._devprof)


def _restore_books(eng, saved):
    """Put back :func:`_books`' record, dropping the requests submitted
    since from ``eng``'s list and the trace store. Each attribute is
    written under the lock that guards it (the step lock, then the
    tier's and the engine's, the order a step takes them)."""
    from ..observability import tracing as _tracing
    tier, tb = getattr(eng, "kv_tier", None), saved[0]
    saved = saved[1:]
    with eng._step_lock:
        if tier is not None:
            with tier._lock:
                (tier._migrated, tier._dedup_blocks, tier._resumed,
                 tier.sessions_peak, tier.store.peak_used,
                 tier.store.evictions) = tb
                tier._migrated = dict(tier._migrated)
        with eng._lock:
            (eng._completed, eng._slo_met, eng._tenant_stats,
             eng._shed_by_reason, n, adopted, copies,
             eng._prefix_hit_reqs, eng._prefix_miss_reqs, pool,
             eng._devprof) = saved
            for r in eng._all[n:]:
                _tracing.store().discard(r.id)
            del eng._all[n:]
        if hasattr(eng, "adopted"):
            eng.adopted, eng.adopted_copies = adopted, copies
    if pool is not None:
        p = eng.cache.pool
        p.prefix_hits, p.prefix_misses, p.blocks_allocated_total = pool


def _warm_handoff(pw, dw, plen: int, max_new_tokens: int,
                  max_steps: int = 1000, decode_kw: Optional[dict] = None):
    """One warm-up request submitted to prefill worker ``pw`` alone,
    stepped there until exported, then on decode worker ``dw`` alone
    until it ends (resubmitted while an injected fault sheds it); then
    taken out of both workers' books and the trace store."""
    from ..serving import QueueFullError
    pw.cache.flush_prefix_cache()
    if pw.kv_tier is not None:
        pw.kv_tier.flush()
    saved = [(e, _books(e)) for e in (pw, dw)]
    pw._devprof = dw._devprof = None
    for _ in range(50):
        for e in (pw, dw):
            # costs learned from the captures must not shed the warm-up
            # at the SLO gate (the warm-up resets them at its end anyway)
            e.reset_cost_estimates()
        try:
            req = pw.submit([1] * plen, max_new_tokens=max_new_tokens,
                            _log_request=False, **(decode_kw or {}))
        except QueueFullError:
            continue
        for _ in range(max_steps):
            if pw.idle:
                break
            pw.step()
        for _ in range(max_steps):
            if req.done:
                break
            dw.step()
        if not req.done or not pw.idle or len(pw._handoff):
            raise RuntimeError(f"warm-up handoff of {plen} tokens did "
                               f"not finish: {req}")
        if req.state == "done":
            break
    for eng, books in saved:
        _restore_books(eng, books)


# ------------------------------------------------------------------ CLI
def _parse_range(text: str) -> Tuple[int, int]:
    lo, hi = (int(p) for p in str(text).split(":"))
    return lo, hi


def _parse_frange(text: str) -> Tuple[float, float]:
    lo, hi = (float(p) for p in str(text).split(":"))
    return lo, hi


def _parse_mix(text: str) -> Optional[dict]:
    if not text:
        return None
    out = {}
    for part in text.split(","):
        k, v = part.split(":")
        out[int(k)] = float(v)
    return out


def _parse_tenant_mix(text: str) -> Optional[dict]:
    if not text:
        return None
    out = {}
    for part in text.split(","):
        k, v = part.split(":")
        out[str(k)] = float(v)
    return out


def _captures(model) -> int:
    """Every step-cache entry's specialisations: the graphs captured on
    the card (the port's compiles), the input signatures on the CPU."""
    return sum(e["traces"]["count"]
               for e in getattr(model, "_step_compile_cache", {}).values())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="open-loop load generator for the port's serving plane")
    ap.add_argument("--mode", default="poisson",
                    choices=list(LoadGen.MODES))
    ap.add_argument("--rate", type=float, default=8.0,
                    help="calm/mean arrival rate, requests/s")
    ap.add_argument("--duration", type=float, default=4.0,
                    help="arrival window, seconds")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--model", default="gpt2-tiny",
                    help="GPT_CONFIGS name (random weights from a seed)")
    ap.add_argument("--device", default=None,
                    help="torch device; default CUDA (raises without one)")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--max-queue", type=int, default=32)
    ap.add_argument("--buckets", default="16,32,64",
                    help="comma-separated prefill buckets")
    ap.add_argument("--prompt-tokens", type=_parse_range, default=(4, 24),
                    metavar="LO:HI")
    ap.add_argument("--new-tokens", type=_parse_range, default=(2, 16),
                    metavar="LO:HI")
    ap.add_argument("--closed-loop", type=int, default=0, metavar="N",
                    help="> 0 runs N closed-loop clients instead of "
                    "open-loop release")
    ap.add_argument("--think-time-ms", type=_parse_frange,
                    default=(0.0, 0.0), metavar="A:B",
                    help="closed-loop per-client think time, uniform on "
                    "[A, B] ms")
    ap.add_argument("--abandon-frac", type=float, default=0.0,
                    metavar="F", help="fraction of closed-loop clients "
                    "that hang up mid-decode; requires --closed-loop")
    ap.add_argument("--returning-frac", type=float, default=0.0,
                    metavar="F", help="fraction of arrivals that open "
                    "a multi-turn session (seeded draws from a "
                    "dedicated stream): follow-up turns arrive after "
                    "idle gaps and submit with session=<id> so the "
                    "host KV tier resumes the stored context; "
                    "requires --host-blocks")
    ap.add_argument("--turns-per-session", type=_parse_range,
                    default=(2, 4), metavar="A:B",
                    help="returning-users turns per session, uniform "
                    "on [A, B] from the session stream")
    ap.add_argument("--host-blocks", type=int, default=0,
                    metavar="N", help="> 0 turns on the host-RAM KV "
                    "tier (FLAGS_serving_host_tier) with N host "
                    "blocks — cold chains demote int8-at-rest and "
                    "sessions park/resume through the fleet-shared "
                    "store")
    ap.add_argument("--demote-idle-ms", type=float, default=None,
                    metavar="MS", help="FLAGS_serving_demote_idle_ms "
                    "for the run: how long (engine clock) a prefix "
                    "entry must sit cold before the sweep demotes it "
                    "(0 = every step; default: the flag)")
    ap.add_argument("--priority-mix", type=_parse_mix, default=None,
                    metavar="P:W,P:W", help="priority class weights, "
                    "e.g. '0:0.1,1:0.8,2:0.1' (lower = more urgent)")
    ap.add_argument("--sample-frac", type=float, default=0.0,
                    help="fraction of arrivals carrying sampled decode "
                    "params")
    ap.add_argument("--tenant-mix", type=_parse_tenant_mix,
                    default=None, metavar="NAME:W,NAME:W",
                    help="multi-tenant LoRA mix, e.g. "
                    "'base:0.5,acme:0.3,zeta:0.2' ('base' = no "
                    "adapter); non-base tenants need --lora-rank")
    ap.add_argument("--lora-rank", type=int, default=0,
                    help="> 0 builds the paged LoRA adapter pool "
                    "(FLAGS_serving_lora_rank) and loads one seeded "
                    "adapter per non-base tenant in --tenant-mix")
    ap.add_argument("--slo-ttft-ms", type=float, default=0.0,
                    help="> 0 turns on SLO-aware admission; also the "
                    "goodput SLO for reporting")
    ap.add_argument("--slo-prefill-ms", type=float, default=0.0,
                    help="pin the predictor's prefill cost (0 = EWMA)")
    ap.add_argument("--slo-tpot-ms", type=float, default=0.0,
                    help="pin the predictor's per-token cost (0 = EWMA)")
    ap.add_argument("--depth-only", action="store_true",
                    help="run the engine WITHOUT SLO admission but score "
                    "goodput against --slo-ttft-ms")
    ap.add_argument("--replicas", type=int, default=1)
    ap.add_argument("--autoscale", default="", metavar="MIN:MAX",
                    help="enable router autoscaling inside the bounds")
    ap.add_argument("--hedge-ms", type=float, default=0.0, metavar="MS",
                    help="router hedged prefill (> 0 fixed threshold, -1 "
                    "auto from the traced TTFT p95, 0 off)")
    ap.add_argument("--hedge-budget", type=float, default=None,
                    metavar="FRAC", help="hedge token bucket refill per "
                    "offered request")
    ap.add_argument("--straggler", default="", metavar="I:MS",
                    help="after warmup, pin replica I's predicted prefill "
                    "cost to MS ms and slow its steps to match")
    ap.add_argument("--disagg", default="", metavar="PxD",
                    help="run a disaggregated fleet of P prefill-only "
                    "+ D decode-only workers behind a DisaggRouter "
                    "instead of symmetric replicas (e.g. '1x2')")
    ap.add_argument("--no-prefix-affinity", action="store_true",
                    help="with --disagg: route least-loaded instead of "
                    "to the worker holding the longest cached prefix")
    ap.add_argument("--chaos", default="", metavar="T:KIND:I,...",
                    help="inline chaos schedule, KIND in kill|restart|"
                    "kill_decode|kill_prefill")
    ap.add_argument("--replay", default="", metavar="TRACE.json",
                    help="replay a recorded arrival trace")
    ap.add_argument("--megastep", type=int, default=1, metavar="N",
                    help="> 1 runs decode megasteps of N iterations")
    ap.add_argument("--dispatch-ahead", action="store_true",
                    help="with --megastep > 1: enqueue megastep k+1 "
                    "while k executes (FLAGS_serving_dispatch_ahead); "
                    "the host commit validates the speculation and "
                    "discards it on any roster/sampling change")
    ap.add_argument("--dispatch-threads", type=int, default=0,
                    metavar="T", help="> 0 steps router replicas from T "
                    "threads")
    ap.add_argument("--virtual-step-ms", type=float, default=0.0,
                    help="> 0 runs on a virtual clock advancing this much "
                    "per step")
    ap.add_argument("--fault-spec", default="",
                    help="FLAGS_fault_spec for the run")
    ap.add_argument("--fault-seed", type=int, default=0)
    ap.add_argument("--no-warmup", action="store_true")
    ap.add_argument("--json", action="store_true",
                    help="print the report as one JSON line")
    ap.add_argument("--trace", default="",
                    help="write the per-request trace JSON here")
    ap.add_argument("--trace-sample", type=float, default=None,
                    metavar="FRAC", help="FLAGS_serving_trace for this run")
    ap.add_argument("--span-trace-out", default="", metavar="PATH",
                    help="export the span traces as chrome-trace JSON")
    ap.add_argument("--expect-goodput-min", type=float, default=None)
    ap.add_argument("--expect-zero-leaks", action="store_true")
    ap.add_argument("--expect-zero-new-compiles", action="store_true",
                    help="exit 1 if any step graph was captured after "
                    "warmup (on the CPU: any new input signature)")
    ap.add_argument("--expect-sheds-min", type=int, default=None)
    ap.add_argument("--expect-resumed-min", type=int, default=None,
                    help="exit 1 unless sessions_resumed >= this "
                    "(returning-users runs must actually resume)")
    ap.add_argument("--expect-capacity-gt-device",
                    action="store_true",
                    help="exit 1 unless the peak concurrent-session "
                    "count exceeds the device pool's block count — "
                    "the sessions-beyond-HBM capacity gate (host "
                    "tier on)")
    ap.add_argument("--devprof", action="store_true",
                    help="turn on the device-cost observatory "
                         "(FLAGS_serving_devprof) for every engine "
                         "this run constructs: counted step costs, "
                         "sampled device timing, roofline gauges, "
                         "decode blame split")
    ap.add_argument("--devprof-sample", type=float, default=None,
                    metavar="FRAC",
                    help="override FLAGS_serving_devprof_sample "
                         "(fraction of step dispatches timed; default "
                         "keeps the flag's 0.1)")
    ap.add_argument("--ledger", default="", metavar="PATH",
                    help="append this run's headline metrics (+ "
                         "devprof roofline summary and cost digest) "
                         "as one perf-ledger JSONL row")
    args = ap.parse_args(argv)

    import torch

    from .. import flags as _fl
    from ..device import resolve_device
    from ..models.gpt import GPT_CONFIGS, GPTForCausalLM
    from ..observability import tracing as _tracing
    from ..resilience import fault_scope
    from ..serving import (AutoscalePolicy, DisaggRouter, ReplicaRouter,
                           ServingEngine)
    from ..serving.router import _parse_autoscale

    from contextlib import nullcontext
    device = resolve_device(args.device)
    ctx = (fault_scope(args.fault_spec, seed=args.fault_seed)
           if args.fault_spec else nullcontext())
    cfg = GPT_CONFIGS[args.model]
    gen = torch.Generator(device=device).manual_seed(0)
    model = GPTForCausalLM(cfg, device=device, generator=gen).eval()
    if args.returning_frac and args.host_blocks <= 0:
        print("FAIL: --returning-frac needs --host-blocks > 0 "
              "(session resume parks context in the host KV tier)",
              file=sys.stderr)
        return 1
    if args.host_blocks > 0:
        tier_flags = {"serving_host_tier": True,
                      "serving_host_blocks": args.host_blocks}
        if args.demote_idle_ms is not None:
            tier_flags["serving_demote_idle_ms"] = args.demote_idle_ms
        _fl.set_flags(tier_flags)
    if args.abandon_frac and not args.closed_loop:
        print("FAIL: --abandon-frac needs --closed-loop clients "
              "(abandonment is a client hang-up mid-decode)",
              file=sys.stderr)
        return 1
    if args.replay:
        lg = LoadGen.from_trace(args.replay)
        if args.closed_loop:
            lg.closed_loop = int(args.closed_loop)
            lg.think_time_ms = args.think_time_ms
    else:
        lg = LoadGen(mode=args.mode, rate=args.rate,
                     duration=args.duration, seed=args.seed,
                     vocab_size=cfg.vocab_size,
                     prompt_tokens=args.prompt_tokens,
                     new_tokens=args.new_tokens,
                     priority_mix=args.priority_mix,
                     sample_frac=args.sample_frac,
                     tenant_mix=args.tenant_mix,
                     closed_loop=args.closed_loop,
                     think_time_ms=args.think_time_ms,
                     abandon_frac=args.abandon_frac,
                     returning_frac=args.returning_frac,
                     turns_per_session=args.turns_per_session)
    if args.chaos:
        for part in args.chaos.split(","):
            t_s, kind, idx = part.split(":")
            lg.chaos.append({"t": float(t_s), "kind": str(kind),
                             "index": int(idx)})
        lg.chaos.sort(key=lambda e: e["t"])
    lora_tenants = sorted(t for t in (args.tenant_mix or {})
                          if t not in ("", "base"))
    if lora_tenants and args.lora_rank <= 0:
        print("FAIL: --tenant-mix names non-base tenants; they need "
              "--lora-rank > 0", file=sys.stderr)
        return 1
    if args.lora_rank > 0:
        _fl.set_flags({"serving_lora_rank": args.lora_rank,
                       "serving_lora_max_adapters":
                           max(len(lora_tenants), 1)})
    if args.megastep < 1:
        print("FAIL: --megastep must be >= 1", file=sys.stderr)
        return 1
    if args.dispatch_ahead and args.megastep <= 1:
        print("FAIL: --dispatch-ahead needs --megastep > 1",
              file=sys.stderr)
        return 1
    if args.dispatch_threads < 0:
        print("FAIL: --dispatch-threads must be >= 0", file=sys.stderr)
        return 1
    if args.megastep > 1 or args.dispatch_threads > 0:
        _fl.set_flags({"serving_megastep": args.megastep,
                       "serving_dispatch_ahead": bool(args.dispatch_ahead),
                       "serving_dispatch_threads": args.dispatch_threads})
    if args.trace_sample is not None:
        _fl.set_flags({"serving_trace": args.trace_sample})
    if args.devprof_sample is not None and not args.devprof:
        print("FAIL: --devprof-sample needs --devprof",
              file=sys.stderr)
        return 1
    if args.devprof:
        # a flag write (not an engine kwarg), so router- and
        # disagg-constructed engines profile too
        dp_flags = {"serving_devprof": True}
        if args.devprof_sample is not None:
            dp_flags["serving_devprof_sample"] = args.devprof_sample
        _fl.set_flags(dp_flags)
    _tracing.reset()
    vc = (VirtualClock() if args.virtual_step_ms > 0 else None)
    eng_kwargs = dict(
        max_slots=args.slots, max_len=args.max_len,
        max_queue=args.max_queue,
        buckets=[int(b) for b in args.buckets.split(",")],
        slo_ttft_ms=0.0 if args.depth_only else args.slo_ttft_ms,
        slo_prefill_ms=args.slo_prefill_ms,
        slo_tpot_ms=args.slo_tpot_ms, device=device)
    if vc is not None:
        eng_kwargs["clock"] = vc.now
    with ctx:
        bounds = _parse_autoscale(args.autoscale)
        if args.disagg:
            _fl.set_flags({
                "serving_disagg": args.disagg,
                "serving_prefix_affinity":
                    not args.no_prefix_affinity})
            target = DisaggRouter(model=model, **eng_kwargs)
        elif args.replicas > 1 or bounds is not None or \
                args.hedge_ms != 0.0:
            target = ReplicaRouter(
                model=model, n_replicas=args.replicas,
                autoscale=(None if bounds is None else AutoscalePolicy(
                    min_replicas=bounds[0], max_replicas=bounds[1])),
                hedge_ms=args.hedge_ms,
                hedge_budget=args.hedge_budget,
                **eng_kwargs)
        else:
            target = ServingEngine(model, **eng_kwargs)
        if lora_tenants:
            # one seeded adapter per named tenant, loaded before any
            # traffic: a write into the pool, no capture
            from ..serving import make_adapter
            for i, name in enumerate(lora_tenants):
                target.load_adapter(
                    name, make_adapter(cfg, args.lora_rank, seed=i + 1))
        if not args.no_warmup:
            warmup(target, sampled=any(a.temperature > 0
                                       for a in lg.schedule()))
        if args.straggler:
            # a deterministic straggler: its predicted prefill cost
            # pinned high, so the hedge gate sees it coming, and each
            # real step stretched to MS of wall time over three router
            # passes (two idle passes of MS/3, then the step), so hedge
            # checks run between them and the strike watchdog, which
            # kills a replica after three unproductive passes with work,
            # sees it produce every third call
            si_s, sms_s = args.straggler.split(":")
            si, sms = int(si_s), float(sms_s)
            slow_eng = target.engines[si]
            slow_eng._prefill_ms_pin = sms
            _orig_step = slow_eng.step
            _stall = {"n": 0}

            def _slow_step(_o=_orig_step, _ms=sms):
                time.sleep(_ms / 3e3)
                _stall["n"] += 1
                if _stall["n"] % 3:
                    return False
                return _o()
            slow_eng.step = _slow_step
        base = _captures(model)
        report = lg.run(target, clock=vc,
                        step_cost_ms=args.virtual_step_ms,
                        slo_ttft_ms=args.slo_ttft_ms or None,
                        include_trace=bool(args.trace))
        report["new_compiles_after_warmup"] = _captures(model) - base
    trace = report.pop("trace", None)
    if args.trace:
        with open(args.trace, "w") as f:
            json.dump({"schedule": json.loads(lg.trace_bytes()),
                       "requests": trace}, f)
    if args.span_trace_out:
        _tracing.export_chrome_trace(args.span_trace_out)
        report["span_trace"] = args.span_trace_out
    blame = _tracing.blame_summary()
    if blame["requests"]:
        report["blame"] = blame
    if args.ledger:
        from . import perf_ledger
        report["ledger_row"] = perf_ledger.append_report(
            args.ledger, report, run="loadgen")
    if args.json:
        print(json.dumps(report))
    else:
        for k, v in report.items():
            if k != "decisions":
                print(f"{k}: {v}")
    ok = True
    if args.expect_goodput_min is not None:
        g = report["goodput_per_s"]
        if g is None or g < args.expect_goodput_min:
            print(f"FAIL: goodput_per_s {g} < "
                  f"{args.expect_goodput_min}", file=sys.stderr)
            ok = False
    if args.expect_zero_leaks and report["leaked_kv_blocks"] != 0:
        print(f"FAIL: leaked_kv_blocks = "
              f"{report['leaked_kv_blocks']}", file=sys.stderr)
        ok = False
    if args.expect_zero_leaks and report.get("leaked_lora_pages"):
        print(f"FAIL: leaked_lora_pages = "
              f"{report['leaked_lora_pages']}", file=sys.stderr)
        ok = False
    if args.expect_zero_new_compiles and \
            report["new_compiles_after_warmup"] != 0:
        print(f"FAIL: new_compiles_after_warmup = "
              f"{report['new_compiles_after_warmup']}", file=sys.stderr)
        ok = False
    if args.expect_sheds_min is not None and \
            report["shed_total"] < args.expect_sheds_min:
        print(f"FAIL: shed_total {report['shed_total']} < "
              f"{args.expect_sheds_min}", file=sys.stderr)
        ok = False
    sess = report.get("sessions", {})
    if args.expect_resumed_min is not None:
        r = sess.get("sessions_resumed")
        if r is None or r < args.expect_resumed_min:
            print(f"FAIL: sessions_resumed {r} < "
                  f"{args.expect_resumed_min}", file=sys.stderr)
            ok = False
    if args.expect_capacity_gt_device:
        peak, dev = sess.get("sessions_peak"), sess.get(
            "device_blocks", 0)
        if peak is None or peak <= dev:
            print(f"FAIL: sessions_peak {peak} <= device_blocks "
                  f"{dev} (no capacity win over HBM)", file=sys.stderr)
            ok = False
    if args.expect_zero_leaks and sess.get("leaked_host_blocks"):
        print(f"FAIL: leaked_host_blocks = "
              f"{sess['leaked_host_blocks']}", file=sys.stderr)
        ok = False
    if report["exceptions"]:
        print(f"FAIL: {report['exceptions']} unhandled exceptions",
              file=sys.stderr)
        ok = False
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
