"""Pipeline parallelism: device_guard-annotated program split + GPipe /
1F1B microbatch schedules — the counterpart of
``paddle_tpu/distributed/fleet/pipeline.py``.

Capability analog of the reference's pipeline stack: fluid
PipelineOptimizer (optimizer.py:3666, `_split_program`:3790, enqueue/
dequeue insertion :4135) executed by PipelineTrainer/SectionWorker
(pipeline_trainer.cc:24, section_worker.cc:82 — "forward over N
microbatch scopes -> backward over N -> optimize").

Each stage becomes THREE phase programs (forward / backward / optimize)
holding that stage's ops; cross-stage boundary values hand off through
the Scope as persistable variables. Schedules: GPipe (all forwards, all
backwards with gradient accumulation into persistable buffers, one
optimize apply) or 1F1B (warmup forwards then one-forward-one-backward
steady state — lower activation memory, identical numerics).

Gradient accumulation is inserted at split time: each backward phase sums
its parameter grads into ``<p>@GRAD@PACC``; the optimize phase reads the
accumulator (scaled by 1/num_microbatches) and zeroes it.

On one card every stage runs on that card, through the executor it is
handed: ``device_guard`` labels (``"gpu:N"``, ``"tpu:N"``) name stages,
not devices. ``devices=`` gives each stage an executor of its own on a
device of its own; a list naming more CUDA cards than the machine has
raises. The runner's per-microbatch stash copies each boundary value
into tensors of its own, made at the first step (the reference binds the
same immutable array under a second name; the port's executor writes
persistable outputs in place, so a shared tensor would be overwritten by
the next microbatch), and keeps the stash beside the scope rather than
among its names: a new name in the scope keys every program anew in the
executor. With the scope's names complete after the first step, which
runs eagerly (``jit.no_capture``: it makes the boundary values and the
stash), each phase program is captured once, in the second step, and
replayed for every microbatch after that.
"""

from __future__ import annotations

import contextlib
import time
import weakref
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ... import jit as _jit
from ...framework.program import (GRAD_SUFFIX, Operator, Program,
                                 default_startup_program)

GRAD_ACC_SUFFIX = "@GRAD@PACC"


class PipelineStage:
    def __init__(self, device: str):
        self.device = device
        self.forward = Program()
        self.backward = Program()
        self.optimize = Program()

    def phases(self):
        return (("forward", self.forward), ("backward", self.backward),
                ("optimize", self.optimize))


def _op_phase(op: Operator) -> str:
    role = op.attrs.get("op_role", "forward")
    if role == "optimize":
        return "optimize"
    if role == "backward":
        return "backward"
    return "forward"


def split_pipeline_program(program: Program,
                           num_microbatches: int) -> List[PipelineStage]:
    """Partition the global block by (op_device, phase); insert gradient
    accumulation; mark cross-program boundary vars persistable so they
    hand off through the Scope. Ops with no device annotation inherit
    the previous op's stage (the reference's implicit-device rule)."""
    block = program.global_block()
    devices: List[str] = []
    for op in block.ops:
        d = op.attrs.get("op_device")
        if d and d not in devices:
            devices.append(d)
    if not devices:
        raise ValueError(
            "pipeline requires device_guard annotations (no op_device "
            "attrs found)")
    stages = {d: PipelineStage(d) for d in devices}

    # ---- partition ops -----------------------------------------------------
    param_names = {p.name for p in block.all_parameters()}
    # params belong to the stage of the first forward op reading them, so
    # their optimizer-update ops co-locate with the forward/backward use
    # (the reference's per-section optimize blocks, optimizer.py:4272)
    param_stage: Dict[str, str] = {}
    cur_dev = devices[0]
    for op in block.ops:
        cur_dev = op.attrs.get("op_device") or cur_dev
        if op.attrs.get("op_role") not in ("backward", "optimize"):
            for n in op.input_names():
                if n in param_names and n not in param_stage:
                    param_stage[n] = cur_dev
    cur_dev = devices[0]
    for op in block.ops:
        cur_dev = op.attrs.get("op_device") or cur_dev
        dev = cur_dev
        if _op_phase(op) == "optimize":
            p_in = op.inputs.get("Param", [])
            if p_in and p_in[0] in param_stage:
                dev = param_stage[p_in[0]]
        stage = stages[dev]
        phase = _op_phase(op)
        target = dict(stage.phases())[phase]
        tb = target.global_block()
        new_op = Operator(tb, op.type, {k: list(v) for k, v in
                                        op.inputs.items()},
                          {k: list(v) for k, v in op.outputs.items()},
                          dict(op.attrs))
        tb.ops.append(new_op)

    # ---- copy var metadata into every phase program ------------------------
    for stage in stages.values():
        for _, prog in stage.phases():
            tb = prog.global_block()
            for op in tb.ops:
                for n in op.input_names() + op.output_names():
                    if n in block.vars and n not in tb.vars:
                        src = block.vars[n]
                        tb.vars[n] = type(src)(
                            tb, n, shape=src.shape, dtype=src.dtype,
                            persistable=src.persistable,
                            stop_gradient=src.stop_gradient,
                            is_data=src.is_data, trainable=src.trainable,
                            is_parameter=src.is_parameter)

    # ---- gradient accumulation over microbatches ---------------------------
    startup = getattr(program, "_startup_ref", None) or \
        default_startup_program()
    for stage in stages.values():
        bb = stage.backward.global_block()
        ob = stage.optimize.global_block()
        # param grads produced by this stage's backward
        stage_pgrads = []
        for op in bb.ops:
            for n in op.output_names():
                if n.endswith("@GRAD") and n[:-5] in param_names:
                    if n not in stage_pgrads:
                        stage_pgrads.append(n)
        for g in stage_pgrads:
            acc = f"{g}@PACC"
            # declare accumulator persistable in backward+optimize+startup
            for blk in (bb, ob):
                blk.create_var(acc, persistable=True, stop_gradient=True)
            sb = startup.global_block()
            sb.create_var(acc, persistable=True, stop_gradient=True)
            # shape comes from the parameter at run time
            sb.append_op("fill_constant_like", {"X": g[:-5]}, {"Out": acc},
                         {"value": 0.0})
            bb.append_op("sum", {"X": [acc, g]}, {"Out": acc},
                         {"op_role": "backward"})
            # optimize phase: read averaged accumulator under the grad's
            # name, then reset the accumulator
            ob.prepend_op("scale", {"X": acc}, {"Out": g},
                          {"scale": 1.0 / num_microbatches,
                           "op_role": "optimize"})
            ob.append_op("scale", {"X": acc}, {"Out": acc},
                         {"scale": 0.0, "op_role": "optimize"})

    # ---- mark cross-program values persistable -----------------------------
    produced_by: Dict[str, Tuple] = {}
    order = []
    for d in devices:
        for phase, prog in stages[d].phases():
            order.append((d, phase, prog))
    for d, phase, prog in order:
        for op in prog.global_block().ops:
            for n in op.output_names():
                produced_by.setdefault(n, (d, phase))
    for d, phase, prog in order:
        tb = prog.global_block()
        for op in tb.ops:
            for n in op.input_names():
                src = produced_by.get(n)
                if src is not None and src != (d, phase):
                    # crosses a program boundary -> persist through scope
                    if n in tb.vars:
                        tb.vars[n].persistable = True
                    sd, sp = src
                    sblk = dict(stages[sd].phases())[sp].global_block()
                    if n in sblk.vars:
                        sblk.vars[n].persistable = True
                    else:
                        sblk.create_var(n, persistable=True,
                                        stop_gradient=True)
    # ---- declare each grad var's forward var -------------------------------
    # the verifier's grad pairing looks a grad's forward var up; the
    # reference leaves it out of a stage's backward program where no op
    # there reads it and the scope does not carry it (a value inside the
    # stage), and its own verifier then rejects that program (ROADMAP C).
    # Declared last, so a program that names every such var already is
    # the reference's, var for var
    def carried(n):
        src = produced_by.get(n)
        if src is None:
            return False
        sblk = dict(stages[src[0]].phases())[src[1]].global_block()
        return n in sblk.vars and sblk.vars[n].persistable

    for d, phase, prog in order:
        tb = prog.global_block()
        for op in tb.ops:
            for n in op.input_names() + op.output_names():
                base = n.split(GRAD_SUFFIX, 1)[0]
                if GRAD_SUFFIX in n and base in block.vars \
                        and base not in tb.vars and not carried(base):
                    src = block.vars[base]
                    tb.vars[base] = type(src)(
                        tb, base, shape=src.shape, dtype=src.dtype,
                        persistable=False, stop_gradient=src.stop_gradient,
                        is_data=src.is_data, trainable=src.trainable,
                        is_parameter=src.is_parameter)
    result = [stages[d] for d in devices]
    for st in result:
        for _, prog in st.phases():
            prog.bump_version()
    return result


class PipelineRunner:
    """Microbatch scheduler over the split stages (PipelineTrainer /
    SectionWorker analog, pipeline_trainer.cc:24, section_worker.cc:82).

    Schedules:
      - ``"gpipe"``: all forwards, then all backwards, then optimize.
      - ``"1f1b"``: each stage does ``min(M, S-1-s)`` warmup forwards,
        then alternates one-forward-one-backward, then drains backwards
        (lower peak activation memory, same numerics).
    Both are linearized into one dependency-respecting dispatch order;
    ``self.dispatch_log`` records it for inspection.

    Per-microbatch state: every phase dispatch first restores that
    microbatch's stashed boundary values (``(<name>, i)`` entries of the
    runner's stash for the scope — the per-microbatch scope analog),
    runs, then stashes its own persistable outputs under the microbatch
    tag. Both directions copy (``copy_``) between tensors that stay in
    place from the first step on. Gradient accumulators (``@PACC``) are
    deliberately never stashed — they are shared across microbatches by
    design. A scope's first step runs under ``jit.no_capture()``.

    ``fetch_list`` is honored on EVERY microbatch; the returned value
    for each fetch target is the mean across microbatches (equal to the
    full-batch value for mean-reduced losses with equal microbatches).
    """

    def __init__(self, stages: Sequence[PipelineStage],
                 num_microbatches: int,
                 devices: Optional[Sequence] = None,
                 schedule: str = "gpipe"):
        self.stages = list(stages)
        self.num_microbatches = num_microbatches
        if schedule not in ("gpipe", "1f1b"):
            raise ValueError(f"unknown pipeline schedule {schedule!r}")
        self.schedule = schedule
        self.devices = list(devices) if devices is not None else None
        self._stage_execs = None
        if self.devices is not None:
            if len(self.devices) < len(self.stages):
                raise ValueError(
                    f"pipeline has {len(self.stages)} stages but only "
                    f"{len(self.devices)} devices were given")
            from ...framework.executor import Executor
            use = [torch.device(d) for d in self.devices[:len(self.stages)]]
            have = torch.cuda.device_count()
            over = [str(d) for d in use
                    if d.type == "cuda" and (d.index or 0) >= have]
            if over:
                raise ValueError(
                    f"pipeline devices {over} name cards this machine "
                    f"lacks ({have} CUDA device(s))")
            self._stage_execs = [Executor(place=d) for d in use]
        self.dispatch_log: List[Tuple[str, int, int]] = []
        self.dispatch_times: List[Tuple[str, int, int, float]] = []
        self.last_enqueue_wall = 0.0
        self.last_total_wall = 0.0
        # scope -> {(name, microbatch): tensor}
        self._stashes = weakref.WeakKeyDictionary()

    # -- schedule construction ----------------------------------------------
    def _stage_orders(self) -> List[List[Tuple[str, int]]]:
        """Per-stage local item order: list of (phase, microbatch)."""
        S, M = len(self.stages), self.num_microbatches
        orders = []
        for s in range(S):
            items: List[Tuple[str, int]] = []
            if self.schedule == "gpipe":
                items += [("F", mb) for mb in range(M)]
                items += [("B", mb) for mb in range(M - 1, -1, -1)]
            else:  # 1f1b
                warmup = min(M, S - 1 - s)
                items += [("F", mb) for mb in range(warmup)]
                for i in range(M - warmup):
                    items.append(("F", warmup + i))
                    items.append(("B", i))
                # drain the warmup microbatches' backwards. NOTE: emitted
                # in ASCENDING mb order (GPipe drains descending); only
                # correct because _linearize re-sorts by dependency —
                # consumers of _stage_orders must not assume issue order
                # equals execution order
                items += [("B", mb) for mb in range(M - warmup, M)]
            items.append(("OPT", -1))
            orders.append(items)
        return orders

    def _linearize(self) -> List[Tuple[str, int, int]]:
        """Round-robin merge of the per-stage orders into one dispatch
        sequence in which every item's cross-stage dependencies are
        dispatched earlier (per-device queues keep same-stage order)."""
        S = len(self.stages)
        orders = self._stage_orders()
        heads = [0] * S
        done = set()
        out: List[Tuple[str, int, int]] = []

        def deps_met(phase, s, mb):
            if phase == "F":
                return s == 0 or ("F", s - 1, mb) in done
            if phase == "B":
                if ("F", s, mb) not in done:
                    return False
                return s == S - 1 or ("B", s + 1, mb) in done
            # OPT is last in each stage's local order, after all its B's
            return True

        remaining = sum(len(o) for o in orders)
        while remaining:
            progressed = False
            for s in range(S):
                if heads[s] >= len(orders[s]):
                    continue
                phase, mb = orders[s][heads[s]]
                if deps_met(phase, s, mb):
                    out.append((phase, s, mb))
                    done.add((phase, s, mb))
                    heads[s] += 1
                    remaining -= 1
                    progressed = True
            if not progressed:
                raise RuntimeError(
                    "pipeline schedule deadlock (a bug in _stage_orders)")
        return out

    # -- execution -----------------------------------------------------------
    @staticmethod
    def _mb_vars(prog):
        """Persistable, non-parameter vars of a phase program that carry
        per-microbatch values (excludes shared grad accumulators)."""
        for v in prog.global_block().vars.values():
            if (v.persistable and not v.is_parameter
                    and not v.name.endswith("@PACC")
                    and "@MB" not in v.name):
                yield v.name

    def schedule_concurrency(self) -> float:
        """Ideal parallel speedup of the dispatched schedule: simulate
        the linearized plan with unit-cost F/B items on one device per
        stage (an item starts when its deps are done AND its device is
        free) and compare the makespan to serial execution. This is the
        deterministic upper bound the schedule exposes — on one card,
        where every stage runs on the same device, wall-clock cannot
        show it, which is why the proxy exists."""
        plan = [it for it in (self.dispatch_log or self._linearize())
                if it[0] in ("F", "B")]
        finish: Dict[Tuple[str, int, int], int] = {}
        device_free = [0] * len(self.stages)
        S = len(self.stages)
        for phase, s, mb in plan:
            deps = []
            if phase == "F" and s > 0:
                deps.append(("F", s - 1, mb))
            if phase == "B":
                deps.append(("F", s, mb))
                if s < S - 1:
                    deps.append(("B", s + 1, mb))
            start = max([device_free[s]] +
                        [finish[d] for d in deps if d in finish])
            finish[(phase, s, mb)] = start + 1
            device_free[s] = start + 1
        makespan = max(finish.values()) if finish else 1
        return len(plan) / makespan

    def overlap_report(self) -> dict:
        """Evidence for the overlap claim after a run():
        - ``schedule_speedup``: simulated ideal speedup of the dispatch
          schedule over serial (needs len(stages) real devices);
        - ``host_enqueue_fraction``: host time spent ENQUEUEING work /
          total wall including the sync — small means the host races
          ahead of the device's queue."""
        enq = sum(t for *_, t in self.dispatch_times)
        total = self.last_total_wall or 1e-9
        return {
            "schedule_speedup": round(self.schedule_concurrency(), 3),
            "host_enqueue_fraction": round(enq / total, 4),
            "enqueue_wall_s": round(self.last_enqueue_wall, 4),
            "total_wall_s": round(self.last_total_wall, 4),
            "n_dispatches": len(self.dispatch_times),
        }

    @staticmethod
    def _fits(dst, src) -> bool:
        return isinstance(dst, torch.Tensor) and dst.shape == src.shape \
            and dst.dtype == src.dtype

    def _put(self, store, key, src):
        """Stash ``src``'s value under ``key``: into the tensor made at
        the first step, never the scope's own tensor."""
        dst = store.get(key)
        if self._fits(dst, src):
            dst.copy_(src)
        else:
            store[key] = src.detach().clone()

    def _copy_into(self, scope, name, src):
        """A stashed value back into the scope's tensor of ``name`` (a
        tensor a captured step holds stays in place)."""
        dst = scope.find_var(name)
        if self._fits(dst, src):
            dst.copy_(src)
        else:
            scope.set_var(name, src.clone())

    def run(self, exe, scope, microbatch_feeds: Sequence[dict],
            fetch_list: Optional[Sequence[str]] = None):
        if len(microbatch_feeds) != self.num_microbatches:
            raise ValueError(
                f"expected {self.num_microbatches} microbatch feeds, got "
                f"{len(microbatch_feeds)}")
        fetch_list = [f if isinstance(f, str) else f.name
                      for f in (fetch_list or [])]
        for f in fetch_list:
            if not any(f in st.forward.global_block().vars
                       for st in self.stages):
                raise KeyError(
                    f"fetch target {f!r} is not produced by any stage's "
                    f"forward program (pipeline fetch supports forward "
                    f"values; grads/optimizer state live in the scope)")
        # fetch name -> list of per-microbatch device values
        fetched: Dict[str, List] = {f: [] for f in fetch_list}

        first = scope not in self._stashes
        store = self._stashes.setdefault(scope, {})

        def stash(prog, mb):
            for n in self._mb_vars(prog):
                arr = scope.find_var(n)
                if arr is not None:
                    self._put(store, (n, mb), arr)

        def unstash(prog, mb):
            for n in self._mb_vars(prog):
                arr = store.get((n, mb))
                if arr is not None:
                    self._copy_into(scope, n, arr)

        plan = self._linearize()
        self.dispatch_log = plan
        self.dispatch_times = []   # (phase, stage, mb, host_enqueue_sec)
        t_loop0 = time.perf_counter()
        with _jit.no_capture() if first else contextlib.nullcontext():
            self._dispatch(plan, exe, scope, microbatch_feeds, fetch_list,
                           fetched, stash, unstash)
        self.last_enqueue_wall = time.perf_counter() - t_loop0

        out = []
        for f in fetch_list:
            arrs = [v.detach().float().cpu().numpy() if v.dtype ==
                    torch.bfloat16 else v.detach().cpu().numpy()
                    for v in fetched[f]]  # sync point
            out.append(np.mean(np.stack(arrs), axis=0))
        self.last_total_wall = time.perf_counter() - t_loop0
        return out

    def _dispatch(self, plan, exe, scope, microbatch_feeds, fetch_list,
                  fetched, stash, unstash):
        phase_prog = {"F": lambda st: st.forward,
                      "B": lambda st: st.backward,
                      "OPT": lambda st: st.optimize}
        for phase, s, mb in plan:
            stage = self.stages[s]
            runner_exe = (self._stage_execs[s]
                          if self._stage_execs is not None else exe)
            prog = phase_prog[phase](stage)
            t0 = time.perf_counter()
            if phase == "OPT":
                runner_exe.run(prog, feed={}, fetch_list=[], scope=scope)
                self.dispatch_times.append(
                    (phase, s, mb, time.perf_counter() - t0))
                continue
            unstash(prog, mb)
            fl = ([f for f in fetch_list
                   if f in prog.global_block().vars]
                  if phase == "F" else [])
            # return_numpy=False keeps the values on the device until the
            # final conversion below
            vals = runner_exe.run(prog, feed=microbatch_feeds[mb],
                                  fetch_list=fl, scope=scope,
                                  return_numpy=False)
            for f, v in zip(fl, vals):
                fetched[f].append(v)
            stash(prog, mb)
            self.dispatch_times.append(
                (phase, s, mb, time.perf_counter() - t0))
