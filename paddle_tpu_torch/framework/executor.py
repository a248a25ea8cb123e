"""Executor — the counterpart of ``paddle_tpu/framework/executor.py``:
``exe.run(program, feed, fetch_list, scope)`` with a persistent
:class:`~.scope.Scope`.

The reference traces block 0 once into one XLA computation per key
(program and version, feed shapes and dtypes, fetch set, scope and its
names, ``flags.version()``) and rebinds every state variable it
returns. The port runs the block op by op through the op registry
(:class:`_BlockRunner`), and on the card records it as one CUDA graph per
key (:mod:`~paddle_tpu_torch.jit`'s ``warm_up`` / ``capture`` /
``replay``, its capture lock, ``no_capture()``):

- a key's first run is the run itself, eager, on the capture stream:
  kernels build and load, cuBLAS makes its handles and the AdamW
  kernel's tables are built there. Its second run captures the block
  (which executes nothing) and replays it once; later runs replay. So
  every ``exe.run`` takes exactly one step. A startup program runs once
  and is never captured;
- state lives in place: a run reads the scope's own tensors and writes
  each new value of a persistable or scope variable into the scope's
  tensor (``copy_``; a pass-through is not copied), so a graph holds the
  state by address. A persistable variable that a run creates (the
  startup program's parameters, the first run's accumulators) is made on
  that run. ``Scope.set_var`` of a name a graph holds copies into the
  held tensor (same shape and dtype) or drops the graph;
- feeds are copied into the graph's static buffers, fetches come back as
  clones (numpy with ``return_numpy=True``, bfloat16 as float32);
- each run's PRNG key (``_next_rng``: ``fold_in(PRNGKey(seed), counter)``
  for a seeded program, else a draw) is a small device input, folded
  with each op's index (or its ``__rng_tag__``) on the device by the ops
  that draw;
- ``FLAGS_check_nan_inf`` scans each op's outputs on the host, so with
  it on every run is eager and a non-finite output raises
  :class:`NanInfError` naming the op and the variable, the reference's
  text;
- liveness (:func:`plan_drops`): a run drops each block-0 value that is
  neither state, nor fetched, nor persistable right after the last op
  that touches it, as XLA's buffer liveness frees it in the reference.
  Under capture the graph pool reuses the freed memory, so a
  checkpointed backward (``RecomputeOptimizer``) holds only its
  checkpoints across the forward. A control-flow op's sub-block reads
  count as the op's own; a host op of a split key reads at its index.

A capture is reported to the compile tracker under the reference's site
name ``executor_step``; on the CPU a new key is (the reference's XLA
compile). The executor has no CPU fallback: ``place=None`` means the
card and raises without one; ``place="cpu"`` runs on the CPU. A
``CompiledProgram`` (:mod:`~paddle_tpu_torch.compiler`) runs through
its ``_compile_for_executor`` door on this same path.

Host ops (``py_func``, the proposal ops, the PS pull and push) split a
captured key (:func:`plan_pieces`); each run hands them its feed as the
host holds it (``host_feed``), so the PS pull reads its ids without a
copy back from the card, and the seconds each spends replaying are
counted by op type (``host_calls``, ``host_seconds``).
``train_from_dataset`` / ``infer_from_dataset`` step the program over a
slot dataset's batches; with ``thread_num`` > 1 hogwild workers run keys
of their own (:meth:`Executor._train_hogwild` says why).
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import flags as _flags
from .. import jit as _jit
from .. import prng
from ..analysis import concurrency as _ccz
from ..device import resolve_device
from ..ops import control_flow_ops as _cf
from ..ops import registry as _reg
from ..resilience.injector import fault_point
from .program import Program, Variable, default_main_program
from .scope import Scope, global_scope


class NanInfError(FloatingPointError):
    """Raised when ``FLAGS_check_nan_inf`` finds a non-finite op output —
    analog of the reference's details/nan_inf_utils_detail.cc scan hooked
    in operator.cc:1056."""


def check_nan_inf_hook(op_type: str, name: str, value):
    """Scan one op output for NaN/Inf on the host (no-op for non-float
    tensors); raises :class:`NanInfError` with the reference's text."""
    if not isinstance(value, torch.Tensor) or not (
            value.is_floating_point() or value.is_complex()):
        return
    bad = int(value.numel() - int(torch.isfinite(value).sum()))
    if bad:
        raise NanInfError(
            f"op {op_type!r} output {name!r} contains {bad} NaN/Inf values "
            f"(FLAGS_check_nan_inf=true)")


#: ``fn(program, block_idx, name, value)`` for every value an op writes
#: (:func:`observe_values`); empty unless a caller probes
_observers: List[Any] = []


@contextlib.contextmanager
def observe_values(fn):
    """Call ``fn(program, block_idx, name, value)`` for every output of
    every op the executor runs while the context is open (under a capture
    too, where ``value`` holds its shape and dtype but no result yet): a
    shape probe, as the abstract interpreter's check on the card reads
    it."""
    _observers.append(fn)
    try:
        yield
    finally:
        _observers.remove(fn)


class _BlockRunner:
    """Runs a block's ops against an env dict of tensors, on ``device``
    (where constants and random keys are made)."""

    def __init__(self, program: Program, mesh=None, axis_env=None, *,
                 device=None):
        self.program = program
        self.mesh = mesh
        self.axis_env = axis_env or {}
        self.device = device
        # block-0 op index -> the values dropped after it (plan_drops)
        self.drops: Dict[int, List[str]] = {}

    def run_block(self, block_idx: int, env: Dict[str, Any], rng,
                  start: int = 0, stop: Optional[int] = None,
                  host_loop=None, host_feed=None) -> Dict[str, Any]:
        """Run ops ``[start, stop)`` of the block (all by default) on
        ``env``; ``host_loop`` goes to a dynamic ``while`` the executor
        split its key at, ``host_feed`` (the run's feed on the host) to
        the ops that read a fed value on the host (the PS pull and
        push)."""
        block = self.program.blocks[block_idx]
        check = _flags.get_flag("check_nan_inf")
        drops = self.drops if block_idx == 0 else {}
        ops = block.ops[start:stop]
        for i, op in enumerate(ops, start):
            # __rng_tag__ pins an op's stream to another position: a
            # recompute clone regenerates the identical dropout mask
            rng_key = op.attrs.get("__rng_tag__", i)
            op_rng = ((lambda k=rng_key: prng.fold_in(rng, k))
                      if rng is not None else None)
            ctx = _reg.LoweringContext(
                rng=op_rng, eager=False, mesh=self.mesh,
                axis_env=self.axis_env, device=self.device)
            ctx.block_runner = self  # control-flow hook
            ctx.env = env
            ctx.block_idx = block_idx
            ctx.host_loop = host_loop
            ctx.host_feed = host_feed
            ctx.op = op
            ins = {}
            for slot, names in op.inputs.items():
                vals = []
                for n in names:
                    if n not in env:
                        raise KeyError(
                            f"op {op.type!r} input {slot}={n!r} is not defined "
                            f"— not produced by a prior op, not fed, and not "
                            f"in scope (analog of PADDLE_ENFORCE NotFound)")
                    vals.append(env[n])
                ins[slot] = vals
            # the op's type names its kernels in a profiler trace (the
            # reference's named_scope)
            with torch.profiler.record_function(op.type):
                outs = _reg.execute(ctx, op.type, ins, op.attrs)
            for slot, names in op.outputs.items():
                vals = outs.get(slot, [])
                for n, v in zip(names, vals):
                    if check:
                        check_nan_inf_hook(op.type, n, v)
                    for fn in _observers:
                        fn(self.program, block_idx, n, v)
                    env[n] = v
            for n in drops.get(i, ()):
                env.pop(n, None)
        return env


def _op_touches(program: Program, op) -> set:
    """The names an op reads or writes, its sub-blocks' (nested ones
    too) counted as its own."""
    from .program import op_sub_block_indices, transitive_sub_blocks
    names = set(op.input_names()) | set(op.output_names())
    for si in op_sub_block_indices(op):
        for bi in transitive_sub_blocks(program, si):
            for inner in program.blocks[bi].ops:
                names.update(inner.input_names())
                names.update(inner.output_names())
    return names


def plan_drops(program: Program, keep) -> Dict[int, List[str]]:
    """Block 0's liveness: op index -> the values to drop from a run's
    env after that op, each at the last op that reads or writes it (a
    value nothing reads goes after the op that made it). Names in
    ``keep`` (state, written back, fetched) and persistable variables
    are never dropped. For an intermediate the env's reference is the
    last one the executor holds, so the tensor is freed there (to the
    graph pool under capture); a feed's buffer stays with its key, and
    a host piece of a split key holds its own inputs."""
    block = program.global_block()
    last: Dict[str, int] = {}
    for i, op in enumerate(block.ops):
        for n in _op_touches(program, op):
            last[n] = i
    drops: Dict[int, List[str]] = {}
    for n, i in last.items():
        v = block.vars.get(n)
        if n in keep or (v is not None and v.persistable):
            continue
        drops.setdefault(i, []).append(n)
    return {i: sorted(ns) for i, ns in drops.items()}


def plan_pieces(program: Program, on_card: bool):
    """Block 0's ops as the pieces a captured key is made of: ``(start,
    stop, host)``. A host piece is one op the host must run (a ``while``
    without ``max_iters``, a ``py_func``: :func:`~..ops.control_flow_ops.
    splits_key`); the ops between are graphs, and the last piece is a
    graph (the state write-back closes it). Decided from the op types
    before the first run; on the card a host op nested in a captured
    body raises here."""
    from ..ops.control_flow_ops import splits_key
    from .program import op_sub_block_indices, transitive_sub_blocks
    ops = program.global_block().ops
    pieces, start = [], 0
    for i, op in enumerate(ops):
        if splits_key(op):
            if start < i:
                pieces.append((start, i, False))
            pieces.append((i, i + 1, True))
            start = i + 1
        elif on_card:
            for si in op_sub_block_indices(op):
                for bi in transitive_sub_blocks(program, si):
                    inner = [o.type for o in program.blocks[bi].ops
                             if splits_key(o)]
                    if inner:
                        raise NotImplementedError(
                            f"op {op.type!r} holds host op(s) {inner} in a "
                            f"sub-block; only a top-level one can split a "
                            f"captured key")
    pieces.append((start, len(ops), False))
    return pieces


def _log_train_step(runlog_mod, step, feed, fetch_names, fetched,
                    step_time_s: float):
    """Emit one structured ``train_step`` run-log event: step index,
    loss (the first scalar fetch, by convention the loss), wall step
    time, and examples/sec from the feed's batch dimension."""
    if not runlog_mod.enabled():
        return
    loss = None
    if fetched:
        v = np.asarray(fetched[0])
        if v.size == 1:
            loss = float(v.ravel()[0])
    batch = None
    for arr in (feed or {}).values():
        shape = getattr(arr, "shape", None)
        if shape:
            batch = int(shape[0])
            break
    runlog_mod.log_event(
        "train_step", step=int(step), loss=loss,
        step_time_ms=round(step_time_s * 1e3, 3),
        examples_per_sec=(round(batch / step_time_s, 3)
                          if batch and step_time_s > 0 else None))


def _print_step(step, infos, fetched):
    msg = ", ".join(f"{n}={np.asarray(v).ravel()[:4]}"
                    for n, v in zip(infos, fetched))
    print(f"[train_from_dataset] step {step}: {msg}")


def _collect_io(block, feed_names, scope: Scope):
    """Static analysis of a block: which names must come from scope (state),
    and which outputs must be written back.

    Scope-resident inputs: read before first definition, not fed. Write-back
    set: every scope-resident input (pass-through or updated) plus any
    persistable output. The port copies only the values a run changed.
    """
    defined = set(feed_names)
    state_in: List[str] = []
    written: List[str] = []
    for op in block.ops:
        for names in op.inputs.values():
            for n in names:
                if n not in defined and n not in state_in:
                    if scope.has_var(n):
                        state_in.append(n)
                        defined.add(n)
        for names in op.outputs.values():
            for n in names:
                defined.add(n)
                try:
                    v = block.var(n)
                    persistable = v.persistable
                except KeyError:
                    persistable = False
                if (persistable or scope.has_var(n)) and n not in written:
                    written.append(n)
    # every state input is written back (pass-through if not updated)
    for n in state_in:
        if n not in written:
            written.append(n)
    return state_in, written


def _host_tensor(v) -> torch.Tensor:
    """A feed value as a tensor (numpy arrays without a copy)."""
    if isinstance(v, torch.Tensor):
        return v
    return torch.from_numpy(np.ascontiguousarray(np.asarray(v)))


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


class _ExecGraph:
    """One captured key: its pieces in order (``("graph", graph, delta,
    bodies)`` or ``("host", op index, inputs, output buffers,
    host_loop)``), its feed buffers, its key buffer and its fetch
    outputs."""

    def __init__(self, pieces, feeds, rng, outputs):
        self.pieces, self.feeds, self.rng = pieces, feeds, rng
        self.outputs = outputs

    @property
    def bodies(self):
        return [b for p in self.pieces if p[0] == "graph" for b in p[3]]

    def kernels(self) -> int:
        """The kernel nodes of the key's graphs (IF bodies apart)."""
        return sum(_jit.graph_kernels(p[1]) for p in self.pieces
                   if p[0] == "graph")


class _Entry:
    """One cache key's analysis, its run count and, on the card, its
    graph."""

    def __init__(self, runner, state_in, written, fetch_names, refs,
                 pieces=None, worker=None):
        self.runner = runner
        self.worker = worker      # the hogwild worker the key is for
        self.state_in, self.written = state_in, written
        self.fetch_names = fetch_names
        self._refs = refs         # (program, scope): ids stay unique
        self.pieces = pieces      # plan_pieces' split of block 0
        self.runs = 0
        self.graph: Optional[_ExecGraph] = None
        self.feed_bufs = None     # the feeds' tensors on the card

    def drop_graph(self):
        """Forget the graph (a held tensor was rebound): the next run is
        eager again and the one after it captures anew."""
        self.graph = None
        self.runs = 0


class Executor:
    """Analog of fluid.Executor (executor.py:915 / executor.cc:180).

    ``place`` None runs on the card (and raises without one); a device
    (``"cpu"``, ``"cuda:0"``, a ``torch.device``) runs there.
    ``donate_state`` is accepted for the reference's signature: the port
    updates state in place always."""

    def __init__(self, place: Any = None, donate_state: bool = False):
        self.place = place
        self.device = resolve_device(place)
        self.donate_state = donate_state
        self._cache: Dict[Any, _Entry] = {}
        self._verified_programs: set = set()
        # serializes cache-miss builds, as in the reference
        self._build_lock = _ccz.make_lock("Executor._build_lock")
        self._seed_counters: Dict[int, int] = {}
        self._seed_lock = _ccz.make_lock("Executor._seed_lock")
        # OS-entropy seeded: unseeded programs vary run to run; set
        # program.random_seed for determinism
        self._nprng = np.random.RandomState()
        # the graphs' memory pools (card): one for the executor's keys,
        # one more per hogwild worker's
        self._pools: Dict[Any, Any] = {}
        self.captures = 0         # keys captured (card)
        self.graphs = 0           # graphs captured (a split key has several)
        self.host_syncs = 0       # host reads of predicates, the last run
        # host pieces replayed on the card, by op type: calls and seconds
        self.host_calls: Dict[str, int] = {}
        self.host_seconds: Dict[str, float] = {}
        self._stats_lock = _ccz.make_lock("Executor._stats_lock")
        # the last hogwild epoch: steps on this thread and in the workers
        self.hogwild_stats: Dict[str, Any] = {}

    # -- public API --------------------------------------------------------
    def run(
        self,
        program: Optional[Program] = None,
        feed: Optional[Dict[str, Any]] = None,
        fetch_list: Optional[Sequence[Any]] = None,
        scope: Optional[Scope] = None,
        return_numpy: bool = True,
    ):
        program = program or default_main_program()
        # chaos hook: `exec.step:nan@N` simulates the N-th step hitting a
        # NaN batch; `error`/`preempt` kinds raise straight through
        kind = fault_point("exec.step")
        if kind == "nan":
            raise NanInfError(
                "injected non-finite step (fault spec 'exec.step:nan')")
        if hasattr(program, "_compile_for_executor"):
            # CompiledProgram: its passes applied once, then this path
            return program._compile_for_executor(self).run(
                feed=feed, fetch_list=fetch_list, scope=scope,
                return_numpy=return_numpy)
        if not isinstance(program, Program):
            raise TypeError(
                f"Executor.run expects a Program or CompiledProgram, got "
                f"{type(program).__name__}")
        return self._run(program, feed, fetch_list, scope, return_numpy)

    @staticmethod
    def _key(program, feed, fetch_names, scope, worker):
        feed_sig = tuple(sorted(
            (k, tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in feed.items()))
        # the scope-names signature catches "scope populated after the
        # first run"; the entry keeps program and scope alive, so an id
        # cannot be reused by another object while its entry exists
        scope_sig = hash(frozenset(scope.all_var_names()))
        return (id(program), program._version, feed_sig, tuple(fetch_names),
                id(scope), scope_sig, _flags.version(), worker)

    def _run(self, program: Program, feed, fetch_list, scope,
             return_numpy: bool, worker=None, may_capture=True,
             snapshot=False):
        """One run of a Program (``run`` past its fault point and its
        CompiledProgram door); ``worker`` (a hogwild worker's index)
        gives the run a key, and on the card graphs and a memory pool,
        of its own; with ``may_capture`` False a key that holds no graph
        yet runs eagerly (a hogwild thread never captures), and with
        ``snapshot`` an eager run reads copies of the state (a hogwild
        thread: another worker's in-place writes must not reach this
        step's autograd graph), whose new values it writes back."""
        feed = {k: _host_tensor(v) for k, v in (feed or {}).items()}
        scope = scope or global_scope()
        fetch_names = [f.name if isinstance(f, Variable) else str(f)
                       for f in (fetch_list or [])]
        key = self._key(program, feed, fetch_names, scope, worker)
        entry = self._cache.get(key)
        new = entry is None
        t0 = time.perf_counter()
        reads0 = _cf.host_reads
        if new:
            with self._build_lock:
                entry = self._cache.get(key)
                if entry is None:
                    entry = self._build(program, feed, fetch_names, scope)
                    entry.worker = worker
                    self._cache[key] = entry
        state = self._state(entry, scope)
        rng = self._next_rng(program)
        dev = self.device
        graphs = (dev.type == "cuda" and _jit.capture_enabled()
                  and not _flags.get_flag("check_nan_inf"))
        if graphs and entry.graph is None and entry.runs >= 1 \
                and may_capture:
            fetches = self._capture(entry, scope, state, feed, rng)
            self._compiled(feed, t0)
        elif graphs and entry.graph is not None:
            fetches = self._replay(entry, feed, rng)
        else:
            if snapshot:
                state = {n: v.clone() for n, v in state.items()}
            feed_dev = (self._feed_buffers(entry, feed) if dev.type == "cuda"
                        else {k: v.to(dev) for k, v in feed.items()})
            rng_dev = rng.to(dev)
            if dev.type == "cuda":
                fetches = _jit.warm_up(dev, self._eager, entry, scope,
                                       state, feed_dev, rng_dev, feed)
            else:
                fetches = self._eager(entry, scope, state, feed_dev,
                                      rng_dev, feed)
            if new and dev.type != "cuda":
                self._compiled(feed, t0)
        entry.runs += 1
        self.host_syncs = _cf.host_reads - reads0
        if return_numpy:
            return [_to_numpy(f) for f in fetches]
        return list(fetches)

    def train_from_dataset(self, program=None, dataset=None,
                           scope: Optional[Scope] = None,
                           fetch_list: Optional[Sequence[Any]] = None,
                           fetch_info: Optional[Sequence[str]] = None,
                           print_period: Optional[int] = None,
                           debug: bool = False, trainer_desc=None, *,
                           on_step=None):
        """Run one epoch over a Dataset (analog of executor.py:1597
        train_from_dataset -> MultiTrainer::Run, multi_trainer.cc:120):
        each batch of ``dataset.batch_iterator()`` feeds one ``run`` of
        the program (one key per batch signature: a captured step on the
        card). Explicit arguments win over ``trainer_desc``'s;
        ``print_period`` defaults to 100; a ``trainer_desc`` with
        ``thread_num`` > 1 runs hogwild workers (:meth:`_train_hogwild`).
        Returns the fetched values of the final batch, printing every
        ``print_period`` steps with ``debug``. ``on_step(step, fetched)``
        (the port's addition) sees every step's fetches."""
        if dataset is None:
            raise ValueError("train_from_dataset requires a dataset")
        if trainer_desc is not None:
            # TrainerDesc config plane (trainer_desc.py parity);
            # explicit arguments always win over the desc
            fetch_list = fetch_list or trainer_desc._fetch_vars
            fetch_info = fetch_info or trainer_desc._fetch_info
            if print_period is None:
                print_period = trainer_desc._print_period
            debug = debug or bool(trainer_desc._fetch_vars)
        if print_period is None:
            print_period = 100
        scope = scope or global_scope()
        fetch_names = [f.name if isinstance(f, Variable) else str(f)
                       for f in (fetch_list or [])]
        thread_num = int(getattr(trainer_desc, "_thread_num", 1) or 1) \
            if trainer_desc is not None else 1
        if thread_num > 1:
            return self._train_hogwild(program, dataset, scope,
                                       fetch_names, thread_num,
                                       debug=debug,
                                       fetch_info=fetch_info,
                                       print_period=print_period,
                                       on_step=on_step)
        from ..observability import runlog as _runlog
        last = None
        for step, feed in enumerate(dataset.batch_iterator()):
            t0 = time.perf_counter()
            last = self.run(program, feed=feed, fetch_list=fetch_names,
                            scope=scope)
            _log_train_step(_runlog, step, feed, fetch_names, last,
                            time.perf_counter() - t0)
            if on_step is not None:
                on_step(step, last)
            if debug and fetch_names and step % print_period == 0:
                _print_step(step, fetch_info or fetch_names, last)
        return last

    def _train_hogwild(self, program, dataset, scope, fetch_names,
                       thread_num: int, debug: bool = False,
                       fetch_info=None, print_period: int = 100, *,
                       on_step=None):
        """Hogwild-style concurrent device workers (TrainerDesc
        thread_num > 1; analog of hogwild_worker.cc under
        MultiTrainer::Run): N threads drain one shared batch queue and
        step the program against the SAME scope, lock-free. Racing
        parameter writes are last-writer-wins — the hogwild contract —
        while host sparse tables stay consistent through their per-shard
        locks.

        The reference's N threads share one compiled step. One key's
        CUDA graphs hold their feeds and intermediates by address, so two
        threads replaying one key would race on them, and a capture
        fails while another thread launches work. So each worker runs a
        key of its own (``_run``'s ``worker``), with graphs from a
        memory pool of its own, and every key is captured on the calling
        thread, one after the other, before the threads start: worker
        0's first batch is its eager run (the first batch runs
        single-threaded, as in the reference), its second the capture,
        then the same for worker 1, and so on (on the CPU, which
        captures nothing, only the first batch runs here). The threads
        then only replay; a batch of another signature runs eagerly in
        its thread and is never captured there. The parameters are the
        scope's tensors, shared in place by every worker's graphs: last
        writer wins. An eager run in a thread (every run on the CPU)
        reads a copy of the state, as the reference's step reads the
        scope's arrays when it is called, and writes its result back:
        last writer wins there too. ``captures`` counts one key per
        worker."""
        import queue as _queue

        if self.donate_state:
            raise ValueError(
                "hogwild (thread_num > 1) is incompatible with "
                "donate_state=True: concurrent workers would donate the "
                "same scope buffers another worker is still reading — "
                "use a non-donating Executor or thread_num=1")
        program = program or default_main_program()
        on_card = (self.device.type == "cuda" and _jit.capture_enabled()
                   and not _flags.get_flag("check_nan_inf"))
        it = dataset.batch_iterator()
        last_holder = {0: None}
        step_counter = [0]
        counter_lock = _ccz.make_lock("Executor._hogwild_counter")

        def report(step, r):
            if on_step is not None:
                on_step(step, r)
            if (debug and fetch_names
                    and step % max(print_period, 1) == 0):
                _print_step(step, fetch_info or fetch_names, r)

        def warm(w) -> bool:
            """Run batches of worker ``w``'s key here until it holds a
            graph (the CPU: one batch); False when the data ran out."""
            while True:
                feed = next(it, None)
                if feed is None:
                    return False
                r = self._run(program, feed, fetch_names, scope, True,
                              worker=w)
                step = step_counter[0]
                step_counter[0] += 1
                last_holder[0] = r
                report(step, r)
                if not on_card or self._held_graph(
                        program, feed, fetch_names, scope, w):
                    return True

        for w in (range(thread_num) if on_card else (0,)):
            if not warm(w):
                return last_holder[0]
        warm_steps = step_counter[0]

        q: "_queue.Queue" = _queue.Queue(maxsize=thread_num * 2)
        errors: list = []

        def worker(w):
            while True:
                item = q.get()
                if item is None:
                    return
                try:
                    r = self._run(program, item, fetch_names, scope, True,
                                  worker=w, may_capture=False,
                                  snapshot=True)
                    with counter_lock:
                        step = step_counter[0]
                        step_counter[0] += 1
                        last_holder[0] = r
                    report(step, r)
                except BaseException as e:  # surfaced after join
                    errors.append(e)
                    return

        threads = [threading.Thread(target=worker, args=(w,), daemon=True,
                                    name=f"hogwild-{w}")
                   for w in range(thread_num)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()

        def put_checked(item) -> bool:
            """Bounded put that never deadlocks: if every worker died on
            errors, stop producing and surface the failure."""
            while True:
                try:
                    q.put(item, timeout=0.2)
                    return True
                except _queue.Full:
                    if len(errors) >= thread_num:
                        return False

        try:
            for feed in it:
                if errors:
                    break
                if not put_checked(feed):
                    break
        finally:
            # always shut workers down — a dataset iterator that raises
            # mid-epoch must not leak N threads parked on q.get()
            for _ in threads:
                if not put_checked(None):
                    break
            for t in threads:
                t.join()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.hogwild_stats = {
            "warm_steps": warm_steps,
            "thread_steps": step_counter[0] - warm_steps,
            "thread_seconds": time.perf_counter() - t0}
        if errors:
            raise errors[0]
        return last_holder[0]

    def _held_graph(self, program, feed, fetch_names, scope, worker):
        """Whether the key of this run holds a captured graph."""
        feed = {k: _host_tensor(v) for k, v in feed.items()}
        entry = self._cache.get(self._key(program, feed, fetch_names, scope,
                                          worker))
        return entry is not None and entry.graph is not None

    def infer_from_dataset(self, program=None, dataset=None,
                           scope: Optional[Scope] = None,
                           fetch_list: Optional[Sequence[Any]] = None,
                           **kw):
        """Inference twin of train_from_dataset (executor.py parity)."""
        return self.train_from_dataset(program, dataset, scope,
                                       fetch_list, **kw)

    def close(self):
        self._cache.clear()

    # -- internals ---------------------------------------------------------
    def _next_rng(self, program: Program) -> torch.Tensor:
        """This run's key ``[2]`` int64 on the host."""
        if program.random_seed is not None:
            seed = int(program.random_seed)
            # deterministic but varying per call for this program
            with self._seed_lock:
                ctr = self._seed_counters.get(id(program), 0) + 1
                self._seed_counters[id(program)] = ctr
            key = prng.fold_in_host((0, seed & prng.MASK), ctr)
        else:
            with self._seed_lock:  # RandomState is not thread-safe
                key = (0, int(self._nprng.randint(0, 2**31 - 1)))
        return torch.tensor(key, dtype=torch.int64)

    def _verify_once(self, program: Program, feed_arrays, fetch_names,
                     scope):
        """FLAGS_check_program / FLAGS_check_shapes hook: static-verify
        the program at its first run (framework/analysis.py), so a
        malformed IR fails with block/op coordinates instead of an error
        inside a lowering or a capture. Names held by the scope count as
        feeds — state residency is a runtime property the static check
        must not second-guess."""
        key = (id(program), program._version)
        if key in self._verified_programs:
            return
        from .analysis import verify_program
        feeds = set(feed_arrays) | set(scope.all_var_names())
        verify_program(program, feeds=feeds,
                       fetches=fetch_names).raise_if_errors(
            f"FLAGS_check_program: first compile of {program!r}")
        self._verified_programs.add(key)

    def _build(self, program: Program, feed_arrays, fetch_names, scope):
        if (_flags.get_flag("check_program")
                or _flags.get_flag("check_shapes")):
            self._verify_once(program, feed_arrays, fetch_names, scope)
        block = program.global_block()
        state_in, written = _collect_io(block, feed_arrays.keys(), scope)
        runner = _BlockRunner(program, device=self.device)
        runner.drops = plan_drops(
            program, set(state_in) | set(written) | set(fetch_names))
        pieces = plan_pieces(program, self.device.type == "cuda")
        return _Entry(runner, state_in, written, fetch_names,
                      (program, scope), pieces)

    def _state(self, entry, scope) -> Dict[str, torch.Tensor]:
        """The scope's tensors of the entry's state inputs, on the
        executor's device (a tensor elsewhere is moved there and
        rebound)."""
        state = {}
        for n in entry.state_in:
            v = scope.find_var(n)
            if v is None:
                raise KeyError(
                    f"variable {n!r} needed by the program is not in scope — "
                    f"did you run the startup program?")
            if not isinstance(v, torch.Tensor) or v.device != self.device:
                v = _host_tensor(v).to(self.device)
                scope.set_var(n, v)
            state[n] = v
        return state

    def _body(self, entry, scope, state, feed, rng, host_feed=None):
        """One step: run the block, take the fetches, write the changed
        state into the scope's tensors."""
        env = dict(state)
        env.update(feed)
        env = entry.runner.run_block(0, env, rng, host_feed=host_feed)
        return self._finish(entry, scope, env, False)

    def _finish(self, entry, scope, env, capturing):
        """The fetches of ``env`` (clones unless capturing) and its state
        written into the scope's tensors. Under capture a variable the
        scope lacks, or whose tensor does not fit, raises."""
        missing = [n for n in entry.fetch_names if n not in env]
        if missing:
            raise KeyError(f"fetch vars not produced by program: {missing}")
        fetches = [env[n] for n in entry.fetch_names]
        if not capturing:
            fetches = [f.clone() for f in fetches]
        for n in entry.written:
            v = env.get(n)
            if v is None:
                continue
            old = scope._vars.get(n)
            if old is v:
                continue
            if isinstance(old, torch.Tensor) and old.shape == v.shape \
                    and old.dtype == v.dtype:
                old.copy_(v)
            elif capturing:
                raise RuntimeError(
                    f"executor: variable {n!r} would be rebound under "
                    "capture (new, or of another shape or dtype); a "
                    "captured step writes its state in place")
            else:
                scope.set_var(n, v.clone())
        return fetches

    def _eager(self, entry, scope, state, feed, rng, host_feed=None):
        with torch.no_grad():
            return self._body(entry, scope, state, feed, rng, host_feed)

    def _capture_graph(self, fn, pool):
        """``fn()`` captured as one graph of ``pool``: ``(graph, delta,
        bodies)``."""
        from ..ops.cuda import cond_graph
        with cond_graph.collecting() as bodies:
            graph, _, delta = _jit.capture(self.device, fn, [], pool)
        for b in bodies:
            b.count_kernels()
        self.graphs += 1
        return graph, delta, bodies

    @staticmethod
    def _replay_graph(graph, delta, bodies):
        from ..ops.cuda import cond_graph
        _jit.replay(graph, delta)
        cond_graph.settle(bodies)

    def _capture(self, entry, scope, state, feed, rng):
        """The key's second run: each piece is captured and replayed in
        turn (a capture runs nothing), a host piece is run by the host
        (a dynamic ``while`` captures its body's graph on the way); the
        last graph writes the state back. Returns the fetches."""
        from ..ops.control_flow_ops import HostLoop
        dev = self.device
        pool = self._pools.get(entry.worker)
        if pool is None:
            pool = self._pools[entry.worker] = torch.cuda.graph_pool_handle()
        feeds = self._feed_buffers(entry, feed)
        rng_buf = rng.to(dev, copy=True)
        env = dict(state)
        env.update(feeds)
        runner, ops = entry.runner, entry._refs[0].global_block().ops
        pieces, out = [], []
        with torch.no_grad():
            for a, b, host in entry.pieces:
                if host:
                    loop = HostLoop(
                        lambda fn: self._capture_graph(fn, pool),
                        lambda g: self._replay_graph(*g))
                    op = ops[a]
                    ins = {n: env[n] for names in op.inputs.values()
                           for n in names}
                    runner.run_block(0, env, rng_buf, a, b, host_loop=loop,
                                     host_feed=feed)
                    bufs = {n: env[n].clone() for names in
                            op.outputs.values() for n in names if n in env}
                    env.update(bufs)
                    pieces.append(("host", a, ins, bufs, loop))
                    continue
                last = b == len(ops)

                def fn(a=a, b=b, last=last):
                    runner.run_block(0, env, rng_buf, a, b)
                    if last:
                        out.extend(self._finish(entry, scope, env, True))

                graph, delta, bodies = self._capture_graph(fn, pool)
                self._replay_graph(graph, delta, bodies)
                pieces.append(("graph", graph, delta, bodies))
        self.captures += 1
        entry.graph = _ExecGraph(pieces, feeds, rng_buf, out)
        scope._hold(set(entry.state_in) | set(entry.written), entry)
        return [o.clone() for o in out]

    def _feed_buffers(self, entry, feed):
        """The entry's feed tensors on the card, filled with ``feed``: the
        same tensors from its first run on, so the eager run and the
        capture hand the ops the same addresses (the AdamW kernel's
        tables are keyed by them: a fed learning rate)."""
        bufs = entry.feed_bufs
        if bufs is None:
            bufs = entry.feed_bufs = {k: v.to(self.device, copy=True)
                                      for k, v in feed.items()}
        else:
            for k, buf in bufs.items():
                buf.copy_(feed[k], non_blocking=True)
        return bufs

    def _replay(self, entry, feed, rng):
        g = entry.graph
        for k, buf in g.feeds.items():
            buf.copy_(feed[k], non_blocking=True)
        g.rng.copy_(rng, non_blocking=True)
        runner = entry.runner
        ops = entry._refs[0].global_block().ops
        with torch.no_grad():
            for p in g.pieces:
                if p[0] == "graph":
                    self._replay_graph(*p[1:])
                    continue
                _, a, ins, bufs, loop = p
                t0 = time.perf_counter()
                env = runner.run_block(0, dict(ins), g.rng, a, a + 1,
                                       host_loop=loop, host_feed=feed)
                for n, buf in bufs.items():
                    buf.copy_(env[n])
                self._note_host(ops[a].type, time.perf_counter() - t0)
        return [o.clone() for o in g.outputs]

    def _note_host(self, op_type: str, seconds: float):
        with self._stats_lock:
            self.host_calls[op_type] = self.host_calls.get(op_type, 0) + 1
            self.host_seconds[op_type] = \
                self.host_seconds.get(op_type, 0.0) + seconds

    @staticmethod
    def _compiled(feed, t0):
        from ..observability import compile_tracker as _ct
        _ct.note_compile("executor_step", None, list(feed.values()),
                         (time.perf_counter() - t0) * 1e3)
