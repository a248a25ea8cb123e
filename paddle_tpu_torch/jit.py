"""jit — the counterpart of ``paddle_tpu/jit.py``'s ``to_static``
(``:74``) and ``to_static_multi_step`` (``:215``).

The reference traces a dygraph step (forward, backward, ``opt.step()``)
into one XLA computation and threads the parameters, gradients and
optimizer state through it. On a CUDA card the port records the step
as one CUDA graph and replays it:

- the first call for a key runs the function eagerly, on the stream the
  graph will be captured on. This is the warm-up, and its step really
  happens: kernels build and load, cuBLAS makes its handles and the
  optimizer creates its accumulators here, never under capture;
- the second call copies its arguments into static buffers, captures
  one ``torch.cuda.CUDAGraph`` of the function and replays it once;
- later calls copy their arguments into the buffers and replay.

So every call is exactly one step, as in JAX. The key is (the
arguments' shapes and dtypes, which gradients are present,
``flags.version()``), as ``paddle_tpu/jit.py:184-190`` retraces. The
function's Python code runs at the warm-up and at the capture only;
state it touches must be updated in place (the port's optimizers and
BatchNorm's running statistics are), and a capture that rebinds a
parameter, a buffer (BatchNorm's ``_mean`` / ``_variance``) or an
optimizer's state, or fails in any other way, raises after restoring the
bindings it changed (each ``p.grad``, each optimizer's state). It never
falls back to the eager path. On the CPU the function simply runs
eagerly.

Learning rates: before every replay each optimizer refreshes its device
learning-rate tensors from its scheduler (or float) and its parameters'
``lr_scale`` (``Optimizer._refresh_lr``: a fill per slot whose value
changed, outside the graph), so a scheduler stepped between calls is
followed; ``to_static_multi_step``'s K replays of one call share one
learning rate. A capture pins each parameter's slot
(``Optimizer._pin_lr``): an ``lr_scale`` changed after it raises at the
next refresh, as the graph would go on reading the old slot. The
reference bakes ``float(lr)`` into its traced step and keeps it (its key
ignores the learning rate): a deliberate divergence.

Outputs are returned detached: fresh clones of the graph's outputs after
a replay, never the static buffers. The kernel wrappers' Python launch
counts do not tick on a replay, so the capture records each count's
change and every replay adds it: ``launches`` keeps meaning the launches
the card ran.

Gradients: with ``retain_grads=False`` every ``p.grad`` is None after a
call, as the reference leaves it. The reference's memory lever (XLA frees
each gradient at its update, ``paddle_tpu/jit.py:100-107``) is not
reproduced: the gradients live in the graph's memory pool between
replays. With ``retain_grads=True`` each ``p.grad`` after a replay is
the graph's gradient output. A step that clears its gradients before
``backward()`` (as ``bench.py``'s do) never reads the gradients it found,
so a replay copies nothing and the graph keeps no reference to them. A
step that accumulates into its gradients does so in place (autograd
accumulates in place without ``create_graph``), so its graph reads and
writes the tensors it found, and a replay copies a gradient into that
tensor only where the caller rebound ``p.grad`` since. A step that leaves
a gradient with a ``grad_fn`` (``backward(create_graph=True)``, which
accumulates out of place) is refused at capture.

Serving captures its steps with the same pieces (:func:`warm_up`,
:func:`capture`, :func:`replay`) through :class:`HeldStep`, which differs
from ``to_static`` in what is an argument: only the small inputs are
copied into static buffers; the KV pools and the parameters are held by
address. :func:`no_capture` turns every capture off, as
``jax.disable_jit()`` turns off the reference's compiles.
"""

from __future__ import annotations

import contextlib
import threading
import weakref
from typing import Callable, Optional

import numpy as np
import torch

from . import flags as _flags


# ------------------------------------------------------------ launch counts

def _counted_modules():
    from .ops.cuda import (adamw, flash_attention, flash_pack2, layer_norm,
                           paged_attention)
    return (adamw, flash_attention, flash_pack2, layer_norm, paged_attention)


def launch_counts() -> dict:
    """Every kernel wrapper's launch count: ``{(module, kernel, route):
    n}``, route None for the per-kernel totals."""
    out = {}
    for m in _counted_modules():
        name = m.__name__.rsplit(".", 1)[1]
        if isinstance(m.launches, int):
            out[(name, None, None)] = m.launches
        else:
            for k, n in m.launches.items():
                out[(name, k, None)] = n
        for k, by in getattr(m, "launches_by_route", {}).items():
            for r, n in by.items():
                out[(name, k, r)] = n
    return out


def _set_launch_counts(counts):
    mods = {m.__name__.rsplit(".", 1)[1]: m for m in _counted_modules()}
    for (name, kernel, route), n in counts.items():
        m = mods[name]
        if kernel is None:
            m.launches = n
        elif route is None:
            m.launches[kernel] = n
        else:
            m.launches_by_route[kernel][route] = n


def _add_launch_counts(delta):
    now = launch_counts()
    _set_launch_counts({k: now[k] + n for k, n in delta.items()})


# ----------------------------------------------------------------- helpers

def _as_tensor(a):
    return torch.from_numpy(a) if isinstance(a, np.ndarray) else a


def _signature(a):
    if isinstance(a, torch.Tensor):
        return ("tensor", tuple(a.shape), a.dtype)
    try:
        hash(a)
    except TypeError:
        raise TypeError(f"to_static takes tensors, arrays and hashable "
                        f"constants as arguments, not {type(a).__name__}")
    return ("const", a)


def _tree_map(fn, out):
    if isinstance(out, torch.Tensor):
        return fn(out)
    if isinstance(out, (list, tuple)):
        return type(out)(_tree_map(fn, o) for o in out)
    if isinstance(out, dict):
        return {k: _tree_map(fn, v) for k, v in out.items()}
    return out


def _stack(outs):
    """``[K]`` per-step outputs of one structure -> one structure of
    ``[K, ...]`` tensors (non-tensor leaves become lists)."""
    first = outs[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(outs)
    if isinstance(first, (list, tuple)):
        return type(first)(_stack([o[i] for o in outs])
                           for i in range(len(first)))
    if isinstance(first, dict):
        return {k: _stack([o[k] for o in outs]) for k in first}
    return list(outs)


def _refuse(mesh, param_rules, arg_specs):
    if mesh is not None or param_rules is not None or arg_specs is not None:
        raise NotImplementedError(
            "mesh/param_rules/arg_specs (the SPMD train step) are not "
            "ported yet; the port's to_static runs on one card")


# ------------------------------------------------------------- capturing

_local = threading.local()


@contextlib.contextmanager
def no_capture():
    """Inside this context every ``to_static`` step and every serving step
    entry runs its eager body, also on the card: nothing is captured and
    nothing replays. The counterpart of ``jax.disable_jit()`` and, like
    it, a debugging switch; it is also how one process times eager
    against captured steps. Nests; holds for the calling thread."""
    _local.depth = getattr(_local, "depth", 0) + 1
    try:
        yield
    finally:
        _local.depth -= 1


def capture_enabled() -> bool:
    """False inside :func:`no_capture`."""
    return not getattr(_local, "depth", 0)


_streams = {}      # device -> the stream steps warm up and capture on


def _side_stream(dev):
    s = _streams.get(dev)
    if s is None:
        s = _streams[dev] = torch.cuda.Stream(dev)
    return s


def warm_up(dev, fn, *args):
    """``fn(*args)`` run eagerly on the capture stream, ordered after the
    caller's stream and before its later work (``torch.cuda.graphs``'
    warm-up rule: kernels load and cuBLAS makes its handles there, never
    under capture)."""
    cur = torch.cuda.current_stream(dev)
    side = _side_stream(dev)
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        out = fn(*args)
    cur.wait_stream(side)
    return out


def capture(dev, fn, args, pool=None):
    """``fn(*args)`` recorded as one ``torch.cuda.CUDAGraph`` on the
    capture stream, its memory from ``pool`` (a
    ``torch.cuda.graph_pool_handle()``; None: a pool of its own). Returns
    ``(graph, outputs, delta)``, ``delta`` being the launch counts one
    replay adds. The capture runs nothing, so the counts are restored,
    also when it raises. The graph keeps its ``cudaGraph_t`` beside the
    executable, which is instantiated here, so :func:`graph_kernels` can
    count what a replay launches."""
    counts = launch_counts()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    try:
        with torch.cuda.graph(graph, pool=pool, stream=_side_stream(dev)):
            out = fn(*args)
        graph.instantiate()
        now = launch_counts()
    finally:
        _set_launch_counts(counts)
    delta = {k: n - counts.get(k, 0) for k, n in now.items()
             if n != counts.get(k, 0)}
    return graph, out, delta


#: the driver API's node types that :func:`graph_kernels` reads
_CU_KERNEL_NODE, _CU_CHILD_GRAPH_NODE = 0, 4


def graph_kernels(graph) -> int:
    """The kernels one replay of ``graph`` (from :func:`capture`)
    launches: its kernel nodes, those of child graphs included, read from
    the kept ``cudaGraph_t`` through the driver API. Exact where a
    profiler's trace of a replay may drop or add a record."""
    import ctypes
    cu = ctypes.CDLL("libcuda.so.1")
    ptr, size = ctypes.c_void_p, ctypes.c_size_t

    def check(rc, what):
        if rc != 0:
            raise RuntimeError(f"{what} failed with CUresult {rc}")

    def count(g):
        n = size(0)
        check(cu.cuGraphGetNodes(g, None, ctypes.byref(n)), "cuGraphGetNodes")
        nodes = (ptr * n.value)()
        check(cu.cuGraphGetNodes(g, nodes, ctypes.byref(n)),
              "cuGraphGetNodes")
        total = 0
        for node in nodes:
            kind = ctypes.c_int(-1)
            check(cu.cuGraphNodeGetType(ptr(node), ctypes.byref(kind)),
                  "cuGraphNodeGetType")
            if kind.value == _CU_KERNEL_NODE:
                total += 1
            elif kind.value == _CU_CHILD_GRAPH_NODE:
                child = ptr()
                check(cu.cuGraphChildGraphNodeGetGraph(
                    ptr(node), ctypes.byref(child)),
                    "cuGraphChildGraphNodeGetGraph")
                total += count(child)
        return total

    return count(ptr(graph.raw_cuda_graph()))


def replay(graph, delta):
    """One replay of ``graph`` on the caller's current stream, ordered
    after the work queued there; the launch counts gain ``delta``."""
    graph.replay()
    _add_launch_counts(delta)


# ------------------------------------------------------------------ graphs

class _Graph:
    """One captured step: the graph, its static input buffers (None for a
    constant argument), its outputs, the launch counts one replay adds,
    each parameter's gradient after the step (``grads_out``) and, where
    the step accumulated into the gradient it found, that tensor
    (``grads_in``; None elsewhere: the graph never reads it)."""

    def __init__(self, graph, inputs, outputs, delta, grads_in, grads_out):
        self.graph, self.inputs, self.outputs = graph, inputs, outputs
        self.delta = delta
        self.grads_in, self.grads_out = grads_in, grads_out

    def run(self, params, args=None):
        if args is not None:
            for buf, a in zip(self.inputs, args):
                if buf is not None:
                    buf.copy_(a, non_blocking=True)
        for p, gi in zip(params, self.grads_in):
            if gi is not None and p.grad is not gi:
                gi.copy_(p.grad)
        replay(self.graph, self.delta)
        for p, go in zip(params, self.grads_out):
            p.grad = go
        return _tree_map(torch.clone, self.outputs)


class _Step:
    """One function's step over fixed layers and optimizers: the eager
    path on the CPU, and on CUDA the warm-up, capture and replays of one
    graph per key. ``to_static`` and ``to_static_multi_step`` of the
    same function, layers, optimizers and ``retain_grads`` share it, and
    so its graphs."""

    def __init__(self, fn, layers, optimizers, retain_grads):
        self.fn = fn
        self.optimizers = list(optimizers)
        self.retain_grads = retain_grads
        self.layers = list(layers)
        self.params = []
        seen = set()
        for layer in layers:
            for p in layer.parameters():
                if id(p) not in seen:
                    seen.add(id(p))
                    self.params.append(p)
        self.warmed = set()       # keys whose eager warm-up ran
        self.graphs = {}          # key -> _Graph

    def key(self, args):
        """What a captured graph is specialised to: the arguments' shapes
        and dtypes (constants by value), which gradients are present and
        the flags' version."""
        return (tuple(_signature(_as_tensor(a)) for a in args),
                tuple(p.grad is not None for p in self.params),
                _flags.version())

    def device(self, args):
        """The CUDA device of the step (of its first CUDA argument or
        parameter), or None: the step runs eagerly."""
        for t in list(args) + self.params:
            if isinstance(t, torch.Tensor) and t.is_cuda:
                return t.device
        return None

    def __call__(self, *args):
        args = [_as_tensor(a) for a in args]
        dev = self.device(args)
        if dev is None or not capture_enabled():
            args = [a.to(dev) if dev is not None and
                    isinstance(a, torch.Tensor) else a for a in args]
            out = _tree_map(torch.Tensor.detach, self.fn(*args))
        else:
            args = [a.to(dev) if isinstance(a, torch.Tensor) else a
                    for a in args]
            key = self.key(args)
            entry = self.graphs.get(key)
            if entry is not None:
                self.refresh_lr()
                out = entry.run(self.params, args)
            elif key not in self.warmed:
                self.warmed.add(key)
                out = _tree_map(torch.Tensor.detach,
                                warm_up(dev, self.fn, *args))
            else:
                entry = self.graphs[key] = self._capture(dev, args)
                self.refresh_lr()
                out = entry.run(self.params)
        if not self.retain_grads:
            for p in self.params:
                p.grad = None
        return out

    def refresh_lr(self):
        """Each optimizer's device learning rates, from its current
        schedule, before a replay (outside the graph)."""
        for o in self.optimizers:
            refresh = getattr(o, "_refresh_lr", None)
            if refresh is not None:
                refresh()

    def _capture(self, dev, args):
        inputs = [a.detach().clone() if isinstance(a, torch.Tensor)
                  else None for a in args]
        call = [b if b is not None else a for b, a in zip(inputs, args)]
        grads_in = [p.grad for p in self.params]
        ptrs = [p.data_ptr() for p in self.params]
        bptrs = self.buffer_ptrs()
        states = [dict(getattr(o, "_state", {})) for o in self.optimizers]
        try:
            graph, out, delta = capture(dev, self.fn, call)
            grads_out = [p.grad for p in self.params]
            self._check_in_place(ptrs, states, grads_out)
            self._check_buffers(bptrs)
        except BaseException:
            for p, g in zip(self.params, grads_in):
                p.grad = g
            for o, st in zip(self.optimizers, states):
                if hasattr(o, "_state"):
                    o._state.clear()
                    o._state.update(st)
            raise
        for p, g in zip(self.params, grads_in):
            p.grad = g
        for o in self.optimizers:
            pin = getattr(o, "_pin_lr", None)
            if pin is not None:
                pin()
        read = [gi if gi is not None and gi is go else None
                for gi, go in zip(grads_in, grads_out)]
        return _Graph(graph, inputs, _tree_map(torch.Tensor.detach, out),
                      delta, read, grads_out)

    def buffer_ptrs(self):
        """The addresses of the layers' buffers (BatchNorm's running
        statistics), as the layers hold them now."""
        out, seen = [], set()
        for layer in self.layers:
            for b in layer.buffers():
                if id(b) not in seen:
                    seen.add(id(b))
                    out.append(b.data_ptr())
        return out

    def _check_buffers(self, bptrs):
        """Raise unless every buffer of the layers is still where it
        was: a graph writes buffers in place."""
        if self.buffer_ptrs() != bptrs:
            raise RuntimeError(
                "the captured step rebound a buffer of its layers (a "
                "running statistic?); a graph replays only in-place "
                "updates")

    def _check_in_place(self, ptrs, states, grads_out):
        moved = [i for i, (p, ptr) in enumerate(zip(self.params, ptrs))
                 if p.data_ptr() != ptr]
        if moved:
            raise RuntimeError(
                f"the captured step rebound {len(moved)} parameter(s); a "
                "graph replays only in-place updates")
        for o, st in zip(self.optimizers, states):
            now = getattr(o, "_state", {})
            if set(now) != set(st) or any(now[k] is not v
                                          for k, v in st.items()):
                raise RuntimeError(
                    f"the captured step created or rebound state of "
                    f"{type(o).__name__}; a graph replays only in-place "
                    "updates of state created before the capture")
        if any(g is not None and g.grad_fn is not None for g in grads_out):
            raise RuntimeError(
                "the captured step left gradients with a grad_fn "
                "(backward(create_graph=True)): its out-of-place "
                "accumulation would read gradients the replays do not "
                "keep; to_static captures first-order steps only")


_shared = weakref.WeakValueDictionary()


def _step_for(fn, layers, optimizers, retain_grads) -> _Step:
    key = (id(fn), tuple(id(m) for m in layers),
           tuple(id(o) for o in optimizers), bool(retain_grads))
    step = _shared.get(key)
    if step is None or step.fn is not fn:
        step = _shared[key] = _Step(fn, layers, optimizers,
                                    bool(retain_grads))
    return step


# -------------------------------------------------------- serving steps

def _check_held(held, returned, what):
    """Raise unless ``returned`` holds ``held``'s tensors themselves, in
    place: a graph writes the pools where they are, and a step that
    rebinds one would leave its graph writing memory nobody reads."""
    if len(returned) != len(held) or any(
            len(r) != len(h) or any(a is not b for a, b in zip(r, h))
            for r, h in zip(returned, held)):
        raise RuntimeError(f"{what} returned state other than the tensors "
                           "it was given; a serving step updates its pools "
                           "in place")


class _HeldGraph:
    """One captured serving step: the graph, the static buffers of its
    small inputs, its other outputs and the launch counts a replay
    adds."""

    def __init__(self, graph, inputs, outputs, delta):
        self.graph, self.inputs = graph, inputs
        self.outputs, self.delta = outputs, delta

    def run(self, small):
        for buf, a in zip(self.inputs, small):
            buf.copy_(a, non_blocking=True)
        replay(self.graph, self.delta)
        return _tree_map(torch.clone, self.outputs)


class HeldStep:
    """A serving step: its eager body, and on CUDA its captured graphs.

    ``body(*small, held)`` computes from the small inputs (tokens,
    positions, block tables, ... as tensors or numpy arrays) and ``held``,
    a list of tuples of tensors it updates in place (the KV pools), and
    returns ``(outputs, held)``, the second being the very tensors it was
    given. It reads ``params`` (the model's parameters) where they lie.

    On CUDA a graph is specialised to its key: the small inputs' shapes
    and dtypes and the addresses of the held tensors and parameters. A
    call with a new key runs the body eagerly on the capture stream (the
    warm-up; its result is the call's) and then records it, into the
    memory pool ``pool`` that the model's other step graphs share. A
    later call with that key copies the small inputs into the graph's
    static buffers and replays it on the caller's stream, after whatever
    the caller queued there (copy-on-write block copies, the tables'
    copies). Nothing else is copied: not the pools (hundreds of MB) and
    not the parameters, so a new value written into a parameter in place
    (``ServingEngine.swap_weights``) is what the next replay reads, and a
    rebound pool or parameter has a new address, hence a new key and a
    new capture, never a stale read. The outputs come back as clones, as
    the next replay overwrites the graph's. A failed capture raises with
    the launch counts restored; nothing falls back to the eager path.

    On the CPU, and inside :func:`no_capture`, the body runs eagerly.
    ``traces["count"]`` counts the graphs captured, or on the CPU the
    input signatures seen (shapes and dtypes): one per specialisation
    either way. The keys of graphs whose pools were freed stay in
    ``graphs`` (a pool allocated later at the same address, with the
    same shape, replays them correctly). ``last`` is the graph the last
    call captured or replayed (None after an eager call)."""

    def __init__(self, body, params, traces, pool, what):
        self.body, self.params = body, list(params)
        self.traces, self.pool, self.what = traces, pool, what
        self.graphs = {}          # key -> _HeldGraph
        self.signatures = set()   # CPU: input signatures seen
        self.last = None

    def __call__(self, small, held):
        small = [_as_tensor(a) for a in small]
        dev = held[0][0].device
        if dev.type == "cuda" and capture_enabled():
            key = (tuple(_signature(a) for a in small),
                   tuple(a.data_ptr() for layer in held for a in layer),
                   tuple(map(torch.Tensor.data_ptr, self.params)))
            g = self.graphs.get(key)
            if g is not None:
                self.last = g
                return g.run(small)
            return self._capture(dev, key, small, held)
        self.last = None
        small = [a.to(dev) for a in small]
        if dev.type == "cpu":
            sig = (tuple(_signature(a) for a in small),
                   tuple(_signature(a) for layer in held for a in layer))
            if sig not in self.signatures:
                self.signatures.add(sig)
                self.traces["count"] += 1
        out, back = self.body(*small, held)
        _check_held(held, back, self.what)
        return out

    def _capture(self, dev, key, small, held):
        inputs = [a.to(dev, copy=True) for a in small]
        out, back = warm_up(dev, self.body, *inputs, held)
        _check_held(held, back, self.what)
        ptrs = tuple(map(torch.Tensor.data_ptr, self.params))
        graph, (outputs, back), delta = capture(
            dev, self.body, [*inputs, held], self.pool)
        _check_held(held, back, f"{self.what} under capture")
        if tuple(map(torch.Tensor.data_ptr, self.params)) != ptrs:
            raise RuntimeError(f"{self.what} rebound a parameter under "
                               "capture; a graph reads parameters in place")
        self.graphs[key] = self.last = _HeldGraph(graph, inputs, outputs,
                                                  delta)
        self.traces["count"] += 1
        return out


# ------------------------------------------------------------- public API

def to_static(function: Optional[Callable] = None, *, layers=None,
              optimizers=None, donate_state: bool = True, mesh=None,
              param_rules=None, arg_specs=None, ast_convert: bool = False,
              retain_grads: bool = True):
    """One step of ``function`` per call, captured as a CUDA graph on the
    card (see the module's docstring).

    - forward-only: ``fast = to_static(model)`` with ``model`` an
      ``nn.Module``;
    - train step: ``@to_static(layers=[model], optimizers=[opt])`` around
      a function that runs the forward, ``backward()`` and
      ``opt.step()``.

    Arguments are tensors or numpy arrays (moved to the step's device) or
    hashable constants (part of the key, baked into the graph).
    ``donate_state`` is accepted and has nothing to do: the state is
    updated in place. ``mesh``, ``param_rules``, ``arg_specs`` and
    ``ast_convert`` raise NotImplementedError."""
    _refuse(mesh, param_rules, arg_specs)
    if ast_convert:
        raise NotImplementedError("ast_convert needs the dygraph-to-static "
                                  "converter, which is not ported yet")
    if isinstance(function, torch.nn.Module) and layers is None:
        layer = function
        return to_static(lambda *a: layer(*a), layers=[layer],
                         optimizers=optimizers, retain_grads=retain_grads)

    def deco(fn):
        step = _step_for(fn, layers or [], optimizers or [], retain_grads)

        def wrapper(*args):
            return step(*args)

        wrapper.__wrapped__ = fn
        wrapper._step = step
        return wrapper

    return deco(function) if function is not None else deco


def to_static_multi_step(fn, *, layers, optimizers=None,
                         donate_state: bool = True, mesh=None,
                         param_rules=None, arg_specs=None,
                         retain_grads: bool = True):
    """K chained steps of ``fn`` per call, the counterpart of the
    reference's ``lax.scan`` over K steps. Each tensor argument carries a
    leading step dimension ``[K, ...]`` and goes to the device once;
    slice k is copied into the single-step graph's inputs (the graph
    :func:`to_static` of the same ``fn``, layers, optimizers and
    ``retain_grads`` uses) and replayed, K times, with no host
    synchronisation between steps. The outputs come back stacked
    ``[K, ...]``. As in the reference, one ordinary :func:`to_static`
    step must come first, so that the optimizers' accumulators exist."""
    _refuse(mesh, param_rules, arg_specs)
    step = _step_for(fn, layers or [], optimizers or [], retain_grads)

    def wrapper(*args):
        args = [_as_tensor(a) for a in args]
        ks = {a.shape[0] for a in args if isinstance(a, torch.Tensor)}
        if len(ks) != 1:
            raise ValueError(f"to_static_multi_step takes tensor arguments "
                             f"with one leading step dimension, got "
                             f"{sorted(ks)}")
        for o in step.optimizers:
            if getattr(o, "_steps", 1) == 0:
                raise RuntimeError(
                    "to_static_multi_step needs the optimizers' "
                    "accumulators: run one to_static step first")
        dev = step.device(args)
        if dev is not None:
            args = [a.to(dev) if isinstance(a, torch.Tensor) else a
                    for a in args]
        (k,) = ks
        return _stack([step(*[a[i] if isinstance(a, torch.Tensor) else a
                              for a in args]) for i in range(k)])

    wrapper.__wrapped__ = fn
    wrapper._step = step
    return wrapper
