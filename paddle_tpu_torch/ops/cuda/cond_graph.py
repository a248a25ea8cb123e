"""Conditional (IF) nodes in a CUDA graph under capture, through the CUDA
runtime (``csrc/cond_graph.cu``): the counterpart of the branch selection
``lax.cond`` / ``lax.switch`` compile into one XLA program
(``paddle_tpu/ops/control_flow_ops.py:50-184``).

``with if_body(pred):`` inside a capture puts the work of the block into
the body of an IF node of the graph being captured: at a replay it runs
only where the device predicate ``pred`` (a one-element tensor, nonzero =
taken; ``negate`` inverts it) holds. The body is captured from a stream
of its own (one per nesting depth), which is the current stream inside
the block, so every kernel wrapper launches onto it (each reads
``torch.cuda.current_stream()`` at its call). Its memory comes from a
private pool per nesting depth, which the caching allocator serves to
that stream only while the body captures.

Launch counts: a wrapper's launch inside a body goes into the body's
recording (:class:`Body` ``.delta``), and the body adds one to its device
counter (``ctr``) each time a replay runs it, so the executor can add
``delta`` times the counter after a replay (:func:`settle`).
:meth:`Body.count_kernels` reads the body graph's own kernel nodes
(nested bodies count apart) once the capture has ended.
``launches`` counts ``cond_set_kernel``, which sets an IF node's
condition from its predicate: one per IF node each replay reaches.
"""

from __future__ import annotations

import contextlib
import ctypes
import sys

import torch

from . import _build, _launches

#: the bodies captured since :func:`collecting` opened, outermost first
_collected = None
_streams = {}        # (device index, depth) -> the body stream
_pools = {}          # (device index, depth) -> the body memory pool id
_depth = 0
#: runs of ``cond_set_kernel`` (one per IF node a replay reaches)
launches = 0


class Body:
    """One captured IF body: its launch counter on the card, the launches
    one run of it adds, and its kernel nodes."""

    def __init__(self, ctr, depth):
        self.ctr, self.depth = ctr, depth
        self.delta = {}
        self.graph = None
        self.kernels = None

    def count_kernels(self):
        """Read the body graph's kernel nodes through libcuda (after the
        capture ended: no graph is read while a stream captures)."""
        from ...jit import graph_node_kernels
        self.kernels = graph_node_kernels(self.graph)
        return self.kernels


def _lib():
    lib = _build.load("cond_graph")
    if not getattr(lib, "_typed", False):
        vp = ctypes.c_void_p
        lib.cond_if_begin.argtypes = [vp, vp, ctypes.c_int, vp,
                                      ctypes.POINTER(vp)]
        lib.cond_if_end.argtypes = [vp, vp]
        lib.cond_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _check(rc, what):
    if rc != 0:
        msg = _lib().cond_error_string(rc).decode()
        raise RuntimeError(f"{what} failed: {msg} ({rc})")


def _allocator_hooks():
    """torch's private switches that send a stream's allocations to a
    graph pool (their names moved between releases)."""
    c = torch._C
    begin = getattr(c, "_cuda_beginAllocateCurrentStreamToPool", None)
    end = (getattr(c, "_cuda_endAllocateToPool", None)
           or getattr(c, "_cuda_endAllocateCurrentStreamToPool", None))
    if begin is None or end is None:
        raise RuntimeError(
            "this torch has no _cuda_beginAllocateCurrentStreamToPool / "
            "_cuda_endAllocateToPool: an IF body cannot allocate from a "
            "graph pool")
    return begin, end


@contextlib.contextmanager
def collecting():
    """The :class:`Body` of every IF node captured inside, in a list."""
    global _collected
    prev, _collected = _collected, []
    try:
        yield _collected
    finally:
        _collected = prev


@contextlib.contextmanager
def if_body(pred: torch.Tensor, negate: bool = False):
    """Capture the block's work into an IF node on ``pred`` of the graph
    the current stream captures. Yields the :class:`Body`."""
    global _depth
    if not torch.cuda.is_current_stream_capturing():
        raise RuntimeError("if_body needs a stream that captures a graph")
    dev = pred.device
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    pred = pred.reshape(-1)[:1]
    if pred.dtype != torch.bool:
        pred = pred != 0
    pred = pred.contiguous()
    ctr = torch.zeros(1, dtype=torch.int64, device=dev)
    body = Body(ctr, _depth)
    outer = torch.cuda.current_stream(dev)
    key = (idx, _depth)
    if key not in _streams:
        _streams[key] = torch.cuda.Stream(dev)
        _pools[key] = torch.cuda.graph_pool_handle()
    stream, pool = _streams[key], _pools[key]
    begin, end = _allocator_hooks()
    graph = ctypes.c_void_p()
    with torch.cuda.device(dev):
        _check(_lib().cond_if_begin(outer.cuda_stream, pred.data_ptr(),
                                    int(negate), stream.cuda_stream,
                                    ctypes.byref(graph)), "cond_if_begin")
    _launches.count(sys.modules[__name__])
    _launches.push_body(body.delta)
    _depth += 1
    ok = False
    try:
        with torch.cuda.stream(stream):
            begin(idx, pool)
            try:
                ctr.add_(1)
                yield body
            finally:
                end(idx, pool)
        ok = True
    finally:
        _depth -= 1
        _launches.pop_body()
        rc = _lib().cond_if_end(stream.cuda_stream, graph)
        if ok:
            _check(rc, "cond_if_end")
    body.graph = graph
    if _collected is not None:
        _collected.append(body)


def settle(bodies):
    """After a replay: add each body's launches times the runs its device
    counter saw (one small copy to the host, which waits for the
    replay)."""
    counted = [b for b in bodies if b.delta]
    if not counted:
        return
    runs = torch.cat([b.ctr for b in counted]).tolist()
    total = {}
    for b, n in zip(counted, runs):
        for k, v in b.delta.items():
            total[k] = total.get(k, 0) + v * n
    from ... import jit
    jit._add_launch_counts(total)


def plain_select(pred: torch.Tensor) -> bool:
    """The host's reading of a predicate, for runs that capture nothing
    (on the CPU, or a key's eager first run on the card)."""
    return bool(pred.reshape(-1)[0])

