"""Dygraph tracer and autograd — the counterpart of
``paddle_tpu/dygraph/tape.py``.

Every eager op dispatches through :func:`run_op`: the tracer casts the
inputs as AMP asks (:func:`~paddle_tpu_torch.amp.auto_cast.maybe_autocast_inputs`),
runs the port's registry lowering (:func:`~paddle_tpu_torch.ops.registry.execute`)
on the inputs' torch tensors and wraps the outputs.

**The tape records onto torch autograd.** Where the reference builds a
graph of ``GradNode``s and walks it in reverse with the static plane's
``make_grad_ops``, the port lets torch record:

- a leaf with ``stop_gradient=False`` holds a torch leaf that requires
  grad, and ``Tensor.grad`` wraps its ``.grad``;
- when the tracer is enabled and an input needs a gradient, the
  lowering runs under ``torch.enable_grad()`` and each differentiable
  output keeps its autograd history; otherwise it runs under
  ``torch.no_grad()``;
- ``backward`` is ``torch.autograd.backward`` and :func:`grad` is
  ``torch.autograd.grad(allow_unused=True)``, followed by the
  reference's own errors and ``None``s.

The gradients are those of the static plane: its generic grad
(``ops/registry.py``) derives each ``<op>_grad`` the same way, by running
the forward lowering under autograd. A forward through the flash
attention and LayerNorm ``autograd.Function``s keeps its residuals
(o, lse; mean, rstd), so a tape step launches each forward kernel once,
where the static plane's generic grad launches it twice. An op with a
registered grad lowering (``while``, ``cond``, ``switch_case``) holds
sub-blocks, which only a Program carries: the reference's tape cannot
run them eagerly either.

The reference's rules hold on top of torch:

- outputs in an op's ``nondiff_outputs`` are detached, and a
  ``not_differentiable`` op runs under ``no_grad``;
- inputs in ``no_grad_slots`` are detached;
- ``stop_gradient=True`` on a non-leaf makes later ops read a detached
  value;
- ``backward(retain_graph=False)`` drops the loss's link to the graph, so
  a second call does nothing (torch would raise on the freed graph);
- ``grad(create_graph=True)`` raises ``NotImplementedError``;
- an integer leaf whose gradient is wanted gets zeros when the backward
  reaches an op it feeds: float32 by the generic grad's rule, the input's
  dtype from ``cast_grad``; torch cannot mark an integer tensor, so the
  op's outputs pass through a probe (``_IntProbe``) that sets them.

Divergences (ROADMAP C): gradients that several consumers send to one
tensor are summed in torch's order, not the reference's reverse node
order, so the two agree to rounding; and ``paddle_tpu_torch.nn.Layer``
is ``torch.nn.Module``, not :class:`~.layers.Layer`, where the
reference's two are one class.

Eager random ops draw from ``LoweringContext(eager=True).rng()``: the
process-global counter that :func:`~.layers.seed` sets, as the
reference's do, so dropout masks follow its threefry stream.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

import torch

from ..ops import registry as _reg
from .tensor import Parameter, Tensor

# Program-recording hook (ProgramDescTracer analog): while active, every
# traced op is also appended to the target Program block
_recording = None


class record_program:
    """``with record_program(prog): out = layer(x)`` — ops append to
    ``prog`` as they execute."""

    def __init__(self, program):
        self.program = program

    def __enter__(self):
        global _recording
        self._prev = _recording
        _recording = self.program
        return self

    def __exit__(self, *a):
        global _recording
        _recording = self._prev
        return False


def _record_op(op_type, ins, out_tensors, attrs):
    block = _recording.global_block()
    for ts in ins.values():
        for t in ts:
            if t.name not in block.vars:
                if isinstance(t, Parameter):
                    block.create_parameter(t.name, shape=t.shape,
                                           dtype=t.dtype)
                else:
                    block.create_var(t.name, shape=t.shape, dtype=t.dtype,
                                     stop_gradient=t.stop_gradient)
    for ts in out_tensors.values():
        for t in ts:
            if t.name not in block.vars:
                block.create_var(t.name, shape=t.shape, dtype=t.dtype)
    rec_attrs = {k: v for k, v in attrs.items()
                 if isinstance(v, (int, float, bool, str, list, tuple,
                                   dict, type(None)))}
    block.append_op(op_type,
                    {s: [t.name for t in ts] for s, ts in ins.items()},
                    {s: [t.name for t in ts]
                     for s, ts in out_tensors.items()},
                    rec_attrs)


# Parameter-discovery hook for fleet.utils.recompute's probe: while set
# on THIS thread, every traced op reports its input tensors
_probe_tls = threading.local()
# set while grad() runs: the probes give no integer leaf a .grad
_partial_tls = threading.local()


def _inexact(v: torch.Tensor) -> bool:
    return v.is_floating_point() or v.is_complex()


def _int_zeros(t, dtype):
    return torch.zeros(tuple(t.value.shape), dtype=dtype,
                       device=t.value.device)


class _IntProbe(torch.autograd.Function):
    """Passes an op's output through and marks, when a gradient reaches
    it, that the backward reached an op that integer leaves feed: each
    gets zeros of the grad op's dtype as its ``.grad``. The zero-size
    ``probe`` is what grad() asks autograd for, to learn the same."""

    @staticmethod
    def forward(fctx, leaves, dtype, a, probe):
        fctx.leaves, fctx.dtype = leaves, dtype
        return a.view_as(a)

    @staticmethod
    def backward(fctx, g):
        if not getattr(_partial_tls, "active", False):
            for t in fctx.leaves:
                if t.grad is None:
                    t.grad = _int_zeros(t, fctx.dtype)
        return None, None, g, torch.zeros((), device=g.device)


def _names(tree, tag):
    return {s: [f"{tag}{s}:{i}" for i in range(len(v))]
            for s, v in tree.items()}


class _RegisteredGrad(torch.autograd.Function):
    """An op whose gradient the registry defines itself (a custom grad
    maker, as the quantization ops' straight-through estimators, or a
    registered ``<op>_grad``, as ``lookup_table_v2``'s that skips the
    padding row): the forward runs the lowering and the backward runs
    the grad ops that ``make_grad_ops`` gives, as the reference's tape
    does, keeping only the values those grad ops read."""

    @staticmethod
    def forward(fctx, op, ctx, attrs, layout, nondiff, *flat):
        ins, k = {}, 0
        for slot, n in layout:
            ins[slot] = list(flat[k:k + n])
            k += n
        outs = {s: [v if isinstance(v, torch.Tensor) else torch.as_tensor(v)
                    for v in vals]
                for s, vals in _reg.execute(ctx, op.type, ins,
                                            attrs).items()}
        out_layout = [(s, len(vals)) for s, vals in outs.items()]
        flat_outs = [v for vals in outs.values() for v in vals]
        op.outputs = _names(outs, "o:")
        values = {n: v for tree, names in ((ins, op.inputs),
                                           (outs, op.outputs))
                  for s, vals in tree.items()
                  for n, v in zip(names[s], vals)}
        # the values the grad ops read when every gradient flows
        descs = _reg.make_grad_ops(op, *_grad_names(op, outs, ins,
                                                    nondiff, forward=True))
        read = sorted({n for _, g_in, _, _ in descs for ns in g_in.values()
                       for n in ns if n in values})
        fctx.op, fctx.ctx, fctx.nondiff = op, ctx, nondiff
        fctx.layout, fctx.out_layout, fctx.read = layout, out_layout, read
        fctx.save_for_backward(*(values[n] for n in read))
        fctx.mark_non_differentiable(*(
            v for (s, n), vals in zip(out_layout, _chunks(flat_outs,
                                                          out_layout))
            for v in vals if s in nondiff or not _inexact(v)))
        fctx.set_materialize_grads(False)
        return tuple(flat_outs)

    @staticmethod
    def backward(fctx, *gouts):
        op = fctx.op
        env = dict(zip(fctx.read, fctx.saved_tensors))
        outs = dict(zip((s for s, _ in fctx.out_layout),
                        _chunks(gouts, fctx.out_layout)))
        wanted_mask, k = {}, 0
        for slot, n in fctx.layout:
            wanted_mask[slot] = [fctx.needs_input_grad[5 + k + i]
                                 for i in range(n)]
            k += n
        out_g, wanted = _grad_names(op, outs, wanted_mask, fctx.nondiff,
                                    forward=False)
        for (slot, n), gs in zip(fctx.out_layout,
                                 _chunks(gouts, fctx.out_layout)):
            for name, g in zip(op.outputs[slot], gs):
                if g is not None:
                    env[name + "@G"] = g
        for g_type, g_in, g_out, g_attrs in _reg.make_grad_ops(op, out_g,
                                                               wanted):
            res = _reg.execute(fctx.ctx, g_type,
                               {s: [env[n] for n in ns]
                                for s, ns in g_in.items()}, g_attrs)
            for s, ns in g_out.items():
                for n, v in zip(ns, res.get(s, [])):
                    env[n] = v
        grads = [env.get(n + "@IG") for slot, _ in fctx.layout
                 for n in op.inputs[slot]]
        return (None,) * 5 + tuple(grads)


def _chunks(flat, layout):
    out, k = [], 0
    for _, n in layout:
        out.append(list(flat[k:k + n]))
        k += n
    return out


def _grad_names(op, outs, ins_or_mask, nondiff, *, forward):
    """``make_grad_ops``' out-grad and wanted-input names for ``op``. At
    the ``forward`` (``outs`` and ``ins_or_mask`` the values): every
    float output outside ``nondiff`` and every float input. In the
    backward (``outs`` the incoming gradients, ``ins_or_mask`` whether
    autograd wants each input's): the outputs with a gradient, the
    wanted inputs."""
    out_g = {}
    for slot, vals in outs.items():
        names = op.outputs[slot]
        if forward:
            out_g[slot] = [n + "@G" if slot not in nondiff and _inexact(v)
                           else None for n, v in zip(names, vals)]
        else:
            out_g[slot] = [n + "@G" if g is not None and slot not in nondiff
                           else None for n, g in zip(names, vals)]
    wanted = {}
    for slot, vals in ins_or_mask.items():
        names = op.inputs[slot]
        if forward:
            wanted[slot] = [n + "@IG" if _inexact(v) else None
                            for n, v in zip(names, vals)]
        else:
            wanted[slot] = [n + "@IG" if m else None
                            for n, m in zip(names, vals)]
    return out_g, wanted


class _OpStub:
    """Shaped like ``framework.Operator`` for ``make_grad_ops``."""

    __slots__ = ("type", "inputs", "outputs", "attrs")

    def __init__(self, type, inputs, attrs):  # noqa: A002
        self.type = type
        self.inputs = inputs
        self.outputs = {}
        self.attrs = attrs


def _own_grad(d) -> bool:
    """Whether the registry defines op ``d``'s gradient itself."""
    return d is not None and (d.custom_grad_maker is not None
                              or f"{d.type}_grad" in _reg.OPS)


class Tracer:
    """Runs eager ops. ``enabled`` is False under :class:`no_grad`;
    ``_amp_level`` / ``_amp_dtype`` read the AMP state in force on this
    thread (``amp.auto_cast``)."""

    def __init__(self):
        self.enabled = True

    @property
    def _amp_level(self) -> str:
        from ..amp.auto_cast import amp_state
        return amp_state()[0]

    @property
    def _amp_dtype(self) -> str:
        from ..amp.auto_cast import amp_state
        return str(amp_state()[1]).replace("torch.", "")

    # -- op execution ------------------------------------------------------
    def trace_op(self, op_type: str, ins: Dict[str, List[Tensor]],
                 attrs: Dict, *, autocast: bool = True
                 ) -> Dict[str, List[Tensor]]:
        hook = getattr(_probe_tls, "hook", None)
        if hook is not None:
            hook(ins)
        d = _reg.declared(op_type)
        if autocast:
            level = self._amp_level
            if level in ("O1", "O2"):
                from ..amp.auto_cast import maybe_autocast_inputs
                ins = maybe_autocast_inputs(op_type, ins, self._amp_dtype,
                                            level)
        devices = {t.value.device for ts in ins.values() for t in ts}
        if len(devices) > 1:
            raise ValueError(
                f"op {op_type!r}: inputs on {sorted(map(str, devices))}; "
                "a tape op runs on one device (move the tensors first)")
        needs_grad = self.enabled and any(
            not t.stop_gradient for ts in ins.values() for t in ts)
        record = needs_grad and not (d is not None and d.not_differentiable)
        no_grad_slots = set(d.no_grad_slots) if d is not None else set()
        arr_ins, in_ids = {}, set()
        int_leaves = []
        for s, ts in ins.items():
            row = []
            for t in ts:
                v = t.value
                in_ids.add(id(v))
                if record and s in no_grad_slots:
                    v = v.detach()
                elif record and t.is_leaf and not t.stop_gradient and \
                        not _inexact(v):
                    int_leaves.append(t)
                row.append(v)
            arr_ins[s] = row
        ctx = _reg.LoweringContext(
            eager=True, device=next(iter(devices)) if devices else None)
        with torch.enable_grad() if record else torch.no_grad():
            if record and _own_grad(d):
                arr_outs = self._run_registered_grad(d, ctx, arr_ins, attrs)
            else:
                arr_outs = _reg.execute(ctx, op_type, arr_ins, attrs)
            nondiff = set(d.nondiff_outputs) if d is not None else set()
            out_tensors = {}
            for slot, vals in arr_outs.items():
                row = []
                diff = record and slot not in nondiff
                for a in vals:
                    if not isinstance(a, torch.Tensor):
                        a = torch.as_tensor(a)
                    if not diff:
                        a = a.detach()
                    elif id(a) in in_ids:
                        # an output that is an input: a node of its own,
                        # so the output's backward and fields are its own
                        a = a.view_as(a)
                    if diff and int_leaves and _inexact(a):
                        # the generic grad's float32 zeros, or the
                        # registered grad op's (cast_grad: zeros in the
                        # input's dtype)
                        zdt = (int_leaves[0].value.dtype if _own_grad(d)
                               else torch.float32)
                        probe = torch.zeros((), device=a.device,
                                            requires_grad=True)
                        a = _IntProbe.apply(list(int_leaves), zdt, a, probe)
                        for leaf in int_leaves:
                            leaf.__dict__.setdefault(
                                "_int_probes", []).append((probe, zdt))
                    t = Tensor._wrap(a)
                    if diff:
                        t._stop_gradient = False
                        t.is_leaf = False
                        if a.requires_grad:
                            t._root = a
                    row.append(t)
                out_tensors[slot] = row
        if _recording is not None:
            _record_op(op_type, ins, out_tensors, attrs)
        return out_tensors

    @staticmethod
    def _run_registered_grad(d, ctx, ins, attrs):
        layout = [(s, len(v)) for s, v in ins.items()]
        op = _OpStub(d.type, _names(ins, "i:"), dict(attrs))
        flat = [v for vals in ins.values() for v in vals]
        res = _RegisteredGrad.apply(op, ctx, dict(attrs), layout,
                                    frozenset(d.nondiff_outputs), *flat)
        outs, k = {}, 0
        for slot, names in op.outputs.items():
            outs[slot] = list(res[k:k + len(names)])
            k += len(names)
        return outs

    # -- autograd ----------------------------------------------------------
    def backward(self, loss: Tensor, grad_tensor: Optional[Tensor] = None,
                 retain_graph: bool = False):
        root = loss._root
        if root is None:
            return
        seed = (grad_tensor.value if grad_tensor is not None
                else torch.ones_like(root))
        torch.autograd.backward([root], [seed.to(root.dtype)],
                                retain_graph=retain_graph)
        if not retain_graph:
            loss._root = None


_tracer = Tracer()


def default_tracer() -> Tracer:
    return _tracer


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph=False, allow_unused=False):
    """paddle.grad parity — grads of ``outputs`` w.r.t. ``inputs``
    WITHOUT touching ``.grad``. Returns a list aligned with ``inputs``
    (None where unused, if allow_unused).

    ``retain_graph=None`` follows ``create_graph`` (the reference's
    default): eager loops calling grad() each step free the graph
    instead of keeping it."""
    if retain_graph is None:
        retain_graph = create_graph
    if create_graph:
        raise NotImplementedError(
            "create_graph=True (higher-order grad) is not supported; "
            "compose jax.grad via jit.to_static for nested derivatives")
    outs = outputs if isinstance(outputs, (list, tuple)) else [outputs]
    ins = inputs if isinstance(inputs, (list, tuple)) else [inputs]
    gouts = (grad_outputs if isinstance(grad_outputs, (list, tuple))
             else [grad_outputs] * len(outs))
    roots, seeds = [], []
    for o, g in zip(outs, gouts):
        if o._root is None:
            continue
        roots.append(o._root)
        seeds.append((g.value if g is not None
                      else torch.ones_like(o._root)).to(o._root.dtype))
    if not roots:
        raise ValueError("none of the outputs is connected to the graph")
    # the tensors autograd can differentiate for: a recorded output's
    # graph value, or a leaf that requires grad; an integer leaf is
    # reached when a gradient reaches an output of an op it feeds
    targets, consumers = [], []
    for i, t in enumerate(ins):
        v = t._root if t._root is not None else t.value
        if not t.stop_gradient and v.requires_grad:
            targets.append((i, v))
        elif t.is_leaf and not t.stop_gradient and not _inexact(t.value):
            consumers += [(i, c, zdt)
                          for c, zdt in getattr(t, "_int_probes", ())]
    wrt = [v for _, v in targets] + [c for _, c, _ in consumers]
    _partial_tls.active = True
    try:
        got = torch.autograd.grad(roots, wrt, seeds,
                                  retain_graph=retain_graph,
                                  allow_unused=True) if wrt else []
    finally:
        _partial_tls.active = False
    by_index = {}
    for (i, _), g in zip(targets, got):
        by_index[i] = g
    for (i, _, zdt), g in zip(consumers, got[len(targets):]):
        if g is not None and i not in by_index:
            by_index[i] = _int_zeros(ins[i], zdt)
    result = []
    for i, t in enumerate(ins):
        g = by_index.get(i)
        if g is None:
            if not allow_unused:
                raise ValueError(
                    f"input {t.name!r} received no gradient (set "
                    "allow_unused=True to get None)")
            result.append(None)
        else:
            result.append(Tensor._wrap(g.detach()))
    return result


def run_op(op_type: str, ins: Dict[str, List[Tensor]], attrs: Dict
           ) -> Dict[str, List[Tensor]]:
    return _tracer.trace_op(op_type, ins, attrs)


class no_grad:
    """Context manager/decorator disabling grad recording."""

    def __enter__(self):
        self._prev = _tracer.enabled
        _tracer.enabled = False
        return self

    def __exit__(self, *a):
        _tracer.enabled = self._prev
        return False

    def __call__(self, fn):
        def wrapper(*a, **kw):
            with no_grad():
                return fn(*a, **kw)
        return wrapper
