"""Control-flow op lowerings — the counterpart of
``paddle_tpu/ops/control_flow_ops.py`` (``:50-184``): ``while``, ``cond``
and ``switch_case`` over the Program's nested blocks, run through the
executor's block runner (``ctx.block_runner``).

The reference traces a sub-block into ``lax.while_loop`` / ``lax.scan``
/ ``lax.cond`` / ``lax.switch`` inside its one XLA program. The port runs
a sub-block's ops op by op, in one of two ways:

- nothing captures (the CPU, or a key's eager first run on the card):
  the host reads the predicate and runs the taken branch, or the loop's
  iterations, only;
- the executor captures the block (a key's second run on the card):
  each branch is the body of an IF node of the one CUDA graph
  (:mod:`.cuda.cond_graph`), so a replay runs only the taken branch;
  ``switch_case`` is a chain of IF nodes on ``index == i``, the default
  last; a bounded ``while`` (``differentiable=True``, ``max_iters=N``)
  is N IF nodes on the live flag, the reference's masked scan over
  ``lax.cond``. A ``while`` without ``max_iters`` is a loop of the host,
  which no graph holds: the executor splits the key around it
  (:func:`splits_key`) and replays the body's own graph while a host
  read of the condition says so (``host_loop``).

Gradients (registered grad lowerings, :func:`~.registry.register_grad`,
not the generic one, which would run autograd across IF nodes):
``cond_grad`` and ``switch_case_grad`` are IF nodes per
branch, each re-running its branch's forward under autograd and taking
its VJP, as ``jax.vjp`` of ``lax.cond`` differentiates the taken branch
only. ``while_grad`` (bounded loops only, as in the reference) re-runs
the forward keeping each iteration's input carry and live flag (the
reference's scan residuals), then runs the N iterations in reverse, each
an IF node on its live flag taking that iteration's VJP; a dead
iteration runs nothing, so it leaks no NaN into the gradient.

Contracts kept from the reference: a loop carry keeps its shape and
dtype; branches agree in signature (checked where both are captured);
an out-of-range ``switch_case`` index runs the default; a
differentiable loop needs ``max_iters > 0``. PRNG plumbing: ``while``
splits its key once per iteration, ``cond`` splits it into the two
branches' keys, ``switch_case`` folds the branch index in. The name
plumbing rides in attrs (``carry_names``, ``cond_name``,
``param_names``, ``out_names``, ``sub_block(s)``). The static infer
rules (the reference's ``:180-257``) recurse into the sub-blocks through
the abstract interpreter and check the two contracts statically: a loop
carry's shape and dtype across one iteration (``while``) and the
branches' signatures (``cond``, ``switch_case``).
"""

from __future__ import annotations

from typing import Dict, List

import torch

from .. import prng
from .cuda import cond_graph
from .registry import (GRAD_SLOT_SUFFIX, register, register_grad,
                       register_infer)

#: host reads of a predicate on the card (each waits for the card)
host_reads = 0


def note_host_read():
    """One more host read on the card (a copy to the host that waits for
    the card)."""
    global host_reads
    host_reads += 1


def read_pred(pred: torch.Tensor) -> bool:
    """The host's reading of a predicate or a loop's condition, counted
    on the card."""
    if pred.is_cuda:
        note_host_read()
    return cond_graph.plain_select(pred)


def _capturing(t: torch.Tensor) -> bool:
    return t.is_cuda and torch.cuda.is_current_stream_capturing()


def _runner(ctx, op_name):
    runner = getattr(ctx, "block_runner", None)
    if runner is None:
        raise RuntimeError(
            f"{op_name} requires the static-graph executor (sub-block "
            "runs); it cannot run as a standalone eager op")
    return runner


def splits_key(op) -> bool:
    """Whether the executor must split a captured key at ``op``: a
    ``while`` without ``max_iters`` (its trip count is read by the host)
    or an op registered as a host op (``py_func``)."""
    from .registry import OPS, is_registered
    if op.type == "while":
        return not op.attrs.get("differentiable")
    return is_registered(op.type) and OPS[op.type].host_op


def _inexact(v) -> bool:
    return isinstance(v, torch.Tensor) and (v.is_floating_point()
                                            or v.is_complex())


def _fresh(vals, held):
    """``vals`` with every tensor that shares storage with one of
    ``held`` cloned, so copying them into ``held`` in turn reads no value
    already overwritten (a body that swaps its carries)."""
    ptrs = {h.untyped_storage().data_ptr() for h in held}
    return [v.clone() if v.untyped_storage().data_ptr() in ptrs else v
            for v in vals]


def _check_carry(names, before, after):
    for n, b, a in zip(names, before, after):
        if tuple(a.shape) != tuple(b.shape) or a.dtype != b.dtype:
            raise TypeError(
                f"loop carry {n!r} changes from {b.dtype} {tuple(b.shape)} "
                f"to {a.dtype} {tuple(a.shape)} across one iteration — while "
                f"carries must keep their shape and dtype")


def _check_sig(what, names, first, other):
    for n, a, b in zip(names, first, other):
        if tuple(a.shape) != tuple(b.shape) or a.dtype != b.dtype:
            raise TypeError(
                f"{what} branches must return matching shapes/dtypes for "
                f"every output: {n!r} is {a.dtype} {tuple(a.shape)} in one "
                f"and {b.dtype} {tuple(b.shape)} in another")


# ----------------------------------------------------------------- while

class _Loop:
    """A ``while`` op's sub-block as a function of (condition, carries,
    key): the new condition and carries."""

    def __init__(self, ctx, ins, attrs):
        self.runner = _runner(ctx, "while")
        self.sub = int(attrs["sub_block"])
        self.carry_names = list(attrs["carry_names"])
        self.cond_name = attrs["cond_name"]
        self.params = dict(zip(attrs.get("param_names", []),
                               ins.get("Params", [])))

    def body(self, cond_val, xs, rng, params=None):
        env = dict(self.params if params is None else params)
        env.update(zip(self.carry_names, xs))
        env[self.cond_name] = cond_val
        env = self.runner.run_block(self.sub, env, rng)
        new = [env[n] for n in self.carry_names]
        _check_carry(self.carry_names, xs, new)
        return env[self.cond_name], new


def _split(rng):
    k = prng.split(rng, 2)
    return k[0], k[1]


@register("while", no_grad_slots=("Condition",))
def _while(ctx, ins, attrs):
    """Carries in slot X (their final values -> Out, same order);
    read-only closure values in Params; Condition is the value before
    the loop, which the sub-block recomputes every iteration."""
    loop = _Loop(ctx, ins, attrs)
    cond0, xs0 = ins["Condition"][0], list(ins["X"])
    rng = ctx.rng()
    if attrs.get("differentiable"):
        n = int(attrs.get("max_iters", 0))
        if n <= 0:
            raise ValueError(
                "while with differentiable=True requires max_iters > 0 "
                "(a bounded trip count is what makes the backward storable)")
        if _capturing(cond0):
            cond, xs = cond0.clone(), [x.clone() for x in xs0]
            for _ in range(n):
                rng, sub = _split(rng)
                with cond_graph.if_body(cond):
                    c, new = loop.body(cond, xs, sub)
                    for buf, v in zip([cond] + xs, _fresh([c] + new,
                                                          [cond] + xs)):
                        buf.copy_(v)
            return {"Out": xs}
        cond, xs = cond0, xs0
        for _ in range(n):
            if not read_pred(cond):
                break
            rng, sub = _split(rng)
            cond, xs = loop.body(cond, xs, sub)
        return {"Out": list(xs)}
    host = getattr(ctx, "host_loop", None)
    if host is not None:
        return {"Out": host.run(loop, cond0, xs0, rng)}
    if _capturing(cond0):
        raise RuntimeError(
            "a while without max_iters runs on the host and cannot be "
            "captured; the executor splits a key at a top-level one")
    cond, xs = cond0, xs0
    while read_pred(cond):
        rng, sub = _split(rng)
        cond, xs = loop.body(cond, xs, sub)
    return {"Out": list(xs)}


class HostLoop:
    """A dynamic ``while`` on the card where the executor split its key:
    the body is a graph of its own over fixed carry buffers (captured at
    the key's capture run, through ``capture``), replayed while a host
    read of the condition says so."""

    def __init__(self, capture, replay):
        self.capture, self.replay = capture, replay
        self.state = None

    def run(self, loop, cond0, xs0, rng):
        if self.state is None:
            cond, xs = cond0.clone(), [x.clone() for x in xs0]
            key = rng.clone()

            def body():
                k, sub = _split(key)
                c, new = loop.body(cond, xs, sub)
                for buf, v in zip([cond] + xs + [key],
                                  _fresh([c] + new + [k],
                                         [cond] + xs + [key])):
                    buf.copy_(v)

            self.state = (cond, xs, key, self.capture(body))
        cond, xs, key, graph = self.state
        cond.copy_(cond0)
        key.copy_(rng)
        for buf, x in zip(xs, xs0):
            buf.copy_(x)
        while read_pred(cond):
            self.replay(graph)
        return list(xs)


def _grads_of(outs, cots, leaves):
    """``torch.autograd.grad`` of the float outputs with a cotangent,
    None where a leaf got nothing."""
    pairs = [(o, c) for o, c in zip(outs, cots)
             if c is not None and _inexact(o) and o.requires_grad]
    if not pairs or not leaves:
        return [None] * len(leaves)
    return list(torch.autograd.grad([o for o, _ in pairs], leaves,
                                    [c.to(o.dtype) for o, c in pairs],
                                    allow_unused=True))


def _leaves(vals):
    """Detached copies of ``vals``, the float ones requiring grad, and
    the indices of those."""
    out, idx = [], []
    for i, v in enumerate(vals):
        v = v.detach()
        if _inexact(v):
            v = v.requires_grad_(True)
            idx.append(i)
        out.append(v)
    return out, idx


def _cotangents(ins, slot, outs_like, attrs):
    """The incoming cotangents of output ``slot``, None where absent."""
    gs = list(ins.get(slot + GRAD_SLOT_SUFFIX, []))
    mask = attrs.get("__out_grad_present__", {}).get(slot)
    if mask is not None:
        it = iter(gs)
        gs = [next(it) if m else None for m in mask]
    gs += [None] * (len(outs_like) - len(gs))
    return gs


def _zeros(v):
    return (torch.zeros_like(v) if _inexact(v) else
            torch.zeros(tuple(v.shape), dtype=torch.float32,
                        device=v.device))


def _select_wanted(attrs, out, slot, grads):
    mask = attrs.get("__in_grad_wanted__", {}).get(slot)
    if mask is not None:
        grads = [g for g, m in zip(grads, mask) if m]
    out[slot + GRAD_SLOT_SUFFIX] = grads


@register_grad("while")
def _while_grad(ctx, ins, attrs):
    """The bounded loop's VJP: the forward again keeping each
    iteration's input carry and live flag, then the iterations in
    reverse, a live one taking its VJP of the body."""
    if not attrs.get("differentiable"):
        raise ValueError(
            "a while without max_iters is not reverse-differentiable (its "
            "residuals are unbounded); set max_iters on while_loop")
    loop = _Loop(ctx, ins, attrs)
    n = int(attrs["max_iters"])
    cond0, xs0 = ins["Condition"][0], list(ins["X"])
    params = list(ins.get("Params", []))
    pnames = list(attrs.get("param_names", []))
    g_out = _cotangents(ins, "Out", xs0, attrs)
    capture = _capturing(cond0)
    rng = ctx.rng()
    # the forward again, keeping each iteration's inputs
    saved = []
    cond, xs = (cond0.clone(), [x.clone() for x in xs0]) if capture \
        else (cond0, xs0)
    for _ in range(n):
        rng, sub = _split(rng)
        if capture:
            live = cond.clone()
            saved.append((live, [x.clone() for x in xs], sub, live))
            with cond_graph.if_body(live):
                c, new = loop.body(cond, xs, sub)
                for buf, v in zip([cond] + xs, _fresh([c] + new,
                                                      [cond] + xs)):
                    buf.copy_(v)
        else:
            if not read_pred(cond):
                break
            saved.append((None, xs, sub, cond))
            cond, xs = loop.body(cond, xs, sub)
    g_xs = [g.clone() if g is not None else _zeros(x)
            for g, x in zip(g_out, xs0)]
    g_ps = [_zeros(p) for p in params]

    def vjp(xs_in, sub, cond_in):
        with torch.enable_grad():
            x_leaves, xi = _leaves(xs_in)
            p_leaves, pi = _leaves(params)
            _, new = loop.body(cond_in, x_leaves, sub,
                               dict(zip(pnames, p_leaves)))
            got = _grads_of(new, [g if _inexact(v) else None
                                  for g, v in zip(g_xs, new)],
                            [x_leaves[i] for i in xi]
                            + [p_leaves[i] for i in pi])
        gx = dict(zip(xi, got[:len(xi)]))
        gp = dict(zip(pi, got[len(xi):]))
        return ([gx.get(i) if gx.get(i) is not None else _zeros(x)
                 for i, x in enumerate(xs_in)],
                [gp.get(i) for i in range(len(params))])

    for live, xs_in, sub, cond_in in reversed(saved):
        if capture:
            with cond_graph.if_body(live):
                gx, gp = vjp(xs_in, sub, cond_in)
                for buf, v in zip(g_xs, _fresh(gx, g_xs)):
                    buf.copy_(v.to(buf.dtype))
                for buf, v in zip(g_ps, gp):
                    if v is not None:
                        buf.add_(v.to(buf.dtype))
        else:
            gx, gp = vjp(xs_in, sub, cond_in)
            g_xs = [v.to(b.dtype) for b, v in zip(g_xs, gx)]
            g_ps = [b if v is None else b + v.to(b.dtype)
                    for b, v in zip(g_ps, gp)]
    out: Dict[str, List[torch.Tensor]] = {}
    _select_wanted(attrs, out, "X", g_xs)
    if params:
        _select_wanted(attrs, out, "Params", g_ps)
    return out


# ------------------------------------------------------- cond, switch_case

def _branch(runner, blk, names, vals, out_names, rng, what):
    env = runner.run_block(blk, dict(zip(names, vals)), rng)
    missing = [n for n in out_names if n not in env]
    if missing:
        raise KeyError(f"{what} branch (block {blk}) did not produce "
                       f"outputs {missing}")
    return [env[n] for n in out_names]


#: (id of a block-0 op's attrs, output index) -> the tensor its outputs
#: are written into, run after run: a key's eager run and its capture
#: then hand the ops after it the same tensors (the AdamW kernel's
#: tables are keyed by their addresses). Only block 0's ops, which run
#: once per run: a loop body's op runs again while its last outputs may
#: still be read
_HELD: dict = {}


def _held(key, vals):
    out = []
    for i, v in enumerate(vals):
        b = _HELD.get((key, i))
        if b is None or b.shape != v.shape or b.dtype != v.dtype or \
                b.device != v.device:
            b = _HELD[(key, i)] = torch.empty_like(v)
        out.append(b)
    return out


def _branches(preds, run, what, names, key=None):
    """``run(i)`` for the branch ``i`` whose predicate holds: on the host
    by reading ``preds`` (a callable giving the branch index), under
    capture one IF node per branch (``preds`` then gives each branch's
    device predicate), each copying its outputs into the same tensors:
    those held for ``key`` (an op's outputs), or the first branch's
    fresh copies."""
    which, device_preds = preds
    if device_preds is None:
        vals = run(which())
        if key is None:
            return vals
        outs = _held(key, vals)
        for o, v in zip(outs, vals):
            o.copy_(v)
        return outs
    outs = None
    for i, (pred, negate) in enumerate(device_preds):
        with cond_graph.if_body(pred, negate=negate):
            vals = run(i)
            if outs is None:
                outs = (_held(key, vals) if key is not None else
                        [torch.empty_like(v) for v in vals])
            else:
                _check_sig(what, names, outs, vals)
            for o, v in zip(outs, vals):
                o.copy_(v)
    return outs


def _cond_preds(ctx, ins, attrs):
    pred = ins["Cond"][0]
    keys = prng.split(ctx.rng(), 2)
    blocks = [int(attrs["sub_block_t"]), int(attrs["sub_block_f"])]
    if _capturing(pred):
        return blocks, keys, (None, [(pred, False), (pred, True)])
    return blocks, keys, (lambda: 0 if read_pred(pred) else 1, None)


def _switch_preds(ctx, ins, attrs):
    blocks = [int(b) for b in attrs["sub_blocks"]]
    rng = ctx.rng()
    keys = [prng.fold_in(rng, i) for i in range(len(blocks))]
    idx = ins["Index"][0].reshape(-1)[:1].to(torch.int64)
    last = len(blocks) - 1
    # any out-of-range index (negative or too large) runs the default,
    # which layers.switch_case places last: paddle's contract
    idx = torch.where((idx < 0) | (idx > last), torch.full_like(idx, last),
                      idx)
    if _capturing(idx):
        return blocks, keys, (None, [(idx == i, False)
                                     for i in range(len(blocks))])
    return blocks, keys, (lambda: _read_index(idx), None)


def _read_index(idx):
    if idx.is_cuda:
        note_host_read()
    return int(idx[0])


def _forward(ctx, ins, attrs, what, preds):
    runner = _runner(ctx, what)
    names = list(attrs.get("param_names", []))
    out_names = list(attrs["out_names"])
    vals = list(ins.get("Params", []))
    blocks, keys, sel = preds(ctx, ins, attrs)
    outs = _branches(sel, lambda i: _branch(runner, blocks[i], names, vals,
                                            out_names, keys[i], what),
                     what, out_names,
                     key=id(attrs) if getattr(ctx, "block_idx", None) == 0
                     else None)
    return {"Out": list(outs)}


def _backward(ctx, ins, attrs, what, preds):
    runner = _runner(ctx, what)
    names = list(attrs.get("param_names", []))
    out_names = list(attrs["out_names"])
    vals = list(ins.get("Params", []))
    cots = _cotangents(ins, "Out", out_names, attrs)
    blocks, keys, sel = preds(ctx, ins, attrs)

    def vjp(i):
        with torch.enable_grad():
            leaves, li = _leaves(vals)
            outs = _branch(runner, blocks[i], names, leaves, out_names,
                           keys[i], what)
            got = dict(zip(li, _grads_of(outs, cots,
                                         [leaves[j] for j in li])))
        return [got[j] if got.get(j) is not None else _zeros(v)
                for j, v in enumerate(vals)]

    grads = _branches(sel, vjp, what, names)
    out: Dict[str, List[torch.Tensor]] = {}
    _select_wanted(attrs, out, "Params", [g.detach() for g in grads])
    return out


@register("cond", no_grad_slots=("Cond",))
def _cond(ctx, ins, attrs):
    """Two branches over Params (names in ``param_names``); each defines
    every name of ``out_names``."""
    return _forward(ctx, ins, attrs, "cond", _cond_preds)


@register_grad("cond")
def _cond_grad(ctx, ins, attrs):
    return _backward(ctx, ins, attrs, "cond", _cond_preds)


@register("switch_case", no_grad_slots=("Index",))
def _switch_case(ctx, ins, attrs):
    """N branches over ``sub_blocks``, the last the default."""
    return _forward(ctx, ins, attrs, "switch_case", _switch_preds)


@register_grad("switch_case")
def _switch_case_grad(ctx, ins, attrs):
    return _backward(ctx, ins, attrs, "switch_case", _switch_preds)


# ---------------------------------------------------------------------------
# static infer rules (the abstract interpreter, analysis/abstract_interp.py)
#
# These lowerings cannot run on meta tensors: they re-enter the
# executor's block runner to run sub-blocks. The rules mirror the name
# plumbing above and enforce statically the two contracts the lowerings
# check only when they run — loop-carry shape/dtype invariance (while)
# and branch-signature agreement (cond / switch_case).
# ---------------------------------------------------------------------------


def _seed_env(attrs, ins):
    return dict(zip(attrs.get("param_names", []), ins.get("Params", [])))


@register_infer("while")
def _while_infer(ictx, ins, attrs):
    carry_names = list(attrs["carry_names"])
    cond_name = attrs["cond_name"]
    carries = list(ins.get("X", []))
    env = _seed_env(attrs, ins)
    env.update(zip(carry_names, carries))
    if ins.get("Condition"):
        env[cond_name] = ins["Condition"][0]
    out_env = ictx.infer_block(int(attrs["sub_block"]), env)
    for name, before in zip(carry_names, carries):
        after = out_env.get(name)
        if (after is not None and before.known and after.known
                and (before.shape != after.shape
                     or before.dtype != after.dtype)):
            ictx.report(
                "shapes.loop-carry",
                f"loop carry {name!r} changes from {before} to {after} "
                f"across one iteration — while carries must be "
                f"shape/dtype invariant (the contract of the reference's "
                f"lax.while_loop, and of a captured loop's IF nodes)",
                var=name)
    # invariance means the entry carries ARE the loop's fixed point
    return {"Out": carries}


def _join_branches(ictx, attrs, branch_outs, what):
    from ..analysis.abstract_interp import AbstractVar
    out_names = list(attrs["out_names"])
    joined = []
    for name in out_names:
        vals = [outs.get(name) for outs in branch_outs]
        known = [v for v in vals if v is not None and v.known]
        agree = all(v.shape == known[0].shape and v.dtype == known[0].dtype
                    for v in known) if known else True
        if not agree:
            ictx.report(
                "shapes.branch-mismatch",
                f"{what} output {name!r} disagrees across branches: "
                f"{', '.join(str(v) if v is not None else '?' for v in vals)}"
                f" — every branch must keep one signature (one XLA "
                f"computation in the reference, one output per IF node "
                f"here)",
                var=name)
            joined.append(None)
        else:
            joined.append(known[0] if known and len(known) == len(vals)
                          else None)
    return {"Out": [v if v is not None else AbstractVar()
                    for v in joined]}


@register_infer("cond")
def _cond_infer(ictx, ins, attrs):
    outs = [ictx.infer_block(int(attrs[k]), _seed_env(attrs, ins))
            for k in ("sub_block_t", "sub_block_f")]
    return _join_branches(ictx, attrs, outs, "cond")


@register_infer("switch_case")
def _switch_case_infer(ictx, ins, attrs):
    outs = [ictx.infer_block(int(b), _seed_env(attrs, ins))
            for b in attrs["sub_blocks"]]
    return _join_branches(ictx, attrs, outs, "switch_case")
