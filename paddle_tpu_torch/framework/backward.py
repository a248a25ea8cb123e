"""Program-level autodiff: ``append_backward``, recompute segments and
``gradients`` — the counterpart of ``paddle_tpu/framework/backward.py``,
ported whole.

Gradients are real ops appended to the Program (the reference's
GradOpMaker scheme, backward.py:1215), so later rewrites see them.
Accumulation follows the reference's rename-and-sum: when several
consumers contribute gradients to one forward var, each grad op writes
a unique ``<var>@GRAD@RENAME@i`` and a ``sum`` op materializes
``<var>@GRAD``. With ``checkpoints`` the forward ops between
checkpoints are cloned into the backward pass behind an
``optimization_barrier`` (a pass-through in the port, which has no
compiler to fence in), their outputs renamed ``@RCP<seg>``.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Set, Tuple

from ..ops import registry as _reg
from .program import Block, Operator, Variable, grad_var_name


def _op_def(op_type: str):
    try:
        return _reg.get_op_def(op_type)
    except NotImplementedError:
        return None


def _forward_needs_grad(block: Block, no_grad_set: Set[str]) -> Set[str]:
    """Forward sweep: which var names can carry gradient."""
    needs: Set[str] = set()
    for v in block.vars.values():
        if v.name in no_grad_set:
            continue
        if v.is_parameter and v.trainable:
            needs.add(v.name)
        elif not v.stop_gradient and v.is_data:
            needs.add(v.name)
    for op in block.ops:
        d = _op_def(op.type)
        if d is None or d.not_differentiable:
            continue
        virtual = getattr(d, "virtual_param", False)
        if virtual or any(n in needs for n in op.input_names()):
            for slot, names in op.outputs.items():
                if slot in d.nondiff_outputs:
                    continue
                for n in names:
                    if n not in no_grad_set:
                        needs.add(n)
    return needs


def append_backward(
    loss: Variable,
    parameter_list: Optional[Sequence] = None,
    no_grad_set: Optional[Set[str]] = None,
    checkpoints: Optional[Sequence] = None,
) -> List[Tuple[Variable, Variable]]:
    """With ``checkpoints`` (var names/Variables), builds a RECOMPUTING
    backward: forward ops between consecutive checkpoints are cloned into
    the backward pass (outputs renamed ``@RCP<seg>``) and the grad ops
    consume the recomputed values — so only checkpoint activations stay
    live across forward->backward. Analog of the reference's
    RecomputeOptimizer / _append_backward_ops_with_checkpoints_
    (fluid/backward.py:629); the TPU payoff is XLA liveness: non-
    checkpoint activations die at the end of the forward."""
    result, _ = _append_backward_impl(loss, parameter_list, no_grad_set,
                                      checkpoints=checkpoints)
    return result


def _segment_plan(fwd_ops, checkpoint_names: Set[str]):
    """Assign each forward op a segment id; a segment CLOSES after an op
    that produces a checkpoint. Returns (seg_of_op list, per-segment
    rename maps name->name@RCP<seg> for names produced in the segment)."""
    seg_of_op: List[int] = []
    produced_in_seg: List[Set[str]] = [set()]
    seg = 0
    for op in fwd_ops:
        seg_of_op.append(seg)
        outs = set(op.output_names())
        produced_in_seg[seg] |= outs
        if outs & checkpoint_names:
            seg += 1
            produced_in_seg.append(set())
    renames: List[Dict[str, str]] = []
    for s, names in enumerate(produced_in_seg):
        renames.append({n: f"{n}@RCP{s}" for n in names
                        if n not in checkpoint_names})
    return seg_of_op, renames


def _append_backward_impl(
    loss: Variable,
    parameter_list: Optional[Sequence] = None,
    no_grad_set: Optional[Set[str]] = None,
    extra_vars: Sequence[str] = (),
    checkpoints: Optional[Sequence] = None,
):
    """Append grad ops computing d(loss)/d(param); returns [(param, grad)].

    The backward ops are appended to ``loss.block`` in reverse-forward
    order, with op attr ``op_role='backward'`` so passes (pipeline split,
    AMP, gradient-merge) can classify them — analog of the reference's
    OpRole attribute.
    """
    block = loss.block
    program = block.program
    no_grad_set = set(no_grad_set or ())
    needs_grad = _forward_needs_grad(block, no_grad_set)
    if loss.name not in needs_grad:
        raise ValueError(
            f"loss {loss.name!r} does not depend on any trainable parameter")

    fwd_ops = list(block.ops)

    ckpt_names: Set[str] = set()
    seg_of_op: List[int] = []
    seg_renames: List[Dict[str, str]] = []
    seg_emitted: Set[int] = set()
    if checkpoints:
        ckpt_names = {c.name if isinstance(c, Variable) else str(c)
                      for c in checkpoints}
        produced = {n for op in fwd_ops for n in op.output_names()}
        unmatched = sorted(ckpt_names - produced)
        if unmatched:
            raise ValueError(
                f"recompute checkpoints {unmatched} are not produced by "
                "any forward op — the rewrite would silently be a no-op")
        seg_of_op, seg_renames = _segment_plan(fwd_ops, ckpt_names)
        # the tail segment (after the last checkpoint, incl. the loss)
        # is NOT recomputed: its activations are live anyway at the
        # moment the backward starts, so cloning it would double its
        # FLOPs for zero memory benefit
        tail = max(seg_of_op) if seg_of_op else 0
        seg_renames[tail] = {}
        seg_emitted.add(tail)

    def _emit_recompute(seg: int):
        """Clone segment ``seg``'s forward ops into the backward stream
        with renamed outputs; inputs defined inside the segment use the
        renamed values, everything else reads the still-live original
        (checkpoints, feeds, params)."""
        if seg in seg_emitted:
            return
        seg_emitted.add(seg)
        ren = seg_renames[seg]
        # barrier the segment's external inputs (checkpoints, feeds,
        # params): without an optimization_barrier XLA CSE would merge
        # the clones back into the original ops and keep the original
        # activations alive — the exact thing recompute exists to avoid
        # (same mechanism as jax.checkpoint)
        ext = []
        for idx, op in enumerate(fwd_ops):
            if seg_of_op[idx] != seg:
                continue
            for n in op.input_names():
                if n not in ren and n not in ext:
                    ext.append(n)
        barrier = {}
        if ext:
            b_names = [f"{n}@RCPB{seg}" for n in ext]
            for bn in b_names:
                block.create_var(bn, stop_gradient=True)
            block.append_op("optimization_barrier", inputs={"X": ext},
                            outputs={"Out": b_names},
                            attrs={"op_role": "backward"})
            barrier = dict(zip(ext, b_names))
        ren = {**barrier, **ren}
        seg_renames[seg] = ren
        for idx, op in enumerate(fwd_ops):
            if seg_of_op[idx] != seg:
                continue
            new_in = {s: [ren.get(n, n) for n in names]
                      for s, names in op.inputs.items()}
            new_out = {s: [ren.get(n, n) for n in names]
                       for s, names in op.outputs.items()}
            attrs = dict(op.attrs)
            attrs["op_role"] = "backward"
            # pin functional randomness to the ORIGINAL op position so a
            # recomputed dropout regenerates the identical mask
            attrs.setdefault("__rng_tag__", idx)
            for names in new_out.values():
                for n in names:
                    if n not in block.vars:
                        block.create_var(n, stop_gradient=True)
            block.append_op(op.type, inputs=new_in, outputs=new_out,
                            attrs=attrs)

    def _remap_grad_inputs(op_idx: int,
                           g_in: Dict[str, List[str]]
                           ) -> Dict[str, List[str]]:
        """Point a grad op's forward-value inputs at the recomputed
        names for values produced inside the op's segment."""
        seg = seg_of_op[op_idx]
        ren = seg_renames[seg]
        out = {}
        for slot, names in g_in.items():
            if slot.endswith(_reg.GRAD_SLOT_SUFFIX):
                out[slot] = names
            else:
                out[slot] = [ren.get(n, n) for n in names]
        return out

    # d(loss)/d(loss) = 1
    loss_grad = grad_var_name(loss.name)
    block.create_var(loss_grad, shape=loss.shape, dtype=loss.dtype,
                     stop_gradient=True)
    block.append_op(
        "fill_constant_like",
        inputs={"X": [loss.name]},
        outputs={"Out": [loss_grad]},
        attrs={"value": 1.0, "op_role": "backward"},
    )

    # produced[v] = list of grad var names contributed so far
    produced: Dict[str, List[str]] = defaultdict(list)
    produced[loss.name].append(loss_grad)
    finalized: Dict[str, str] = {}  # var -> materialized accumulated grad name

    def materialize(v: str) -> Optional[str]:
        """Return the accumulated grad name for forward var v (sum if >1)."""
        if v in finalized:
            return finalized[v]
        contribs = produced.get(v)
        if not contribs:
            return None
        if len(contribs) == 1:
            finalized[v] = contribs[0]
            return contribs[0]
        acc = grad_var_name(v)
        if acc in contribs:
            acc = grad_var_name(v) + "@ACC"
        block.create_var(acc, stop_gradient=True)
        block.append_op("sum", inputs={"X": list(contribs)},
                        outputs={"Out": [acc]},
                        attrs={"op_role": "backward"})
        finalized[v] = acc
        return acc

    for op_idx in range(len(fwd_ops) - 1, -1, -1):
        op = fwd_ops[op_idx]
        d = _op_def(op.type)
        if d is None or d.not_differentiable:
            continue
        out_grad_names: Dict[str, List[Optional[str]]] = {}
        any_grad = False
        for slot, names in op.outputs.items():
            gs: List[Optional[str]] = []
            for n in names:
                g = materialize(n)
                gs.append(g)
                if g is not None:
                    any_grad = True
            out_grad_names[slot] = gs
        if not any_grad:
            continue

        # wanted input grads, unique name per (name, occurrence)
        wanted: Dict[str, List[Optional[str]]] = {}
        new_contribs: List[Tuple[str, str]] = []
        for slot, names in op.inputs.items():
            targets: List[Optional[str]] = []
            for n in names:
                if n in needs_grad and slot not in d.no_grad_slots:
                    k = len(produced[n]) + sum(1 for v, _ in new_contribs if v == n)
                    t = grad_var_name(n) if k == 0 else f"{grad_var_name(n)}@RENAME@{k}"
                    targets.append(t)
                    new_contribs.append((n, t))
                else:
                    targets.append(None)
            wanted[slot] = targets

        grad_op_descs = _reg.make_grad_ops(op, out_grad_names, wanted)
        if not grad_op_descs:
            continue
        if checkpoints:
            _emit_recompute(seg_of_op[op_idx])
        for (g_type, g_in, g_out, g_attrs) in grad_op_descs:
            g_attrs = dict(g_attrs)
            g_attrs["op_role"] = "backward"
            if checkpoints:
                g_in = _remap_grad_inputs(op_idx, g_in)
                g_attrs.setdefault("__rng_tag__", op_idx)
            block.append_op(g_type, inputs=g_in, outputs=g_out, attrs=g_attrs)
        # register contributions actually emitted
        emitted_targets = set()
        for (_, _, g_out, _) in grad_op_descs:
            for names in g_out.values():
                emitted_targets.update(names)
        for n, t in new_contribs:
            if t in emitted_targets:
                produced[n].append(t)
                block.create_var(t, stop_gradient=True)

    # materialize final grads for parameters
    if parameter_list is not None:
        params = [p if isinstance(p, Variable) else block.var(str(p))
                  for p in parameter_list]
    else:
        params = [p for p in block.all_parameters() if p.trainable]
    result: List[Tuple[Variable, Variable]] = []
    for p in params:
        g = materialize(p.name)
        if g is None:
            continue
        gv = block.var(g)
        gv.shape = p.shape
        gv.dtype = p.dtype
        result.append((p, gv))
    # accumulated grad names for any extra requested vars (gradients() API)
    grad_map = {v: materialize(v) for v in extra_vars}
    program.bump_version()
    return result, grad_map


def gradients(targets, inputs, target_gradients=None) -> List[Optional[Variable]]:
    """Analog of fluid.gradients: grads of targets w.r.t. arbitrary inputs."""
    tgt = targets if isinstance(targets, (list, tuple)) else [targets]
    ins = inputs if isinstance(inputs, (list, tuple)) else [inputs]
    if len(tgt) != 1:
        raise NotImplementedError("gradients() currently supports one target")
    names = [v.name if isinstance(v, Variable) else str(v) for v in ins]
    _, grad_map = _append_backward_impl(tgt[0], parameter_list=None,
                                        extra_vars=names)
    block = tgt[0].block
    return [block.vars.get(grad_map[n]) if grad_map.get(n) else None
            for n in names]
