"""Control-flow layer builders: ``While``, ``while_loop``, ``cond``,
``case``, ``switch_case`` and the comparison / logical builders — the
counterpart of ``paddle_tpu/layers/control_flow.py`` (analog of
python/paddle/fluid/layers/control_flow.py: While:1043,
while_loop:1238), a copy of the reference's builders. They trace user
functions into nested blocks of the Program and emit the ``while`` /
``cond`` / ``switch_case`` ops (:mod:`~paddle_tpu_torch.ops.
control_flow_ops`), which the executor runs as IF nodes of its CUDA
graph, or, for a ``while`` without ``max_iters``, as a host loop over
the body's own graph.

Contracts the builders and their ops keep, as the reference's do:
- loop-carried variables keep their shape and dtype across iterations;
- the branches of ``cond`` / ``switch_case`` return matching shapes and
  dtypes;
- a reverse-differentiable loop needs a static ``max_iters`` bound (the
  reference's extension of ``while_loop``).
"""

from __future__ import annotations

import contextlib
from typing import Callable, List, Optional, Sequence

from ..framework import unique_name
from ..framework.program import Block, Program, Variable, \
    block_reads_writes as _block_reads_writes, default_main_program


def _as_var_list(v) -> List[Variable]:
    if v is None:
        return []
    if isinstance(v, Variable):
        return [v]
    return list(v)


def _declare_outputs(parent: Block, rets: Sequence[Variable],
                     prefix: str) -> List[Variable]:
    outs = []
    for r in rets:
        o = parent.create_var(unique_name.generate(prefix),
                              shape=r.shape, dtype=r.dtype)
        outs.append(o)
    return outs


def _compare(op: str, x: Variable, y: Variable, name=None) -> Variable:
    from ..layer_helper import LayerHelper
    helper = LayerHelper(op, name=name)
    out = helper.create_variable_for_type_inference("bool", True)
    out.shape = x.shape
    helper.append_op(op, inputs={"X": x, "Y": y}, outputs={"Out": out})
    return out


def less_than(x, y, name=None):
    """fluid.layers.less_than (ref operators/controlflow/compare_op.cc)."""
    return _compare("less_than", x, y, name)


def less_equal(x, y, name=None):
    return _compare("less_equal", x, y, name)


def greater_than(x, y, name=None):
    return _compare("greater_than", x, y, name)


def greater_equal(x, y, name=None):
    return _compare("greater_equal", x, y, name)


def equal(x, y, name=None):
    return _compare("equal", x, y, name)


def not_equal(x, y, name=None):
    return _compare("not_equal", x, y, name)


def logical_and(x, y, name=None):
    return _compare("logical_and", x, y, name)


def logical_or(x, y, name=None):
    return _compare("logical_or", x, y, name)


def logical_not(x, name=None):
    from ..layer_helper import LayerHelper
    helper = LayerHelper("logical_not", name=name)
    out = helper.create_variable_for_type_inference("bool", True)
    out.shape = x.shape
    helper.append_op("logical_not", inputs={"X": x}, outputs={"Out": out})
    return out


def cond(pred: Variable, true_fn: Callable, false_fn: Callable,
         name: Optional[str] = None):
    """paddle.static.nn.cond parity: trace both branches into sub-blocks
    and emit one ``cond`` op, which runs the taken branch only. Returns a
    Variable or a tuple matching the branch returns (which must agree in
    structure)."""
    prog = default_main_program()
    parent = prog.current_block()

    with prog.block_scope() as tblk:
        t_rets = _as_var_list(true_fn())
    with prog.block_scope() as fblk:
        f_rets = _as_var_list(false_fn())
    if len(t_rets) != len(f_rets):
        raise ValueError(
            f"cond branches returned {len(t_rets)} vs {len(f_rets)} "
            "values; both must match")

    outs = _declare_outputs(parent, t_rets, name or "cond_out")
    # canonicalize branch returns onto shared output names inside each
    # sub-block so the lowering can fetch them uniformly
    for blk, rets in ((tblk, t_rets), (fblk, f_rets)):
        for r, o in zip(rets, outs):
            blk.append_op("assign", {"X": r.name}, {"Out": o.name})

    reads_t, _ = _block_reads_writes(prog, tblk.idx)
    reads_f, _ = _block_reads_writes(prog, fblk.idx)
    param_names = []
    for n in reads_t + reads_f:
        if n not in param_names and parent.has_var(n):
            param_names.append(n)

    parent.append_op(
        "cond",
        inputs={"Cond": pred, "Params": param_names},
        outputs={"Out": [o.name for o in outs]},
        attrs={"sub_block_t": tblk.idx, "sub_block_f": fblk.idx,
               "param_names": param_names,
               "out_names": [o.name for o in outs]})
    if not outs:
        return None
    return outs[0] if len(outs) == 1 else tuple(outs)


def while_loop(cond_fn: Callable, body_fn: Callable,
               loop_vars: Sequence[Variable],
               is_test: bool = False, name: Optional[str] = None,
               max_iters: Optional[int] = None):
    """paddle.static.nn.while_loop parity. The reference's extension:
    pass ``max_iters`` to make the loop reverse-differentiable (at most
    ``max_iters`` iterations, each run only while the condition holds;
    on the card one IF node each)."""
    loop_vars = list(loop_vars)
    if not loop_vars:
        raise ValueError("while_loop requires at least one loop var")
    prog = default_main_program()
    parent = prog.current_block()

    pre_cond = cond_fn(*loop_vars)

    with prog.block_scope() as blk:
        rets = _as_var_list(body_fn(*loop_vars))
        if len(rets) != len(loop_vars):
            raise ValueError(
                f"while_loop body returned {len(rets)} values for "
                f"{len(loop_vars)} loop vars")
        # write results back onto the loop-var names (the carry) in two
        # phases through temps — a body returning a permutation of the
        # loop vars (e.g. swapped carries) must not read names already
        # clobbered by an earlier assign
        pending = [(r, lv) for r, lv in zip(rets, loop_vars)
                   if r.name != lv.name]
        tmps = []
        for r, lv in pending:
            tmp = blk.create_var(unique_name.generate("carry_tmp"),
                                 shape=r.shape, dtype=r.dtype)
            blk.append_op("assign", {"X": r.name}, {"Out": tmp.name})
            tmps.append(tmp)
        for tmp, (r, lv) in zip(tmps, pending):
            blk.append_op("assign", {"X": tmp.name}, {"Out": lv.name})
        new_cond = cond_fn(*loop_vars)
        if new_cond.name != pre_cond.name:
            blk.append_op("assign", {"X": new_cond.name},
                          {"Out": pre_cond.name})

    carry_names = [lv.name for lv in loop_vars]
    reads, _ = _block_reads_writes(prog, blk.idx)
    param_names = [n for n in reads
                   if n not in carry_names and n != pre_cond.name
                   and parent.has_var(n)]

    attrs = {"sub_block": blk.idx, "carry_names": carry_names,
             "cond_name": pre_cond.name, "param_names": param_names,
             "is_test": is_test}
    if max_iters is not None:
        attrs.update(differentiable=True, max_iters=int(max_iters))
    # outputs get FRESH names: writing back onto the input names would
    # alias pre-loop values away and break recompute-based gradients
    outs = _declare_outputs(parent, loop_vars, name or "while_out")
    parent.append_op(
        "while",
        inputs={"Condition": pre_cond, "X": carry_names,
                "Params": param_names},
        outputs={"Out": [o.name for o in outs]},
        attrs=attrs)
    return outs[0] if len(outs) == 1 else tuple(outs)


class While:
    """fluid.layers.While parity — block-style loop builder:

        i = layers.fill_constant([1], "int64", 0)
        cond = layers.less_than(i, n)
        w = layers.While(cond)
        with w.block():
            ...  # update vars with layers.assign / increment
            layers.assign(layers.less_than(i, n), cond)

    Variables from the enclosing block that the body re-assigns become
    the loop carry; everything else it reads is closed over read-only.
    """

    def __init__(self, cond: Variable, is_test: bool = False,
                 name: Optional[str] = None):
        self.cond_var = cond
        self.is_test = is_test
        self.name = name

    @contextlib.contextmanager
    def block(self):
        prog = default_main_program()
        parent = prog.current_block()
        with prog.block_scope() as blk:
            yield blk
        reads, writes = _block_reads_writes(prog, blk.idx)
        # carried = names written by the body that live in the parent
        # chain (i.e. survive the loop), except the condition itself
        carry_names = [n for n in writes
                       if n != self.cond_var.name
                       and n not in blk.vars and parent.has_var(n)]
        param_names = [n for n in reads
                       if n not in carry_names and n != self.cond_var.name
                       and parent.has_var(n)]
        parent.append_op(
            "while",
            inputs={"Condition": self.cond_var, "X": carry_names,
                    "Params": param_names},
            outputs={"Out": carry_names},
            attrs={"sub_block": blk.idx, "carry_names": carry_names,
                   "cond_name": self.cond_var.name,
                   "param_names": param_names, "is_test": self.is_test})


def case(pred_fn_pairs, default=None, name=None):
    """paddle.static.nn.case parity via nested cond ops: first true
    predicate wins; ``default`` runs when none are true."""
    if not pred_fn_pairs:
        raise ValueError("case requires at least one (pred, fn) pair")
    pred, fn = pred_fn_pairs[0]
    rest = pred_fn_pairs[1:]
    if not rest:
        if default is None:
            # reference behavior: last fn doubles as the default
            return cond(pred, fn, fn, name=name)
        return cond(pred, fn, default, name=name)
    return cond(pred, fn, lambda: case(rest, default), name=name)


def switch_case(branch_index: Variable, branch_fns, default=None,
                name=None):
    """paddle.static.nn.switch_case parity: dict/list of index->fn plus
    optional default, lowered to one ``switch_case`` op (an out-of-range
    index runs the default)."""
    if isinstance(branch_fns, dict):
        pairs = sorted(branch_fns.items())
    elif branch_fns and all(isinstance(b, (tuple, list)) and len(b) == 2
                            for b in branch_fns):
        # paddle also accepts a list of (index, fn) tuples
        pairs = sorted((int(k), fn) for k, fn in branch_fns)
    else:
        pairs = list(enumerate(branch_fns))
    keys = [k for k, _ in pairs]
    if keys != list(range(len(keys))):
        raise NotImplementedError(
            "switch_case currently requires dense 0..N-1 branch keys")
    fns = [fn for _, fn in pairs]
    if default is not None:
        fns.append(default)
    else:
        fns.append(fns[-1])

    prog = default_main_program()
    parent = prog.current_block()
    blocks, rets_per = [], []
    for fn in fns:
        with prog.block_scope() as blk:
            rets = _as_var_list(fn())
        blocks.append(blk)
        rets_per.append(rets)
    n_out = len(rets_per[0])
    if any(len(r) != n_out for r in rets_per):
        raise ValueError("switch_case branches must return the same "
                         "number of values")
    outs = _declare_outputs(parent, rets_per[0], name or "switch_out")
    for blk, rets in zip(blocks, rets_per):
        for r, o in zip(rets, outs):
            blk.append_op("assign", {"X": r.name}, {"Out": o.name})
    param_names = []
    for blk in blocks:
        reads, _ = _block_reads_writes(prog, blk.idx)
        for n in reads:
            if n not in param_names and parent.has_var(n):
                param_names.append(n)
    parent.append_op(
        "switch_case",
        inputs={"Index": branch_index, "Params": param_names},
        outputs={"Out": [o.name for o in outs]},
        attrs={"sub_blocks": [b.idx for b in blocks],
               "param_names": param_names,
               "out_names": [o.name for o in outs]})
    return outs[0] if len(outs) == 1 else tuple(outs)
