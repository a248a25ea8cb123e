"""Abstract interpretation over the Program IR — static shape/dtype
inference; the counterpart of ``paddle_tpu/analysis/abstract_interp.py``.

The reference framework runs C++ ``InferShape``/``InferVarType`` per op
desc before any kernel executes (framework/operator.cc RunImpl,
shape_inference.h); a shape bug surfaces as a located PADDLE_ENFORCE.
The port runs a Program op by op, eagerly or under a CUDA-graph capture,
so declared Variable shapes are advisory and a mis-shaped program dies
inside a lowering, or inside a capture on the card.

This module restores the capability as an *abstract interpreter*: it
propagates :class:`AbstractVar` ``(shape, dtype)`` values through every
block (recursing into control-flow sub-blocks) without touching a
device. Per-op transfer functions resolve in order:

1. an explicit infer rule registered next to the lowering
   (``ops.registry.register(op_type, infer=...)`` /
   ``register_infer``) — control flow (needs sub-block recursion),
   collectives (shape depends on the mesh), PS ops, host ops and the
   lowerings whose output shape depends on their data;
2. the registered lowering run on ``torch.device("meta")`` tensors via
   ``registry.execute`` (the reference's ``jax.eval_shape``): a meta
   tensor has a shape and a dtype and no storage, so nothing is
   allocated or launched, and a kernel wrapper takes its plain
   version's shapes. Forward ops and the generic ``<fw>_grad`` ops get
   exact inference for free;
3. otherwise the op is recorded as an unknown-op fallback (WARNING)
   and its outputs become unknown.

Dynamic batch: ``layers.data`` declares dim 0 as ``-1``. The
interpreter runs twice with two concrete probe substitutions
(default 2 and 4) and joins the runs — dims that differ between probes
are reported as ``-1`` (batch-dependent), dims that agree are static.
Diagnostics come from the first run only.

Findings are the same structured :class:`framework.analysis.Diagnostic`
records as the verifier's other checks, surfaced through the registered
``shapes.infer`` check (``Program.verify()`` / PassManager /
``FLAGS_check_shapes``).
"""

from __future__ import annotations

import dataclasses
from typing import (Any, Dict, List, Mapping, Optional, Sequence, Set,
                    Tuple)

from ..framework.analysis import ERROR, WARNING, Diagnostic
from ..framework.program import Block, Operator, Program, convert_dtype

__all__ = [
    "AbstractVar", "InferContext", "InferError", "InterpretResult",
    "abstract_eval_op", "interpret_program",
]


@dataclasses.dataclass(frozen=True)
class AbstractVar:
    """Static value: shape tuple (``-1`` marks a batch-dependent dim
    after probe joining) and canonical dtype name; ``None`` means
    unknown (rank or dtype not statically derivable)."""

    shape: Optional[Tuple[int, ...]] = None
    dtype: Optional[str] = None

    @property
    def known(self) -> bool:
        return self.shape is not None and self.dtype is not None

    @property
    def concrete(self) -> bool:
        """Known with no dynamic dims — runnable on meta tensors."""
        return self.known and all(d >= 0 for d in self.shape)

    def __str__(self):
        if not self.known:
            return "?"
        dims = ",".join("?" if d < 0 else str(d) for d in self.shape)
        return f"{self.dtype}[{dims}]"


_UNKNOWN = AbstractVar()


class InferError(Exception):
    """Raised by infer rules (via ``InferContext.fail``) for a static
    contract violation; the interpreter converts it into an ERROR
    diagnostic located at the offending op."""


class InferContext:
    """Per-op context handed to explicit infer rules."""

    def __init__(self, interp: "_Interpreter", block: Block, op_idx: int,
                 op: Operator):
        self.interp = interp
        self.program = interp.program
        self.block = block
        self.op_idx = op_idx
        self.op = op

    def infer_block(self, idx: int,
                    env: Dict[str, AbstractVar]) -> Dict[str, AbstractVar]:
        """Abstractly run sub-block ``idx`` seeded with ``env`` (the
        rule's name->AbstractVar bindings); parent-block bindings stay
        visible underneath. Returns the sub-block's final environment."""
        return self.interp.run_block(idx, env)

    def fail(self, message: str):
        raise InferError(message)

    def report(self, check: str, message: str, *,
               severity: str = ERROR, var: Optional[str] = None):
        """Emit a diagnostic located at this op without aborting the
        rule (contract violations that still have a best-effort result,
        e.g. loop-carry drift where the declared carry is the answer)."""
        self.interp._diag(severity, check, message, self.block,
                          self.op_idx, var=var)


@dataclasses.dataclass
class InterpretResult:
    """One interpretation of a program."""

    diagnostics: List[Diagnostic]
    # (block_idx, var name) -> joined AbstractVar
    var_shapes: Dict[Tuple[int, str], AbstractVar]
    # (op_type, block_idx, op_idx) of every unknown-op fallback
    unknown_ops: List[Tuple[str, int, int]]
    ops_inferred: int = 0

    @property
    def errors(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == ERROR]

    def ok(self) -> bool:
        return not self.errors

    def shape_of(self, name: str,
                 block_idx: int = 0) -> Optional[AbstractVar]:
        return self.var_shapes.get((block_idx, name))


# ---------------------------------------------------------------------------
# the registered lowering on meta tensors
# ---------------------------------------------------------------------------


def _canon_dtype(dt) -> Optional[str]:
    try:
        return convert_dtype(dt)
    except (TypeError, ValueError):
        return str(dt) if dt is not None else None


def abstract_eval_op(op_type: str, ins: Dict[str, List[AbstractVar]],
                     attrs: Dict[str, Any]) -> Dict[str, List[AbstractVar]]:
    """Shape/dtype inference by running the registered lowering
    (``registry.execute``, so generic ``<fw>_grad`` ops work too) on meta
    tensors. Inputs must be concrete; raises on a genuine shape contract
    violation — the caller converts that into a Diagnostic."""
    import torch

    from .. import prng
    from ..ops import registry as _reg

    meta = torch.device("meta")
    tensors = {
        slot: [torch.empty(tuple(v.shape), dtype=_reg.np_dtype(v.dtype),
                           device=meta) for v in vals]
        for slot, vals in ins.items()}
    ctx = _reg.LoweringContext(rng=lambda: prng.PRNGKey(0, device=meta),
                               eager=False, device=meta)
    with torch.no_grad():
        out_vals = _reg.execute(ctx, op_type, tensors, dict(attrs))
    outs: Dict[str, List[AbstractVar]] = {}
    for slot, vals in out_vals.items():
        avs = []
        for v in (vals if isinstance(vals, (list, tuple)) else [vals]):
            shape = tuple(int(d) for d in getattr(v, "shape", ()))
            avs.append(AbstractVar(shape, _canon_dtype(
                getattr(v, "dtype", None))))
        outs[slot] = avs
    return outs


def _grad_mirror(op, ins: Dict[str, List[AbstractVar]]
                 ) -> Dict[str, List[AbstractVar]]:
    """Shape rule shared by every well-formed grad op: ``<Slot>@GRAD``
    outputs mirror the forward's ``<Slot>`` inputs (the default grad
    maker wires forward inputs into the grad op, so they are in
    ``ins``)."""
    from ..ops.registry import GRAD_SLOT_SUFFIX
    outs: Dict[str, List[AbstractVar]] = {}
    for slot in op.outputs:
        if slot.endswith(GRAD_SLOT_SUFFIX):
            base = slot[:-len(GRAD_SLOT_SUFFIX)]
            if base in ins:
                outs[slot] = list(ins[base])
    return outs


def _format_ins(ins: Dict[str, List[AbstractVar]]) -> str:
    parts = []
    for slot, vals in sorted(ins.items()):
        parts.append(f"{slot}=[{', '.join(str(v) for v in vals)}]")
    return "; ".join(parts)


# ---------------------------------------------------------------------------
# the interpreter
# ---------------------------------------------------------------------------


class _Interpreter:
    """One probe run over a program. ``probe`` substitutes every ``-1``
    dim in the seeded state/feed shapes with a concrete value."""

    def __init__(self, program: Program,
                 feeds: Mapping[str, AbstractVar],
                 probe: int, collect: bool = True,
                 memo: Optional[Dict[Any, Dict[str, List[AbstractVar]]]]
                 = None):
        self.program = program
        self.feeds = dict(feeds)
        self.probe = int(probe)
        self.collect = collect          # False: silent second-probe run
        self.diagnostics: List[Diagnostic] = []
        self.var_shapes: Dict[Tuple[int, str], AbstractVar] = {}
        self.unknown_ops: List[Tuple[str, int, int]] = []
        self.ops_inferred = 0
        # (op type, input AbstractVars, attrs) -> the lowering's outputs:
        # a lowering's shapes depend on nothing else, and a program
        # repeats its layers (the reference's eval_shape has no memo)
        self.memo = {} if memo is None else memo
        self.saw_dynamic = False
        self._env_stack: List[Dict[str, AbstractVar]] = []
        self._block_stack: List[int] = []

    # -- environment -------------------------------------------------------
    def _probe_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        out = []
        for d in shape:
            if d < 0:
                self.saw_dynamic = True
                out.append(self.probe)
            else:
                out.append(int(d))
        return tuple(out)

    def _state_abstract(self, block: Block, name: str) -> AbstractVar:
        """Seed value for a name with no in-scope producer: explicit
        feed shape, else the declared shape of a data/persistable/
        parameter var on the scope chain, else unknown."""
        fed = self.feeds.get(name)
        if fed is not None and (fed.shape is not None
                                or fed.dtype is not None):
            if fed.shape is None:
                return fed
            return AbstractVar(self._probe_shape(fed.shape), fed.dtype)
        # a bare-name feed (shape withheld, e.g. the executor's "these
        # names are externally provided" set) defers to the declaration
        seen: Set[int] = set()
        blk: Optional[Block] = block
        while blk is not None and blk.idx not in seen:
            seen.add(blk.idx)
            v = blk.vars.get(name)
            if v is not None:
                # A producer-less name's declaration is the only shape
                # information there is (data/persistable/parameter vars,
                # tape-recorded constants) — seed from it; whether a
                # producer SHOULD exist is dataflow.def-before-use's
                # complaint, not ours.
                if v.shape is None:
                    return _UNKNOWN
                return AbstractVar(self._probe_shape(v.shape),
                                   _canon_dtype(v.dtype))
            p = blk.parent_idx
            blk = (self.program.blocks[p]
                   if 0 <= p < len(self.program.blocks) else None)
        return _UNKNOWN

    def _lookup(self, block: Block, name: str) -> AbstractVar:
        for env in reversed(self._env_stack):
            if name in env:
                return env[name]
        return self._state_abstract(block, name)

    # -- diagnostics -------------------------------------------------------
    def _diag(self, severity: str, check: str, message: str,
              block: Block, op_idx: Optional[int] = None,
              var: Optional[str] = None):
        if self.collect:
            self.diagnostics.append(Diagnostic(
                severity, check, message, block_idx=block.idx,
                op_idx=op_idx, var=var))

    # -- execution ---------------------------------------------------------
    def run(self):
        self.run_block(0, {})
        return self

    def run_block(self, idx: int,
                  seed: Dict[str, AbstractVar]) -> Dict[str, AbstractVar]:
        if not 0 <= idx < len(self.program.blocks):
            return dict(seed)  # structural checks report this
        if idx in self._block_stack:
            return dict(seed)  # cyclic block graph: ditto
        block = self.program.blocks[idx]
        env = dict(seed)
        self._env_stack.append(env)
        self._block_stack.append(idx)
        try:
            for i, op in enumerate(block.ops):
                self._step(block, i, op, env)
        finally:
            self._env_stack.pop()
            self._block_stack.pop()
        return env

    def _step(self, block: Block, i: int, op: Operator,
              env: Dict[str, AbstractVar]):
        from ..ops import registry as _reg

        ins: Dict[str, List[AbstractVar]] = {}
        if isinstance(op.inputs, dict):
            for slot, names in op.inputs.items():
                if isinstance(names, (list, tuple)):
                    ins[slot] = [self._lookup(block, n) for n in names
                                 if isinstance(n, str)]

        d = _reg.declared(op.type)
        fw = (_reg.declared(op.type[:-5])
              if op.type.endswith("_grad") else None)
        outs: Optional[Dict[str, List[AbstractVar]]] = None
        try:
            if d is not None and d.infer is not None:
                outs = d.infer(InferContext(self, block, i, op), ins,
                               dict(op.attrs))
            elif (d is None and fw is not None
                  and (fw.infer is not None or fw.side_effect)):
                # grad of an op whose lowering can't run abstractly:
                # each <Slot>@GRAD output mirrors the forward input slot
                outs = _grad_mirror(op, ins)
            elif ((d is not None and not d.side_effect)
                  or (d is None and fw is not None
                      and not fw.side_effect)):
                if all(v.concrete for vals in ins.values() for v in vals):
                    key = _memo_key(op.type, ins, op.attrs)
                    outs = self.memo.get(key) if key is not None else None
                    if outs is None:
                        outs = abstract_eval_op(op.type, ins,
                                                dict(op.attrs))
                        if key is not None:
                            self.memo[key] = outs
                # else: some input unknown — propagate unknown silently
            elif d is not None and d.side_effect:
                pass  # side-effecting op with no rule: outputs unknown
            else:
                self.unknown_ops.append((op.type, block.idx, i))
                self._diag(
                    WARNING, "shapes.unknown-op",
                    f"op {op.type!r} has no infer rule and no "
                    f"registered lowering to derive shapes from; "
                    f"downstream shapes are unknown", block, i)
        except InferError as e:
            self._diag(ERROR, "shapes.infer",
                       f"op {op.type!r}: {e}", block, i)
        except Exception as e:  # a lowering's contract violation
            self._diag(
                ERROR, "shapes.infer",
                f"op {op.type!r} failed shape inference with inputs "
                f"({_format_ins(ins)}): {type(e).__name__}: {e}",
                block, i)
        else:
            if outs is not None:
                self.ops_inferred += 1

        if not isinstance(op.outputs, dict):
            return
        for slot, names in op.outputs.items():
            if not isinstance(names, (list, tuple)):
                continue
            vals = (outs or {}).get(slot, ())
            for j, name in enumerate(names):
                if not isinstance(name, str):
                    continue
                av = vals[j] if j < len(vals) else _UNKNOWN
                env[name] = av
                self.var_shapes[(block.idx, name)] = av
                self._check_declared(block, i, name, av)

    def _check_declared(self, block: Block, op_idx: int, name: str,
                        av: AbstractVar):
        """Declared var shapes are advisory (program.py docstring), so
        drift from the inferred shape is a WARNING: it usually means a
        layer builder's bookkeeping is wrong, not that execution will
        fail. Dims declared ``-1`` match anything; dtypes only flag
        when the *kind* differs (float/int/bool), since the port's
        int32 and the reference's x64 widths legitimately differ."""
        if not av.known:
            return
        v = None
        blk: Optional[Block] = block
        seen: Set[int] = set()
        while blk is not None and blk.idx not in seen:
            seen.add(blk.idx)
            v = blk.vars.get(name)
            if v is not None:
                break
            p = blk.parent_idx
            blk = (self.program.blocks[p]
                   if 0 <= p < len(self.program.blocks) else None)
        if v is None or v.shape is None:
            return
        decl = tuple(v.shape)
        bad = (len(decl) != len(av.shape)
               or any(dd >= 0 and di >= 0 and dd != di
                      for dd, di in zip(decl, av.shape)))
        if bad:
            self._diag(
                WARNING, "shapes.declared-mismatch",
                f"declared shape {list(decl)} disagrees with inferred "
                f"{av} for {name!r}", block, op_idx, var=name)
            return
        if v.dtype and av.dtype and _dtype_kind(v.dtype) != _dtype_kind(
                av.dtype):
            self._diag(
                WARNING, "shapes.declared-mismatch",
                f"declared dtype {v.dtype!r} disagrees with inferred "
                f"{av.dtype!r} for {name!r}", block, op_idx, var=name)


def _memo_key(op_type: str, ins: Dict[str, List[AbstractVar]],
              attrs: Dict[str, Any]):
    """A hashable key of one abstract run of a lowering, or None when an
    attr has no faithful text form."""
    import json

    def enc(o):
        if hasattr(o, "tolist"):
            return ["__array__", str(getattr(o, "dtype", "")), o.tolist()]
        raise TypeError(type(o).__name__)

    try:
        text = json.dumps(attrs, sort_keys=True, default=enc)
    except (TypeError, ValueError):
        return None
    return (op_type, tuple((slot, tuple(vals))
                           for slot, vals in sorted(ins.items())), text)


def _dtype_kind(name: str) -> str:
    if name.startswith(("float", "bfloat")) or name in ("half", "double"):
        return "float"
    if name == "bool":
        return "bool"
    if name.startswith(("int", "uint")):
        return "int"
    return name


# ---------------------------------------------------------------------------
# probe joining + entry point
# ---------------------------------------------------------------------------


def _join(a: AbstractVar, b: Optional[AbstractVar]) -> AbstractVar:
    if b is None or not (a.known and b.known):
        return a if a.known else (b or a)
    if a.dtype != b.dtype or len(a.shape) != len(b.shape):
        return _UNKNOWN
    shape = tuple(da if da == db else -1
                  for da, db in zip(a.shape, b.shape))
    return AbstractVar(shape, a.dtype)


def _normalize_feeds(feeds) -> Dict[str, AbstractVar]:
    """Accept the verifier's name iterable, a name -> (shape, dtype)
    mapping, or name -> AbstractVar."""
    out: Dict[str, AbstractVar] = {}
    if feeds is None:
        return out
    if isinstance(feeds, Mapping):
        for name, spec in feeds.items():
            if isinstance(spec, AbstractVar):
                out[name] = spec
            elif spec is None:
                out[name] = _UNKNOWN
            else:
                shape, dtype = spec
                out[name] = AbstractVar(
                    tuple(int(d) for d in shape) if shape is not None
                    else None,
                    _canon_dtype(dtype))
    else:
        # bare names: shapes come from the declared vars (data vars
        # always declare one), so an unknown placeholder suffices
        for name in feeds:
            out.setdefault(name, _UNKNOWN)
    return out


def interpret_program(program: Program, feeds=(),
                      batch_probes: Sequence[int] = (2, 4)
                      ) -> InterpretResult:
    """Abstractly interpret ``program`` and return the inferred
    shape/dtype for every var plus structured diagnostics.

    ``feeds`` is either an iterable of externally-satisfied names (the
    ``verify_program`` convention — shapes then come from the declared
    vars) or a mapping ``name -> (shape, dtype)`` with authoritative
    feed shapes. ``batch_probes``: the two concrete substitutions used
    to classify ``-1`` dims (dims that differ between the probe runs
    are reported as dynamic)."""
    fd = _normalize_feeds(feeds)
    memo: Dict[Any, Dict[str, List[AbstractVar]]] = {}
    first = _Interpreter(program, fd, probe=batch_probes[0],
                         memo=memo).run()
    var_shapes = dict(first.var_shapes)
    if first.saw_dynamic and len(batch_probes) > 1:
        second = _Interpreter(program, fd, probe=batch_probes[1],
                              collect=False, memo=memo).run()
        var_shapes = {key: _join(av, second.var_shapes.get(key))
                      for key, av in first.var_shapes.items()}
    return InterpretResult(
        diagnostics=first.diagnostics,
        var_shapes=var_shapes,
        unknown_ops=first.unknown_ops,
        ops_inferred=first.ops_inferred)
