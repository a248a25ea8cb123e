"""Static analysis over the Program IR — the verifier pass suite; the
counterpart of ``paddle_tpu/framework/analysis.py``.

Analog of the checking the reference spreads across C++ ``InferShape`` /
``OpDesc::Check`` / ``PADDLE_ENFORCE`` call sites and the
``tools/check_op_desc.py`` CI guard: a malformed program (a pass that
dropped a producer op, a transcribed program reading an undefined var, a
grad op violating the registry contract) is reported HERE as a
structured :class:`Diagnostic` — severity, block idx, op idx, var name,
message — instead of surfacing as an opaque error deep inside the
executor, or under a CUDA-graph capture on the card.

Three check families, run in order:

- **structural**: every op type has a lowering (directly registered, or
  derivable as ``<fw>_grad``), slot values are lists of variable-name
  strings, sub-block attrs reference valid block indices with no cycles,
  block parent chains terminate, and var dtypes pass ``convert_dtype``.
- **dataflow**: topological def-before-use per block (honoring
  parent-block definitions, feeds, and persistable/scope state; nested
  control-flow reads attributed via ``block_reads_writes``),
  write-after-write hazards (a value overwritten before anyone read it),
  and — when fetch targets are known — dead ops/vars.
- **gradient**: for programs after ``append_backward``, every ``@GRAD``
  var pairs with a forward var, and grad ops respect the registry's
  ``no_grad_slots`` / ``grad_needs_outputs`` contract.

Entry points: :func:`verify_program` (or the ``Program.verify()``
façade). Integration layers live elsewhere: ``PassManager.apply``
verifies after each IR pass under ``FLAGS_check_ir_passes`` (the error
names the offending pass), and the executor verifies once per program at
its first run of the program under ``FLAGS_check_program`` (a
``CompiledProgram`` runs through the same door).
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Set

from .program import (GRAD_SUFFIX, Block, Operator, Program, convert_dtype,
                      op_sub_block_indices)

ERROR = "error"
WARNING = "warning"

# Ops that are kept by dead-code analysis even when nothing consumes
# their outputs: their effect is external to the dataflow graph
# (collectives, PS pushes, host prints, barriers). The op registry's
# ``side_effect`` OpDef field is the authoritative source
# (ops/collective_ops.py, ops/ps_ops.py mark themselves); these static
# sets are the fallback for ops the registry doesn't know — audited
# against those modules so communication ops are never marked dead.
SIDE_EFFECT_OP_PREFIXES = ("c_", "send", "recv", "print")
SIDE_EFFECT_OP_TYPES = frozenset({
    "print", "send", "recv", "push_sparse", "push_dense",
    "optimization_barrier", "fetch_barrier", "send_barrier",
    # bare-named collectives (no "c_" prefix to catch them)
    "barrier", "allreduce", "partial_allgather",
    # PS table traffic: the pull mutates host parameter-server state on
    # trace; the grad op's only output is a non-persistable @PUSH token
    # that nothing reads — without this entry dead-code would drop the
    # gradient push itself
    "distributed_lookup_table", "distributed_lookup_table_grad",
})


@dataclasses.dataclass
class Diagnostic:
    """One verifier finding. ``op_idx``/``var`` are None when the finding
    is not attached to a specific op/var (e.g. a cyclic block graph)."""

    severity: str            # ERROR | WARNING
    check: str               # e.g. "dataflow.def-before-use"
    message: str
    block_idx: int = 0
    op_idx: Optional[int] = None
    var: Optional[str] = None
    # Stamped by the PassManager integration so a failure names the
    # IR pass that introduced it.
    pass_name: Optional[str] = None

    def location(self) -> str:
        loc = f"block {self.block_idx}"
        if self.op_idx is not None:
            loc += f" op {self.op_idx}"
        if self.var is not None:
            loc += f" var {self.var!r}"
        return loc

    def __str__(self):
        head = f"{self.severity}[{self.check}]"
        if self.pass_name:
            head += f" after pass {self.pass_name!r}"
        return f"{head} {self.location()}: {self.message}"


class VerifyResult:
    """Ordered collection of diagnostics from one verifier run."""

    def __init__(self, diagnostics: Iterable[Diagnostic] = ()):
        self.diagnostics: List[Diagnostic] = list(diagnostics)

    @property
    def errors(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == ERROR]

    @property
    def warnings(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == WARNING]

    def ok(self) -> bool:
        return not self.errors

    def __iter__(self):
        return iter(self.diagnostics)

    def __len__(self):
        return len(self.diagnostics)

    def summary(self) -> str:
        if not self.diagnostics:
            return "program verifies clean"
        lines = [f"{len(self.errors)} error(s), "
                 f"{len(self.warnings)} warning(s):"]
        lines += [f"  {d}" for d in self.diagnostics]
        return "\n".join(lines)

    def raise_if_errors(self, context: str = ""):
        if self.errors:
            prefix = f"{context}: " if context else ""
            raise ProgramVerifyError(
                f"{prefix}program verification failed — {self.summary()}",
                self)
        return self

    def __repr__(self):
        return (f"VerifyResult(errors={len(self.errors)}, "
                f"warnings={len(self.warnings)})")


class ProgramVerifyError(RuntimeError):
    """Raised when verification finds ERROR diagnostics; carries the full
    structured result as ``.result``."""

    def __init__(self, msg: str, result: VerifyResult):
        super().__init__(msg)
        self.result = result


# ---------------------------------------------------------------------------
# Check registry (one entry per pass of the suite; the `checks=`
# selector reads it)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CheckDef:
    name: str                # "<family>.<check>"
    description: str
    fn: Callable[["_Context"], Iterable[Diagnostic]]


ANALYSIS_CHECKS: "OrderedDict[str, CheckDef]" = OrderedDict()


def _register_check(name: str, description: str):
    def deco(fn):
        ANALYSIS_CHECKS[name] = CheckDef(name, description, fn)
        return fn
    return deco


class _Context:
    """Shared state threaded through the checks of one run."""

    def __init__(self, program: Program, feeds: Sequence[str],
                 fetches: Optional[Sequence[str]]):
        self.program = program
        self.feeds = set(feeds or ())
        self.fetches = list(fetches) if fetches is not None else None
        # set by structural.sub-blocks; dataflow recursion into nested
        # blocks is only safe when the block graph checked out
        self.blocks_ok = True
        # set by verify_program when the caller explicitly selected
        # "shapes.infer" — the shape pass then runs even with
        # FLAGS_check_shapes off (it is costly: dual abstract runs)
        self.shapes_requested = False

    # -- helpers shared by checks ------------------------------------------
    def valid_sub_indices(self, op: Operator, block: Block) -> List[int]:
        """Sub-block indices of ``op`` that are in range and not the op's
        own block (the invalid ones are reported by structural checks)."""
        try:
            idxs = op_sub_block_indices(op)
        except (TypeError, ValueError):
            return []
        n = len(self.program.blocks)
        return [i for i in idxs if 0 <= i < n and i != block.idx]

    def scope_chain_var(self, block: Block, name: str):
        """Variable for ``name`` found by walking the parent chain
        (guarded against corrupted parent links)."""
        seen = set()
        blk: Optional[Block] = block
        while blk is not None and blk.idx not in seen:
            seen.add(blk.idx)
            if name in blk.vars:
                return blk.vars[name]
            p = blk.parent_idx
            blk = (self.program.blocks[p]
                   if 0 <= p < len(self.program.blocks) else None)
        return None

    def is_state(self, block: Block, name: str) -> bool:
        """True when ``name`` is satisfied without an in-block producer:
        fed at runtime, or declared data/persistable/parameter anywhere
        on the scope chain."""
        if name in self.feeds:
            return True
        v = self.scope_chain_var(block, name)
        return v is not None and (v.is_data or v.persistable
                                  or v.is_parameter)

    def ancestor_produced(self, block: Block) -> Set[str]:
        """Names produced by ANY op in an ancestor block. Position within
        the ancestor is deliberately ignored (the invocation point of a
        sub-block is not tracked in the IR) — over-permissive, so nested
        blocks never false-positive; the ancestor's own def-before-use
        pass still catches ordering bugs at that level."""
        names: Set[str] = set()
        seen = {block.idx}
        p = block.parent_idx
        while 0 <= p < len(self.program.blocks) and p not in seen:
            seen.add(p)
            parent = self.program.blocks[p]
            for op in parent.ops:
                names.update(op.output_names())
            p = parent.parent_idx
        return names

    def block_external_reads(self, idx: int) -> List[str]:
        """``block_reads_writes`` external-read attribution, guarded:
        only called when the sub-block graph verified acyclic."""
        from .program import block_reads_writes
        reads, _ = block_reads_writes(self.program, idx)
        return reads


# ---------------------------------------------------------------------------
# structural checks
# ---------------------------------------------------------------------------


@_register_check(
    "structural.registered-ops",
    "every op type has a registered lowering, or derives one as "
    "`<fw>_grad` of a registered forward op")
def _check_registered_ops(ctx: _Context):
    from ..ops import registry as _reg
    for block in ctx.program.blocks:
        for i, op in enumerate(block.ops):
            t = op.type
            if _reg.declared(t) is not None:
                continue
            if t.endswith("_grad") and _reg.declared(t[:-5]) is not None:
                continue  # vjp-derived grad lowering (registry.execute)
            yield Diagnostic(
                ERROR, "structural.registered-ops",
                f"op type {t!r} has no registered lowering and no "
                f"registered forward op to derive one from",
                block_idx=block.idx, op_idx=i)


@_register_check(
    "structural.slot-shape",
    "op input/output slots map slot names to lists of variable-name "
    "strings")
def _check_slot_shape(ctx: _Context):
    for block in ctx.program.blocks:
        for i, op in enumerate(block.ops):
            for kind, slots in (("input", op.inputs),
                                ("output", op.outputs)):
                if not isinstance(slots, dict):
                    yield Diagnostic(
                        ERROR, "structural.slot-shape",
                        f"op {op.type!r} {kind}s is "
                        f"{type(slots).__name__}, expected dict",
                        block_idx=block.idx, op_idx=i)
                    continue
                for slot, names in slots.items():
                    if not isinstance(names, (list, tuple)):
                        yield Diagnostic(
                            ERROR, "structural.slot-shape",
                            f"op {op.type!r} {kind} slot {slot!r} is "
                            f"{type(names).__name__}, expected a list "
                            f"of var names",
                            block_idx=block.idx, op_idx=i)
                        continue
                    for n in names:
                        if not isinstance(n, str) or not n:
                            yield Diagnostic(
                                ERROR, "structural.slot-shape",
                                f"op {op.type!r} {kind} slot {slot!r} "
                                f"holds {n!r}, expected a non-empty "
                                f"var-name string",
                                block_idx=block.idx, op_idx=i)


@_register_check(
    "structural.sub-blocks",
    "sub_block-style attrs reference valid block indices, parent chains "
    "terminate, and the block-reference graph is acyclic")
def _check_sub_blocks(ctx: _Context):
    program = ctx.program
    nblocks = len(program.blocks)
    edges: Dict[int, Set[int]] = {b.idx: set() for b in program.blocks}

    for block in program.blocks:
        # parent chain must terminate at -1 without revisiting a block
        seen: Set[int] = set()
        blk = block
        while blk.parent_idx >= 0:
            if blk.parent_idx >= nblocks:
                ctx.blocks_ok = False
                yield Diagnostic(
                    ERROR, "structural.sub-blocks",
                    f"block {blk.idx} parent_idx {blk.parent_idx} is out "
                    f"of range ({nblocks} blocks)",
                    block_idx=block.idx)
                break
            if blk.idx in seen:
                ctx.blocks_ok = False
                yield Diagnostic(
                    ERROR, "structural.sub-blocks",
                    f"block parent chain starting at block {block.idx} "
                    f"is cyclic", block_idx=block.idx)
                break
            seen.add(blk.idx)
            blk = program.blocks[blk.parent_idx]

        for i, op in enumerate(block.ops):
            try:
                idxs = op_sub_block_indices(op)
            except (TypeError, ValueError) as e:
                ctx.blocks_ok = False
                yield Diagnostic(
                    ERROR, "structural.sub-blocks",
                    f"op {op.type!r} has a malformed sub-block attr: {e}",
                    block_idx=block.idx, op_idx=i)
                continue
            for si in idxs:
                if not 0 <= si < nblocks:
                    ctx.blocks_ok = False
                    yield Diagnostic(
                        ERROR, "structural.sub-blocks",
                        f"op {op.type!r} references sub-block {si}, but "
                        f"the program has {nblocks} blocks",
                        block_idx=block.idx, op_idx=i)
                elif si == block.idx:
                    ctx.blocks_ok = False
                    yield Diagnostic(
                        ERROR, "structural.sub-blocks",
                        f"op {op.type!r} references its own block {si} "
                        f"as a sub-block", block_idx=block.idx, op_idx=i)
                else:
                    edges[block.idx].add(si)

    # cycle detection over the (valid) block-reference graph
    WHITE, GRAY, BLACK = 0, 1, 2
    color = {idx: WHITE for idx in edges}

    def has_cycle(u: int) -> bool:
        color[u] = GRAY
        for v in edges[u]:
            if color[v] == GRAY:
                return True
            if color[v] == WHITE and has_cycle(v):
                return True
        color[u] = BLACK
        return False

    for idx in edges:
        if color[idx] == WHITE and has_cycle(idx):
            ctx.blocks_ok = False
            yield Diagnostic(
                ERROR, "structural.sub-blocks",
                f"sub-block reference graph is cyclic (reachable from "
                f"block {idx})", block_idx=idx)
            break


@_register_check(
    "structural.dtypes",
    "every declared variable's dtype normalizes through `convert_dtype`")
def _check_dtypes(ctx: _Context):
    for block in ctx.program.blocks:
        for v in block.vars.values():
            try:
                convert_dtype(v.dtype)
            except (ValueError, TypeError) as e:
                yield Diagnostic(
                    ERROR, "structural.dtypes",
                    f"variable {v.name!r} has invalid dtype "
                    f"{v.dtype!r}: {e}",
                    block_idx=block.idx, var=v.name)


# ---------------------------------------------------------------------------
# dataflow checks
# ---------------------------------------------------------------------------


def _op_reads(ctx: _Context, block: Block, op: Operator) -> List[str]:
    """Effective reads of an op: direct inputs plus — when the block
    graph is sound — the external reads of its nested sub-blocks."""
    reads = list(op.input_names())
    if ctx.blocks_ok:
        for si in ctx.valid_sub_indices(op, block):
            reads.extend(ctx.block_external_reads(si))
    return reads


@_register_check(
    "dataflow.def-before-use",
    "every op input is produced by a prior op, declared as feed/"
    "persistable state, or defined in an ancestor block "
    "(nested-block reads attributed via `block_reads_writes`)")
def _check_def_before_use(ctx: _Context):
    for block in ctx.program.blocks:
        defined: Set[str] = set()
        if ctx.blocks_ok:
            defined |= ctx.ancestor_produced(block)
        reported: Set[str] = set()
        for i, op in enumerate(block.ops):
            for n in _op_reads(ctx, block, op):
                if n in defined or n in reported:
                    continue
                if ctx.is_state(block, n):
                    continue
                reported.add(n)
                v = ctx.scope_chain_var(block, n)
                why = ("declared but never produced and not "
                       "feed/persistable" if v is not None
                       else "never declared or produced")
                yield Diagnostic(
                    ERROR, "dataflow.def-before-use",
                    f"op {op.type!r} reads {n!r} before definition "
                    f"({why})",
                    block_idx=block.idx, op_idx=i, var=n)
            defined.update(op.output_names())


@_register_check(
    "dataflow.write-after-write",
    "a var overwritten before any op read the previous value (the first "
    "write is dead — usually a pass dropped or reordered a consumer)")
def _check_write_after_write(ctx: _Context):
    for block in ctx.program.blocks:
        last_write: Dict[str, int] = {}
        read_since: Set[str] = set()
        for i, op in enumerate(block.ops):
            for n in _op_reads(ctx, block, op):
                read_since.add(n)
            for n in op.output_names():
                if n in last_write and n not in read_since:
                    yield Diagnostic(
                        WARNING, "dataflow.write-after-write",
                        f"op {op.type!r} overwrites {n!r} written by op "
                        f"{last_write[n]} with no read in between",
                        block_idx=block.idx, op_idx=i, var=n)
                last_write[n] = i
                read_since.discard(n)


def _has_side_effects(op: Operator) -> bool:
    t = op.type
    if (t in SIDE_EFFECT_OP_TYPES
            or any(t.startswith(p) for p in SIDE_EFFECT_OP_PREFIXES)
            or not op.outputs):
        return True
    # registry-declared effects; a <fw>_grad of a side-effecting forward
    # inherits it (the default grad maker re-runs the forward's channel)
    from ..ops import registry as _reg
    d = _reg.declared(t)
    if d is not None and d.side_effect:
        return True
    if t.endswith("_grad"):
        fw = _reg.declared(t[:-5])
        return fw is not None and fw.side_effect
    return False


@_register_check(
    "dataflow.dead-code",
    "ops whose outputs are never consumed and vars never read — skipped "
    "unless fetch targets are supplied (the executor passes its fetch "
    "list; `Program.verify(fetches=...)` to run it standalone)")
def _check_dead_code(ctx: _Context):
    if ctx.fetches is None:
        return
    program = ctx.program
    block = program.global_block()
    needed: Set[str] = set(ctx.fetches)
    live_ops: Set[int] = set()
    for i in range(len(block.ops) - 1, -1, -1):
        op = block.ops[i]
        keep = _has_side_effects(op)
        if not keep:
            for n in op.output_names():
                if n in needed:
                    keep = True
                    break
                v = ctx.scope_chain_var(block, n)
                if v is not None and v.persistable:
                    keep = True  # state write-back (optimizer updates…)
                    break
        if not keep:
            continue
        live_ops.add(i)
        needed.update(_op_reads(ctx, block, op))
    for i, op in enumerate(block.ops):
        if i not in live_ops:
            yield Diagnostic(
                WARNING, "dataflow.dead-code",
                f"op {op.type!r} is dead: no output reaches a fetch "
                f"target, persistable var, or side effect",
                block_idx=block.idx, op_idx=i)

    # dead vars: declared, never read anywhere, not state, not fetched.
    # Outputs of live ops are exempt: an op stays live when ANY of its
    # outputs is consumed, and its remaining slots (LSTM cell state,
    # reshape's XShape, accuracy counters…) are mandatory byproducts,
    # not dead declarations.
    read_anywhere: Set[str] = set()
    produced_by_live: Set[str] = set()
    for b in program.blocks:
        for j, op in enumerate(b.ops):
            read_anywhere.update(op.input_names())
            if b.idx != block.idx or j in live_ops:
                produced_by_live.update(op.output_names())
    for b in program.blocks:
        for v in b.vars.values():
            if (v.name not in read_anywhere
                    and v.name not in needed
                    and v.name not in produced_by_live
                    and not (v.persistable or v.is_data
                             or v.is_parameter)):
                yield Diagnostic(
                    WARNING, "dataflow.dead-code",
                    f"variable {v.name!r} is declared but never read, "
                    f"fetched, or persisted",
                    block_idx=b.idx, var=v.name)


# ---------------------------------------------------------------------------
# gradient-contract checks
# ---------------------------------------------------------------------------


def _grad_base_name(name: str) -> Optional[str]:
    """``x@GRAD``/``x@GRAD@RENAME@1``/``x@GRAD@ACC`` -> ``x``."""
    if GRAD_SUFFIX not in name:
        return None
    return name.split(GRAD_SUFFIX, 1)[0]


@_register_check(
    "gradient.grad-pairing",
    "every `@GRAD` var (incl. `@RENAME@k`/`@ACC` accumulation names) "
    "pairs with a forward var that exists in the program")
def _check_grad_pairing(ctx: _Context):
    program = ctx.program
    produced: Set[str] = set()
    for b in program.blocks:  # names produced anywhere
        for op in b.ops:
            produced.update(op.output_names())
    reported: Set[tuple] = set()
    for block in program.blocks:
        for i, op in enumerate(block.ops):
            for n in op.input_names() + op.output_names():
                base = _grad_base_name(n)
                if base is None or not base or (block.idx, n) in reported:
                    continue
                if base in produced or base in ctx.feeds:
                    continue
                if ctx.scope_chain_var(block, base) is not None:
                    continue
                reported.add((block.idx, n))
                yield Diagnostic(
                    ERROR, "gradient.grad-pairing",
                    f"grad var {n!r} pairs with forward var {base!r}, "
                    f"which does not exist in the program",
                    block_idx=block.idx, op_idx=i, var=n)


@_register_check(
    "gradient.registry-contract",
    "default-maker grad ops respect the registry: no `<slot>@GRAD` "
    "output for a `no_grad_slots` slot; `grad_needs_outputs` forward "
    "values are wired as inputs")
def _check_registry_contract(ctx: _Context):
    from ..ops import registry as _reg
    for block in ctx.program.blocks:
        for i, op in enumerate(block.ops):
            if not op.type.endswith("_grad"):
                continue
            d = _reg.declared(op.type[:-5])
            if d is None:
                continue
            fw_type = op.type[:-5]
            if d.custom_grad_maker is not None:
                continue  # custom wiring owns its own contract
            for slot in d.no_grad_slots:
                gslot = f"{slot}{_reg.GRAD_SLOT_SUFFIX}"
                if op.outputs.get(gslot):
                    yield Diagnostic(
                        ERROR, "gradient.registry-contract",
                        f"grad op {op.type!r} emits {gslot!r}, but slot "
                        f"{slot!r} is in no_grad_slots for {fw_type!r}",
                        block_idx=block.idx, op_idx=i,
                        var=op.outputs[gslot][0])
            for slot in d.grad_needs_outputs:
                if slot not in op.inputs:
                    yield Diagnostic(
                        WARNING, "gradient.registry-contract",
                        f"grad op {op.type!r} is missing forward output "
                        f"slot {slot!r} listed in grad_needs_outputs "
                        f"for {fw_type!r}",
                        block_idx=block.idx, op_idx=i)


# ---------------------------------------------------------------------------
# shape/dtype inference (abstract interpretation)
# ---------------------------------------------------------------------------


@_register_check(
    "shapes.infer",
    "static shape/dtype inference by abstract interpretation "
    "(`paddle_tpu_torch/analysis/`): per-op infer rules + the registered "
    "lowerings run on meta tensors, recursing into control-flow "
    "sub-blocks — "
    "gated behind `FLAGS_check_shapes` (or select the check explicitly) "
    "because it abstractly executes the whole program")
def _check_shapes(ctx: _Context):
    from .. import flags as _flags
    if not (_flags.get_flag("check_shapes") or ctx.shapes_requested):
        return
    if not ctx.blocks_ok:
        return  # structural checks already reported the block graph
    from ..analysis.abstract_interp import interpret_program
    result = interpret_program(ctx.program, feeds=ctx.feeds)
    for d in result.diagnostics:
        yield d


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------


def verify_program(program: Program, feeds: Sequence[str] = (),
                   fetches: Optional[Sequence[str]] = None,
                   checks: Optional[Sequence[str]] = None) -> VerifyResult:
    """Run the analysis suite over ``program``.

    ``feeds``: names satisfied externally at run time (feed dict keys,
    scope contents); vars declared ``is_data``/persistable/parameter are
    always treated as satisfied. ``fetches``: fetch-target names —
    enables the dead-code check (skipped when None, since any var could
    be a legitimate fetch). ``checks``: optional subset of check names
    (default: all of ``ANALYSIS_CHECKS``).
    """
    ctx = _Context(program, feeds, fetches)
    ctx.shapes_requested = checks is not None and "shapes.infer" in checks
    selected = (list(ANALYSIS_CHECKS) if checks is None else list(checks))
    unknown = [c for c in selected if c not in ANALYSIS_CHECKS]
    if unknown:
        raise ValueError(
            f"unknown verifier check(s) {unknown}; available: "
            f"{sorted(ANALYSIS_CHECKS)}")
    diags: List[Diagnostic] = []
    for name in selected:
        diags.extend(ANALYSIS_CHECKS[name].fn(ctx))
    return VerifyResult(diags)


__all__ = [
    "ANALYSIS_CHECKS", "CheckDef", "Diagnostic", "ERROR", "WARNING",
    "ProgramVerifyError", "VerifyResult", "verify_program",
]
