"""Program IR — the static-graph intermediate representation; the
counterpart of ``paddle_tpu/framework/program.py``, ported whole.

``Program`` / ``Block`` / ``Operator`` / ``Variable`` with attrs, nested
blocks and persistable parameters; JSON (de)serialization with the
reference's schema, dtype strings (``"int64"`` stays ``"int64"``) and
per-op versions, so a program saved by either package loads in the
other and its JSON is the reference's character for character;
``clone(for_test)``, ``_prune``, ``fingerprint``, ``device_guard``,
``program_guard`` and the default programs.

The executor (:mod:`.executor`) runs block 0 op by op through the op
registry, eagerly or as a replayed CUDA graph keyed by the program's
version, the feeds' shapes and dtypes and the fetch set; shapes on
Variables are advisory, as in the reference. ``Program.verify`` waits
for the port of ``framework/analysis.py`` (ROADMAP A7.3).
"""

from __future__ import annotations

import contextlib
import copy
import hashlib
import json
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from . import unique_name

# Version tag for the serialized IR schema.
IR_VERSION = 1

# Canonical dtype names (analog of framework.proto VarType dtypes).
_DTYPE_ALIASES = {
    "float32": "float32", "fp32": "float32", "f32": "float32",
    "float64": "float64", "fp64": "float64", "double": "float64",
    "float16": "float16", "fp16": "float16", "half": "float16",
    "bfloat16": "bfloat16", "bf16": "bfloat16",
    "int8": "int8", "uint8": "uint8", "int16": "int16",
    "int32": "int32", "int64": "int64", "bool": "bool",
}


def convert_dtype(dtype) -> str:
    """Normalize a dtype spec (str / np.dtype / torch dtype) to canonical
    name."""
    if dtype is None:
        return "float32"
    if isinstance(dtype, torch.dtype):
        dtype = str(dtype).replace("torch.", "")
    if isinstance(dtype, str):
        key = dtype.lower()
        if key in _DTYPE_ALIASES:
            return _DTYPE_ALIASES[key]
        raise ValueError(f"unsupported dtype string: {dtype!r}")
    name = np.dtype(dtype).name if not hasattr(dtype, "name") else dtype.name
    if name in _DTYPE_ALIASES:
        return _DTYPE_ALIASES[name]
    raise ValueError(f"unsupported dtype: {dtype!r}")


class Variable:
    """A named tensor slot in a Block.

    Analog of VarDesc (framework.proto:104-170) + python Variable
    (python/paddle/fluid/framework.py:889). ``shape`` may contain -1 for
    dims unknown until feed time; the executor specializes on real shapes.
    """

    def __init__(
        self,
        block: "Block",
        name: str,
        shape: Optional[Sequence[int]] = None,
        dtype: Any = "float32",
        persistable: bool = False,
        stop_gradient: bool = False,
        is_data: bool = False,
        trainable: bool = True,
        is_parameter: bool = False,
    ):
        self.block = block
        self.name = name
        self.shape = tuple(int(d) for d in shape) if shape is not None else None
        self.dtype = convert_dtype(dtype)
        self.persistable = persistable
        self.stop_gradient = stop_gradient
        self.is_data = is_data
        self.trainable = trainable
        self.is_parameter = is_parameter
        # Optional initializer spec consumed by startup-program builders:
        # dict like {"type": "gaussian_random", "attrs": {...}}.
        self.initializer: Optional[dict] = None
        # Regularizer spec consumed by Optimizer: ("l2", coeff) / ("l1", coeff)
        self.regularizer = None

    # -- convenience -------------------------------------------------------
    @property
    def ndim(self) -> Optional[int]:
        return None if self.shape is None else len(self.shape)

    def numel(self) -> Optional[int]:
        if self.shape is None or any(d < 0 for d in self.shape):
            return None
        return int(np.prod(self.shape)) if self.shape else 1

    def grad_name(self) -> str:
        return grad_var_name(self.name)

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "shape": list(self.shape) if self.shape is not None else None,
            "dtype": self.dtype,
            "persistable": self.persistable,
            "stop_gradient": self.stop_gradient,
            "is_data": self.is_data,
            "trainable": self.trainable,
            "is_parameter": self.is_parameter,
            "initializer": self.initializer,
            "regularizer": list(self.regularizer) if self.regularizer else None,
        }

    @staticmethod
    def from_dict(block: "Block", d: dict) -> "Variable":
        v = Variable(
            block,
            d["name"],
            shape=d.get("shape"),
            dtype=d.get("dtype", "float32"),
            persistable=d.get("persistable", False),
            stop_gradient=d.get("stop_gradient", False),
            is_data=d.get("is_data", False),
            trainable=d.get("trainable", True),
            is_parameter=d.get("is_parameter", False),
        )
        v.initializer = d.get("initializer")
        reg = d.get("regularizer")
        v.regularizer = tuple(reg) if reg else None
        return v

    def __repr__(self):
        return (f"Variable(name={self.name!r}, shape={self.shape}, "
                f"dtype={self.dtype}, persistable={self.persistable})")


GRAD_SUFFIX = "@GRAD"


def grad_var_name(name: str) -> str:
    return name + GRAD_SUFFIX


class Operator:
    """One op in a Block.

    Analog of OpDesc (framework.proto:42-72; op_desc.cc). ``inputs`` and
    ``outputs`` map slot names (e.g. "X", "Out") to lists of variable names.
    ``attrs`` are JSON-serializable python values; sub-block references are
    stored as integer block indices under attr names ending in "_block".
    """

    def __init__(
        self,
        block: "Block",
        type: str,  # noqa: A002 - matches reference naming
        inputs: Optional[Dict[str, Any]] = None,
        outputs: Optional[Dict[str, Any]] = None,
        attrs: Optional[Dict[str, Any]] = None,
    ):
        self.block = block
        self.type = type
        self.inputs = {k: _as_name_list(v) for k, v in (inputs or {}).items()}
        self.outputs = {k: _as_name_list(v) for k, v in (outputs or {}).items()}
        self.attrs = dict(attrs or {})

    def input_names(self) -> List[str]:
        return [n for vs in self.inputs.values() for n in vs]

    def output_names(self) -> List[str]:
        return [n for vs in self.outputs.values() for n in vs]

    def input(self, slot: str) -> List[str]:
        return self.inputs.get(slot, [])

    def output(self, slot: str) -> List[str]:
        return self.outputs.get(slot, [])

    def attr(self, name: str, default=None):
        return self.attrs.get(name, default)

    def to_dict(self) -> dict:
        return {
            "type": self.type,
            "inputs": {k: list(v) for k, v in self.inputs.items()},
            "outputs": {k: list(v) for k, v in self.outputs.items()},
            "attrs": _jsonable_attrs(self.attrs),
        }

    @staticmethod
    def from_dict(block: "Block", d: dict) -> "Operator":
        attrs = {}
        for k, v in d["attrs"].items():
            if isinstance(v, dict) and "__ndarray__" in v:
                attrs[k] = np.asarray(v["__ndarray__"], dtype=v["dtype"])
            else:
                attrs[k] = v
        return Operator(block, d["type"], d["inputs"], d["outputs"], attrs)

    def __repr__(self):
        return f"Operator({self.type}, in={self.inputs}, out={self.outputs})"


def _as_name_list(v) -> List[str]:
    if v is None:
        return []
    if isinstance(v, Variable):
        return [v.name]
    if isinstance(v, str):
        return [v]
    return [x.name if isinstance(x, Variable) else str(x) for x in v]


def _jsonable_attrs(attrs: dict) -> dict:
    out = {}
    for k, v in attrs.items():
        if isinstance(v, np.ndarray):
            out[k] = {"__ndarray__": v.tolist(), "dtype": str(v.dtype)}
        elif isinstance(v, (np.integer,)):
            out[k] = int(v)
        elif isinstance(v, (np.floating,)):
            out[k] = float(v)
        else:
            out[k] = v
    return out


class Block:
    """An ordered list of ops plus a symbol table of variables.

    Analog of BlockDesc (framework.proto:174-188). Nested blocks (while/cond
    bodies) reference their parent for symbol lookup.
    """

    def __init__(self, program: "Program", idx: int, parent_idx: int = -1):
        self.program = program
        self.idx = idx
        self.parent_idx = parent_idx
        self.vars: Dict[str, Variable] = {}
        self.ops: List[Operator] = []

    @property
    def parent_block(self) -> Optional["Block"]:
        if self.parent_idx < 0:
            return None
        return self.program.blocks[self.parent_idx]

    def create_var(self, name: Optional[str] = None, **kw) -> Variable:
        if name is None:
            name = unique_name.generate("tmp")
        if name in self.vars:
            return self.vars[name]
        v = Variable(self, name, **kw)
        self.vars[name] = v
        return v

    def create_parameter(self, name, shape, dtype="float32", trainable=True,
                         initializer=None, regularizer=None) -> Variable:
        v = self.create_var(
            name, shape=shape, dtype=dtype, persistable=True,
            stop_gradient=not trainable, trainable=trainable,
            is_parameter=True,
        )
        v.initializer = initializer
        v.regularizer = regularizer
        return v

    def var(self, name: str) -> Variable:
        """Look up a variable, searching ancestor blocks (scope chaining)."""
        blk: Optional[Block] = self
        while blk is not None:
            if name in blk.vars:
                return blk.vars[name]
            blk = blk.parent_block
        raise KeyError(f"variable {name!r} not found in block {self.idx}")

    def has_var(self, name: str) -> bool:
        try:
            self.var(name)
            return True
        except KeyError:
            return False

    def append_op(self, type: str, inputs=None, outputs=None, attrs=None) -> Operator:  # noqa: A002
        op = Operator(self, type, inputs, outputs, attrs)
        if _current_device_guard is not None and "op_device" not in op.attrs:
            op.attrs["op_device"] = _current_device_guard
        self.ops.append(op)
        self.program.bump_version()
        return op

    def prepend_op(self, type: str, inputs=None, outputs=None, attrs=None) -> Operator:  # noqa: A002
        op = Operator(self, type, inputs, outputs, attrs)
        self.ops.insert(0, op)
        self.program.bump_version()
        return op

    def remove_op(self, index: int):
        del self.ops[index]
        self.program.bump_version()

    def all_parameters(self) -> List[Variable]:
        return [v for v in self.vars.values() if v.is_parameter]

    def to_dict(self) -> dict:
        return {
            "idx": self.idx,
            "parent_idx": self.parent_idx,
            "vars": [v.to_dict() for v in self.vars.values()],
            "ops": [op.to_dict() for op in self.ops],
        }


class Program:
    """A list of blocks; block 0 is the global block.

    Analog of ProgramDesc (framework.proto:212-216; python framework.py:3934).
    """

    def __init__(self):
        self.blocks: List[Block] = [Block(self, 0)]
        self._current_block_idx = 0
        self.random_seed: Optional[int] = None
        self._version = 0  # bumped on structural edits; part of compile key

    # -- block management --------------------------------------------------
    def global_block(self) -> Block:
        return self.blocks[0]

    def current_block(self) -> Block:
        return self.blocks[self._current_block_idx]

    def _create_block(self, parent_idx: Optional[int] = None) -> Block:
        parent = self._current_block_idx if parent_idx is None else parent_idx
        blk = Block(self, len(self.blocks), parent)
        self.blocks.append(blk)
        self._current_block_idx = blk.idx
        return blk

    def _rollback(self):
        self._current_block_idx = self.current_block().parent_idx

    @contextlib.contextmanager
    def block_scope(self):
        """Enter a fresh nested block (used by control-flow builders)."""
        blk = self._create_block()
        try:
            yield blk
        finally:
            self._rollback()

    def bump_version(self):
        self._version += 1

    # -- queries -----------------------------------------------------------
    def all_parameters(self) -> List[Variable]:
        return [p for b in self.blocks for p in b.all_parameters()]

    def list_vars(self):
        for b in self.blocks:
            yield from b.vars.values()

    # -- serialization -----------------------------------------------------
    def to_dict(self) -> dict:
        from ..ops.registry import op_version_map
        used = {op.type for b in self.blocks for op in b.ops}
        versions = {t: v for t, v in op_version_map().items() if t in used}
        return {
            "ir_version": IR_VERSION,
            # per-op semantic versions at save time (op_version.h analog):
            # loaders reject ops whose registered version moved past the
            # saved one instead of mis-executing them
            "op_versions": versions,
            "random_seed": self.random_seed,
            "blocks": [b.to_dict() for b in self.blocks],
        }

    def to_json(self, indent=None) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    @staticmethod
    def from_dict(d: dict) -> "Program":
        saved = d.get("op_versions") or {}
        if saved:
            from ..ops.registry import op_version_map
            cur = op_version_map()
            # the versions dict records every op type USED by the program
            # at save time, so a type unknown here means removed/renamed
            # — fail at load with a clear message, not at first execution
            gone = sorted(t for t in saved if t not in cur)
            if gone:
                raise ValueError(
                    f"saved program uses ops this build no longer "
                    f"registers: {gone} — re-export the model")
            stale = {t: (v, cur[t]) for t, v in saved.items()
                     if cur[t] > v}
            if stale:
                raise ValueError(
                    "saved program uses older op versions than this "
                    f"build: {stale} — re-export the model or add a "
                    "compat shim (op_version_registry analog)")
            future = {t: (v, cur[t]) for t, v in saved.items()
                      if cur[t] < v}
            if future:
                # an older build can never shim a future version
                raise ValueError(
                    "saved program was exported by a NEWER build (op "
                    f"versions {future}) — upgrade this runtime")
        prog = Program()
        prog.random_seed = d.get("random_seed")
        prog.blocks = []
        for bd in d["blocks"]:
            blk = Block(prog, bd["idx"], bd.get("parent_idx", -1))
            for vd in bd["vars"]:
                blk.vars[vd["name"]] = Variable.from_dict(blk, vd)
            for od in bd["ops"]:
                blk.ops.append(Operator.from_dict(blk, od))
            prog.blocks.append(blk)
        if not prog.blocks:
            prog.blocks = [Block(prog, 0)]
        return prog

    @staticmethod
    def from_json(s: str) -> "Program":
        return Program.from_dict(json.loads(s))

    def clone(self, for_test: bool = False) -> "Program":
        """Deep-copy the program. With for_test=True, flip is_test attrs
        (dropout/batch_norm behave in inference mode) — analog of
        Program.clone(for_test=True) in the reference."""
        p = Program.from_dict(copy.deepcopy(self.to_dict()))
        p.random_seed = self.random_seed
        if for_test:
            for b in p.blocks:
                for op in b.ops:
                    if "is_test" in op.attrs:
                        op.attrs["is_test"] = True
        return p

    def _prune(self, targets, keep_var_names=()) -> "Program":
        """Backward slice of block 0: keep only the ops needed to compute
        ``targets`` (analog of fluid Program._prune / prune_backward used
        by save_inference_model, fluid/io.py:1279). Ops referencing
        sub-blocks keep those blocks whole, and the sub-blocks' free
        variables are treated as the op's inputs. Variables not touched
        by a surviving op (minus ``keep_var_names``, e.g. declared feed
        vars) are dropped from block 0, and sub-blocks no longer
        referenced by a surviving op are emptied (indices stay stable
        because ops address sub-blocks by index)."""
        p = self.clone()
        blk = p.blocks[0]
        needed = {t.name if isinstance(t, Variable) else str(t)
                  for t in targets}

        kept = []
        live_blocks = {0}
        for op in reversed(blk.ops):
            if not any(n in needed for n in op.output_names()):
                continue
            kept.append(op)
            needed.update(op.input_names())
            for si in op_sub_block_indices(op):
                reads, _ = block_reads_writes(p, si)
                needed.update(reads)
                live_blocks.add(si)
                live_blocks.update(transitive_sub_blocks(p, si))
        blk.ops = list(reversed(kept))
        referenced = needed | set(keep_var_names)
        for op in blk.ops:
            referenced.update(op.output_names())
        blk.vars = {n: v for n, v in blk.vars.items() if n in referenced}
        for b in p.blocks:
            if b.idx not in live_blocks:
                b.ops = []
                b.vars = {}
        return p

    def fingerprint(self) -> str:
        """Stable content hash; part of the executor's compile-cache key."""
        h = hashlib.sha256(self.to_json().encode()).hexdigest()[:16]
        return h

    def verify(self, feeds: Sequence[str] = (), fetches=None,
               checks=None):
        """The reference runs its static analysis suite
        (``framework/analysis.py``) here; that suite is not ported yet."""
        raise NotImplementedError(
            "Program.verify runs framework/analysis.py's verifier, which "
            "waits for ROADMAP A7.3")

    def __repr__(self):
        nops = sum(len(b.ops) for b in self.blocks)
        return f"Program(blocks={len(self.blocks)}, ops={nops})"


# -- sub-block graph helpers (shared by Program._prune and
# layers/control_flow; ONE encoding of the sub-block attr convention) -------

SUB_BLOCK_ATTRS = ("sub_block", "sub_block_t", "sub_block_f")


def op_sub_block_indices(op: "Operator") -> List[int]:
    """Block indices an op references (while/cond/switch-style attrs)."""
    idxs = [int(op.attrs[a]) for a in SUB_BLOCK_ATTRS if a in op.attrs]
    idxs += [int(b) for b in op.attrs.get("sub_blocks", [])]
    return idxs


def transitive_sub_blocks(program: "Program", idx: int,
                          _seen=None) -> set:
    """All block indices reachable from ``idx`` through nested ops."""
    seen = _seen if _seen is not None else set()
    if idx in seen:
        return seen
    seen.add(idx)
    for op in program.blocks[idx].ops:
        for si in op_sub_block_indices(op):
            transitive_sub_blocks(program, si, seen)
    return seen


def block_reads_writes(program: "Program", blk_idx: int) -> tuple:
    """(external_reads, writes) of a block, recursing into nested
    control-flow sub-blocks. External reads = names consumed before any
    op in this block (or its children) defines them."""
    blk = program.blocks[blk_idx]
    defined: set = set()
    reads: List[str] = []
    writes: List[str] = []
    for op in blk.ops:
        for n in op.input_names():
            if n not in defined and n not in reads:
                reads.append(n)
        for si in op_sub_block_indices(op):
            sub_reads, _ = block_reads_writes(program, si)
            for n in sub_reads:
                if n not in defined and n not in reads:
                    reads.append(n)
        for n in op.output_names():
            defined.add(n)
            if n not in writes:
                writes.append(n)
    return reads, writes


# -- device guard (analog of framework.py device_guard / op_device attr) ----

_current_device_guard: Optional[str] = None


@contextlib.contextmanager
def device_guard(device: Optional[str] = None):
    """Stamp ops built inside the context with an ``op_device`` attr
    (e.g. "tpu:0") — the pipeline-stage annotation consumed by
    PipelineOptimizer's program split, mirroring the reference's
    fluid.device_guard -> PipelineOptimizer._split_program flow
    (fluid/framework.py device_guard, optimizer.py:3790)."""
    global _current_device_guard
    prev = _current_device_guard
    _current_device_guard = device
    try:
        yield
    finally:
        _current_device_guard = prev


# -- global default programs (analog of framework.py:5398-5486) -------------

_main_program = Program()
_startup_program = Program()


def default_main_program() -> Program:
    return _main_program


def default_startup_program() -> Program:
    return _startup_program


@contextlib.contextmanager
def program_guard(main_program: Program, startup_program: Optional[Program] = None):
    global _main_program, _startup_program
    prev_main, prev_startup = _main_program, _startup_program
    _main_program = main_program
    if startup_program is not None:
        _startup_program = startup_program
    # Remember which startup program this main program was built against so
    # later rewrites (optimizer accumulators created outside the original
    # guard) append their init ops to the startup program the user will
    # actually run. Don't clobber an explicit pairing on re-entry without
    # startup_program.
    if startup_program is not None or not hasattr(main_program,
                                                  "_startup_ref"):
        main_program._startup_ref = _startup_program
    try:
        yield
    finally:
        _main_program, _startup_program = prev_main, prev_startup
