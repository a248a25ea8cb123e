"""Op lowering registry — the counterpart of ``paddle_tpu/ops/registry.py``
(``:40-396``).

An op type maps to a *lowering*: a Python function from the op's input
tensors (``{slot: [tensor, ...]}``) and attrs to its output tensors.
The static executor (:mod:`~paddle_tpu_torch.framework.executor`) calls
it op by op, eagerly or under a CUDA graph capture; the lowerings are
torch functions, and where the reference's lowering reaches a Pallas
kernel the port's reaches the hand-written CUDA kernel through its
wrapper (:mod:`.cuda`).

Gradients: grad ops are op types named ``<type>_grad``. Without a
registered ``<type>_grad`` lowering, :func:`_generic_grad_lowering`
derives one from the forward lowering, as the reference derives it with
``jax.vjp``: it re-runs the forward lowering under autograd and takes
``torch.autograd.grad`` of its outputs. A forward that goes through one
of the port's ``torch.autograd.Function`` kernels (flash attention,
LayerNorm) so launches the kernel's forward again and then its backward
kernels; the reference's XLA recompute is free where the port's is a
second launch (ROADMAP B, later perf work).

The lowering modules (``math_ops``, ``reduce_ops``, ``tensor_ops``,
``random_ops``, ``nn_ops``, ``attention_ops``, ``optimizer_ops``) are
imported at the first lookup, so importing the registry alone stays
light; :data:`OPS` is complete after any call of :func:`get_op_def`,
:func:`execute`, :func:`is_registered`, :func:`registered_ops` or
:func:`op_version_map`.
"""

from __future__ import annotations

import dataclasses
import importlib
import os
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import prng

# ---------------------------------------------------------------------------
# Lowering context
# ---------------------------------------------------------------------------


class LoweringContext:
    """Per-op execution context threaded through lowerings: the op's PRNG
    key (a threefry key tensor ``[2]`` int64 on the op's device, see
    :mod:`~paddle_tpu_torch.prng`), the mesh hooks of the reference
    (unused on one card) and the mode.

    ``rng`` is a key tensor, or a callable that makes one: the executor
    hands each op a callable that folds the op's index into the run's key
    on the device, so an op that draws nothing costs nothing (the
    reference folds for every op and XLA drops the unused ones).
    ``device`` is where an eager key without ``rng`` is made."""

    def __init__(self, rng=None, eager: bool = False, mesh=None,
                 axis_env: Optional[Dict[int, str]] = None,
                 executor=None, *, device=None):
        self._rng = rng
        self.eager = eager
        self.mesh = mesh
        self.axis_env = axis_env or {}
        self.executor = executor
        self.device = torch.device(device) if device is not None else None

    def rng(self) -> torch.Tensor:
        if self._rng is None:
            # eager without an explicit key: the process-global counter,
            # entropy-seeded at import as in the reference
            global _EAGER_SEED
            _EAGER_SEED += 1
            return prng.PRNGKey(_EAGER_SEED, device=self.device)
        if callable(self._rng):
            self._rng = self._rng()
        return self._rng

    def axis_name(self, ring_id: int) -> Optional[str]:
        return self.axis_env.get(int(ring_id))


def _init_eager_seed() -> int:
    # OS entropy so every process draws a distinct sequence, the rank
    # folded in as the reference does (registry.py:74-81)
    base = int.from_bytes(os.urandom(4), "little")
    rank = int(os.environ.get("PADDLE_TRAINER_ID", 0))
    return (base ^ (rank * 0x9E3779B9)) & 0x7FFFFFFF


_EAGER_SEED = _init_eager_seed()


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

# Lowering signature: (ctx, ins, attrs) -> outs, ins/outs {slot: [tensor]}
Lowering = Callable[[LoweringContext, Dict[str, List[Any]], Dict[str, Any]],
                    Dict[str, List[Any]]]
# maker(op_desc, out_grad_names, wanted_input_slots) -> [(type, ins, outs,
# attrs)], as the reference's GradMaker
GradMaker = Callable[..., List[Tuple[str, dict, dict, dict]]]
# the reference's static infer rule: (ictx, ins, attrs) -> outs over
# abstract values; the abstract interpreter that reads it waits with
# framework/analysis.py (ROADMAP A7.3), the field is kept for parity
InferRule = Callable[[Any, Dict[str, List[Any]], Dict[str, Any]],
                     Dict[str, List[Any]]]


@dataclasses.dataclass
class OpDef:
    type: str
    lowering: Lowering
    # input slots that never receive gradients (indices, labels, masks)
    no_grad_slots: Tuple[str, ...] = ()
    # output slots that are non-differentiable (e.g. argmax Indices)
    nondiff_outputs: Tuple[str, ...] = ()
    # forward input slots the default grad op does not need
    grad_drops_inputs: Tuple[str, ...] = ()
    # forward output slots the grad op additionally needs (dropout's Mask)
    grad_needs_outputs: Tuple[str, ...] = ()
    # True if the op has no gradient at all
    not_differentiable: bool = False
    custom_grad_maker: Optional[GradMaker] = None
    # trainable state outside the program (a host sparse table)
    virtual_param: bool = False
    # per-op semantic version, saved with a program (op_version.h analog)
    version: int = 1
    infer: Optional[InferRule] = None
    # effect outside the dataflow graph (collectives, PS pulls, prints)
    side_effect: bool = False


OPS: Dict[str, OpDef] = {}

#: the lowering modules, imported at the first lookup, in the order the
#: reference's ``ops/__init__.py`` imports its counterparts
LOWERING_MODULES = ("math_ops", "tensor_ops", "nn_ops", "reduce_ops",
                    "random_ops", "optimizer_ops", "attention_ops")
_loaded = False
# op type -> (its module's place in LOWERING_MODULES, registration number):
# other modules of the port import some lowering modules first, so the
# insertion order of OPS varies; this is the reference's order
_ORDER: Dict[str, Tuple[int, int]] = {}


def _load():
    global _loaded
    if not _loaded:
        _loaded = True
        for name in LOWERING_MODULES:
            importlib.import_module(f"{__package__}.{name}")


def register(op_type: str, **kw):
    """Decorator: register a lowering for ``op_type``."""
    def deco(fn: Lowering) -> Lowering:
        if op_type in OPS:
            raise ValueError(f"op {op_type!r} already registered")
        OPS[op_type] = OpDef(type=op_type, lowering=fn, **kw)
        mod = fn.__module__.rsplit(".", 1)[-1]
        _ORDER[op_type] = (LOWERING_MODULES.index(mod)
                           if mod in LOWERING_MODULES else
                           len(LOWERING_MODULES), len(_ORDER))
        return fn
    return deco


def register_infer(op_type: str):
    """Decorator: attach a static infer rule to an already-registered op
    (the inline form is ``register(op_type, infer=...)``)."""
    def deco(fn: InferRule) -> InferRule:
        d = OPS.get(op_type)
        if d is None:
            raise ValueError(
                f"cannot register infer rule: op {op_type!r} has no "
                f"registered lowering")
        if d.infer is not None:
            raise ValueError(
                f"op {op_type!r} already has an infer rule")
        d.infer = fn
        return fn
    return deco


def get_op_def(op_type: str) -> OpDef:
    _load()
    d = OPS.get(op_type)
    if d is None:
        raise NotImplementedError(
            f"no lowering registered for op {op_type!r} "
            f"({len(OPS)} ops registered; the rest of the reference's op "
            f"library waits for ROADMAP A7.2)")
    return d


def is_registered(op_type: str) -> bool:
    _load()
    return op_type in OPS


def registered_ops() -> List[str]:
    _load()
    return sorted(OPS.keys())


def op_version_map() -> Dict[str, int]:
    """op type -> semantic version (op_version_registry.h analog), in the
    reference's registration order (a saved program's ``op_versions``
    then reads as the reference's, key for key)."""
    _load()
    return {name: OPS[name].version
            for name in sorted(OPS, key=_ORDER.__getitem__)}


# ---------------------------------------------------------------------------
# Execution
# ---------------------------------------------------------------------------


def execute(ctx: LoweringContext, op_type: str, ins: Dict[str, List[Any]],
            attrs: Dict[str, Any]) -> Dict[str, List[Any]]:
    """Run one op's lowering; falls back to the derived grad lowering."""
    _load()
    if op_type in OPS:
        return OPS[op_type].lowering(ctx, ins, attrs)
    if op_type.endswith("_grad") and op_type[:-5] in OPS:
        return _generic_grad_lowering(ctx, op_type[:-5], ins, attrs)
    raise NotImplementedError(
        f"no lowering for op {op_type!r} (the rest of the reference's op "
        f"library waits for ROADMAP A7.2)")


GRAD_SLOT_SUFFIX = "@GRAD"


def _inexact(v) -> bool:
    return isinstance(v, torch.Tensor) and (v.is_floating_point()
                                            or v.is_complex())


def _generic_grad_lowering(ctx: LoweringContext, fw_type: str,
                           ins: Dict[str, List[Any]],
                           attrs: Dict[str, Any]) -> Dict[str, List[Any]]:
    """Derive ``<op>_grad`` from the forward lowering with autograd.

    The grad op's inputs follow the reference's slot convention: forward
    input slots carry forward values, ``<out_slot>@GRAD`` slots the
    incoming cotangents; its outputs are ``<in_slot>@GRAD``. The forward
    lowering re-runs with the float inputs of gradient-carrying slots as
    leaves that require grad and every other input detached; the
    cotangents of outputs that got none are zero (they add nothing, so
    they are left out of ``torch.autograd.grad``), integer outputs take
    none, and an input no output depends on gets zeros, float32 zeros
    for an integer input whose gradient is wanted, as in the
    reference."""
    fw_def = OPS[fw_type]
    fw_ins = {s: v for s, v in ins.items() if not s.endswith(GRAD_SLOT_SUFFIX)}
    out_grads = {s[:-len(GRAD_SLOT_SUFFIX)]: list(v) for s, v in ins.items()
                 if s.endswith(GRAD_SLOT_SUFFIX)}
    for slot, mask in attrs.get("__out_grad_present__", {}).items():
        gs = iter(out_grads.get(slot, []))
        out_grads[slot] = [next(gs) if m else None for m in mask]

    leaves: List[Tuple[str, int, torch.Tensor]] = []
    with torch.enable_grad():
        all_ins = {}
        for slot, vals in fw_ins.items():
            no_grad = slot in fw_def.no_grad_slots
            row = []
            for i, v in enumerate(vals):
                if isinstance(v, torch.Tensor):
                    v = v.detach()
                    if not no_grad and _inexact(v):
                        v = v.requires_grad_(True)
                        leaves.append((slot, i, v))
                row.append(v)
            all_ins[slot] = row
        primal_out = fw_def.lowering(ctx, all_ins, attrs)
        outs, cots = [], []
        for slot, vals in primal_out.items():
            gs = out_grads.get(slot)
            for i, v in enumerate(vals):
                if not _inexact(v) or not v.requires_grad:
                    continue
                g = gs[i] if gs is not None and i < len(gs) else None
                if g is None:
                    continue
                outs.append(v)
                cots.append(g.to(v.dtype))
        if outs and leaves:
            grads = torch.autograd.grad(outs, [t for _, _, t in leaves],
                                        cots, allow_unused=True)
        else:
            grads = [None] * len(leaves)
    got = {(slot, i): g for (slot, i, _), g in zip(leaves, grads)
           if g is not None}

    wanted_masks = attrs.get("__in_grad_wanted__", {})
    out = {}
    for slot, vals in fw_ins.items():
        if slot in fw_def.no_grad_slots:
            continue
        grads_ = []
        for i, v in enumerate(vals):
            g = got.get((slot, i))
            if g is None:
                g = (torch.zeros_like(v) if _inexact(v) else
                     torch.zeros(tuple(v.shape), dtype=torch.float32,
                                 device=v.device))
            grads_.append(g.detach())
        mask = wanted_masks.get(slot)
        if mask is not None:
            grads_ = [g for g, m in zip(grads_, mask) if m]
        out[f"{slot}{GRAD_SLOT_SUFFIX}"] = grads_
    return out


# ---------------------------------------------------------------------------
# Default grad-op maker (analog of DefaultGradOpDescMaker)
# ---------------------------------------------------------------------------


def make_grad_ops(op, out_grad_names: Dict[str, List[Optional[str]]],
                  wanted_input_grads: Dict[str, List[Optional[str]]]
                  ) -> List[Tuple[str, dict, dict, dict]]:
    """Build grad-op descs for forward op ``op``.

    Returns a list of (type, inputs, outputs, attrs). Uses the op's custom
    maker when registered; otherwise the default convention:

        type:    <fw_type>_grad
        inputs:  all fw input slots (minus grad_drops_inputs)
                 + fw outputs listed in grad_needs_outputs
                 + <out_slot>@GRAD for each grad-carrying output
        outputs: <in_slot>@GRAD for each wanted input grad
    """
    d = get_op_def(op.type)
    if d.not_differentiable:
        return []
    if d.custom_grad_maker is not None:
        return d.custom_grad_maker(op, out_grad_names, wanted_input_grads)

    g_inputs: Dict[str, List[str]] = {}
    for slot, names in op.inputs.items():
        if slot in d.grad_drops_inputs:
            continue
        g_inputs[slot] = list(names)
    for slot in d.grad_needs_outputs:
        if slot in op.outputs:
            g_inputs[slot] = list(op.outputs[slot])
    g_attrs = dict(op.attrs)
    has_incoming = False
    out_present: Dict[str, List[bool]] = {}
    for slot, gnames in out_grad_names.items():
        if any(g is not None for g in gnames):
            has_incoming = True
            g_inputs[f"{slot}{GRAD_SLOT_SUFFIX}"] = [
                g for g in gnames if g is not None]
            if any(g is None for g in gnames):
                out_present[slot] = [g is not None for g in gnames]
    if not has_incoming:
        return []
    if out_present:
        g_attrs["__out_grad_present__"] = out_present

    g_outputs: Dict[str, List[str]] = {}
    in_wanted: Dict[str, List[bool]] = {}
    for slot, gnames in wanted_input_grads.items():
        if slot in d.no_grad_slots:
            continue
        targets = [g for g in gnames if g is not None]
        if targets:
            g_outputs[f"{slot}{GRAD_SLOT_SUFFIX}"] = targets
            if any(g is None for g in gnames):
                in_wanted[slot] = [g is not None for g in gnames]
    if not g_outputs:
        return []
    if in_wanted:
        g_attrs["__in_grad_wanted__"] = in_wanted
    return [(f"{op.type}_grad", g_inputs, g_outputs, g_attrs)]


# ---------------------------------------------------------------------------
# dtypes
# ---------------------------------------------------------------------------

#: the IR's dtype names (``framework.program.convert_dtype``) as torch's
TORCH_DTYPES = {
    "float32": torch.float32, "float64": torch.float64,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "int8": torch.int8, "uint8": torch.uint8, "int16": torch.int16,
    "int32": torch.int32, "int64": torch.int64, "bool": torch.bool,
}


def as_array(x, *, device=None) -> torch.Tensor:
    """``x`` as a tensor (a numpy array or scalar becomes one, on
    ``device`` when given)."""
    if isinstance(x, torch.Tensor):
        return x if device is None else x.to(device)
    return torch.as_tensor(np.asarray(x), device=device)


def np_dtype(name: str):
    """The torch dtype of an IR dtype name (or of anything
    ``convert_dtype`` takes); the reference returns the jnp dtype."""
    if isinstance(name, torch.dtype):
        return name
    from ..framework.program import convert_dtype
    return TORCH_DTYPES[convert_dtype(name)]
