"""Static-graph AMP: the bf16 rewrite of a Program — the counterpart of
``paddle_tpu/amp/static_amp.py`` (``rewrite_program`` ``:57``,
``decorate`` ``:97``), op for op.

The rewrite walks block 0 and inserts ``cast`` ops so that white-list
ops (products, convolutions, ``fused_attention_qkv``) take bfloat16
operands and black-list ops (softmax, normalizations, reductions) take
float32 ones: the same casts in the same places, the same cached cast
names (``<var>.cast_<dtype>``, one per source and destination type) and
bfloat16 stamped on every white-list output. Parameters stay float32
masters. The casts are ordinary ops, so the backward differentiates
through them (``cast_grad`` casts a cotangent back to the source type).

The executor then runs those ops in bfloat16: a ``mul`` / ``matmul``
takes bf16 operands on the tensor cores, a ``fused_attention_qkv`` with
bf16 q/k/v takes the flash kernels' bf16 ``wgmma`` route
(:func:`~paddle_tpu_torch.ops.attention_ops.flash_route`), and a
black-list ``layer_norm`` gets its float32 input back (the LayerNorm
kernels in f32). bf16 keeps f32's exponent range, so no loss scaling is
inserted; ``decorate``'s loss-scaling arguments are accepted for the
reference's signature.
"""

from __future__ import annotations

from typing import Dict, Optional

from ..framework import unique_name
from ..framework.program import Block, Operator, Program
from .lists import AutoMixedPrecisionLists

_FLOAT = ("float32", "float64")


def _cast_input(block: Block, op_idx: int, op, slot: str, name: str,
                dst_dtype: str, cast_cache: Dict[str, str]) -> int:
    """Insert a cast op before op_idx; returns ops inserted (0 or 1)."""
    key = f"{name}->{dst_dtype}"
    if key in cast_cache:
        new_name = cast_cache[key]
        op.inputs[slot] = [new_name if n == name else n
                           for n in op.inputs[slot]]
        return 0
    try:
        v = block.var(name)
        src_dtype = v.dtype
    except KeyError:
        src_dtype = "float32"
    if src_dtype not in _FLOAT and src_dtype != "bfloat16":
        return 0
    if src_dtype == dst_dtype:
        return 0
    new_name = unique_name.generate(f"{name}.cast_{dst_dtype}")
    block.create_var(new_name, dtype=dst_dtype, stop_gradient=True)
    cast_op = Operator(block, "cast",
                       {"X": [name]}, {"Out": [new_name]},
                       {"in_dtype": src_dtype, "out_dtype": dst_dtype,
                        "op_role": "forward"})
    block.ops.insert(op_idx, cast_op)
    op.inputs[slot] = [new_name if n == name else n for n in op.inputs[slot]]
    cast_cache[key] = new_name
    return 1


def rewrite_program(program: Program, amp_lists: Optional[
        AutoMixedPrecisionLists] = None, dest_dtype: str = "bfloat16"):
    """In-place bf16 rewrite of the (forward) program."""
    amp_lists = amp_lists or AutoMixedPrecisionLists()
    block = program.global_block()
    i = 0
    cast_cache: Dict[str, str] = {}
    while i < len(block.ops):
        op = block.ops[i]
        inserted = 0
        if op.type in amp_lists.white_list:
            for slot, names in list(op.inputs.items()):
                for name in list(names):
                    inserted += _cast_input(block, i, op, slot, name,
                                            dest_dtype, cast_cache)
        elif op.type in amp_lists.black_list:
            for slot, names in list(op.inputs.items()):
                for name in list(names):
                    try:
                        if block.var(name).dtype == dest_dtype:
                            inserted += _cast_input(block, i, op, slot, name,
                                                    "float32", cast_cache)
                    except KeyError:
                        pass
        else:
            i += 1
            continue
        # mark low-precision outputs so downstream black ops re-cast
        if op.type in amp_lists.white_list:
            for names in op.outputs.values():
                for n in names:
                    try:
                        block.var(n).dtype = dest_dtype
                    except KeyError:
                        block.create_var(n, dtype=dest_dtype)
        i += inserted + 1
    program.bump_version()
    return program


def decorate(optimizer, amp_lists=None, init_loss_scaling: float = 2.**15,
             use_dynamic_loss_scaling: bool = True, use_pure_bf16=False,
             dest_dtype: str = "bfloat16"):
    """Wrap an optimizer so minimize() runs the AMP rewrite first
    (analog of mixed_precision/decorator.py:218)."""

    class OptimizerWithMixedPrecision:
        def __init__(self, opt):
            self._optimizer = opt
            self._amp_lists = amp_lists
            self._loss_scaling = init_loss_scaling

        def __getattr__(self, name):
            return getattr(self._optimizer, name)

        def minimize(self, loss, startup_program=None, parameter_list=None,
                     no_grad_set=None):
            rewrite_program(loss.block.program, self._amp_lists, dest_dtype)
            return self._optimizer.minimize(loss, startup_program,
                                            parameter_list, no_grad_set)

        def backward(self, loss, **kw):
            rewrite_program(loss.block.program, self._amp_lists, dest_dtype)
            return self._optimizer.backward(loss, **kw)

        def apply_gradients(self, params_grads, startup_program=None):
            return self._optimizer.apply_gradients(params_grads,
                                                   startup_program)

        def get_loss_scaling(self):
            return self._loss_scaling

    return OptimizerWithMixedPrecision(optimizer)
