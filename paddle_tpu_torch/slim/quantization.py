"""Quantization passes: QAT transform, freeze, post-training quant —
the counterpart of ``paddle_tpu/slim/quantization.py``, built on the
pass plane (:mod:`~paddle_tpu_torch.framework.ir`):

- ``QuantizationTransformPass`` inserts fake quant-dequant ops around
  quantizable ops: per-channel abs-max on weights, moving-average
  abs-max on activations (with persistable scale / state vars
  initialized into the startup program or a scope). The rewritten
  program trains with straight-through gradients
  (:mod:`~paddle_tpu_torch.ops.quant_ops`).
- ``QuantizationFreezePass`` flips the activation quant ops to
  ``is_test`` so the learned scales are frozen, and reports the
  {var: scale} map from the scope.
- ``PostTrainingQuantization`` runs calibration batches through the
  float program, computes abs-max activation scales and emits a frozen
  quantized program (no training).

The quantization is simulated (float in, float out, rounded to the int
grid), as the reference's is.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from ..framework import unique_name
from ..framework.ir import IrGraph, Pass, register_pass
from ..framework.program import Operator, Program

# op type -> (activation slot, weight slot, channel axis of the weight)
_QUANTIZABLE = {
    "mul": ("X", "Y", 1),
    "matmul": ("X", "Y", 1),
    "matmul_v2": ("X", "Y", 1),
    "conv2d": ("Input", "Filter", 0),
    "depthwise_conv2d": ("Input", "Filter", 0),
}


class QuantizationTransformPass(Pass):
    """Insert weight + activation fake-quant ops
    (quantization_pass.py:174). Attrs: weight_bits, activation_bits,
    moving_rate, quantizable_op_type, startup_program (receives scale
    var initializers), for_test."""

    name = "quantization_transform_pass"

    def apply_impl(self, graph: IrGraph):
        wbits = int(self.get_attr("weight_bits", 8))
        abits = int(self.get_attr("activation_bits", 8))
        rate = float(self.get_attr("moving_rate", 0.9))
        startup: Optional[Program] = self.get_attr("startup_program")
        scope = self.get_attr("scope")
        for_test = bool(self.get_attr("for_test", False))
        types = set(self.get_attr("quantizable_op_type",
                                  list(_QUANTIZABLE)))
        blk = graph.block
        quantized_cache: Dict[str, str] = {}
        i = 0
        while i < len(blk.ops):
            op = blk.ops[i]
            if op.type not in types or op.attr("__quant_skip__"):
                i += 1
                continue
            act_slot, w_slot, w_axis = _QUANTIZABLE[op.type]
            for slot, is_weight in ((w_slot, True), (act_slot, False)):
                names = op.inputs.get(slot, [])
                if not names:
                    continue
                name = names[0]
                if name in quantized_cache:
                    op.inputs[slot] = [quantized_cache[name]]
                    continue
                if is_weight != graph.is_persistable(name):
                    continue  # slot/kind mismatch (e.g. dynamic weight)
                qname = unique_name.generate(f"{name}.quantized.dequantized")
                blk.create_var(qname, stop_gradient=False)
                if is_weight:
                    qop = Operator(
                        blk, "fake_channel_wise_quantize_dequantize_abs_max",
                        {"X": [name]},
                        {"Out": [qname],
                         "OutScale": [self._scale_var(blk, qname)]},
                        {"bit_length": wbits, "quant_axis": w_axis})
                else:
                    scale = self._state_var(blk, startup, scope,
                                            f"{name}.scale", 1.0)
                    state = self._state_var(blk, startup, scope,
                                            f"{name}.state", 1.0)
                    accum = self._state_var(blk, startup, scope,
                                            f"{name}.accum", 1.0)
                    qop = Operator(
                        blk,
                        "fake_quantize_dequantize_moving_average_abs_max",
                        {"X": [name], "InScale": [scale],
                         "InState": [state], "InAccum": [accum]},
                        {"Out": [qname], "OutScale": [scale],
                         "OutState": [state], "OutAccum": [accum]},
                        {"bit_length": abits, "moving_rate": rate,
                         "is_test": for_test})
                blk.ops.insert(i, qop)
                i += 1
                op.inputs[slot] = [qname]
                quantized_cache[name] = qname
            i += 1
        graph._rebuild()

    @staticmethod
    def _scale_var(blk, base: str) -> str:
        name = unique_name.generate(f"{base}.scale")
        blk.create_var(name, stop_gradient=True)
        return name

    @staticmethod
    def _state_var(blk, startup: Optional[Program], scope, base: str,
                   init: float) -> str:
        name = unique_name.generate(base)
        blk.create_var(name, persistable=True, stop_gradient=True)
        if scope is not None:
            # direct scope init: safe for pretrained models (re-running
            # the startup program would re-randomize trained weights)
            scope.set_var(name, np.float32(init))
        if startup is not None:
            sblk = startup.global_block()
            sblk.create_var(name, persistable=True, stop_gradient=True)
            sblk.append_op("fill_constant", {}, {"Out": [name]},
                           {"shape": [], "value": float(init),
                            "dtype": "float32"})
        return name


@register_pass("quantization_freeze_pass")
class QuantizationFreezePass(Pass):
    """Freeze QAT scales: flip moving-average quant ops to is_test
    (InScale becomes the frozen scale) and collect the learned scales
    from the scope via attr 'scope' (quantization_pass.py
    QuantizationFreezePass analog). The scale map lands on
    ``pass.scales`` after apply."""

    name = "quantization_freeze_pass"

    def apply_impl(self, graph: IrGraph):
        scope = self.get_attr("scope")
        self.scales: Dict[str, float] = {}
        for node in graph.all_op_nodes():
            if node.type == \
                    "fake_quantize_dequantize_moving_average_abs_max":
                node.op.attrs["is_test"] = True
                scale_name = node.op.input("InScale")[0]
                if scope is not None and scope.has_var(scale_name):
                    self.scales[node.op.input("X")[0]] = float(
                        scope.get_numpy(scale_name))


# keep the transform pass registered by name too
try:
    register_pass("quantization_transform_pass")(QuantizationTransformPass)
except ValueError:
    pass


def quant_aware(program: Program, startup_program: Optional[Program] = None,
                weight_bits: int = 8, activation_bits: int = 8,
                moving_rate: float = 0.9, for_test: bool = False,
                quantizable_op_type: Optional[Sequence[str]] = None,
                scope=None) -> Program:
    """High-level QAT entry (paddleslim quant_aware style): returns the
    rewritten program.

    Scale/state var initialization, two flows:
    - Training from scratch: pass ``startup_program``; initializers are
      appended — run startup ONCE before training (running it again
      later would re-randomize weights).
    - Fine-tuning a pretrained model whose weights already live in a
      scope: pass ``scope`` instead; scale vars are initialized
      directly there and the startup program is left untouched.
    """
    graph = IrGraph(program)
    p = QuantizationTransformPass(
        weight_bits=weight_bits, activation_bits=activation_bits,
        moving_rate=moving_rate, startup_program=startup_program,
        for_test=for_test, scope=scope,
        quantizable_op_type=list(quantizable_op_type or _QUANTIZABLE))
    p.apply(graph)
    return graph.to_program()


def convert(program: Program, scope=None) -> "tuple[Program, dict]":
    """Freeze a QAT program for inference: scales fixed, state updates
    gone. Returns (program, {activation var: scale})."""
    graph = IrGraph(program)
    p = QuantizationFreezePass(scope=scope)
    p.apply(graph)
    return graph.to_program(), dict(getattr(p, "scales", {}))


class PostTrainingQuantization:
    """Post-training quantization (post_training_quantization.py
    analog): calibrate activation scales on sample batches, then emit a
    frozen quantized program.

    >>> ptq = PostTrainingQuantization(exe, program, scope=scope)
    >>> for feed in calib_batches: ptq.collect(feed)
    >>> qprog, scales = ptq.quantize(startup_program)
    """

    def __init__(self, executor, program: Program, scope=None,
                 weight_bits: int = 8, activation_bits: int = 8,
                 quantizable_op_type: Optional[Sequence[str]] = None):
        from ..framework.scope import global_scope
        self._exe = executor
        self._program = program
        # same fallback as Executor.run: calibration already reads the
        # global scope when none is given, so scale writes must too
        self._scope = scope if scope is not None else global_scope()
        self._wbits = weight_bits
        self._abits = activation_bits
        self._types = set(quantizable_op_type or _QUANTIZABLE)
        self._act_vars = self._find_activation_vars()
        self._absmax: Dict[str, float] = {v: 0.0 for v in self._act_vars}

    def _find_activation_vars(self) -> List[str]:
        blk = self._program.global_block()
        acts = []
        for op in blk.ops:
            if op.type not in self._types:
                continue
            act_slot, _, _ = _QUANTIZABLE[op.type]
            for name in op.inputs.get(act_slot, []):
                try:
                    persistable = blk.var(name).persistable
                except KeyError:
                    persistable = False
                if not persistable and name not in acts:
                    acts.append(name)
        return acts

    def collect(self, feed: dict):
        """Run one calibration batch, track activation abs-max."""
        vals = self._exe.run(self._program, feed=feed,
                             fetch_list=list(self._act_vars),
                             scope=self._scope)
        for name, v in zip(self._act_vars, vals):
            self._absmax[name] = max(self._absmax[name],
                                     float(np.max(np.abs(v))))

    def quantize(self, startup_program: Optional[Program] = None):
        """-> (frozen quantized program, {var: scale}). Calibrated
        scales are written straight into the scope (the trained weights
        there are untouched — re-running the caller's startup would
        re-randomize them)."""
        q = quant_aware(self._program, startup_program or Program(),
                        weight_bits=self._wbits,
                        activation_bits=self._abits, for_test=True,
                        quantizable_op_type=list(self._types))
        blk = q.global_block()
        scales = {}
        for op in blk.ops:
            if op.type == \
                    "fake_quantize_dequantize_moving_average_abs_max":
                x = op.input("X")[0]
                scale = self._absmax.get(x, 1.0) or 1.0
                if self._scope is not None:
                    self._scope.set_var(op.input("InScale")[0],
                                        np.float32(scale))
                    self._scope.set_var(op.input("InState")[0],
                                        np.float32(1.0))
                    self._scope.set_var(op.input("InAccum")[0],
                                        np.float32(scale))
                scales[x] = scale
        return q, scales


__all__ = ["PostTrainingQuantization", "QuantizationFreezePass",
           "QuantizationTransformPass", "convert", "quant_aware"]
