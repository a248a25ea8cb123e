"""Inference stack: Config + Predictor over saved inference models — the
counterpart of ``paddle_tpu/inference.py``.

Capability analog of the reference's AnalysisPredictor front door
(paddle/fluid/inference/api/analysis_predictor.cc,
paddle_analysis_config.h). The reference runs an ordered IR-pass pipeline
inside the predictor (inference/analysis/ir_pass_manager.cc, pass list
from api/paddle_pass_builder.cc); here the structural passes (dropout
deletion, BN folding, add+act fusion) run through the same
framework/ir.py PassManager at predictor build, and the program runs
through the static executor: on the card a key's first run is eager and
its second captures one CUDA graph that later runs replay, so a batch
size is one capture. The Predictor owns a private Scope (the reference's
per-predictor scope) so params load once and concurrent predictors don't
collide.

Placement is the executor's: a Predictor runs on the card, and raises
without one, unless it is made with ``place="cpu"`` (the port's only
addition to the reference's surface; ``Config`` has no device knob).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np

# Ordered inference pass pipeline — the subset of the reference's
# CpuPassStrategy (api/paddle_pass_builder.cc:141) that changes the op
# graph structurally.
INFERENCE_PASSES = [
    "delete_dropout_op_pass",
    "fuse_bn_act_pass",
    "fuse_elewise_add_act_pass",
]


def apply_inference_passes(program, passes: Optional[Sequence[str]] = None):
    """Run the inference pass pipeline over a loaded program, skipping
    passes that are not registered (mirrors ir_pass_manager.cc's
    tolerance for absent passes)."""
    from .framework.ir import PassManager, registered_passes
    wanted = INFERENCE_PASSES if passes is None else passes
    names = [p for p in wanted if p in registered_passes()]
    return PassManager(names).apply(program)


class Config:
    """paddle.inference.Config parity surface. `switch_ir_optim` gates the
    IR pass pipeline (on by default, like the reference);
    `enable_memory_optim` maps to the executor's ``donate_state`` (the
    port's executor frees each dead value after its last reader always:
    ``framework/executor.py:plan_drops``)."""

    def __init__(self, model_dir: str):
        self.model_dir = model_dir
        self._ir_optim = True
        self._memory_optim = False
        self._glog_info = True
        self._passes: Optional[List[str]] = None

    def enable_memory_optim(self, flag: bool = True):
        self._memory_optim = bool(flag)

    def memory_optim_enabled(self) -> bool:
        return self._memory_optim

    def switch_ir_optim(self, flag: bool = True):
        self._ir_optim = bool(flag)

    def ir_optim(self) -> bool:
        return self._ir_optim

    def pass_builder(self) -> List[str]:
        """Mutable pass list (analog of paddle_pass_builder.h); edits
        apply to predictors created afterwards."""
        if self._passes is None:
            self._passes = list(INFERENCE_PASSES)
        return self._passes

    def disable_glog_info(self):
        self._glog_info = False


class Predictor:
    """paddle.inference.create_predictor parity: load once, run many.

    >>> pred = create_predictor(Config(model_dir))
    >>> [out] = pred.run([input_batch])

    ``place``: the executor's (None is the card, ``"cpu"`` the CPU)."""

    def __init__(self, config: Config, *, place: Any = None):
        from .framework import Executor, Scope
        from .framework_io import load_inference_model
        self._scope = Scope()
        self._exe = Executor(place,
                             donate_state=config.memory_optim_enabled())
        self._program, self._feed_names, self._fetch_names = \
            load_inference_model(config.model_dir, self._exe,
                                 scope=self._scope)
        if config.ir_optim():
            self._program = apply_inference_passes(
                self._program, config._passes)

    def get_input_names(self) -> List[str]:
        return list(self._feed_names)

    def get_output_names(self) -> List[str]:
        return list(self._fetch_names)

    @property
    def program(self):
        """The (possibly pass-optimized) program this predictor runs."""
        return self._program

    @property
    def executor(self):
        """The executor the predictor runs on (its ``captures``)."""
        return self._exe

    @property
    def scope(self):
        """The predictor's private scope (its loaded parameters)."""
        return self._scope

    def run(self, inputs: Sequence[np.ndarray]) -> List[np.ndarray]:
        if len(inputs) != len(self._feed_names):
            raise ValueError(
                f"expected {len(self._feed_names)} inputs "
                f"({self._feed_names}), got {len(inputs)}")
        feed = {n: np.asarray(a) for n, a in zip(self._feed_names, inputs)}
        return self._exe.run(self._program, feed=feed,
                             fetch_list=self._fetch_names,
                             scope=self._scope)

    def run_dict(self, feed: Dict[str, np.ndarray]) -> List[np.ndarray]:
        return self._exe.run(self._program, feed=feed,
                             fetch_list=self._fetch_names,
                             scope=self._scope)


def create_predictor(config: Config, *, place: Any = None) -> Predictor:
    return Predictor(config, place=place)
