"""paddle.static — the 2.0 static-graph namespace; the counterpart of
``paddle_tpu/static/__init__.py`` with what the port has: ``Program``,
``program_guard``, ``data``, ``Executor``, ``Scope``, ``global_scope``,
``append_backward``, ``gradients``, the default programs,
``device_guard``, ``nn`` (= :mod:`paddle_tpu_torch.layers`),
``quantization`` (= :mod:`paddle_tpu_torch.slim.quantization`),
``framework_io``'s ``save_inference_model`` / ``load_inference_model``
and ``save_persistables`` / ``load_persistables``, and the compiler's
``BuildStrategy``, ``CompiledProgram`` and ``ExecutionStrategy``.

Waiting: ``InputSpec`` with ``jit.save`` for ROADMAP A7.5b (the reference
traces a dygraph Layer through the tape's ``record_program``). 2.0
``static.data`` takes the FULL shape including the batch dim (None/-1
leading), unlike fluid ``layers.data`` which prepends it.
"""

from __future__ import annotations

from typing import Optional, Sequence

from ..compiler import BuildStrategy, CompiledProgram, ExecutionStrategy
from ..framework import (Executor, Program, Scope, append_backward,
                         default_main_program, default_startup_program,
                         device_guard, gradients, program_guard)
from ..framework.program import Variable
from ..framework.scope import global_scope
from ..framework_io import (load_inference_model, load_persistables,
                            save_inference_model, save_persistables)
from ..slim import quantization  # paddle.static.quantization surface
from .. import layers as nn  # static.nn.fc / conv2d / ... wrappers


def data(name: str, shape: Sequence[Optional[int]],
         dtype: str = "float32", lod_level: int = 0) -> Variable:
    """2.0 static.data: ``shape`` is the full shape, batch dim included
    (None or -1 means variadic) — static.py:data. Delegates to the
    fluid builder with the batch dim already present."""
    from ..layers.nn import data as _fluid_data
    full = [-1 if d is None else int(d) for d in shape]
    return _fluid_data(name, full, dtype=dtype, append_batch_size=False)


__all__ = [
    "BuildStrategy", "CompiledProgram", "ExecutionStrategy", "Executor", "Program", "Scope", "append_backward", "data",
    "default_main_program", "default_startup_program", "device_guard",
    "global_scope", "gradients", "load_inference_model",
    "load_persistables", "nn", "program_guard", "quantization",
    "save_inference_model", "save_persistables",
]
