"""The dygraph (eager) engine — the counterpart of
``paddle_tpu/dygraph/``: the eager :class:`Tensor`, the tracer that runs
each op through the registry and records onto torch autograd
(:mod:`.tape`), and the tape's :class:`Layer` with its containers.
``dygraph_to_static`` and ``DataParallel`` wait for ROADMAP A7.5b."""

from .tensor import Parameter, Tensor, to_tensor, to_variable
from .tape import (Tracer, default_tracer, grad, no_grad, record_program,
                   run_op)
from .layers import Layer, LayerList, ParameterList, Sequential, seed

__all__ = ["Layer", "LayerList", "Parameter", "ParameterList", "Sequential",
           "Tensor", "Tracer", "default_tracer", "grad", "no_grad",
           "record_program", "run_op", "seed", "to_tensor", "to_variable"]
