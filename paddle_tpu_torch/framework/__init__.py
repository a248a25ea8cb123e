"""Framework core of the port: the Program IR, Scope, Executor and
program-level autodiff (the counterpart of ``paddle_tpu/framework/``).
``ir`` is the pass plane (``IrGraph``, ``Pass``, ``PassManager``),
``analysis`` the static verifier (``verify_program``) and ``subgraph``
the subgraph partitioner (``SubgraphDelegatePass``)."""

from .program import (Block, Operator, Program, Variable, convert_dtype,
                      default_main_program, default_startup_program,
                      device_guard, grad_var_name, program_guard)
from .scope import Scope, global_scope
from .executor import Executor, NanInfError
from .backward import append_backward, gradients
from . import unique_name
from . import ir
from . import analysis
from .analysis import (Diagnostic, ProgramVerifyError, VerifyResult,
                       verify_program)
