"""Static-analysis plane over the Program IR and the serving fleet; the
port's copy of ``paddle_tpu/analysis``:

- :mod:`abstract_interp` — shape/dtype inference by abstract
  interpretation (the trace-free analog of Fluid's
  ``InferShape``/``InferVarType``: the registered lowerings run on meta
  tensors), surfaced through the registered ``shapes.infer`` verifier
  check and ``FLAGS_check_shapes``;
- :mod:`recompile` — static prediction of the executor's keys
  (:class:`ExecutorCompilePredictor`) and the serving steps' compile
  counts (:func:`predict_serving_compiles`), held against the compile
  tracker's observed counts;
- :mod:`lifecycle` — static resource-lifecycle (KV rows / LoRA pins:
  release-on-all-paths, export/adopt ownership transfer) and
  lock-discipline (``# guarded-by``) checks over the serving sources,
  surfaced through ``python3 -m paddle_tpu_torch.tools.lint_serving``;
- :mod:`concurrency` — the runtime half of the same plane
  (``FLAGS_sanitize_locks``): instrumented locks recording the
  lock-acquisition-order graph (deadlock-cycle detection) and a
  guarded-state registry that raises on writes without the declared
  lock.
"""

from .abstract_interp import (AbstractVar, InferContext, InferError,
                              InterpretResult, abstract_eval_op,
                              interpret_program)
from .concurrency import (GuardedStateError, SanitizedLock,
                          declare_guarded, make_lock,
                          sanitizer_report)
from .lifecycle import (LintResult, SourceDiagnostic, lint_files,
                        lint_serving)
from .recompile import (ExecutorCompilePredictor, RecompilePredictor,
                        feed_signature, merge_compile_counts,
                        predict_serving_compiles)

__all__ = [
    "AbstractVar", "InferContext", "InferError", "InterpretResult",
    "abstract_eval_op", "interpret_program",
    "ExecutorCompilePredictor", "RecompilePredictor", "feed_signature",
    "merge_compile_counts", "predict_serving_compiles",
    "GuardedStateError", "SanitizedLock", "declare_guarded",
    "make_lock", "sanitizer_report",
    "LintResult", "SourceDiagnostic", "lint_files", "lint_serving",
]
