"""The serving half of the analysis plane; the port's copy of the parts
of ``paddle_tpu/analysis`` that need no static Program:

- :mod:`recompile` — static prediction of the serving steps' compile
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

The executor's predictor (``ExecutorCompilePredictor``) and abstract
interpretation wait for the static Program (ROADMAP A7).
"""

from .concurrency import (GuardedStateError, SanitizedLock,
                          declare_guarded, make_lock,
                          sanitizer_report)
from .lifecycle import (LintResult, SourceDiagnostic, lint_files,
                        lint_serving)
from .recompile import (RecompilePredictor, feed_signature,
                        merge_compile_counts, predict_serving_compiles)

__all__ = [
    "RecompilePredictor", "feed_signature",
    "merge_compile_counts", "predict_serving_compiles",
    "GuardedStateError", "SanitizedLock", "declare_guarded",
    "make_lock", "sanitizer_report",
    "LintResult", "SourceDiagnostic", "lint_files", "lint_serving",
]
