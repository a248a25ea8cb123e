"""Static concurrency + resource-lifecycle lint over the port's serving
modules; the port's copy of ``tools/lint_serving.py``.

Runs :mod:`paddle_tpu_torch.analysis.lifecycle` over the serving fleet
sources of ``paddle_tpu_torch/serving/`` (``engine.py``, ``router.py``,
``disagg.py``, ``kv_cache.py``, ``lora.py``, ``kv_tier.py``), from the
repository root:

    python3 -m paddle_tpu_torch.tools.lint_serving --strict
    python3 -m paddle_tpu_torch.tools.lint_serving --json
    python3 -m paddle_tpu_torch.tools.lint_serving path/to/extra.py \\
        --no-default-paths

Two checkers (see the analysis module's docstring for the semantics):

- **resource-leak / double-release / release-after-move** — dataflow
  over KV/LoRA obligations (``acquire``/``import_row``/``adopt_row``
  create, ``release*``/``deref``/``cancel`` discharge, ``export_row``
  moves), proving release-on-all-paths including raise edges and shed
  branches, with a path witness per finding;
- **unguarded-write** — writes to ``# guarded-by: <lock>`` attributes
  outside ``with self.<lock>:`` (or a ``# holds: <lock>`` method).

Accepted findings live in ``lint_serving_baseline.json`` beside this
file (``{"entries": [{"key": ..., "justification": ...}]}``); every
entry must carry a one-line justification, and stale entries are
warnings.

Exit status 1 on ERROR findings; --strict also fails on warnings.
Pure stdlib AST analysis: it imports no torch and runs anywhere.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

DEFAULT_BASELINE = os.path.join(
    os.path.dirname(os.path.abspath(__file__)),
    "lint_serving_baseline.json")


def main(argv=None):
    ap = argparse.ArgumentParser(
        "lint_serving",
        description="Static lifecycle + lock-discipline checks over "
                    "the serving modules.")
    ap.add_argument("paths", nargs="*",
                    help="extra source files to lint (on top of the "
                         "serving modules unless --no-default-paths)")
    ap.add_argument("--no-default-paths", action="store_true",
                    help="lint only the paths given on the command "
                         "line")
    ap.add_argument("--baseline", default=DEFAULT_BASELINE,
                    help="justified-findings baseline JSON "
                         "[paddle_tpu_torch/tools/"
                         "lint_serving_baseline.json]; '' disables")
    ap.add_argument("--strict", action="store_true",
                    help="treat warnings as fatal too")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="emit one JSON report on stdout instead of "
                         "text")
    args = ap.parse_args(argv)

    from ..analysis import lifecycle

    if args.no_default_paths:
        if not args.paths:
            raise SystemExit(
                "--no-default-paths needs explicit paths")
        paths = list(args.paths)
    else:
        here = os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "serving")
        paths = [os.path.join(here, f)
                 for f in lifecycle.SERVING_FILES]
        paths += list(args.paths)

    result = lifecycle.lint_files(paths)
    baseline = {}
    if args.baseline and os.path.exists(args.baseline):
        baseline = lifecycle.load_baseline(args.baseline)
        result = lifecycle.apply_baseline(result, baseline)
    failed = bool(result.errors) or (args.strict
                                     and bool(result.warnings))

    if args.as_json:
        print(json.dumps({
            "ok": not failed,
            "files": [os.path.basename(p) for p in paths],
            "errors": len(result.errors),
            "warnings": len(result.warnings),
            "baselined": len(result.baselined),
            "diagnostics": [dataclasses.asdict(d)
                            for d in result.diagnostics],
            "baselined_keys": sorted({d.key
                                      for d in result.baselined}),
        }, indent=2))
        return 1 if failed else 0

    print(f"serving lint: {len(paths)} file(s), "
          f"{len(baseline)} baseline entr(ies)")
    for d in result.diagnostics:
        print(f"  {d}")
    for d in result.baselined:
        print(f"  [baselined] {d.key}: {baseline.get(d.key, '')}")
    print(f"{'FAIL' if failed else 'ok'}: {len(result.errors)} "
          f"error(s), {len(result.warnings)} warning(s), "
          f"{len(result.baselined)} baselined")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
