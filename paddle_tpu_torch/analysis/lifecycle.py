"""Static lifecycle + lock-discipline checks over the serving modules;
the port's copy of ``paddle_tpu/analysis/lifecycle.py`` (the port
imports nothing of the JAX package), run over the port's own serving
modules.

The static half of the serving concurrency plane (the runtime half is
:mod:`paddle_tpu_torch.analysis.concurrency`). Two source-level
checkers, surfaced through ``python3 -m
paddle_tpu_torch.tools.lint_serving``:

**Resource-lifecycle leak checker.** An AST-based dataflow pass that
models the serving resource APIs as effects on *obligations*:

- ``BlockKVCache.acquire`` / ``import_row`` / ``adopt_row`` and
  ``LoRAPool.acquire`` create an obligation (the returned handle must
  eventually be released); all three row acquirers may return ``None``
  (no capacity), which ``if x is None:`` narrowing discharges;
- ``release_row`` / ``release`` / ``release_blocks`` / ``deref`` /
  ``cancel`` discharge an obligation — discharging one that is
  already released (double-release — e.g. a hedge-loser teardown
  releasing a row the winner's settlement already released) or was
  exported (release-after-move — the classic handoff double-free) is
  an ERROR;
- ``export_row`` *moves* the obligation: the row no longer owns its
  blocks, the returned record does (a fresh obligation);
- storing a handle into longer-lived state (``self._active[row] =
  req``, ``self.x = rec``, ``pending.append(...)``), returning it, or
  passing it to a constructor transfers ownership out of the
  function's proof domain ("escape") — the holder's lifecycle owns it
  from there.

The pass interprets each function over a path-merging abstract state
(statuses union at joins), follows exception edges into ``except``
handlers (handler entry = merge of the state before every statement
of the ``try`` body), explicit ``raise`` edges, and the shed/return
exits the fault sites take. An obligation still *held* at any exit is
a leak, reported with a path witness ("acquired at line L, leaks on
the raise edge at line M"). Same-class helper calls are resolved
through one-pass summaries ("returns a fresh obligation", "releases
its parameter") — including through ``RetryPolicy...call(self.fn,
...)`` indirection, which is how every fault-site attempt runs.

**Guarded-state checker.** Attributes declared with a trailing
``# guarded-by: <lock>`` comment at their initialization must only be
written inside ``with self.<lock>:`` (rebinding writes, subscript
stores, ``del``, and container mutators like ``append``/``pop``/
``update``). A ``# holds: <lock>`` comment on a ``def`` line asserts
the caller holds that lock for the whole body (the runtime sanitizer
verifies the assertion under ``FLAGS_sanitize_locks``); a
``# unguarded-ok: <reason>`` trailing comment waives one site.
Declarations are inherited: ``PrefillEngine`` methods are checked
against ``ServingEngine``'s declarations.

Findings are :class:`SourceDiagnostic` records with file:line
coordinates; a JSON baseline file
(``paddle_tpu_torch/tools/lint_serving_baseline.json``) can carry
justified findings — every
entry needs a one-line justification, and stale entries are warnings
so the baseline can only shrink.
"""

from __future__ import annotations

import ast
import dataclasses
import io
import json
import os
import tokenize
from typing import Dict, List, Optional, Sequence, Set, Tuple

__all__ = [
    "CHECK_DOCS", "ERROR", "WARNING", "LintResult", "SourceDiagnostic",
    "SERVING_FILES", "apply_baseline", "lint_files", "lint_serving",
    "load_baseline",
]

ERROR = "error"
WARNING = "warning"

#: check name -> one-line doc (the reference renders these into its
#: README)
CHECK_DOCS = {
    "resource-leak":
        "a KV/LoRA obligation (acquire / import_row / adopt_row "
        "handle, or an exported handoff record) is still held on some "
        "exit path — including raise edges, except handlers and "
        "early-return sheds; the diagnostic carries a path witness "
        "naming the leaking edge",
    "double-release":
        "an obligation already discharged is released again "
        "(release_row / release / release_blocks / deref / cancel on "
        "a RELEASED handle — e.g. a hedge-loser teardown releasing a "
        "row its winner's settlement already released)",
    "release-after-move":
        "a row released after export_row moved its blocks into a "
        "handoff record — the classic disaggregated-handoff "
        "double-free",
    "unguarded-write":
        "a write (rebind, subscript store, del, or a container "
        "mutator) to an attribute declared `# guarded-by: <lock>` "
        "outside `with self.<lock>:` and outside a `# holds: <lock>` "
        "method; `# unguarded-ok: <reason>` waives one site",
    "stale-baseline":
        "a baseline entry no longer matches any finding — the "
        "justified-findings file can only shrink",
}

#: method name -> effect kind for the serving resource APIs.
#: ``cancel`` joins the release family: canceling a request
#: discharges whatever its stage still holds — the queued entry, the
#: active row, or the handoff record's exported references — exactly
#: once. A cancel path that pulls a slot out of ``_active`` without
#: releasing it is a leak, and a hedge-loser teardown that releases
#: the same row the winner's mirror already released is a
#: double-release; both are the findings this pass exists to catch.
FRESH_METHODS = ("acquire", "import_row", "adopt_row")
RELEASE_METHODS = ("release_row", "release", "release_blocks", "deref",
                   "cancel")
MOVE_METHODS = ("export_row",)
#: container mutators the guarded-state checker treats as writes
MUTATORS = frozenset((
    "append", "appendleft", "extend", "insert", "pop", "popleft",
    "popitem", "remove", "discard", "clear", "add", "update",
    "setdefault", "move_to_end", "sort", "reverse"))

#: the serving modules the CLI lints by default
SERVING_FILES = ("engine.py", "router.py", "disagg.py", "kv_cache.py",
                 "lora.py", "kv_tier.py")


@dataclasses.dataclass
class SourceDiagnostic:
    """One finding with source coordinates and a path witness."""

    severity: str        # ERROR | WARNING
    check: str           # resource-leak | double-release | ...
    message: str
    file: str
    line: int
    function: str
    symbol: str          # the variable / attribute involved
    witness: str = ""

    @property
    def key(self) -> str:
        """Stable baseline key — survives line drift."""
        return (f"{self.check}:{os.path.basename(self.file)}:"
                f"{self.function}:{self.symbol}")

    def __str__(self):
        loc = f"{os.path.basename(self.file)}:{self.line}"
        w = f" [{self.witness}]" if self.witness else ""
        return (f"[{self.severity.upper()}] {self.check} {loc} "
                f"({self.function}): {self.message}{w}")


class LintResult:
    """Diagnostics plus the usual errors/warnings split."""

    def __init__(self, diagnostics: Optional[
            List[SourceDiagnostic]] = None):
        self.diagnostics: List[SourceDiagnostic] = list(
            diagnostics or [])
        self.baselined: List[SourceDiagnostic] = []

    @property
    def errors(self) -> List[SourceDiagnostic]:
        return [d for d in self.diagnostics if d.severity == ERROR]

    @property
    def warnings(self) -> List[SourceDiagnostic]:
        return [d for d in self.diagnostics if d.severity == WARNING]


# ----------------------------------------------------------- comments

def _comment_map(source: str) -> Dict[int, str]:
    """line number -> comment text (without '#') for one file."""
    out: Dict[int, str] = {}
    try:
        for tok in tokenize.generate_tokens(
                io.StringIO(source).readline):
            if tok.type == tokenize.COMMENT:
                out[tok.start[0]] = tok.string.lstrip("#").strip()
    except tokenize.TokenizeError:
        pass
    return out


def _stmt_comment(comments: Dict[int, str], node: ast.AST,
                  tag: str) -> Optional[str]:
    """The value of ``# <tag>: ...`` trailing any line of ``node``."""
    end = getattr(node, "end_lineno", node.lineno)
    for line in range(node.lineno, end + 1):
        text = comments.get(line)
        if text and text.startswith(tag + ":"):
            return text[len(tag) + 1:].strip()
    return None


# ----------------------------------------------------- AST small talk

def _call_method(node: ast.Call) -> Optional[str]:
    if isinstance(node.func, ast.Attribute):
        return node.func.attr
    return None


def _receiver_is_lock(node: ast.Call) -> bool:
    """``self._lock.acquire()``-style receivers are the concurrency
    checker's turf, not a resource effect."""
    func = node.func
    if isinstance(func, ast.Attribute) and isinstance(
            func.value, ast.Attribute):
        return func.value.attr.endswith("_lock")
    return False


def _receiver_text(node: ast.Call) -> str:
    try:
        return ast.unparse(node.func)
    except Exception:
        return "<call>"


def _base_name(node: ast.AST) -> Optional[str]:
    """The root Name of ``x``, ``x[0]``, ``x[0][1]`` — the alias the
    obligation environment is keyed on."""
    while isinstance(node, ast.Subscript):
        node = node.value
    if isinstance(node, ast.Name):
        return node.id
    return None


def _names_in(node: ast.AST) -> Set[str]:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


def _self_attr(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name) and \
            node.value.id == "self":
        return node.attr
    return None


# -------------------------------------------------- function summaries

@dataclasses.dataclass
class _Summary:
    returns_fresh: bool = False
    releases_params: Tuple[str, ...] = ()


def _summarize(fn: ast.FunctionDef) -> _Summary:
    """Syntactic one-pass summary: does the function return a fresh
    obligation (a direct ``return <acquire-family>(...)``), and which
    of its parameters does it discharge?"""
    params = {a.arg for a in fn.args.args} - {"self"}
    returns_fresh = False
    released: Set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Return) and \
                isinstance(node.value, ast.Call):
            m = _call_method(node.value)
            if m in FRESH_METHODS and not _receiver_is_lock(node.value):
                returns_fresh = True
        if isinstance(node, ast.Call):
            m = _call_method(node)
            if m in RELEASE_METHODS and not _receiver_is_lock(node) \
                    and node.args:
                base = _base_name(node.args[0])
                if base in params:
                    released.add(base)
    return _Summary(returns_fresh, tuple(sorted(released)))


# ------------------------------------------------------ abstract state

HELD = "held"
RELEASED = "released"
MOVED = "moved"          # exported: the record owns the blocks now
ADOPTED = "adopted"      # record consumed by import_row/adopt_row
ESCAPED = "escaped"
VACUOUS = "vacuous"      # the acquire returned None on this path
UNBORN = "unborn"        # not yet acquired on some merged-in path


class _State:
    __slots__ = ("env", "obligs")

    def __init__(self, env=None, obligs=None):
        self.env: Dict[str, int] = dict(env or {})
        self.obligs: Dict[int, Set[str]] = {
            k: set(v) for k, v in (obligs or {}).items()}

    def copy(self) -> "_State":
        return _State(self.env, self.obligs)


def _merge(states: List[_State]) -> _State:
    if len(states) == 1:
        return states[0].copy()
    out = _State()
    all_oids: Set[int] = set()
    for st in states:
        all_oids.update(st.obligs)
        for var, oid in st.env.items():
            out.env.setdefault(var, oid)
    for oid in all_oids:
        statuses: Set[str] = set()
        for st in states:
            statuses |= st.obligs.get(oid, {UNBORN})
        out.obligs[oid] = statuses
    return out


class _Outcome:
    __slots__ = ("kind", "state", "line")

    def __init__(self, kind: str, state: _State, line: int):
        self.kind = kind          # normal|return|raise|break|continue
        self.state = state
        self.line = line


class _FuncChecker:
    """Interprets one function body over the obligation state."""

    def __init__(self, owner: "_FileChecker", fn: ast.FunctionDef,
                 func_label: str):
        self.owner = owner
        self.fn = fn
        self.func_label = func_label
        self.next_oid = 0
        self.meta: Dict[int, dict] = {}   # oid -> label/line/releases

    # -- obligation plumbing ------------------------------------------
    def _new_oblig(self, st: _State, label: str, line: int) -> int:
        oid = self.next_oid = self.next_oid + 1
        st.obligs[oid] = {HELD}
        self.meta[oid] = {"label": label, "line": line,
                          "releases": [], "consumed": []}
        return oid

    def _diag(self, severity, check, message, line, symbol,
              witness=""):
        self.owner.diags.append(SourceDiagnostic(
            severity, check, message, self.owner.path, line,
            self.func_label, symbol, witness))

    def _escape(self, st: _State, oid: int):
        statuses = st.obligs.get(oid)
        if statuses is not None:
            statuses.discard(HELD)
            statuses.add(ESCAPED)

    def _escape_names(self, st: _State, node: ast.AST):
        for name in _names_in(node):
            oid = st.env.get(name)
            if oid is not None:
                self._escape(st, oid)

    def _discharge(self, st: _State, oid: int, line: int, kind: str):
        statuses = st.obligs.get(oid)
        if statuses is None:
            return
        meta = self.meta[oid]
        live = statuses - {UNBORN, VACUOUS, ADOPTED}
        if not live and ADOPTED in statuses:
            if kind == "adopt":
                # the other arm of `import_row(...) if ... else
                # adopt_row(...)` — one consumption, not two
                return
            # dropping the source refs of an adopted/copied record is
            # the cross-pool protocol, not a double-free
            statuses.discard(ADOPTED)
            statuses.add(RELEASED)
            meta["releases"].append(line)
            return
        if live and live <= {RELEASED}:
            self._diag(
                ERROR, "double-release",
                f"{meta['label']} (acquired at line {meta['line']}) "
                f"released again at line {line}", line,
                meta["label"],
                f"prior release at line"
                f" {meta['releases'][-1] if meta['releases'] else '?'}")
        elif live and live <= {MOVED}:
            self._diag(
                ERROR, "release-after-move",
                f"{meta['label']} (acquired at line {meta['line']}) "
                f"was exported — ownership moved to the record — but "
                f"is released at line {line}: double-free of the "
                f"exported blocks", line, meta["label"],
                "export_row transfers the obligation to the returned "
                "record")
        statuses.discard(HELD)
        statuses.discard(UNBORN)
        statuses.discard(ADOPTED)
        statuses.add({"move": MOVED, "adopt": ADOPTED}.get(
            kind, RELEASED))
        meta["releases"].append(line)

    # -- expression effects -------------------------------------------
    def eval_expr(self, node: ast.AST, st: _State) -> Optional[int]:
        """Apply call effects inside ``node``; return the obligation
        the whole expression denotes, if any."""
        if isinstance(node, ast.Call):
            return self._eval_call(node, st)
        if isinstance(node, ast.IfExp):
            # `import_row(rec) if same_pool else adopt_row(rec)`:
            # exactly one branch runs; fold both branch obligations
            # into one so the binding and later narrowing track it
            self.eval_expr(node.test, st)
            oid1 = self.eval_expr(node.body, st)
            oid2 = self.eval_expr(node.orelse, st)
            if oid1 is not None and oid2 is not None and oid1 != oid2:
                self.meta[oid1]["consumed"].extend(
                    self.meta[oid2]["consumed"])
                st.obligs.pop(oid2, None)
                return oid1
            return oid1 if oid1 is not None else oid2
        if isinstance(node, (ast.Name, ast.Subscript)):
            base = _base_name(node)
            if base is not None:
                return st.env.get(base)
            if isinstance(node, ast.Subscript):
                self.eval_expr(node.value, st)
            return None
        # walk nested calls (conditions, f-strings, tuples, ...)
        for child in ast.iter_child_nodes(node):
            self.eval_expr(child, st)
        return None

    def _arg_oblig(self, st: _State, node: ast.AST) -> Optional[int]:
        base = _base_name(node)
        return st.env.get(base) if base else None

    def _eval_call(self, node: ast.Call, st: _State) -> Optional[int]:
        method = _call_method(node)
        line = node.lineno
        # effects of nested calls in the receiver and arguments first
        if isinstance(node.func, ast.Attribute):
            self.eval_expr(node.func.value, st)
        for arg in node.args:
            if isinstance(arg, ast.Call):
                self._eval_call(arg, st)
        if method and not _receiver_is_lock(node):
            if method in RELEASE_METHODS and node.args:
                oid = self._arg_oblig(st, node.args[0])
                if oid is not None:
                    self._discharge(st, oid, line, "release")
                return None
            if method in MOVE_METHODS and node.args:
                oid = self._arg_oblig(st, node.args[0])
                if oid is not None:
                    self._discharge(st, oid, line, "move")
                return self._new_oblig(
                    st, f"{_receiver_text(node)}(...)", line)
            if method in FRESH_METHODS:
                fresh = self._new_oblig(
                    st, f"{_receiver_text(node)}(...)", line)
                if method in ("import_row", "adopt_row") and node.args:
                    # the record is consumed by the splice/copy — but
                    # only on success; a None-narrowed failure branch
                    # restores it (see _narrow)
                    oid = self._arg_oblig(st, node.args[0])
                    if oid is not None:
                        self._discharge(st, oid, line, "adopt")
                        self.meta[fresh]["consumed"].append(oid)
                return fresh
            if method == "call":
                # RetryPolicy.from_flags(site).call(self.fn, *args):
                # the fault-site indirection every attempt runs through
                return self._eval_indirect(node, st)
        # same-class helper with a summary
        target = self._summary_for(node)
        if target is not None:
            summary, offset = target
            for pname in summary.releases_params:
                idx = self._param_index(node, pname, offset)
                if idx is not None and idx < len(node.args):
                    oid = self._arg_oblig(st, node.args[idx])
                    if oid is not None:
                        self._discharge(st, oid, line, "release")
            if summary.returns_fresh:
                return self._new_oblig(
                    st, f"{_receiver_text(node)}(...)", line)
            return None
        # constructors adopt their arguments (e.g. _Handoff(req, rec))
        if isinstance(node.func, ast.Name) and \
                node.func.id.lstrip("_")[:1].isupper():
            for arg in node.args:
                self._escape_names(st, arg)
        # container adoption: pending.append(rec) etc.
        if method in MUTATORS:
            for arg in node.args:
                self._escape_names(st, arg)
        return None

    def _eval_indirect(self, node: ast.Call, st: _State
                       ) -> Optional[int]:
        if not node.args:
            return None
        fn_ref = node.args[0]
        attr = _self_attr(fn_ref)
        if attr is None:
            return None
        summary = self.owner.lookup_summary(attr)
        if summary is None:
            return None
        rest = node.args[1:]
        sig = self.owner.lookup_signature(attr)
        for pname in summary.releases_params:
            if sig and pname in sig:
                idx = sig.index(pname)
                if idx < len(rest):
                    oid = self._arg_oblig(st, rest[idx])
                    if oid is not None:
                        self._discharge(st, oid, node.lineno,
                                        "release")
        if summary.returns_fresh:
            return self._new_oblig(
                st, f"{ast.unparse(fn_ref)}(...) [via RetryPolicy]",
                node.lineno)
        return None

    def _summary_for(self, node: ast.Call
                     ) -> Optional[Tuple[_Summary, int]]:
        # only `self.method(...)` calls resolve through summaries
        if not (isinstance(node.func, ast.Attribute) and
                isinstance(node.func.value, ast.Name) and
                node.func.value.id == "self"):
            return None
        summary = self.owner.lookup_summary(node.func.attr)
        if summary is None:
            return None
        return summary, 0

    def _param_index(self, node: ast.Call, pname: str,
                     offset: int) -> Optional[int]:
        attr = node.func.attr if isinstance(
            node.func, ast.Attribute) else None
        sig = self.owner.lookup_signature(attr) if attr else None
        if sig and pname in sig:
            return sig.index(pname) + offset
        return None

    # -- statements ----------------------------------------------------
    def exec_stmts(self, stmts: Sequence[ast.stmt], st: _State,
                   snapshots: Optional[List[_State]] = None
                   ) -> List[_Outcome]:
        outs: List[_Outcome] = []
        cur = st
        for stmt in stmts:
            if snapshots is not None:
                snapshots.append(cur.copy())
            res = self.exec_stmt(stmt, cur)
            normals = [o for o in res if o.kind == "normal"]
            outs.extend(o for o in res if o.kind != "normal")
            if not normals:
                return outs
            cur = _merge([o.state for o in normals])
        outs.append(_Outcome("normal", cur,
                             stmts[-1].end_lineno if stmts else 0))
        return outs

    def exec_stmt(self, stmt: ast.stmt, st: _State) -> List[_Outcome]:
        line = stmt.lineno
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef, ast.Import,
                             ast.ImportFrom, ast.Global,
                             ast.Nonlocal, ast.Pass)):
            return [_Outcome("normal", st, line)]
        if isinstance(stmt, ast.Assign):
            oid = self.eval_expr(stmt.value, st)
            leak_ok = _stmt_comment(self.owner.comments, stmt,
                                    "leak-ok")
            if oid is not None and leak_ok is not None:
                self._escape(st, oid)
                oid = None
            store_escapes = False
            for target in stmt.targets:
                if isinstance(target, (ast.Attribute, ast.Subscript)):
                    store_escapes = True
                elif isinstance(target, ast.Name):
                    if oid is not None:
                        st.env[target.id] = oid
                    else:
                        st.env.pop(target.id, None)
                elif isinstance(target, (ast.Tuple, ast.List)):
                    for el in target.elts:
                        if isinstance(el, ast.Name):
                            if oid is not None:
                                st.env[el.id] = oid
                            else:
                                st.env.pop(el.id, None)
            if store_escapes:
                # storing into attributes/containers hands ownership
                # to the holder: self._active[row] = req commits row
                self._escape_names(st, stmt)
                if oid is not None:
                    self._escape(st, oid)
            return [_Outcome("normal", st, line)]
        if isinstance(stmt, ast.AnnAssign):
            if stmt.value is not None:
                oid = self.eval_expr(stmt.value, st)
                if isinstance(stmt.target, ast.Name):
                    if oid is not None:
                        st.env[stmt.target.id] = oid
                    else:
                        st.env.pop(stmt.target.id, None)
                elif oid is not None:
                    self._escape(st, oid)
            return [_Outcome("normal", st, line)]
        if isinstance(stmt, ast.AugAssign):
            self.eval_expr(stmt.value, st)
            return [_Outcome("normal", st, line)]
        if isinstance(stmt, ast.Expr):
            oid = self.eval_expr(stmt.value, st)
            if oid is not None:
                # an unassigned acquire (`pool.acquire(tenant)`) is
                # tracked by the pool itself, keyed on the argument —
                # the return value was never this function's handle
                self._escape(st, oid)
            return [_Outcome("normal", st, line)]
        if isinstance(stmt, ast.Return):
            if stmt.value is not None:
                oid = self.eval_expr(stmt.value, st)
                if oid is not None:
                    self._escape(st, oid)
                self._escape_names(st, stmt.value)
            return [_Outcome("return", st, line)]
        if isinstance(stmt, ast.Raise):
            if stmt.exc is not None:
                self.eval_expr(stmt.exc, st)
            return [_Outcome("raise", st, line)]
        if isinstance(stmt, ast.If):
            return self._exec_if(stmt, st)
        if isinstance(stmt, (ast.While, ast.For)):
            return self._exec_loop(stmt, st)
        if isinstance(stmt, ast.Try):
            return self._exec_try(stmt, st)
        if isinstance(stmt, ast.With):
            for item in stmt.items:
                self.eval_expr(item.context_expr, st)
            return self.exec_stmts(stmt.body, st)
        if isinstance(stmt, ast.Break):
            return [_Outcome("break", st, line)]
        if isinstance(stmt, ast.Continue):
            return [_Outcome("continue", st, line)]
        if isinstance(stmt, (ast.Delete, ast.Assert)):
            for child in ast.iter_child_nodes(stmt):
                self.eval_expr(child, st)
            return [_Outcome("normal", st, line)]
        return [_Outcome("normal", st, line)]

    def _narrow(self, test: ast.AST, st: _State, branch: bool):
        """``if x is None:`` — in the None branch the acquire failed,
        so the obligation is vacuous there (nothing to release)."""
        if not (isinstance(test, ast.Compare) and
                len(test.ops) == 1 and
                isinstance(test.ops[0], (ast.Is, ast.IsNot)) and
                isinstance(test.comparators[0], ast.Constant) and
                test.comparators[0].value is None):
            return
        base = _base_name(test.left)
        oid = st.env.get(base) if base else None
        if oid is None:
            return
        is_none_branch = branch if isinstance(test.ops[0], ast.Is) \
            else not branch
        if is_none_branch:
            st.obligs[oid] = {VACUOUS}
            # the splice/copy failed, so the source record was NOT
            # consumed on this path — restore its obligation
            for consumed in self.meta.get(oid, {}).get("consumed", ()):
                if consumed in st.obligs:
                    st.obligs[consumed] = {HELD}

    def _exec_if(self, stmt: ast.If, st: _State) -> List[_Outcome]:
        self.eval_expr(stmt.test, st)
        body_st, else_st = st.copy(), st.copy()
        self._narrow(stmt.test, body_st, True)
        self._narrow(stmt.test, else_st, False)
        outs = self.exec_stmts(stmt.body, body_st)
        if stmt.orelse:
            outs += self.exec_stmts(stmt.orelse, else_st)
        else:
            outs.append(_Outcome("normal", else_st, stmt.lineno))
        return outs

    def _exec_loop(self, stmt, st: _State) -> List[_Outcome]:
        if isinstance(stmt, ast.While):
            self.eval_expr(stmt.test, st)
        else:
            self.eval_expr(stmt.iter, st)
            if isinstance(stmt.target, ast.Name):
                st.env.pop(stmt.target.id, None)
        entry = st.copy()
        outs = self.exec_stmts(stmt.body, st.copy())
        exit_states = [entry]
        passthrough: List[_Outcome] = []
        for o in outs:
            if o.kind in ("normal", "continue", "break"):
                exit_states.append(o.state)
            else:
                passthrough.append(o)
        merged = _merge(exit_states)
        if stmt.orelse:
            tail = self.exec_stmts(stmt.orelse, merged)
            normals = [o.state for o in tail if o.kind == "normal"]
            passthrough += [o for o in tail if o.kind != "normal"]
            if normals:
                passthrough.append(_Outcome(
                    "normal", _merge(normals), stmt.lineno))
            return passthrough
        passthrough.append(_Outcome("normal", merged, stmt.lineno))
        return passthrough

    def _exec_try(self, stmt: ast.Try, st: _State) -> List[_Outcome]:
        snapshots: List[_State] = []
        body_outs = self.exec_stmts(stmt.body, st.copy(), snapshots)
        handler_entry_states = list(snapshots)
        caught: List[_Outcome] = []
        passthrough: List[_Outcome] = []
        for o in body_outs:
            if o.kind == "raise" and stmt.handlers:
                handler_entry_states.append(o.state)
            else:
                passthrough.append(o)
        outs: List[_Outcome] = []
        if stmt.handlers and handler_entry_states:
            entry = _merge(handler_entry_states)
            for handler in stmt.handlers:
                h_st = entry.copy()
                if handler.name:
                    h_st.env.pop(handler.name, None)
                outs += self.exec_stmts(handler.body, h_st)
        normals = [o for o in passthrough if o.kind == "normal"]
        rest = [o for o in passthrough if o.kind != "normal"]
        if stmt.orelse and normals:
            outs += self.exec_stmts(
                stmt.orelse, _merge([o.state for o in normals]))
        else:
            outs += normals
        outs += rest
        outs += caught
        if stmt.finalbody:
            final_outs: List[_Outcome] = []
            for o in outs:
                f = self.exec_stmts(stmt.finalbody, o.state)
                for fo in f:
                    if fo.kind == "normal":
                        final_outs.append(
                            _Outcome(o.kind, fo.state, o.line))
                    else:
                        final_outs.append(fo)
            return final_outs
        return outs

    # -- entry ---------------------------------------------------------
    def run(self):
        st = _State()
        outs = self.exec_stmts(self.fn.body, st)
        reported: Set[Tuple[int, str]] = set()
        for o in outs:
            for oid, statuses in o.state.obligs.items():
                if HELD not in statuses:
                    continue
                meta = self.meta[oid]
                key = (oid, o.kind)
                if key in reported:
                    continue
                reported.add(key)
                exit_desc = {"return": "the return at line",
                             "raise": "the raise edge at line",
                             "normal": "fall-through exit at line",
                             }.get(o.kind, o.kind + " at line")
                partial = len(statuses - {HELD, UNBORN}) > 0
                qual = ("not released on every path through "
                        if partial else "never released before ")
                self._diag(
                    ERROR, "resource-leak",
                    f"{meta['label']} acquired at line "
                    f"{meta['line']} is {qual}{exit_desc} {o.line}",
                    meta["line"], meta["label"],
                    f"acquired at line {meta['line']}; leaks via "
                    f"{o.kind} at line {o.line}" +
                    (f"; releases seen at lines "
                     f"{meta['releases']}" if meta["releases"]
                     else ""))


# --------------------------------------------------- guarded-state pass

class _ClassInfo:
    __slots__ = ("name", "bases", "guards", "node")

    def __init__(self, name, bases, guards, node):
        self.name = name
        self.bases = bases          # base class simple names
        self.guards = guards        # attr -> lock attr name
        self.node = node


def _collect_classes(tree: ast.Module, comments: Dict[int, str]
                     ) -> Dict[str, _ClassInfo]:
    out: Dict[str, _ClassInfo] = {}
    for node in tree.body:
        if not isinstance(node, ast.ClassDef):
            continue
        bases = []
        for b in node.bases:
            if isinstance(b, ast.Name):
                bases.append(b.id)
            elif isinstance(b, ast.Attribute):
                bases.append(b.attr)
        guards: Dict[str, str] = {}
        for sub in ast.walk(node):
            if isinstance(sub, (ast.Assign, ast.AnnAssign)):
                tag = _stmt_comment(comments, sub, "guarded-by")
                if tag is None:
                    continue
                targets = (sub.targets
                           if isinstance(sub, ast.Assign)
                           else [sub.target])
                for t in targets:
                    attr = _self_attr(t)
                    if attr is not None:
                        guards[attr] = tag
        out[node.name] = _ClassInfo(node.name, bases, guards, node)
    return out


def _resolved_guards(cls: _ClassInfo,
                     registry: Dict[str, _ClassInfo]
                     ) -> Dict[str, str]:
    """Own + inherited guard declarations (nearest class wins)."""
    out: Dict[str, str] = {}
    seen: Set[str] = set()
    stack = [cls.name]
    order: List[str] = []
    while stack:
        name = stack.pop(0)
        if name in seen or name not in registry:
            continue
        seen.add(name)
        order.append(name)
        stack.extend(registry[name].bases)
    for name in reversed(order):       # base first, subclass wins
        out.update(registry[name].guards)
    return out


class _GuardChecker:
    """Lexical lock-discipline pass over one class's methods."""

    def __init__(self, owner: "_FileChecker", cls: _ClassInfo,
                 guards: Dict[str, str]):
        self.owner = owner
        self.cls = cls
        self.guards = guards

    def check(self):
        for node in self.cls.node.body:
            if isinstance(node, ast.FunctionDef) and \
                    node.name != "__init__":
                held: Set[str] = set()
                holds = _stmt_comment(self.owner.comments, node,
                                      "holds")
                if holds:
                    held |= {h.strip() for h in holds.split(",")}
                self._walk(node.body, held, node.name)

    def _mutation(self, attr: str, line: int, stmt: ast.stmt,
                  held: Set[str], func: str, what: str):
        lock = self.guards.get(attr)
        if lock is None or lock in held:
            return
        if _stmt_comment(self.owner.comments, stmt,
                         "unguarded-ok") is not None:
            return
        self.owner.diags.append(SourceDiagnostic(
            ERROR, "unguarded-write",
            f"{what} of {self.cls.name}.{attr} outside "
            f"'with self.{lock}:' (declared '# guarded-by: {lock}')",
            self.owner.path, line, f"{self.cls.name}.{func}", attr,
            f"holding {sorted(held) or 'no locks'}"))

    def _walk(self, stmts: Sequence[ast.stmt], held: Set[str],
              func: str):
        for stmt in stmts:
            if isinstance(stmt, ast.With):
                added = set()
                for item in stmt.items:
                    attr = _self_attr(item.context_expr)
                    if attr is not None:
                        added.add(attr)
                self._walk(stmt.body, held | added, func)
                continue
            if isinstance(stmt, ast.FunctionDef):
                inner: Set[str] = set()
                holds = _stmt_comment(self.owner.comments, stmt,
                                      "holds")
                if holds:
                    inner |= {h.strip() for h in holds.split(",")}
                self._walk(stmt.body, inner, func)
                continue
            if isinstance(stmt, (ast.Assign, ast.AnnAssign,
                                 ast.AugAssign)):
                targets = (stmt.targets
                           if isinstance(stmt, ast.Assign)
                           else [stmt.target])
                for t in targets:
                    attr = _self_attr(t)
                    if attr is not None:
                        self._mutation(attr, stmt.lineno, stmt, held,
                                       func, "write")
                    elif isinstance(t, ast.Subscript):
                        attr = _self_attr(t.value)
                        if attr is not None:
                            self._mutation(attr, stmt.lineno, stmt,
                                           held, func,
                                           "subscript store")
            if isinstance(stmt, ast.Delete):
                for t in stmt.targets:
                    attr = _self_attr(t)
                    if attr is None and isinstance(t, ast.Subscript):
                        attr = _self_attr(t.value)
                    if attr is not None:
                        self._mutation(attr, stmt.lineno, stmt, held,
                                       func, "del")
            # container mutators in THIS statement's own expressions —
            # compound statements contribute only their headers here;
            # their bodies are visited by the recursion below (which
            # carries the right held-lock set past inner `with`s)
            if isinstance(stmt, (ast.If, ast.While)):
                scan: List[ast.AST] = [stmt.test]
            elif isinstance(stmt, ast.For):
                scan = [stmt.iter]
            elif isinstance(stmt, ast.Try):
                scan = []
            else:
                scan = [stmt]
            for root in scan:
                for node in ast.walk(root):
                    if isinstance(node, ast.Call) and \
                            isinstance(node.func, ast.Attribute) and \
                            node.func.attr in MUTATORS:
                        attr = _self_attr(node.func.value)
                        if attr is not None:
                            self._mutation(attr, node.lineno, stmt,
                                           held, func,
                                           f".{node.func.attr}() call")
            for body in ("body", "orelse", "finalbody"):
                sub = getattr(stmt, body, None)
                if sub:
                    self._walk(sub, held, func)
            for handler in getattr(stmt, "handlers", ()) or ():
                self._walk(handler.body, held, func)


# ------------------------------------------------------------- drivers

class _FileChecker:
    def __init__(self, path: str, source: str,
                 class_registry: Dict[str, _ClassInfo]):
        self.path = path
        self.source = source
        self.comments = _comment_map(source)
        self.tree = ast.parse(source, filename=path)
        self.diags: List[SourceDiagnostic] = []
        self.class_registry = class_registry
        self.summaries: Dict[str, _Summary] = {}
        self.signatures: Dict[str, List[str]] = {}
        self._collect_summaries()

    def _collect_summaries(self):
        for node in ast.walk(self.tree):
            if isinstance(node, ast.FunctionDef):
                self.summaries.setdefault(node.name, _summarize(node))
                self.signatures.setdefault(
                    node.name,
                    [a.arg for a in node.args.args
                     if a.arg != "self"])

    def lookup_summary(self, name: str) -> Optional[_Summary]:
        return self.summaries.get(name)

    def lookup_signature(self, name: str) -> Optional[List[str]]:
        return self.signatures.get(name)

    def run(self) -> List[SourceDiagnostic]:
        # lifecycle pass over every function (methods + module level)
        for node in ast.walk(self.tree):
            if isinstance(node, ast.FunctionDef):
                label = node.name
                parent = getattr(node, "_lint_class", None)
                if parent:
                    label = f"{parent}.{node.name}"
                _FuncChecker(self, node, label).run()
        # guarded-state pass
        classes = _collect_classes(self.tree, self.comments)
        for cls in classes.values():
            guards = _resolved_guards(cls, self.class_registry)
            if guards:
                _GuardChecker(self, cls, guards).check()
        return self.diags


def _tag_methods(tree: ast.Module):
    for node in tree.body:
        if isinstance(node, ast.ClassDef):
            for sub in node.body:
                if isinstance(sub, ast.FunctionDef):
                    sub._lint_class = node.name


def lint_files(paths: Sequence[str]) -> LintResult:
    """Run both checkers over the given source files. Guard
    declarations are collected across ALL files first so subclasses in
    one module inherit declarations from their base in another."""
    sources: Dict[str, str] = {}
    registry: Dict[str, _ClassInfo] = {}
    for path in paths:
        with open(path, "r") as f:
            sources[path] = f.read()
        tree = ast.parse(sources[path], filename=path)
        comments = _comment_map(sources[path])
        for name, info in _collect_classes(tree, comments).items():
            registry.setdefault(name, info)
    result = LintResult()
    for path in paths:
        checker = _FileChecker(path, sources[path], registry)
        _tag_methods(checker.tree)
        result.diagnostics.extend(checker.run())
    result.diagnostics.sort(
        key=lambda d: (d.file, d.line, d.check, d.symbol))
    return result


# ------------------------------------------------------------ baseline

def load_baseline(path: str) -> Dict[str, str]:
    """Baseline format: ``{"entries": [{"key": <diagnostic key>,
    "justification": <one line>}]}`` — every entry MUST carry a
    non-empty justification (enforced here, not on faith)."""
    with open(path, "r") as f:
        data = json.load(f)
    out: Dict[str, str] = {}
    for ent in data.get("entries", ()):
        key = ent.get("key", "")
        why = (ent.get("justification") or "").strip()
        if not key:
            raise ValueError(f"baseline entry without a key: {ent}")
        if not why:
            raise ValueError(
                f"baseline entry {key!r} has no justification — "
                "every accepted finding needs one line of why")
        out[key] = why
    return out


def apply_baseline(result: LintResult,
                   baseline: Dict[str, str]) -> LintResult:
    """Move baselined findings out of ``diagnostics``; stale baseline
    entries (nothing matches any more) become warnings so the file
    can only shrink."""
    keep: List[SourceDiagnostic] = []
    matched: Set[str] = set()
    for d in result.diagnostics:
        if d.key in baseline:
            matched.add(d.key)
            result.baselined.append(d)
        else:
            keep.append(d)
    result.diagnostics = keep
    for key in sorted(set(baseline) - matched):
        result.diagnostics.append(SourceDiagnostic(
            WARNING, "stale-baseline",
            f"baseline entry {key!r} matches no current finding — "
            "remove it", "<baseline>", 0, "-", key))
    return result


def lint_serving(paths: Optional[Sequence[str]] = None,
                 baseline_path: Optional[str] = None) -> LintResult:
    """Lint the serving modules (or explicit ``paths``), applying the
    baseline when given."""
    if paths is None:
        here = os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))
        paths = [os.path.join(here, "serving", f)
                 for f in SERVING_FILES]
    result = lint_files(list(paths))
    if baseline_path and os.path.exists(baseline_path):
        result = apply_baseline(result, load_baseline(baseline_path))
    return result
