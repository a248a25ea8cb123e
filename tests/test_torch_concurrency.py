"""The port's concurrency plane (``paddle_tpu_torch/analysis/lifecycle.py``,
``analysis/concurrency.py``, ``tools/lint_serving.py``) against the
reference's (``paddle_tpu/analysis``, ``tools/lint_serving.py``) on the
CPU.

Each test of ``tests/test_concurrency_lint.py`` has a counterpart here:
- the checker cases write the reference's snippet files and both
  packages' ``lint_files`` must give identical diagnostics (check,
  severity, line, symbol, function, message and witness), besides the
  reference's expectations; the baseline and the CLI likewise;
- both checkers over the port's serving modules (and over the
  reference's) agree, and the port's lint clean under ``--strict`` with
  an empty baseline;
- the sanitizer's unit tests run on the port's module;
- the four sanitized fleet tests (replica kill, restart and scrape; a
  disaggregated decode-worker kill; a stats scrape racing restarts; the
  no-survivor path) run on port fleets;
- ``guards_of`` of the port's engine, router, disaggregated fleet and
  worker, handoff queue, host tier and LoRA pool equals the reference's
  on every attribute they share, the dispatch-ahead state among them;
  the port's own guarded attributes are named.

Every port lock is checked to come from ``make_lock``: the ones made per
object in-process, the ones made at import (the capture lock, the
metrics registry, the launch counters) in a child process started with
``FLAGS_sanitize_locks=1``.
"""

import torch_threads  # noqa: F401  (one worker's share of the cores)
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
import threading

import jax
import numpy as np
import pytest

import paddle_tpu as pt
from paddle_tpu import flags as jflags
from paddle_tpu.analysis import concurrency as jccz
from paddle_tpu.analysis import lifecycle as jlife
from paddle_tpu.models.gpt import GPTConfig as JGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JGPT
from paddle_tpu.serving import DisaggRouter as JDisaggRouter
from paddle_tpu.serving import HostBlockStore as JHostBlockStore
from paddle_tpu.serving import LoRAPool as JLoRAPool
from paddle_tpu.serving import ReplicaRouter as JReplicaRouter
from paddle_tpu.serving import ServingEngine as JServingEngine
from paddle_tpu.serving import TierManager as JTierManager
from paddle_tpu_torch import flags
from paddle_tpu_torch.analysis import concurrency as ccz
from paddle_tpu_torch.analysis import lifecycle
from paddle_tpu_torch.models import generation as tgen
from paddle_tpu_torch.models.convert import gpt_state_from_numpy
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.serving import (DisaggRouter, HostBlockStore, LoRAPool,
                                      ReplicaRouter, ServingEngine,
                                      TierManager)
from paddle_tpu_torch.tools import lint_serving as tool
from tools import lint_serving as jtool

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GEOM = dict(vocab_size=97, max_position_embeddings=64, hidden_size=32,
            num_layers=2, num_heads=4, ffn_hidden_size=64)
FLEET = dict(max_slots=2, max_len=32, buckets=[8, 16], max_queue=16,
             block_size=4)


@pytest.fixture(autouse=True)
def jax_without_x64():
    with jax.enable_x64(False):
        yield


@pytest.fixture(scope="module")
def arrays():
    pt.seed(7)
    jm = JGPT(JGPTConfig(**GEOM))
    jm.eval()
    return jm, {n: np.asarray(p.value) for n, p in jm.named_parameters()}


def _port_model(arrays):
    """A fresh port model with the reference's weights: its trace lock is
    made at its first step, so inside a sanitized test it is sanitized."""
    tm = GPTForCausalLM(GPTConfig(**GEOM), device="cpu")
    tm.load_state_dict(gpt_state_from_numpy(arrays[1], "cpu"), strict=True)
    return tm.eval()


@pytest.fixture
def sanitize():
    """FLAGS_sanitize_locks on in both packages + a clean sanitizer
    slate, restored after the test (locks built inside the test become
    sanitized)."""
    old, jold = flags.get_flag("sanitize_locks"), \
        jflags.get_flag("sanitize_locks")
    flags.set_flags({"sanitize_locks": True})
    jflags.set_flags({"sanitize_locks": True})
    ccz.reset()
    jccz.reset()
    try:
        yield ccz
    finally:
        flags.set_flags({"sanitize_locks": old})
        jflags.set_flags({"sanitize_locks": jold})
        ccz.reset()
        jccz.reset()


def _prompts(sizes, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, 97, size=n).tolist() for n in sizes]


def _leaked_per_pool(rt):
    """leaked() per *unique* pool (co-located roles share one)."""
    pools = {}
    for eng in rt.engines + rt._retiring:
        pools[id(eng.cache.pool)] = eng.cache
    out = []
    for cache in pools.values():
        cache.flush_prefix_cache()
        out.append(cache.allocator.leaked())
    return out


def _records(result):
    return [dataclasses.asdict(d) for d in result.diagnostics]


def _by_check(result, check):
    return [d for d in result.diagnostics if d.check == check]


# ------------------------------------------ the checker: snippet cases
#: the reference's snippet files, by its test's name
SNIPPETS = {
    "leak_on_exception_path": """
        class Engine:
            def leaky(self, n):
                row = self.cache.acquire(n)
                if row is None:
                    return None
                try:
                    self.fill(row)
                except RuntimeError:
                    raise
                self.cache.release_row(row)
                return True
        """,
    "leak_on_early_return_shed_branch": """
        class Engine:
            def shed_path(self, req):
                row = self.cache.acquire(req.blocks)
                if row is None:
                    return None
                if req.expired:
                    self.shed(req)
                    return False        # forgot release: leak
                self.cache.release_row(row)
                return True
        """,
    "export_then_release_double_free": """
        class Prefill:
            def handoff(self, n):
                row = self.cache.acquire(n)
                if row is None:
                    return None
                rec = self.cache.export_row(row)
                self.pending.append(rec)
                self.cache.release_row(row)     # double-free
                return True
        """,
    "plain_double_release": """
        class Engine:
            def twice(self, n):
                row = self.cache.acquire(n)
                if row is None:
                    return
                self.cache.release_row(row)
                self.cache.release_row(row)
        """,
    "clean_exception_safe_function_passes": """
        class Engine:
            def careful(self, n):
                row = self.cache.acquire(n)
                if row is None:
                    return None
                try:
                    self.fill(row)
                except RuntimeError:
                    self.cache.release_row(row)
                    raise
                self.cache.release_row(row)
                return True

            def with_finally(self, n):
                row = self.cache.acquire(n)
                if row is None:
                    return None
                try:
                    return self.fill(row)
                finally:
                    self.cache.release_row(row)
        """,
    "leaky_cancel_path_is_flagged": """
        class Engine:
            def admit_or_cancel(self, req):
                row = self.cache.acquire(req.blocks)
                if row is None:
                    return None
                if req.canceled:
                    req.slot = None
                    return False      # forgot the release: leak
                self.cache.release_row(row)
                return True
        """,
    "cancel_discharges_obligation_cleanly": """
        class Engine:
            def admit_or_cancel(self, req):
                row = self.cache.acquire(req.blocks)
                if row is None:
                    return None
                if req.canceled:
                    self.cache.cancel(row)
                    return False
                self.cache.release_row(row)
                return True
        """,
    "double_release_on_hedge_lose_is_flagged": """
        class Router:
            def resolve_hedge_lose(self, n):
                row = self.cache.acquire(n)
                if row is None:
                    return None
                self.cache.cancel(row)          # loser torn down...
                self.cache.release_row(row)     # ...twice
                return True
        """,
    "handoff_protocol_lints_clean": """
        class Fleet:
            def produce(self, n):
                row = self.cache.acquire(n)
                if row is None:
                    return None
                rec = self.cache.export_row(row)
                return rec

            def consume(self, rec, same_pool):
                row = (self.cache.import_row(rec) if same_pool
                       else self.cache.adopt_row(rec))
                if row is None:
                    rec["pool"].release_blocks(rec["blocks"])
                    return None
                self._active[row] = rec
                return row
        """,
    "guarded_write_outside_lock": """
        class Counter:
            def __init__(self):
                self._lock = make_lock("c._lock")
                self._count = 0          # guarded-by: _lock
                self._items = []         # guarded-by: _lock

            def good(self):
                with self._lock:
                    self._count += 1
                    self._items.append(1)

            def bad_rebind(self):
                self._count += 1

            def bad_mutator(self):
                self._items.append(2)

            def asserted(self):          # holds: _lock
                self._count += 1

            def waived(self):
                self._count = 0          # unguarded-ok: test reset
        """,
}

#: what the reference's test of each case asserts: (check, severity)
#: of every diagnostic, in order, and a word its witness names
EXPECT = {
    "leak_on_exception_path": ([("resource-leak", "error")], "raise"),
    "leak_on_early_return_shed_branch": ([("resource-leak", "error")],
                                         "return"),
    "export_then_release_double_free": (
        [("release-after-move", "error")], ""),
    "plain_double_release": ([("double-release", "error")], ""),
    "clean_exception_safe_function_passes": ([], ""),
    "leaky_cancel_path_is_flagged": ([("resource-leak", "error")],
                                     "return"),
    "cancel_discharges_obligation_cleanly": ([], ""),
    "double_release_on_hedge_lose_is_flagged": (
        [("double-release", "error")], ""),
    "handoff_protocol_lints_clean": ([], ""),
    "guarded_write_outside_lock": ([("unguarded-write", "error")] * 2, ""),
}

_LEAKY = """
class Engine:
    def leaky(self, n):
        row = self.cache.acquire(n)
        if row is None:
            return
        self.work(row)
"""


@pytest.mark.parametrize("case", sorted(SNIPPETS))
def test_checker_cases_give_the_reference_diagnostics(tmp_path, case):
    p = tmp_path / "fixture.py"
    p.write_text(textwrap.dedent(SNIPPETS[case]))
    port = lifecycle.lint_files([str(p)])
    ref = jlife.lint_files([str(p)])
    assert _records(port) == _records(ref)
    kinds, word = EXPECT[case]
    assert [(d.check, d.severity) for d in port.diagnostics] == kinds
    if word:
        assert word in port.diagnostics[0].witness
    if case == "guarded_write_outside_lock":
        assert {d.function.split(".")[-1] for d in port.diagnostics} == {
            "bad_rebind", "bad_mutator"}
        assert all("_lock" in d.message for d in port.diagnostics)
    if case == "export_then_release_double_free":
        assert "export" in port.diagnostics[0].message


def test_guard_declarations_inherit_across_files(tmp_path):
    """Subclass methods in another module are checked against the base's
    # guarded-by declarations (the PrefillEngine/DecodeEngine over
    ServingEngine layout), alike in both checkers."""
    base = tmp_path / "base.py"
    base.write_text(textwrap.dedent("""
        class Base:
            def __init__(self):
                self._lock = make_lock("b._lock")
                self._count = 0          # guarded-by: _lock
        """))
    sub = tmp_path / "sub.py"
    sub.write_text(textwrap.dedent("""
        class Sub(Base):
            def bump(self):
                self._count += 1
        """))
    paths = [str(base), str(sub)]
    port = lifecycle.lint_files(paths)
    assert _records(port) == _records(jlife.lint_files(paths))
    bad = _by_check(port, "unguarded-write")
    assert len(bad) == 1 and "Sub.bump" in bad[0].function


def test_baseline_suppresses_justified_findings_like_the_reference(tmp_path):
    p = tmp_path / "fixture.py"
    p.write_text(_LEAKY)
    for life in (lifecycle, jlife):
        r = life.lint_files([str(p)])
        assert len(r.errors) == 1
        key = r.errors[0].key
        bl = tmp_path / "baseline.json"
        bl.write_text(json.dumps({"entries": [
            {"key": key, "justification": "known leak, tracked"}]}))
        r2 = life.apply_baseline(life.lint_files([str(p)]),
                                 life.load_baseline(str(bl)))
        assert r2.diagnostics == [] and len(r2.baselined) == 1
        # an entry without justification is rejected, not honored
        bl.write_text(json.dumps({"entries": [{"key": key,
                                               "justification": ""}]}))
        with pytest.raises(ValueError):
            life.load_baseline(str(bl))
        # a stale entry becomes a warning so the file can only shrink
        bl.write_text(json.dumps({"entries": [
            {"key": key, "justification": "ok"},
            {"key": "resource-leak:gone.py:f:x", "justification": "ok"}]}))
        r3 = life.apply_baseline(life.lint_files([str(p)]),
                                 life.load_baseline(str(bl)))
        stale = _by_check(r3, "stale-baseline")
        assert len(stale) == 1 and stale[0].severity == "warning"
    port = lifecycle.apply_baseline(lifecycle.lint_files([str(p)]),
                                    lifecycle.load_baseline(str(bl)))
    ref = jlife.apply_baseline(jlife.lint_files([str(p)]),
                               jlife.load_baseline(str(bl)))
    assert _records(port) == _records(ref)
    assert [dataclasses.asdict(d) for d in port.baselined] == \
        [dataclasses.asdict(d) for d in ref.baselined]


def test_lint_serving_cli_and_the_port_is_clean(tmp_path, capsys):
    """The gate: the port's six serving modules lint clean under
    --strict with the shipped (empty) baseline; a leaky fixture fails;
    --json reports what the reference's CLI reports."""
    assert tool.main(["--strict"]) == 0
    out = capsys.readouterr().out
    assert "6 file(s)" in out and "ok: 0 error(s), 0 warning(s)" in out
    shipped = json.load(open(tool.DEFAULT_BASELINE))
    assert shipped == {"entries": []}
    assert tool.DEFAULT_BASELINE.endswith(os.path.join(
        "paddle_tpu_torch", "tools", "lint_serving_baseline.json"))
    p = tmp_path / "fixture.py"
    p.write_text(_LEAKY)
    assert tool.main([str(p), "--no-default-paths",
                      "--baseline", ""]) == 1
    capsys.readouterr()
    reps = []
    for t in (tool, jtool):
        assert t.main([str(p), "--no-default-paths", "--baseline", "",
                       "--json"]) == 1
        reps.append(json.loads(capsys.readouterr().out))
    assert reps[0] == reps[1]
    rep = reps[0]
    assert not rep["ok"] and rep["errors"] == 1
    d = rep["diagnostics"][0]
    assert d["check"] == "resource-leak" and d["line"] > 0
    assert d["file"].endswith("fixture.py")
    with pytest.raises(SystemExit):
        tool.main(["--no-default-paths"])


def test_lint_serving_runs_as_a_module_from_the_root():
    out = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.tools.lint_serving",
         "--strict", "--json"], cwd=ROOT, capture_output=True, text=True,
        timeout=120)
    assert out.returncode == 0, out.stderr
    rep = json.loads(out.stdout)
    assert rep["ok"] and rep["files"] == list(lifecycle.SERVING_FILES)
    assert rep["errors"] == rep["warnings"] == rep["baselined"] == 0


@pytest.mark.parametrize("tree", ["paddle_tpu_torch", "paddle_tpu"])
def test_both_checkers_agree_over_the_serving_modules(tree):
    paths = [os.path.join(ROOT, tree, "serving", f)
             for f in lifecycle.SERVING_FILES]
    port = lifecycle.lint_files(paths)
    assert _records(port) == _records(jlife.lint_files(paths))
    assert port.diagnostics == []
    assert lifecycle.SERVING_FILES == jlife.SERVING_FILES
    assert lifecycle.CHECK_DOCS == jlife.CHECK_DOCS


def test_port_serving_declares_the_reference_guards():
    """Every ``# guarded-by`` declaration and ``# holds`` marker of the
    reference's serving modules is in the port's, on the same class (the
    port's own additions besides), the dispatch-ahead state and the
    ``# holds`` markers of ``_dispatch_ahead`` / ``_take_ahead`` among
    them."""
    import ast

    def declared(tree_root):
        out = set()
        for f in lifecycle.SERVING_FILES:
            path = os.path.join(ROOT, tree_root, "serving", f)
            src = open(path).read()
            comments = lifecycle._comment_map(src)
            classes = lifecycle._collect_classes(ast.parse(src), comments)
            for name, info in classes.items():
                out |= {(f, name, "guard", a, lk)
                        for a, lk in info.guards.items()}
            for node in ast.walk(ast.parse(src)):
                if isinstance(node, ast.ClassDef):
                    for sub in node.body:
                        if isinstance(sub, ast.FunctionDef):
                            lk = comments.get(sub.lineno, "")
                            if lk.startswith("holds:"):
                                out.add((f, node.name, "holds", sub.name,
                                         lk[6:].strip()))
        return out

    ref, port = declared("paddle_tpu"), declared("paddle_tpu_torch")
    renamed = {("engine.py", "ServingEngine", "holds", "_admit_round",
                "_step_lock")}
    assert (ref - renamed) <= port, sorted(ref - renamed - port)
    assert {x for x in ref if "_ahead" in x[3]} <= port
    assert ("engine.py", "ServingEngine", "holds", "_admit_round_dense",
            "_step_lock") in port


# -------------------------------------------- the sanitizer: lock order
def test_ab_ba_inversion_recorded_not_raised(sanitize):
    a = ccz.SanitizedLock("A")
    b = ccz.SanitizedLock("B")
    with a:
        with b:
            pass
    assert ccz.cycles() == []          # one order seen: no inversion
    with b:
        with a:                        # closes the cycle
            pass
    cyc = ccz.cycles()
    assert len(cyc) == 1
    names = {n.split("#")[0] for n in cyc[0]["locks"]}
    assert names == {"A", "B"}
    assert cyc[0]["held"]              # the held-set at the bad edge
    # deduped: witnessing the same inversion again adds nothing
    with b:
        with a:
            pass
    assert len(ccz.cycles()) == 1
    rep = ccz.report()
    assert rep["lock_acquires"] >= 6 and rep["order_edges"] >= 2


def test_consistent_order_and_reentrancy_are_silent(sanitize):
    a = ccz.SanitizedLock("A")
    r = ccz.SanitizedLock("R", reentrant=True)
    for _ in range(3):
        with a:
            with r:
                with r:                # reentrant re-acquire: no edge
                    pass
    assert ccz.cycles() == []
    assert ccz.report()["order_edges"] == 1    # just A -> R


def test_inversion_across_threads(sanitize):
    a = ccz.SanitizedLock("A")
    b = ccz.SanitizedLock("B")
    done = threading.Event()

    def ab():
        with a:
            with b:
                pass
        done.set()

    t = threading.Thread(target=ab)
    t.start()
    t.join()
    assert done.is_set()
    with b:
        with a:
            pass
    assert len(ccz.cycles()) == 1


def test_contended_sanitized_lock_loses_no_update(sanitize):
    """More threads than cores bump one guarded counter under its
    sanitized lock, with the interpreter switching threads as often as
    it can: no update is lost, every outermost acquire is counted, no
    write is refused and the order graph stays empty."""
    class Box:
        def __init__(self):
            self._lock = ccz.make_lock("stress._lock")
            self._n = 0
            ccz.declare_guarded(self, {"_n": "_lock"})

    box, threads_n, per = Box(), 2 * (os.cpu_count() or 1) + 2, 200
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def bump():
            for _ in range(per):
                with box._lock:
                    box._n = box._n + 1

        threads = [threading.Thread(target=bump) for _ in range(threads_n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert box._n == threads_n * per
    rep = ccz.report()
    assert rep["lock_acquires"] == threads_n * per
    assert rep["violations"] == [] and rep["cycles"] == []
    assert rep["order_edges"] == 0


def test_make_lock_plain_when_flag_off():
    old = flags.get_flag("sanitize_locks")
    flags.set_flags({"sanitize_locks": False})
    try:
        lk = ccz.make_lock("plain")
        assert not isinstance(lk, ccz.SanitizedLock)
        assert isinstance(ccz.make_lock("re", reentrant=True),
                          type(threading.RLock()))
        with lk:
            pass                       # still a working lock
    finally:
        flags.set_flags({"sanitize_locks": old})


def test_acquires_bump_the_reference_counter(sanitize):
    from paddle_tpu_torch import observability as obs
    c = obs.counter("sanitizer_lock_acquires")
    before = c.value
    with ccz.SanitizedLock("C"):
        pass
    assert c.value == before + 1
    assert obs.metrics.DEFAULT._instruments[
        "sanitizer_lock_acquires"].help == \
        "lock acquisitions instrumented by the concurrency sanitizer " \
        "(FLAGS_sanitize_locks)"


# ------------------------------------------- the sanitizer: guarded state
def test_guarded_state_dynamic_enforcement(sanitize):
    class Box:
        def __init__(self):
            self._lock = ccz.make_lock("box._lock")
            self._n = 0
            ccz.declare_guarded(self, {"_n": "_lock"})

    b = Box()
    with b._lock:
        b._n = 1                       # fine: lock held
    with pytest.raises(ccz.GuardedStateError):
        b._n = 2
    v = ccz.violations()
    assert len(v) == 1 and v[0]["attr"] == "_n"
    assert v[0]["lock"].startswith("box._lock")
    assert b._n == 1                   # the bare write did not land
    assert ccz.guards_of(b) == {"_n": b._lock.name}
    # undeclared attributes stay writable without any lock
    b.free = 9
    assert len(ccz.violations()) == 1


def test_declare_guarded_noop_when_off():
    old = flags.get_flag("sanitize_locks")
    flags.set_flags({"sanitize_locks": False})
    try:
        class Box:
            pass

        b = Box()
        b._lock = ccz.make_lock("off._lock")
        b._n = 0
        ccz.declare_guarded(b, {"_n": "_lock"})
        b._n = 5                       # no guard class, no raise
        assert type(b) is Box
    finally:
        flags.set_flags({"sanitize_locks": old})


def test_class_swap_keeps_isinstance_and_the_subclass_declarations(
        sanitize, arrays):
    """The generated guard class subclasses the engine's own, under its
    name: isinstance holds, a DecodeEngine adds its declarations to the
    engine's, and a rebinding write without its lock raises."""
    rt = DisaggRouter(_port_model(arrays), n_prefill=1, n_decode=1,
                      device="cpu", **FLEET)
    dec = rt.decodes[0]
    assert isinstance(dec, ServingEngine) and type(dec).__name__ == \
        "DecodeEngine"
    guards = ccz.guards_of(dec)
    assert guards["adopted"] == guards["_active"] == dec._step_lock.name
    with pytest.raises(ccz.GuardedStateError):
        dec.adopted = 3
    with dec._step_lock:
        dec.adopted = 0
    assert len(ccz.violations()) == 1
    ccz.reset()


# -------------------------------------------- sanitized fleets (chaos)
def _check_port_locks(rt, model):
    """The fleet's locks and the model's trace lock are sanitized."""
    for lk in [rt._lock, generation_lock(model)] + [
            x for e in rt.engines for x in (e._lock, e._step_lock)]:
        assert isinstance(lk, ccz.SanitizedLock), lk


def generation_lock(model):
    return tgen.model_trace_lock(model)


def test_sanitized_replica_kill_restart_scrape(sanitize, arrays):
    """A full fleet lifecycle under FLAGS_sanitize_locks — submits,
    steps, a concurrent stats() scraper, kill + restart — finishes with
    zero lock-order cycles and zero guarded-state violations, and the
    sanitizer watched it."""
    model = _port_model(arrays)
    rt = ReplicaRouter(model, n_replicas=2, device="cpu", **FLEET)
    reqs = [rt.submit(p, max_new_tokens=4)
            for p in _prompts((3, 7, 5, 6), seed=11)]
    stop = threading.Event()
    errs = []

    def scraper():
        while not stop.is_set():
            try:
                st = rt.stats()
                assert st["replicas"] >= 1
            except Exception as e:     # pragma: no cover
                errs.append(e)
                return

    t = threading.Thread(target=scraper, name="scraper")
    t.start()
    try:
        rt.engines[0].step()
        rt.kill_replica(0)
        rt.restart_replica(0)
        rt.run_until_idle()
    finally:
        stop.set()
        t.join()
    assert not errs
    assert all(r.state in ("done", "shed") for r in reqs)
    _check_port_locks(rt, model)
    rep = ccz.report()
    assert rep["enabled"] is True
    assert rep["lock_acquires"] > 0 and rep["locks_tracked"] > 0
    assert rep["cycles"] == [], rep["cycles"]
    assert rep["violations"] == [], rep["violations"]
    st = rt.stats()
    assert st["kills"] == 2 and st["restarts"] == 1


def test_sanitized_disagg_kill_decode_worker(sanitize, arrays):
    """The disagg kill/re-home path (handoff splices, affinity-index
    surgery, cross-pool adoption) under the sanitizer: zero cycles,
    zero violations, zero KV-block leaks."""
    model = _port_model(arrays)
    rt = DisaggRouter(model, n_prefill=1, n_decode=2, device="cpu",
                      **FLEET)
    reqs = [rt.submit(p, max_new_tokens=4)
            for p in _prompts((3, 6, 4), seed=12)]
    for _ in range(3):
        rt.step()
    rt.kill_decode_worker(0)
    rt.run_until_idle()
    assert all(r.state in ("done", "shed") for r in reqs)
    assert all(lk == 1 for lk in _leaked_per_pool(rt))  # trash only
    assert isinstance(rt._handoff._lock, ccz.SanitizedLock)
    _check_port_locks(rt, model)
    rep = ccz.report()
    assert rep["cycles"] == [] and rep["violations"] == []
    assert rep["lock_acquires"] > 0


def test_router_stats_scrape_races_restarts(sanitize, arrays):
    """ReplicaRouter.stats() snapshots under the lock: a tight
    scrape/restart loop never raises, corrupts counts, or trips the
    guarded-state check."""
    rt = ReplicaRouter(_port_model(arrays), n_replicas=2, device="cpu",
                       **FLEET)
    errs = []
    stop = threading.Event()

    def scraper():
        while not stop.is_set():
            try:
                st = rt.stats()
                assert st["kills"] >= 0
            except Exception as e:
                errs.append(e)
                return

    t = threading.Thread(target=scraper)
    t.start()
    try:
        for _ in range(3):
            rt.restart_replica(0)
    finally:
        stop.set()
        t.join()
    assert not errs
    assert ccz.violations() == []
    st = rt.stats()
    assert st["kills"] == 3 and st["restarts"] == 3


def test_disagg_no_survivor_path_releases_blocks(arrays):
    """kill_decode_worker when NO survivor can adopt: every in-flight
    record's blocks are released and the request sheds — nothing
    leaks."""
    rt = DisaggRouter(_port_model(arrays), n_prefill=1, n_decode=2,
                      device="cpu", **{**FLEET, "max_slots": 1})
    reqs = [rt.submit(p, max_new_tokens=4)
            for p in _prompts((3, 5), seed=13)]
    for _ in range(3):
        rt.step()
    # jam the only survivor so adoption fails, then kill the other
    survivor = rt.decodes[1]
    survivor.draining = True
    rt.kill_decode_worker(0)
    survivor.draining = False
    rt.run_until_idle()
    assert all(r.state in ("done", "shed") for r in reqs)
    assert all(lk == 1 for lk in _leaked_per_pool(rt))  # trash only


def test_import_time_locks_are_sanitized_with_the_flag_in_the_env():
    """The capture lock, the metrics registry and the launch counters
    are made at import: with FLAGS_sanitize_locks=1 in the environment
    they are sanitized, under their names, and plain without it."""
    code = textwrap.dedent("""
        import json
        from paddle_tpu_torch import jit
        from paddle_tpu_torch.analysis import concurrency as ccz
        from paddle_tpu_torch.observability import metrics
        from paddle_tpu_torch.ops.cuda import _launches
        locks = {"jit._capture_lock": jit._capture_lock,
                 "metrics.registry": metrics.DEFAULT._lock,
                 "launches.lock": _launches.lock,
                 "HeldStep.lock": jit.HeldStep(None, [], {}, None,
                                               "x").lock}
        print(json.dumps({k: getattr(v, "base_name", None)
                          for k, v in locks.items()}))
        """)
    seen = {}
    for on in ("1", "0"):
        env = {**os.environ, "FLAGS_sanitize_locks": on}
        out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                             env=env, capture_output=True, text=True,
                             timeout=120)
        assert out.returncode == 0, out.stderr
        seen[on] = json.loads(out.stdout.strip().splitlines()[-1])
    assert seen["1"] == {k: k for k in seen["1"]}
    assert set(seen["0"].values()) == {None}


# -------------------------------------------------- guards_of parity
#: attributes only the port has, each written under its lock: the
#: sampling mask and the dispatch counts (engine), the copies' host time
#: and the pinned staging buffer (host tier)
PORT_ONLY = {
    "engine": {"_mask", "_mask_rows", "prefill_dispatches", "decode_steps",
               "megastep_dispatches", "_pinned"},
    "tier": {"migrate_ms", "_stage"},
    "lora": {"load_version"},
}


def test_guards_of_equal_the_reference(sanitize, arrays):
    jm, arr = arrays
    tm = _port_model(arrays)
    cfg = tm.cfg

    def objects(pkg):
        if pkg == "jax":
            eng = JServingEngine(jm, **FLEET)
            rt = JReplicaRouter(jm, n_replicas=2, **FLEET)
            dg = JDisaggRouter(jm, n_prefill=1, n_decode=1, **FLEET)
            tier = JTierManager(JHostBlockStore(
                cfg.num_layers, cfg.num_heads, cfg.head_dim, block_size=4,
                num_blocks=8))
            pool = JLoRAPool(cfg, 2, 1)
        else:
            eng = ServingEngine(tm, device="cpu", **FLEET)
            rt = ReplicaRouter(tm, n_replicas=2, device="cpu", **FLEET)
            dg = DisaggRouter(tm, n_prefill=1, n_decode=1, device="cpu",
                              **FLEET)
            tier = TierManager(HostBlockStore(
                cfg.num_layers, cfg.num_heads, cfg.head_dim, block_size=4,
                num_blocks=8))
            pool = LoRAPool(cfg, 2, 1, device="cpu")
        return {"engine": eng, "router": rt, "disagg": dg,
                "prefill": dg.prefills[0], "decode": dg.decodes[0],
                "handoff": dg._handoff, "tier": tier, "lora": pool}

    ref = {k: {a: lk.split("#")[0] for a, lk in jccz.guards_of(o).items()}
           for k, o in objects("jax").items()}
    port = {k: {a: lk.split("#")[0] for a, lk in ccz.guards_of(o).items()}
            for k, o in objects("port").items()}
    for k in ref:
        extra = PORT_ONLY.get(k if k not in ("prefill", "decode")
                              else "engine", set())
        assert {a: lk for a, lk in port[k].items()
                if a not in extra} == ref[k], k
        assert extra <= set(port[k]), k
        assert ref[k], k
    assert jccz.violations() == [] and ccz.violations() == []
