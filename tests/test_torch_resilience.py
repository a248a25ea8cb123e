"""The port's resilience plane against ``paddle_tpu.resilience``: the same
fault specs parse to the same rules and fire on the same calls, site by
site (``@N``, ``@N+``, seeded probabilities, virtual-time ``@t>Ns``
triggers); ``RetryPolicy`` backs off by the same deterministic jitter,
retries and gives up the same way; ``RetryBudget`` bounds retries; and
``fault_scope`` nests and restores the flags."""

import torch_threads  # noqa: F401  (one worker's share of the cores)
import pytest

import paddle_tpu as pt
from paddle_tpu import flags as jflags
from paddle_tpu import monitor as jmonitor
from paddle_tpu.resilience import injector as jinjector
from paddle_tpu.resilience import retry as jretry
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch import monitor as tmonitor
from paddle_tpu_torch.resilience import injector as tinjector
from paddle_tpu_torch.resilience import retry as tretry

SPECS = [
    "serving.step:skip@3",
    "serving.route:drop@2+",
    "serving.alloc:skip@0.3;serving.alloc:error@0.2",
    "serving.replica:error@0;serving.submit:skip@0.5;exec.step:nan@4",
    "fs.write:error;ckpt.save:corrupt@1",
]
SITES = ["serving.step", "serving.route", "serving.alloc", "serving.replica",
         "serving.submit", "exec.step", "fs.write", "ckpt.save"]


def _fire(mod, spec, seed, calls=40):
    """What ``fault_point`` does on ``calls`` calls of each site, in a
    fixed interleaving: the kind returned, the exception's class name, or
    None."""
    out = []
    with mod.fault_scope(spec, seed=seed):
        for i in range(calls):
            for site in SITES:
                try:
                    out.append(mod.fault_point(site))
                except BaseException as e:   # InjectedPreemption too
                    out.append(type(e).__name__)
    return out


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("seed", [0, 7])
def test_seeded_firing_sequences_match_jax(spec, seed):
    jmonitor.reset()
    tmonitor.reset()
    assert _fire(tinjector, spec, seed) == _fire(jinjector, spec, seed)
    assert tmonitor.stats_with_prefix("STAT_fault_") == \
        jmonitor.stats_with_prefix("STAT_fault_")


def test_parse_spec_and_site_table_match_jax():
    spec = ("serving.step:skip@3;serving.route:drop@0.25;"
            "serving.replica:error@t>2.5s+;x.y:kill@5+")
    j, t = jinjector.parse_spec(spec, 3), tinjector.parse_spec(spec, 3)
    assert {s: [(r.kind, r.trigger) for r in rs] for s, rs in t.items()} \
        == {s: [(r.kind, r.trigger) for r in rs] for s, rs in j.items()}
    assert tinjector.FAULT_SITE_DOCS == jinjector.FAULT_SITE_DOCS
    assert tinjector.FAULT_EXIT_CODE == jinjector.FAULT_EXIT_CODE
    for bad in ("serving.step", "serving.step:boom", "a:skip@1.5",
                "a:skip@t>3", "a:skip@t>-1s"):
        with pytest.raises(ValueError) as je:
            jinjector.parse_spec(bad)
        with pytest.raises(ValueError) as te:
            tinjector.parse_spec(bad)
        assert str(te.value) == str(je.value)


def test_virtual_time_triggers_match_jax():
    def run(mod):
        now = [0.0]
        out = []
        with mod.fault_scope("serving.replica:error@t>2s;"
                             "serving.step:skip@t>3s+", seed=1,
                             time_source=lambda: now[0]):
            for t in range(6):
                now[0] = float(t)
                for site in ("serving.replica", "serving.step"):
                    try:
                        out.append(mod.fault_point(site))
                    except mod.InjectedFault as e:
                        out.append(type(e).__name__)
        return out

    assert run(tinjector) == run(jinjector)
    assert tinjector._time_source is None


def test_fault_scope_nests_and_restores():
    tflags.set_flags({"fault_spec": "", "fault_seed": 0})
    with tinjector.fault_scope("serving.step:skip", seed=4):
        assert tinjector.fault_point("serving.step") == "skip"
        with tinjector.fault_scope("serving.route:skip@1", seed=5):
            assert tflags.get_flags(["fault_spec", "fault_seed"]) == {
                "fault_spec": "serving.route:skip@1", "fault_seed": 5}
            assert tinjector.fault_point("serving.step") is None
            assert [tinjector.fault_point("serving.route")
                    for _ in range(3)] == [None, "skip", None]
        assert tflags.get_flag("fault_spec") == "serving.step:skip"
        # restoring resets the site counters, as the reference does
        assert tinjector.fault_point("serving.step") == "skip"
    assert tflags.get_flag("fault_spec") == ""
    assert not tinjector.injector_active()
    assert tinjector.fault_point("serving.step") is None


@pytest.mark.parametrize("site", ["serving.route", "serving.step", ""])
@pytest.mark.parametrize("seed", [0, 3])
def test_backoff_matches_jax(site, seed):
    pt.set_flags({"fault_seed": seed})
    tflags.set_flags({"fault_seed": seed})
    try:
        j = jretry.RetryPolicy(site=site)
        t = tretry.RetryPolicy(site=site)
        assert [t.backoff(i) for i in range(8)] == \
            [j.backoff(i) for i in range(8)]
        assert (t.max_attempts, t.base_delay, t.max_delay, t.deadline) == \
            (j.max_attempts, j.base_delay, j.max_delay, j.deadline)
    finally:
        pt.set_flags({"fault_seed": 0})
        tflags.set_flags({"fault_seed": 0})


def _flaky(n_fail, exc):
    calls = []

    def fn(x):
        calls.append(x)
        if len(calls) <= n_fail:
            raise exc(f"failure {len(calls)}")
        return x * 2
    return fn, calls


@pytest.mark.parametrize("mod,monitor", [(jretry, jmonitor),
                                         (tretry, tmonitor)],
                         ids=["jax", "port"])
def test_retry_and_exhaustion(mod, monitor):
    monitor.reset()
    slept = []
    policy = mod.RetryPolicy(max_attempts=3, base_delay=0.01, site="t.site",
                             sleep=slept.append)
    fn, calls = _flaky(2, ConnectionResetError)
    assert policy.call(fn, 21) == 42 and len(calls) == 3
    assert slept == [policy_backoff(mod, "t.site", i) for i in range(2)]
    assert monitor.stat_get("STAT_retry_t.site") == 2
    fn, calls = _flaky(5, OSError)
    with pytest.raises(mod.RetryError) as e:
        policy.call(fn, 1)
    assert isinstance(e.value.__cause__, OSError) and len(calls) == 3
    fn, calls = _flaky(5, FileNotFoundError)      # not transient
    with pytest.raises(FileNotFoundError):
        policy.call(fn, 1)
    assert len(calls) == 1
    fn, calls = _flaky(5, ValueError)             # not retried at all
    with pytest.raises(ValueError):
        policy.call(fn, 1)
    wrapped = policy.wrap(_flaky(1, OSError)[0])
    assert wrapped(4) == 8
    clock = iter([0.0, 100.0, 100.0])
    late = mod.RetryPolicy(max_attempts=5, deadline=1.0, sleep=slept.append,
                           clock=lambda: next(clock))
    fn, calls = _flaky(5, OSError)
    with pytest.raises(mod.RetryError):
        late.call(fn, 1)
    assert len(calls) == 1                        # past the deadline


def policy_backoff(mod, site, attempt):
    """A fresh policy's ``attempt``-th backoff (the jitter stream restarts
    per policy)."""
    p = mod.RetryPolicy(max_attempts=3, base_delay=0.01, site=site)
    return [p.backoff(i) for i in range(attempt + 1)][-1]


@pytest.mark.parametrize("mod", [jretry, tretry], ids=["jax", "port"])
def test_retry_budget_bounds_retries(mod):
    budget = mod.RetryBudget(ratio=0.5, reserve=2.0)
    assert budget.remaining() == 2.0 and budget.cap == 20.0
    policy = mod.RetryPolicy(max_attempts=10, base_delay=0.0,
                             sleep=lambda s: None, budget=budget,
                             site="b.site")
    fn, calls = _flaky(10, OSError)
    with pytest.raises(mod.RetryError, match="RetryBudget"):
        policy.call(fn, 1)
    assert len(calls) == 3                        # 1 try + 2 funded retries
    assert budget.snapshot()["denials"] == 1
    for _ in range(4):
        policy.call(lambda: 1)
    assert budget.remaining() == 2.0              # 4 successes x 0.5
    for _ in range(100):
        budget.deposit()
    assert budget.remaining() == budget.cap
    assert mod.RetryPolicy.from_flags("serving.route").budget is \
        mod.default_budget()
    assert mod.RetryPolicy.from_flags("serving.step").budget is None
    mod.reset_default_budget()
    assert mod.RetryPolicy.from_flags("serving.route").budget is not \
        budget


def test_resilience_flags_keep_jax_names_defaults_and_help():
    jf, tf = jflags.list_flags(), tflags.list_flags()
    for name in ("fault_spec", "fault_seed", "retry_max_attempts",
                 "retry_base_delay", "retry_max_delay", "retry_deadline",
                 "retry_budget_ratio", "retry_budget_reserve"):
        assert tf[name]["default"] == jf[name]["default"], name
        assert tf[name]["help"] == jf[name]["help"], name
