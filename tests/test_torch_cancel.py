"""Cancel, hard deadlines and hedged prefill in the port
(``paddle_tpu_torch/serving/engine.py`` and ``router.py``) against
``paddle_tpu.serving`` on the CPU, each scenario run once per package on
the same weights (carried across by ``gpt_state_from_numpy``), prompts
and clock, and what it observes must be equal: ``cancel`` while queued
and mid-decode (f32; int8 pools with spec K 2; megastep 4; the dense
cache), its idempotence, the freed row's reuse by the next request with
tokens equal, the row's block table back on the trash block; a
``deadline_ms`` that expires while queued or mid-decode, within one step
(and keeps a megastep engine on single steps when it is tighter than a
megastep); the router's hedge race against a straggler
(``stats()["hedges"]``, tokens, steps to the first token, the loser
canceled with reason "hedge_lose"), a dry hedge bucket, a fleet cancel
of a hedged pair, and a kill that finds a request past its hard
deadline. Every pool ends holding only its trash block. The model is the
small GPT of ``tests/test_serving_cancel.py`` (vocab 97, h 32, 2 layers,
4 heads) drawn at ``init_std`` 0.2. The JAX side runs with 64-bit types
off."""

import torch_threads  # noqa: F401  (one worker's share of the cores)
from types import SimpleNamespace

import jax
import numpy as np
import pytest

import paddle_tpu as pt
from paddle_tpu.models.gpt import GPTConfig as JGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JGPT
from paddle_tpu.resilience import reset_default_budget as jreset_budget
from paddle_tpu.serving import ReplicaRouter as JReplicaRouter
from paddle_tpu.serving import ServingEngine as JServingEngine
from paddle_tpu_torch.models.convert import gpt_state_from_numpy
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.resilience import reset_default_budget as treset_budget
from paddle_tpu_torch.serving import ReplicaRouter, ServingEngine

GEOM = dict(vocab_size=97, max_position_embeddings=64, hidden_size=32,
            num_layers=2, num_heads=4, ffn_hidden_size=64, init_std=0.2)
ONE_SLOT = dict(max_slots=1, max_len=32, buckets=[8], max_queue=8,
                block_size=4)


@pytest.fixture(autouse=True)
def jax_without_x64():
    with jax.enable_x64(False):
        yield


@pytest.fixture(scope="module")
def pkgs():
    pt.seed(7)
    jm = JGPT(JGPTConfig(**GEOM))
    jm.eval()
    arrays = {n: np.asarray(p.value) for n, p in jm.named_parameters()}
    tm = GPTForCausalLM(GPTConfig(**GEOM), device="cpu")
    tm.load_state_dict(gpt_state_from_numpy(arrays, "cpu"), strict=True)
    tm.eval()
    return (SimpleNamespace(name="jax", model=jm, Engine=JServingEngine,
                            Router=JReplicaRouter,
                            reset_budget=jreset_budget, kw={}),
            SimpleNamespace(name="port", model=tm, Engine=ServingEngine,
                            Router=ReplicaRouter,
                            reset_budget=treset_budget,
                            kw={"device": "cpu"}))


class _Clock:
    def __init__(self):
        self.t = 0.0

    def now(self):
        return self.t


def _prompts(sizes, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, 97, size=n).tolist() for n in sizes]


def _both(pkgs, scenario):
    out = []
    for pkg in pkgs:
        pkg.reset_budget()
        out.append(scenario(pkg))
    assert out[1] == out[0]
    return out[0]


def _leaked(eng):
    if not eng.paged:
        return 1
    eng.cache.flush_prefix_cache()
    return eng.cache.allocator.leaked()


def _drive(eng, clk, step_s=0.004):
    while not eng.idle:
        eng.step()
        clk.t += step_s


def _view(r):
    return (r.state, r.shed_reason, list(r.tokens), r.first_token_at,
            r.finished_at)


def test_cancel_queued_is_idempotent(pkgs):
    def run(pkg):
        clk = _Clock()
        eng = pkg.Engine(pkg.model, **ONE_SLOT, clock=clk.now, **pkg.kw)
        p1, p2 = _prompts((4, 5), seed=1)
        r1 = eng.submit(p1, max_new_tokens=8)
        r2 = eng.submit(p2, max_new_tokens=4)
        eng.step()
        out = [eng.cancel(r2.id), eng.cancel(r2.id),
               eng.cancel(10_000_000)]
        out = [None if o is None else (o["stage"], o["reason"])
               for o in out]
        _drive(eng, clk)
        out.append(eng.cancel(r1.id))
        st = eng.stats()
        return (out, _view(r1), _view(r2), st["canceled"],
                st["canceled_total"], st["completed"], _leaked(eng))

    out = _both(pkgs, run)
    assert out[0] == [("queued", "client"), None, None, None]
    assert out[2][:2] == ("canceled", "client")
    assert out[3:] == ({"client": 1}, 1, 1, 1)


@pytest.mark.parametrize("kind,kw", [
    ("f32", {}),
    ("int8 spec 2", {"kv_dtype": "int8", "spec_tokens": 2}),
    ("megastep 4", {"megastep": 4}),
    ("dense", {"paged": False}),
])
def test_cancel_mid_decode_frees_the_row_for_the_next(pkgs, kind, kw):
    """Cancel after the first token: the row and its blocks come back at
    once (its table row on the trash block), and the queued request
    decodes in it with the tokens the reference gives."""
    def run(pkg):
        clk = _Clock()
        eng = pkg.Engine(pkg.model, **ONE_SLOT, **kw, clock=clk.now,
                         **pkg.kw)
        p1, p2 = _prompts((4, 6), seed=2)
        r1 = eng.submit(p1, max_new_tokens=12)
        r2 = eng.submit(p2, max_new_tokens=6)
        eng.step()
        clk.t += 0.004
        slot = r1.slot
        out = eng.cancel(r1.id, reason="disconnect")
        table = (eng.cache.tables[slot].tolist() if eng.paged else None)
        free = eng.cache.num_free
        _drive(eng, clk)
        return ((out["stage"], out["reason"]), _view(r1), _view(r2),
                table, free, eng.stats()["canceled"], _leaked(eng))

    out = _both(pkgs, run)
    assert out[0] == ("decode", "disconnect")
    assert out[1][:2] == ("canceled", "disconnect")
    assert out[2][0] == "done" and len(out[2][2]) == 6
    if out[3] is not None:
        assert set(out[3]) == {0}
    assert out[4] == 1 and out[6] == 1


def test_deadline_ms_validation(pkgs):
    for pkg in pkgs:
        eng = pkg.Engine(pkg.model, **ONE_SLOT, **pkg.kw)
        for bad in (0, -5.0):
            with pytest.raises(ValueError, match="deadline_ms"):
                eng.submit(_prompts((4,))[0], max_new_tokens=2,
                           deadline_ms=bad)


@pytest.mark.parametrize("megastep", [1, 4])
def test_hard_deadline_ends_a_request_within_one_step(pkgs, megastep):
    """A ``deadline_ms`` that passes mid-decode cancels the request in
    the next step, before admission, so the waiting request takes the row
    in that step; one that passes while queued cancels it there. At
    megastep 4 a deadline tighter than a megastep keeps the batch on
    single steps."""
    def run(pkg):
        clk = _Clock()
        eng = pkg.Engine(pkg.model, **ONE_SLOT, megastep=megastep,
                         slo_tpot_ms=10.0, clock=clk.now, **pkg.kw)
        calls = {"single": 0, "megastep": 0}
        for name, attr in (("single", "_decode"),
                           ("megastep", "_decode_megastep")):
            def counted(*a, _f=getattr(eng, attr), _n=name):
                calls[_n] += 1
                return _f(*a)
            setattr(eng, attr, counted)
        p1, p2, p3 = _prompts((4, 6, 5), seed=4)
        r1 = eng.submit(p1, max_new_tokens=12, deadline_ms=100.0)
        r2 = eng.submit(p2, max_new_tokens=2)
        r3 = eng.submit(p3, max_new_tokens=2, deadline_ms=50.0)
        eng.step()
        clk.t += 0.01
        eng.step()
        clk.t = 0.25
        eng.step()
        after = (_view(r1), r2.first_token_at)
        _drive(eng, clk)
        st = eng.stats()
        return (after, _view(r2), r1.hard_deadline, st["canceled"],
                st["completed"], calls, _leaked(eng), _view(r3))

    out = _both(pkgs, run)
    (r1, r2_first), r2 = out[0], out[1]
    assert r1[:2] == ("canceled", "deadline") and r2_first == 0.25
    assert out[7][:2] == ("canceled", "deadline") and out[7][3] is None
    assert out[2] == pytest.approx(0.1)
    assert out[3] == {"deadline": 2} and out[4] == 1
    assert out[6] == 1
    if megastep > 1:        # 100 ms at 10 ms per token < 4 tokens first
        assert out[5]["single"] >= 1


def _straggler(eng, skip=8, pin_ms=500.0):
    """``tests/test_serving_cancel.py``'s straggler: predicted slow (a
    pinned prefill cost) and slow (its first ``skip`` steps idle)."""
    eng._prefill_ms_pin = pin_ms
    orig = eng.step
    state = {"n": 0}

    def lazy_step():
        state["n"] += 1
        if state["n"] <= skip:
            return False
        return orig()
    eng.step = lazy_step
    return state


def _hedge_router(pkg, clk, **kw):
    return pkg.Router(pkg.model, n_replicas=2, max_slots=2, max_len=32,
                      buckets=[8, 16], max_queue=16, block_size=4,
                      clock=clk.now, **kw, **pkg.kw)


def _first_token_steps(rt, clk, req, budget=400):
    clk.t += 0.01             # past the hedge delay
    for n in range(1, budget + 1):
        rt.step()
        clk.t += 0.004
        if req.first_token_at is not None:
            return n
    raise AssertionError(f"no first token in {budget} steps")


def _router_drive(rt, clk):
    while not rt.idle:
        rt.step()
        clk.t += 0.004


def _no_leaks(rt):
    return [_leaked(e) for e in rt.engines + rt._retiring]


@pytest.mark.parametrize("hedge_ms", [0.0, 5.0])
def test_hedge_race_like_the_reference(pkgs, hedge_ms):
    """A straggler primary: hedged, the clone fires after the delay,
    wins, its tokens are mirrored onto the caller's handle and the
    primary is canceled ("hedge_lose"); unhedged, the request waits out
    the straggler. Both packages step the same number of times."""
    prompt = _prompts((4,), seed=5)[0]

    def run(pkg):
        clk = _Clock()
        rt = _hedge_router(pkg, clk, hedge_ms=hedge_ms)
        _straggler(rt.engines[0])
        req = rt.submit(prompt, max_new_tokens=4)
        steps = _first_token_steps(rt, clk, req)
        _router_drive(rt, clk)
        st = rt.stats()
        return (steps, _view(req), st.get("hedges"), st["canceled"],
                [len(r) for r in (rt.results(),)], _no_leaks(rt))

    out = _both(pkgs, run)
    assert out[1][0] == "done"
    if hedge_ms:
        h = out[2]
        assert h["fired"] == 1 and h["wins"] == 1 and h["pending"] == 0
        assert out[3] == {"hedge_lose": 1}
    else:
        assert out[2] is None
    assert out[4] == [1]              # the clone is not a result
    assert set(out[5]) == {1}


def test_dry_hedge_bucket_and_fleet_cancel_of_a_pair(pkgs):
    """``hedge_budget`` 0: one hedge from the starting token, the next
    dropped dry. Then a fleet cancel of a request whose hedge fired
    cancels the clone too (reason "duplicate")."""
    def run(pkg):
        clk = _Clock()
        rt = _hedge_router(pkg, clk, hedge_ms=5.0, hedge_budget=0.0)
        state = _straggler(rt.engines[0])
        p1, p2 = _prompts((4, 5), seed=6)
        r1 = rt.submit(p1, max_new_tokens=4)
        _first_token_steps(rt, clk, r1)
        _router_drive(rt, clk)
        fired = rt.stats()["hedges"]["fired"]
        state["n"] = 0
        r2 = rt.submit(p2, max_new_tokens=4)
        _first_token_steps(rt, clk, r2)
        _router_drive(rt, clk)
        h1 = rt.stats()["hedges"]

        rt2 = _hedge_router(pkg, clk, hedge_ms=5.0, hedge_budget=1.0)
        _straggler(rt2.engines[0], skip=50)
        # the peer's two rows busy, so the clone waits in its queue
        busy = [rt2.engines[1].submit(p, max_new_tokens=12)
                for p in _prompts((7, 8), seed=9)]
        rt2.engines[1].step()
        r3 = rt2.submit(p1, max_new_tokens=6)
        clk.t += 0.01
        rt2.step()                      # fires the clone
        clk.t += 0.004
        out = rt2.cancel(r3.id)
        _router_drive(rt2, clk)
        st = rt2.stats()
        return (fired, _view(r1), _view(r2), h1,
                None if out is None else (out["stage"], out["reason"]),
                _view(r3), st["hedges"], st["canceled"],
                [_view(b) for b in busy], _no_leaks(rt) + _no_leaks(rt2))

    out = _both(pkgs, run)
    assert out[0] == 1 and out[3]["fired"] == 1 and out[3]["pending"] == 0
    assert out[1][0] == out[2][0] == "done"
    assert out[4] == ("queued", "client") and out[5][0] == "canceled"
    assert out[6]["fired"] == 1 and out[6]["pending"] == 0
    assert out[7] == {"client": 1, "duplicate": 1}
    assert all(b[0] == "done" for b in out[8]) and set(out[9]) == {1}


def test_kill_cancels_requests_past_their_hard_deadline(pkgs):
    """A replica killed after a request's hard deadline passed: the
    request is canceled ("deadline"), not re-homed; the rest re-home
    and finish with the reference's tokens."""
    def run(pkg):
        clk = _Clock()
        rt = pkg.Router(pkg.model, n_replicas=2, max_slots=2, max_len=32,
                        buckets=[8, 16], max_queue=16, block_size=4,
                        clock=clk.now, **pkg.kw)
        e0 = rt.engines[0]
        ps = _prompts((4, 6, 5), seed=8)
        reqs = [e0.submit(ps[0], max_new_tokens=6, deadline_ms=20.0),
                e0.submit(ps[1], max_new_tokens=6),
                e0.submit(ps[2], max_new_tokens=6, deadline_ms=500.0)]
        e0.step()
        clk.t = 0.05
        info = rt.kill_replica(0)
        _router_drive(rt, clk)
        return (info, [_view(r) + (r.rehomed,) for r in reqs],
                rt.stats()["canceled"], _no_leaks(rt))

    info, views, canceled, leaks = _both(pkgs, run)
    assert info["rehomed"] == 2
    assert views[0][:2] == ("canceled", "deadline")
    assert views[1][0] == views[2][0] == "done"
    assert canceled == {"deadline": 1} and set(leaks) == {1}
