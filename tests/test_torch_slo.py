"""The port's SLO admission (``paddle_tpu_torch/serving/engine.py``)
against ``paddle_tpu.serving.ServingEngine`` on the CPU, each scenario
run once per package on the same weights (carried across by
``gpt_state_from_numpy``), prompts and clock: the TTFT predictor, equal
as floats at queue depths 0-8 with pinned and with learned costs; the
SLO gate's sheds with their reason and ``retry_after_s``; priority
preemption and FIFO within a class; queued requests shed when their TTFT
deadline passed; ``stats()``'s SLO fields and the
``serving_slo_attainment`` gauge. The model is the small GPT of
``tests/test_serving_slo.py`` (vocab 97, h 32, 2 layers, 4 heads) drawn
at ``init_std`` 0.2. The JAX side runs with 64-bit types off."""

import torch_threads  # noqa: F401  (one worker's share of the cores)
from types import SimpleNamespace

import jax
import numpy as np
import pytest

import paddle_tpu as pt
from paddle_tpu import observability as jobs
from paddle_tpu.models.gpt import GPTConfig as JGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JGPT
from paddle_tpu.resilience import fault_scope as jfault_scope
from paddle_tpu.serving import QueueFullError as JQueueFullError
from paddle_tpu.serving import ReplicaRouter as JReplicaRouter
from paddle_tpu.serving import ServingEngine as JServingEngine
from paddle_tpu_torch import observability as tobs
from paddle_tpu_torch.models.convert import gpt_state_from_numpy
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.resilience import fault_scope as tfault_scope
from paddle_tpu_torch.serving import (QueueFullError, ReplicaRouter,
                                      ServingEngine)

GEOM = dict(vocab_size=97, max_position_embeddings=64, hidden_size=32,
            num_layers=2, num_heads=4, ffn_hidden_size=64, init_std=0.2)


@pytest.fixture(autouse=True)
def jax_without_x64():
    with jax.enable_x64(False):
        yield


@pytest.fixture(scope="module")
def pkgs():
    pt.seed(11)
    jm = JGPT(JGPTConfig(**GEOM))
    jm.eval()
    arrays = {n: np.asarray(p.value) for n, p in jm.named_parameters()}
    tm = GPTForCausalLM(GPTConfig(**GEOM), device="cpu")
    tm.load_state_dict(gpt_state_from_numpy(arrays, "cpu"), strict=True)
    tm.eval()
    return (SimpleNamespace(name="jax", model=jm, Engine=JServingEngine,
                            Router=JReplicaRouter,
                            QueueFullError=JQueueFullError, obs=jobs,
                            fault_scope=jfault_scope, kw={}),
            SimpleNamespace(name="port", model=tm, Engine=ServingEngine,
                            Router=ReplicaRouter,
                            QueueFullError=QueueFullError, obs=tobs,
                            fault_scope=tfault_scope, kw={"device": "cpu"}))


class _Clock:
    def __init__(self):
        self.t = 0.0

    def now(self):
        return self.t


def _prompts(sizes, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, 97, size=n).tolist() for n in sizes]


def _engine(pkg, clk, **kw):
    base = dict(max_slots=2, max_len=32, buckets=[8, 16], max_queue=16)
    return pkg.Engine(pkg.model, **{**base, **kw}, clock=clk.now,
                      **pkg.kw)


def _drive(eng, clk, step_s=0.004):
    """Step ``eng`` to idle, the clock advancing ``step_s`` per step."""
    while not eng.idle:
        eng.step()
        clk.t += step_s


def _both(pkgs, scenario):
    out = [scenario(pkg) for pkg in pkgs]
    assert out[1] == out[0]
    return out[0]


def _submit(pkg, eng, prompt, **kw):
    """Submit; a shed comes back as ``("shed", reason, retry_after_s)``."""
    try:
        return eng.submit(prompt, **kw)
    except pkg.QueueFullError as e:
        return ("shed", e.reason, e.retry_after_s)


def _states(reqs):
    return [(r.state, r.shed_reason, list(r.tokens), r.first_token_at,
             r.deadline, r.deadline_met) if not isinstance(r, tuple) else r
            for r in reqs]


@pytest.mark.parametrize("pinned", [True, False])
def test_predicted_ttft_equal_at_queue_depths_0_to_8(pkgs, pinned):
    """The predictor over 0-8 queued requests, with 0, 1 and 2 active
    rows: equal floats in both packages, with costs pinned or learned
    from the same fed samples, and monotone in the depth."""
    def run(pkg):
        kw = (dict(slo_prefill_ms=10.0, slo_tpot_ms=2.0) if pinned
              else {})
        clk = _Clock()
        eng = _engine(pkg, clk, slo_ttft_ms=10_000.0, max_queue=64, **kw)

        def learned():
            # steps teach the EWMAs wall times: replace them with the
            # same samples on both sides
            eng.reset_cost_estimates()
            if not pinned:
                for bucket, ms in ((8, 3.25), (16, 5.5), (8, 4.0)):
                    eng._note_prefill_ms(bucket, ms)
                for ms in (1.5, 2.25, 1.75):
                    eng._note_tpot_ms(ms)

        out = []
        prompts = _prompts((4, 6, 9, 5, 7, 3), seed=1)
        for n_active in range(3):
            learned()
            out.append([eng.predict_ttft_ms(prompt_len=p, queue_ahead=q)
                        for q in range(9) for p in (4, 12, 30)])
            if n_active < 2:
                for pr, mnt in zip(prompts[3 * n_active:], (6, 3, 5)):
                    eng.submit(pr, max_new_tokens=mnt)
                eng.step()
        learned()
        out.append(eng.predict_ttft_ms())
        _drive(eng, clk)
        return out

    preds = _both(pkgs, run)
    for row in preds[:-1]:
        by_q = row[0::3]
        assert all(b >= a for a, b in zip(by_q, by_q[1:])), by_q


def test_slo_gate_and_retry_after_like_the_reference(pkgs):
    """Costs pinned so one queued wave blows a 25 ms budget: the second
    submission is shed with reason "slo" and the predictor's hint; a
    full queue, a draining engine and an injected submit fault shed with
    their own reasons and hints; ``stats()``'s SLO fields and the
    attainment gauge agree."""
    def run(pkg):
        clk = _Clock()
        eng = _engine(pkg, clk, max_slots=1, buckets=[8], max_queue=2,
                      slo_ttft_ms=25.0, slo_prefill_ms=10.0,
                      slo_tpot_ms=5.0)
        p = _prompts((4, 4, 4, 4), seed=1)
        out = [_submit(pkg, eng, p[0], max_new_tokens=4),
               _submit(pkg, eng, p[1], max_new_tokens=4)]
        _drive(eng, clk)
        deep = _engine(pkg, clk, max_slots=1, buckets=[8], max_queue=1,
                       slo_prefill_ms=10.0, slo_tpot_ms=5.0)
        out += [_submit(pkg, deep, p[2], max_new_tokens=4),
                _submit(pkg, deep, p[3], max_new_tokens=4)]
        _drive(deep, clk)
        deep.draining = True
        out.append(_submit(pkg, deep, p[3], max_new_tokens=4))
        deep.draining = False
        with pkg.fault_scope("serving.submit:skip", seed=0):
            out.append(_submit(pkg, deep, p[3], max_new_tokens=4))
        # a router whose replicas all shed passes the last one's reason
        # and hint on
        rt = pkg.Router(pkg.model, n_replicas=2, max_slots=1, max_len=32,
                        buckets=[8], max_queue=1, slo_ttft_ms=25.0,
                        slo_prefill_ms=10.0, slo_tpot_ms=5.0, clock=clk.now,
                        **pkg.kw)
        out += [_submit(pkg, rt, p[i], max_new_tokens=4, priority=1,
                        deadline_ms=500.0) for i in range(3)]
        _drive(rt, clk)
        st = eng.stats()
        gauge = pkg.obs.gauge("serving_slo_attainment").value_of(
            (("engine", eng._eid),))
        keys = ("shed", "shed_total", "completed", "slo_ttft_ms",
                "slo_met", "slo_attainment", "predicted_ttft_ms",
                "canceled", "canceled_total", "tenants")
        return (_states(out), {k: st[k] for k in keys}, gauge,
                deep.stats()["shed"])

    states, st, gauge, deep_shed = _both(pkgs, run)
    assert states[1] == ("shed", "slo", 1)
    assert states[3][:2] == ("shed", "queue_full") and states[3][2] >= 1
    assert [s[1] for s in states[4:6]] == ["drain", "fault"]
    assert [s[0] for s in states[6:8]] == ["done", "done"]
    assert states[8] == ("shed", "queue_full", 1)
    assert st["shed"] == {"slo": 1} and st["slo_attainment"] == 1.0
    assert gauge == 1.0
    assert deep_shed == {"queue_full": 1, "drain": 1, "fault": 1}


def test_priority_preemption_and_fifo_within_a_class(pkgs):
    """A full queue and an urgent submission: the newest request of the
    worst class is shed ("preempted"); a mixed queue drains urgent
    first, FIFO within a class, and a peer never preempts a peer; an SLO
    miss preempts lower classes until the prediction fits."""
    def run(pkg):
        clk = _Clock()
        eng = _engine(pkg, clk, max_slots=1, buckets=[8], max_queue=3)
        reqs = [eng.submit(_prompts((4,))[0], max_new_tokens=2,
                           priority=1)]
        reqs += [eng.submit(p, max_new_tokens=2, priority=2)
                 for p in _prompts((4, 4), seed=2)]
        reqs.append(eng.submit(_prompts((4,), seed=3)[0],
                               max_new_tokens=2, priority=0))
        reqs.append(_submit(pkg, eng, _prompts((4,), seed=4)[0],
                            max_new_tokens=2, priority=2))
        _drive(eng, clk)
        fifo = _engine(pkg, clk, max_slots=1, buckets=[8], max_queue=16)
        order = [fifo.submit(_prompts((4,), seed=s)[0], max_new_tokens=2,
                             priority=pr)
                 for s, pr in ((4, 2), (5, 2), (6, 0), (7, 1), (8, 0))]
        _drive(fifo, clk)
        ranks = sorted(range(len(order)),
                       key=lambda i: order[i].first_token_at)
        slo = _engine(pkg, clk, max_slots=1, buckets=[8], max_queue=16,
                      slo_ttft_ms=30.0, slo_prefill_ms=10.0,
                      slo_tpot_ms=5.0)
        s_reqs = [_submit(pkg, slo, p, max_new_tokens=2, priority=2)
                  for p in _prompts((4, 4, 4), seed=9)]
        s_reqs.append(_submit(pkg, slo, _prompts((5,), seed=10)[0],
                              max_new_tokens=2, priority=0))
        _drive(slo, clk)
        return (_states(reqs), eng.stats()["shed"], ranks,
                _states(s_reqs), slo.stats()["shed"])

    reqs, shed, ranks, s_reqs, s_shed = _both(pkgs, run)
    assert reqs[2][:2] == ("shed", "preempted") and reqs[3][0] == "done"
    assert reqs[4][:2] == ("shed", "queue_full")
    assert shed == {"preempted": 1, "queue_full": 1}
    assert ranks == [2, 4, 3, 0, 1]
    assert s_shed.get("preempted", 0) >= 1 and s_reqs[-1][0] == "done"


def test_queued_deadline_sheds_before_prefill(pkgs):
    """The clock jumps past every TTFT deadline while requests queue:
    they are shed with reason "deadline" and never prefilled; a request
    submitted after the jump is served."""
    def run(pkg):
        clk = _Clock()
        eng = _engine(pkg, clk, max_queue=16, buckets=[8],
                      slo_ttft_ms=50.0, slo_prefill_ms=1.0,
                      slo_tpot_ms=1.0)
        reqs = [eng.submit(p, max_new_tokens=2)
                for p in _prompts((4, 4, 4), seed=7)]
        clk.t = 1.0
        _drive(eng, clk)
        prefilled = dict(eng._prefill_fns)
        late = eng.submit(_prompts((5,), seed=8)[0], max_new_tokens=2)
        _drive(eng, clk)
        return (_states(reqs + [late]), sorted(prefilled),
                eng.stats()["shed"], eng.stats()["slo_attainment"])

    states, prefilled, shed, att = _both(pkgs, run)
    assert all(s[:2] == ("shed", "deadline") and s[5] is False
               for s in states[:3])
    assert prefilled == [] and shed == {"deadline": 3}
    assert states[3][0] == "done" and att == 1.0
