"""The port's HTTP front end (``paddle_tpu_torch/serving/http.py``) and its
Prometheus export (``paddle_tpu_torch/observability/export.py``) against
``paddle_tpu.serving.http`` and ``paddle_tpu.observability.export`` on
the CPU. Each scenario serves the same weights (carried across by
``gpt_state_from_numpy``) from a server of each package on an ephemeral
127.0.0.1 port and sends the same requests; the statuses, the
Retry-After headers and the JSON bodies must be equal (request ids and
trace tracks normalized). The counterparts of ``tests/test_serving.py``
's HTTP tests (generate, health, stats and bad bodies; 429 with
Retry-After; DELETE at every stage; a broken pipe canceling its request),
``tests/test_serving_slo.py``'s priority and predicted Retry-After,
``tests/test_tracing.py``'s ``GET /v1/requests/<id>`` and
``tests/test_observability.py``'s exporter tests. The DELETE test does
not race the scheduler: the target's scheduler thread is parked
(``stop()``) while the test steps the request to the stage it cancels,
so a request cannot finish before its DELETE lands. The JSON-mode field
is refused with a 400 in both packages (the reference for an engine
without a grammar; the port because the grammar is not ported, which its
body says), and so is a tenant on an engine without a LoRA pool, with
the same body; tenants served: ``tests/test_torch_lora.py``. The model is the small GPT of
``tests/test_serving.py`` (vocab 97, h 32, 2 layers, 4 heads) drawn at
``init_std`` 0.2; engines run on a frozen clock. The JAX side runs with
64-bit types off."""

import torch_threads  # noqa: F401  (one worker's share of the cores)
import http.client
import json
import re
import types
from types import SimpleNamespace

import jax
import numpy as np
import pytest

import paddle_tpu as pt
from paddle_tpu import monitor as jmonitor
from paddle_tpu import observability as jobs
from paddle_tpu.models.generation import greedy_search as jgreedy
from paddle_tpu.models.gpt import GPTConfig as JGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JGPT
from paddle_tpu.observability import export as jexport
from paddle_tpu.observability import metrics as jmetrics
from paddle_tpu.observability import tracing as jtracing
from paddle_tpu.serving import DisaggRouter as JDisaggRouter
from paddle_tpu.serving import ReplicaRouter as JReplicaRouter
from paddle_tpu.serving import ServingEngine as JServingEngine
from paddle_tpu.serving import ServingHTTPServer as JServer
from paddle_tpu.serving.http import _ServingHandler as JHandler
from paddle_tpu_torch import monitor as tmonitor
from paddle_tpu_torch import observability as tobs
from paddle_tpu_torch.models.convert import gpt_state_from_numpy
from paddle_tpu_torch.models.generation import greedy_search as tgreedy
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.observability import export as texport
from paddle_tpu_torch.observability import metrics as tmetrics
from paddle_tpu_torch.observability import tracing as ttracing
from paddle_tpu_torch.serving import (DisaggRouter, ReplicaRouter,
                                      ServingEngine, ServingHTTPServer)
from paddle_tpu_torch.serving.http import _ServingHandler as THandler

GEOM = dict(vocab_size=97, max_position_embeddings=64, hidden_size=32,
            num_layers=2, num_heads=4, ffn_hidden_size=64, init_std=0.2)
FLEET = dict(max_slots=2, max_len=32, buckets=[8], max_queue=8,
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
                            Router=JReplicaRouter, Disagg=JDisaggRouter,
                            Server=JServer, Handler=JHandler,
                            greedy=jgreedy, monitor=jmonitor,
                            tracing=jtracing, export=jexport, kw={}),
            SimpleNamespace(name="port", model=tm, Engine=ServingEngine,
                            Router=ReplicaRouter, Disagg=DisaggRouter,
                            Server=ServingHTTPServer, Handler=THandler,
                            greedy=tgreedy, monitor=tmonitor,
                            tracing=ttracing, export=texport,
                            kw={"device": "cpu"}))


def _prompts(sizes, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, 97, size=n).tolist() for n in sizes]


def _target(pkg, kind, **kw):
    kw = {**FLEET, "clock": lambda: 0.0, **kw, **pkg.kw}
    if kind == "engine":
        return pkg.Engine(pkg.model, **kw)
    if kind == "router":
        return pkg.Router(pkg.model, n_replicas=2, **kw)
    return pkg.Disagg(pkg.model, n_prefill=1, n_decode=2, **kw)


class _Client:
    """One keep-alive connection; each call logs (method, path, status,
    Retry-After, JSON body) with the request ids it was told about
    replaced by names (``log_body=False`` logs no body: a stats dict)."""

    def __init__(self, port):
        self.c = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        self.ids = {}
        self._raw = []

    def name(self, rid, label):
        self.ids[int(rid)] = label

    def _norm(self, v, key=None):
        if isinstance(v, dict):
            return {k: self._norm(x, k) for k, x in v.items()}
        if isinstance(v, list):
            return [self._norm(x) for x in v]
        if key == "id" and v in self.ids:
            return self.ids[v]
        if isinstance(v, str):
            for rid, label in self.ids.items():
                v = re.sub(rf"\brequest {rid}\b", f"request {label}", v)
        return v

    def __call__(self, method, path, body=None, raw=None, log_body=True):
        shown = path
        for rid, label in self.ids.items():
            path = path.replace(f"<{label}>", str(rid))
        data = raw if raw is not None else (
            None if body is None else json.dumps(body))
        self.c.request(method, path, body=data)
        r = self.c.getresponse()
        text = r.read().decode()
        is_json = "json" in r.getheader("Content-Type", "")
        payload = json.loads(text) if is_json else text
        self._raw.append((method, shown, r.status,
                          r.getheader("Retry-After"),
                          payload if is_json and log_body else None))
        return r.status, payload

    @property
    def log(self):
        """The calls so far, ids named as the script named them (also the
        ids it named after their call)."""
        return [(*e[:4], self._norm(e[4])) for e in self._raw]

    def close(self):
        self.c.close()


def _served(pkg, target, script):
    """Serve ``target`` over HTTP, run ``script(client, target)``, stop;
    returns the client's log and what the script returned."""
    pkg.monitor.reset()
    pkg.tracing.reset()
    srv = pkg.Server(target, port=0)
    srv.start()
    client = _Client(srv.port)
    try:
        out = script(client, target)
    finally:
        client.close()
        srv.stop()
    return client.log, out


def _both(pkgs, run):
    res = [run(pkg) for pkg in pkgs]
    assert res[1] == res[0]
    return res[0]


def _leaked(target):
    engines = getattr(target, "engines", [target])
    pools = {id(e.cache.pool): e.cache for e in engines
             + list(getattr(target, "_retiring", []))}
    out = []
    for cache in pools.values():
        cache.flush_prefix_cache()
        out.append(cache.allocator.leaked())
    return out


@pytest.mark.parametrize("kind", ["engine", "router", "disagg"])
def test_generate_health_stats_and_bad_bodies_like_the_reference(pkgs, kind):
    """POST /v1/generate gives greedy_search's tokens; /health and
    /v1/stats answer; malformed bodies, bad geometry and bad decoding
    parameters are 400; unknown paths 404. Over a router the JAX
    handler's /health reads engine attributes the router lacks, so
    there the port's /health is checked alone."""
    prompt = _prompts((5,), seed=4)[0]

    def run(pkg):
        ref = [int(t) for t in pkg.greedy(pkg.model, np.asarray([prompt]),
                                          max_new_tokens=4,
                                          cache_len=32)[0]]

        def script(c, target):
            status, out = c("POST", "/v1/generate",
                            {"ids": prompt, "max_new_tokens": 4})
            c.name(out["id"], "r0")
            assert status == 200 and out["output_ids"] == ref
            health = None
            if kind == "engine" or pkg.name == "port":
                _, health = c("GET", "/health")
            _, stats = c("GET", "/v1/stats", log_body=False)
            c("POST", "/v1/generate", {"ids": []})
            c("POST", "/v1/generate", raw="not json")
            c("POST", "/v1/generate", {"max_new_tokens": 2})
            c("POST", "/v1/generate", {"ids": [1, 2], "max_new_tokens": 99})
            c("POST", "/v1/generate", {"ids": [1, 2], "temperature": -1})
            c("POST", "/v1/generate", {"ids": [1, 2], "top_p": 2.0})
            c("GET", "/nope")
            c("POST", "/v1/other", {"ids": [1]})
            return {"completed": stats["STAT_serving_completed"],
                    "health": health}

        log, out = _served(pkg, _target(pkg, kind), script)
        if pkg.name == "port" and kind != "engine":
            log = [e for e in log if e[1] != "/health"]
        return log, out["completed"], out["health"] if kind == "engine" \
            else None

    log, completed, health = _both(pkgs, run)
    assert [e[2] for e in log] == [200] + ([200] if kind == "engine"
                                           else []) + [200] + [400] * 6 + \
        [404] * 2
    assert completed == 1
    if kind == "engine":
        # the prompt's full block stays in the prefix cache
        assert health == {"ok": True, "slots_free": 2, "queued": 0,
                          "kv_blocks_free": 15, "kv_blocks_used": 2}


def test_health_over_a_disaggregated_fleet():
    """The port's /health over a fleet sums its engines' rows and queues
    and counts each pool once (a 1 x 2 co-located fleet: one pool)."""
    model = GPTForCausalLM(GPTConfig(**GEOM), device="cpu").eval()
    rt = DisaggRouter(model, n_prefill=1, n_decode=2, **FLEET, device="cpu")
    srv = ServingHTTPServer(rt, port=0)
    srv.start()
    try:
        c = _Client(srv.port)
        status, health = c("GET", "/health")
        c.close()
    finally:
        srv.stop()
    assert status == 200
    assert health == {"ok": True, "slots_free": 6, "queued": 0,
                      "kv_blocks_free": 16, "kv_blocks_used": 1}


def test_refused_fields_are_400_like_the_reference(pkgs):
    """``json_mode`` and ``tenant`` on an engine without a grammar or a
    LoRA pool: the reference's 400s, with its bodies, in both
    packages."""
    def run(pkg):
        def script(c, target):
            a = c("POST", "/v1/generate", {"ids": [1, 2], "json_mode": True})
            b = c("POST", "/v1/generate", {"ids": [1, 2], "tenant": "acme"})
            return a, b

        _, (a, b) = _served(pkg, _target(pkg, "engine"), script)
        return a, b

    grammar, tenant = _both(pkgs, run)
    assert grammar[0] == 400 and tenant[0] == 400
    assert "grammar" in grammar[1]["error"]
    assert "LoRA pool" in tenant[1]["error"]


def test_429_retry_after_and_stats_surface_like_the_reference(pkgs):
    """A full queue over HTTP: 429, its reason and Retry-After; the stats
    keys the reference exposes."""
    def run(pkg):
        def script(c, target):
            c("POST", "/v1/generate", {"ids": [1, 2], "max_new_tokens": 2})
            _, stats = c("GET", "/v1/stats", log_body=False)
            return sorted(k for k in ("ttft_p50_ms", "tpot_p99_ms",
                                      "latency_samples", "spec_tokens")
                          if k in stats)

        return _served(pkg, _target(pkg, "engine", max_slots=1,
                                    max_queue=0), script)

    log, keys = _both(pkgs, run)
    assert log[0][2] == 429 and int(log[0][3]) >= 1
    assert log[0][4]["reason"] == "queue_full"
    assert keys == ["latency_samples", "spec_tokens", "tpot_p99_ms",
                    "ttft_p50_ms"]


@pytest.mark.parametrize("kind", ["engine", "router", "disagg"])
def test_delete_at_every_stage_like_the_reference(pkgs, kind):
    """DELETE /v1/requests/<id> with the scheduler parked, so the request
    sits where the test put it: 200 with its stage (decode, queued; on a
    disaggregated fleet also the handoff queue), 404 for a second DELETE,
    an unknown id, a finished request and a foreign path, 400 for a
    non-integer id; every block reclaimed."""
    prompts = _prompts((4, 5, 6), seed=9)

    def run(pkg):
        def script(c, target):
            target.stop()            # park the scheduler thread
            victim = target.submit(prompts[0], max_new_tokens=24)
            c.name(victim.id, "victim")
            for _ in range(2):
                target.step()        # admitted and decoding
            c("DELETE", "/v1/requests/<victim>")
            c("DELETE", "/v1/requests/<victim>")
            c("DELETE", "/v1/requests/abc")
            c("DELETE", "/v1/requests/999999")
            c("DELETE", "/v1/other/1")
            queued = target.submit(prompts[1], max_new_tokens=4)
            c.name(queued.id, "queued")
            c("DELETE", "/v1/requests/<queued>")
            if kind == "disagg":
                handed = target.submit(prompts[2], max_new_tokens=4)
                c.name(handed.id, "handed")
                target.prefills[0].step()   # exported into the queue
                c("DELETE", "/v1/requests/<handed>")
            target.start()
            _, done = c("POST", "/v1/generate",
                        {"ids": prompts[0], "max_new_tokens": 2})
            c.name(done["id"], "done")
            c("DELETE", "/v1/requests/<done>")
            target.stop()
            return ([victim.state, victim.shed_reason, queued.state],
                    target.stats()["canceled"])

        target = _target(pkg, kind)
        log, out = _served(pkg, target, script)
        return log, out, _leaked(target)

    log, (states, canceled), leaked = _both(pkgs, run)
    stages = [e[4]["stage"] for e in log if e[0] == "DELETE" and
              e[2] == 200]
    assert stages == ["decode", "queued"] + (["handoff"] if kind == "disagg"
                                             else [])
    assert [e[2] for e in log[1:5]] == [404, 400, 404, 404]
    assert log[-1][2] == 404 and log[-2][4]["state"] == "done"
    assert states == ["canceled", "client", "canceled"]
    assert canceled == {"client": len(stages)}
    assert all(lk == 1 for lk in leaked)


@pytest.mark.parametrize("kind", ["engine", "disagg"])
def test_broken_pipe_cancels_inflight_request_like_the_reference(pkgs, kind):
    """A client that hangs up before its result: the write's broken pipe
    cancels the request (reason "disconnect"); after it ended the
    hang-up is a no-op."""
    def run(pkg):
        target = _target(pkg, kind)
        req = target.submit(_prompts((4,), seed=10)[0], max_new_tokens=4)

        def broken(code, payload, headers=None):
            raise BrokenPipeError()

        for _ in range(2):
            h = pkg.Handler.__new__(pkg.Handler)
            h.server = types.SimpleNamespace(engine=target)
            h._json = broken
            pkg.Handler._json_or_cancel(h, 200, {"id": req.id}, req.id)
        return (req.state, req.shed_reason, target.stats()["canceled"],
                _leaked(target))

    assert _both(pkgs, run)[:3] == ("canceled", "disconnect",
                                    {"disconnect": 1})


def test_priority_and_retry_after_from_prediction_like_the_reference(pkgs):
    """The priority field goes through; with the scheduler parked and a
    priority-0 peer queued, the next priority-0 POST is refused with
    reason "slo" and the predicted-TTFT Retry-After; /v1/stats shows the
    SLO shed and attainment."""
    def run(pkg):
        def script(c, target):
            body = {"ids": _prompts((4,), seed=8)[0], "max_new_tokens": 4,
                    "priority": 0}
            _, out = c("POST", "/v1/generate", body)
            c.name(out["id"], "first")
            target.stop()
            queued = target.submit(_prompts((8,), seed=10)[0],
                                   max_new_tokens=8, priority=0)
            c("POST", "/v1/generate", body)
            target.run_until_idle()
            _, stats = c("GET", "/v1/stats", log_body=False)
            return (queued.state, stats["shed"], stats["slo_attainment"],
                    stats["STAT_serving_rejected"])

        return _served(pkg, _target(pkg, "engine", max_slots=1,
                                    slo_ttft_ms=25.0, slo_prefill_ms=10.0,
                                    slo_tpot_ms=5.0), script)

    log, (state, shed, attainment, rejected) = _both(pkgs, run)
    assert [e[2] for e in log] == [200, 429, 200]
    assert log[1][4]["reason"] == "slo" and int(log[1][3]) >= 1
    assert shed.get("slo", 0) >= 1 and attainment is not None
    assert state in ("done", "shed") and rejected >= 1


def test_requests_endpoint_like_the_reference(pkgs):
    """GET /v1/requests/<id>: the trace's marks and blame for a traced
    request, 404 for an unknown id, 400 for a malformed one; over a
    disaggregated fleet the marks include the export and the adoption."""
    def run(pkg):
        out = []
        for kind in ("engine", "disagg"):
            def script(c, target):
                _, done = c("POST", "/v1/generate",
                            {"ids": _prompts((5,), seed=4)[0],
                             "max_new_tokens": 4})
                c.name(done["id"], "r")
                _, info = c("GET", "/v1/requests/<r>")
                c("GET", "/v1/requests/999999999")
                c("GET", "/v1/requests/abc")
                return ([m["kind"] for m in info["marks"]], info["outcome"],
                        sorted(info["blame_ms"]), info["e2e_ms"])

            log, info = _served(pkg, _target(pkg, kind), script)
            out.append(([e[2] for e in log], info, log[2][4]["error"]))
        return out

    engine, disagg = _both(pkgs, run)
    assert engine[0] == disagg[0] == [200, 200, 404, 400]
    assert engine[1][0][0] == "submit" and engine[1][1] == "done"
    assert {"export", "adopt"} <= set(disagg[1][0])
    assert "no trace" in engine[2]


def test_metrics_endpoint_validates(pkgs):
    """GET /metrics after traffic over a disaggregated fleet: Prometheus
    text the port's validator accepts (and the reference's), holding the
    fleet's families."""
    _, port = pkgs

    def script(c, target):
        c("POST", "/v1/generate", {"ids": [3, 4, 5], "max_new_tokens": 3})
        return c("GET", "/metrics")

    _, (status, text) = _served(port, _target(port, "disagg"), script)
    assert status == 200
    assert texport.validate_prometheus_text(text) == \
        jexport.validate_prometheus_text(text) > 0
    for family in ("serving_handoff_queue_depth", "serving_disagg_workers",
                   "serving_ttft_seconds_bucket", "STAT_serving_handoffs"):
        assert family in text, family


def _fill(reg):
    reg.counter("STAT_fault_exec.step", "dotted name").add(3)
    h = reg.histogram("lat_seconds", "latency")
    for v in (0.01, 0.02, 5.0):
        h.observe(v)
    h.labels(engine="0").observe(0.5)
    g = reg.gauge("serving_disagg_workers", 'help with "quotes"\nand a line')
    g.labels(router="0", role="prefill").set(1)
    g.labels(router="0", role="decode").set(2.5)
    reg.counter("weird-name with spaces").labels(**{"bad-label": 'x"y'}).inc()


def test_prometheus_text_equals_the_reference_line_for_line():
    """Registries filled the same way render the same text; the port's
    validator counts the same samples and catches the same breakage."""
    jreg, treg = jmetrics.MetricsRegistry(), tmetrics.MetricsRegistry()
    _fill(jreg)
    _fill(treg)
    text = texport.prometheus_text(treg)
    assert text.splitlines() == jexport.prometheus_text(jreg).splitlines()
    assert "STAT_fault_exec_step 3" in text
    assert "STAT_fault_exec.step" not in text
    assert 'lat_seconds_bucket{engine="0",le="+Inf"} 1' in text
    n = texport.validate_prometheus_text(text)
    assert n == jexport.validate_prometheus_text(text) > 40
    broken = text.replace("lat_seconds_count 3", "lat_seconds_count 7")
    for exp in (texport, jexport):
        with pytest.raises(ValueError, match="count"):
            exp.validate_prometheus_text(broken)
        with pytest.raises(ValueError):
            exp.validate_prometheus_text("bad metric line {\n")
        with pytest.raises(ValueError, match="no samples"):
            exp.validate_prometheus_text("# HELP x y\n")
    assert [texport.sanitize_name(s) for s in ("a.b", "9x", "ok_1", "")] == \
        [jexport.sanitize_name(s) for s in ("a.b", "9x", "ok_1", "")]
    assert tobs.prometheus_text is texport.prometheus_text


def test_snapshot_equals_the_reference_without_the_compile_tracker():
    """The JSON snapshot's counters, gauges and histograms equal the
    reference's, and both carry the compile records and the devprof
    cost table; with no tracked compile and devprof off in either
    process's trackers (both reset), those sections are equal too."""
    jreg, treg = jmetrics.MetricsRegistry(), tmetrics.MetricsRegistry()
    _fill(jreg)
    _fill(treg)
    jobs.reset_compiles()
    tobs.reset_compiles()
    jobs.devprof.reset()
    tobs.devprof.reset()
    jsnap, tsnap = jexport.snapshot(jreg), texport.snapshot(treg)
    assert set(jsnap) == set(tsnap)
    assert tsnap["compiles"] == jsnap["compiles"] == {}
    assert tsnap["device_costs"] == jsnap["device_costs"] == {}
    assert tsnap == jsnap
    assert set(tsnap["histograms"]["lat_seconds"]) == {
        "count", "sum", "min", "max", "p50", "p95", "p99"}
    json.dumps(tsnap)
