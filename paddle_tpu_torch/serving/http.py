"""Threaded HTTP front end of the serving plane, the counterpart of
``paddle_tpu/serving/http.py``: a ``ThreadingHTTPServer`` on a daemon
thread in front of a :class:`~paddle_tpu_torch.serving.ServingEngine`,
a :class:`~paddle_tpu_torch.serving.ReplicaRouter` or a
:class:`~paddle_tpu_torch.serving.DisaggRouter` (the target), speaking
the reference's JSON generation protocol:

  POST /v1/generate   {"ids": [...], "max_new_tokens"?, "eos_token_id"?,
                       "priority"?, "temperature"?, "top_k"?, "top_p"?,
                       "stop"?, "seed"?, "tenant"?, "json_mode"?,
                       "deadline_ms"?}
                      -> 200 {"id", "output_ids", "generated", "state"}
                             (+ "tenant" echoed when one was named)
                      -> 400 malformed JSON, a geometry the cache cannot
                             hold, invalid decoding parameters
                             (temperature < 0, top_k < 0, top_p outside
                             [0, 1]), json_mode on an engine constructed
                             without a grammar= or with speculative
                             decoding, a tenant without a LoRA pool or
                             naming an adapter that is not loaded
                      -> 429 admission control (a full queue, a predicted
                             SLO miss, a shed at submit), "reason" in the
                             body saying which gate fired; Retry-After is
                             the target's ``retry_after_s`` (from its
                             predicted TTFT), else one idle wait
                      -> 503 request shed mid-flight (fault policy)
                      -> 504 request not finished within the server's
                             ``request_timeout`` (canceled)
  GET  /v1/stats      -> 200 the STAT_serving_* counters merged with the
                             target's ``stats()``
  GET  /metrics       -> 200 the whole metrics registry in Prometheus text
                             format (``observability.prometheus_text``)
  GET  /health        -> 200 {"ok": true, "slots_free": n, "queued": n,
                             "kv_blocks_free": n, "kv_blocks_used": n}
                             (the block counts with paged KV)
  GET  /v1/requests/<id>
                      -> 200 the request's trace: marks on the engine
                             clock and the blame breakdown
                             (``observability.tracing.get``)
                      -> 400 non-integer id
                      -> 404 unknown id, unsampled request, or one out of
                             the finished ring (FLAGS_serving_trace_keep)
  DELETE /v1/requests/<id>
                      -> 200 {"id", "stage", "reason"}: the request was
                             canceled wherever it was (queued / prefill /
                             handoff / decode), its KV blocks reclaimed
                             (the target's ``cancel``)
                      -> 400 non-integer id
                      -> 404 unknown id or an ended request (a second
                             DELETE is a no-op)

``deadline_ms`` is the client's patience: the request is canceled, not
completed, wherever it is once it lapses. A client that hangs up early
gets the same: a broken pipe on the response write cancels the request
(reason "disconnect"), so a dead connection pins no rows or blocks.

Over a router, ``/health`` sums its live engines' rows and queues and
counts each KV pool once (co-located disaggregated roles share one); the
reference's handler reads an engine's attributes there and fails on a
router. ``start()`` starts the target's scheduler thread in the caller's
capture mode: warm the target first, so the thread replays graphs and
captures none.

Unauthenticated cluster-private HTTP, as the reference's: bind
127.0.0.1 (the default) unless the network is trusted.
"""

from __future__ import annotations

import json
import math
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional

from .. import monitor as _monitor
from .. import observability as _obs
from ..observability import tracing as _tracing
from .engine import QueueFullError

def _engines(target) -> List:
    """The live engines behind ``target`` (itself when it is one)."""
    engs = getattr(target, "engines", None)
    return [target] if engs is None else list(engs)


def _health(target) -> dict:
    engs = _engines(target)
    payload = {"ok": True,
               "slots_free": sum(e.cache.num_free for e in engs),
               "queued": sum(len(e._queue) for e in engs)}
    pools = {id(e.cache.pool): e.cache for e in engs if e.paged}
    if pools:
        payload["kv_blocks_free"] = sum(c.blocks_free
                                        for c in pools.values())
        payload["kv_blocks_used"] = sum(c.blocks_used
                                        for c in pools.values())
    return payload


class _ServingHandler(BaseHTTPRequestHandler):
    server_version = "PaddleTPUServing/1.0"

    def log_message(self, *a):  # quiet
        pass

    def _json(self, code: int, payload: dict,
              headers: Optional[dict] = None):
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _json_or_cancel(self, code: int, payload: dict, rid: int):
        """Write the response of request ``rid``; a broken pipe means the
        client hung up before its result, so cancel the request (a no-op
        once it ended)."""
        try:
            self._json(code, payload)
        except (BrokenPipeError, ConnectionResetError):
            self.server.engine.cancel(rid, reason="disconnect")

    def _request_id(self) -> Optional[int]:
        tail = self.path[len("/v1/requests/"):]
        try:
            return int(tail)
        except ValueError:
            self._json(400, {"error": f"bad request id {tail!r}"})
            return None

    def do_GET(self):
        target = self.server.engine
        if self.path == "/health":
            self._json(200, _health(target))
        elif self.path == "/v1/stats":
            payload = _monitor.stats_with_prefix("STAT_serving")
            payload.update(target.stats())
            self._json(200, payload)
        elif self.path == "/metrics":
            body = _obs.prometheus_text().encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        elif self.path.startswith("/v1/requests/"):
            rid = self._request_id()
            if rid is None:
                return
            info = _tracing.get(rid)
            if info is None:
                self._json(404, {"error": f"no trace for request {rid} "
                                          "(unknown, unsampled, or "
                                          "evicted from the ring)"})
            else:
                self._json(200, info)
        else:
            self._json(404, {"error": f"unknown path {self.path!r}"})

    def do_POST(self):
        target = self.server.engine
        if self.path != "/v1/generate":
            self._json(404, {"error": f"unknown path {self.path!r}"})
            return
        try:
            length = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(length) or b"{}")
            ids = body["ids"]
        except (ValueError, KeyError, TypeError) as e:
            self._json(400, {"error": f"bad request body: {e}"})
            return
        try:
            req = target.submit(ids,
                                max_new_tokens=body.get("max_new_tokens"),
                                eos_token_id=body.get("eos_token_id"),
                                priority=body.get("priority"),
                                temperature=body.get("temperature"),
                                top_k=body.get("top_k"),
                                top_p=body.get("top_p"),
                                stop=body.get("stop"),
                                seed=body.get("seed"),
                                json_mode=body.get("json_mode"),
                                tenant=body.get("tenant"),
                                deadline_ms=body.get("deadline_ms"))
        except QueueFullError as e:
            # the target's predicted-TTFT backoff when it attached one,
            # else one idle wait (when the scheduler next looks)
            retry_s = getattr(e, "retry_after_s", None)
            if retry_s is None:
                idle = _engines(target)[0].idle_wait
                retry_s = max(1, int(math.ceil(idle)))
            self._json(429, {"error": str(e),
                             "reason": getattr(e, "reason", "queue_full")},
                       headers={"Retry-After": str(int(retry_s))})
            return
        except ValueError as e:
            self._json(400, {"error": str(e)})
            return
        if not req.wait(self.server.request_timeout):
            self._json_or_cancel(
                504, {"error": f"request {req.id} timed out"}, req.id)
            return
        if req.state != "done":
            self._json_or_cancel(
                503, {"error": f"request {req.id} {req.state}: "
                               f"{req.error}"}, req.id)
            return
        payload = {"id": req.id, "output_ids": req.output_ids,
                   "generated": len(req.tokens), "state": req.state}
        if req.tenant:
            payload["tenant"] = req.tenant
        self._json_or_cancel(200, payload, req.id)

    def do_DELETE(self):
        target = self.server.engine
        if not self.path.startswith("/v1/requests/"):
            self._json(404, {"error": f"unknown path {self.path!r}"})
            return
        rid = self._request_id()
        if rid is None:
            return
        out = target.cancel(rid, reason="client")
        if out is None:
            self._json(404, {"error": f"request {rid} is unknown or "
                                      "already finished"})
        else:
            self._json(200, out)


class ServingHTTPServer:
    """``srv = ServingHTTPServer(target); srv.start()``: also starts the
    target's scheduler thread, so a started server is the whole
    deployment. ``port=0`` binds an ephemeral port."""

    def __init__(self, engine, port: int = 0,
                 bind_address: str = "127.0.0.1",
                 request_timeout: float = 120.0):
        self.engine = engine
        self._httpd = ThreadingHTTPServer((bind_address, port),
                                          _ServingHandler)
        self._httpd.engine = engine
        self._httpd.request_timeout = request_timeout
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def start(self):
        self.engine.start()
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="serving-http")
        self._thread.start()

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        self.engine.stop()
