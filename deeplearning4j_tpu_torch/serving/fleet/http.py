"""Fleet front door: one listener, N replicas behind the router.

Counterpart of ``deeplearning4j_tpu/serving/fleet/http.py``, the same
code and routes.

Clients speak the SAME wire protocol as a single replica
(serving/http.py) — chunked NDJSON token streams, the 400/404/429/503/
504 status taxonomy, X-Trace-Id echo — so pointing an existing client at
the fleet is a URL change, not a client change. What the fleet adds is
invisible until a replica dies: pre-first-token failures are replayed on
a survivor (the client just sees a slower admission), post-first-token
losses close the stream with ``reason: "replica_lost"``.

  POST /generate[/model]   routed + failover (stream and blocking)
  POST /predict[/model]    routed + failover
  GET  /health             200 while >= 1 replica is READY, else 503;
                           per-replica states + fleet counters
  GET  /metrics            router metrics (+ per-replica /metrics scrape
                           with {"scrape": false} absent — the
                           fleet_report tool folds these; with a
                           collector attached also "slo" + "collector")
  GET  /metrics/prometheus fleet Prometheus text: front-door samples,
                           per-replica samples with replica="<id>"
                           labels, and fleet_* aggregates whose
                           histogram buckets are merged cumulative
                           counts (honest fleet p99)
  GET  /debug/trace        distinct stitched trace ids the collector
                           currently holds
  GET  /debug/trace/<id>   one request's cross-process timeline —
                           front-door ingress + fleet routing + replica
                           decode spans merged chronologically
  GET  /fleet              membership table (states, steering, restarts)
  POST /scale              {"op": "drain"|"kill", "replica": id} — ops
                           scale-in and chaos injection share the door

Trace/aggregation routes need a :class:`~.collector.FleetCollector`
(``FleetHTTPServer(router, collector=...)``); without one they answer
503 so a collector-less fleet still serves everything else.
"""
from __future__ import annotations

import json
import threading
import time
from typing import Optional

from ...telemetry import get_registry
from ...telemetry.tracecontext import (event, new_trace_context,
                                       use_trace_context)
from .router import FleetHTTPError, FleetRouter, NoReadyReplicaError


class FleetHTTPServer:
    def __init__(self, router: FleetRouter, port: int = 0,
                 host: str = "127.0.0.1", collector=None):
        self.router = router
        self.collector = collector      # FleetCollector or None
        self.host = host
        self._port = port
        self._httpd = None
        self._thread = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1] if self._httpd else self._port

    def start(self) -> int:
        import http.server as hs

        from ...util.httpjson import read_json, write_json
        router = self.router
        collector = self.collector

        class Handler(hs.BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            _trace_ctx = None

            def _traced(self):
                # the SAME trace id flows client -> fleet -> replica:
                # router forwards it via X-Trace-Id, so one trace stitches
                # the front-door admission to the replica's decode spans
                ctx = new_trace_context(self.headers.get("X-Trace-Id"))
                self._trace_ctx = ctx
                return use_trace_context(ctx)

            def end_headers(self):
                ctx = self._trace_ctx
                if ctx is not None:
                    self.send_header("X-Trace-Id", ctx.trace_id)
                super().end_headers()

            def do_GET(self):       # noqa: N802
                try:
                    with self._traced():
                        self._route_get()
                finally:
                    self._trace_ctx = None

            def do_POST(self):      # noqa: N802
                try:
                    with self._traced():
                        event("fleet.request", method="POST",
                              route=self.path)
                        self._route_post()
                finally:
                    self._trace_ctx = None

            # ---------------------------------------------------- routes
            def _route_get(self):
                if self.path == "/health":
                    rows = router.replicas()
                    ready = sum(1 for r in rows if r["state"] == "ready")
                    body = {"status": "ok" if ready else "unavailable",
                            "ready": ready, "replicas": len(rows),
                            "states": {r["id"]: r["state"] for r in rows},
                            "policy": router.policy}
                    write_json(self, 200 if ready else 503, body)
                # collector-backed routes dispatch BEFORE the
                # startswith("/metrics") catch-all below
                elif self.path == "/metrics/prometheus":
                    self._prometheus()
                elif self.path == "/debug/trace" or \
                        self.path.startswith("/debug/trace/"):
                    self._stitched_trace()
                elif self.path.startswith("/metrics"):
                    body = router.metrics()
                    body["replica_metrics"] = self._scrape()
                    if collector is not None:
                        body["collector"] = collector.snapshot()
                        if collector.watchdog is not None:
                            body["slo"] = collector.watchdog.check()
                    write_json(self, 200, body)
                elif self.path == "/fleet":
                    write_json(self, 200, {"replicas": router.replicas(),
                                           "policy": router.policy,
                                           "block_len": router.block_len})
                else:
                    write_json(self, 404,
                               {"error": f"no route {self.path}"})

            def _prometheus(self):
                """Fleet Prometheus text dump. A bucket-ladder mismatch
                is refused loudly (500 naming the offending histogram)
                rather than silently mis-merged — the merge-correctness
                contract the regression tests pin."""
                from ...telemetry.registry import HistogramLadderMismatch
                try:
                    if collector is not None:
                        text = collector.to_prometheus_text()
                    else:
                        text = get_registry().to_prometheus_text()
                except HistogramLadderMismatch as e:
                    write_json(self, 500, {
                        "error": str(e), "kind": "HistogramLadderMismatch"})
                    return
                data = text.encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def _stitched_trace(self):
                if collector is None:
                    write_json(self, 503, {
                        "error": "no FleetCollector attached to this "
                                 "front door"})
                    return
                collector.pull_once()   # serve fresh, not period-stale
                if self.path == "/debug/trace":
                    write_json(self, 200,
                               {"traces": collector.trace_ids()})
                    return
                tid = self.path[len("/debug/trace/"):]
                events = collector.events_for_trace(tid)
                if not events:
                    write_json(self, 404,
                               {"error": f"no events for trace {tid!r}"})
                    return
                write_json(self, 200, {"trace_id": tid, "events": events})

            def _scrape(self) -> dict:
                """Per-replica /metrics snapshots (best effort — a dead
                replica yields its last known nothing, not a 500 here)."""
                out = {}
                for r in router.replicas():
                    if r["state"] != "ready" or not r["url"]:
                        continue
                    try:
                        _, m = router.client.request_json(
                            "GET", r["url"] + "/metrics", timeout=5.0)
                        out[r["id"]] = m
                    except Exception:
                        pass
                return out

            def _route_post(self):
                if self.path == "/generate" or \
                        self.path.startswith("/generate/"):
                    self._generate()
                elif self.path == "/predict" or \
                        self.path.startswith("/predict/"):
                    self._forward()
                elif self.path == "/scale":
                    self._scale()
                else:
                    self._drain_body()
                    write_json(self, 404,
                               {"error": f"no route {self.path}"})

            def _drain_body(self):
                n = int(self.headers.get("Content-Length", 0) or 0)
                if n:
                    try:
                        self.rfile.read(n)
                    except OSError:
                        self.close_connection = True

            def _model_suffix(self, prefix: str) -> Optional[str]:
                if self.path.startswith(prefix + "/"):
                    return self.path[len(prefix) + 1:] or None
                return None

            def _generate(self):
                model = self._model_suffix("/generate")
                try:
                    req = read_json(self)
                    if not isinstance(req, dict) or "prompt" not in req:
                        raise ValueError("body must carry 'prompt'")
                    stream = bool(req.get("stream", True))
                except Exception as e:
                    write_json(self, 400, {"error": f"bad request: {e}"})
                    return
                t0 = time.monotonic()
                if not stream:
                    status, body = router.generate_blocking(req, model)
                    self._observe(t0, status)
                    write_json(self, status, body)
                    return
                it = router.stream_generate(req, model)
                try:
                    first = next(it)
                except FleetHTTPError as e:
                    self._observe(t0, e.status)
                    write_json(self, e.status, e.body)
                    return
                except NoReadyReplicaError as e:
                    self._observe(t0, 503)
                    write_json(self, 503, {"error": str(e),
                                           "kind": "NoReadyReplica"})
                    return
                except StopIteration:   # pragma: no cover - defensive
                    write_json(self, 500, {"error": "empty stream"})
                    return
                self._stream(it, first)
                self._observe(t0, 200)

            def _stream(self, it, first):
                """Re-emit the router's NDJSON dicts as a chunked body —
                the terminator ALWAYS arrives (done/deadline/replica_lost
                alike), so fleet clients never hang on a dead replica."""
                self.send_response(200)
                self.send_header("Content-Type", "application/x-ndjson")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()

                def chunk(obj) -> bool:
                    data = (json.dumps(obj) + "\n").encode()
                    try:
                        self.wfile.write(
                            f"{len(data):x}\r\n".encode() + data + b"\r\n")
                        self.wfile.flush()
                        return True
                    except (BrokenPipeError, ConnectionResetError,
                            OSError):
                        return False
                alive = chunk(first)
                for obj in it:
                    if alive and not chunk(obj):
                        alive = False   # keep draining: frees the slot
                if alive:
                    try:
                        self.wfile.write(b"0\r\n\r\n")
                        self.wfile.flush()
                    except (BrokenPipeError, ConnectionResetError,
                            OSError):
                        self.close_connection = True
                else:
                    self.close_connection = True

            def _forward(self):
                try:
                    req = read_json(self)
                except Exception as e:
                    write_json(self, 400, {"error": f"bad request: {e}"})
                    return
                t0 = time.monotonic()
                status, body = router.forward_json("POST", self.path, req)
                self._observe(t0, status)
                write_json(self, status, body)

            def _scale(self):
                try:
                    req = read_json(self)
                    op = req["op"]
                    rid = req["replica"]
                except Exception as e:
                    write_json(self, 400, {"error": f"bad request: {e}"})
                    return
                if op == "drain":
                    drained = router.drain_replica(rid)
                    write_json(self, 200, {"replica": rid, "op": "drain",
                                           "drained": drained})
                elif op == "kill":
                    try:
                        router.kill_replica(rid)
                    except Exception as e:
                        write_json(self, 404, {"error": str(e)})
                        return
                    write_json(self, 200, {"replica": rid, "op": "kill"})
                else:
                    write_json(self, 400, {"error": f"unknown op {op!r}"})

            @staticmethod
            def _observe(t0: float, status: int) -> None:
                reg = get_registry()
                if reg.enabled:
                    reg.histogram("fleet.latency_ms").observe(
                        (time.monotonic() - t0) * 1e3)
                    reg.counter(f"fleet.http_{status // 100}xx").inc()

            def log_message(self, *a):
                pass

        self._httpd = hs.ThreadingHTTPServer((self.host, self._port),
                                             Handler)
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True, name="fleet-http")
        self._thread.start()
        return self.port

    def stop(self, *, close_router: bool = False) -> None:
        if self._httpd:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if close_router:
            if self.collector is not None:
                self.collector.stop()
            self.router.close()
