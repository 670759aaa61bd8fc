"""HTTP surface for the inference + generation engines.

Counterpart of ``deeplearning4j_tpu/serving/http.py``: the same routes,
request and response bodies, status mapping (``status_for``,
``_error_body``), NDJSON chunked streaming that always ends with a done
line, keep-alive safety (an early error still drains the request body)
and ``/reload`` retry policy (``_RELOAD_RETRY``). Routes:

  POST /predict            {"features": [[...]], "timeout_ms"?: int}
  POST /predict/<model>    same, routed to a named model
  POST /generate           {"prompt": [ids], "max_tokens"?, "temperature"?,
                            "top_k"?, "stop"?: [ids], "timeout_ms"?,
                            "stream"?: bool (default true),
                            "speculative"?: bool (default true — opt a
                            request out of draft-verify decode on a
                            speculating model)}
                           stream=true -> chunked NDJSON: one
                           {"token": id} line per generated token, then a
                           {"done": true, "reason": ..., "tokens": n}
                           terminator (also on mid-stream deadline/shutdown
                           — the stream always ends cleanly, clients never
                           hang). stream=false -> single JSON body.
  POST /generate/<model>   same, routed to a named generation model
  GET  /health             200 ok / 503 draining, queue depths per model
  GET  /metrics            per-model serving metrics (+ "generation" key
                           when a generation engine is attached)
  GET  /models             registry listing (version, buckets, warm state)
  GET  /metrics/prometheus the registry in the Prometheus text format (after
                           an SLO check and a cost-index fold)
  GET  /debug/trace        the registry's trace ring as NDJSON, one event
                           per line with its ``seq`` stamp;
                           ``?since_seq=N`` returns only events past the
                           cursor
  GET  /debug/metrics      raw mergeable metrics: counters, gauges, and
                           histograms as cumulative ``le`` buckets
  POST /reload             {"model": name, "path": zip-or-checkpoint-dir}
                           -> zero-downtime hot-swap (forward-serving OR
                           generation model), returns new version
  POST /debug/flightrec    explicit flight-recorder dump (black box)
  POST /debug/memprof      memory profile: top-K tagged-tensor groups by
                           (shape, dtype, owner) + per-device totals
                           ({"top_k": n} optional body)

Status mapping: malformed payload -> 400, unknown model -> 404, queue full
OR KV block-pool exhaustion -> 429 (the latter with a retry_after_ms hint),
model/device-side failure -> 500, draining/stopped -> 503, deadline expired
before ANY output -> 504 (a deadline expiring mid-stream terminates the
stream with reason "deadline" instead — HTTP status is already on the
wire).

Every request runs under a trace context: the inbound ``X-Trace-Id``
(normalized hex) or a fresh 128-bit id, echoed on every response, and a
POST records an ``http.request`` event under it. ``/metrics`` carries the
``slo`` key when an SLO watchdog is set and the ``perf`` key when the
registry is on, as the reference's does. Differences: ``/reload``
restores the network onto the device of the engine it replaces a model
in (the generation engine's when both serve the name), and
``/debug/memprof`` answers the port's ``telemetry.memprof.snapshot``
(tagged tensors plus the allocator's ``untagged`` remainder, see that
module).
"""
from __future__ import annotations

import json
import threading
import zipfile
from typing import Optional

import numpy as np

from ..telemetry import get_registry
from ..telemetry.flightrec import get_flight_recorder
from ..telemetry.perf import get_cost_index, perf_snapshot
from ..telemetry.slo import get_slo_watchdog
from ..telemetry.tracecontext import (event, new_trace_context,
                                      use_trace_context)
from ..util.retry import RetryError, RetryPolicy
from .engine import InferenceEngine
from .errors import (BlockPoolExhaustedError, DeadlineExceededError,
                     DrainingError, QueueFullError, ShapeMismatchError,
                     UnknownModelError)

# /reload checkpoint loads ride shared storage that can flake mid-read
# (NFS hiccup, object-store gateway timeout, a checkpoint zip still
# landing): retry transient I/O with capped backoff before answering
# 500. A missing path is NOT transient — FileNotFoundError stays a fast
# 400 (util/retry's `retryable` filter, not a blanket except).
_RELOAD_RETRY = RetryPolicy(
    max_attempts=3, base_delay_s=0.05, max_delay_s=0.25,
    retryable=lambda e: (isinstance(e, (OSError, zipfile.BadZipFile))
                         and not isinstance(e, FileNotFoundError)))

_STATUS = ((ShapeMismatchError, 400), (UnknownModelError, 404),
           (QueueFullError, 429), (DrainingError, 503),
           (DeadlineExceededError, 504))


def status_for(exc: BaseException) -> int:
    for cls, code in _STATUS:
        if isinstance(exc, cls):
            return code
    return 500


def _device_of(target, name: str):
    """The device a reloaded network must live on: the generation
    engine's, or that of the forward model being replaced."""
    label, eng = target
    if label == "generation":
        return eng.device
    return eng.registry.get(name).active.net.device


def _error_body(exc: BaseException) -> dict:
    body = {"error": str(exc), "kind": type(exc).__name__}
    if isinstance(exc, BlockPoolExhaustedError) and \
            getattr(exc, "retryable", True):
        body["retry_after_ms"] = 100       # decode steps free blocks fast
    return body


class ServingHTTPServer:
    def __init__(self, engine: Optional[InferenceEngine] = None,
                 port: int = 0, host: str = "127.0.0.1", *,
                 generation=None, health_extra=None):
        if engine is None and generation is None:
            raise ValueError("need an InferenceEngine and/or a "
                             "GenerationEngine to serve")
        self.engine = engine
        self.generation = generation
        self.host = host
        self._port = port
        self._httpd = None
        self._thread = None
        # extra keys merged into every /health body
        self._health_extra = health_extra

    @property
    def port(self) -> int:
        return self._httpd.server_address[1] if self._httpd else self._port

    def start(self) -> int:
        import http.server as hs

        from ..util.httpjson import read_json, write_json
        engine = self.engine
        generation = self.generation
        health_extra = self._health_extra

        class Handler(hs.BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"    # required for chunked replies

            # ------------------------------------------------ request tracing
            # every request runs under a TraceContext (the inbound
            # X-Trace-Id, else a fresh id) echoed on EVERY response: the
            # end_headers override covers write_json and the chunked path
            _trace_ctx = None

            def _traced(self):
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
                    # keep-alive: a later malformed request on this
                    # connection must not echo THIS request's id
                    self._trace_ctx = None

            def do_POST(self):      # noqa: N802
                try:
                    with self._traced():
                        event("http.request", method="POST",
                              route=self.path)
                        self._route_post()
                finally:
                    self._trace_ctx = None

            def _route_get(self):
                # query strings only exist on the /debug/trace cursor route
                path, _, query = self.path.partition("?")
                if path == "/debug/trace":
                    self._debug_trace(query)
                    return
                if path == "/debug/metrics":
                    write_json(self, 200, get_registry().raw_metrics())
                    return
                if self.path == "/health":
                    depths = engine.queue_depths() if engine else {}
                    gdepths = generation.queue_depths() if generation else {}
                    draining = bool(
                        (engine.draining if engine else False)
                        or (generation.draining if generation else False))
                    body = {"status": "draining" if draining else "ok",
                            "draining": draining,
                            "models": (engine.registry.names()
                                       if engine else []),
                            "queue_depth": depths,
                            "queue_depth_total": sum(depths.values())}
                    if generation is not None:
                        body["generation_models"] = generation.names()
                        body["generation_queue_depth"] = gdepths
                        body["steering"] = generation.steering()
                    if health_extra is not None:
                        try:
                            body.update(health_extra())
                        except Exception:   # pragma: no cover - defensive
                            pass
                    write_json(self, 503 if draining else 200, body)
                elif self.path == "/metrics":
                    body = engine.metrics() if engine else {}
                    if generation is not None:
                        body = dict(body)
                        body["generation"] = generation.metrics()
                    wd = get_slo_watchdog()
                    if wd is not None:
                        # fresh evaluation per scrape
                        body = dict(body)
                        body["slo"] = wd.check()
                    if get_registry().enabled:
                        body = dict(body)
                        body["perf"] = perf_snapshot()
                    write_json(self, 200, body)
                elif self.path == "/metrics/prometheus":
                    wd = get_slo_watchdog()
                    if wd is not None:
                        wd.check()        # refresh slo.* gauges first
                    if get_registry().enabled:
                        # refresh the perf.* gauges too: a deployment
                        # scraped only here would never fold otherwise
                        get_cost_index().fold(get_registry())
                    text = get_registry().to_prometheus_text().encode()
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "text/plain; version=0.0.4")
                    self.send_header("Content-Length", str(len(text)))
                    self.end_headers()
                    self.wfile.write(text)
                elif self.path == "/models":
                    body = engine.models() if engine else {}
                    if generation is not None:
                        body = dict(body)
                        body["generation"] = generation.models()
                    write_json(self, 200, body)
                else:
                    write_json(self, 404, {"error": f"no route {self.path}"})

            def _route_post(self):
                if self.path == "/predict" or \
                        self.path.startswith("/predict/"):
                    self._predict()
                elif self.path == "/generate" or \
                        self.path.startswith("/generate/"):
                    self._generate()
                elif self.path == "/reload":
                    self._reload()
                elif self.path == "/debug/flightrec":
                    self._flightrec()
                elif self.path == "/debug/memprof":
                    self._memprof()
                else:
                    self._drain_body()
                    write_json(self, 404, {"error": f"no route {self.path}"})

            def _debug_trace(self, query: str):
                """The trace ring as NDJSON, one event a line with its
                ``seq``; ``?since_seq=N`` returns only events past the
                cursor. ``X-Trace-Seq`` echoes the registry's watermark."""
                from urllib.parse import parse_qs
                reg = get_registry()
                try:
                    q = parse_qs(query)
                    since = int(q.get("since_seq", ["0"])[0])
                except (ValueError, TypeError):
                    write_json(self, 400,
                               {"error": "since_seq must be an integer"})
                    return
                events = reg.trace_events_since(since)
                body = "".join(json.dumps(e) + "\n"
                               for e in events).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/x-ndjson")
                self.send_header("Content-Length", str(len(body)))
                self.send_header("X-Trace-Seq", str(reg.last_seq))
                self.send_header("X-Trace-Dropped",
                                 str(reg.trace_dropped))
                self.end_headers()
                self.wfile.write(body)

            def _memprof(self):
                """The memory profile (``telemetry/memprof.py``). Optional
                JSON body: {"top_k": n}."""
                try:
                    info = read_json(self)
                    top_k = int(info.get("top_k", 10)) \
                        if isinstance(info, dict) else 10
                except Exception:
                    top_k = 10
                from ..telemetry import memprof
                try:
                    body = memprof.snapshot(top_k=max(1, min(top_k, 100)))
                except Exception as e:     # pragma: no cover - defensive
                    write_json(self, 500, {"error": str(e)})
                    return
                write_json(self, 200, body)

            def _flightrec(self):
                """Explicit black-box dump; the (optional) JSON body's
                fields land in the dump's info block."""
                try:
                    info = read_json(self)
                    if not isinstance(info, dict):
                        info = {"note": info}
                except Exception:
                    info = {}
                # body keys must not collide with dump()'s own parameters
                safe = {("body_" + k if k in ("self", "trigger", "force")
                         else str(k)): v for k, v in info.items()}
                path = get_flight_recorder().dump("http_debug", **safe)
                if path is None:
                    write_json(self, 503,
                               {"error": "flight recorder unavailable "
                                         "(telemetry disabled or dump "
                                         "failed)"})
                    return
                write_json(self, 200, {"dumped": path})

            def _drain_body(self):
                """Error paths that respond BEFORE parsing must still
                consume the request body: under HTTP/1.1 keep-alive an
                unread body would be parsed as the next request line."""
                n = int(self.headers.get("Content-Length", 0) or 0)
                if n:
                    try:
                        self.rfile.read(n)
                    except OSError:
                        self.close_connection = True

            def _predict(self):
                if engine is None:
                    self._drain_body()
                    write_json(self, 404,
                               {"error": "no forward-serving engine"})
                    return
                model: Optional[str] = None
                if self.path.startswith("/predict/"):
                    model = self.path[len("/predict/"):] or None
                try:                                   # parse phase -> 400
                    req = read_json(self)
                    feats = req["features"]
                    x = np.asarray(feats, np.dtype(engine.dtype))
                    timeout = req.get("timeout_ms")
                    timeout = None if timeout is None else float(timeout) / 1e3
                except Exception as e:
                    write_json(self, 400, {"error": f"bad request: {e}"})
                    return
                try:                                   # serve phase -> taxonomy
                    out = engine.predict(x, model=model, timeout=timeout)
                except Exception as e:
                    write_json(self, status_for(e), _error_body(e))
                    return
                write_json(self, 200, {"output": np.asarray(out).tolist(),
                                       "model": model
                                       or engine.registry.default_name})

            # ------------------------------------------------- generation
            def _generate(self):
                if generation is None:
                    self._drain_body()
                    write_json(self, 404, {"error": "no generation engine"})
                    return
                model: Optional[str] = None
                if self.path.startswith("/generate/"):
                    model = self.path[len("/generate/"):] or None
                try:                                   # parse phase -> 400
                    req = read_json(self)
                    prompt = [int(t) for t in req["prompt"]]
                    max_tokens = req.get("max_tokens")
                    max_tokens = None if max_tokens is None \
                        else int(max_tokens)
                    temperature = float(req.get("temperature", 0.0))
                    top_k = int(req.get("top_k", 0))
                    stop = [int(t) for t in req.get("stop", [])]
                    timeout = req.get("timeout_ms")
                    timeout = None if timeout is None \
                        else float(timeout) / 1e3
                    stream = bool(req.get("stream", True))
                    speculative = bool(req.get("speculative", True))
                except Exception as e:
                    write_json(self, 400, {"error": f"bad request: {e}"})
                    return
                try:                         # admission phase -> taxonomy
                    ts = generation.generate(
                        prompt, model=model, max_tokens=max_tokens,
                        temperature=temperature, top_k=top_k, stop=stop,
                        timeout=timeout, stream=True,
                        speculative=speculative)
                except Exception as e:
                    write_json(self, status_for(e), _error_body(e))
                    return
                if stream:
                    self._stream_tokens(ts)
                    return
                tokens, reason = ts.result(raise_on_error=False)
                if ts.error is not None and reason in ("error", "shutdown"):
                    # no bytes on the wire yet: the blocking flavor CAN
                    # report the failure properly (partial tokens included)
                    body = _error_body(ts.error)
                    body["tokens"] = tokens
                    body["reason"] = reason
                    write_json(self, status_for(ts.error), body)
                    return
                if reason == "deadline" and not tokens:
                    write_json(self, 504, _error_body(
                        ts.error or DeadlineExceededError(
                            "deadline expired before any output")))
                    return
                write_json(self, 200, {"tokens": tokens, "reason": reason,
                                       "model": model
                                       or generation.default_name})

            def _stream_tokens(self, ts):
                """Chunked NDJSON: flushed per token so callers see tokens
                as they decode; ALWAYS closed with a done line + chunk
                terminator (deadline/shutdown mid-stream included)."""
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
                alive = True
                for tok in ts:
                    if alive and not chunk({"token": int(tok)}):
                        alive = False
                        ts.cancel()     # client went away: free the slot
                done = {"done": True, "reason": ts.finish_reason,
                        "tokens": ts.emitted}
                if ts.error is not None:
                    done["error"] = str(ts.error)
                if alive:
                    chunk(done)
                    try:
                        self.wfile.write(b"0\r\n\r\n")
                        self.wfile.flush()
                    except (BrokenPipeError, ConnectionResetError, OSError):
                        self.close_connection = True
                else:
                    self.close_connection = True

            def _reload(self):
                try:
                    req = read_json(self)
                    name = req["model"]
                    path = req["path"]
                    if not isinstance(name, str) or not isinstance(path, str):
                        raise TypeError("'model' and 'path' must be strings")
                except Exception as e:
                    write_json(self, 400, {"error": f"bad request: {e}"})
                    return
                targets = []
                if engine is not None and name in engine.registry.names():
                    targets.append(("serving", engine))
                if generation is not None and name in generation.names():
                    targets.append(("generation", generation))
                if not targets:
                    write_json(self, 404,
                               {"error": f"no model {name!r} in any engine"})
                    return
                # load the checkpoint ONCE: both engines swap to the same
                # params object (no double deserialization, no skew if the
                # file changes between loads)
                try:
                    from .registry import load_net
                    net = _RELOAD_RETRY.call(load_net, path,
                                             device=_device_of(targets[-1],
                                                               name))
                except FileNotFoundError as e:
                    write_json(self, 400, {"error": str(e)})
                    return
                except RetryError as e:
                    write_json(self, 500,
                               {"error": f"failed to load {path!r} after "
                                         f"{e.attempts} attempts: {e.last}"})
                    return
                except Exception as e:
                    write_json(self, 500,
                               {"error": f"failed to load {path!r}: {e}"})
                    return
                # per-engine outcomes: a partial failure (swapped in one
                # engine, failed in the other) must be VISIBLE, not a bare
                # 500 that implies nothing changed
                versions, errors = {}, {}
                for label, t in targets:
                    try:
                        versions[label] = t.hot_swap(name, net)
                    except Exception as e:
                        errors[label] = e
                if errors:
                    write_json(self, 500,
                               {"model": name, "swapped": versions,
                                "failed": {k: str(v)
                                           for k, v in errors.items()},
                                "error": "; ".join(
                                    f"{k}: {v}" for k, v in errors.items()),
                                "status": ("partially swapped" if versions
                                           else "failed")})
                    return
                body = {"model": name, "status": "swapped",
                        "version": next(iter(versions.values()))}
                if len(versions) > 1:
                    body["versions"] = versions
                write_json(self, 200, body)

            def log_message(self, *a):
                pass

        self._httpd = hs.ThreadingHTTPServer((self.host, self._port), Handler)
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True,
                                        name="serving-http")
        self._thread.start()
        return self.port

    def stop(self, drain: bool = True) -> None:
        """Drain-then-stop: new requests see 503 while queued work flushes,
        then the listener goes down."""
        if self.engine is not None:
            self.engine.stop(drain=drain)
        if self.generation is not None:
            self.generation.stop(drain=drain)
        if self._httpd:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
