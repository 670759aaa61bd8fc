"""Model-serving HTTP route (the legacy single-model path).

Counterpart of ``deeplearning4j_tpu/parallel/model_server.py``
(``ModelServingServer`` ``:29-117``) on the port's ``util/httpjson.py``:
the stdlib HTTP server in place of the reference's Camel route; batched
inference rides ``ParallelInference``, so concurrent requests coalesce
into one batch.

For production serving (shape buckets, warmed programs, admission
control, several models, hot swap) use
``deeplearning4j_tpu_torch.serving.ServingHTTPServer``.

Endpoints (JSON):
  POST /predict {"features": [[...], ...]}       -> {"output": [[...], ...]}
  GET  /health                                   -> {"status": "ok"|"draining",
                                                     "queue_depth": N, ...}
Status codes: malformed JSON or features -> 400; a model or device failure
-> 500; draining -> 503.
"""
from __future__ import annotations

import threading

import numpy as np

from .inference import ParallelInference, _host


class ModelServingServer:
    def __init__(self, net, port: int = 0, host: str = "127.0.0.1",
                 batched: bool = True, max_batch: int = 64):
        self.net = net
        self.host = host
        self._port = port
        self._pi = (ParallelInference(net, batch_limit=max_batch)
                    if batched else None)
        self._httpd = None
        self._thread = None
        self._count = 0
        self._count_lock = threading.Lock()
        self._draining = False

    @property
    def port(self) -> int:
        return self._httpd.server_address[1] if self._httpd else self._port

    def start(self) -> int:
        import http.server
        server = self

        from ..util.httpjson import read_json, write_json

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):   # noqa: N802
                if self.path == "/health":
                    depth = (server._pi.queue_depth
                             if server._pi is not None else 0)
                    body = {"status": ("draining" if server._draining
                                       else "ok"),
                            "draining": server._draining,
                            "queue_depth": depth,
                            "model": type(server.net).__name__,
                            "requests_served": server._count}
                    write_json(self, 503 if server._draining else 200, body)
                else:
                    self.send_error(404)

            def do_POST(self):  # noqa: N802
                if self.path != "/predict":
                    self.send_error(404)
                    return
                if server._draining:
                    write_json(self, 503, {"error": "server is draining"})
                    return
                try:            # parse/validate phase: caller's fault -> 400
                    req = read_json(self)
                    x = np.asarray(req["features"], np.float32)
                except Exception as e:
                    write_json(self, 400, {"error": f"bad request: {e}"})
                    return
                try:            # inference phase: server's fault -> 500
                    if server._pi is not None:
                        out = server._pi.output(x)
                    else:
                        out = server.net.output(x)
                except Exception as e:
                    # a request that slipped past the drain check and was
                    # failed by the shutdown is a routine drain, not a 500
                    if server._draining:
                        write_json(self, 503, {"error": "server is draining"})
                    else:
                        write_json(self, 500, {"error": str(e)})
                    return
                with server._count_lock:   # handler threads race here
                    server._count += 1
                write_json(self, 200, {"output": _host(out).tolist()})

            def log_message(self, *a):
                pass

        import http.server as hs
        self._httpd = hs.ThreadingHTTPServer((self.host, self._port), Handler)
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self.port

    def stop(self):
        # drain first: new requests see 503 while in-flight ones finish or
        # are failed by the ParallelInference shutdown (never left hanging)
        self._draining = True
        if self._pi is not None:
            self._pi.shutdown()
        if self._httpd:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
