"""Nearest-neighbors HTTP server + client.

A copy of ``deeplearning4j_tpu/clustering/server.py`` (stdlib and numpy
only) over the port's ``util/httpjson.py``: the same endpoints, requests
and responses.

Reference: deeplearning4j-nearestneighbors-parent/
deeplearning4j-nearestneighbor-server/.../NearestNeighborsServer.java (Play
REST over a VPTree of vectors: POST /knn {ndarray index, k} and /knnnew
{raw vector, k}) with the HTTP client module. Stdlib-only here
(http.server + urllib), same endpoint semantics, loopback-bound by default.
"""
from __future__ import annotations

import json
import threading

import numpy as np

from .vptree import VPTree


class NearestNeighborsServer:
    """Serves kNN queries over an in-memory point set.

    Endpoints (JSON POST):
      /knn     {"index": i, "k": n}   -> neighbors of stored point i
      /knnnew  {"vector": [...], "k": n} -> neighbors of a new vector
    Response: {"indices": [...], "distances": [...]}
    """

    def __init__(self, points: np.ndarray, port: int = 0,
                 host: str = "127.0.0.1", metric: str = "euclidean"):
        self.points = np.asarray(points, np.float64)
        self.tree = VPTree(self.points, metric=metric)
        self.host = host
        self._port = port
        self._httpd = None
        self._thread = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1] if self._httpd else self._port

    def start(self) -> int:
        import http.server
        server = self

        from ..util.httpjson import read_json, write_json

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_POST(self):   # noqa: N802 (stdlib API)
                try:
                    req = read_json(self)
                    k = int(req.get("k", 1))
                    if self.path == "/knn":
                        i = int(req["index"])
                        if not (0 <= i < len(server.points)):
                            raise IndexError(f"index {i} out of range")
                        # query by the stored point; drop the self-match.
                        # k clamps to n-1 (there are only n-1 other points);
                        # a k+1 query then always yields >= k non-self pairs
                        # (VPTree.knn returns exactly k+1 unique indices)
                        k = min(k, len(server.points) - 1)
                        idxs, dists = server.tree.knn(server.points[i], k + 1)
                        pairs = [(j, d) for j, d in zip(idxs, dists)
                                 if j != i][:k]
                        idxs = [j for j, _ in pairs]
                        dists = [d for _, d in pairs]
                    elif self.path == "/knnnew":
                        v = np.asarray(req["vector"], np.float64)
                        idxs, dists = server.tree.knn(v, k)
                    else:
                        self.send_error(404)
                        return
                    write_json(self, 200,
                               {"indices": [int(j) for j in idxs],
                                "distances": [float(d) for d in dists]})
                except Exception as e:   # client error surface
                    write_json(self, 400, {"error": str(e)})

            def log_message(self, *a):   # quiet
                pass

        import http.server as hs
        self._httpd = hs.ThreadingHTTPServer((self.host, self._port), Handler)
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self.port

    def stop(self):
        if self._httpd:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None


class NearestNeighborsClient:
    """HTTP client (reference nearestneighbor-client module)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 9000):
        self.base = f"http://{host}:{port}"

    def _post(self, path: str, payload: dict) -> dict:
        import urllib.request
        req = urllib.request.Request(
            self.base + path, data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as r:
            return json.loads(r.read())

    def knn(self, index: int, k: int) -> dict:
        return self._post("/knn", {"index": index, "k": k})

    def knn_new(self, vector, k: int) -> dict:
        return self._post("/knnnew", {"vector": list(map(float, vector)),
                                      "k": k})
