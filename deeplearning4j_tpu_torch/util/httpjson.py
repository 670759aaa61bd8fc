"""JSON plumbing for the stdlib HTTP servers and :class:`HTTPClient`, a
keep-alive client.

A copy of ``deeplearning4j_tpu/util/httpjson.py`` (stdlib only, kept
here so the port imports nothing of the JAX package). Connections are
pooled per ``(host, port)`` with a bounded depth; a request that finds a
pooled connection reuses its socket, a clean fully-read response returns
the connection to the pool, and anything suspect (unread stream bytes, a
transport error, a ``Connection: close`` response) closes the socket
instead of poisoning the pool. A request on a *reused* connection that
dies before any response bytes arrive is retried ONCE on a fresh
connection — the server may have idle-closed the pooled socket between
requests, which is the one failure reuse itself introduces; failures on
fresh connections always propagate (they are real)."""
from __future__ import annotations

import http.client
import json
import threading
from collections import deque
from contextlib import contextmanager
from typing import Any, Deque, Dict, Optional, Tuple
from urllib.parse import urlsplit


def read_json(handler) -> Any:
    """Parse the JSON body of the current request (empty body -> {})."""
    n = int(handler.headers.get("Content-Length", 0))
    return json.loads(handler.rfile.read(n) or b"{}")


def write_json(handler, code: int, obj: Any) -> None:
    body = json.dumps(obj).encode()
    handler.send_response(code)
    handler.send_header("Content-Type", "application/json")
    handler.send_header("Content-Length", str(len(body)))
    handler.end_headers()
    handler.wfile.write(body)


# --------------------------------------------------------------- client
_TRANSPORT_ERRORS = (http.client.HTTPException, ConnectionError, OSError)


class HTTPClient:
    """Bounded per-host keep-alive connection pool over ``http.client``.

        client = HTTPClient(max_per_host=4, timeout=5.0)
        status, body = client.request_json("GET", url + "/health")
        with client.stream("POST", url + "/generate", body=payload) as resp:
            for line in resp: ...

    Thread-safe; connections are never shared concurrently (acquire/
    release). ``connections_created`` / ``reused`` are the pool's own
    regression surface — the socket-reuse tests pin them."""

    def __init__(self, *, max_per_host: int = 4, timeout: float = 10.0):
        self.max_per_host = int(max_per_host)
        self.timeout = float(timeout)
        self._pools: Dict[Tuple[str, int],
                          Deque[http.client.HTTPConnection]] = {}
        self._lock = threading.Lock()
        self.connections_created = 0
        self.reused = 0

    # ------------------------------------------------------------- pool
    def _acquire(self, host: str, port: int,
                 timeout: Optional[float]) -> Tuple[
                     http.client.HTTPConnection, bool]:
        """Returns (connection, was_pooled)."""
        key = (host, port)
        with self._lock:
            pool = self._pools.get(key)
            conn = pool.popleft() if pool else None
            if conn is not None:
                self.reused += 1
        if conn is None:
            conn = http.client.HTTPConnection(
                host, port, timeout=self.timeout if timeout is None
                else timeout)
            with self._lock:
                self.connections_created += 1
            return conn, False
        if timeout is not None and conn.sock is not None:
            conn.sock.settimeout(timeout)
        return conn, True

    def _release(self, host: str, port: int,
                 conn: http.client.HTTPConnection) -> None:
        key = (host, port)
        # restore the default timeout before pooling: a per-request
        # override must not leak into the next caller's wait budget
        if conn.sock is not None:
            conn.sock.settimeout(self.timeout)
        with self._lock:
            pool = self._pools.setdefault(key, deque())
            if len(pool) < self.max_per_host:
                pool.append(conn)
                return
        conn.close()

    def close(self) -> None:
        with self._lock:
            pools, self._pools = self._pools, {}
        for pool in pools.values():
            for conn in pool:
                conn.close()

    def stats(self) -> dict:
        with self._lock:
            pooled = sum(len(p) for p in self._pools.values())
        return {"connections_created": self.connections_created,
                "reused": self.reused, "pooled_idle": pooled}

    # --------------------------------------------------------- requests
    @staticmethod
    def _split(url: str) -> Tuple[str, int, str]:
        u = urlsplit(url)
        if u.scheme not in ("http", ""):
            raise ValueError(f"HTTPClient only speaks http, got {url!r}")
        path = u.path or "/"
        if u.query:
            path += "?" + u.query
        return u.hostname or "127.0.0.1", u.port or 80, path

    def _issue(self, host: str, port: int, method: str, path: str,
               body: Optional[bytes], headers: Dict[str, str],
               timeout: Optional[float]) -> Tuple[
                   http.client.HTTPConnection, http.client.HTTPResponse]:
        """Send one request, retrying ONCE on a fresh connection if a
        pooled socket turns out to be stale (server idle-closed it)."""
        for _ in range(2):
            conn, was_pooled = self._acquire(host, port, timeout)
            try:
                conn.request(method, path, body=body, headers=headers)
                return conn, conn.getresponse()
            except _TRANSPORT_ERRORS:
                conn.close()
                if not was_pooled:
                    raise
        raise AssertionError("unreachable")  # pragma: no cover

    def request(self, method: str, url: str, *,
                body: Optional[bytes] = None,
                headers: Optional[Dict[str, str]] = None,
                timeout: Optional[float] = None
                ) -> Tuple[int, Dict[str, str], bytes]:
        """Full-body request. Returns (status, headers, body bytes); the
        connection goes back to the pool after the body is read."""
        host, port, path = self._split(url)
        conn, resp = self._issue(host, port, method, path, body,
                                 dict(headers or {}), timeout)
        try:
            data = resp.read()
        except _TRANSPORT_ERRORS:
            conn.close()
            raise
        if resp.will_close:
            conn.close()
        else:
            self._release(host, port, conn)
        return resp.status, dict(resp.getheaders()), data

    def request_json(self, method: str, url: str, *,
                     payload: Any = None,
                     headers: Optional[Dict[str, str]] = None,
                     timeout: Optional[float] = None) -> Tuple[int, Any]:
        """JSON in, JSON out. Non-JSON bodies come back as raw text."""
        hdrs = {"Content-Type": "application/json", **(headers or {})}
        body = None if payload is None else json.dumps(payload).encode()
        status, _, data = self.request(method, url, body=body,
                                       headers=hdrs, timeout=timeout)
        try:
            return status, json.loads(data) if data else None
        except ValueError:
            return status, data.decode("utf-8", "replace")

    def request_ndjson(self, method: str, url: str, *,
                       headers: Optional[Dict[str, str]] = None,
                       timeout: Optional[float] = None
                       ) -> Tuple[int, Dict[str, str], list]:
        """Full-body NDJSON pull: one JSON value per non-blank line.
        Returns (status, headers, parsed list) — the fleet collector's
        ``/debug/trace`` delta pulls ride this. A non-2xx body is
        returned unparsed as an empty list (status tells the story)."""
        status, hdrs, data = self.request(method, url, headers=headers,
                                          timeout=timeout)
        if not (200 <= status < 300):
            return status, hdrs, []
        out = [json.loads(line) for line in data.decode().splitlines()
               if line.strip()]
        return status, hdrs, out

    @contextmanager
    def stream(self, method: str, url: str, *,
               body: Optional[bytes] = None,
               headers: Optional[Dict[str, str]] = None,
               timeout: Optional[float] = None):
        """Yield the raw ``HTTPResponse`` (chunked decoding included — the
        NDJSON token streams iterate it line by line). A response read to
        EOF returns its connection to the pool; a stream abandoned
        mid-body (or a transport error) closes the socket."""
        host, port, path = self._split(url)
        conn, resp = self._issue(host, port, method, path, body,
                                 dict(headers or {}), timeout)
        try:
            yield resp
        except BaseException:
            conn.close()
            raise
        if resp.isclosed() and not resp.will_close:
            self._release(host, port, conn)
        else:
            conn.close()
