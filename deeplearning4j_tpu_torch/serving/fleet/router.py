"""FleetRouter: health-gated admission + affinity routing + retries.

Counterpart of ``deeplearning4j_tpu/serving/fleet/router.py``, the same
code over the port's replicas, telemetry and ``util/httpjson.py``.

The router owns the fleet membership table: each replica is either a
supervised :class:`~.replica.ReplicaProcess` (the router can restart and
kill it) or a bare URL (an externally managed process — tests route
across in-process servers this way). A background poller scrapes every
replica's ``/health`` steering payload on a short period; admission is
gated on that state — a replica is a candidate only while READY, and a
replica that fails ``DEAD_AFTER`` consecutive transport attempts (health
polls and forwards both count) is marked DEAD, dropped from the affinity
map (its cache died with it), black-boxed via the flight recorder, and —
with ``autorestart`` — respawned.

Retry discipline (the part chaos tests pin): a generation forward that
dies BEFORE any token reached the client is replayed on the next
candidate with capped backoff (``util/retry.py`` delays); once a token
is on the client's wire the stream can never be replayed — it is closed
with an explicit ``{"done": true, "reason": "replica_lost"}`` terminator
so the client-visible stream is always a single clean sequence, never a
spliced or double-emitted one. Every replay lands a ``fleet.retry``
trace event; a replayed request's done line carries ``retries``.
"""
from __future__ import annotations

import json
import threading
import time
from typing import Dict, List, Optional, Tuple

from ...telemetry import get_registry
from ...telemetry.flightrec import get_flight_recorder
from ...telemetry.tracecontext import current_trace_context, event
from ...util.httpjson import HTTPClient
from ...util.retry import RetryPolicy
from .affinity import DEFAULT_BLOCK_LEN, AffinityPolicy, prompt_chain
from .replica import ReplicaProcess

# consecutive transport failures after which a replica is DEAD (flapping
# sockets must not flap membership, and a hard-killed replica must stop
# receiving traffic within 3 strikes)
DEAD_AFTER = 3

STARTING, READY, DRAINING, DEAD = "starting", "ready", "draining", "dead"


class FleetError(RuntimeError):
    pass


class NoReadyReplicaError(FleetError):
    """No candidate could serve the request (fleet-level 503)."""


class FleetHTTPError(FleetError):
    """A replica answered with a non-retryable HTTP error — forwarded to
    the client verbatim (status + body)."""

    def __init__(self, status: int, body: dict):
        super().__init__(f"replica answered {status}")
        self.status = status
        self.body = body


class _Replica:
    """Router-side view of one replica."""

    __slots__ = ("id", "url", "proc", "state", "steering", "fails",
                 "restarts", "forwarded", "last_poll_s", "_restarting",
                 "_dying")

    def __init__(self, rid: str, url: Optional[str],
                 proc: Optional[ReplicaProcess]):
        self.id = rid
        self.url = url
        self.proc = proc
        self.state = STARTING
        self.steering: dict = {}
        self.fails = 0
        self.restarts = 0
        self.forwarded = 0
        self.last_poll_s: Optional[float] = None
        self._restarting = False
        self._dying = False

    @property
    def ready(self) -> bool:
        return self.state == READY and self.url is not None

    def row(self) -> dict:
        return {"id": self.id, "url": self.url, "state": self.state,
                "pid": self.proc.pid if self.proc else None,
                "consecutive_failures": self.fails,
                "restarts": self.restarts, "forwarded": self.forwarded,
                "spool_path": getattr(self.proc, "spool_path", None),
                "steering": self.steering}


class FleetRouter:
    def __init__(self, *, policy: str = "affinity",
                 block_len: Optional[int] = None,
                 client: Optional[HTTPClient] = None,
                 health_period_s: float = 0.2,
                 retry: Optional[RetryPolicy] = None,
                 queue_hi: int = 8, min_free_frac: float = 0.05,
                 autorestart: bool = False):
        if policy not in ("affinity", "round_robin", "least_loaded"):
            raise ValueError(f"unknown routing policy {policy!r}")
        self.policy = policy
        self._block_len = block_len     # None: adopt from first steering
        self.client = client or HTTPClient(max_per_host=8, timeout=30.0)
        self.health_period_s = float(health_period_s)
        self.retry = retry or RetryPolicy(max_attempts=3,
                                          base_delay_s=0.02,
                                          max_delay_s=0.2)
        self.autorestart = autorestart
        self.affinity = AffinityPolicy(queue_hi=queue_hi,
                                       min_free_frac=min_free_frac)
        self._replicas: Dict[str, _Replica] = {}
        self._lock = threading.RLock()
        self._rr = 0                    # round-robin cursor
        self._poll_thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._counters = {"requests": 0, "retries": 0, "streams_lost": 0,
                          "replica_deaths": 0, "rejected": 0}

    # ---------------------------------------------------------- membership
    def add_url(self, url: str, replica_id: Optional[str] = None) -> str:
        """Register an externally managed replica by base URL."""
        with self._lock:
            rid = replica_id or f"r{len(self._replicas)}"
            if rid in self._replicas:
                raise ValueError(f"replica {rid!r} already registered")
            self._replicas[rid] = _Replica(rid, url.rstrip("/"), None)
        self.poll_replica(rid)
        return rid

    def add_process(self, proc: ReplicaProcess, *,
                    wait_ready: bool = True,
                    timeout: float = 120.0) -> str:
        """Register (and readiness-gate) a supervised replica process."""
        with self._lock:
            if proc.id in self._replicas:
                raise ValueError(f"replica {proc.id!r} already registered")
            r = _Replica(proc.id, None, proc)
            self._replicas[proc.id] = r
        if not proc.alive:
            proc.start()
        if wait_ready:
            proc.wait_ready(timeout=timeout, client=self.client)
            r.url = proc.base_url
            self.poll_replica(proc.id)
        return proc.id

    def remove_replica(self, rid: str) -> None:
        with self._lock:
            r = self._replicas.pop(rid, None)
        if r is not None:
            self.affinity.forget_replica(rid)

    def replicas(self) -> List[dict]:
        with self._lock:
            return [r.row() for r in self._replicas.values()]

    def ready_count(self) -> int:
        with self._lock:
            return sum(1 for r in self._replicas.values() if r.ready)

    @property
    def block_len(self) -> int:
        return self._block_len or DEFAULT_BLOCK_LEN

    # -------------------------------------------------------------- health
    def start(self) -> "FleetRouter":
        """Start the background health poller."""
        if self._poll_thread is None:
            self._stop.clear()
            self._poll_thread = threading.Thread(
                target=self._poll_loop, daemon=True, name="fleet-health")
            self._poll_thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._poll_thread is not None:
            self._poll_thread.join(timeout=5.0)
            self._poll_thread = None

    def _poll_loop(self) -> None:
        while not self._stop.wait(self.health_period_s):
            self.poll_once()

    def poll_once(self) -> None:
        with self._lock:
            rids = list(self._replicas)
        for rid in rids:
            self.poll_replica(rid)

    def poll_replica(self, rid: str) -> None:
        with self._lock:
            r = self._replicas.get(rid)
        if r is None:
            return
        # a supervised child that EXITED is unambiguously dead — no need
        # to burn three strikes on connection-refused
        if r.proc is not None and r.proc.proc is not None \
                and not r.proc.alive and r.state != DEAD:
            self._mark_dead(r, reason="process_exit")
            return
        if r.url is None:
            # still starting: adopt the URL once the ready file lands
            if r.proc is not None:
                try:
                    with open(r.proc.ready_path) as f:
                        r.proc.ready_info = json.load(f)
                    r.url = r.proc.base_url
                except (OSError, ValueError):
                    return
            else:
                return
        try:
            status, body = self.client.request_json(
                "GET", r.url + "/health", timeout=5.0)
        except Exception:
            self._note_failure(r)
            return
        r.fails = 0
        r.last_poll_s = time.monotonic()
        if isinstance(body, dict):
            r.steering = body.get("steering", {}) or {}
            if self._block_len is None and r.steering.get("block_len"):
                self._block_len = int(r.steering["block_len"])
        if r.state != DRAINING:     # router-initiated drains are sticky
            r.state = READY if status == 200 else \
                (DRAINING if status == 503 else r.state)

    def _note_failure(self, r: _Replica) -> None:
        r.fails += 1
        if r.fails >= DEAD_AFTER and r.state != DEAD:
            self._mark_dead(r, reason="transport_failures")

    def _mark_dead(self, r: _Replica, *, reason: str) -> None:
        with self._lock:                # at-most-once across threads
            if r.state == DEAD or r._dying:
                return
            r._dying = True
        self._counters["replica_deaths"] += 1
        dropped = self.affinity.forget_replica(r.id)
        reg = get_registry()
        if reg.enabled:
            reg.counter("fleet.replica_deaths").inc()
        event("fleet.replica_dead", replica=r.id, reason=reason)
        # black box: what was the fleet doing when it lost this replica —
        # plus what the VICTIM was doing, recovered from its crash-durable
        # spool spill (telemetry/spool.py). A SIGKILLed replica cannot dump
        # anything itself; its last periodic spill speaks for it.
        get_flight_recorder().dump(
            "fleet_replica_lost", replica=r.id, reason=reason,
            consecutive_failures=r.fails, affinity_entries_dropped=dropped,
            restarts=r.restarts, victim_spill=self._victim_spill(r))
        # state flips LAST: an observer that polls to "dead" may rely on
        # the black box already being on disk (the chaos tests do)
        r.state = DEAD
        r._dying = False
        if self.autorestart and r.proc is not None and not r._restarting:
            r._restarting = True
            threading.Thread(target=self._restart, args=(r,),
                             daemon=True, name=f"fleet-restart-{r.id}").start()

    @staticmethod
    def _victim_spill(r: _Replica, cap: int = 512) -> Optional[dict]:
        """The dead replica's last spool spill, event tail capped so the
        dump stays readable; None when no black box survived."""
        path = getattr(r.proc, "spool_path", None)
        if not path:
            return None
        from ...telemetry.spool import read_spool
        spill = read_spool(path)
        if spill is None:
            return None
        events = spill.get("events") or []
        if len(events) > cap:
            spill = {**spill, "events": events[-cap:],
                     "events_truncated": len(events) - cap}
        return spill

    def _restart(self, r: _Replica) -> None:
        try:
            r.proc.kill()           # reap if half-dead
            r.proc.restart()
            r.restarts += 1
            r.state = STARTING
            r.url = None
            r.fails = 0
            info = r.proc.wait_ready(timeout=300.0, client=self.client)
            r.url = r.proc.base_url
            r.state = READY
            event("fleet.replica_restarted", replica=r.id,
                  ready_s=info.get("ready_s"))
        except Exception as e:      # pragma: no cover - host-dependent
            event("fleet.replica_restart_failed", replica=r.id,
                  error=str(e))
        finally:
            r._restarting = False

    # -------------------------------------------------------------- routing
    def candidates(self, prompt) -> Tuple[List[str], str]:
        """Ordered candidate replica ids for this prompt + route reason."""
        with self._lock:
            views = list(self._replicas.values())
            if self.policy == "affinity":
                chain = prompt_chain(prompt or [], self.block_len)
                return self.affinity.candidates(chain, views)
            ready = [v.id for v in views if v.ready]
            if not ready:
                return [], "none"
            if self.policy == "round_robin":
                self._rr += 1
                k = self._rr % len(ready)
                return ready[k:] + ready[:k], "round_robin"
            # least_loaded: shallowest queue + in-flight first
            ready.sort(key=lambda rid: (
                self._replicas[rid].steering.get("queue_depth", 0)
                + self._replicas[rid].steering.get("in_flight", 0)))
            return ready, "least_loaded"

    def _record_route(self, prompt, rid: str) -> None:
        if self.policy == "affinity":
            with self._lock:
                self.affinity.record(
                    prompt_chain(prompt or [], self.block_len), rid)

    @staticmethod
    def _trace_headers() -> Dict[str, str]:
        ctx = current_trace_context()
        hdrs = {"Content-Type": "application/json"}
        if ctx is not None:
            hdrs["X-Trace-Id"] = ctx.trace_id   # per-replica propagation
        return hdrs

    def stream_generate(self, payload: dict, model: Optional[str] = None):
        """Generator of parsed NDJSON dicts for one /generate admission.

        Pre-stream failures (transport errors, 429/500/503 admissions)
        fail over to the next candidate under the capped-backoff retry
        budget; post-first-token failures close the stream with
        ``reason: "replica_lost"``. Raises :class:`FleetHTTPError` for
        non-retryable replica answers and :class:`NoReadyReplicaError`
        when the budget or the candidate list runs out."""
        prompt = payload.get("prompt") or []
        path = "/generate" + (f"/{model}" if model else "")
        body = json.dumps({**payload, "stream": True}).encode()
        self._counters["requests"] += 1
        reg = get_registry()
        if reg.enabled:
            reg.counter("fleet.requests").inc()
        delays = self.retry.delays()
        tried: set = set()
        retries = 0
        last_err: Optional[BaseException] = None
        while True:
            ids, reason = self.candidates(prompt)
            ids = [i for i in ids if i not in tried]
            if not ids:
                self._counters["rejected"] += 1
                raise NoReadyReplicaError(
                    f"no ready replica after {retries} retries "
                    f"({len(tried)} tried)") from last_err
            rid = ids[0]
            with self._lock:
                r = self._replicas.get(rid)
            if r is None or r.url is None:
                tried.add(rid)
                continue
            emitted = 0
            try:
                with self.client.stream("POST", r.url + path, body=body,
                                        headers=self._trace_headers()) \
                        as resp:
                    if resp.status != 200:
                        data = resp.read()
                        try:
                            err = json.loads(data)
                        except ValueError:
                            err = {"error": data.decode("utf-8", "replace")}
                        if resp.status in (429, 500, 503):
                            raise _RetryableAdmission(resp.status, err)
                        raise FleetHTTPError(resp.status, err)
                    r.fails = 0
                    r.forwarded += 1
                    self._record_route(prompt, rid)
                    event("fleet.route", replica=rid, reason=reason,
                          retries=retries)
                    for line in resp:
                        if not line.strip():
                            continue
                        obj = json.loads(line)
                        if "token" in obj:
                            emitted += 1
                        if obj.get("done"):
                            obj.setdefault("replica", rid)
                            if retries:
                                obj["retries"] = retries
                            yield obj
                            return
                        yield obj
                # replica stream ended without a done line: the engine
                # contract says streams ALWAYS end with one, so this is a
                # mid-stream connection loss surfaced as clean EOF
                raise ConnectionError("stream ended without done line")
            except FleetHTTPError:
                raise
            except _RetryableAdmission as e:
                tried.add(rid)
                last_err = e
                # replica alive but busy/draining/failing: NOT a strike
                if not self._backoff(delays):
                    self._counters["rejected"] += 1
                    raise FleetHTTPError(e.status, e.body) from None
                retries += 1
                self._on_retry(rid, f"http_{e.status}")
            except Exception as e:
                self._note_failure(r)
                last_err = e
                if emitted:
                    # token(s) already on the client's wire: never replay
                    self._counters["streams_lost"] += 1
                    if reg.enabled:
                        reg.counter("fleet.streams_lost").inc()
                    event("fleet.stream_lost", replica=rid,
                          tokens=emitted, error=str(e))
                    yield {"done": True, "reason": "replica_lost",
                           "tokens": emitted, "replica": rid,
                           "error": str(e)}
                    return
                tried.add(rid)
                if not self._backoff(delays):
                    self._counters["rejected"] += 1
                    raise NoReadyReplicaError(
                        f"retry budget exhausted after {retries + 1} "
                        f"attempts: {e}") from e
                retries += 1
                self._on_retry(rid, str(e))

    def _backoff(self, delays) -> bool:
        d = next(delays, None)
        if d is None:
            return False
        time.sleep(d)
        return True

    def _on_retry(self, rid: str, why: str) -> None:
        self._counters["retries"] += 1
        reg = get_registry()
        if reg.enabled:
            reg.counter("fleet.retries").inc()
        # the explicit retry marker the idempotency tests pin
        event("fleet.retry", replica=rid, error=why)

    def generate_blocking(self, payload: dict,
                          model: Optional[str] = None) -> Tuple[int, dict]:
        """Non-streaming /generate: nothing reaches the client until the
        request completed, so a stream lost mid-decode is safely replayed
        in full on a survivor (the replay decodes again — duplicated
        work, never duplicated output)."""
        replays = 0
        while True:
            tokens: List[int] = []
            done: Optional[dict] = None
            try:
                for obj in self.stream_generate(payload, model):
                    if "token" in obj:
                        tokens.append(obj["token"])
                    if obj.get("done"):
                        done = obj
            except FleetHTTPError as e:
                return e.status, e.body
            except NoReadyReplicaError as e:
                return 503, {"error": str(e), "kind": "NoReadyReplica"}
            if done is not None and done.get("reason") == "replica_lost" \
                    and replays < self.retry.max_attempts - 1:
                replays += 1
                self._on_retry(done.get("replica", "?"), "blocking_replay")
                continue
            body = {"tokens": tokens,
                    "reason": (done or {}).get("reason", "error"),
                    "replica": (done or {}).get("replica")}
            if replays or (done or {}).get("retries"):
                body["retries"] = replays + int((done or {}).get(
                    "retries", 0))
            return 200, body

    def forward_json(self, method: str, path: str, payload=None,
                     *, prompt=None) -> Tuple[int, dict]:
        """Failover forward for non-streaming routes (/predict, admin):
        capped-backoff retries through util/retry.py, candidates in
        routing-policy order."""
        def attempt():
            ids, _reason = self.candidates(prompt)
            if not ids:
                raise NoReadyReplicaError("no ready replica")
            rid = ids[0]
            with self._lock:
                r = self._replicas.get(rid)
            if r is None or r.url is None:
                raise NoReadyReplicaError(f"replica {rid} has no URL")
            try:
                status, body = self.client.request_json(
                    method, r.url + path, payload=payload,
                    headers=self._trace_headers())
            except Exception:
                self._note_failure(r)
                raise
            r.fails = 0
            r.forwarded += 1
            return status, body

        from ...util.retry import RetryError
        try:
            return self.retry.call(attempt)
        except RetryError as e:
            self._counters["rejected"] += 1
            return 503, {"error": f"fleet forward failed: {e.last}",
                         "kind": "NoReadyReplica"}

    # -------------------------------------------------------------- scaling
    def drain_replica(self, rid: str, *, timeout: float = 30.0,
                      stop_process: bool = True,
                      poll_s: float = 0.05) -> bool:
        """Drain-then-stop scale-in: stop routing to ``rid``, wait for its
        queue and in-flight slots to empty, then SIGTERM the process (the
        child drains its engines again on the way out — belt and braces).
        Returns True if the replica emptied within ``timeout``."""
        with self._lock:
            r = self._replicas.get(rid)
        if r is None:
            return False
        r.state = DRAINING          # candidates() stops offering it NOW
        event("fleet.drain", replica=rid)
        drained = False
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            try:
                _, body = self.client.request_json(
                    "GET", r.url + "/health", timeout=5.0)
                s = (body or {}).get("steering", {})
                if s.get("queue_depth", 0) == 0 \
                        and s.get("in_flight", 0) == 0:
                    drained = True
                    break
            except Exception:
                break               # already gone
            time.sleep(poll_s)
        if stop_process and r.proc is not None:
            r.proc.terminate(drain=True)
        self.remove_replica(rid)
        return drained

    def kill_replica(self, rid: str) -> None:
        """Chaos: SIGKILL a supervised replica, no drain, no cleanup —
        detection is the router's problem (that is the test)."""
        with self._lock:
            r = self._replicas.get(rid)
        if r is None or r.proc is None:
            raise FleetError(f"no supervised replica {rid!r}")
        r.proc.kill()

    # ------------------------------------------------------- observability
    def metrics(self) -> dict:
        with self._lock:
            rows = [r.row() for r in self._replicas.values()]
            counters = dict(self._counters)
        ready = [r for r in rows if r["state"] == READY]
        lookups = sum(r["steering"].get("prefix_lookups", 0) for r in ready)
        hits = sum(r["steering"].get("prefix_hit_rate", 0.0)
                   * r["steering"].get("prefix_lookups", 0) for r in ready)
        return {
            "policy": self.policy,
            "block_len": self.block_len,
            "replicas": {r["id"]: r for r in rows},
            "ready": len(ready),
            "aggregate_prefix_hit_rate": (round(hits / lookups, 4)
                                          if lookups else 0.0),
            "affinity": (self.affinity.stats()
                         if self.policy == "affinity" else None),
            **counters,
        }

    def close(self) -> None:
        """Stop polling and drain-stop every supervised replica."""
        self.stop()
        with self._lock:
            rs = list(self._replicas.values())
            self._replicas.clear()
        for r in rs:
            if r.proc is not None:
                try:
                    r.proc.terminate(drain=True, timeout=10.0)
                except Exception:   # pragma: no cover - defensive
                    pass
        self.client.close()


class _RetryableAdmission(Exception):
    def __init__(self, status: int, body: dict):
        super().__init__(f"retryable admission {status}")
        self.status = status
        self.body = body
