"""StatsStorage SPI + in-memory, JSON-lines, SQLite and remote backends.

Counterpart of ``deeplearning4j_tpu/ui/storage.py``, copied unchanged: it
is pure Python. Records are plain JSON-able dicts. The JSON-lines file
(one ``{"kind", "session", "worker", "data"}`` object a line) and the
SQLite tables (``static_info``, ``updates`` and their index) are the
reference's byte for byte, so either package reads the other's files.

Reference: deeplearning4j-ui-parent/deeplearning4j-ui-model/src/main/java/org/
deeplearning4j/api/storage/StatsStorage.java (SPI: listSessionIDs,
getAllUpdatesAfter, getStaticInfo, listeners) with InMemoryStatsStorage and
FileStatsStorage (MapDB) as the stock backends.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple


class StatsStorageEvent:
    """Posted to registered listeners (reference StatsStorageEvent.java)."""

    NEW_SESSION = "new_session"
    NEW_WORKER = "new_worker"
    POST_STATIC = "post_static"
    POST_UPDATE = "post_update"

    def __init__(self, kind: str, session_id: str, worker_id: str,
                 timestamp: float):
        self.kind = kind
        self.session_id = session_id
        self.worker_id = worker_id
        self.timestamp = timestamp


class StatsStorage:
    """Abstract storage for training stats (reference StatsStorage.java SPI)."""

    def __init__(self):
        self._listeners: List[Callable[[StatsStorageEvent], None]] = []
        self._lock = threading.RLock()

    # ------------------------------------------------------------- write side
    def put_static_info(self, session_id: str, worker_id: str,
                        info: Dict[str, Any]) -> None:
        raise NotImplementedError

    def put_update(self, session_id: str, worker_id: str,
                   update: Dict[str, Any]) -> None:
        raise NotImplementedError

    # -------------------------------------------------------------- read side
    def list_session_ids(self) -> List[str]:
        raise NotImplementedError

    def list_worker_ids(self, session_id: str) -> List[str]:
        raise NotImplementedError

    def get_static_info(self, session_id: str,
                        worker_id: str) -> Optional[Dict[str, Any]]:
        raise NotImplementedError

    def get_updates(self, session_id: str, worker_id: str,
                    since_iteration: int = -1) -> List[Dict[str, Any]]:
        """All updates with iteration > since_iteration, ordered by iteration
        (reference getAllUpdatesAfter)."""
        raise NotImplementedError

    def get_latest_update(self, session_id: str,
                          worker_id: str) -> Optional[Dict[str, Any]]:
        ups = self.get_updates(session_id, worker_id)
        return ups[-1] if ups else None

    # -------------------------------------------------------------- listeners
    def register_listener(self, cb: Callable[[StatsStorageEvent], None]):
        self._listeners.append(cb)

    def _notify(self, kind: str, session_id: str, worker_id: str):
        ev = StatsStorageEvent(kind, session_id, worker_id, time.time())
        for cb in list(self._listeners):
            cb(ev)

    def close(self):
        pass


class InMemoryStatsStorage(StatsStorage):
    """Reference InMemoryStatsStorage.java — dict-backed, test/dev default."""

    def __init__(self):
        super().__init__()
        self._static: Dict[Tuple[str, str], Dict[str, Any]] = {}
        self._updates: Dict[Tuple[str, str], List[Dict[str, Any]]] = {}

    def put_static_info(self, session_id, worker_id, info):
        with self._lock:
            new_session = not any(s == session_id for s, _ in self._static)
            self._static[(session_id, worker_id)] = dict(info)
        if new_session:
            self._notify(StatsStorageEvent.NEW_SESSION, session_id, worker_id)
        self._notify(StatsStorageEvent.POST_STATIC, session_id, worker_id)

    def put_update(self, session_id, worker_id, update):
        with self._lock:
            self._updates.setdefault((session_id, worker_id), []).append(dict(update))
        self._notify(StatsStorageEvent.POST_UPDATE, session_id, worker_id)

    def list_session_ids(self):
        with self._lock:
            keys = set(s for s, _ in self._static) | set(s for s, _ in self._updates)
        return sorted(keys)

    def list_worker_ids(self, session_id):
        with self._lock:
            keys = set(w for s, w in self._static if s == session_id)
            keys |= set(w for s, w in self._updates if s == session_id)
        return sorted(keys)

    def get_static_info(self, session_id, worker_id):
        with self._lock:
            return self._static.get((session_id, worker_id))

    def get_updates(self, session_id, worker_id, since_iteration=-1):
        with self._lock:
            ups = list(self._updates.get((session_id, worker_id), []))
        return [u for u in ups if u.get("iteration", 0) > since_iteration]


class FileStatsStorage(StatsStorage):
    """Append-only JSON-lines file storage (capability of the reference's
    MapDB-backed FileStatsStorage.java, in a tail-able text format).

    Each line: {"kind": "static"|"update", "session": .., "worker": ..,
    "data": {...}}. Reads re-scan the file, so an independent dashboard
    process sees a live training run's appends.
    """

    def __init__(self, path: str):
        super().__init__()
        self.path = path
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        # touch so readers don't race a missing file
        if not os.path.exists(path):
            with open(path, "a"):
                pass

    def _append(self, rec: Dict[str, Any]):
        with self._lock:
            with open(self.path, "a") as f:
                f.write(json.dumps(rec) + "\n")

    def _scan(self):
        with self._lock:
            with open(self.path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        yield json.loads(line)
                    except json.JSONDecodeError:
                        continue  # torn tail write from a live run

    def put_static_info(self, session_id, worker_id, info):
        known = session_id in self.list_session_ids()
        self._append({"kind": "static", "session": session_id,
                      "worker": worker_id, "data": info})
        if not known:
            self._notify(StatsStorageEvent.NEW_SESSION, session_id, worker_id)
        self._notify(StatsStorageEvent.POST_STATIC, session_id, worker_id)

    def put_update(self, session_id, worker_id, update):
        self._append({"kind": "update", "session": session_id,
                      "worker": worker_id, "data": update})
        self._notify(StatsStorageEvent.POST_UPDATE, session_id, worker_id)

    def list_session_ids(self):
        return sorted({r["session"] for r in self._scan()})

    def list_worker_ids(self, session_id):
        return sorted({r["worker"] for r in self._scan()
                       if r["session"] == session_id})

    def get_static_info(self, session_id, worker_id):
        out = None
        for r in self._scan():
            if (r["kind"] == "static" and r["session"] == session_id
                    and r["worker"] == worker_id):
                out = r["data"]  # last write wins
        return out

    def get_updates(self, session_id, worker_id, since_iteration=-1):
        out = [r["data"] for r in self._scan()
               if (r["kind"] == "update" and r["session"] == session_id
                   and r["worker"] == worker_id)]
        return [u for u in out if u.get("iteration", 0) > since_iteration]


class SqliteStatsStorage(StatsStorage):
    """Indexed SQLite backend (reference ui/storage/sqlite/
    J7FileStatsStorage / the sqlite storage module): durable, queryable by
    (session, worker, iteration) with an index, safe for a separate
    dashboard process to read while a training run writes (WAL mode).
    Records are stored as JSON text — same dict records as every other
    backend."""

    def __init__(self, path: str):
        super().__init__()
        import sqlite3
        self.path = path
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._conn.execute("PRAGMA journal_mode=WAL")
        with self._lock:
            self._conn.execute(
                "CREATE TABLE IF NOT EXISTS static_info ("
                " session TEXT NOT NULL, worker TEXT NOT NULL,"
                " data TEXT NOT NULL, PRIMARY KEY (session, worker))")
            self._conn.execute(
                "CREATE TABLE IF NOT EXISTS updates ("
                " session TEXT NOT NULL, worker TEXT NOT NULL,"
                " iteration INTEGER NOT NULL, data TEXT NOT NULL)")
            self._conn.execute(
                "CREATE INDEX IF NOT EXISTS idx_updates"
                " ON updates (session, worker, iteration)")
            self._conn.commit()

    def put_static_info(self, session_id, worker_id, info):
        with self._lock:
            known = session_id in self.list_session_ids()
            self._conn.execute(
                "INSERT OR REPLACE INTO static_info VALUES (?, ?, ?)",
                (session_id, worker_id, json.dumps(info)))
            self._conn.commit()
        if not known:
            self._notify(StatsStorageEvent.NEW_SESSION, session_id, worker_id)
        self._notify(StatsStorageEvent.POST_STATIC, session_id, worker_id)

    def put_update(self, session_id, worker_id, update):
        with self._lock:
            self._conn.execute(
                "INSERT INTO updates VALUES (?, ?, ?, ?)",
                (session_id, worker_id, int(update.get("iteration", 0)),
                 json.dumps(update)))
            self._conn.commit()
        self._notify(StatsStorageEvent.POST_UPDATE, session_id, worker_id)

    def list_session_ids(self):
        with self._lock:
            rows = self._conn.execute(
                "SELECT DISTINCT session FROM static_info "
                "UNION SELECT DISTINCT session FROM updates").fetchall()
        return sorted(r[0] for r in rows)

    def list_worker_ids(self, session_id):
        with self._lock:
            rows = self._conn.execute(
                "SELECT DISTINCT worker FROM static_info WHERE session=? "
                "UNION SELECT DISTINCT worker FROM updates WHERE session=?",
                (session_id, session_id)).fetchall()
        return sorted(r[0] for r in rows)

    def get_static_info(self, session_id, worker_id):
        with self._lock:
            row = self._conn.execute(
                "SELECT data FROM static_info WHERE session=? AND worker=?",
                (session_id, worker_id)).fetchone()
        return json.loads(row[0]) if row else None

    def get_updates(self, session_id, worker_id, since_iteration=-1):
        with self._lock:
            rows = self._conn.execute(
                "SELECT data FROM updates WHERE session=? AND worker=? AND "
                "iteration>? ORDER BY iteration, rowid",
                (session_id, worker_id, since_iteration)).fetchall()
        return [json.loads(r[0]) for r in rows]

    def close(self):
        with self._lock:
            self._conn.close()


class RemoteStatsStorageRouter(StatsStorage):
    """Client-side router POSTing every record to a remote TrainingUIServer's
    /collect endpoint (reference core/api/storage/impl/
    RemoteUIStatsStorageRouter.java + the Play RemoteReceiverModule, which
    queues asynchronously with bounded retries). Writes are ASYNC: a
    background thread drains a bounded queue with per-record retries;
    transport failures never reach (or block) the training loop — dropped
    records are counted in ``dropped``. ``flush()`` waits for the queue to
    drain (tests / shutdown). Only the write half of the StatsStorage SPI is
    functional — reads go to the server's own storage."""

    def __init__(self, url: str, timeout: float = 10.0, queue_size: int = 256,
                 max_retries: int = 3, retry_delay: float = 0.2):
        super().__init__()
        import queue as _queue
        import threading as _threading
        self.url = url.rstrip("/") + "/collect"
        self.timeout = timeout
        self.max_retries = max_retries
        self.retry_delay = retry_delay
        self.dropped = 0
        self._q: "_queue.Queue" = _queue.Queue(maxsize=queue_size)
        self._worker = _threading.Thread(target=self._drain, daemon=True)
        self._worker.start()

    def _drain(self):
        import time as _time
        while True:
            payload = self._q.get()
            ok = False
            for attempt in range(self.max_retries):
                try:
                    self._post(payload)
                    ok = True
                    break
                except Exception:
                    _time.sleep(self.retry_delay * (attempt + 1))
            if not ok:
                self.dropped += 1
            self._q.task_done()

    def _post(self, payload):
        import json as _json
        import urllib.request
        req = urllib.request.Request(
            self.url, data=_json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=self.timeout) as r:
            r.read()

    def _enqueue(self, payload):
        import queue as _queue
        try:
            self._q.put_nowait(payload)
        except _queue.Full:
            self.dropped += 1        # back-pressure: drop, never block fit()

    def flush(self):
        self._q.join()

    def put_static_info(self, session_id, worker_id, info):
        self._enqueue({"kind": "static", "session_id": session_id,
                       "worker_id": worker_id, "data": info})

    def put_update(self, session_id, worker_id, update):
        self._enqueue({"kind": "update", "session_id": session_id,
                       "worker_id": worker_id, "data": update})

    def list_session_ids(self):
        return []

    def list_worker_ids(self, session_id):
        return []

    def get_static_info(self, session_id, worker_id):
        return None

    def get_updates(self, session_id, worker_id, since_iteration=-1):
        return []
