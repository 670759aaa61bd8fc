"""Replica process supervisor + the replica child entrypoint.

Counterpart of ``deeplearning4j_tpu/serving/fleet/replica.py``. The spec
gains ``device`` (``"cuda"`` unless it says ``"cpu"``, the tests' choice):
the child builds its network and engine there. On a machine with one card
the replicas are separate CUDA processes that share it. The zoo spec
builds the port's ``models/zoo_extra.py`` ``transformer_lm``; a ``path``
restores through ``serving/registry.py`` ``load_net``.

One replica = one OS process running the EXISTING single-process serving
stack (``GenerationEngine`` behind ``ServingHTTPServer``) — the fleet
adds supervision around it, it does not fork the engine. The SparkNet
shape (arXiv 1511.06051): a coordinator supervising workers that each
hold warm state, coupled only through cheap periodic state publication
(here: the ``/health`` steering payload), never through tight RPC.

Child lifecycle
(``python -m deeplearning4j_tpu_torch.serving.fleet.replica``):
  1. point the kernel-library directory at the shared one
     (coldstart.py) BEFORE any kernel is loaded, so warm-directory
     replicas load instead of build;
  2. build the model from the spec — a checkpoint/model-zip ``path``
     (serving.registry.load_net) or a deterministic ``zoo`` constructor
     (same seed -> identical params in every replica, no weight
     distribution step needed for benches and tests);
  3. construct + warm the GenerationEngine, start the HTTP server;
  4. atomically write the ready file (port, pid, ready_s, cold-start
     accounting) — the supervisor's readiness gate, then double-gated by
     ``GET /health`` 200. The kernel wrappers' launch counts are reset
     here, so the ``replica`` block of ``/health`` serves
     ``kernel_launches``: each forward kernel's launches since the replica
     turned ready (its warm-up's not among them; a decode graph's replays
     are no wrapper launch, the runtime's ``graph_stats`` counts them);
  5. wait for SIGTERM/SIGINT -> drain-then-stop (in-flight generations
     finish, new admissions see 503) -> exit 0.

The supervisor (:class:`ReplicaProcess`) owns spawn/readiness/terminate/
kill/restart and keeps each replica's stdout+stderr in a per-replica log
file for post-mortems.
"""
from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time
from typing import Optional


def _default_spec_model() -> dict:
    """The tiny deterministic LM used when a spec omits ``model`` —
    bench/test scaffolding, not a production default."""
    return {"zoo": "transformer_lm",
            "kwargs": {"vocab_size": 64, "d_model": 16, "n_heads": 2,
                       "n_blocks": 1, "max_length": 64, "seed": 7,
                       "dtype": "float32", "token_input": True}}


class ReplicaProcess:
    """Spawn/supervise one replica child.

        proc = ReplicaProcess(spec, "r0", workdir=tmp).start()
        info = proc.wait_ready(timeout=60)     # {"port": ..., ...}
        ...
        proc.terminate(drain=True)             # SIGTERM -> drain -> exit

    ``spec`` keys: ``model`` ({"path": ...} or {"zoo": name,
    "kwargs": {...}}), ``model_name``, ``generation`` (GenerationConfig
    kwargs), ``device`` (``"cuda"`` by default), ``host``, ``port``,
    ``compile_cache`` (falls back to the ``DL4J_TPU_COMPILE_CACHE`` env
    knob).
    """

    def __init__(self, spec: dict, replica_id: str, *, workdir: str,
                 env: Optional[dict] = None, python: str = sys.executable):
        self.spec = dict(spec)
        self.id = str(replica_id)
        self.spec.setdefault("replica_id", self.id)
        self.workdir = workdir
        self.env = dict(env or {})
        self.python = python
        self.proc: Optional[subprocess.Popen] = None
        self.ready_info: Optional[dict] = None
        self._log_file = None
        os.makedirs(workdir, exist_ok=True)
        self.spec_path = os.path.join(workdir, f"replica-{self.id}.spec.json")
        self.ready_path = os.path.join(workdir,
                                       f"replica-{self.id}.ready.json")
        self.log_path = os.path.join(workdir, f"replica-{self.id}.log")
        # crash-durable black box: the child periodically spills its trace
        # ring + raw metrics here (telemetry/spool.py); survives SIGKILL
        self.spool_path = os.path.join(workdir,
                                       f"replica-{self.id}.spool.json")
        self.spec.setdefault("spool_path", self.spool_path)

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "ReplicaProcess":
        if self.alive:
            raise RuntimeError(f"replica {self.id} already running")
        self.ready_info = None
        try:
            os.unlink(self.ready_path)
        except FileNotFoundError:
            pass
        with open(self.spec_path, "w") as f:
            json.dump(self.spec, f)
        env = {**os.environ, **self.env}
        # chaos dumps from the child must land beside its log, never in
        # the caller's working tree (the conftest discipline, fleet-wide)
        env.setdefault("DL4J_TPU_FLIGHTREC_DIR",
                       os.path.join(self.workdir, "flightrec"))
        self._log_file = open(self.log_path, "ab")
        self.proc = subprocess.Popen(
            [self.python, "-m",
             "deeplearning4j_tpu_torch.serving.fleet.replica",
             "--spec", self.spec_path, "--ready-file", self.ready_path],
            stdout=self._log_file, stderr=subprocess.STDOUT, env=env,
            start_new_session=True)
        return self

    @property
    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None

    @property
    def pid(self) -> Optional[int]:
        return self.proc.pid if self.proc is not None else None

    @property
    def base_url(self) -> Optional[str]:
        if self.ready_info is None:
            return None
        host = self.spec.get("host", "127.0.0.1")
        return f"http://{host}:{self.ready_info['port']}"

    def wait_ready(self, timeout: float = 120.0, *, client=None,
                   poll_s: float = 0.05) -> dict:
        """Block until the child wrote its ready file AND answers
        ``GET /health`` 200. Raises RuntimeError (with the log tail) if
        the child exits first, TimeoutError on the deadline."""
        deadline = time.monotonic() + timeout
        while self.ready_info is None:
            if not self.alive:
                raise RuntimeError(
                    f"replica {self.id} exited rc={self.proc.returncode} "
                    f"before ready:\n{self.log_tail()}")
            try:
                with open(self.ready_path) as f:
                    self.ready_info = json.load(f)
            except (FileNotFoundError, json.JSONDecodeError):
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"replica {self.id} not ready after {timeout}s:\n"
                        f"{self.log_tail()}") from None
                time.sleep(poll_s)
        # health gate: the listener is up, now require a 200 (not 503)
        from ...util.httpjson import HTTPClient
        own = client is None
        client = client or HTTPClient(max_per_host=1, timeout=5.0)
        try:
            while True:
                try:
                    status, _ = client.request_json(
                        "GET", self.base_url + "/health", timeout=2.0)
                    if status == 200:
                        return self.ready_info
                except Exception:
                    pass
                if not self.alive:
                    raise RuntimeError(
                        f"replica {self.id} died during health gate:\n"
                        f"{self.log_tail()}")
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"replica {self.id} /health not 200 after "
                        f"{timeout}s:\n{self.log_tail()}")
                time.sleep(poll_s)
        finally:
            if own:
                client.close()

    def terminate(self, drain: bool = True, timeout: float = 15.0) -> int:
        """Drain-then-stop: SIGTERM (child drains engines, finishes
        in-flight generations, exits 0); SIGKILL only past ``timeout``.
        ``drain=False`` goes straight to SIGKILL. Returns the exit code."""
        if self.proc is None:
            return 0
        if self.proc.poll() is None:
            if drain:
                self.proc.send_signal(signal.SIGTERM)
                try:
                    self.proc.wait(timeout=timeout)
                except subprocess.TimeoutExpired:
                    self.proc.kill()
            else:
                self.proc.kill()
            self.proc.wait()
        self._close_log()
        return self.proc.returncode

    def kill(self) -> None:
        """Chaos path: immediate SIGKILL, no drain, no goodbye — the
        router must notice on its own."""
        if self.proc is not None and self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self._close_log()

    def restart(self) -> "ReplicaProcess":
        """Respawn after death (the supervisor's autorestart path)."""
        if self.alive:
            raise RuntimeError(f"replica {self.id} still alive")
        self._close_log()
        return self.start()

    def _close_log(self) -> None:
        if self._log_file is not None:
            try:
                self._log_file.close()
            except OSError:     # pragma: no cover - defensive
                pass
            self._log_file = None

    def log_tail(self, lines: int = 40) -> str:
        try:
            with open(self.log_path, "rb") as f:
                return b"\n".join(
                    f.read().splitlines()[-lines:]).decode("utf-8",
                                                           "replace")
        except OSError:
            return "<no log>"


# ----------------------------------------------------------- child process
def _build_net(model_spec: dict, device: str):
    if "path" in model_spec:
        from ..registry import load_net
        return load_net(model_spec["path"], device=device)
    if model_spec.get("zoo") == "transformer_lm":
        from ...models.zoo_extra import transformer_lm
        return transformer_lm(**model_spec.get("kwargs", {}),
                              device=device).init()
    raise ValueError(f"unsupported model spec: {model_spec!r}")


def _kernel_wrappers() -> dict:
    """The forward kernels a served language model launches, by the names
    of the port's launch counts: K1 (attention) and K5 (the LSTM loop).
    Each wrapper counts its own launches."""
    from ...ops import flash_attention, lstm
    return {"flash_attention_fwd": flash_attention.flash_attention,
            "lstm_fwd": lstm.fused_lstm_fwd}


def _tupled(cfg: dict) -> dict:
    """JSON round-trips tuples as lists; GenerationConfig wants tuples."""
    return {k: tuple(v) if isinstance(v, list) else v
            for k, v in cfg.items()}


def _child_main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(prog="deeplearning4j_tpu_torch fleet "
                                      "replica")
    ap.add_argument("--spec", required=True)
    ap.add_argument("--ready-file", required=True)
    args = ap.parse_args(argv)
    with open(args.spec) as f:
        spec = json.load(f)

    t0 = time.monotonic()
    # the directory must be set before the first kernel loads (coldstart.py)
    from . import coldstart
    cache_dir = coldstart.configure_compile_cache(spec.get("compile_cache"))

    from ..generation import GenerationEngine
    from ..http import ServingHTTPServer
    device = spec.get("device", "cuda")
    net = _build_net(spec.get("model") or _default_spec_model(), device)
    engine = GenerationEngine(net,
                              model_name=spec.get("model_name", "lm"),
                              device=device,
                              **_tupled(spec.get("generation", {})))

    replica_info = {"id": spec.get("replica_id"),
                    "pid": os.getpid(),
                    "device": str(engine.device),
                    "ready_s": None,        # filled below, served forever
                    "coldstart": None}
    kernels = _kernel_wrappers()
    srv = ServingHTTPServer(
        generation=engine, host=spec.get("host", "127.0.0.1"),
        port=int(spec.get("port", 0)),
        health_extra=lambda: {"replica": dict(
            replica_info, kernel_launches={n: w.launches
                                           for n, w in kernels.items()})})
    port = srv.start()
    for w in kernels.values():
        w.launches = 0                  # served launches only, not warm-up
    replica_info["ready_s"] = round(time.monotonic() - t0, 3)
    replica_info["coldstart"] = coldstart.snapshot()
    ready = {"port": port, "pid": os.getpid(),
             "ready_s": replica_info["ready_s"],
             "cache_dir": cache_dir, **replica_info["coldstart"]}
    tmp = args.ready_file + ".tmp"
    with open(tmp, "w") as f:
        json.dump(ready, f)
    os.replace(tmp, args.ready_file)    # atomic: never a half-read ready

    spool = None
    if spec.get("spool_path"):
        from ...telemetry.spool import TraceSpool
        spool = TraceSpool(spec["spool_path"],
                           replica_id=str(spec.get("replica_id") or ""),
                           period_s=float(spec.get("spool_period_s", 0.25))
                           ).start()

    import threading
    stop = threading.Event()

    def _on_signal(signum, frame):
        stop.set()

    signal.signal(signal.SIGTERM, _on_signal)
    signal.signal(signal.SIGINT, _on_signal)
    # Orphan watchdog: the child runs in its own session, so a SIGKILLed
    # supervisor delivers no signal here — without this check the replica
    # would serve nobody forever (the router died with the supervisor).
    # Reparenting (ppid change) is the orphan signal; drain and exit.
    parent = os.getppid()
    while not stop.wait(1.0):
        if os.getppid() != parent:
            break
    srv.stop(drain=True)                # finish in-flight, 503 the rest
    if spool is not None:
        spool.stop()                    # final spill covers the drain tail
    return 0


if __name__ == "__main__":      # pragma: no cover - subprocess entry
    sys.exit(_child_main())
