"""The port's fleet under chaos: two replica OS processes on the CPU
(``"device": "cpu"``) behind the router and the front door, killed and
revived. The second half of the reference's ``tests/test_fleet_process.py``
(its first half is ``tests/test_torch_fleet_process.py``):

- a SIGKILL at the first streamed token loses only that stream, closed
  with ``reason: "replica_lost"``; the router marks the victim dead and
  dumps a ``fleet_replica_lost`` black box; the survivor keeps serving;
- a kill before the first token replays on the survivor with the exact
  greedy sequence and a ``fleet.retry`` event;
- a killed replica's spool spill outlives it, rides in the router's dump
  as ``victim_spill`` and stitches into the fleet timeline;
- scale-in drains a replica to exit code 0, and a replica respawned on
  the warm kernel-library directory reports zero fresh builds.

Every destructive test revives its victim before it returns. Every wait
is on a state, never a sleep. The children's dumps land in this module's
tmp dir (``DL4J_TPU_FLIGHTREC_DIR``). The reference's slow chaos soak and
orphan test stay slow there and are not ported."""
import _torch_threads  # noqa: F401
import json
import os
import time
from types import SimpleNamespace

import pytest

from deeplearning4j_tpu_torch import telemetry
from deeplearning4j_tpu_torch.models.decode import (TransformerDecodeSpec,
                                                    naive_generate)
from deeplearning4j_tpu_torch.models.zoo_extra import transformer_lm
from deeplearning4j_tpu_torch.serving.fleet import (FleetCollector,
                                                    FleetHTTPServer,
                                                    FleetRouter,
                                                    ReplicaProcess)
from deeplearning4j_tpu_torch.telemetry import (MetricsRegistry,
                                                configure_flight_recorder,
                                                get_flight_recorder)
from deeplearning4j_tpu_torch.telemetry.spool import read_spool
from deeplearning4j_tpu_torch.util.httpjson import HTTPClient

# big enough that a 200-token decode takes a while on the CPU: the kill
# at the first token must land while tokens are still being produced
MODEL_KW = dict(vocab_size=64, d_model=64, n_heads=4, n_blocks=2,
                max_length=256, seed=7, dtype="float32", token_input=True)
GEN_KW = dict(block_len=16, max_seq_len=224, decode_slots=2,
              prefill_batches=[1], num_blocks=32, queue_limit=64)
CAPACITY = 224


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    work = tmp_path_factory.mktemp("fleet")
    dumps = str(tmp_path_factory.mktemp("torch_flightrec"))
    configure_flight_recorder(directory=dumps)
    spec = {"model": {"zoo": "transformer_lm", "kwargs": MODEL_KW},
            "model_name": "lm", "generation": GEN_KW, "device": "cpu",
            "compile_cache": str(work / "cache"), "spool_period_s": 0.1}
    env = {"DL4J_TPU_FLIGHTREC_DIR": dumps, "OMP_NUM_THREADS": "2"}
    procs = {rid: ReplicaProcess(spec, rid, workdir=str(work), env=env)
             for rid in ("f0", "f1")}
    router = FleetRouter(policy="affinity", health_period_s=0.1).start()
    front = FleetHTTPServer(router)
    client = HTTPClient(max_per_host=4, timeout=60.0)
    try:
        for p in procs.values():
            p.start()
        for rid in ("f0", "f1"):
            router.add_process(procs[rid], wait_ready=True, timeout=240.0)
        base = f"http://127.0.0.1:{front.start()}"
        yield SimpleNamespace(work=work, spec=spec, procs=procs,
                              router=router, front=front, base=base,
                              client=client, dumps=dumps)
    finally:
        client.close()
        front.stop(close_router=True)   # drain-stops every live replica


def _revive(fleet, rid):
    """Restore the 2-replica state after a destructive test."""
    proc = fleet.procs[rid]
    fleet.router.remove_replica(rid)
    if proc.alive:
        proc.kill()
    proc.restart()
    fleet.router.add_process(proc, wait_ready=True, timeout=240.0)


def _want(prompt, n):
    net = transformer_lm(**MODEL_KW, device="cpu").init()
    return naive_generate(net, prompt, n, pad_to=CAPACITY,
                          spec=TransformerDecodeSpec(net), device="cpu")


def _stream_lines(fleet, payload, on_line=None):
    body = json.dumps(payload).encode()
    lines = []
    with fleet.client.stream("POST", fleet.base + "/generate", body=body,
                             headers={"Content-Type": "application/json"},
                             timeout=120.0) as resp:
        assert resp.status == 200
        for raw in resp:
            if not raw.strip():
                continue
            obj = json.loads(raw)
            lines.append(obj)
            if on_line is not None:
                on_line(obj)
    return lines


def _blocking(fleet, payload, headers=None):
    return fleet.client.request_json(
        "POST", fleet.base + "/generate",
        payload={**payload, "stream": False}, headers=headers,
        timeout=120.0)


def _wait(pred, timeout=20.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return False


def _state(router, rid):
    return {r["id"]: r for r in router.replicas()}.get(rid, {}).get("state")


def _lost_dumps(directory):
    out = []
    for fn in os.listdir(directory):
        if "fleet_replica_lost" in fn:
            with open(os.path.join(directory, fn)) as f:
                out.append(json.load(f)["info"])
    return out


# ------------------------------------------------------------------ chaos
def test_sigkill_loses_only_the_inflight_stream(fleet):
    prompt = [5, 9, 13, 17] * 6        # 24 tokens: one full 16-block
    _, probe = _blocking(fleet, {"prompt": prompt, "max_tokens": 2})
    victim = probe["replica"]
    survivor = "f1" if victim == "f0" else "f0"
    try:
        killed = []

        def kill_at_first_token(obj):
            if "token" in obj and not killed:
                killed.append(True)
                fleet.router.kill_replica(victim)

        lines = _stream_lines(fleet, {"prompt": prompt, "max_tokens": 200},
                              on_line=kill_at_first_token)
        done = lines[-1]
        assert done["done"] is True
        # closed with a reason; nothing replays after the first token
        assert done["reason"] == "replica_lost"
        assert done["replica"] == victim
        n_tokens = sum(1 for l in lines if "token" in l)
        assert done["tokens"] == n_tokens
        assert n_tokens < 200
        # the router notices on its own and marks the victim dead, after
        # its black box is on disk
        assert _wait(lambda: _state(fleet.router, victim) == "dead")
        rec_dir = get_flight_recorder().directory
        assert rec_dir == fleet.dumps
        assert any(info.get("replica") == victim
                   for info in _lost_dumps(rec_dir))
        status, body = _blocking(fleet, {"prompt": prompt,
                                         "max_tokens": 4})
        assert status == 200 and body["replica"] == survivor
    finally:
        _revive(fleet, victim)


def test_pre_first_token_kill_replays_idempotently(fleet):
    """Kill the affinity target before the request: the router fails over
    and the client sees one clean greedy sequence, plus ``fleet.retry``."""
    prompt = [3, 6, 9, 12] * 5          # a prefix of its own
    _, probe = _blocking(fleet, {"prompt": prompt, "max_tokens": 2})
    victim = probe["replica"]
    want = _want(prompt, 6)
    fleet.router.stop()                 # freeze: the victim stays READY
    reg = MetricsRegistry(enabled=True)
    prev = telemetry.set_registry(reg)
    try:
        fleet.procs[victim].kill()
        lines = list(fleet.router.stream_generate(
            {"prompt": prompt, "max_tokens": 6}))
        toks = [l["token"] for l in lines if "token" in l]
        assert toks == want             # never partial, never double
        done = lines[-1]
        assert done["reason"] == "length"
        assert done["replica"] != victim
        assert done["retries"] >= 1
        assert "fleet.retry" in [e["name"] for e in reg.trace_events()]
    finally:
        telemetry.set_registry(prev)
        fleet.router.start()
        _revive(fleet, victim)


# ---------------------------------------------------------- observability
def test_sigkill_black_box_recovered_from_spool(fleet):
    """A killed replica's last spool spill tells its story: readable from
    disk, embedded as ``victim_spill`` in the router's dump, and ingested
    by the collector so its spans stitch into the fleet timeline."""
    tid = "cafebabe2026"
    reg = MetricsRegistry(enabled=True)
    prev = telemetry.set_registry(reg)
    col = FleetCollector(fleet.router, registry=reg)
    victim = None
    try:
        status, body = _blocking(fleet, {"prompt": [4, 8, 12, 16],
                                         "max_tokens": 3},
                                 headers={"X-Trace-Id": tid})
        assert status == 200
        victim = body["replica"]
        spool = fleet.procs[victim].spool_path

        def spilled():
            spill = read_spool(spool)
            return spill is not None and any(
                e.get("args", {}).get("trace_id") == tid
                and e["name"].startswith("generation.")
                for e in spill["events"])
        assert _wait(spilled)           # the request's spans reached disk
        fleet.router.kill_replica(victim)
        assert _wait(lambda: _state(fleet.router, victim) == "dead")
        spill = read_spool(spool)
        assert spill["replica"] == victim
        assert spill["pid"] > 0 and spill["seq"] > 0
        embedded = [info["victim_spill"]
                    for info in _lost_dumps(get_flight_recorder().directory)
                    if info.get("replica") == victim
                    and info.get("victim_spill")]
        assert any(any(e.get("args", {}).get("trace_id") == tid
                       for e in s.get("events", []))
                   for s in embedded), "no dump embeds the victim's spill"
        col.pull_once()
        assert col.spools_recovered >= 1
        events = col.events_for_trace(tid)
        assert any(e["args"]["replica"] == victim
                   and e["name"].startswith("generation.")
                   for e in events)
    finally:
        col.stop()
        telemetry.set_registry(prev)
        if victim is not None:
            _revive(fleet, victim)


# -------------------------------------------------------------- elasticity
def test_warm_cache_replica_joins_and_drains_out(fleet):
    """Scale-in drains a replica to a clean exit; the same replica
    respawned on the warm kernel-library directory reaches ready with no
    fresh build (the CPU builds none; the card's second replica is
    ``chip_smoke.py`` phase 21) and serves again."""
    assert fleet.router.drain_replica("f1", timeout=20.0) is True
    assert {r["id"] for r in fleet.router.replicas()} == {"f0"}
    assert fleet.procs["f1"].proc.returncode == 0   # SIGTERM -> drain -> 0
    fleet.procs["f1"].restart()
    fleet.router.add_process(fleet.procs["f1"], wait_ready=True,
                             timeout=240.0)
    info = fleet.procs["f1"].ready_info
    assert info["fresh_compiles"] == 0
    assert info["cache_dir"] == fleet.spec["compile_cache"]
    assert fleet.router.ready_count() == 2
