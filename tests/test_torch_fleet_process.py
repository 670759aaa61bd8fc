"""The port's fleet as deployed: two replica OS processes on the CPU
(``"device": "cpu"`` in the spec) behind the router and the front door.

The first half of the reference's ``tests/test_fleet_process.py`` (its
chaos half is ``tests/test_torch_fleet_chaos.py``, so that
``--dist loadfile`` puts the two on different workers): readiness gating
and the ``/health`` steering payload; front-door token streams equal to the
cache-free greedy reference; one ``X-Trace-Id`` stitched across the front
door and a replica process; the compile-cache knob, whose port counterpart
is the kernel-library directory; and a replica's default device, the card.

Every wait is on a state (a ready file, a ``/health`` answer, a pulled
event), never a sleep. The children's flight-recorder dumps land in this
module's tmp dir (``DL4J_TPU_FLIGHTREC_DIR``)."""
import _torch_threads  # noqa: F401
import json
import os
from types import SimpleNamespace

import pytest

from deeplearning4j_tpu_torch import telemetry
from deeplearning4j_tpu_torch.models.decode import (TransformerDecodeSpec,
                                                    naive_generate)
from deeplearning4j_tpu_torch.models.zoo_extra import transformer_lm
from deeplearning4j_tpu_torch.ops import nvcc
from deeplearning4j_tpu_torch.serving.fleet import (FleetCollector,
                                                    FleetHTTPServer,
                                                    FleetRouter,
                                                    ReplicaProcess, coldstart)
from deeplearning4j_tpu_torch.serving.fleet import replica as replica_mod
from deeplearning4j_tpu_torch.serving.fleet.collector import FRONT_DOOR
from deeplearning4j_tpu_torch.telemetry import (MetricsRegistry,
                                                configure_flight_recorder)
from deeplearning4j_tpu_torch.util.httpjson import HTTPClient

MODEL_KW = dict(vocab_size=64, d_model=32, n_heads=4, n_blocks=1,
                max_length=128, seed=7, dtype="float32", token_input=True)
GEN_KW = dict(block_len=16, max_seq_len=64, decode_slots=2,
              prefill_batches=[1], num_blocks=16, queue_limit=64)
CAPACITY = 64


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    work = tmp_path_factory.mktemp("fleet")
    dumps = str(tmp_path_factory.mktemp("torch_flightrec"))
    configure_flight_recorder(directory=dumps)
    spec = {"model": {"zoo": "transformer_lm", "kwargs": MODEL_KW},
            "model_name": "lm", "generation": GEN_KW, "device": "cpu",
            "compile_cache": str(work / "cache")}
    env = {"DL4J_TPU_FLIGHTREC_DIR": dumps, "OMP_NUM_THREADS": "2"}
    procs = {rid: ReplicaProcess(spec, rid, workdir=str(work), env=env)
             for rid in ("f0", "f1")}
    router = FleetRouter(policy="affinity", health_period_s=0.1).start()
    front = FleetHTTPServer(router)
    client = HTTPClient(max_per_host=4, timeout=60.0)
    try:
        for p in procs.values():      # both children warm up together
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


def _net():
    return transformer_lm(**MODEL_KW, device="cpu").init()


def _want(net, prompt, n):
    return naive_generate(net, prompt, n, pad_to=CAPACITY,
                          spec=TransformerDecodeSpec(net), device="cpu")


def _stream_lines(fleet, payload):
    body = json.dumps(payload).encode()
    with fleet.client.stream("POST", fleet.base + "/generate", body=body,
                             headers={"Content-Type": "application/json"},
                             timeout=120.0) as resp:
        assert resp.status == 200
        return [json.loads(raw) for raw in resp if raw.strip()]


def _blocking(fleet, payload):
    return fleet.client.request_json(
        "POST", fleet.base + "/generate", payload={**payload,
                                                   "stream": False},
        timeout=120.0)


# -------------------------------------------------------------- readiness
def test_readiness_gate_and_health_steering(fleet):
    for rid, proc in fleet.procs.items():
        info = proc.ready_info
        assert info["port"] > 0 and info["pid"] > 0
        assert info["ready_s"] > 0
        assert info["cache_dir"] == fleet.spec["compile_cache"]
        # the CPU builds no kernel; a replica's warm runs are its own
        assert info["fresh_compiles"] == 0 and info["warm_runs"] > 0
        status, health = fleet.client.request_json(
            "GET", proc.base_url + "/health", timeout=10.0)
        assert status == 200
        s = health["steering"]
        for key in ("queue_depth", "in_flight", "slot_occupancy",
                    "block_pool_free_frac", "prefix_hit_rate",
                    "prefix_lookups", "block_len"):
            assert key in s, key
        assert s["block_len"] == 16
        assert health["replica"]["id"] == rid
        assert health["replica"]["device"] == "cpu"
    status, body = fleet.client.request_json(
        "GET", fleet.base + "/health", timeout=10.0)
    assert status == 200 and body["ready"] == 2
    assert body["states"] == {"f0": "ready", "f1": "ready"}
    status, m = fleet.client.request_json(
        "GET", fleet.base + "/metrics", timeout=30.0)
    assert status == 200 and m["policy"] == "affinity"
    assert set(m["replicas"]) == {"f0", "f1"}
    assert set(m["replica_metrics"]) <= {"f0", "f1"}
    assert fleet.router.block_len == 16     # adopted from steering


# ------------------------------------------------------------ correctness
def test_front_door_matches_single_process_reference(fleet):
    prompt = list(range(2, 18))
    want = _want(_net(), prompt, 8)
    lines = _stream_lines(fleet, {"prompt": prompt, "max_tokens": 8})
    toks = [l["token"] for l in lines if "token" in l]
    assert toks == want
    done = lines[-1]
    assert done["done"] and done["reason"] == "length"
    assert done["replica"] in ("f0", "f1")
    # blocking rides the same affinity: same tokens, same replica
    status, body = _blocking(fleet, {"prompt": prompt, "max_tokens": 8})
    assert status == 200
    assert body["tokens"] == want
    assert body["replica"] == done["replica"]


def test_a_replica_serves_its_kernel_launches(fleet):
    """The ``replica`` block of ``/health`` carries each forward kernel
    wrapper's own launch count since the replica turned ready. On the CPU
    the wrappers take their plain versions, so serving launches none."""
    from deeplearning4j_tpu_torch.ops import flash_attention, lstm
    assert replica_mod._kernel_wrappers() == {
        "flash_attention_fwd": flash_attention.flash_attention,
        "lstm_fwd": lstm.fused_lstm_fwd}
    status, body = _blocking(fleet, {"prompt": list(range(3, 19)),
                                     "max_tokens": 4})
    assert status == 200
    status, health = fleet.client.request_json(
        "GET", fleet.procs[body["replica"]].base_url + "/health",
        timeout=10.0)
    assert status == 200
    assert health["replica"]["kernel_launches"] == {
        "flash_attention_fwd": 0, "lstm_fwd": 0}


# ---------------------------------------------------------- observability
def test_cross_process_trace_stitching(fleet, tmp_path):
    """One ``X-Trace-Id`` through front door -> router -> replica process
    comes back as one ts-ordered timeline attributed by process, and
    ``tools/trace2timeline.py`` renders the same stitched view."""
    from tools.trace2timeline import format_timeline, load_merged, timeline
    tid = "feedface2026"
    reg = MetricsRegistry(enabled=True)
    prev = telemetry.set_registry(reg)
    col = FleetCollector(fleet.router, registry=reg)
    try:
        status, body = fleet.client.request_json(
            "POST", fleet.base + "/generate",
            payload={"prompt": [2, 4, 6, 8], "max_tokens": 3,
                     "stream": False},
            headers={"X-Trace-Id": tid}, timeout=120.0)
        assert status == 200
        rid = body["replica"]
        assert col.pull_once() > 0 and col.pull_errors == 0
        events = col.events_for_trace(tid)
        replicas = {e["args"]["replica"] for e in events}
        assert {FRONT_DOOR, rid} <= replicas    # both processes present
        names = [e["name"] for e in events]
        assert any(n.startswith("fleet.") for n in names)       # front
        assert any(n.startswith("generation.") for n in names)  # replica
        ts = [e["ts"] for e in events]
        assert ts == sorted(ts)
        assert names.index("fleet.request") \
            < min(i for i, n in enumerate(names)
                  if n.startswith("generation."))
        f = tmp_path / "stitched.json"
        f.write_text(json.dumps({"events": events}))
        rows = timeline(load_merged([str(f)]), tid)
        assert [r["name"] for r in rows] == names
        text = format_timeline(rows)
        assert "replica" in text.splitlines()[0] and rid in text
    finally:
        col.stop()
        telemetry.set_registry(prev)


# ------------------------------------------------------------ cold start
def test_compile_cache_env_knob(tmp_path, monkeypatch):
    """``DL4J_TPU_COMPILE_CACHE`` names the kernel-library directory;
    '0' (or empty) leaves the default. A build counts once: the second
    replica to ask for a library finds it (a cache hit)."""
    monkeypatch.setattr(nvcc, "BUILD_DIR", nvcc.BUILD_DIR)
    monkeypatch.setattr(nvcc, "_counts", {"built": 0, "found": 0})
    monkeypatch.setattr(coldstart, "_configured_dir", None)
    cache = str(tmp_path / "cc")
    monkeypatch.setenv(coldstart.ENV_CACHE, cache)
    assert coldstart.configure_compile_cache() == cache
    assert nvcc.BUILD_DIR == tmp_path / "cc"
    assert coldstart.configured_cache_dir() == cache
    assert os.path.isdir(cache)
    # one nvcc build (a stand-in compiler), then the directory answers
    src = tmp_path / "k.cu"
    src.write_text("int x;\n")
    monkeypatch.setattr(nvcc, "_nvcc", lambda: "nvcc")

    def fake_run(cmd, **kw):
        open(cmd[cmd.index("-o") + 1], "w").close()
        return nvcc.subprocess.CompletedProcess(cmd, 0, "", "")
    monkeypatch.setattr(nvcc.subprocess, "run", fake_run)
    lib = nvcc.build_library(src)
    assert lib.parent == tmp_path / "cc"
    assert coldstart.fresh_compile_count() == 1
    assert nvcc.build_library(src) == lib
    snap = coldstart.snapshot()
    assert (snap["fresh_compiles"], snap["cache_hits"],
            snap["compiles"]) == (1, 1, 2)
    assert snap["cache_dir"] == cache and snap["warm_runs"] >= 0
    monkeypatch.setenv(coldstart.ENV_CACHE, "0")
    assert coldstart.configure_compile_cache() is None
    explicit = str(tmp_path / "explicit")        # a path beats the env
    assert coldstart.configure_compile_cache(explicit) == explicit


def test_a_replica_runs_on_the_card_unless_its_spec_says_cpu(tmp_path):
    """The child's device defaults to ``cuda``: without a card a spec with
    no ``device`` fails before it is ready, naming the CPU way out."""
    spec = {"model": {"zoo": "transformer_lm", "kwargs": MODEL_KW},
            "generation": GEN_KW}
    path = tmp_path / "spec.json"
    path.write_text(json.dumps(spec))
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default would serve on it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        replica_mod._child_main(["--spec", str(path), "--ready-file",
                                 str(tmp_path / "ready.json")])
    assert not (tmp_path / "ready.json").exists()
