"""``tools/fleet_report.py`` reads the port's front door unchanged.

The tool is stdlib-only and stays as it is. Here it folds the port's
``FleetHTTPServer`` ``GET /metrics`` (two in-process replicas of the
port's ``GenerationEngine`` on the CPU, registered by URL) into the same
report, key for key, as the JAX front door's over the JAX package's
engines serving the same requests; its CLI renders a saved port snapshot
as text and JSON; and it imports neither package nor torch.
"""
import _torch_threads  # noqa: F401
import ast
import json
import os
import subprocess
import sys

import pytest

from deeplearning4j_tpu.models.zoo_extra import \
    transformer_lm as jtransformer_lm
from deeplearning4j_tpu.serving import GenerationEngine as JEngine
from deeplearning4j_tpu.serving import ServingHTTPServer as JServer
from deeplearning4j_tpu.serving.fleet import FleetHTTPServer as JFront
from deeplearning4j_tpu.serving.fleet import FleetRouter as JRouter
from deeplearning4j_tpu_torch.models.zoo_extra import transformer_lm
from deeplearning4j_tpu_torch.serving import ServingHTTPServer
from deeplearning4j_tpu_torch.serving.fleet import (FleetHTTPServer,
                                                    FleetRouter)
from deeplearning4j_tpu_torch.serving.generation import GenerationEngine
from _torch_flightrec import _port_flightrec_dir  # noqa: F401
from deeplearning4j_tpu_torch.util.httpjson import HTTPClient

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from tools import fleet_report  # noqa: E402

LM = dict(vocab_size=29, d_model=16, n_heads=2, n_blocks=1, max_length=32,
          seed=7, dtype="float32", token_input=True)
GEN = dict(model_name="lm", block_len=8, max_seq_len=32, decode_slots=2,
           prefill_batches=(1,), prompt_rungs=(32,))
PROMPTS = [list(range(1, 17))] * 3 + [list(range(5, 14))]


def _serve(make_engine, make_server, router_cls, front_cls):
    """Two replicas behind an affinity router and its front door; the
    prompts through the door; the door's ``GET /metrics``."""
    engines = [make_engine() for _ in range(2)]
    servers = [make_server(e) for e in engines]
    router = router_cls(policy="affinity", health_period_s=3600.0)
    front = front_cls(router)
    client = HTTPClient(max_per_host=2, timeout=30.0)
    try:
        for i, srv in enumerate(servers):
            router.add_url(f"http://127.0.0.1:{srv.start()}", f"f{i}")
        base = f"http://127.0.0.1:{front.start()}"
        for p in PROMPTS:
            status, _ = client.request_json(
                "POST", base + "/generate",
                payload={"prompt": p, "max_tokens": 3, "stream": False})
            assert status == 200
        router.poll_once()          # the steering after the traffic
        status, snap = client.request_json("GET", base + "/metrics")
        assert status == 200
        return snap
    finally:
        client.close()
        front.stop(close_router=True)
        for srv, eng in zip(servers, engines):
            srv.stop()
            eng.stop(drain=False, timeout=5.0)


@pytest.fixture(scope="module")
def snaps():
    port = _serve(
        lambda: GenerationEngine(transformer_lm(**LM, device="cpu").init(),
                                 device="cpu", **GEN),
        lambda e: ServingHTTPServer(generation=e), FleetRouter,
        FleetHTTPServer)
    ref = _serve(lambda: JEngine(jtransformer_lm(**LM).init(), **GEN),
                 lambda e: JServer(generation=e), JRouter, JFront)
    return port, ref


def _keys(report):
    return {"top": sorted(report), "totals": sorted(report["totals"]),
            "counters": sorted(report["counters"]),
            "row": sorted(report["rows"][0])}


def test_the_port_snapshot_folds_into_the_references_report(snaps):
    port, ref = snaps
    mine, theirs = fleet_report.fold(port), fleet_report.fold(ref)
    assert _keys(mine) == _keys(theirs)
    assert [r["id"] for r in mine["rows"]] == ["f0", "f1"]
    for key in ("replicas", "ready", "forwarded"):
        assert mine["totals"][key] == theirs["totals"][key], key
    assert mine["totals"]["forwarded"] == len(PROMPTS)
    assert mine["counters"]["requests"] == theirs["counters"]["requests"]
    # the repeated prompt sticks to one replica and hits its prefix cache
    assert mine["totals"]["aggregate_hit_rate"] == pytest.approx(
        port["aggregate_prefix_hit_rate"], abs=1e-3)
    assert mine["totals"]["aggregate_hit_rate"] > 0
    assert all(r["ttft_p50_ms"] is not None for r in mine["rows"]
               if r["forwarded"])


def test_the_cli_renders_a_saved_port_snapshot(snaps, tmp_path):
    path = tmp_path / "fleet_metrics.json"
    path.write_text(json.dumps(snaps[0]))
    tool = os.path.join(REPO, "tools", "fleet_report.py")
    out = subprocess.run([sys.executable, tool, str(path)],
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert "policy=affinity" in out.stdout and "TOTAL" in out.stdout
    assert any(l.lstrip().startswith("f0") for l in out.stdout.splitlines())
    js = subprocess.run([sys.executable, tool, str(path), "--json"],
                        capture_output=True, text=True, timeout=60)
    assert js.returncode == 0
    assert json.loads(js.stdout)["totals"]["replicas"] == 2


def test_the_tool_imports_neither_package_nor_torch():
    tree = ast.parse(open(os.path.join(REPO, "tools",
                                       "fleet_report.py")).read())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            mods.add(node.module.split(".")[0])
    assert not mods & {"deeplearning4j_tpu", "deeplearning4j_tpu_torch",
                       "torch", "jax", "numpy"}
