"""The port's ``FleetRouter`` over in-process replicas: routing,
failover, membership. The reference's ``tests/test_fleet_router.py`` case
by case, on the port's ``GenerationEngine`` on the CPU.

Two real ServingHTTPServer+GenerationEngine replicas (same seed -> same
weights) registered by URL — everything the router does above the
process layer is pinned here without spawning subprocesses: affinity
concentration vs round-robin spread, the DEAD_AFTER=3 mark-dead
discipline, pre-first-token failover idempotency (the replayed request's
tokens are EXACTLY the single-replica greedy sequence, with the
``fleet.retry`` trace marker), non-retryable error passthrough, and
drain-then-remove scale-in. The subprocess/chaos half lives in
tests/test_fleet_process.py.
"""
import _torch_threads  # noqa: F401
import socket

import pytest

from deeplearning4j_tpu_torch import telemetry
from deeplearning4j_tpu_torch.models.decode import (TransformerDecodeSpec,
                                                    naive_generate)
from deeplearning4j_tpu_torch.models.zoo_extra import transformer_lm
from deeplearning4j_tpu_torch.serving import ServingHTTPServer
from deeplearning4j_tpu_torch.serving.fleet import (DEAD_AFTER,
                                                    FleetHTTPError,
                                                    FleetRouter,
                                                    NoReadyReplicaError)
from deeplearning4j_tpu_torch.serving.fleet.affinity import prompt_chain
from deeplearning4j_tpu_torch.serving.generation import GenerationEngine
from deeplearning4j_tpu_torch.telemetry import (MetricsRegistry)
from _torch_flightrec import _port_flightrec_dir  # noqa: F401

PROMPT = list(range(1, 17))     # two full 8-token blocks


@pytest.fixture
def fresh_registry():
    reg = MetricsRegistry(enabled=True)
    prev = telemetry.set_registry(reg)
    try:
        yield reg
    finally:
        telemetry.set_registry(prev)


@pytest.fixture(scope="module")
def pair():
    """Two live replicas with identical weights + the reference net."""
    net = transformer_lm(vocab_size=29, d_model=16, n_heads=2, n_blocks=1,
                         max_length=32, seed=7, dtype="float32",
                         token_input=True, device="cpu").init()
    servers, engines, urls = [], [], []
    for _ in range(2):
        eng = GenerationEngine(net, model_name="lm", block_len=8,
                               max_seq_len=32, decode_slots=2,
                               prefill_batches=(1,), prompt_rungs=(32,),
                               device="cpu")
        srv = ServingHTTPServer(generation=eng)
        urls.append(f"http://127.0.0.1:{srv.start()}")
        servers.append(srv)
        engines.append(eng)
    yield {"urls": urls, "net": net, "spec": TransformerDecodeSpec(net)}
    for srv, eng in zip(servers, engines):
        srv.stop()
        eng.stop(drain=False, timeout=5.0)


def _router(pair, policy="affinity", **kw):
    r = FleetRouter(policy=policy, **kw)
    for url in pair["urls"]:
        r.add_url(url)
    return r


def _dead_url():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return f"http://127.0.0.1:{port}"


# ---------------------------------------------------------------- routing
def test_block_len_adopted_from_replica_steering(pair):
    router = _router(pair)
    try:
        assert router.block_len == 8        # the engines', not the default
        assert router.ready_count() == 2
    finally:
        router.close()


def test_affinity_concentrates_repeated_prefixes(pair):
    router = _router(pair)
    try:
        hit = set()
        for _ in range(6):
            status, body = router.generate_blocking(
                {"prompt": PROMPT, "max_tokens": 4})
            assert status == 200 and body["reason"] == "length"
            hit.add(body["replica"])
        # the whole point: every repeat landed on the SAME cache
        assert len(hit) == 1
        router.poll_once()                  # refresh steering snapshots
        m = router.metrics()
        assert m["aggregate_prefix_hit_rate"] > 0.3
        assert m["affinity"]["entries"] >= 2
        assert m["requests"] == 6 and m["retries"] == 0
    finally:
        router.close()


def test_affinity_spreads_distinct_prefixes(pair):
    """Unseen prefixes rendezvous across the fleet — N replicas must be
    N caches, not N copies. Deterministic given ids + prompts."""
    router = _router(pair)
    try:
        firsts = {router.candidates([t, t + 1] * 8)[0][0]
                  for t in range(1, 13)}
        assert firsts == {"r0", "r1"}
    finally:
        router.close()


def test_round_robin_alternates(pair):
    router = _router(pair, policy="round_robin")
    try:
        seen = []
        for _ in range(4):
            status, body = router.generate_blocking(
                {"prompt": PROMPT, "max_tokens": 2})
            assert status == 200
            seen.append(body["replica"])
        assert set(seen) == {"r0", "r1"}
        assert seen[0] != seen[1] and seen[1] != seen[2]
    finally:
        router.close()


def test_least_loaded_orders_by_queue_and_in_flight(pair):
    router = _router(pair, policy="least_loaded")
    try:
        with router._lock:
            router._replicas["r0"].steering = {"queue_depth": 5,
                                               "in_flight": 2}
            router._replicas["r1"].steering = {"queue_depth": 0,
                                               "in_flight": 1}
        ids, reason = router.candidates(PROMPT)
        assert ids == ["r1", "r0"] and reason == "least_loaded"
    finally:
        router.close()


# ----------------------------------------------------------- mark-dead
def test_replica_dead_after_three_transport_failures(pair, fresh_registry):
    router = FleetRouter(policy="affinity", block_len=8)
    try:
        rid = router.add_url(_dead_url())   # poll #1 fails inside add_url
        router.affinity.record([b"h0", b"h1"], rid)
        assert router.replicas()[0]["state"] != "dead"
        router.poll_replica(rid)            # strike 2
        assert router.replicas()[0]["state"] != "dead"
        router.poll_replica(rid)            # strike 3 -> dead
        row = router.replicas()[0]
        assert row["state"] == "dead"
        assert row["consecutive_failures"] == DEAD_AFTER
        m = router.metrics()
        assert m["replica_deaths"] == 1
        # its cache died with it: affinity entries dropped
        assert rid not in m["affinity"]["entries_per_replica"]
        assert any(e["name"] == "fleet.replica_dead"
                   for e in fresh_registry.trace_events())
    finally:
        router.close()


def test_dead_after_discipline_is_pinned():
    """The reference's 3-consecutive-failure mark-dead discipline: a
    change here must be a deliberate one, in both packages."""
    from deeplearning4j_tpu.serving.fleet import DEAD_AFTER as JDEAD
    assert DEAD_AFTER == JDEAD == 3


# ------------------------------------------------------------- failover
def test_pre_first_token_failover_is_idempotent(pair, fresh_registry):
    """Affinity points at a dead replica; the replay on the survivor must
    produce EXACTLY the single-replica greedy sequence — never a partial,
    spliced, or double-emitted stream — and must land the fleet.retry
    trace marker plus a retries count on the done line."""
    router = _router(pair)
    try:
        ghost = router.add_url(_dead_url(), replica_id="ghost")
        with router._lock:
            router._replicas[ghost].state = "ready"     # lie: looks alive
        chain_prompt = PROMPT
        router.affinity.record(prompt_chain(chain_prompt, 8), ghost)
        assert router.candidates(chain_prompt)[0][0] == ghost

        want = naive_generate(pair["net"], chain_prompt, 6, pad_to=32,
                              spec=pair["spec"], device="cpu")
        lines = list(router.stream_generate(
            {"prompt": chain_prompt, "max_tokens": 6}))
        toks = [l["token"] for l in lines if "token" in l]
        assert toks == want
        done = lines[-1]
        assert done["done"] and done["reason"] == "length"
        assert done["replica"] in ("r0", "r1")
        assert done["retries"] >= 1
        names = [e["name"] for e in fresh_registry.trace_events()]
        assert "fleet.retry" in names
        assert "fleet.route" in names
        assert router.metrics()["retries"] >= 1
    finally:
        router.close()


def test_blocking_failover_matches_naive(pair, fresh_registry):
    router = _router(pair)
    try:
        ghost = router.add_url(_dead_url(), replica_id="ghost")
        with router._lock:
            router._replicas[ghost].state = "ready"
        router.affinity.record(prompt_chain(PROMPT, 8), ghost)
        want = naive_generate(pair["net"], PROMPT, 5, pad_to=32,
                              spec=pair["spec"], device="cpu")
        status, body = router.generate_blocking(
            {"prompt": PROMPT, "max_tokens": 5})
        assert status == 200
        assert body["tokens"] == want
        assert body["retries"] >= 1
    finally:
        router.close()


def test_non_retryable_replica_error_passes_through(pair):
    router = _router(pair)
    try:
        with pytest.raises(FleetHTTPError) as ei:
            list(router.stream_generate({"prompt": PROMPT,
                                         "max_tokens": 2}, "nope"))
        assert ei.value.status == 404
        status, body = router.generate_blocking(
            {"prompt": PROMPT, "max_tokens": 2}, "nope")
        assert status == 404 and "error" in body
    finally:
        router.close()


def test_empty_fleet_rejects_cleanly():
    router = FleetRouter(policy="affinity", block_len=8)
    try:
        with pytest.raises(NoReadyReplicaError):
            list(router.stream_generate({"prompt": PROMPT,
                                         "max_tokens": 2}))
        status, body = router.generate_blocking({"prompt": PROMPT,
                                                 "max_tokens": 2})
        assert status == 503 and body["kind"] == "NoReadyReplica"
        status, _ = router.forward_json("GET", "/health")
        assert status == 503
        assert router.metrics()["rejected"] >= 2
    finally:
        router.close()


# --------------------------------------------------------------- scale-in
def test_drain_replica_removes_from_membership(pair):
    router = _router(pair)
    try:
        assert router.drain_replica("r0", timeout=5.0) is True
        assert [r["id"] for r in router.replicas()] == ["r1"]
        ids, _ = router.candidates(PROMPT)
        assert ids == ["r1"]
        status, body = router.generate_blocking(
            {"prompt": PROMPT, "max_tokens": 2})
        assert status == 200 and body["replica"] == "r1"
    finally:
        router.close()


def test_forward_json_reaches_a_replica(pair):
    router = _router(pair)
    try:
        status, body = router.forward_json("GET", "/health")
        assert status == 200
        assert "steering" in body
    finally:
        router.close()
