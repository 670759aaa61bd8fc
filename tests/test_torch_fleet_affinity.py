"""The port's ``serving/fleet/affinity.py``: the routing math, no
processes involved. The reference's ``tests/test_fleet_affinity.py`` case
by case, and the pure functions beside the JAX package's on the same
inputs (``prompt_chain``, ``rendezvous_order``, the policy's ordering).

Pins the property the whole affinity design hangs on — the router's
chain hashes are THE SAME hashes the replica prefix caches key blocks by
(imported, not re-implemented) — plus rendezvous determinism/minimal
disruption, the learned LRU map, and the candidate-ordering policy
(affinity preferred, overload spills, unseen prefixes rendezvous).
"""
import _torch_threads  # noqa: F401
from types import SimpleNamespace

import numpy as np
import pytest

from deeplearning4j_tpu.serving.fleet import affinity as jaff
from deeplearning4j_tpu_torch.serving.fleet.affinity import (
    AffinityMap, AffinityPolicy, prompt_chain, rendezvous_order)
from deeplearning4j_tpu_torch.serving.generation.prefix import _block_hashes


def _view(rid, ready=True, queue=0, free=1.0):
    return SimpleNamespace(id=rid, ready=ready,
                           steering={"queue_depth": queue,
                                     "block_pool_free_frac": free})


# ------------------------------------------------------------- chain hash
def test_prompt_chain_is_the_prefix_cache_hash():
    prompt = list(range(3, 45))
    for blk in (8, 16):
        chain = prompt_chain(prompt, blk)
        want = _block_hashes(np.asarray(prompt, dtype=np.int32), blk)
        assert chain == want
        # only FULL blocks hash — the cache can only share full blocks
        assert len(chain) == len(prompt) // blk


def test_prompt_chain_is_a_rolling_chain():
    """chain(prefix) is a prefix of chain(extension): shared prompt heads
    share hashes, diverging tails diverge from the divergence block on."""
    head = list(range(32))
    a = prompt_chain(head + [1, 2, 3, 4, 5, 6, 7, 8], 8)
    b = prompt_chain(head + [9, 9, 9, 9, 9, 9, 9, 9], 8)
    assert a[:4] == b[:4] == prompt_chain(head, 8)
    assert a[4] != b[4]


def test_short_prompt_has_empty_chain():
    assert prompt_chain([1, 2, 3], 8) == []


# ------------------------------------------------------------- rendezvous
def test_rendezvous_is_deterministic_and_total():
    ids = [f"r{i}" for i in range(5)]
    key = b"some-chain-head"
    order = rendezvous_order(key, ids)
    assert sorted(order) == sorted(ids)
    assert order == rendezvous_order(key, list(reversed(ids)))


def test_rendezvous_minimal_disruption_on_member_loss():
    """Removing one replica must not remap keys that did not score
    highest on it — the surviving ids keep their relative order."""
    ids = [f"r{i}" for i in range(6)]
    keys = [f"key-{k}".encode() for k in range(40)]
    for key in keys:
        before = rendezvous_order(key, ids)
        lost = before[0]
        after = rendezvous_order(key, [r for r in ids if r != lost])
        assert after == [r for r in before if r != lost]


def test_rendezvous_spreads_distinct_keys():
    ids = ["a", "b", "c"]
    firsts = {rendezvous_order(f"k{i}".encode(), ids)[0]
              for i in range(60)}
    assert firsts == set(ids)   # every replica wins some keyspace


# ----------------------------------------------------------- affinity map
def test_affinity_map_longest_is_deepest_first():
    chain = prompt_chain(list(range(40)), 8)    # 5 blocks
    m = AffinityMap()
    m.record(chain[:2], "shallow")
    m.record(chain[:4], "deep")     # overwrites blocks 0-1 too
    rid, depth = m.longest(chain)
    assert (rid, depth) == ("deep", 4)
    # a diverging prompt still matches its shared head
    other = prompt_chain(list(range(16)) + [99] * 24, 8)
    rid, depth = m.longest(other)
    assert (rid, depth) == ("deep", 2)
    assert m.longest([]) == (None, 0)


def test_affinity_map_lru_capacity_and_forget():
    m = AffinityMap(capacity=4)
    chains = [prompt_chain([i] * 8, 8) for i in range(6)]
    for i, c in enumerate(chains):
        m.record(c, f"r{i % 2}")
    assert len(m) == 4              # two oldest evicted
    assert m.longest(chains[0]) == (None, 0)
    assert m.longest(chains[5])[0] == "r1"
    dropped = m.forget_replica("r1")
    assert dropped > 0
    assert m.longest(chains[5]) == (None, 0)
    stats = m.stats()
    assert "r1" not in stats["entries_per_replica"]


# ----------------------------------------------------------------- policy
def test_policy_prefers_learned_affinity_target():
    p = AffinityPolicy()
    chain = prompt_chain(list(range(32)), 8)
    views = [_view("a"), _view("b"), _view("c")]
    p.record(chain, "c")
    order, reason = p.candidates(chain, views)
    assert order[0] == "c" and reason == "affinity"
    assert sorted(order) == ["a", "b", "c"]


def test_policy_unseen_prefix_falls_back_to_rendezvous():
    p = AffinityPolicy()
    chain = prompt_chain(list(range(32)), 8)
    order, reason = p.candidates(chain, [_view("a"), _view("b")])
    assert reason == "rendezvous"
    assert order == rendezvous_order(chain[0], ["a", "b"])


def test_policy_spills_off_overloaded_target():
    p = AffinityPolicy(queue_hi=4)
    chain = prompt_chain(list(range(32)), 8)
    p.record(chain, "hot")
    views = [_view("hot", queue=9), _view("cool")]
    order, reason = p.candidates(chain, views)
    assert reason == "spill"
    assert order[0] == "cool"       # overloaded target demoted, not gone
    assert order[-1] == "hot"


def test_policy_starved_block_pool_counts_as_overload():
    p = AffinityPolicy(min_free_frac=0.05)
    chain = prompt_chain(list(range(32)), 8)
    p.record(chain, "starved")
    order, _ = p.candidates(chain, [_view("starved", free=0.01),
                                    _view("ok")])
    assert order[0] == "ok"


def test_policy_skips_not_ready_and_handles_empty():
    p = AffinityPolicy()
    chain = prompt_chain(list(range(32)), 8)
    p.record(chain, "dead")
    order, reason = p.candidates(
        chain, [_view("dead", ready=False), _view("live")])
    assert order == ["live"]
    assert p.candidates(chain, [_view("dead", ready=False)]) == ([], "none")
    # short prompt: no chain, rendezvous on the sentinel key still works
    order, reason = p.candidates([], [_view("a"), _view("b")])
    assert sorted(order) == ["a", "b"] and reason == "rendezvous"


# ------------------------------------------------ beside the JAX package
R = np.random.default_rng(61)


@pytest.mark.parametrize("blk", [4, 8, 16])
def test_prompt_chain_equals_the_references(blk):
    for n in (0, 3, blk, 5 * blk + 3, 97):
        prompt = R.integers(0, 4096, size=n).tolist()
        assert prompt_chain(prompt, blk) == jaff.prompt_chain(prompt, blk)


def test_rendezvous_order_equals_the_references():
    ids = [f"r{i}" for i in range(7)]
    for k in range(50):
        key = R.bytes(8)
        assert rendezvous_order(key, ids) == jaff.rendezvous_order(key, ids)


def test_policy_orders_candidates_as_the_reference():
    """The same learned routes and fleet states give the same candidate
    order and route reason, step by step."""
    mine, theirs = AffinityPolicy(queue_hi=3), jaff.AffinityPolicy(
        queue_hi=3)
    ids = ["a", "b", "c", "d"]
    for step in range(60):
        views = [_view(r, ready=bool(R.random() > 0.15),
                       queue=int(R.integers(0, 6)),
                       free=float(R.random())) for r in ids]
        prompt = R.integers(0, 64, size=int(R.integers(0, 40))).tolist()
        chain = prompt_chain(prompt, 8)
        got = mine.candidates(chain, views)
        assert got == theirs.candidates(chain, views)
        if got[0]:
            mine.record(chain, got[0][0])
            theirs.record(chain, got[0][0])
    assert mine.stats() == theirs.stats()
