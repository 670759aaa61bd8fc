"""Prefix-cache-affinity routing: N replicas as N× cache capacity.

Counterpart of ``deeplearning4j_tpu/serving/fleet/affinity.py``, the same
code: it hashes with the port's ``serving/generation/prefix.py``
``_block_hashes``, the function the port's prefix cache keys blocks by.

Each replica's prefix cache (serving/generation/prefix.py) is
per-process, so a load balancer that sprays requests uniformly turns N
replicas into N× cache MISSES — every replica re-prefills every popular
system prompt, and the pool pressure evicts N copies of everything. The
affinity policy routes on the prompt's block-aligned prefix chain
instead, computed with the SAME rolling chain hash the prefix cache
itself keys blocks by (imported, not re-implemented — the two can never
drift):

    h_0 = H(tokens[0:blk])   h_i = H(h_{i-1} || tokens[i*blk:(i+1)*blk])

Routing is learned longest-prefix matching over a bounded LRU map from
chain hash -> replica: a request walks its chain deepest-first and
follows the deepest hash the router has routed before — exactly the
replica whose cache already holds those blocks. Unseen prefixes fall
back to rendezvous (highest-random-weight) hashing on the chain head,
which (a) spreads DISTINCT system prompts across the fleet so the
aggregate cache capacity actually multiplies, and (b) is stable under
membership churn — adding or losing a replica remaps only the keys that
scored highest on it, not the whole keyspace.

Affinity is a preference, not a law: a target that is draining, dead, or
overloaded (deep queue, starved block pool — read from the ``/health``
steering payload) is skipped and the request spills to the next
candidate, which then LEARNS the prefix so the hot prompt's blocks
simply live on two replicas from then on.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

# the cache's own rolling chain hash — shared on purpose, see module doc
from ..generation.prefix import _block_hashes

DEFAULT_BLOCK_LEN = 16


def prompt_chain(prompt: Sequence[int], block_len: int) -> List[bytes]:
    """Rolling chain hashes for every FULL block of ``prompt`` (identical
    to the prefix cache's block keys for the same tokens)."""
    arr = np.asarray(list(prompt), dtype=np.int32)
    return _block_hashes(arr, int(block_len))


def rendezvous_order(key: bytes, replica_ids: Iterable[str]) -> List[str]:
    """Replica ids by descending highest-random-weight score for ``key``.
    Deterministic, stateless, minimally disruptive under membership
    change."""
    return sorted(
        replica_ids,
        key=lambda rid: hashlib.blake2b(
            key + b"\x00" + rid.encode(), digest_size=8).digest(),
        reverse=True)


class AffinityMap:
    """Bounded LRU of chain hash -> replica id (the learned half of the
    policy). Single-router-owned; guarded by the router's lock."""

    def __init__(self, capacity: int = 8192):
        self.capacity = int(capacity)
        self._map: "OrderedDict[bytes, str]" = OrderedDict()

    def __len__(self) -> int:
        return len(self._map)

    def longest(self, chain: Sequence[bytes]
                ) -> Tuple[Optional[str], int]:
        """Deepest recorded hash in ``chain``: (replica_id, depth in
        blocks), or (None, 0). Touches the match (LRU refresh)."""
        for depth in range(len(chain), 0, -1):
            rid = self._map.get(chain[depth - 1])
            if rid is not None:
                self._map.move_to_end(chain[depth - 1])
                return rid, depth
        return None, 0

    def record(self, chain: Sequence[bytes], replica_id: str) -> None:
        for h in chain:
            self._map[h] = replica_id
            self._map.move_to_end(h)
        while len(self._map) > self.capacity:
            self._map.popitem(last=False)

    def forget_replica(self, replica_id: str) -> int:
        """Drop every entry pointing at a dead/removed replica (its cache
        died with it); returns entries dropped."""
        stale = [h for h, rid in self._map.items() if rid == replica_id]
        for h in stale:
            del self._map[h]
        return len(stale)

    def stats(self) -> dict:
        owners: Dict[str, int] = {}
        for rid in self._map.values():
            owners[rid] = owners.get(rid, 0) + 1
        return {"entries": len(self._map), "capacity": self.capacity,
                "entries_per_replica": owners}


class AffinityPolicy:
    """Candidate ordering for one admission.

    ``views`` are lightweight router records exposing ``.id``, ``.ready``
    (health-gated: starting/draining/dead replicas are never candidates)
    and ``.steering`` (the replica's last ``/health`` steering payload).
    Overload (queue deeper than ``queue_hi`` or block-pool free fraction
    under ``min_free_frac``) demotes a replica behind every non-overloaded
    one without removing it — under total fleet pressure requests still
    land somewhere and the replica's own 429 backpressure takes over."""

    def __init__(self, *, map_capacity: int = 8192, queue_hi: int = 8,
                 min_free_frac: float = 0.05):
        self.map = AffinityMap(map_capacity)
        self.queue_hi = int(queue_hi)
        self.min_free_frac = float(min_free_frac)

    def overloaded(self, view) -> bool:
        s = view.steering or {}
        if s.get("queue_depth", 0) > self.queue_hi:
            return True
        return s.get("block_pool_free_frac", 1.0) < self.min_free_frac

    def candidates(self, chain: Sequence[bytes], views: Sequence
                   ) -> Tuple[List[str], str]:
        """Ordered candidate replica ids + the route reason
        (``affinity`` / ``rendezvous`` / ``spill`` / ``none``)."""
        ready = [v for v in views if v.ready]
        if not ready:
            return [], "none"
        key = chain[0] if chain else b"short-prompt"
        order = rendezvous_order(key, [v.id for v in ready])
        by_id = {v.id: v for v in ready}
        # stable partition: non-overloaded first, overloaded as last resort
        order = ([r for r in order if not self.overloaded(by_id[r])]
                 + [r for r in order if self.overloaded(by_id[r])])
        target, _depth = self.map.longest(chain)
        reason = "rendezvous"
        if target is not None and target in by_id:
            if not self.overloaded(by_id[target]):
                order.remove(target)
                order.insert(0, target)
                reason = "affinity"
            else:
                reason = "spill"
        return order, reason

    def record(self, chain: Sequence[bytes], replica_id: str) -> None:
        self.map.record(chain, replica_id)

    def forget_replica(self, replica_id: str) -> int:
        return self.map.forget_replica(replica_id)

    def stats(self) -> dict:
        return {"queue_hi": self.queue_hi,
                "min_free_frac": self.min_free_frac, **self.map.stats()}
