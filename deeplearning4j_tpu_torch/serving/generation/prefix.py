"""Copy-on-write prefix-cache sharing over the paged KV block pool.

Counterpart of ``deeplearning4j_tpu/serving/generation/prefix.py``
(``_block_hashes`` ``:50``, ``PrefixCache`` ``:71-238``). The module is
numpy and ``hashlib`` only, so it is the reference's code over the port's
``BlockAllocator``; the chain hashes are the reference's bytes.

Thousands of requests that open with the same system prompt should pay
prefill ONCE. The unit of sharing is the immutable FULL block: a prompt's
first ``floor(plen/block_len)`` blocks hold K/V that never changes after
prefill, so they are keyed by a rolling prefix hash —

    h_0 = H(tokens[0:blk])      h_i = H(h_{i-1} || tokens[i*blk:(i+1)*blk])

— which makes a chain lookup equivalent to longest-prefix matching without
ever comparing tokens twice. Admission walks the chain, bumps the matched
blocks' refcounts (the ``BlockAllocator`` owns refcounts; freeing a
refcounted block raises), points the new sequence's block table at the
shared read-only blocks, and the scheduler replays only the UNMATCHED
prompt suffix through the already-warmed decode program — TTFT for a fully
cached prefix is one decode step instead of a prefill.

Copy-on-write: when the match covers the whole prompt (block-aligned), the
final prompt token must still be fed through decode to produce the
next-token logits, and that feed WRITES K/V at ``plen-1`` — a position
inside the last shared block. The cache never lets a sequence write a
shared block: admission copies that block into a fresh one (the warmed
``cow`` program), repoints the table entry, and drops the reference on the
original. Divergent continuations after a shared prefix never COW — their
first write lands at ``matched_tokens``, which is always the first
UNSHARED table entry by construction.

Lifecycle: a block's refcount counts live sequences referencing it (the
registering owner included). At refcount 0 a cached block is NOT freed —
it parks in an LRU so the next identical prompt still hits; eviction runs
only under pool pressure (oldest first, refcount-0 only, descendants
evicted with their parent — a child can never out-ref its parent because
every sequence that matched the child matched the whole chain), and only
then does ``BlockPoolExhaustedError`` fire. Cohort-scoped: a prefix cache
lives and dies with its cohort's pool, so hot-swap can never serve K/V
computed under old params to a new-params sequence.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from .kvcache import BlockAllocator


def _block_hashes(prompt: np.ndarray, block_len: int) -> List[bytes]:
    """Rolling chain hashes for every FULL block of ``prompt``."""
    n_full = len(prompt) // block_len
    out: List[bytes] = []
    h = b""
    for i in range(n_full):
        blk = np.ascontiguousarray(
            prompt[i * block_len:(i + 1) * block_len], dtype=np.int32)
        h = hashlib.blake2b(h + blk.tobytes(), digest_size=16).digest()
        out.append(h)
    return out


class _Entry:
    __slots__ = ("block", "parent", "children")

    def __init__(self, block: int, parent: Optional[bytes]):
        self.block = block
        self.parent = parent
        self.children: Set[bytes] = set()


class PrefixCache:
    """Hash-chain index + refcounts + LRU over ONE cohort's block pool.

    Single-threaded by contract (the scheduler's dispatch thread owns it,
    exactly like the allocator)."""

    def __init__(self, allocator: BlockAllocator, block_len: int):
        self.allocator = allocator
        self.block_len = int(block_len)
        self._entries: Dict[bytes, _Entry] = {}
        self._by_block: Dict[int, bytes] = {}
        # refcount-0 cached blocks, oldest-first (move_to_end on touch)
        self._lru: "OrderedDict[bytes, None]" = OrderedDict()
        # stats (mirrored into GenerationMetrics by the scheduler)
        self.hits = 0
        self.misses = 0
        self.tokens_matched = 0
        self.cow_copies = 0
        self.evictions = 0

    # ------------------------------------------------------------- queries
    @property
    def cached_blocks(self) -> int:
        return len(self._entries)

    @property
    def lru_blocks(self) -> int:
        return len(self._lru)

    @property
    def shared_blocks(self) -> int:
        """Cached blocks currently referenced by at least one live
        sequence."""
        return len(self._entries) - len(self._lru)

    def cached_block_ids(self) -> Set[int]:
        return set(self._by_block)

    def probe(self, prompt: np.ndarray) -> int:
        """Longest cached prefix in BLOCKS, without taking references."""
        n = 0
        for h in _block_hashes(prompt, self.block_len):
            if h not in self._entries:
                break
            n += 1
        return n

    def evictable_for(self, prompt: np.ndarray) -> int:
        """LRU blocks evictable to serve THIS prompt's admission: blocks
        the prompt would match don't count — reviving them is the point."""
        matched = 0
        for h in _block_hashes(prompt, self.block_len):
            e = self._entries.get(h)
            if e is None:
                break
            if h in self._lru:
                matched += 1
        return len(self._lru) - matched

    # ----------------------------------------------------------- admission
    def match(self, prompt: np.ndarray) -> Tuple[List[int], int]:
        """Take references on the longest cached prefix. Returns
        (shared_block_ids, matched_token_count); refcount-0 matches are
        revived out of the LRU. Records the hit/miss stat."""
        shared: List[int] = []
        for h in _block_hashes(prompt, self.block_len):
            e = self._entries.get(h)
            if e is None:
                break
            self._lru.pop(h, None)
            self.allocator.incref(e.block)
            shared.append(e.block)
        if shared:
            self.hits += 1
            self.tokens_matched += len(shared) * self.block_len
        else:
            self.misses += 1
        return shared, len(shared) * self.block_len

    def release(self, block_ids: List[int]) -> None:
        """Drop one reference per block; blocks reaching refcount 0 park in
        the LRU (still allocated — only eviction frees them)."""
        for b in block_ids:
            if self.allocator.decref(b) == 0:
                h = self._by_block.get(b)
                if h is not None:
                    self._lru[h] = None
                    self._lru.move_to_end(h)
                else:       # unregistered share (COW'd original, raced reg)
                    self.allocator.free([b])

    def register(self, prompt: np.ndarray, table_row: np.ndarray,
                 owned: List[int]) -> List[int]:
        """After a prefill (or replay) completes, index the prompt's full
        blocks. Blocks newly registered move from the caller's ``owned``
        set to cache custody (refcount 1 for the live owner); blocks whose
        hash is already cached stay owned by the caller (same-batch
        duplicate prompts). Returns the block ids now cache-managed that
        the caller must release() instead of free()."""
        owned_set = set(owned)
        managed: List[int] = []
        parent: Optional[bytes] = None
        for i, h in enumerate(_block_hashes(prompt, self.block_len)):
            blk = int(table_row[i])
            e = self._entries.get(h)
            if e is not None:
                parent = h
                continue
            if blk not in owned_set:
                # this table entry is a shared block from admission (its
                # hash is cached under possibly-evicted ancestry) — never
                # steal custody of a block the caller doesn't own
                parent = h
                continue
            e = _Entry(blk, parent)
            self._entries[h] = e
            self._by_block[blk] = h
            if parent is not None and parent in self._entries:
                self._entries[parent].children.add(h)
            self.allocator.incref(blk)
            owned_set.discard(blk)
            managed.append(blk)
            parent = h
        return managed

    # ------------------------------------------------------------ eviction
    def ensure_free(self, n: int) -> int:
        """Evict oldest refcount-0 cached blocks until the allocator has
        ``n`` free blocks (descendant chains go with their parent). Returns
        blocks evicted; the caller decides whether a shortfall is
        BlockPoolExhaustedError."""
        evicted = 0
        while self.allocator.free_blocks < n and self._lru:
            h = next(iter(self._lru))
            evicted += self._evict_chain(h)
        return evicted

    def _evict_chain(self, h: bytes) -> int:
        e = self._entries.get(h)
        if e is None:
            return 0
        n = 0
        # children first (all refcount-0 by the chain-refcount invariant)
        for child in list(e.children):
            n += self._evict_chain(child)
        del self._entries[h]
        del self._by_block[e.block]
        self._lru.pop(h, None)
        if e.parent is not None and e.parent in self._entries:
            self._entries[e.parent].children.discard(h)
        self.allocator.free([e.block])
        self.evictions += 1
        n += 1
        return n

    def stats(self) -> dict:
        total = self.hits + self.misses
        return {
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": round(self.hits / total, 4) if total else 0.0,
            "tokens_matched": self.tokens_matched,
            "cow_copies": self.cow_copies,
            "evictions": self.evictions,
            "cached_blocks": self.cached_blocks,
            "cached_lru_blocks": self.lru_blocks,
            "shared_blocks": self.shared_blocks,
        }
