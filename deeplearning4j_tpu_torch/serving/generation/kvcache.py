"""Paged KV cache: a fixed pool of blocks plus per-sequence block tables.

Counterpart of ``deeplearning4j_tpu/serving/generation/kvcache.py``
(``BlockAllocator`` ``:34``, ``make_pools`` ``:148`` for full precision,
``prefill_scatter`` ``:181``, ``PagedStore`` ``:271``). The cache is one
pair of pool tensors per model —

    k_pool / v_pool : [n_layers, num_blocks, block_len, n_heads, head_dim]

— and a sequence's cache is the set of blocks its host-side table points
at. Block 0 is the reserved TRASH block: idle decode slots and the unused
tail of a prefill's table point at it, so every scatter has a legal
destination and garbage lands where nothing reads it.

Unlike the reference's functional updates, the pools here are updated IN
PLACE (``index_put_``): ``prefill_scatter`` and ``PagedStore.put_get``
write into the tensors they are given, so the cache costs one pool and no
copies per step.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from ..errors import BlockPoolExhaustedError


class BlockAllocator:
    """Free list over the pool's usable blocks (ids 1..n-1; block 0 is the
    trash block). Not thread-safe by itself: the scheduler owns it from its
    single dispatch thread. Freeing a block that was never allocated, or
    twice, raises — a leak or double free would corrupt every sequence
    sharing the pool."""

    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ValueError("need >= 2 blocks (block 0 is reserved trash)")
        self.num_blocks = int(num_blocks)
        self._free: List[int] = list(range(self.num_blocks - 1, 0, -1))
        self._allocated: set = set()

    @property
    def total_usable(self) -> int:
        return self.num_blocks - 1

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> List[int]:
        if n > len(self._free):
            raise BlockPoolExhaustedError(
                f"block pool exhausted: need {n} blocks, "
                f"{len(self._free)}/{self.total_usable} free — retry after "
                f"in-flight generations release their blocks")
        got = [self._free.pop() for _ in range(n)]
        self._allocated.update(got)
        return got

    def free(self, ids: Sequence[int]) -> None:
        for b in ids:
            if not 1 <= b < self.num_blocks:
                raise ValueError(f"free of invalid block id {b}")
            if b not in self._allocated:
                raise ValueError(
                    f"free of unallocated block {b} (double free, or an id "
                    f"this allocator never handed out)")
            self._allocated.discard(b)
            self._free.append(int(b))


def make_pools(n_layers: int, num_blocks: int, block_len: int,
               n_heads: int, head_dim: int, dtype: torch.dtype,
               device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Zero-filled (k_pool, v_pool)."""
    shape = (n_layers, num_blocks, block_len, n_heads, head_dim)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def prefill_scatter(pool, layer_kv, tables) -> None:
    """Write a prefill's K or V for every layer into ``pool`` in place.

    pool      [n_layers, nb, blk, H, Dh]
    layer_kv  list of [P, L, H, Dh] per layer (L % blk == 0)
    tables    [P, max_blocks] int — the first L//blk entries are the
              sequence's blocks (the rest point at trash block 0).
    """
    P, L, H, Dh = layer_kv[0].shape
    blk = pool.shape[2]
    nblk = L // blk
    idx = tables[:, :nblk].long()
    for i, kv in enumerate(layer_kv):
        pool[i].index_put_((idx,), kv.reshape(P, nblk, blk, H, Dh))


class PagedStore:
    """The decode step's K/V store over the paged pools, for ONE step.

    Scatter, then gather: the current token's K/V lands in its block slot
    first, then the gathered context (position-ordered, so attention row
    ``pos`` sees what the naive causal row sees) includes it. Idle slots
    scatter to the trash block."""

    def __init__(self, k_pool, v_pool, tables, pos, active, block_len: int):
        self.k_pool = k_pool
        self.v_pool = v_pool
        self.tables = tables.long()       # [S, max_blocks]
        self.block_len = int(block_len)
        S, mb = tables.shape
        self._ctx_len = mb * self.block_len
        pos = pos.long()
        bid = torch.gather(self.tables, 1,
                           (pos // self.block_len)[:, None])[:, 0]
        zero = torch.zeros_like(bid)
        self._bid = torch.where(active, bid, zero)
        self._off = torch.where(active, pos % self.block_len, zero)
        self._mask = (torch.arange(self._ctx_len, device=pos.device)[None, :]
                      <= pos[:, None])

    def _gather(self, pool, i, S, H, Dh):
        ctx = pool[i][self.tables].reshape(S, self._ctx_len, H, Dh)
        return ctx.transpose(1, 2)

    def put_get(self, i: int, k_tok, v_tok):
        S = k_tok.shape[0]
        H, Dh = k_tok.shape[-2:]
        self.k_pool[i].index_put_((self._bid, self._off), k_tok)
        self.v_pool[i].index_put_((self._bid, self._off), v_tok)
        return (self._gather(self.k_pool, i, S, H, Dh),
                self._gather(self.v_pool, i, S, H, Dh), self._mask)
