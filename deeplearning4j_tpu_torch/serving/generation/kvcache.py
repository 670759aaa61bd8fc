"""Paged KV cache: a fixed pool of blocks plus per-sequence block tables.

Counterpart of ``deeplearning4j_tpu/serving/generation/kvcache.py``
(``BlockAllocator`` ``:34-116`` with its refcounts, ``QuantizedPool``,
``kv_quantize`` and ``kv_dequantize`` ``:118-146``, ``make_pools``
``:148``, ``pool_bytes`` and ``cow_copy`` ``:162-179``,
``prefill_scatter`` ``:181``, the quantize and dequantize seams
``_pool_write`` / ``_pool_gather`` ``:210-231``, ``QuantSimStore``
``:233``, ``PagedStore`` ``:271`` and ``PagedWindowStore`` ``:310``). The
cache is one pair of pool tensors per model —

    k_pool / v_pool : [n_layers, num_blocks, block_len, n_heads, head_dim]

— or, on the int8 tier, one ``QuantizedPool`` (int8 codes of that shape
plus one f32 scale per token and head) each. A sequence's cache is the set
of blocks its host-side table points at. Block 0 is the reserved TRASH
block: idle decode slots and the unused tail of a prefill's table point at
it, so every scatter has a legal destination and garbage lands where
nothing reads it.

Unlike the reference's functional updates, the pools here are updated IN
PLACE (``index_put_``): ``prefill_scatter``, ``cow_copy`` and the stores'
``put_get`` write into the tensors they are given, so the cache costs one
pool and no copies per step, and a CUDA graph captured over a cohort's
pools (``graphs.py``) sees every write made outside it.
"""
from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import torch

from ..errors import BlockPoolExhaustedError


class BlockAllocator:
    """Free list over the pool's usable blocks (ids 1..n-1; block 0 is the
    trash block). Not thread-safe by itself: the scheduler owns it from its
    single dispatch thread.

    An explicit allocated set plus per-block refcounts (the prefix cache's
    sharing currency). Freeing a block that was never allocated, freeing
    it twice, or freeing one whose refcount is still nonzero raises — a
    leak or double free would corrupt every sequence sharing the pool."""

    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ValueError("need >= 2 blocks (block 0 is reserved trash)")
        self.num_blocks = int(num_blocks)
        self._free: List[int] = list(range(self.num_blocks - 1, 0, -1))
        self._allocated: set = set()
        self._refcount: dict = {}

    @property
    def total_usable(self) -> int:
        return self.num_blocks - 1

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        return self.total_usable - len(self._free)

    @property
    def allocated(self) -> frozenset:
        return frozenset(self._allocated)

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
            if self._refcount.get(b, 0):
                raise ValueError(
                    f"free of block {b} with refcount "
                    f"{self._refcount[b]} — shared blocks must be "
                    f"released through the prefix cache, not freed")
            self._allocated.discard(b)
            self._free.append(int(b))

    # ------------------------------------------------------------ refcounts
    def incref(self, b: int) -> int:
        if b not in self._allocated:
            raise ValueError(f"incref of unallocated block {b}")
        self._refcount[b] = self._refcount.get(b, 0) + 1
        return self._refcount[b]

    def decref(self, b: int) -> int:
        n = self._refcount.get(b, 0)
        if n < 1:
            raise ValueError(f"decref of block {b} below zero")
        n -= 1
        if n:
            self._refcount[b] = n
        else:
            del self._refcount[b]
        return n

    def refcount(self, b: int) -> int:
        return self._refcount.get(b, 0)


class QuantizedPool(NamedTuple):
    """int8 block pool: the same [n_layers, num_blocks, block_len, n_heads,
    *] geometry, each (token, head) vector stored as int8 codes plus ONE
    f32 scale — 2*(Dh+4) bytes per token, layer and head for K and V
    instead of f32's 8*Dh."""
    q: torch.Tensor         # int8 [n_layers, nb, blk, H, Dh]
    scale: torch.Tensor     # f32  [n_layers, nb, blk, H]


def kv_quantize(x) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., Dh] -> (int8 codes [..., Dh], f32 scales [...]), symmetric
    per-(token, head) scales. Prefill, decode, replay and verify all
    quantize through this one expression, in the reference's order (the
    scale in x's dtype, then f32; an f32 divide, round half to even, clip,
    int8), so the codes are the reference's bits."""
    amax = torch.amax(torch.abs(x), dim=-1)
    scale = torch.where(amax > 0, amax / 127.0,
                        torch.ones_like(amax)).to(torch.float32)
    q = torch.clamp(torch.round(x.to(torch.float32) / scale[..., None]),
                    -127, 127).to(torch.int8)
    return q, scale


def kv_dequantize(q, scale, dtype):
    return (q.to(torch.float32) * scale[..., None]).to(dtype)


def make_pools(n_layers: int, num_blocks: int, block_len: int,
               n_heads: int, head_dim: int, dtype: torch.dtype,
               device: torch.device, quantized: bool = False) -> Tuple:
    """Zero-filled (k_pool, v_pool): plain tensors, or ``QuantizedPool``
    pairs when ``quantized`` (the kv_cache_dtype="int8" tier)."""
    shape = (n_layers, num_blocks, block_len, n_heads, head_dim)
    if quantized:
        def qp():
            return QuantizedPool(
                torch.zeros(shape, dtype=torch.int8, device=device),
                torch.zeros(shape[:-1], dtype=torch.float32, device=device))
        return qp(), qp()
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def _leaves(pool) -> Tuple[torch.Tensor, ...]:
    return tuple(pool) if isinstance(pool, QuantizedPool) else (pool,)


def pool_bytes(pool) -> int:
    """Device bytes of one pool entry (plain tensor or QuantizedPool)."""
    return sum(t.numel() * t.element_size() for t in _leaves(pool))


def cow_copy(k_pool, v_pool, src: int, dst: int) -> None:
    """Copy block ``src``'s content (every layer, K and V; codes and scales
    on the int8 tier) to block ``dst`` in place — the copy-on-write
    primitive for prefix sharing."""
    for pool in (k_pool, v_pool):
        for t in _leaves(pool):
            t[:, dst] = t[:, src]


def _scatter(pool, i: int, idx: Tuple, tok) -> None:
    """Write one layer's K or V ``tok`` [..., H, Dh] at the index tuple
    ``idx`` of ``pool[i]`` — the quantize-on-write seam."""
    if isinstance(pool, QuantizedPool):
        q, s = kv_quantize(tok)
        pool.q[i].index_put_(idx, q)
        pool.scale[i].index_put_(idx, s)
    else:
        pool[i].index_put_(idx, tok)


def prefill_scatter(pool, layer_kv, tables) -> None:
    """Write a prefill's K or V for every layer into ``pool`` in place
    (a quantized pool quantizes on write).

    pool      [n_layers, nb, blk, H, Dh] or a ``QuantizedPool``
    layer_kv  list of [P, L, H, Dh] per layer (L % blk == 0)
    tables    [P, max_blocks] int — the first L//blk entries are the
              sequence's blocks (the rest point at trash block 0).
    """
    P, L, H, Dh = layer_kv[0].shape
    blk = _leaves(pool)[0].shape[2]
    nblk = L // blk
    idx = (tables[:, :nblk].long(),)
    for i, kv in enumerate(layer_kv):
        _scatter(pool, i, idx, kv.reshape(P, nblk, blk, H, Dh))


def _pool_gather(pool, i: int, tables, S: int, ctx_len: int, H: int,
                 Dh: int, dtype):
    """Gather one layer's full context -> [S, H, ctx, Dh] — the
    dequantize-in-attention seam."""
    if isinstance(pool, QuantizedPool):
        ctx = kv_dequantize(
            pool.q[i][tables].reshape(S, ctx_len, H, Dh),
            pool.scale[i][tables].reshape(S, ctx_len, H), dtype)
    else:
        ctx = pool[i][tables].reshape(S, ctx_len, H, Dh)
    return ctx.transpose(1, 2)


class QuantSimStore:
    """Full-prompt window store for the int8 tier's PREFILL: records each
    layer's raw K/V (for the quantize-on-write scatter afterwards) and
    serves attention the fake-quantized context, dequantize(quantize(k)),
    with the causal row mask. Row ``i`` then sees exactly what a decode
    step at position ``i`` reads back from the quantized pool, so a prefix
    hit (which replays its suffix through the decode step) and a miss
    give the same tokens."""

    def __init__(self, n_layers: int):
        self.ks: List = [None] * n_layers
        self.vs: List = [None] * n_layers

    def put_get(self, i: int, k_win, v_win):
        """k_win/v_win: [B, W, H, Dh]. Returns (K [B,H,W,Dh], V [B,H,W,Dh],
        causal row_mask [B,W,W])."""
        self.ks[i] = k_win
        self.vs[i] = v_win
        B, W = k_win.shape[:2]

        def fakeq(x):
            q, s = kv_quantize(x)
            return kv_dequantize(q, s, x.dtype).transpose(1, 2)

        ar = torch.arange(W, device=k_win.device)
        mask = (ar[None, None, :] <= ar[None, :, None]).expand(B, W, W)
        return fakeq(k_win), fakeq(v_win), mask


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

    def put_get(self, i: int, k_tok, v_tok):
        S = k_tok.shape[0]
        H, Dh = k_tok.shape[-2:]
        idx = (self._bid, self._off)
        _scatter(self.k_pool, i, idx, k_tok)
        _scatter(self.v_pool, i, idx, v_tok)
        return (_pool_gather(self.k_pool, i, self.tables, S, self._ctx_len,
                             H, Dh, k_tok.dtype),
                _pool_gather(self.v_pool, i, self.tables, S, self._ctx_len,
                             H, Dh, v_tok.dtype), self._mask)


class PagedWindowStore:
    """Window store over the paged pools for ONE speculative-verify pass:
    the W = k+1 fed tokens of a slot land at positions ``pos .. pos+W-1``
    (crossing block boundaries through per-position block and offset),
    then the gathered context plus per-row key masks give row ``i`` the
    visibility the one-token ``PagedStore`` gives position ``pos+i``."""

    def __init__(self, k_pool, v_pool, tables, pos, active, block_len: int,
                 window: int):
        self.k_pool = k_pool
        self.v_pool = v_pool
        self.tables = tables.long()       # [S, max_blocks]
        self.block_len = int(block_len)
        S, mb = tables.shape
        self._ctx_len = mb * self.block_len
        dev = tables.device
        w_pos = (pos.long()[:, None]
                 + torch.arange(window, device=dev)[None, :])    # [S, W]
        bidx = torch.clamp(w_pos // self.block_len, 0, mb - 1)
        bid = torch.gather(self.tables, 1, bidx)                 # [S, W]
        # idle slots AND window positions past capacity (a verify window is
        # always W wide even when fewer tokens of budget remain) go to
        # trash — a clipped in-range write would corrupt the last real block
        ok = active[:, None] & (w_pos < mb * self.block_len)
        zero = torch.zeros_like(bid)
        self._bid = torch.where(ok, bid, zero)
        self._off = torch.where(ok, w_pos % self.block_len, zero)
        # row i of a slot's mask: keys at positions <= pos+i are visible
        self._mask = (torch.arange(self._ctx_len, device=dev)[None, None, :]
                      <= w_pos[:, :, None])                      # [S, W, ctx]

    def put_get(self, i: int, k_win, v_win):
        """k_win/v_win: [S, W, H, Dh]. Returns (K [S,H,ctx,Dh],
        V [S,H,ctx,Dh], row_mask [S,W,ctx])."""
        S = k_win.shape[0]
        H, Dh = k_win.shape[-2:]
        idx = (self._bid, self._off)
        _scatter(self.k_pool, i, idx, k_win)
        _scatter(self.v_pool, i, idx, v_win)
        return (_pool_gather(self.k_pool, i, self.tables, S, self._ctx_len,
                             H, Dh, k_win.dtype),
                _pool_gather(self.v_pool, i, self.tables, S, self._ctx_len,
                             H, Dh, v_win.dtype), self._mask)
