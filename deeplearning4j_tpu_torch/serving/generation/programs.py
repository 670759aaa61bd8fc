"""Generation programs: bucketed prefill, the one-token decode step, the
copy-on-write block copy and the speculative draft and verify passes.

Counterpart of ``deeplearning4j_tpu/serving/generation/programs.py``
(``GenerationConfig`` ``:50-130``, ``GenerationProgramSet`` ``:137``:
``make_cache``, ``kv_bytes_per_token``, ``make_draft_cache`` and
``kv_pool_bytes_per_chip`` ``:285-349``, the branches of ``_prefill_fn``
and ``_decode_fn`` ``:352-417`` with the int8 prefill through
``QuantSimStore`` ``:362-376``, ``warm`` ``:472``, ``warmed`` ``:650``,
the ``run_*`` entries ``:665-739`` and ``with_params_from`` ``:742``). A
model is served through one of two adapters:

- ``"paged"`` (a ``transformer_lm`` graph): K/V in block pools addressed by
  per-sequence block tables, full precision or int8 (``kv_cache_dtype``);
  the prefix cache shares their blocks and a draft model (a truncated
  transformer or an LSTM) can speculate for it;
- ``"state"`` (a recurrent MultiLayerNetwork, ``LSTMDecodeSpec``): the
  cache is each recurrent layer's (h, c) for ``decode_slots + 1`` rows, the
  last row the trash slot that prefill padding rows write into.

The reference lowers one executable per program at ``warm()``. Here
``warm()`` runs each program once (every (admission batch, prompt rung)
prefill, the decode step, the block copy, and the draft prefill, propose,
rewind and verify when speculating), which builds the kernels and caches
their plans before traffic; a program whose shape was not warmed raises,
as the reference's missing executable does. On the card, the decode step
of each cohort then runs as a CUDA graph (``graphs.py``), captured from
``decode_tensors``; the other programs run eagerly (ROADMAP A2a-rest). The
caches are updated in place.

``mesh=`` (head-sharded decode across cards) is ROADMAP A7b.
"""
from __future__ import annotations

import math
from collections import Counter
from dataclasses import dataclass
from typing import Callable, Optional, Set, Tuple

import numpy as np
import torch

from ...models.decode import LSTMDecodeSpec, TransformerDecodeSpec
from ..errors import ServingError
from .kvcache import (PagedStore, QuantSimStore, cow_copy, make_pools,
                      pool_bytes, prefill_scatter)
from .sampling import sample_tokens


def _ceil_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass
class GenerationConfig:
    """Shape and capacity plan for one generation model."""
    block_len: int = 16
    max_seq_len: int = 128            # prompt + generated tokens, per request
    decode_slots: int = 8             # in-flight sequences per decode step
    prefill_batches: Tuple[int, ...] = (1, 2, 4)
    prompt_rungs: Optional[Tuple[int, ...]] = None   # default: (capacity,)
    num_blocks: Optional[int] = None  # pool size; default: full occupancy + 1
    queue_limit: int = 256
    default_timeout_s: float = 30.0
    default_max_tokens: int = 32
    seed: int = 0
    # prefix-cache sharing: None = on for the paged adapter, off for the
    # state adapter (no blocks to share); True/False overrides
    prefix_cache: Optional[bool] = None
    # longest unmatched prompt suffix (tokens) a cache hit may REPLAY
    # through the one-token decode step; a shorter match admits as a miss.
    # None = 2 * block_len.
    prefix_max_replay: Optional[int] = None
    # speculative decoding: draft proposals per verify window; 0 with a
    # draft model attached means 4
    spec_k: int = 0
    # "int8" stores the paged pools as int8 codes + per-(token, head) f32
    # scales (quantize on write, dequantize in attention). None = the
    # model's dtype.
    kv_cache_dtype: Optional[str] = None

    def __post_init__(self):
        if self.block_len < 1 or self.decode_slots < 1:
            raise ValueError("block_len and decode_slots must be >= 1")
        if self.kv_cache_dtype not in (None, "int8"):
            raise ValueError(f"kv_cache_dtype must be None or 'int8', got "
                             f"{self.kv_cache_dtype!r}")
        if self.spec_k < 0:
            raise ValueError("spec_k must be >= 0")
        self.capacity = _ceil_to(self.max_seq_len, self.block_len)
        self.blocks_per_seq = self.capacity // self.block_len
        self.prefill_batches = tuple(sorted(set(
            int(b) for b in self.prefill_batches)))
        if not self.prefill_batches or self.prefill_batches[0] < 1:
            raise ValueError("prefill_batches must be positive")
        rungs = self.prompt_rungs or (self.capacity,)
        rungs = tuple(sorted({min(_ceil_to(int(r), self.block_len),
                                  self.capacity) for r in rungs}))
        if rungs[-1] != self.capacity:
            rungs = rungs + (self.capacity,)
        self.prompt_rungs = rungs
        if self.num_blocks is None:
            self.num_blocks = self.decode_slots * self.blocks_per_seq + 1
        if self.num_blocks < 2:
            raise ValueError("num_blocks must be >= 2 (block 0 is trash)")
        if self.prefix_max_replay is None:
            self.prefix_max_replay = 2 * self.block_len
        elif self.prefix_max_replay < 1:
            raise ValueError("prefix_max_replay must be >= 1 (the final "
                             "prompt token always replays)")

    @property
    def max_prompt_len(self) -> int:
        return self.prompt_rungs[-1]

    def blocks_needed(self, prompt_len: int, max_new: int) -> int:
        return math.ceil((prompt_len + max_new) / self.block_len)

    def prefill_rung(self, n: int) -> int:
        for b in self.prefill_batches:
            if n <= b:
                return b
        return self.prefill_batches[-1]

    def prompt_rung(self, plen: int) -> int:
        for r in self.prompt_rungs:
            if plen <= r:
                return r
        raise ValueError(f"prompt length {plen} exceeds the largest prompt "
                         f"rung {self.prompt_rungs[-1]}")


class GenerationProgramSet:
    """One model version's generation programs, its cache layouts and what
    it has warmed. Inputs arrive as numpy arrays from the scheduler;
    sampled tokens go back as numpy (which waits for the device). The
    engine swaps whole sets, and the scheduler pins each in-flight cohort
    to the set it was admitted under (the hot-swap cutover rule)."""

    def __init__(self, net, *, config: GenerationConfig,
                 adapter: str = "auto", draft_net=None,
                 trace_hook: Optional[Callable[[], None]] = None,
                 mesh=None):
        if mesh is not None:
            raise NotImplementedError("head-sharded decode over a mesh is "
                                      "not ported yet (ROADMAP A7b)")
        self.net = net
        self.config = config
        self._trace_hook = trace_hook
        self.mesh = None
        self.model_shards = 1
        self.adapter = self._resolve_adapter(net, adapter)
        self.spec = (TransformerDecodeSpec(net) if self.adapter == "paged"
                     else LSTMDecodeSpec(net))
        self.device = net.device
        self.dtype = self.spec.dtype
        self.vocab = self.spec.vocab
        # prefix-cache sharing only exists where there are blocks to share
        self.prefix_enabled = (self.adapter == "paged"
                               if config.prefix_cache is None
                               else bool(config.prefix_cache)
                               and self.adapter == "paged")
        self.kv_quantized = config.kv_cache_dtype == "int8"
        if self.kv_quantized and self.adapter != "paged":
            raise ValueError("kv_cache_dtype='int8' requires the paged "
                             "(transformer) adapter — the state adapter "
                             "has no KV block pool to quantize")
        # speculative decoding: active iff a draft model is attached
        self.draft_net = draft_net
        self.spec_k = 0
        self.draft_adapter: Optional[str] = None
        self.draft_spec = None
        if draft_net is not None:
            if self.adapter != "paged":
                raise ValueError(
                    "speculative decoding requires a paged (transformer) "
                    "TARGET — the verify window runs over the block tables")
            if draft_net.device != self.device:
                raise ValueError(f"the draft lives on {draft_net.device}, "
                                 f"the target on {self.device}")
            self.spec_k = int(config.spec_k) or 4
            da = self._resolve_adapter(draft_net, "auto")
            self.draft_adapter = "dense" if da == "paged" else "state"
            self.draft_spec = (TransformerDecodeSpec(draft_net)
                               if da == "paged" else LSTMDecodeSpec(draft_net))
            if self.draft_spec.vocab != self.vocab:
                raise ValueError(
                    f"draft vocab {self.draft_spec.vocab} != target vocab "
                    f"{self.vocab} — proposals must share the token space")
        # imported here: serving.programs -> serving.metrics imports this
        # package's metrics, so a module-level import would be circular
        from ..programs import _arch_key, _param_signature
        draft_sig = None if draft_net is None else (
            _param_signature(draft_net), _arch_key(draft_net),
            self.draft_adapter, self.spec_k)
        self.signature = (_param_signature(net), _arch_key(net),
                          self.adapter, config.block_len, config.capacity,
                          config.decode_slots, config.prefill_batches,
                          config.prompt_rungs, config.num_blocks,
                          self.prefix_enabled, config.kv_cache_dtype,
                          draft_sig)
        self._warmed: Set[Tuple] = set()
        self.kv_pool_chip_bytes: Optional[int] = None     # set by warm()
        # eager program runs since warm-up, by program ("prefill",
        # "decode", "cow", "draft_prefill", "propose", "rewind", "verify"):
        # what a path's kernel launches are checked against
        self.runs: Counter = Counter()

    @staticmethod
    def _resolve_adapter(net, adapter: str) -> str:
        if adapter in ("paged", "transformer"):
            return "paged"
        if adapter in ("state", "lstm"):
            return "state"
        if adapter != "auto":
            raise ValueError(f"unknown adapter {adapter!r}")
        # ComputationGraph transformer vs MultiLayerNetwork recurrent stack
        if hasattr(net, "vertex_names") and "b0_attn" in net.vertex_names:
            return "paged"
        return "state"

    # ---------------------------------------------------------------- caches
    def make_cache(self):
        """(k_pool, v_pool) for the paged adapter (``QuantizedPool`` pairs
        on the int8 tier); for the state adapter zeroed (h, c) per
        recurrent layer for ``decode_slots + 1`` rows."""
        c, s = self.config, self.spec
        if self.adapter == "state":
            return s.init_states(c.decode_slots + 1)
        return make_pools(s.n_blocks, c.num_blocks, c.block_len, s.n_heads,
                          s.head_dim, self.dtype, self.device,
                          quantized=self.kv_quantized)

    def fresh_generator(self) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(
            self.config.seed)

    def kv_bytes_per_token(self) -> Optional[float]:
        """Block-pool device bytes per token slot (K + V, all layers and
        heads); None for the state adapter."""
        if self.adapter != "paged":
            return None
        s = self.spec
        if self.kv_quantized:
            per_head = s.head_dim * 1 + 4          # int8 codes + f32 scale
        else:
            per_head = s.head_dim * torch.empty(
                (), dtype=self.dtype).element_size()
        return float(2 * s.n_blocks * s.n_heads * per_head)

    def make_draft_cache(self):
        """Fresh draft cache: dense per-slot K/V for a transformer draft,
        zeroed recurrent states (slots + 1 rows) for an LSTM draft; None
        when speculation is off."""
        if self.draft_adapter is None:
            return None
        c = self.config
        if self.draft_adapter == "dense":
            from .speculative import make_dense_draft_cache
            return make_dense_draft_cache(self.draft_spec, c.decode_slots,
                                          c.capacity, self.device)
        return self.draft_spec.init_states(c.decode_slots + 1)

    def kv_pool_bytes_per_chip(self, cache=None) -> int:
        """Device bytes of the cache on the one card it lives on (the
        reference divides a head-sharded pool over its mesh, A7b)."""
        cache = cache if cache is not None else self.make_cache()
        if self.adapter == "paged":
            return pool_bytes(cache[0]) + pool_bytes(cache[1])
        return sum(pool_bytes(t) for c in cache if c is not None for t in c)

    # -------------------------------------------------------------- programs
    def _t(self, a) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    def _need(self, key) -> None:
        if key not in self._warmed:
            raise ServingError(
                f"no warmed {key} program — call warm() before serving "
                f"(warmed: {sorted(self._warmed)})")
        self.runs[key[0]] += 1

    @torch.inference_mode()
    def run_prefill(self, cache, tokens, lengths, tables, slots, gen, temp,
                    topk) -> np.ndarray:
        """Prefill [P,L] padded prompts into ``cache`` (in place): the paged
        adapter scatters K/V through ``tables`` (the int8 tier computes its
        logits through fake-quantized attention, ``QuantSimStore``), the
        state adapter writes each row's final state into its slot
        ``slots[i]`` (padding rows into the trash slot). Samples each row's
        first token and returns the tokens [P]."""
        self._need(("prefill",) + tuple(tokens.shape))
        return self._prefill(cache, tokens, lengths, tables, slots, gen,
                             temp, topk)

    def _prefill(self, cache, tokens, lengths, tables, slots, gen, temp,
                 topk) -> np.ndarray:
        lengths_t, tokens_t = self._t(lengths), self._t(tokens)
        if self.adapter == "state":
            logits, final = self.spec.prefill_scan(
                tokens_t, lengths_t, self.spec.init_states(tokens.shape[0]))
            slots_t = self._t(slots)
            for carry, new in zip(cache, final):
                if carry is not None:
                    carry[0][slots_t] = new[0]
                    carry[1][slots_t] = new[1]
            last = logits
        else:
            if self.kv_quantized:
                # the first token must match what a decode-step replay of
                # the same prompt gives (a prefix hit replays its suffix
                # through the decode step, whose attention reads int8 K/V)
                store = QuantSimStore(self.spec.n_blocks)
                logits = self.spec.decode_window(
                    tokens_t, torch.zeros_like(lengths_t), store)
                ks, vs = store.ks, store.vs
            else:
                logits, ks, vs = self.spec.prefill_forward(tokens_t)
            k_pool, v_pool = cache
            tables_t = self._t(tables)
            prefill_scatter(k_pool, ks, tables_t)
            prefill_scatter(v_pool, vs, tables_t)
            rows = torch.arange(logits.shape[0], device=self.device)
            last = logits[rows, lengths_t.long() - 1]
        tok = sample_tokens(last, gen, self._t(temp), self._t(topk))
        return tok.cpu().numpy()

    @torch.inference_mode()
    def decode_tensors(self, cache, tokens, pos, tables, active, gen, temp,
                       topk) -> torch.Tensor:
        """The decode step on device tensors ([S] each, ``tables``
        [S, blocks_per_seq]): the cache updated in place — K/V written
        through the block tables (paged) or the active slots' states
        replaced (state) — and the next tokens [S] sampled on the card.
        No host work: this is what ``graphs.DecodeGraph`` captures."""
        if self.adapter == "state":
            S = tokens.shape[0]
            cur = [None if c is None else (c[0][:S], c[1][:S]) for c in cache]
            logits, new = self.spec.decode_step(tokens, cur)
            keep = active[:, None]
            for carry, n in zip(cache, new):
                if carry is not None:
                    carry[0][:S] = torch.where(keep, n[0], carry[0][:S])
                    carry[1][:S] = torch.where(keep, n[1], carry[1][:S])
        else:
            store = PagedStore(cache[0], cache[1], tables, pos, active,
                               self.config.block_len)
            logits = self.spec.decode_step(tokens, pos, store)
        return sample_tokens(logits, gen, temp, topk)

    def run_decode(self, cache, tokens, pos, tables, active, gen, temp,
                   topk) -> np.ndarray:
        """One token for every slot ([S] arrays; idle slots masked by
        ``active``), run eagerly. Returns the next tokens [S]."""
        self._need(("decode",))
        tok = self.decode_tensors(cache, self._t(tokens), self._t(pos),
                                  self._t(tables), self._t(active), gen,
                                  self._t(temp), self._t(topk))
        return tok.cpu().numpy()

    # ------------------------------------------------ prefix-cache program
    @torch.inference_mode()
    def run_cow(self, cache, src: int, dst: int) -> None:
        """Copy block ``src`` -> ``dst`` in both pools (copy-on-write)."""
        self._need(("cow",))
        cow_copy(cache[0], cache[1], int(src), int(dst))

    # ------------------------------------------------- speculative programs
    def run_draft_prefill(self, dcache, tokens, lengths, slots) -> None:
        """The draft consumes the FULL prompt (prefix hits included: the
        draft has no paged cache to share)."""
        from . import speculative as sp
        self._need(("draft_prefill",) + tuple(tokens.shape))
        if self.draft_adapter == "dense":
            sp.draft_prefill_dense(self.draft_spec, dcache, self._t(tokens),
                                   self._t(slots))
        else:
            sp.draft_prefill_state(self.draft_spec, dcache, self._t(tokens),
                                   self._t(lengths), self._t(slots))

    def run_propose(self, dcache, cur, pos, active):
        """Returns (proposals np [S,k], None) for the dense draft (its cache
        updated in place), or (proposals np [S,k], states_stack) for the
        state draft (the caller commits the stack through run_rewind after
        verify)."""
        from . import speculative as sp
        self._need(("propose",))
        if self.draft_adapter == "dense":
            props = sp.propose_dense(self.draft_spec, dcache, self.spec_k,
                                     self._t(cur), self._t(pos),
                                     self._t(active))
            return props.cpu().numpy(), None
        props, stack = sp.propose_state(self.draft_spec, dcache, self.spec_k,
                                        self._t(cur))
        return props.cpu().numpy(), stack

    def run_rewind(self, dcache, stack, idx, mask) -> None:
        """State draft only: commit, per slot, the stacked state matching
        what verify accepted (masked slots keep their state)."""
        from . import speculative as sp
        self._need(("rewind",))
        sp.rewind_state(dcache, stack, self._t(idx), self._t(mask))

    def run_verify(self, cache, feeds, pos, tables, active) -> np.ndarray:
        """One batched target pass over [S, k+1] fed tokens; returns the
        greedy targets [S, k+1]."""
        from . import speculative as sp
        self._need(("verify",))
        tgt = sp.verify(self.spec, cache, self.config.block_len, self.spec_k,
                        self._t(feeds), self._t(pos), self._t(tables),
                        self._t(active))
        return tgt.cpu().numpy()

    # --------------------------------------------------------------- warm-up
    def _warm_run(self, key) -> None:
        if self._trace_hook is not None:
            self._trace_hook()              # counts warm runs
        self._warmed.add(key)

    def warm(self) -> "GenerationProgramSet":
        """Run every program once on a scratch cache: each (prefill batch,
        prompt rung), the decode step, the block copy (prefix cache on) and
        the draft prefill, propose, rewind and verify (speculating). Never
        called on the decode hot path."""
        c = self.config
        S, mb, k = c.decode_slots, c.blocks_per_seq, self.spec_k
        cache, gen = self.make_cache(), self.fresh_generator()
        self.kv_pool_chip_bytes = self.kv_pool_bytes_per_chip(cache)
        zS, fS, bS = (np.zeros((S,), np.int64), np.zeros((S,), np.float32),
                      np.zeros((S,), np.bool_))
        for P in c.prefill_batches:
            for L in c.prompt_rungs:
                self._warm_run(("prefill", P, L))
                self._prefill(cache, np.zeros((P, L), np.int64),
                              np.ones((P,), np.int64),
                              np.zeros((P, mb), np.int64),
                              np.full((P,), S, np.int64), gen,
                              np.zeros((P,), np.float32),
                              np.zeros((P,), np.int64))
        self._warm_run(("decode",))
        self.run_decode(cache, zS, zS, np.zeros((S, mb), np.int64), bS, gen,
                        fS, zS)
        if self.prefix_enabled:
            self._warm_run(("cow",))
            self.run_cow(cache, 0, 0)
        if k:
            dcache = self.make_draft_cache()
            for P in c.prefill_batches:
                for L in c.prompt_rungs:
                    self._warm_run(("draft_prefill", P, L))
                    self.run_draft_prefill(dcache, np.zeros((P, L), np.int64),
                                           np.ones((P,), np.int64),
                                           np.full((P,), S, np.int64))
            self._warm_run(("propose",))
            _, stack = self.run_propose(dcache, zS, zS, bS)
            if self.draft_adapter == "state":
                self._warm_run(("rewind",))
                self.run_rewind(dcache, stack, np.ones((S,), np.int64), bS)
            self._warm_run(("verify",))
            self.run_verify(cache, np.zeros((S, k + 1), np.int64), zS,
                            np.zeros((S, mb), np.int64), bS)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.runs.clear()
        return self

    @property
    def warmed(self) -> bool:
        c = self.config
        want = {("prefill", P, L) for P in c.prefill_batches
                for L in c.prompt_rungs} | {("decode",)}
        if self.prefix_enabled:
            want |= {("cow",)}
        if self.spec_k:
            want |= {("draft_prefill", P, L) for P in c.prefill_batches
                     for L in c.prompt_rungs} | {("propose",), ("verify",)}
            if self.draft_adapter == "state":
                want |= {("rewind",)}
        return want <= self._warmed

    # --------------------------------------------------------------- hot-swap
    def with_params_from(self, net, draft_net=None) -> "GenerationProgramSet":
        """Same-architecture swap: a new set running ``net`` that shares
        this set's warmed programs (the kernels' plans are per shape, not
        per network). The draft (when speculating) carries over unless a
        new one is given. Raises ValueError when the signature changed (the
        caller warms a fresh set before cutover)."""
        new = GenerationProgramSet(net, config=self.config,
                                   adapter=self.adapter,
                                   draft_net=(self.draft_net
                                              if draft_net is None
                                              else draft_net),
                                   trace_hook=self._trace_hook)
        if new.signature != self.signature:
            raise ValueError("parameter/architecture changed; full warm-up "
                             "required")
        new._warmed = self._warmed
        new.kv_pool_chip_bytes = self.kv_pool_chip_bytes
        return new
