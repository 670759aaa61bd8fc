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

**Telemetry** (reference ``:285-303, 538-575``): every cache ``make_cache``
builds is tagged for the memory profiler as ``<cost_path>.kvcache``
(``generation.<model>.kvcache``; ``generation.kvcache`` without a cost
path). Each warm run is noted to ``telemetry.note_warm_run`` and, with
``cost_path`` set, counted (``telemetry.perf``: the aten ops' formulas and
the kernels' own counts, at the warm run's shapes) into the reference's
cost entries: ``<cost_path>.decode_step`` (paired with the scheduler's
``decode_step_ms`` histogram), ``<cost_path>.verify`` (``verify_step_ms``)
and ``<cost_path>.prefill.b<P>xp<L>`` (cost only), each divided by the
model axis.

**Head-sharded decode** (``mesh=`` with a ``model`` axis of m > 1, the
reference's ``:156-235, 262-300``): the set serves a copy of the network
laid out on the model axis (``parallel/tensor_parallel.py`` ``place_net``)
and keeps its paged pools head-sharded, ``[m, n_layers, nb, blk, H/m,
Dh]``: every program runs one store a rank (``TransformerDecodeSpec``'s
sharded path), so ``kv_pool_chip_bytes`` is one rank's bytes, 1/m of the
unsharded pools'. The host side (block tables, allocator, prefix cache)
indexes blocks, which keep their ids. Only the paged adapter shards, and
only a head count the axis divides (both refused otherwise, with the
reference's messages). A transformer draft whose heads divide is sharded
the same way, any other draft stays replicated. The mesh is part of the
``signature``; ``with_params_from`` keeps it and the warmed programs. A
head-sharded cohort's decode step is captured as a CUDA graph like any
other.
"""
from __future__ import annotations

import math
from collections import Counter
from dataclasses import dataclass
from typing import Callable, Optional, Set, Tuple

import numpy as np
import torch

from ...models.decode import LSTMDecodeSpec, TransformerDecodeSpec
from ...parallel.tensor_parallel import (held_specs, model_axis_size,
                                        place_net)
from ...telemetry import memprof
from ...telemetry.perf import get_cost_index
from ...telemetry.torchsignals import timed_warm_run
from ..errors import ServingError
from .kvcache import (PagedStore, QuantSimStore, cow_copy, make_pools,
                      pool_bytes, prefill_scatter, rank_pool, rank_stores)
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
                 mesh=None, cost_path: Optional[str] = None):
        self.net = net
        self.config = config
        self._trace_hook = trace_hook
        self.cost_path = cost_path    # "generation.<model>": cost entries
        self.adapter = self._resolve_adapter(net, adapter)
        self.model_shards = model_axis_size(mesh)
        self.mesh = mesh if self.model_shards > 1 else None
        if self.model_shards > 1:
            if self.adapter != "paged":
                raise ValueError(
                    "model-sharded decode requires the paged (transformer) "
                    "adapter — the recurrent-state cache has no head axis "
                    "to split")
            heads = TransformerDecodeSpec(net)
            if not heads.supports_head_sharding(self.model_shards):
                raise ValueError(
                    f"n_heads={heads.n_heads} does not divide by the "
                    f"model axis ({self.model_shards}) — the paged pools "
                    f"shard whole heads")
            if mesh.device != net.device:
                raise ValueError(f"the mesh lives on {mesh.device}, the "
                                 f"network on {net.device}")
        if self.adapter == "paged" and (self.model_shards > 1
                                        or _holds_rows(net)):
            net = _sharded_copy(net, self.model_shards)
        self.served = net       # the network the programs run
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
            if da == "paged":
                # a draft whose heads divide shards as the target does;
                # any other stays replicated
                dm = self.model_shards if TransformerDecodeSpec(
                    draft_net).supports_head_sharding(self.model_shards) \
                    else 1
                if dm > 1 or _holds_rows(draft_net):
                    draft_net = _sharded_copy(draft_net, dm)
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
        mesh_sig = None if self.mesh is None else (
            self.mesh.axis_names, self.mesh.axis_sizes, str(self.mesh.device))
        self.signature = (_param_signature(self.net), _arch_key(self.net),
                          self.adapter, config.block_len, config.capacity,
                          config.decode_slots, config.prefill_batches,
                          config.prompt_rungs, config.num_blocks,
                          self.prefix_enabled, config.kv_cache_dtype,
                          mesh_sig, draft_sig)
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
            cache = s.init_states(c.decode_slots + 1)
        else:
            cache = make_pools(s.n_blocks, c.num_blocks, c.block_len,
                               s.n_heads, s.head_dim, self.dtype, self.device,
                               quantized=self.kv_quantized,
                               shards=self.model_shards)
        # the memory profiler's owner: the pool dominates the card's bytes
        memprof.tag(cache, (self.cost_path or "generation") + ".kvcache")
        return cache

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
        """Device bytes of the cache one rank holds: all of it unsharded,
        one rank's heads (1/m) of a head-sharded pool."""
        cache = cache if cache is not None else self.make_cache()
        if self.adapter == "paged":
            return (pool_bytes(cache[0]) + pool_bytes(cache[1])) \
                // self.model_shards
        return sum(pool_bytes(t) for c in cache if c is not None for t in c)

    # -------------------------------------------------------------- programs
    def _t(self, a) -> torch.Tensor:
        """A host array onto the device. On the card through pinned memory
        and an asynchronous copy: a copy from pageable memory makes the
        loop thread wait for the work queued on the stream before it (a
        synchronising call for each input). The program's result read
        (``.cpu()``) is then its one wait on the card."""
        if self.device.type != "cuda":
            return torch.as_tensor(a, device=self.device)
        host = torch.from_numpy(np.ascontiguousarray(a)).pin_memory()
        return host.to(self.device, non_blocking=True)

    def _stores(self, make, cache):
        """``make(k_pool, v_pool)`` over the cache's pools, one a rank when
        they are head-sharded (``kvcache.rank_stores``)."""
        return rank_stores(self.model_shards, make, cache[0], cache[1])

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
            m = self.model_shards
            if self.kv_quantized:
                # the first token must match what a decode-step replay of
                # the same prompt gives (a prefix hit replays its suffix
                # through the decode step, whose attention reads int8 K/V)
                stores = self._stores(
                    lambda k, v: QuantSimStore(self.spec.n_blocks), cache)
                logits = self.spec.decode_window(
                    tokens_t, torch.zeros_like(lengths_t), stores)
                per_rank = [(st.ks, st.vs) for st in
                            (stores if m > 1 else [stores])]
            else:
                logits, ks, vs = self.spec.prefill_forward(tokens_t)
                per_rank = [(ks, vs)] if m == 1 else [
                    ([k[r] for k in ks], [v[r] for v in vs])
                    for r in range(m)]
            tables_t = self._t(tables)
            for r, (ks, vs) in enumerate(per_rank):
                pools = cache if m == 1 else (rank_pool(cache[0], r),
                                              rank_pool(cache[1], r))
                prefill_scatter(pools[0], ks, tables_t)
                prefill_scatter(pools[1], vs, tables_t)
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
            store = self._stores(
                lambda k, v: PagedStore(k, v, tables, pos, active,
                                        self.config.block_len), cache)
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
    def _warm_run(self, key, run: Callable[[], object]):
        """Mark ``key`` warmed and run it once: noted as a warm run, and
        counted into its cost entry where it has one. Returns the run's
        output."""
        if self._trace_hook is not None:
            self._trace_hook()              # counts warm runs
        self._warmed.add(key)
        entry = self._cost_entry(key)
        with timed_warm_run():
            if entry is None:
                return run()
            path, timing, items = entry
            return get_cost_index().count(
                path, (key, self.signature), run, timing_metric=timing,
                items_per_step=items, model_axis_size=self.model_shards,
                dtype=self.dtype, device=self.device)

    def _cost_entry(self, key):
        """(path, timing histogram, items a step) of a program's cost
        entry, or None (no cost path, or a program without one)."""
        if self.cost_path is None:
            return None
        base, S = self.cost_path, float(self.config.decode_slots)
        if key[0] == "decode":
            return f"{base}.decode_step", f"{base}.decode_step_ms", S
        if key[0] == "verify":
            return f"{base}.verify", f"{base}.verify_step_ms", S
        if key[0] == "prefill":
            _, P, L = key
            return f"{base}.prefill.b{P}xp{L}", None, float(P)
        return None

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
                self._warm_run(
                    ("prefill", P, L), lambda P=P, L=L: self._prefill(
                        cache, np.zeros((P, L), np.int64),
                        np.ones((P,), np.int64), np.zeros((P, mb), np.int64),
                        np.full((P,), S, np.int64), gen,
                        np.zeros((P,), np.float32),
                        np.zeros((P,), np.int64)))
        self._warm_run(("decode",), lambda: self.run_decode(
            cache, zS, zS, np.zeros((S, mb), np.int64), bS, gen, fS, zS))
        if self.prefix_enabled:
            self._warm_run(("cow",), lambda: self.run_cow(cache, 0, 0))
        if k:
            dcache = self.make_draft_cache()
            for P in c.prefill_batches:
                for L in c.prompt_rungs:
                    self._warm_run(
                        ("draft_prefill", P, L),
                        lambda P=P, L=L: self.run_draft_prefill(
                            dcache, np.zeros((P, L), np.int64),
                            np.ones((P,), np.int64),
                            np.full((P,), S, np.int64)))
            _, stack = self._warm_run(("propose",), lambda: self.run_propose(
                dcache, zS, zS, bS))
            if self.draft_adapter == "state":
                self._warm_run(("rewind",), lambda: self.run_rewind(
                    dcache, stack, np.ones((S,), np.int64), bS))
            self._warm_run(("verify",), lambda: self.run_verify(
                cache, np.zeros((S, k + 1), np.int64), zS,
                np.zeros((S, mb), np.int64), bS))
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
        """Same-architecture swap: a new set running ``net`` on this set's
        mesh that shares this set's warmed programs (the kernels' plans are
        per shape, not per network). The draft (when speculating) carries
        over unless a new one is given. Raises ValueError when the
        signature changed (the caller warms a fresh set before cutover)."""
        new = GenerationProgramSet(net, config=self.config,
                                   adapter=self.adapter,
                                   draft_net=(self.draft_net
                                              if draft_net is None
                                              else draft_net),
                                   trace_hook=self._trace_hook,
                                   mesh=self.mesh, cost_path=self.cost_path)
        if new.signature != self.signature:
            raise ValueError("parameter/architecture changed; full warm-up "
                             "required")
        new._warmed = self._warmed
        new.kv_pool_chip_bytes = self.kv_pool_chip_bytes
        return new


def _holds_rows(net) -> bool:
    return any(s for sd in held_specs(net).values() for s in sd.values())


def _sharded_copy(net, m: int):
    """A copy of ``net``'s parameters laid out on a model axis of ``m``
    (the served network of a head-sharded set, whole at m = 1; the
    caller's network is not touched, and no updater state is copied)."""
    copy = net.clone()
    copy.opt_state = None
    place_net(copy, m)
    return copy
