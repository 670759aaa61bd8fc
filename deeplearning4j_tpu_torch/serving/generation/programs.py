"""Generation programs: bucketed prefill and the one-token decode step.

Counterpart of ``deeplearning4j_tpu/serving/generation/programs.py``
(``GenerationConfig`` ``:49-129``, ``_resolve_adapter`` ``:259-270``,
``make_cache`` and the branches of ``_prefill_fn`` and ``_decode_fn``,
``:352-417``). A model is served through one of two adapters:

- ``"paged"`` (a ``transformer_lm`` graph): K/V in block pools addressed by
  per-sequence block tables;
- ``"state"`` (a recurrent MultiLayerNetwork, ``LSTMDecodeSpec``): the
  cache is each recurrent layer's (h, c) for ``decode_slots + 1`` rows, the
  last row the trash slot that prefill padding rows write into.

PyTorch runs eagerly, so there are no ahead-of-time executables:
``warm()`` runs each (admission batch, prompt rung) prefill and the decode
step once, which builds the kernels and touches every shape before traffic
arrives. The caches are updated in place.

The prefix cache, speculative decoding (an LSTM draft included), the int8
KV tier, meshes and hot-swap come with a later slice (ROADMAP A2).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ...models.decode import LSTMDecodeSpec, TransformerDecodeSpec
from .kvcache import PagedStore, make_pools, prefill_scatter
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
    prefix_cache: Optional[bool] = None   # ROADMAP A2: only None/False
    spec_k: int = 0                       # ROADMAP A2: only 0
    kv_cache_dtype: Optional[str] = None  # ROADMAP A2: only None

    def __post_init__(self):
        if self.prefix_cache or self.spec_k or self.kv_cache_dtype:
            raise NotImplementedError("the prefix cache, speculative "
                                      "decoding and the int8 KV tier are "
                                      "not ported yet (ROADMAP A2)")
        if self.block_len < 1 or self.decode_slots < 1:
            raise ValueError("block_len and decode_slots must be >= 1")
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
    """One model's generation programs, its cache layout and its sampling
    generator. Inputs arrive as numpy arrays from the scheduler; sampled
    tokens go back as numpy (which waits for the device)."""

    def __init__(self, net, *, config: GenerationConfig,
                 adapter: str = "auto"):
        self.net = net
        self.config = config
        self.adapter = self._resolve_adapter(net, adapter)
        self.spec = (TransformerDecodeSpec(net) if self.adapter == "paged"
                     else LSTMDecodeSpec(net))
        self.device = net.device
        self.dtype = self.spec.dtype

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

    def make_cache(self):
        """(k_pool, v_pool) for the paged adapter; for the state adapter
        zeroed (h, c) per recurrent layer for ``decode_slots + 1`` rows."""
        c, s = self.config, self.spec
        if self.adapter == "state":
            return s.init_states(c.decode_slots + 1)
        return make_pools(s.n_blocks, c.num_blocks, c.block_len, s.n_heads,
                          s.head_dim, self.dtype, self.device)

    def fresh_generator(self) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(
            self.config.seed)

    def _t(self, a) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    @torch.inference_mode()
    def run_prefill(self, cache, tokens, lengths, tables, slots, gen, temp,
                    topk) -> np.ndarray:
        """Prefill [P,L] padded prompts into ``cache`` (in place): the paged
        adapter scatters K/V through ``tables``, the state adapter writes
        each row's final state into its slot ``slots[i]`` (padding rows
        into the trash slot). Samples each row's first token and returns
        the tokens [P]."""
        lengths_t = self._t(lengths)
        if self.adapter == "state":
            logits, final = self.spec.prefill_scan(
                self._t(tokens), lengths_t,
                self.spec.init_states(tokens.shape[0]))
            slots_t = self._t(slots)
            for carry, new in zip(cache, final):
                if carry is not None:
                    carry[0][slots_t] = new[0]
                    carry[1][slots_t] = new[1]
            last = logits
        else:
            logits, ks, vs = self.spec.prefill_forward(self._t(tokens))
            k_pool, v_pool = cache
            tables_t = self._t(tables)
            prefill_scatter(k_pool, ks, tables_t)
            prefill_scatter(v_pool, vs, tables_t)
            rows = torch.arange(logits.shape[0], device=self.device)
            last = logits[rows, lengths_t.long() - 1]
        tok = sample_tokens(last, gen, self._t(temp), self._t(topk))
        return tok.cpu().numpy()

    @torch.inference_mode()
    def run_decode(self, cache, tokens, pos, tables, active, gen, temp,
                   topk) -> np.ndarray:
        """One token for every slot ([S] arrays; idle slots masked by
        ``active``), the cache updated in place: K/V written through the
        block tables (paged) or the active slots' states replaced (state).
        Returns the next tokens [S]."""
        active_t = self._t(active)
        if self.adapter == "state":
            S = tokens.shape[0]
            cur = [None if c is None else (c[0][:S], c[1][:S]) for c in cache]
            logits, new = self.spec.decode_step(self._t(tokens), cur)
            keep = active_t[:, None]
            for carry, n in zip(cache, new):
                if carry is not None:
                    carry[0][:S] = torch.where(keep, n[0], carry[0][:S])
                    carry[1][:S] = torch.where(keep, n[1], carry[1][:S])
        else:
            store = PagedStore(cache[0], cache[1], self._t(tables),
                               self._t(pos), active_t, self.config.block_len)
            logits = self.spec.decode_step(self._t(tokens), self._t(pos),
                                           store)
        tok = sample_tokens(logits, gen, self._t(temp), self._t(topk))
        return tok.cpu().numpy()

    def warm(self) -> "GenerationProgramSet":
        """Run every (prefill batch, prompt rung) and the decode step once
        on a scratch cache. Never called on the decode hot path."""
        c = self.config
        S, mb = c.decode_slots, c.blocks_per_seq
        cache, gen = self.make_cache(), self.fresh_generator()
        for P in c.prefill_batches:
            for L in c.prompt_rungs:
                self.run_prefill(cache, np.zeros((P, L), np.int64),
                                 np.ones((P,), np.int64),
                                 np.zeros((P, mb), np.int64),
                                 np.full((P,), S, np.int64), gen,
                                 np.zeros((P,), np.float32),
                                 np.zeros((P,), np.int64))
        self.run_decode(cache, np.zeros((S,), np.int64),
                        np.zeros((S,), np.int64), np.zeros((S, mb), np.int64),
                        np.zeros((S,), np.bool_), gen,
                        np.zeros((S,), np.float32), np.zeros((S,), np.int64))
        return self
