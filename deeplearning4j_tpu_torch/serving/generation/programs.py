"""Generation programs: bucketed prefill and the one-token decode step.

Counterpart of ``deeplearning4j_tpu/serving/generation/programs.py``
(``GenerationConfig`` ``:49-129`` and the paged branches of ``_prefill_fn``
and ``_decode_fn``, ``:352-405``). PyTorch runs eagerly, so there are no
ahead-of-time executables: ``warm()`` runs each (admission batch, prompt
rung) prefill and the decode step once, which builds the kernel and touches
every shape before traffic arrives. The pools are updated in place.

The prefix cache, speculative decoding, the int8 KV tier, meshes and
hot-swap come with later slices.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ...models.decode import TransformerDecodeSpec
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

    def __post_init__(self):
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

    def __init__(self, net, *, config: GenerationConfig):
        self.net = net
        self.config = config
        self.spec = TransformerDecodeSpec(net)
        self.device = net.device
        self.dtype = self.spec.dtype

    def make_cache(self):
        c, s = self.config, self.spec
        return make_pools(s.n_blocks, c.num_blocks, c.block_len, s.n_heads,
                          s.head_dim, self.dtype, self.device)

    def fresh_generator(self) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(
            self.config.seed)

    def _t(self, a) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    @torch.inference_mode()
    def run_prefill(self, cache, tokens, lengths, tables, gen, temp,
                    topk) -> np.ndarray:
        """Prefill [P,L] padded prompts into ``cache`` (in place) and sample
        each row's first token. Returns the tokens [P]."""
        logits, ks, vs = self.spec.prefill_forward(self._t(tokens))
        k_pool, v_pool = cache
        tables_t = self._t(tables)
        prefill_scatter(k_pool, ks, tables_t)
        prefill_scatter(v_pool, vs, tables_t)
        rows = torch.arange(logits.shape[0], device=self.device)
        last = logits[rows, self._t(lengths).long() - 1]
        tok = sample_tokens(last, gen, self._t(temp), self._t(topk))
        return tok.cpu().numpy()

    @torch.inference_mode()
    def run_decode(self, cache, tokens, pos, tables, active, gen, temp,
                   topk) -> np.ndarray:
        """One token for every slot ([S] arrays; idle slots masked by
        ``active``), K/V written into ``cache`` in place. Returns the next
        tokens [S]."""
        store = PagedStore(cache[0], cache[1], self._t(tables),
                           self._t(pos), self._t(active),
                           self.config.block_len)
        logits = self.spec.decode_step(self._t(tokens), self._t(pos), store)
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
                                 np.zeros((P, mb), np.int64), gen,
                                 np.zeros((P,), np.float32),
                                 np.zeros((P,), np.int64))
        self.run_decode(cache, np.zeros((S,), np.int64),
                        np.zeros((S,), np.int64), np.zeros((S, mb), np.int64),
                        np.zeros((S,), np.bool_), gen,
                        np.zeros((S,), np.float32), np.zeros((S,), np.int64))
        return self
