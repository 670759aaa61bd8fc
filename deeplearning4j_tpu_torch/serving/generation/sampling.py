"""Token sampling: greedy, temperature and top-k.

Counterpart of ``deeplearning4j_tpu/serving/generation/sampling.py``.
Greedy (temperature <= 0) is ``argmax`` over the model-dtype logits, the
comparison the naive full-recompute reference makes. Sampling draws from a
seeded ``torch.Generator`` on the logits' device, so its random bits differ
from ``jax.random``'s; per-request temperature and top-k are tensors.
"""
from __future__ import annotations

import torch


def sample_tokens(logits, gen: torch.Generator, temperature, top_k):
    """logits [N,V] (pre-activation); temperature [N] f32 (<= 0: greedy);
    top_k [N] int (<= 0: the full vocabulary). Returns tokens [N] int64."""
    V = logits.shape[-1]
    greedy = torch.argmax(logits, dim=-1)
    scaled = logits.float() / torch.clamp(temperature, min=1e-6)[:, None]
    kk = torch.clamp(torch.where(top_k <= 0, torch.full_like(top_k, V),
                                 top_k), 1, V)
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    thr = torch.gather(sorted_desc, 1, (kk - 1).long()[:, None])
    masked = scaled.masked_fill(scaled < thr, float("-inf"))
    sampled = torch.multinomial(torch.softmax(masked, dim=-1), 1,
                                generator=gen)[:, 0]
    return torch.where(temperature <= 0, greedy, sampled)
