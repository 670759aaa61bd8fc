"""Plain softmax attention.

Counterpart of ``attention`` in ``deeplearning4j_tpu/parallel/ring_attention.py``
(``:52-68``): the single-device reference the fused kernel is held against,
and the attention the layer takes where the kernel's probe refuses the
shapes. The sharded ring comes with the parallel slice.
"""
from __future__ import annotations

import math
from typing import Optional

import torch


def attention(q, k, v, *, causal: bool = False,
              scale: Optional[float] = None, key_mask=None):
    """[B,H,T,D] in and out. ``key_mask`` [B,Tk] excludes padded timesteps
    as keys with -1e30 (so a fully masked query row is uniform, not NaN).
    Causal fills with -1e30 when a key mask is given and with -inf
    otherwise, as the reference does."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    if key_mask is not None:
        visible = key_mask.to(q.dtype)[:, None, None, :] > 0
        s = s.masked_fill(~visible, -1e30)
    if causal:
        tq, tk = s.shape[-2], s.shape[-1]
        above = torch.ones(tq, tk, dtype=torch.bool,
                           device=q.device).triu(diagonal=tk - tq + 1)
        s = s.masked_fill(above, -1e30 if key_mask is not None
                          else float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p, v)
