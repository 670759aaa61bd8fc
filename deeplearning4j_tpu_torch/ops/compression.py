"""Threshold gradient compression: sparse sign+threshold quantization.

Counterpart of ``deeplearning4j_tpu/ops/compression.py``:
``ThresholdPayload``, ``threshold_encode`` (``:44-80``), ``threshold_decode``
(``:83-90``), ``threshold_encode_signs`` (``:93-112``),
``threshold_encode_dense`` (``:115-129``) and ``threshold_roundtrip``
(``:132-140``). Every entry of a flat residual that clears the threshold
ships as +-threshold and is subtracted from the residual, which carries the
unsent mass to the next step (Strom-style error feedback).

These were XLA ops in the reference and are stock torch ops here, in the
residual's dtype throughout, except the seam in ``threshold_encode_signs``:
a flat residual that ``fused_threshold_encode_applicable`` admits goes to
the one-pass kernel (``ops/threshold_encode.py``, K9), which is pinned
bitwise equal to its plain version, which every other residual takes.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .threshold_encode import (fused_threshold_encode_applicable,
                               threshold_encode_fused, threshold_encode_plain,
                               threshold_in_dtype, xla_sign)


class ThresholdPayload(NamedTuple):
    """The compressed message: a sparse sign+index payload of static
    capacity. ``signs`` is 0 for unused slots."""
    indices: torch.Tensor   # [capacity] int32
    signs: torch.Tensor     # [capacity] int8 in {-1, 0, +1}
    count: torch.Tensor     # [] int32, the number of live entries


def _t(threshold: float, like: torch.Tensor) -> torch.Tensor:
    return threshold_in_dtype(threshold, like.dtype).to(like.device)


def threshold_encode(residual: torch.Tensor, threshold: float,
                     capacity: int) -> Tuple[ThresholdPayload, torch.Tensor]:
    """Encode the entries of the flat ``residual`` that clear ``threshold``
    as +-threshold, in index order, up to ``capacity``, subtracting what
    was sent. Entries that do not fit stay in the residual and ship in a
    later round. Returns (payload, new_residual)."""
    if residual.dim() != 1:
        raise ValueError(f"threshold_encode expects the flat 1-D gradient "
                         f"view, got shape {tuple(residual.shape)}")
    n = residual.shape[0]
    capacity = min(int(capacity), n)
    t = _t(threshold, residual)
    sign_pre = xla_sign(residual)
    # an entry of sign 0 is never live (matters only at threshold 0, where
    # a zero would take a payload slot and ship nothing)
    live = (residual.abs() >= t) & (sign_pre != 0)
    # stream compaction: a live entry's slot is its rank among the live;
    # ranks past the capacity are dropped and stay in the residual
    pos = torch.cumsum(live.to(torch.int32), dim=0, dtype=torch.int32) - 1
    take = live & (pos < capacity)
    # one spare slot past the capacity takes every write that is dropped
    slot = torch.where(take, pos, capacity).long()
    dev = residual.device
    idx = torch.zeros(capacity + 1, dtype=torch.int32, device=dev).scatter_(
        0, slot, torch.arange(n, dtype=torch.int32, device=dev))[:capacity]
    signs = torch.zeros(capacity + 1, dtype=torch.int8, device=dev).scatter_(
        0, slot, sign_pre.to(torch.int8))[:capacity]
    sent = torch.where(take, sign_pre * t,
                       torch.zeros((), dtype=residual.dtype,
                                   device=residual.device))
    count = torch.clamp(live.sum(), max=capacity).to(torch.int32)
    return ThresholdPayload(idx, signs, count), residual - sent


def threshold_decode(payload: ThresholdPayload, threshold: float, size: int,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The dense update a payload stands for: +-threshold added at each
    index (an unused slot adds 0 at index 0; an index outside [0, size) is
    dropped)."""
    idx = payload.indices.long()
    vals = payload.signs.to(dtype) * _t(threshold, payload.signs.to(dtype))
    ok = (idx >= 0) & (idx < size)
    out = torch.zeros(size, dtype=dtype, device=idx.device)
    return out.index_add_(0, idx.clamp(0, size - 1),
                          torch.where(ok, vals, torch.zeros_like(vals)))


def threshold_encode_signs(residual: torch.Tensor, threshold: float
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense-semantics encode giving the int8 sign map wire format:
    ``(signs, new_residual)`` with the update ``signs * threshold``. A flat
    residual the probe admits takes the one-pass kernel wrapper; anything
    else takes the elementwise path (bitwise equal). This is what
    ``EncodedAccumulator``'s dense encoder calls."""
    if residual.dim() == 1 and fused_threshold_encode_applicable(
            residual.shape[0], residual.dtype):
        return threshold_encode_fused(residual, threshold)
    return threshold_encode_plain(residual, threshold)


def threshold_encode_dense(residual: torch.Tensor, threshold: float
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference semantics without a capacity bound: every entry whose
    magnitude clears the threshold becomes +-threshold. Returns (sent,
    new_residual) with ``sent`` the dense update peers apply."""
    t = _t(threshold, residual)
    sent = torch.where(residual.abs() >= t, xla_sign(residual) * t,
                       torch.zeros((), dtype=residual.dtype,
                                   device=residual.device))
    return sent, residual - sent


def threshold_roundtrip(residual: torch.Tensor, *, threshold: float,
                        capacity: int):
    """Encode then decode: the exact dense update peers will apply, the
    residual carried to the next step, and the payload."""
    payload, new_residual = threshold_encode(residual, threshold, capacity)
    update = threshold_decode(payload, threshold, residual.shape[0],
                              residual.dtype)
    return update, new_residual, payload
