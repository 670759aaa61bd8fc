"""GradientsAccumulator: the pluggable cross-worker gradient-exchange seam.

Counterpart of ``deeplearning4j_tpu/parallel/accumulation.py``:
``GradientsAccumulator`` (``:37-47``), ``PsumAccumulator`` (``:50-55``) and
``EncodedAccumulator`` (``:58-115``) with both encoders and the same
constructor checks. The training loop asks "combine my gradients" without
knowing the transport.

The reference calls ``combine`` once per worker inside ``shard_map`` with a
mesh axis in scope. Here the workers are the rows of a tensor
(``parallel/mesh.py``): ``combine(flat_grad [n, P], state [n, ...], mesh,
axis)`` runs every worker's encode, row by row as each worker would, and
one ``pmean``; it returns the combined gradient ``[n, P]`` (every row the
same) and the new per-worker carry. The dense encoder's row goes through
``ops.compression.threshold_encode_signs`` and so, for a row of at least
64K elements, through the one-pass kernel (K9): one launch a worker a
step.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Tuple

import torch

from ..device import DeviceLike, resolve_device
from ..ops.compression import (threshold_decode, threshold_encode,
                               threshold_encode_signs)
from ..ops.threshold_encode import threshold_update
from .mesh import Mesh, pmean


class GradientsAccumulator:
    """SPI. ``init(size, dtype, device)`` builds ONE worker's carry;
    ``combine(flat_grad, state, mesh, axis)`` takes the workers' flat
    gradients ``[n, P]`` and carries ``[n, ...]`` and returns
    (combined ``[n, P]``, new carries)."""

    def init(self, size: int, dtype: torch.dtype,
             device: DeviceLike = None) -> Any:
        return ()

    def combine(self, flat_grad: torch.Tensor, state: Any, mesh: Mesh,
                axis: str = "data") -> Tuple[torch.Tensor, Any]:
        raise NotImplementedError


@dataclass
class PsumAccumulator(GradientsAccumulator):
    """Exact all-reduce mean (plain sync data parallelism)."""

    def combine(self, flat_grad, state, mesh, axis="data"):
        return pmean(flat_grad, mesh, axis), state


@dataclass
class EncodedAccumulator(GradientsAccumulator):
    """Threshold-compressed exchange: each worker adds its gradient to its
    residual, quantizes what clears the threshold to +-threshold, subtracts
    the sent mass from the residual (error feedback), and all workers apply
    the mean of the decoded updates.

    Two encoders:
    - ``"dense"``: every entry above the threshold ships, as an int8 sign
      map on the wire.
    - ``"topk"``: a fixed-size index/sign payload of capacity
      ``capacity_fraction * n``, filled in index order.
    ``encoder=None`` selects "topk" when ``capacity_fraction`` is set and
    "dense" otherwise.
    """
    threshold: float = 1e-3
    capacity_fraction: Optional[float] = None
    encoder: Optional[str] = None

    def __post_init__(self):
        if self.encoder is None:
            self.encoder = "dense" if self.capacity_fraction is None else "topk"
        if self.encoder not in ("dense", "topk"):
            raise ValueError(f"Unknown encoder {self.encoder!r} "
                             f"(expected 'dense' or 'topk')")
        if self.encoder == "dense" and self.capacity_fraction is not None:
            raise ValueError(
                "capacity_fraction only applies to the bounded 'topk' "
                "payload format; the dense encoder ships every entry above "
                "threshold")
        if self.encoder == "topk" and self.capacity_fraction is None:
            self.capacity_fraction = 0.1

    def init(self, size: int, dtype: torch.dtype, device: DeviceLike = None):
        """One worker's zero residual, on the card unless ``device`` says
        otherwise."""
        return torch.zeros(size, dtype=dtype, device=resolve_device(device))

    def combine(self, flat_grad, state, mesh, axis="data"):
        residual = state + flat_grad                       # [n, P]
        n, size = residual.shape
        new_residual = torch.empty_like(residual)
        sent = torch.empty_like(residual)
        if self.encoder == "dense":
            # the sign-map front door, one pass a worker; the update peers
            # apply is rebuilt from the int8 map only as the mean's operand
            for i in range(n):
                signs, new_residual[i] = threshold_encode_signs(
                    residual[i], self.threshold)
                threshold_update(signs, self.threshold, residual.dtype,
                                 out=sent[i])
            return pmean(sent, mesh, axis), new_residual
        capacity = max(1, int(self.capacity_fraction * size))
        for i in range(n):
            payload, new_residual[i] = threshold_encode(
                residual[i], self.threshold, capacity)
            sent[i] = threshold_decode(payload, self.threshold, size,
                                       flat_grad.dtype)
        return pmean(sent, mesh, axis), new_residual
