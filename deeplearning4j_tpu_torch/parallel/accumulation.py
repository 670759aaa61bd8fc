"""GradientsAccumulator: the pluggable cross-worker gradient-exchange seam.

Counterpart of ``deeplearning4j_tpu/parallel/accumulation.py``:
``GradientsAccumulator`` (``:37-47``), ``PsumAccumulator`` (``:50-55``) and
``EncodedAccumulator`` (``:58-115``) with both encoders and the same
constructor checks. The training loop asks "combine my gradients" without
knowing the transport.

The reference calls ``combine`` once per worker inside ``shard_map`` with a
mesh axis in scope. Here the workers are the rows of a tensor
(``parallel/mesh.py``): ``combine(flat_grad [local, P], state [local,
...], mesh, axis)`` runs the encode of every worker this process holds
(all n on a logical mesh, its own one on a process-group mesh), row by
row as each worker would, all-gathers the payloads (the dense encoder's
int8 sign map, one byte an element, or the topk encoder's fixed-size
indices and signs), decodes every worker's and adds them in worker order,
then divides by n: bitwise ``pmean`` of the decoded updates. It returns
the combined gradient ``[local, P]`` (every row the same) and the new
per-worker carry. The dense encoder's row goes through
``ops.compression.threshold_encode_signs`` and so, for a row of at least
64K elements, through the one-pass kernel (K9): one launch a worker a
step, once a process a step over processes.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Tuple

import torch

from ..device import DeviceLike, resolve_device
from ..ops.compression import (ThresholdPayload, threshold_decode,
                               threshold_encode, threshold_encode_signs)
from ..ops.threshold_encode import threshold_update
from .mesh import Mesh, all_gather, pmean


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
        residual = state + flat_grad                       # [local, P]
        local, size = residual.shape
        dtype, t = residual.dtype, self.threshold
        new_residual = torch.empty_like(residual)
        if self.encoder == "dense":
            # the sign-map front door, one pass a worker: the int8 map is
            # what crosses to the peers
            maps = []
            for i in range(local):
                signs, new_residual[i] = threshold_encode_signs(residual[i], t)
                maps.append(signs)
            wire = (torch.stack(maps),)

            def decode(every, j):
                return threshold_update(every[0][j], t, dtype)
        else:
            capacity = max(1, int(self.capacity_fraction * size))
            idx, signs = [], []
            for i in range(local):
                payload, new_residual[i] = threshold_encode(residual[i], t,
                                                            capacity)
                idx.append(payload.indices)
                signs.append(payload.signs)
            wire = (torch.stack(idx), torch.stack(signs))

            def decode(every, j):
                return threshold_decode(ThresholdPayload(
                    every[0][j], every[1][j], None), t, size, dtype)
        # every worker's payload [n, ...] (a view on a logical mesh), each
        # decoded and added in worker order, as pmean adds the rows
        every = [all_gather(w, mesh, axis)[0] for w in wire]
        n = every[0].shape[0]
        total = decode(every, 0)
        for j in range(1, n):
            total = total + decode(every, j)
        return (total / n).unsqueeze(0).expand(local, size), new_residual
