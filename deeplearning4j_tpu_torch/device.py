"""Device selection for the port's entry points.

The JAX package has no counterpart: JAX picks its default backend itself.
Here every entry point (``transformer_lm``, ``GenerationEngine``,
``naive_generate``) runs on the CUDA card unless the caller names another
device, and raises when there is no card instead of carrying on on the CPU.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the current CUDA device; ``"cpu"`` (or any explicit
    device) is taken as given. A CUDA device without a card raises."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def check_same_device(what: str, have: torch.device,
                      want: torch.device) -> None:
    if have != want:
        raise ValueError(f"{what} lives on {have}, but {want} was asked for")


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    """Map a configuration's dtype name ("float32", "bfloat16") to torch."""
    try:
        return _DTYPES[str(name)]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}; available: "
                         f"{sorted(_DTYPES)}") from None
