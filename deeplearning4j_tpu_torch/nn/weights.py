"""Weight initialization schemes.

Counterpart of ``deeplearning4j_tpu/nn/weights.py`` (``init_weights``,
``:50-93``, and the Normal/Uniform distributions). Sampling draws from an
explicit ``torch.Generator`` on the CPU and then moves to the target device,
so one seed gives the same weights on the CPU and on the card. A generator
gives other numbers than ``jax.random`` from the same seed: weights cross
between the packages with ``interop.jax_params.load_jax_params``, not by
seed.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch


def _normal(gen, shape, dtype):
    return torch.randn(shape, generator=gen, dtype=torch.float32).to(dtype)


def _uniform(gen, shape, dtype, lo, hi):
    u = torch.rand(shape, generator=gen, dtype=torch.float32)
    return (lo + (hi - lo) * u).to(dtype)


@dataclass(frozen=True)
class NormalDistribution:
    mean: float = 0.0
    std: float = 1.0

    def sample(self, gen, shape, dtype):
        return (self.mean + self.std * _normal(gen, shape, torch.float32)
                ).to(dtype)


@dataclass(frozen=True)
class UniformDistribution:
    lower: float = -1.0
    upper: float = 1.0

    def sample(self, gen, shape, dtype):
        return _uniform(gen, shape, dtype, self.lower, self.upper)


def init_weights(gen: torch.Generator, shape: Tuple[int, ...],
                 weight_init: str, fan_in: float, fan_out: float,
                 dtype: torch.dtype = torch.float32,
                 device: Optional[torch.device] = None,
                 distribution=None) -> torch.Tensor:
    """Sample an initial weight tensor; ``fan_in``/``fan_out`` come from the
    layer. ``gen`` is a CPU generator."""
    wi = str(weight_init).lower()
    fan_in, fan_out = float(fan_in), float(fan_out)
    if wi == "zero":
        w = torch.zeros(shape, dtype=dtype)
    elif wi == "ones":
        w = torch.ones(shape, dtype=dtype)
    elif wi == "distribution":
        if distribution is None:
            raise ValueError("WeightInit DISTRIBUTION requires a "
                             "distribution config")
        w = distribution.sample(gen, shape, dtype)
    elif wi == "uniform":
        a = 1.0 / fan_in ** 0.5
        w = _uniform(gen, shape, dtype, -a, a)
    elif wi == "xavier":
        w = (2.0 / (fan_in + fan_out)) ** 0.5 * _normal(gen, shape, dtype)
    elif wi == "xavier_uniform":
        a = (6.0 / (fan_in + fan_out)) ** 0.5
        w = _uniform(gen, shape, dtype, -a, a)
    elif wi in ("xavier_fan_in", "lecun_normal"):
        w = _normal(gen, shape, dtype) / fan_in ** 0.5
    elif wi == "xavier_legacy":
        w = (1.0 / (fan_in + fan_out) ** 0.5) * _normal(gen, shape, dtype)
    elif wi == "relu":
        w = (2.0 / fan_in) ** 0.5 * _normal(gen, shape, dtype)
    elif wi == "relu_uniform":
        a = (6.0 / fan_in) ** 0.5
        w = _uniform(gen, shape, dtype, -a, a)
    elif wi == "sigmoid_uniform":
        a = 4.0 * (6.0 / (fan_in + fan_out)) ** 0.5
        w = _uniform(gen, shape, dtype, -a, a)
    else:
        raise ValueError(f"Unknown weight init {weight_init!r}")
    return w.to(device) if device is not None else w
