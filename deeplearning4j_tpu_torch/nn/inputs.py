"""Input types for shape inference between layers.

Counterpart of ``deeplearning4j_tpu/nn/inputs.py``, with the feed-forward
and recurrent types the transformer LM's graph needs. Shapes are static
Python ints, inferred once when a configuration is built.
"""
from __future__ import annotations

from dataclasses import dataclass


class InputType:
    """Factory namespace, mirroring the reference's InputType.recurrent(...)."""

    @staticmethod
    def recurrent(size: int, timestep_length: int = -1) -> "InputTypeRecurrent":
        return InputTypeRecurrent(int(size), int(timestep_length))


@dataclass(frozen=True)
class InputTypeFeedForward:
    size: int


@dataclass(frozen=True)
class InputTypeRecurrent:
    """[batch, time, features], batch-major as in the reference port."""
    size: int
    timestep_length: int = -1


def check_input_family(itype, expected: str) -> None:
    """The layer-family rules of the reference's ``auto_preprocessor`` that
    need no preprocessor: feed-forward activations cannot enter a recurrent
    layer."""
    if expected == "rnn" and isinstance(itype, InputTypeFeedForward):
        raise ValueError("Cannot feed FF input to an RNN layer without an "
                         "explicit FeedForwardToRnnPreProcessor")
