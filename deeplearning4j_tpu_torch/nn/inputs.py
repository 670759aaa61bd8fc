"""Input types for shape inference between layers.

Counterpart of ``deeplearning4j_tpu/nn/inputs.py``, with the feed-forward,
recurrent and convolutional types the ported models need. Shapes are static
Python ints, inferred once when a configuration is built. Convolutional
activations are NHWC, as in the reference.
"""
from __future__ import annotations

from dataclasses import dataclass


class InputType:
    """Factory namespace, mirroring the reference's InputType.recurrent(...)."""

    @staticmethod
    def feed_forward(size: int) -> "InputTypeFeedForward":
        return InputTypeFeedForward(int(size))

    @staticmethod
    def recurrent(size: int, timestep_length: int = -1) -> "InputTypeRecurrent":
        return InputTypeRecurrent(int(size), int(timestep_length))

    @staticmethod
    def convolutional(height: int, width: int,
                      channels: int) -> "InputTypeConvolutional":
        return InputTypeConvolutional(int(height), int(width), int(channels))


@dataclass(frozen=True)
class InputTypeFeedForward:
    size: int


@dataclass(frozen=True)
class InputTypeRecurrent:
    """[batch, time, features], batch-major as in the reference port."""
    size: int
    timestep_length: int = -1


@dataclass(frozen=True)
class InputTypeConvolutional:
    """[batch, height, width, channels] (NHWC)."""
    height: int
    width: int
    channels: int

    def flat_size(self) -> int:
        return self.height * self.width * self.channels


def check_input_family(itype, expected: str) -> None:
    """The layer-family rules of the reference's ``auto_preprocessor``
    (``nn/preprocessors.py:110-146``). The port has no input preprocessor
    yet (ROADMAP A5): where the reference would insert the
    CnnToFeedForwardPreProcessor this raises ``NotImplementedError``, and
    where it refuses, this refuses too."""
    conv = isinstance(itype, InputTypeConvolutional)
    if expected == "rnn" and isinstance(itype, InputTypeFeedForward):
        raise ValueError("Cannot feed FF input to an RNN layer without an "
                         "explicit FeedForwardToRnnPreProcessor")
    if expected == "rnn" and conv:
        raise ValueError("Cannot feed CNN activations to an RNN layer "
                         "without an explicit CnnToRnnPreProcessor")
    if expected == "cnn" and isinstance(itype, InputTypeFeedForward):
        raise ValueError("Cannot feed flat FF input to a CNN layer without "
                         "an explicit FeedForwardToCnnPreProcessor")
    if expected == "ff" and conv:
        raise NotImplementedError(
            "CNN activations into a feed-forward layer need the "
            "CnnToFeedForwardPreProcessor, which is not ported yet (ROADMAP "
            "A5); a GlobalPoolingLayer between them needs none")
