"""Input types for shape inference between layers.

Counterpart of ``deeplearning4j_tpu/nn/inputs.py``: the feed-forward,
recurrent, convolutional and flattened-convolutional types, each
registered for JSON serde under the reference's name. Shapes are static
Python ints, inferred once when a configuration is built; where a layer
family changes, ``nn.preprocessors.auto_preprocessor`` inserts the
reference's preprocessor. Convolutional activations are NHWC, as in the
reference.
"""
from __future__ import annotations

from dataclasses import dataclass

from .conf.serde import register


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

    @staticmethod
    def convolutional_flat(height: int, width: int,
                           channels: int) -> "InputTypeConvolutionalFlat":
        return InputTypeConvolutionalFlat(int(height), int(width),
                                          int(channels))


@register
@dataclass(frozen=True)
class InputTypeFeedForward:
    size: int

    def flat_size(self) -> int:
        return self.size

    def batch_shape(self, batch: int):
        return (batch, self.size)


@register
@dataclass(frozen=True)
class InputTypeRecurrent:
    """[batch, time, features], batch-major as in the reference port."""
    size: int
    timestep_length: int = -1

    def flat_size(self) -> int:
        return self.size

    def batch_shape(self, batch: int):
        return (batch, self.timestep_length, self.size)


@register
@dataclass(frozen=True)
class InputTypeConvolutional:
    """[batch, height, width, channels] (NHWC)."""
    height: int
    width: int
    channels: int

    def flat_size(self) -> int:
        return self.height * self.width * self.channels

    def batch_shape(self, batch: int):
        return (batch, self.height, self.width, self.channels)


@register
@dataclass(frozen=True)
class InputTypeConvolutionalFlat:
    """An image fed flattened, [batch, height * width * channels]; a CNN
    layer after it gets a FeedForwardToCnnPreProcessor."""
    height: int
    width: int
    channels: int

    def flat_size(self) -> int:
        return self.height * self.width * self.channels

    def batch_shape(self, batch: int):
        return (batch, self.flat_size())
