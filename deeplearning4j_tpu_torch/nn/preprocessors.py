"""Input preprocessors: shape adapters between layer families.

Counterpart of ``deeplearning4j_tpu/nn/preprocessors.py``: the six
preprocessors (``CnnToFeedForwardPreProcessor``,
``FeedForwardToCnnPreProcessor``, ``RnnToFeedForwardPreProcessor``,
``FeedForwardToRnnPreProcessor``, ``CnnToRnnPreProcessor``,
``RnnToCnnPreProcessor``) and ``auto_preprocessor``, the insertion a
configuration builder makes where a layer family changes. Each is a
reshape of a tensor (a view where the layout allows). Layouts: FF [B,F];
RNN [B,T,F]; CNN [B,H,W,C] (NHWC), as in the reference.
"""
from __future__ import annotations

from dataclasses import dataclass

from .conf.serde import register
from .inputs import (InputTypeConvolutional, InputTypeConvolutionalFlat,
                     InputTypeFeedForward, InputTypeRecurrent)


@register
@dataclass
class CnnToFeedForwardPreProcessor:
    height: int
    width: int
    channels: int

    def apply(self, x):
        return x.reshape(x.shape[0], -1)

    def output_type(self, itype):
        return InputTypeFeedForward(self.height * self.width * self.channels)


@register
@dataclass
class FeedForwardToCnnPreProcessor:
    height: int
    width: int
    channels: int

    def apply(self, x):
        return x.reshape(x.shape[0], self.height, self.width, self.channels)

    def output_type(self, itype):
        return InputTypeConvolutional(self.height, self.width, self.channels)


@register
@dataclass
class RnnToFeedForwardPreProcessor:
    """[B,T,F] -> [B*T,F]."""

    def apply(self, x):
        return x.reshape(-1, x.shape[-1])

    def output_type(self, itype):
        return InputTypeFeedForward(itype.size)


@register
@dataclass
class FeedForwardToRnnPreProcessor:
    timestep_length: int = -1

    def apply(self, x):
        return x.reshape(-1, self.timestep_length, x.shape[-1])

    def output_type(self, itype):
        return InputTypeRecurrent(itype.size, self.timestep_length)


@register
@dataclass
class CnnToRnnPreProcessor:
    """[B*T,H,W,C] -> [B,T,H*W*C]."""
    height: int
    width: int
    channels: int
    timestep_length: int = -1

    def apply(self, x):
        f = self.height * self.width * self.channels
        return x.reshape(-1, self.timestep_length, f)

    def output_type(self, itype):
        return InputTypeRecurrent(self.height * self.width * self.channels,
                                  self.timestep_length)


@register
@dataclass
class RnnToCnnPreProcessor:
    height: int
    width: int
    channels: int

    def apply(self, x):
        return x.reshape(-1, self.height, self.width, self.channels)

    def output_type(self, itype):
        return InputTypeConvolutional(self.height, self.width, self.channels)


def auto_preprocessor(itype, expected: str):
    """(preprocessor or None, new input type) adapting ``itype`` to the
    layer family a layer expects ("ff", "cnn", "rnn" or "any"), the
    reference's InputType auto-insertion; the seams it cannot decide
    raise ValueError, as the reference's do."""
    if expected == "ff":
        if isinstance(itype, InputTypeConvolutional):
            p = CnnToFeedForwardPreProcessor(itype.height, itype.width,
                                             itype.channels)
            return p, p.output_type(itype)
        if isinstance(itype, InputTypeConvolutionalFlat):
            return None, InputTypeFeedForward(itype.flat_size())
        return None, itype
    if expected == "cnn":
        if isinstance(itype, InputTypeConvolutionalFlat):
            p = FeedForwardToCnnPreProcessor(itype.height, itype.width,
                                             itype.channels)
            return p, p.output_type(itype)
        if isinstance(itype, InputTypeFeedForward):
            raise ValueError("Cannot feed flat FF input to a CNN layer "
                             "without an explicit "
                             "FeedForwardToCnnPreProcessor")
        return None, itype
    if expected == "rnn":
        if isinstance(itype, InputTypeFeedForward):
            raise ValueError("Cannot feed FF input to an RNN layer without an "
                             "explicit FeedForwardToRnnPreProcessor")
        if isinstance(itype, (InputTypeConvolutional,
                              InputTypeConvolutionalFlat)):
            raise ValueError(
                "Cannot feed CNN activations to an RNN layer without an "
                "explicit CnnToRnnPreProcessor(height, width, channels, "
                "timestep_length): the time dimension is ambiguous "
                "(reference InputTypeUtil CNN->RNN is the time-distributed "
                "video seam)")
    return None, itype
