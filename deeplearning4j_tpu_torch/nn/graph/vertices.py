"""Graph vertices: a layer, a channel concatenation, or an elementwise
combination of inputs.

Counterpart of ``LayerVertex``, ``MergeVertex`` (``:102-123``) and
``ElementWiseVertex`` in ``deeplearning4j_tpu/nn/graph/vertices.py``. A vertex takes a LIST of input
tensors; shape inference goes through ``output_type(input_types)``. A
[B,T] feature mask reaches a layer only when the layer ``accepts_mask``
and its input is a [B,T,F] sequence (``LayerVertex.apply`` ``:68-77``).
"""
from __future__ import annotations

from typing import Any, List

import torch
from torch import nn

from ..inputs import (InputTypeConvolutional, InputTypeFeedForward,
                      InputTypeRecurrent)


class VertexConf(nn.Module):
    """Base vertex: no parameters unless it wraps a layer."""

    def output_type(self, itypes: List[Any]):
        return itypes[0]

    def init_params(self, itypes, dtype, device, gen) -> None:
        pass

    def param_dict(self) -> dict:
        return {}


class LayerVertex(VertexConf):
    """Wraps one layer; its parameters are the layer's."""

    def __init__(self, layer):
        super().__init__()
        self.layer = layer

    def output_type(self, itypes):
        return self.layer.output_type(itypes[0])

    def init_params(self, itypes, dtype, device, gen):
        self.layer.init_params(itypes[0], dtype, device, gen)

    def param_dict(self) -> dict:
        return self.layer.param_dict()

    def forward(self, inputs, mask=None, *, train=False, gen=None):
        x = inputs[0]
        kwargs = {}
        if mask is not None and getattr(self.layer, "accepts_mask", False) \
                and x.dim() == 3:
            kwargs["mask"] = mask
        return self.layer(x, train=train, gen=gen, **kwargs)


class MergeVertex(VertexConf):
    """Concatenate along the last axis: the channels of NHWC maps (the
    reference's NCHW depth concat), or the features."""

    def output_type(self, itypes):
        it0 = itypes[0]
        if isinstance(it0, InputTypeConvolutional):
            bad = [i for i in itypes
                   if not isinstance(i, InputTypeConvolutional)
                   or (i.height, i.width) != (it0.height, it0.width)]
            if bad:
                raise ValueError(
                    f"MergeVertex concatenates channels, so all inputs must "
                    f"be convolutional with equal spatial dims; got {itypes}")
            return InputTypeConvolutional(it0.height, it0.width,
                                          sum(i.channels for i in itypes))
        if isinstance(it0, InputTypeRecurrent):
            return InputTypeRecurrent(sum(i.size for i in itypes),
                                      it0.timestep_length)
        return InputTypeFeedForward(sum(i.size for i in itypes))

    def forward(self, inputs):
        return torch.cat(inputs, dim=-1)


class ElementWiseVertex(VertexConf):
    """Elementwise combination of same-shaped inputs. The port has the
    ``add`` of residual connections; the reference's other ops come with
    the slices whose models use them."""

    def __init__(self, op: str = "add"):
        super().__init__()
        if op.lower() != "add":
            raise ValueError(f"ElementWiseVertex op {op!r} is not ported; "
                             f"available: ['add']")
        self.op = op

    def output_type(self, itypes):
        def sig(it):
            if isinstance(it, InputTypeRecurrent):
                return ("rnn", it.size)
            return ("flat", it.size)
        if len({sig(i) for i in itypes}) > 1:
            raise ValueError(
                f"ElementWiseVertex({self.op}) requires same-shaped inputs; "
                f"got {itypes}")
        return itypes[0]

    def forward(self, inputs):
        return sum(inputs[1:], inputs[0])
