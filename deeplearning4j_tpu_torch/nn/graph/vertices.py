"""Graph vertices: a layer, a channel concatenation, an elementwise
combination of inputs, a constant scale and an L2 normalization.

Counterpart of ``LayerVertex``, ``MergeVertex`` (``:102-123``),
``ElementWiseVertex``, ``ScaleVertex`` (``:232``) and
``L2NormalizeVertex`` (``:250``) in
``deeplearning4j_tpu/nn/graph/vertices.py``. A
vertex takes a LIST of input tensors; shape inference goes through
``output_type(input_types)``. A layer vertex applies its preprocessor, if
any, before its layer. A [B,T] feature mask reaches a layer only when the
layer ``accepts_mask`` and its input is a [B,T,F] sequence
(``LayerVertex.apply`` ``:68-77``). Each vertex lists its JSON fields in
``serde_fields`` (``nn/conf/serde.py``); the reference's other nine
vertices are ROADMAP A5 (``serde.NOT_PORTED``).
"""
from __future__ import annotations

from typing import Any, List

import torch
from torch import nn

from ..conf.serde import register
from ..inputs import (InputTypeConvolutional, InputTypeFeedForward,
                      InputTypeRecurrent)


class VertexConf(nn.Module):
    """Base vertex: no parameters unless it wraps a layer."""
    serde_fields = ()

    def output_type(self, itypes: List[Any]):
        return itypes[0]

    def init_params(self, itypes, dtype, device, gen) -> None:
        pass

    def param_dict(self) -> dict:
        return {}

    def layer_state(self) -> dict:
        return {}


@register
class LayerVertex(VertexConf):
    """Wraps one layer (and an optional preprocessor before it); its
    parameters are the layer's."""
    serde_fields = ("layer_conf", "preprocessor")

    def __init__(self, layer_conf=None, preprocessor=None):
        super().__init__()
        self.layer = layer_conf
        self.preprocessor = preprocessor

    @property
    def layer_conf(self):
        """The reference's field name for the wrapped layer."""
        return self.layer

    def _in_type(self, itypes):
        it = itypes[0]
        if self.preprocessor is not None and it is not None:
            it = self.preprocessor.output_type(it)
        return it

    def output_type(self, itypes):
        return self.layer.output_type(self._in_type(itypes))

    def init_params(self, itypes, dtype, device, gen):
        self.layer.init_params(self._in_type(itypes), dtype, device, gen)

    def param_dict(self) -> dict:
        return self.layer.param_dict()

    def layer_state(self) -> dict:
        return self.layer.layer_state()

    def _prepare(self, inputs, mask):
        x = inputs[0]
        if self.preprocessor is not None:
            x = self.preprocessor.apply(x)
        kwargs = {}
        if mask is not None and getattr(self.layer, "accepts_mask", False) \
                and x.dim() == 3:
            kwargs["mask"] = mask
        return x, kwargs

    def forward(self, inputs, mask=None, *, train=False, gen=None):
        x, kwargs = self._prepare(inputs, mask)
        return self.layer(x, train=train, gen=gen, **kwargs)

    @property
    def recurrent(self) -> bool:
        """Does the wrapped layer carry a recurrent state (reference
        ``LayerVertex.recurrent``)?"""
        return hasattr(self.layer, "apply_with_final_state")

    def apply_with_final_state(self, inputs, mask=None, *, train=False,
                               gen=None, initial_state=None):
        """The recurrent layer's output and final (h, c), from
        ``initial_state`` when given: the tBPTT and streaming carry
        (reference ``LayerVertex.apply_with_final_state``)."""
        x, kwargs = self._prepare(inputs, mask)
        return self.layer.apply_with_final_state(
            x, train=train, gen=gen, initial_state=initial_state, **kwargs)


@register
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


@register
class ElementWiseVertex(VertexConf):
    """Elementwise combination of same-shaped inputs (sequences, features
    or NHWC maps). The port has the ``add`` of residual connections; the
    reference's other ops come with the slices whose models use them."""
    serde_fields = ("op",)

    def __init__(self, op: str = "add"):
        super().__init__()
        if op.lower() != "add":
            raise ValueError(f"ElementWiseVertex op {op!r} is not ported; "
                             f"available: ['add']")
        self.op = op

    def output_type(self, itypes):
        # every input must agree: conv inputs on the whole (h, w, c), the
        # others on their width (reference ``:132-147``)
        def sig(it):
            if isinstance(it, InputTypeConvolutional):
                return ("cnn", it.height, it.width, it.channels)
            if isinstance(it, InputTypeRecurrent):
                return ("rnn", it.size)
            return ("flat", it.flat_size() if hasattr(it, "flat_size")
                    else it.size)
        if len({sig(i) for i in itypes}) > 1:
            raise ValueError(
                f"ElementWiseVertex({self.op}) requires same-shaped inputs; "
                f"got {itypes}")
        return itypes[0]

    def forward(self, inputs):
        return sum(inputs[1:], inputs[0])


@register
class ScaleVertex(VertexConf):
    """Its input times the constant ``scale_factor`` (the Inception-ResNet
    blocks' residual scale)."""
    serde_fields = ("scale_factor",)

    def __init__(self, scale_factor: float = 1.0):
        super().__init__()
        self.scale_factor = scale_factor

    def forward(self, inputs):
        return inputs[0] * self.scale_factor


@register
class L2NormalizeVertex(VertexConf):
    """Its input divided by sqrt(Σx² + eps) over the last axis (the
    embedding vertex of the face-recognition zoo models)."""
    serde_fields = ("eps",)

    def __init__(self, eps: float = 1e-8):
        super().__init__()
        self.eps = eps

    def forward(self, inputs):
        x = inputs[0]
        return x / torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True)
                              + self.eps)
