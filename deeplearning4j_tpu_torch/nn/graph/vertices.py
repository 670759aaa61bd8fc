"""Graph vertices: a layer, or an elementwise combination of inputs.

Counterpart of ``LayerVertex`` and ``ElementWiseVertex`` in
``deeplearning4j_tpu/nn/graph/vertices.py``. A vertex takes a LIST of input
tensors; shape inference goes through ``output_type(input_types)``. A
[B,T] feature mask reaches a layer only when the layer ``accepts_mask``
and its input is a [B,T,F] sequence (``LayerVertex.apply`` ``:68-77``).
"""
from __future__ import annotations

from typing import Any, List

from torch import nn

from ..inputs import InputTypeRecurrent


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
