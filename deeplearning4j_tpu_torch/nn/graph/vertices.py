"""Graph vertices: a layer, a channel concatenation, an elementwise
combination of inputs, and the reshaping, slicing and arithmetic vertices.

Counterpart of ``deeplearning4j_tpu/nn/graph/vertices.py``:
``LayerVertex``, ``MergeVertex`` (``:102-123``), ``ElementWiseVertex``,
``PoolHelperVertex`` (``:172``), ``SubsetVertex`` (``:189``),
``StackVertex`` (``:206``), ``UnstackVertex`` (``:216``),
``ScaleVertex`` (``:232``), ``ShiftVertex`` (``:241``),
``L2NormalizeVertex`` (``:250``), ``L2Vertex`` (``:261``),
``PreprocessorVertex`` (``:274``), and the recurrent pair
``LastTimeStepVertex`` (``:286``) and ``DuplicateToTimeSeriesVertex``
(``:304``). A vertex takes a LIST of input tensors; shape inference goes
through ``output_type(input_types)``. A layer vertex applies its
preprocessor, if any, before its layer. A [B,T] feature mask reaches a
layer only when the layer ``accepts_mask`` and its input is a [B,T,F]
sequence (``LayerVertex.apply`` ``:68-77``). The graph's executor hands
``LastTimeStepVertex`` its mask and ``DuplicateToTimeSeriesVertex`` its
length (``nn/graph/graph.py``). Each vertex lists its JSON fields in
``serde_fields`` (``nn/conf/serde.py``).
"""
from __future__ import annotations

from typing import Any, List, Optional

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


@register
class PoolHelperVertex(VertexConf):
    """Drops the first row and column of an NHWC map (the off-by-one
    pooling of Caffe-trained inception models)."""

    def output_type(self, itypes):
        it = itypes[0]
        if not isinstance(it, InputTypeConvolutional):
            raise ValueError(f"PoolHelperVertex expects convolutional input, "
                             f"got {it}")
        return InputTypeConvolutional(it.height - 1, it.width - 1,
                                      it.channels)

    def forward(self, inputs):
        return inputs[0][:, 1:, 1:, :]


@register
class SubsetVertex(VertexConf):
    """The features [from_idx, to_idx], both ends included."""
    serde_fields = ("from_idx", "to_idx")

    def __init__(self, from_idx: int = 0, to_idx: int = 0):
        super().__init__()
        self.from_idx = from_idx
        self.to_idx = to_idx

    def output_type(self, itypes):
        n = self.to_idx - self.from_idx + 1
        it = itypes[0]
        if isinstance(it, InputTypeRecurrent):
            return InputTypeRecurrent(n, it.timestep_length)
        return InputTypeFeedForward(n)

    def forward(self, inputs):
        return inputs[0][..., self.from_idx:self.to_idx + 1]


@register
class StackVertex(VertexConf):
    """Its inputs stacked along the batch axis (one layer shared by
    several inputs)."""

    def forward(self, inputs):
        return torch.cat(inputs, dim=0)


@register
class UnstackVertex(VertexConf):
    """Slice ``from_idx`` of ``stack_size`` equal slices of the batch
    axis: the inverse of ``StackVertex``."""
    serde_fields = ("from_idx", "stack_size")

    def __init__(self, from_idx: int = 0, stack_size: int = 1):
        super().__init__()
        self.from_idx = from_idx
        self.stack_size = stack_size

    def forward(self, inputs):
        x = inputs[0]
        step = x.shape[0] // self.stack_size
        return x[self.from_idx * step:(self.from_idx + 1) * step]


@register
class ShiftVertex(VertexConf):
    """Its input plus the constant ``shift_factor``."""
    serde_fields = ("shift_factor",)

    def __init__(self, shift_factor: float = 0.0):
        super().__init__()
        self.shift_factor = shift_factor

    def forward(self, inputs):
        return inputs[0] + self.shift_factor


@register
class L2Vertex(VertexConf):
    """The L2 distance of two inputs over the last axis, sqrt(Σd² + eps),
    [B, 1]."""
    serde_fields = ("eps",)

    def __init__(self, eps: float = 1e-8):
        super().__init__()
        self.eps = eps

    def output_type(self, itypes):
        return InputTypeFeedForward(1)

    def forward(self, inputs):
        d = inputs[0] - inputs[1]
        return torch.sqrt(torch.sum(d * d, dim=-1, keepdim=True) + self.eps)


@register
class PreprocessorVertex(VertexConf):
    """A preprocessor (``nn/preprocessors.py``) as a vertex of its own."""
    serde_fields = ("preprocessor",)

    def __init__(self, preprocessor=None):
        super().__init__()
        self.preprocessor = preprocessor

    def output_type(self, itypes):
        return self.preprocessor.output_type(itypes[0])

    def forward(self, inputs):
        return self.preprocessor.apply(inputs[0])


@register
class LastTimeStepVertex(VertexConf):
    """[B,T,F] -> [B,F] at each sequence's last unmasked step under a
    [B,T] mask (the mask of the vertex or network input named
    ``mask_input``, else its input's), else the literal last step. The
    index is computed on the device from the mask (a gather: no host
    read)."""
    serde_fields = ("mask_input",)

    def __init__(self, mask_input: Optional[str] = None):
        super().__init__()
        self.mask_input = mask_input

    def output_type(self, itypes):
        return InputTypeFeedForward(itypes[0].size)

    def forward(self, inputs, mask=None):
        x = inputs[0]
        if mask is None:
            return x[:, -1]
        idx = torch.clamp(mask.to(torch.int64).sum(dim=1) - 1, min=0)
        return x[torch.arange(x.shape[0], device=x.device), idx]


@register
class DuplicateToTimeSeriesVertex(VertexConf):
    """[B,F] -> [B,T,F], the same features at every step; T is the length
    of ``reference_input``'s activation when the executor passes it, else
    ``timestep_length``."""
    serde_fields = ("reference_input", "timestep_length")

    def __init__(self, reference_input: Optional[str] = None,
                 timestep_length: int = -1):
        super().__init__()
        self.reference_input = reference_input
        self.timestep_length = timestep_length

    def output_type(self, itypes):
        return InputTypeRecurrent(itypes[0].size, self.timestep_length)

    def forward(self, inputs, timesteps=None):
        x = inputs[0]
        t = timesteps if timesteps is not None else self.timestep_length
        return x[:, None, :].expand(x.shape[0], t, x.shape[-1])
