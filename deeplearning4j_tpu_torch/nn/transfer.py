"""Transfer learning: clone a trained network and edit it.

Counterpart of ``deeplearning4j_tpu/nn/transfer.py`` (``:29-316``):
``FineTuneConfiguration`` (hyperparameters set on every layer that is not
frozen), ``TransferLearning`` over a ``MultiLayerNetwork`` (freeze up to a
layer, replace a layer's output width, remove layers from the output end,
append layers), ``TransferLearningHelper`` (featurize through the frozen
front, train the tail alone) and ``TransferLearningGraph`` over a
``ComputationGraph`` (freeze a vertex and everything upstream of it,
replace a layer vertex's output width).

A build deep-copies the source's configuration, whose layers are modules,
edits the copy's fields, makes a network of it on the source's device and
``init``s it, so a re-initialized layer draws from the new network's seed
(the fine-tune seed when one is given) and the updater state restarts.
Every surviving layer's parameters and layer state (a BatchNormalization's
running statistics) are then copied in: the new network shares no tensor
with the source. Freezing sets the layer's ``frozen`` field, which only
the updater reads, so a frozen BatchNormalization still moves its running
statistics in training mode, as the reference's does; the training step
takes no gradient for a frozen parameter, so no backward runs through a
frozen trunk that only feeds a trainable head.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import torch

from .layers.base import resolve_ff_size
from .inputs import InputTypeFeedForward
from .multilayer import MultiLayerNetwork


@dataclass
class FineTuneConfiguration:
    """Hyperparameter overrides for every layer that is not frozen
    (reference nn/transferlearning/FineTuneConfiguration.java); ``updater``
    and ``seed`` replace the network's own."""
    updater: Optional[Any] = None
    learning_rate: Optional[float] = None
    l1: Optional[float] = None
    l2: Optional[float] = None
    dropout: Optional[float] = None
    activation: Optional[str] = None
    seed: Optional[int] = None

    def apply_to_layer(self, layer) -> None:
        """The per-layer half of the override (both builders')."""
        for f in ("learning_rate", "l1", "l2", "dropout", "activation"):
            v = getattr(self, f)
            if v is not None:
                setattr(layer, f, v)

    def apply_to(self, conf) -> None:
        """Apply to a ``MultiLayerConfiguration``, skipping frozen layers:
        frozen pretrained weights keep their regularization and dropout."""
        if self.updater is not None:
            conf.updater = self.updater
        if self.seed is not None:
            conf.seed = self.seed
        for layer in conf.layers:
            if not getattr(layer, "frozen", False):
                self.apply_to_layer(layer)


@torch.no_grad()
def _carry(dst, src) -> None:
    """Copy a layer's (or vertex's) parameters and layer state from
    ``src`` into ``dst``'s own tensors."""
    for own, theirs in ((dst.param_dict(), src.param_dict()),
                        (dst.layer_state(), src.layer_state())):
        for k, t in own.items():
            t.copy_(theirs[k])


class TransferLearning:
    """Builder over a trained ``MultiLayerNetwork`` (reference
    TransferLearning.Builder)."""

    def __init__(self, net: MultiLayerNetwork):
        self._net = net
        self._fine_tune: Optional[FineTuneConfiguration] = None
        self._freeze_until: Optional[int] = None
        self._n_out_replace: Dict[int, tuple] = {}
        self._remove_from_output = 0
        self._added_layers: List[Any] = []

    def fine_tune_configuration(self, ftc: FineTuneConfiguration
                                ) -> "TransferLearning":
        self._fine_tune = ftc
        return self

    def set_feature_extractor(self, layer_idx: int) -> "TransferLearning":
        """Freeze layers [0..layer_idx] inclusive."""
        self._freeze_until = layer_idx
        return self

    def n_out_replace(self, layer_idx: int, n_out: int,
                      weight_init: str = "xavier") -> "TransferLearning":
        """Give the layer a new output width and fresh weights; the next
        layer's input width follows and it is re-initialized too."""
        self._n_out_replace[layer_idx] = (n_out, weight_init)
        return self

    def remove_output_layer(self) -> "TransferLearning":
        self._remove_from_output = max(self._remove_from_output, 1)
        return self

    def remove_layers_from_output(self, n: int) -> "TransferLearning":
        self._remove_from_output = max(self._remove_from_output, n)
        return self

    def add_layer(self, layer) -> "TransferLearning":
        self._added_layers.append(layer)
        return self

    def build(self) -> MultiLayerNetwork:
        src = self._net
        conf = copy.deepcopy(src.conf)
        keep = len(conf.layers) - self._remove_from_output
        conf.layers = conf.layers[:keep]
        conf.input_preprocessors = {
            k: v for k, v in conf.input_preprocessors.items()
            if int(k) < keep}

        reinit = set()
        for idx, (n_out, wi) in self._n_out_replace.items():
            conf.layers[idx].n_out = n_out
            conf.layers[idx].weight_init = wi
            reinit.add(idx)
            if idx + 1 < len(conf.layers) and \
                    hasattr(conf.layers[idx + 1], "n_in"):
                conf.layers[idx + 1].n_in = n_out
                reinit.add(idx + 1)

        # appended layers: n_in from the current tail's output type
        itype = conf.input_type
        if itype is None and conf.layers:
            n_in0 = getattr(conf.layers[0], "n_in", None)
            if n_in0:
                itype = InputTypeFeedForward(n_in0)
        if itype is not None:
            for i, layer in enumerate(conf.layers):
                pre = conf.preprocessor(i)
                if pre is not None:
                    itype = pre.output_type(itype)
                itype = layer.output_type(itype)
        for layer in self._added_layers:
            layer = copy.deepcopy(layer)
            if getattr(layer, "n_in", "absent") is None and itype is not None:
                layer.n_in = resolve_ff_size(itype)
            conf.layers.append(layer)
            reinit.add(len(conf.layers) - 1)
            if itype is not None:
                itype = layer.output_type(itype)

        if self._freeze_until is not None:
            for i in range(min(self._freeze_until + 1, len(conf.layers))):
                conf.layers[i].frozen = True
        if self._fine_tune is not None:
            self._fine_tune.apply_to(conf)

        new_net = MultiLayerNetwork(conf, device=src.device).init()
        for i in range(min(len(src.layers), len(conf.layers))):
            if i not in reinit:
                _carry(new_net.layers[i], src.layers[i])
        return new_net


class TransferLearningHelper:
    """Featurization: run inputs through the frozen front once and train
    only the tail (reference TransferLearningHelper)."""

    def __init__(self, net: MultiLayerNetwork,
                 frozen_until: Optional[int] = None):
        self.net = net
        if frozen_until is None:
            frozen = [i for i, layer in enumerate(net.layers)
                      if getattr(layer, "frozen", False)]
            frozen_until = max(frozen) if frozen else -1
        self.frozen_until = frozen_until

    @torch.inference_mode()
    def featurize(self, features) -> torch.Tensor:
        """The frozen boundary's activations (the eval forward) for raw
        inputs."""
        x = self.net._as_input(features)
        if self.frozen_until < 0:
            return x
        return self.net.apply_fn(x, train=False,
                                 to_layer=self.frozen_until)[-1]

    def unfrozen_network(self) -> MultiLayerNetwork:
        """A standalone network of the unfrozen tail, on the source's
        device, holding copies of its trained parameters and layer state
        and a fresh updater state."""
        conf = copy.deepcopy(self.net.conf)
        cut = self.frozen_until + 1
        conf.layers = conf.layers[cut:]
        conf.input_preprocessors = {
            str(int(k) - cut): v for k, v in conf.input_preprocessors.items()
            if int(k) >= cut}
        conf.input_type = None
        tail = MultiLayerNetwork(conf, device=self.net.device)
        tail.opt_state = tail.updater.init(tail.param_dicts())
        tail.initialized = True
        return tail


class TransferLearningGraph:
    """Transfer learning over a trained ``ComputationGraph`` (reference
    TransferLearning.GraphBuilder): ``set_feature_extractor`` freezes a
    vertex and everything upstream of it, ``n_out_replace`` re-initializes
    a layer vertex and the direct layer consumers whose input width
    changes, ``fine_tune_configuration`` overrides hyperparameters."""

    def __init__(self, net):
        self._net = net
        self._freeze_at: Optional[str] = None
        self._replace: Dict[str, Any] = {}
        self._fine_tune: Optional[FineTuneConfiguration] = None

    def fine_tune_configuration(self, ftc: FineTuneConfiguration
                                ) -> "TransferLearningGraph":
        self._fine_tune = ftc
        return self

    def set_feature_extractor(self, vertex_name: str
                              ) -> "TransferLearningGraph":
        """Freeze ``vertex_name`` and all its ancestors."""
        self._freeze_at = vertex_name
        return self

    def n_out_replace(self, vertex_name: str, n_out: int,
                      weight_init: Optional[str] = None
                      ) -> "TransferLearningGraph":
        self._replace[vertex_name] = (n_out, weight_init)
        return self

    @staticmethod
    def _ancestors(conf, name) -> set:
        seen, stack = set(), [name]
        while stack:
            cur = stack.pop()
            if cur in seen or cur in conf.network_inputs:
                continue
            seen.add(cur)
            stack.extend(conf.vertex_inputs.get(cur, []))
        return seen

    def build(self):
        from .graph.graph import ComputationGraph
        src = self._net
        conf = copy.deepcopy(src.conf)
        reinit = set()

        for name, (n_out, wi) in self._replace.items():
            layer = getattr(conf.vertices[name], "layer", None)
            if layer is None:
                raise ValueError(f"{name!r} is not a layer vertex")
            layer.n_out = n_out
            layer.weight_init = wi or layer.weight_init
            reinit.add(name)
            # direct layer consumers take the new fan-in; a consumer that
            # cannot (a merge, or a layer without n_in such as a
            # BatchNormalization) would keep stale widths: refused here
            for cname, ins in conf.vertex_inputs.items():
                if name in ins:
                    clayer = getattr(conf.vertices[cname], "layer", None)
                    if clayer is not None and hasattr(clayer, "n_in"):
                        clayer.n_in = n_out
                        reinit.add(cname)
                    else:
                        raise ValueError(
                            f"n_out_replace({name!r}): consumer {cname!r} "
                            f"cannot have its fan-in adjusted automatically "
                            f"(only layers with an n_in field are "
                            f"supported) — restructure or replace that "
                            f"consumer explicitly")

        if self._freeze_at is not None:
            if self._freeze_at not in conf.vertices:
                raise ValueError(f"Unknown vertex {self._freeze_at!r}")
            for name in self._ancestors(conf, self._freeze_at):
                layer = getattr(conf.vertices.get(name), "layer", None)
                if layer is not None:
                    layer.frozen = True

        if self._fine_tune is not None:
            ft = self._fine_tune
            if ft.updater is not None:
                conf.updater = ft.updater
            if ft.seed is not None:
                conf.seed = ft.seed
            for v in conf.vertices.values():
                layer = getattr(v, "layer", None)
                if layer is not None and not getattr(layer, "frozen", False):
                    ft.apply_to_layer(layer)

        new_net = ComputationGraph(conf, device=src.device).init()
        for name in new_net.vertex_names:
            if name not in reinit and name in src.vertices:
                _carry(new_net.vertices[name], src.vertices[name])
        return new_net
