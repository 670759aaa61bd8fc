"""ComputationGraph configuration and its builder.

Counterpart of ``deeplearning4j_tpu/nn/conf/graph_conf.py``
(``ComputationGraphConfiguration``, ``topological_sort``, ``GraphBuilder``).
The topological sort is the reference's Kahn's algorithm with the same tie
order, so a graph's vertex order equals the JAX graph's, which is the
order of its ``net.params``. Shape inference sets each layer's ``n_in``
at build time. Automatic preprocessors and JSON serde come with later
slices; the transformer LM needs neither. Truncated BPTT on a graph needs
the graph's recurrent-state carry (``rnn_states``), which comes with the
rest of the training engine (ROADMAP A10); it raises
``NotImplementedError`` until then (a ``MultiLayerNetwork`` trains with
tBPTT).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ..graph.vertices import LayerVertex, VertexConf
from ..inputs import check_input_family
from .config import _infer_n_in


@dataclass
class ComputationGraphConfiguration:
    network_inputs: List[str] = field(default_factory=list)
    network_outputs: List[str] = field(default_factory=list)
    vertex_names: List[str] = field(default_factory=list)          # topo order
    vertices: Dict[str, Any] = field(default_factory=dict)         # name -> vertex
    vertex_inputs: Dict[str, List[str]] = field(default_factory=dict)
    input_types: Optional[List[Any]] = None
    seed: int = 12345
    dtype: str = "float32"
    gradient_normalization: Optional[str] = None
    gradient_normalization_threshold: float = 1.0
    updater: Optional[Any] = None
    max_num_line_search_iterations: int = 5


def topological_sort(names, inputs_of, network_inputs):
    """Kahn's algorithm over the vertex dependency graph."""
    remaining = {n: [i for i in inputs_of[n] if i not in network_inputs]
                 for n in names}
    order, ready = [], [n for n, deps in remaining.items() if not deps]
    consumers: Dict[str, List[str]] = {}
    for n in names:
        for i in remaining[n]:
            consumers.setdefault(i, []).append(n)
    ready = sorted(ready)
    while ready:
        n = ready.pop(0)
        order.append(n)
        for c in consumers.get(n, []):
            remaining[c].remove(n)
            if not remaining[c]:
                ready.append(c)
    if len(order) != len(names):
        cyc = sorted(set(names) - set(order))
        raise ValueError(f"Graph has a cycle or missing inputs involving {cyc}")
    return order


class GraphBuilder:
    def __init__(self, nn_conf):
        self.nn_conf = nn_conf
        self._inputs: List[str] = []
        self._outputs: List[str] = []
        self._vertices: Dict[str, VertexConf] = {}
        self._vertex_inputs: Dict[str, List[str]] = {}
        self._input_types: Optional[List[Any]] = None

    def add_inputs(self, *names: str) -> "GraphBuilder":
        self._inputs.extend(names)
        return self

    def add_layer(self, name: str, layer, *inputs: str) -> "GraphBuilder":
        self._vertices[name] = LayerVertex(self.nn_conf._cascade(layer))
        self._vertex_inputs[name] = list(inputs)
        return self

    def add_vertex(self, name: str, vertex: VertexConf,
                   *inputs: str) -> "GraphBuilder":
        self._vertices[name] = vertex
        self._vertex_inputs[name] = list(inputs)
        return self

    def tbptt_length(self, fwd: int, bwd: Optional[int] = None):
        raise NotImplementedError("truncated BPTT on a ComputationGraph is "
                                  "not ported yet (ROADMAP A10); a "
                                  "MultiLayerNetwork trains with it")

    def set_outputs(self, *names: str) -> "GraphBuilder":
        self._outputs = list(names)
        return self

    def set_input_types(self, *itypes) -> "GraphBuilder":
        self._input_types = list(itypes)
        return self

    def build(self) -> ComputationGraphConfiguration:
        for name, ins in self._vertex_inputs.items():
            for i in ins:
                if i not in self._inputs and i not in self._vertices:
                    raise ValueError(f"Vertex {name!r} references unknown "
                                     f"input {i!r}")
        for o in self._outputs:
            if o not in self._vertices:
                raise ValueError(f"Unknown output vertex {o!r}")
        if not self._outputs:
            raise ValueError("setOutputs(...) required")
        order = topological_sort(list(self._vertices), self._vertex_inputs,
                                  self._inputs)
        if self._input_types is not None:
            itypes: Dict[str, Any] = dict(zip(self._inputs,
                                              self._input_types))
            for name in order:
                v = self._vertices[name]
                in_types = [itypes[i] for i in self._vertex_inputs[name]]
                try:
                    if isinstance(v, LayerVertex):
                        check_input_family(in_types[0],
                                           v.layer.expected_input)
                        if getattr(v.layer, "n_in", "absent") is None:
                            v.layer.n_in = _infer_n_in(v.layer, in_types[0])
                    itypes[name] = v.output_type(in_types)
                except ValueError as e:
                    raise ValueError(
                        f"Invalid configuration at vertex {name!r} "
                        f"(inputs {self._vertex_inputs[name]}): {e}") from e
        nc = self.nn_conf
        return ComputationGraphConfiguration(
            network_inputs=list(self._inputs),
            network_outputs=list(self._outputs),
            vertex_names=order, vertices=dict(self._vertices),
            vertex_inputs=dict(self._vertex_inputs),
            input_types=self._input_types, seed=nc.seed, dtype=nc.dtype,
            gradient_normalization=nc.gradient_normalization,
            gradient_normalization_threshold=(
                nc.gradient_normalization_threshold),
            updater=nc.updater,
            max_num_line_search_iterations=nc.max_num_line_search_iterations)
