"""DeepWalk graph embeddings.

Counterpart of ``deeplearning4j_tpu/graphs/deepwalk.py``. The walks are the
reference's (numpy, ``graph.py``); they train through the port's
``nlp.SequenceVectors``, whose step (``sv_step``) runs on the model's
``device`` (``device.py`` ``resolve_device``: the card unless the caller
names another). The queries (``lookup_table``, ``vertex_vector``,
``similarity``, ``verts_nearest``) read the numpy tables the fit leaves.

Reference: deeplearning4j-graph graph/models/deepwalk/DeepWalk.java:31 —
random walks fed to a skip-gram trainer with hierarchical softmax over a
GraphHuffman tree (InMemoryGraphLookupTable). The default objective is the
reference's hierarchical softmax, batched over padded Huffman paths (the
tree is coded by vertex occurrence frequency in the walks, where the
reference's GraphHuffman codes by degree).
``use_hierarchical_softmax=False`` selects batched negative sampling.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..device import DeviceLike
from ..nlp.sequence_vectors import SequenceVectors
from .graph import Graph, RandomWalkIterator


class DeepWalk:
    """API mirror of reference DeepWalk.Builder: vectorSize, windowSize,
    walkLength, learningRate; fit(graph) / fit(walk_iterator);
    vertex_vector / similarity."""

    def __init__(self, *, vector_size: int = 100, window_size: int = 5,
                 walk_length: int = 40, walks_per_vertex: int = 1,
                 learning_rate: float = 0.025, negative: int = 5,
                 epochs: int = 1, seed: int = 123,
                 use_hierarchical_softmax: bool = True,
                 device: DeviceLike = None):
        self.vector_size = vector_size
        self.window_size = window_size
        self.walk_length = walk_length
        self.walks_per_vertex = walks_per_vertex
        self.learning_rate = learning_rate
        self.negative = negative
        self.epochs = epochs
        self.seed = seed
        self.use_hierarchical_softmax = use_hierarchical_softmax
        self.device = device
        self._sv: Optional[SequenceVectors] = None
        self._n_vertices = 0

    def fit(self, graph_or_walks):
        """Train from a Graph (walks generated internally, reference
        DeepWalk.fit(IGraph)) or any iterable of vertex-id walks
        (reference fit(GraphWalkIterator))."""
        if isinstance(graph_or_walks, Graph):
            g = graph_or_walks
            self._n_vertices = g.num_vertices()
            walks: List[List[int]] = []
            for rep in range(self.walks_per_vertex):
                it = RandomWalkIterator(g, self.walk_length,
                                        seed=self.seed + rep)
                walks.extend(it)
        else:
            walks = [list(w) for w in graph_or_walks]
            self._n_vertices = 1 + max((max(w) for w in walks if w), default=-1)
        token_seqs = [[str(v) for v in w] for w in walks]
        self._sv = SequenceVectors(
            layer_size=self.vector_size, window=self.window_size,
            min_word_frequency=1, negative=self.negative,
            learning_rate=self.learning_rate, epochs=self.epochs,
            seed=self.seed,
            use_hierarchical_softmax=self.use_hierarchical_softmax,
            device=self.device)
        self._sv.fit(token_seqs)
        return self

    # ---- queries (reference getVertexVector / similarity) ----
    def vertex_vector(self, v: int) -> Optional[np.ndarray]:
        return self._sv.get_word_vector(str(v))

    def similarity(self, a: int, b: int) -> float:
        return self._sv.similarity(str(a), str(b))

    def verts_nearest(self, v: int, top_n: int = 10) -> List[int]:
        return [int(w) for w in self._sv.words_nearest(str(v), top_n)]

    @property
    def lookup_table(self) -> np.ndarray:
        """[n_vertices, vector_size] embedding matrix in vertex order
        (reference InMemoryGraphLookupTable.getVertexVectors)."""
        out = np.zeros((self._n_vertices, self.vector_size), np.float32)
        for v in range(self._n_vertices):
            vec = self.vertex_vector(v)
            if vec is not None:
                out[v] = vec
        return out
