"""Graph API: adjacency-list graph + random-walk iterators.

A copy of ``deeplearning4j_tpu/graphs/graph.py`` (numpy only). The walks
draw from ``np.random.default_rng(seed + epoch)`` in the reference's order,
so both packages yield the same walks from one seed.

Reference: deeplearning4j-graph — api/IGraph.java SPI, graph/Graph.java
(adjacency-list impl), iterator/RandomWalkIterator.java (uniform walks with
restart-on-end), iterator/WeightedRandomWalkIterator.java (edge-weight
proportional transitions), NoEdgeHandling modes.
"""
from __future__ import annotations

from typing import Iterable, Iterator, List, Tuple

import numpy as np


class Graph:
    """Directed or undirected adjacency-list graph with optional edge
    weights (reference graph/Graph.java). Vertices are 0..n-1."""

    def __init__(self, n_vertices: int, directed: bool = False):
        self.n = n_vertices
        self.directed = directed
        self._adj: List[List[int]] = [[] for _ in range(n_vertices)]
        self._w: List[List[float]] = [[] for _ in range(n_vertices)]

    def add_edge(self, a: int, b: int, weight: float = 1.0):
        self._adj[a].append(b)
        self._w[a].append(weight)
        if not self.directed:
            self._adj[b].append(a)
            self._w[b].append(weight)
        return self

    def add_edges(self, edges: Iterable[Tuple[int, int]]):
        for e in edges:
            self.add_edge(*e)
        return self

    def num_vertices(self) -> int:
        return self.n

    def degree(self, v: int) -> int:
        return len(self._adj[v])

    def neighbors(self, v: int) -> List[int]:
        return list(self._adj[v])

    def weights(self, v: int) -> List[float]:
        return list(self._w[v])


class RandomWalkIterator:
    """Uniform random walks of fixed length from every vertex (reference
    iterator/RandomWalkIterator.java). ``no_edge_handling``:
    'self_loop' (stay put, the reference's SELF_LOOP_ON_DISCONNECTED) or
    'cutoff' (truncate the walk, EXCEPTION_ON_DISCONNECTED is not useful
    here)."""

    def __init__(self, graph: Graph, walk_length: int, seed: int = 123,
                 no_edge_handling: str = "self_loop",
                 weighted: bool = False):
        self.graph = graph
        self.walk_length = walk_length
        self.seed = seed
        self.no_edge_handling = no_edge_handling
        self.weighted = weighted
        self._epoch = 0

    def __iter__(self) -> Iterator[List[int]]:
        rng = np.random.default_rng(self.seed + self._epoch)
        self._epoch += 1
        order = rng.permutation(self.graph.n)
        for start in order:
            walk = [int(start)]
            cur = int(start)
            for _ in range(self.walk_length):
                nbrs = self.graph._adj[cur]
                if not nbrs:
                    if self.no_edge_handling == "self_loop":
                        walk.append(cur)
                        continue
                    break   # cutoff
                if self.weighted:
                    w = np.asarray(self.graph._w[cur], np.float64)
                    cur = int(rng.choice(nbrs, p=w / w.sum()))
                else:
                    cur = int(nbrs[rng.integers(0, len(nbrs))])
                walk.append(cur)
            yield walk

    def reset(self):
        pass


class WeightedRandomWalkIterator(RandomWalkIterator):
    """Edge-weight-proportional walks (reference
    WeightedRandomWalkIterator.java)."""

    def __init__(self, graph: Graph, walk_length: int, seed: int = 123,
                 no_edge_handling: str = "self_loop"):
        super().__init__(graph, walk_length, seed, no_edge_handling,
                         weighted=True)
