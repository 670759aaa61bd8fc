"""VP-tree nearest-neighbor search.

A copy of ``deeplearning4j_tpu/clustering/vptree.py`` (numpy only):
the same tree from the same seed, the same answers.

Reference: deeplearning4j-nearestneighbors-parent nearestneighbor-core
clustering/vptree/VPTree.java:49 — vantage-point tree for metric kNN.
Host-side numpy (tree search is pointer-chasing); the distances are
vectorized.
"""
from __future__ import annotations

import heapq
from typing import List, Optional, Tuple

import numpy as np


class _Node:
    __slots__ = ("index", "threshold", "left", "right")

    def __init__(self, index):
        self.index = index
        self.threshold = 0.0
        self.left: Optional[_Node] = None
        self.right: Optional[_Node] = None


def _distances(points, x, metric):
    if metric == "euclidean":
        return np.linalg.norm(points - x, axis=-1)
    if metric == "cosine":
        num = points @ x
        den = np.linalg.norm(points, axis=-1) * np.linalg.norm(x)
        return 1.0 - num / np.maximum(den, 1e-12)
    if metric == "manhattan":
        return np.abs(points - x).sum(-1)
    raise ValueError(f"Unknown metric {metric!r}")


class VPTree:
    def __init__(self, points: np.ndarray, metric: str = "euclidean", seed: int = 0):
        self.points = np.asarray(points, np.float64)
        self.metric = metric
        self._rng = np.random.default_rng(seed)
        idxs = list(range(len(self.points)))
        self.root = self._build(idxs)

    def _build(self, idxs: List[int]) -> Optional[_Node]:
        if not idxs:
            return None
        vp_pos = self._rng.integers(len(idxs))
        vp = idxs[vp_pos]
        rest = idxs[:vp_pos] + idxs[vp_pos + 1:]
        node = _Node(vp)
        if not rest:
            return node
        d = _distances(self.points[rest], self.points[vp], self.metric)
        median = float(np.median(d))
        node.threshold = median
        inner = [r for r, dd in zip(rest, d) if dd <= median]
        outer = [r for r, dd in zip(rest, d) if dd > median]
        node.left = self._build(inner)
        node.right = self._build(outer)
        return node

    def knn(self, x, k: int = 1) -> Tuple[List[int], List[float]]:
        """Reference VPTree.search: indices + distances of k nearest."""
        x = np.asarray(x, np.float64)
        heap: List[Tuple[float, int]] = []   # max-heap via negated distance
        tau = [np.inf]

        def search(node):
            if node is None:
                return
            d = float(_distances(self.points[node.index][None], x, self.metric)[0])
            if len(heap) < k:
                heapq.heappush(heap, (-d, node.index))
                if len(heap) == k:
                    tau[0] = -heap[0][0]
            elif d < tau[0]:
                heapq.heapreplace(heap, (-d, node.index))
                tau[0] = -heap[0][0]
            if node.left is None and node.right is None:
                return
            if d <= node.threshold:
                search(node.left)
                if d + tau[0] > node.threshold:
                    search(node.right)
            else:
                search(node.right)
                if d - tau[0] <= node.threshold:
                    search(node.left)

        search(self.root)
        pairs = sorted(((-nd, i) for nd, i in heap))
        return [i for _, i in pairs], [d for d, _ in pairs]
