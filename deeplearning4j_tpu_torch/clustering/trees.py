"""Spatial trees: KDTree, QuadTree, SpTree.

A copy of ``deeplearning4j_tpu/clustering/trees.py`` (numpy only):
the same trees, the same answers.

Reference: deeplearning4j-nearestneighbors-parent/nearestneighbor-core —
clustering/kdtree/KDTree.java (insert/nn/knn over HyperRects),
clustering/quadtree/QuadTree.java (2-D Barnes-Hut cells),
clustering/sptree/SpTree.java (n-D dual-tree with center-of-mass, the
Barnes-Hut t-SNE backbone: computeNonEdgeForces / computeEdgeForces).

These are host-side pointer structures by nature (the reference's are too);
the device's share of clustering is the dense distance work in kmeans.py and
tsne.py — the trees exist for the O(N log N) regime and for Barnes-Hut
t-SNE (``tsne.py`` ``BarnesHutTsne``).
"""
from __future__ import annotations

import heapq
from typing import List, Optional, Tuple

import numpy as np


# ---------------------------------------------------------------------- KDTree
class _KDNode:
    __slots__ = ("idx", "left", "right")

    def __init__(self, idx: int):
        self.idx = idx
        self.left: Optional["_KDNode"] = None
        self.right: Optional["_KDNode"] = None


class KDTree:
    """k-d tree (reference clustering/kdtree/KDTree.java): median build,
    insert, nearest-neighbour and k-NN queries, Euclidean metric."""

    def __init__(self, points: Optional[np.ndarray] = None, dims: Optional[int] = None):
        if points is not None:
            points = np.asarray(points, np.float64)
            self.dims = points.shape[1]
            # keep ORIGINAL indices: store all points up front, link nodes in
            # median-first order for balance
            self._points: List[np.ndarray] = [p for p in points]
            self.root: Optional[_KDNode] = None
            for i in self._median_order(np.arange(len(points)), points, 0):
                self._link(_KDNode(int(i)))
        else:
            if dims is None:
                raise ValueError("Provide points or dims")
            self.dims = dims
            self._points = []
            self.root = None

    def _median_order(self, idxs, points, depth) -> List[int]:
        """Median-first insertion order -> balanced tree from a batch."""
        if len(idxs) == 0:
            return []
        axis = depth % points.shape[1]
        order = idxs[np.argsort(points[idxs, axis], kind="stable")]
        mid = len(order) // 2
        return ([order[mid]]
                + self._median_order(order[:mid], points, depth + 1)
                + self._median_order(order[mid + 1:], points, depth + 1))

    def __len__(self):
        return len(self._points)

    def insert(self, point) -> int:
        point = np.asarray(point, np.float64).reshape(-1)
        if point.shape[0] != self.dims:
            raise ValueError(f"Expected {self.dims}-d point, got {point.shape}")
        idx = len(self._points)
        self._points.append(point)
        self._link(_KDNode(idx))
        return idx

    def _link(self, node: _KDNode):
        point = self._points[node.idx]
        if self.root is None:
            self.root = node
            return
        cur, depth = self.root, 0
        while True:
            axis = depth % self.dims
            if point[axis] < self._points[cur.idx][axis]:
                if cur.left is None:
                    cur.left = node
                    return
                cur = cur.left
            else:
                if cur.right is None:
                    cur.right = node
                    return
                cur = cur.right
            depth += 1

    def nn(self, point) -> Tuple[int, float]:
        idxs, dists = self.knn(point, 1)
        return idxs[0], dists[0]

    def knn(self, point, k: int) -> Tuple[List[int], List[float]]:
        point = np.asarray(point, np.float64).reshape(-1)
        heap: List[Tuple[float, int]] = []   # max-heap via negated distance

        def visit(node, depth):
            if node is None:
                return
            p = self._points[node.idx]
            d = float(np.linalg.norm(p - point))
            if len(heap) < k:
                heapq.heappush(heap, (-d, node.idx))
            elif d < -heap[0][0]:
                heapq.heapreplace(heap, (-d, node.idx))
            axis = depth % self.dims
            diff = point[axis] - p[axis]
            near, far = (node.left, node.right) if diff < 0 else (node.right, node.left)
            visit(near, depth + 1)
            if len(heap) < k or abs(diff) < -heap[0][0]:
                visit(far, depth + 1)

        visit(self.root, 0)
        pairs = sorted(((-nd, i) for nd, i in heap))
        return [i for _, i in pairs], [d for d, _ in pairs]


# --------------------------------------------------------------------- SpTree
class SpTree:
    """n-dimensional space-partitioning tree with centers of mass (reference
    clustering/sptree/SpTree.java — the Barnes-Hut backbone). QuadTree is the
    2-D special case (2^d children = 4)."""

    __slots__ = ("center", "width", "n_dims", "cum_center", "count",
                 "point", "point_index", "children", "capacity_leaf")

    def __init__(self, center: np.ndarray, width: np.ndarray):
        self.center = np.asarray(center, np.float64)
        self.width = np.asarray(width, np.float64)
        self.n_dims = self.center.shape[0]
        self.cum_center = np.zeros(self.n_dims)
        self.count = 0
        self.point: Optional[np.ndarray] = None
        self.point_index: int = -1
        self.children: Optional[List[Optional["SpTree"]]] = None

    # ---- construction ----
    @staticmethod
    def build(points: np.ndarray) -> "SpTree":
        points = np.asarray(points, np.float64)
        lo, hi = points.min(0), points.max(0)
        center = (lo + hi) / 2
        width = np.maximum((hi - lo) / 2 + 1e-5, 1e-5)
        tree = SpTree(center, width)
        for i, p in enumerate(points):
            tree.insert(p, i)
        return tree

    def _child_index(self, point) -> int:
        idx = 0
        for d in range(self.n_dims):
            if point[d] > self.center[d]:
                idx |= (1 << d)
        return idx

    def insert(self, point: np.ndarray, index: int):
        point = np.asarray(point, np.float64)
        self.cum_center += point
        self.count += 1
        if self.count == 1:
            self.point = point.copy()
            self.point_index = index
            return
        if self.children is None:
            # split: push existing point down (duplicate points accumulate in
            # the same cell chain; cap recursion by merging exact duplicates)
            if self.point is not None and np.allclose(self.point, point,
                                                      atol=1e-12):
                return     # duplicate: mass already counted in cum_center
            self.children = [None] * (1 << self.n_dims)
            if self.point is not None:
                self._insert_child(self.point, self.point_index)
                self.point = None
        self._insert_child(point, index)

    def _insert_child(self, point, index):
        ci = self._child_index(point)
        if self.children[ci] is None:
            offset = np.where(
                [(ci >> d) & 1 for d in range(self.n_dims)],
                self.width / 2, -self.width / 2)
            self.children[ci] = SpTree(self.center + offset, self.width / 2)
        self.children[ci].insert(point, index)

    # ---- Barnes-Hut force (reference SpTree.computeNonEdgeForces) ----
    def compute_non_edge_forces(self, point: np.ndarray, theta: float,
                                neg_f: np.ndarray) -> float:
        """Accumulate repulsive force for ``point`` into ``neg_f`` and return
        the partial sum_Z contribution (t-SNE Student-t kernel)."""
        if self.count == 0:
            return 0.0
        com = self.cum_center / self.count
        diff = point - com
        dist2 = float(diff @ diff)
        max_width = float(self.width.max() * 2)
        is_self_leaf = (self.count == 1 and self.point is not None
                        and np.allclose(self.point, point, atol=1e-12))
        if is_self_leaf:
            return 0.0
        if self.children is None or (dist2 > 0 and
                                     max_width * max_width / dist2 < theta * theta):
            q = 1.0 / (1.0 + dist2)
            mult = self.count * q
            neg_f += mult * q * diff
            return mult
        z = 0.0
        for ch in self.children:
            if ch is not None:
                z += ch.compute_non_edge_forces(point, theta, neg_f)
        return z


class QuadTree(SpTree):
    """2-D SpTree (reference clustering/quadtree/QuadTree.java)."""

    def __init__(self, center=None, width=None):
        if center is None:
            center, width = np.zeros(2), np.ones(2)
        center = np.asarray(center, np.float64)
        if center.shape[0] != 2:
            raise ValueError("QuadTree is strictly 2-D; use SpTree otherwise")
        super().__init__(center, width)

    @staticmethod
    def build(points: np.ndarray) -> "QuadTree":
        points = np.asarray(points, np.float64)
        if points.shape[1] != 2:
            raise ValueError("QuadTree is strictly 2-D; use SpTree otherwise")
        lo, hi = points.min(0), points.max(0)
        tree = QuadTree((lo + hi) / 2, np.maximum((hi - lo) / 2 + 1e-5, 1e-5))
        for i, p in enumerate(points):
            tree.insert(p, i)
        return tree
