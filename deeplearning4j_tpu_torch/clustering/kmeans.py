"""K-means clustering.

Counterpart of ``deeplearning4j_tpu/clustering/kmeans.py``. The
assignment and centroid update (the reference's jitted step, ``:39-50``)
is ``kmeans_step``: plain tensor functions on the points' device (the
model's ``device``, ``device.py`` ``resolve_device``: the card unless the
caller names another). The host keeps the reference's draws (the initial
centroids from ``np.random.default_rng(seed).choice``) and its loop, which
reads the shift back once an iteration to test convergence.

The distance is the reference's formula, the sum over D of squared
differences; the expansion |x|^2 - 2 x.c + |c|^2 rounds differently and
can move an argmin to another centroid. The reference broadcasts
[N, k, D] at once; ``kmeans_step`` takes the same formula over chunks of
at most ``CHUNK_ELEMENTS`` elements, so memory follows the chunk, not N.
``argmin`` takes the first index on a tie, as the reference's does.

Reference: nearestneighbor-core clustering/kmeans/KMeansClustering.java +
the generic BaseClusteringAlgorithm strategy/condition machinery.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device

# one chunk's [rows, k, D] differences (256 MB of float32): smaller chunks
# made an iteration slower on an H100 (more, shorter launches) and on its
# host alike, at N 100,000, k 100, D 128
CHUNK_ELEMENTS = 1 << 26


def assign_points(pts: torch.Tensor, cents: torch.Tensor) -> torch.Tensor:
    """The index of each point's nearest centroid by the summed squared
    differences (first index on a tie), over chunks of rows."""
    k, d = cents.shape
    rows = max(1, CHUNK_ELEMENTS // max(1, k * d))
    # squared in place: the same products as ``** 2``, one buffer a chunk
    out = [(pts[i:i + rows, None, :] - cents[None, :, :]).square_()
           .sum(-1).argmin(1) for i in range(0, pts.shape[0], rows)]
    return torch.cat(out)


def kmeans_step(pts: torch.Tensor, cents: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One iteration (reference ``step``, ``:39-50``): assign, then each
    centroid to its points' mean (a centroid with no point stays). Returns
    (new centroids, assignment, the largest centroid shift as a device
    scalar)."""
    assign = assign_points(pts, cents)
    one_hot = torch.nn.functional.one_hot(assign, k).to(pts.dtype)
    counts = one_hot.sum(0)
    sums = one_hot.T @ pts
    new_cents = torch.where(counts[:, None] > 0,
                            sums / torch.clamp_min(counts[:, None], 1.0),
                            cents)
    shift = torch.linalg.vector_norm(new_cents - cents, dim=-1).max()
    return new_cents, assign, shift


class KMeansClustering:
    def __init__(self, k: int, max_iterations: int = 100, tol: float = 1e-4,
                 metric: str = "euclidean", seed: int = 0,
                 device: DeviceLike = None):
        self.k = k
        self.max_iterations = max_iterations
        self.tol = tol
        self.metric = metric
        self.seed = seed
        self.device = device
        self.centroids: Optional[np.ndarray] = None

    def fit(self, points: np.ndarray) -> "KMeansClustering":
        dev = resolve_device(self.device)
        pts = torch.from_numpy(np.ascontiguousarray(points, np.float32)).to(dev)
        n = pts.shape[0]
        rng = np.random.default_rng(self.seed)
        # k-means++ style init: random distinct points
        init_idx = rng.choice(n, size=self.k, replace=False)
        cents = pts[torch.from_numpy(init_idx).to(dev)]
        assign = None
        for _ in range(self.max_iterations):
            cents, assign, shift = kmeans_step(pts, cents, self.k)
            if float(shift) < self.tol:      # the loop's one host read
                break
        self.centroids = cents.cpu().numpy()
        self.labels_ = None if assign is None else assign.cpu().numpy()
        return self

    def predict(self, points: np.ndarray) -> np.ndarray:
        d = ((np.asarray(points)[:, None, :] - self.centroids[None]) ** 2).sum(-1)
        return d.argmin(1)
