"""t-SNE embedding.

Counterpart of ``deeplearning4j_tpu/clustering/tsne.py``. ``Tsne`` is the
exact O(N^2) formulation: the affinities P are computed once on the host
in float64 (the reference's formula; its [N, N, D] broadcast at ``:71``
is taken here over blocks of rows, ``_squared_distances``, which gives the
same values), the beta search stays numpy, and the gradient step
(reference ``:83-102``) is ``tsne_step`` on the model's ``device``
(``device.py`` ``resolve_device``: the card unless the caller names
another): ``torch.autograd.grad`` of the reference's KL expression, the
same gains, momentum, early exaggeration and learning-rate schedule.
``BarnesHutTsne`` is the reference's host-side numpy, copied.

Reference: deeplearning4j-core plot/Tsne.java (exact) and
plot/BarnesHutTsne.java:65 (O(N log N) via SpTree).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device

BLOCK_ELEMENTS = 1 << 20      # float64 differences in one block of rows (8 MB)


def _beta_search_row(d2: np.ndarray, log_target: float, tol=1e-5,
                     max_iter=50) -> np.ndarray:
    """Bisection on precision beta for ONE point's squared distances until
    the conditional distribution's entropy hits ``log_target``; returns the
    normalized row (the classic van der Maaten x2p inner loop, shared by the
    dense and sparse/Barnes-Hut paths)."""
    beta, betamin, betamax = 1.0, -np.inf, np.inf
    for _ in range(max_iter):
        Pi = np.exp(-d2 * beta)
        sum_p = max(Pi.sum(), 1e-12)
        H = np.log(sum_p) + beta * (d2 * Pi).sum() / sum_p
        diff = H - log_target
        if abs(diff) < tol:
            break
        if diff > 0:
            betamin = beta
            beta = beta * 2 if betamax == np.inf else (beta + betamax) / 2
        else:
            betamax = beta
            beta = beta / 2 if betamin == -np.inf else (beta + betamin) / 2
    Pi = np.exp(-d2 * beta)       # row at the final beta
    return Pi / max(Pi.sum(), 1e-12)


def _binary_search_perplexity(D, perplexity, tol=1e-5, max_iter=50):
    """Per-point beta search for target perplexity (host-side, once)."""
    n = D.shape[0]
    P = np.zeros_like(D)
    log_u = np.log(perplexity)
    for i in range(n):
        P[i, np.arange(n) != i] = _beta_search_row(np.delete(D[i], i), log_u,
                                                   tol, max_iter)
    return P


def _squared_distances(X: np.ndarray) -> np.ndarray:
    """``((X[:, None] - X[None]) ** 2).sum(-1)`` in float64 over blocks of
    rows: each entry is summed over D exactly as the whole broadcast sums
    it, so the result is the reference's bit for bit."""
    n, d = X.shape
    rows = max(1, BLOCK_ELEMENTS // max(1, n * d))
    out = np.empty((n, n), np.float64)
    for i in range(0, n, rows):
        out[i:i + rows] = ((X[i:i + rows, None] - X[None]) ** 2).sum(-1)
    return out


def _kl(Y: torch.Tensor, P: torch.Tensor) -> torch.Tensor:
    """The reference's objective (``:86-91``): KL(P || Q) under the
    Student-t kernel, the diagonal masked out, Q clamped at 1e-12."""
    d = ((Y[:, None] - Y[None]) ** 2).sum(-1)
    num = 1.0 / (1.0 + d)
    num = num * (1 - torch.eye(Y.shape[0], dtype=Y.dtype, device=Y.device))
    Q = torch.clamp_min(num / num.sum(), 1e-12)
    return (P * (torch.log(P) - torch.log(Q))).sum()


def tsne_step(Y, vel, gains, P, lr, mom):
    """One gradient step (reference ``step``, ``:83-102``): the KL's
    gradient, Jacobs adaptive gains, momentum, then Y re-centred. Returns
    (Y, vel, gains)."""
    with torch.enable_grad():
        Yg = Y.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(_kl(Yg, P), Yg)
    same_sign = (g * vel) > 0
    gains = torch.clamp_min(torch.where(same_sign, gains * 0.8, gains + 0.2),
                            0.01)
    vel = mom * vel - lr * gains * g
    Y = Y + vel
    return Y - Y.mean(0), vel, gains


class Tsne:
    def __init__(self, n_components: int = 2, perplexity: float = 30.0,
                 learning_rate: Optional[float] = None, n_iter: int = 500,
                 momentum: float = 0.8, early_exaggeration: float = 12.0,
                 seed: int = 0, device: DeviceLike = None):
        self.n_components = n_components
        self.perplexity = perplexity
        self.learning_rate = learning_rate
        self.n_iter = n_iter
        self.momentum = momentum
        self.early_exaggeration = early_exaggeration
        self.seed = seed
        self.device = device

    def _affinities(self, X: np.ndarray) -> np.ndarray:
        """The symmetric joint P, float64, on the host (reference
        ``:69-74``)."""
        n = X.shape[0]
        D = _squared_distances(X)
        P = _binary_search_perplexity(D, min(self.perplexity, (n - 1) / 3))
        P = (P + P.T) / (2 * n)
        return np.maximum(P, 1e-12)

    def fit_transform(self, X: np.ndarray) -> np.ndarray:
        dev = resolve_device(self.device)
        X = np.asarray(X, np.float64)
        n = X.shape[0]
        P = self._affinities(X)
        rng = np.random.default_rng(self.seed)
        Y = torch.from_numpy(rng.normal(0, 1e-4, (n, self.n_components))
                             .astype(np.float32)).to(dev)
        Pt = torch.from_numpy(P.astype(np.float32)).to(dev)
        # auto LR ~ n / (4 * early_exaggeration) with a small-n floor;
        # combined with the adaptive gains this is stable across sizes
        lr = self.learning_rate or max(n / self.early_exaggeration / 4.0, 10.0)
        vel = torch.zeros_like(Y)
        gains = torch.ones_like(Y)
        for i in range(self.n_iter):
            exag = self.early_exaggeration if i < 100 else 1.0
            mom = 0.5 if i < 100 else self.momentum
            Y, vel, gains = tsne_step(Y, vel, gains, Pt * exag, lr, mom)
        return Y.cpu().numpy()


class BarnesHutTsne(Tsne):
    """O(N log N) Barnes-Hut t-SNE (reference plot/BarnesHutTsne.java:65 —
    VPTree for the sparse input neighbourhoods, SpTree for the approximate
    repulsive forces with accuracy knob ``theta``).

    Host-side numpy by design (a copy of the reference's): the tree walk is
    pointer-chasing the device cannot help with. For N <= ~10k the exact
    ``Tsne`` on the device is the dense alternative; this class is for the
    larger-N regime and reference parity.
    """

    def __init__(self, *args, theta: float = 0.5, **kwargs):
        super().__init__(*args, **kwargs)
        self.theta = theta

    def _sparse_affinities(self, X):
        from .vptree import VPTree
        n = X.shape[0]
        k = min(n - 1, max(3, int(3 * self.perplexity)))
        tree = VPTree(X)
        rows = np.empty((n, k), np.int64)
        dists = np.empty((n, k), np.float64)
        for i in range(n):
            idxs, ds = tree.knn(X[i], k + 1)
            pairs = [(j, d) for j, d in zip(idxs, ds) if j != i][:k]
            rows[i] = [j for j, _ in pairs]
            dists[i] = [d for _, d in pairs]
        # per-point beta search on the k squared distances (shared helper
        # with the dense path)
        P = np.zeros((n, k))
        target = np.log(min(self.perplexity, (n - 1) / 3.0))
        for i in range(n):
            P[i] = _beta_search_row(dists[i] ** 2, target)
        # symmetrize the sparse matrix: COO (i, rows[i,j]) entries
        src = np.repeat(np.arange(n), k)
        dst = rows.reshape(-1)
        val = P.reshape(-1)
        # P_sym[i,j] = (P[i,j] + P[j,i]) / (2n) over the union of supports
        both = {}
        for s, d, v in zip(src, dst, val):
            both[(s, d)] = both.get((s, d), 0.0) + v
            both[(d, s)] = both.get((d, s), 0.0) + 0.0
        coo_i = np.fromiter((ij[0] for ij in both), np.int64, len(both))
        coo_j = np.fromiter((ij[1] for ij in both), np.int64, len(both))
        coo_v = np.fromiter(
            ((both[(i, j)] + both.get((j, i), 0.0)) / (2.0 * n)
             for i, j in zip(coo_i, coo_j)), np.float64, len(both))
        coo_v = np.maximum(coo_v, 1e-12)
        return coo_i, coo_j, coo_v

    def fit_transform(self, X: np.ndarray) -> np.ndarray:
        from .trees import SpTree
        X = np.asarray(X, np.float64)
        n = X.shape[0]
        ci, cj, cv = self._sparse_affinities(X)
        rng = np.random.default_rng(self.seed)
        Y = rng.normal(0, 1e-4, (n, self.n_components))
        vel = np.zeros_like(Y)
        gains = np.ones_like(Y)
        lr = self.learning_rate or max(n / self.early_exaggeration / 4.0, 10.0)
        for it in range(self.n_iter):
            exag = self.early_exaggeration if it < 100 else 1.0
            mom = 0.5 if it < 100 else self.momentum
            # attractive: sum_j p_ij q_ij (y_i - y_j), vectorized over COO
            diff = Y[ci] - Y[cj]
            q = 1.0 / (1.0 + np.sum(diff * diff, axis=1))
            w = (exag * cv) * q
            attr = np.zeros_like(Y)
            np.add.at(attr, ci, w[:, None] * diff)
            # repulsive via Barnes-Hut tree (reference computeNonEdgeForces)
            tree = SpTree.build(Y)
            rep = np.zeros_like(Y)
            z = 0.0
            for i in range(n):
                neg = np.zeros(self.n_components)
                z += tree.compute_non_edge_forces(Y[i], self.theta, neg)
                rep[i] = neg
            g = 4.0 * (attr - rep / max(z, 1e-12))
            same_sign = (g * vel) > 0
            gains = np.clip(np.where(same_sign, gains * 0.8, gains + 0.2),
                            0.01, None)
            vel = mom * vel - lr * gains * g
            Y = Y + vel
            Y -= Y.mean(0)
        return Y
