"""Time-series utilities and Viterbi decoding, on the host in numpy.

A copy of ``deeplearning4j_tpu/util/timeseries.py``, which imports no
framework: ``moving_average``, the [B,T,F] <-> [B*T,F] reshapes, the mask
reshapes and ``Viterbi`` (the most likely state sequence of a metastable
chain). Inside a network the preprocessors do these reshapes on tensors;
these are the host-side helpers users of the reference reach for.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


# ---------------------------------------------------------- TimeSeriesUtils
def moving_average(x: np.ndarray, n: int) -> np.ndarray:
    """Trailing n-point moving average along the last axis (reference
    TimeSeriesUtils.movingAverage): output length = len - n + 1."""
    x = np.asarray(x, np.float64)
    c = np.cumsum(np.concatenate([[0.0], x], axis=-1), axis=-1)
    return (c[..., n:] - c[..., :-n]) / n


def reshape_3d_to_2d(x: np.ndarray) -> np.ndarray:
    """[B,T,F] -> [B*T,F] (reference reshape3dTo2d; NHWC-style time-major
    flattening per example)."""
    b, t, f = x.shape
    return np.asarray(x).reshape(b * t, f)


def reshape_2d_to_3d(x: np.ndarray, minibatch_size: int) -> np.ndarray:
    """[B*T,F] -> [B,T,F] (reference reshape2dTo3d)."""
    n, f = x.shape
    if n % minibatch_size:
        raise ValueError(f"rows {n} not divisible by minibatch {minibatch_size}")
    return np.asarray(x).reshape(minibatch_size, n // minibatch_size, f)


def reshape_time_series_mask_to_vector(mask: np.ndarray) -> np.ndarray:
    """[B,T] -> [B*T,1] (reference reshapeTimeSeriesMaskToVector)."""
    return np.asarray(mask).reshape(-1, 1)


def reshape_vector_to_time_series_mask(mask: np.ndarray,
                                       minibatch_size: int) -> np.ndarray:
    """[B*T,1] -> [B,T] (reference reshapeVectorToTimeSeriesMask)."""
    return np.asarray(mask).reshape(minibatch_size, -1)


# ------------------------------------------------------------------ Viterbi
class Viterbi:
    """Most-likely hidden state sequence for a metastable chain (reference
    nn/util/Viterbi.java): transition model = stay with probability
    ``meta_stability``, switch uniformly otherwise; emissions given as
    per-step label observations (index sequence or one-hot/probability rows).
    """

    def __init__(self, possible_labels: Sequence, meta_stability: float = 0.9):
        self.labels = list(possible_labels)
        self.states = len(self.labels)
        if not 0 < meta_stability < 1:
            raise ValueError("meta_stability must be in (0,1)")
        self.meta_stability = meta_stability
        s = self.states
        stay = np.log(meta_stability)
        switch = np.log((1.0 - meta_stability) / max(s - 1, 1))
        self._log_t = np.full((s, s), switch)
        np.fill_diagonal(self._log_t, stay)

    def decode(self, observations) -> Tuple[float, np.ndarray]:
        """observations: [T] state indices, or [T,S] one-hot / probability
        rows. Returns (log-likelihood, [T] decoded state indices)."""
        obs = np.asarray(observations)
        if obs.ndim == 1:
            probs = np.full((len(obs), self.states),
                            (1.0 - self.meta_stability) / max(self.states - 1, 1))
            probs[np.arange(len(obs)), obs.astype(int)] = self.meta_stability
        else:
            probs = np.clip(obs.astype(np.float64), 1e-12, None)
            probs = probs / probs.sum(-1, keepdims=True)
        log_e = np.log(probs)
        t_len = log_e.shape[0]
        delta = np.empty((t_len, self.states))
        psi = np.zeros((t_len, self.states), np.int64)
        delta[0] = -np.log(self.states) + log_e[0]
        for t in range(1, t_len):
            cand = delta[t - 1][:, None] + self._log_t   # [from, to]
            psi[t] = np.argmax(cand, axis=0)
            delta[t] = cand[psi[t], np.arange(self.states)] + log_e[t]
        path = np.empty(t_len, np.int64)
        path[-1] = int(np.argmax(delta[-1]))
        for t in range(t_len - 2, -1, -1):
            path[t] = psi[t + 1][path[t + 1]]
        return float(np.max(delta[-1])), path
