"""EvaluationBinary + EvaluationCalibration.

A copy of ``deeplearning4j_tpu/eval/binary.py`` (numpy only, no JAX): the
port's networks hand it their outputs as numpy arrays.

Reference: eval/EvaluationBinary.java (567 LoC — per-output-label binary
counts for multi-label sigmoid networks, threshold 0.5 default or per-label
custom, accuracy/precision/recall/f1/MCC per label, stats table) and
eval/EvaluationCalibration.java (407 LoC — reliability diagram bins,
residual-plot + probability histograms, per-class calibration curves).
"""
from __future__ import annotations

import math
from typing import List, Optional

import numpy as np


class EvaluationBinary:
    """Per-output independent binary evaluation (multi-label networks with
    sigmoid outputs). Counts TP/FP/TN/FN per output column, honoring an
    optional [N, L] mask (reference EvaluationBinary.eval :  masked
    per-label counting)."""

    def __init__(self, n_labels: Optional[int] = None,
                 decision_threshold=None, label_names: Optional[List[str]] = None):
        self.n = n_labels
        self.threshold = decision_threshold     # scalar or [L] array or None->0.5
        self.label_names = label_names
        self.tp = self.fp = self.tn = self.fn = None

    def _ensure(self, n_labels):
        if self.tp is None:
            self.n = n_labels
            z = np.zeros(n_labels, np.int64)
            self.tp, self.fp, self.tn, self.fn = z.copy(), z.copy(), z.copy(), z.copy()
        elif self.n != n_labels:
            raise ValueError(f"Label count changed: {self.n} vs {n_labels}")

    def eval(self, labels, predictions, mask=None):
        labels = np.asarray(labels)
        predictions = np.asarray(predictions)
        if labels.ndim == 3:     # time series: flatten [B,T,L] -> [B*T,L]
            B, T, L = labels.shape
            labels = labels.reshape(-1, L)
            predictions = predictions.reshape(-1, L)
            if mask is not None:
                mask = np.asarray(mask)
                if mask.shape[:2] != (B, T) or mask.ndim not in (2, 3) or \
                        (mask.ndim == 3 and mask.shape[-1] not in (1, L)):
                    raise ValueError(
                        f"time-series mask must be [B,T]={B, T}, [B,T,1] or "
                        f"[B,T,{L}]; got shape {mask.shape}")
                if mask.ndim == 2 or mask.shape[-1] == 1:
                    # [B,T] or [B,T,1]: one flag per time step
                    mask = mask.reshape(-1)[:, None]
                else:
                    mask = mask.reshape(-1, L)   # [B,T,L] per-label mask
        self._ensure(labels.shape[-1])
        thr = 0.5 if self.threshold is None else np.asarray(self.threshold)
        pred = (predictions > thr).astype(np.int8)
        lab = (labels > 0.5).astype(np.int8)
        m = np.ones_like(lab, np.bool_)
        if mask is not None:
            m = np.broadcast_to(np.asarray(mask) > 0, lab.shape)
        self.tp += ((pred == 1) & (lab == 1) & m).sum(0)
        self.fp += ((pred == 1) & (lab == 0) & m).sum(0)
        self.tn += ((pred == 0) & (lab == 0) & m).sum(0)
        self.fn += ((pred == 0) & (lab == 1) & m).sum(0)

    # ---- per-label metrics (reference naming) ----
    def total_count(self, i):
        return int(self.tp[i] + self.fp[i] + self.tn[i] + self.fn[i])

    def accuracy(self, i: int) -> float:
        t = self.total_count(i)
        return float((self.tp[i] + self.tn[i]) / t) if t else 0.0

    def precision(self, i: int) -> float:
        d = self.tp[i] + self.fp[i]
        return float(self.tp[i] / d) if d else 0.0

    def recall(self, i: int) -> float:
        d = self.tp[i] + self.fn[i]
        return float(self.tp[i] / d) if d else 0.0

    def f1(self, i: int) -> float:
        p, r = self.precision(i), self.recall(i)
        return 2 * p * r / (p + r) if (p + r) else 0.0

    def matthews_correlation(self, i: int) -> float:
        tp, fp, tn, fn = (float(v[i]) for v in (self.tp, self.fp, self.tn, self.fn))
        denom = math.sqrt((tp + fp) * (tp + fn) * (tn + fp) * (tn + fn))
        return ((tp * tn - fp * fn) / denom) if denom else 0.0

    def average_accuracy(self) -> float:
        return float(np.mean([self.accuracy(i) for i in range(self.n)]))

    def average_f1(self) -> float:
        return float(np.mean([self.f1(i) for i in range(self.n)]))

    def merge(self, other: "EvaluationBinary"):
        if other.tp is None:
            return self
        if self.tp is None:
            self._ensure(other.n)
        self.tp += other.tp
        self.fp += other.fp
        self.tn += other.tn
        self.fn += other.fn
        return self

    def stats(self) -> str:
        names = self.label_names or [f"label_{i}" for i in range(self.n or 0)]
        lines = [f"{'Label':<16}{'Acc':>8}{'Prec':>8}{'Rec':>8}{'F1':>8}"
                 f"{'MCC':>8}{'Count':>8}"]
        for i in range(self.n or 0):
            lines.append(f"{names[i]:<16}{self.accuracy(i):>8.4f}"
                         f"{self.precision(i):>8.4f}{self.recall(i):>8.4f}"
                         f"{self.f1(i):>8.4f}{self.matthews_correlation(i):>8.4f}"
                         f"{self.total_count(i):>8d}")
        return "\n".join(lines)


class EvaluationCalibration:
    """Reliability diagram + residual/probability histograms (reference
    EvaluationCalibration.java: reliabilityDiagramNumBins counts of predicted
    probability vs observed frequency per class)."""

    def __init__(self, reliability_bins: int = 10, histogram_bins: int = 10):
        self.rbins = reliability_bins
        self.hbins = histogram_bins
        self._bin_counts = None      # [C, rbins] predictions per bin
        self._bin_pos = None         # [C, rbins] positives per bin
        self._bin_prob_sum = None    # [C, rbins] sum of predicted prob
        self._residual_counts = np.zeros(histogram_bins, np.int64)
        self._prob_counts = None     # [C, hbins]

    def _ensure(self, c):
        if self._bin_counts is None:
            self._bin_counts = np.zeros((c, self.rbins), np.int64)
            self._bin_pos = np.zeros((c, self.rbins), np.int64)
            self._bin_prob_sum = np.zeros((c, self.rbins), np.float64)
            self._prob_counts = np.zeros((c, self.hbins), np.int64)

    def eval(self, labels, predictions):
        labels = np.asarray(labels)
        p = np.asarray(predictions, np.float64)
        if labels.ndim == 3:
            labels = labels.reshape(-1, labels.shape[-1])
            p = p.reshape(-1, p.shape[-1])
        c = labels.shape[-1]
        self._ensure(c)
        bin_idx = np.clip((p * self.rbins).astype(np.int64), 0, self.rbins - 1)
        hist_idx = np.clip((p * self.hbins).astype(np.int64), 0, self.hbins - 1)
        pos = labels > 0.5
        for ci in range(c):
            np.add.at(self._bin_counts[ci], bin_idx[:, ci], 1)
            np.add.at(self._bin_pos[ci], bin_idx[:, ci], pos[:, ci])
            np.add.at(self._bin_prob_sum[ci], bin_idx[:, ci], p[:, ci])
            np.add.at(self._prob_counts[ci], hist_idx[:, ci], 1)
        # residual histogram: |label - p| over all entries (reference
        # residualPlot)
        resid = np.abs(labels.astype(np.float64) - p).reshape(-1)
        ridx = np.clip((resid * self.hbins).astype(np.int64), 0, self.hbins - 1)
        np.add.at(self._residual_counts, ridx, 1)

    def reliability_diagram(self, cls: int):
        """(mean predicted prob per bin, observed positive fraction per bin,
        bin counts) — the curve should hug y=x for a calibrated model."""
        counts = self._bin_counts[cls]
        safe = np.maximum(counts, 1)
        mean_pred = self._bin_prob_sum[cls] / safe
        frac_pos = self._bin_pos[cls] / safe
        return mean_pred, frac_pos, counts.copy()

    def expected_calibration_error(self, cls: int) -> float:
        mean_pred, frac_pos, counts = self.reliability_diagram(cls)
        total = counts.sum()
        if total == 0:
            return 0.0
        return float(np.sum(counts / total * np.abs(mean_pred - frac_pos)))

    def residual_plot(self):
        edges = np.linspace(0.0, 1.0, self.hbins + 1)
        return edges, self._residual_counts.copy()

    def probability_histogram(self, cls: int):
        edges = np.linspace(0.0, 1.0, self.hbins + 1)
        return edges, self._prob_counts[cls].copy()
