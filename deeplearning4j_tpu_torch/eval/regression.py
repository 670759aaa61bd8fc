"""Regression metrics per output column.

A copy of ``deeplearning4j_tpu/eval/regression.py`` (numpy only, no JAX): the
port's networks hand it their outputs as numpy arrays.

Reference: eval/RegressionEvaluation.java — MSE, MAE, RMSE, RSE (relative
squared error), correlation (Pearson), R^2.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np


class RegressionEvaluation:
    def __init__(self, column_names: Optional[List[str]] = None):
        self.column_names = column_names
        self._labels: List[np.ndarray] = []
        self._preds: List[np.ndarray] = []

    def merge(self, other: "RegressionEvaluation"):
        """Accumulate another evaluation's samples (Spark eval-merge
        capability)."""
        self._labels.extend(other._labels)
        self._preds.extend(other._preds)
        return self

    def eval(self, labels, predictions, mask=None):
        labels = np.asarray(labels, float)
        predictions = np.asarray(predictions, float)
        if labels.ndim == 3:
            c = labels.shape[-1]
            labels = labels.reshape(-1, c)
            predictions = predictions.reshape(-1, c)
            if mask is not None:
                m = np.asarray(mask).reshape(-1).astype(bool)
                labels, predictions = labels[m], predictions[m]
        elif mask is not None:
            m = np.asarray(mask).reshape(-1).astype(bool)
            labels, predictions = labels[m], predictions[m]
        self._labels.append(labels)
        self._preds.append(predictions)

    def _all(self):
        return np.concatenate(self._labels), np.concatenate(self._preds)

    def num_columns(self) -> int:
        return self._labels[0].shape[1]

    def mean_squared_error(self, col: int) -> float:
        y, p = self._all()
        return float(np.mean((y[:, col] - p[:, col]) ** 2))

    def mean_absolute_error(self, col: int) -> float:
        y, p = self._all()
        return float(np.mean(np.abs(y[:, col] - p[:, col])))

    def root_mean_squared_error(self, col: int) -> float:
        return self.mean_squared_error(col) ** 0.5

    def relative_squared_error(self, col: int) -> float:
        y, p = self._all()
        num = np.sum((y[:, col] - p[:, col]) ** 2)
        den = np.sum((y[:, col] - np.mean(y[:, col])) ** 2)
        return float(num / den) if den else float("nan")

    def correlation_r2(self, col: int) -> float:
        y, p = self._all()
        if np.std(y[:, col]) == 0 or np.std(p[:, col]) == 0:
            return float("nan")
        return float(np.corrcoef(y[:, col], p[:, col])[0, 1])

    def r_squared(self, col: int) -> float:
        return 1.0 - self.relative_squared_error(col)

    def average_mean_squared_error(self) -> float:
        return float(np.mean([self.mean_squared_error(i) for i in range(self.num_columns())]))

    def average_mean_absolute_error(self) -> float:
        return float(np.mean([self.mean_absolute_error(i) for i in range(self.num_columns())]))

    def stats(self) -> str:
        cols = self.column_names or [f"col_{i}" for i in range(self.num_columns())]
        lines = ["Column    MSE        MAE        RMSE       RSE        R^2"]
        for i, name in enumerate(cols):
            lines.append(f"{name:9s} {self.mean_squared_error(i):<10.5g} "
                         f"{self.mean_absolute_error(i):<10.5g} "
                         f"{self.root_mean_squared_error(i):<10.5g} "
                         f"{self.relative_squared_error(i):<10.5g} "
                         f"{self.r_squared(i):<10.5g}")
        return "\n".join(lines)
