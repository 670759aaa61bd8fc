"""ROC / AUC evaluation (exact, sort-based).

A copy of ``deeplearning4j_tpu/eval/roc.py`` (numpy only, no JAX): the
port's networks hand it their outputs as numpy arrays.

Reference: eval/ROC.java (thresholded + exact modes), ROCBinary.java
(per-output binary), ROCMultiClass.java (one-vs-all). Exact mode only —
the reference's thresholded mode was a memory optimization irrelevant here.
"""
from __future__ import annotations

import json
from typing import List, Optional, Tuple

import numpy as np


def _auc_from_scores(y_true: np.ndarray, scores: np.ndarray) -> float:
    """Exact ROC-AUC via rank statistic (handles ties)."""
    pos = scores[y_true > 0.5]
    neg = scores[y_true <= 0.5]
    if len(pos) == 0 or len(neg) == 0:
        return float("nan")
    order = np.argsort(np.concatenate([pos, neg]), kind="mergesort")
    ranks = np.empty(len(order), float)
    sorted_scores = np.concatenate([pos, neg])[order]
    # average ranks for ties
    i = 0
    while i < len(sorted_scores):
        j = i
        while j + 1 < len(sorted_scores) and sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        ranks[order[i:j + 1]] = (i + j) / 2.0 + 1.0
        i = j + 1
    r_pos = ranks[:len(pos)].sum()
    n_p, n_n = len(pos), len(neg)
    return float((r_pos - n_p * (n_p + 1) / 2.0) / (n_p * n_n))


def _curve(y_true: np.ndarray, scores: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(fpr, tpr, thresholds) exact curve."""
    order = np.argsort(-scores, kind="mergesort")
    y = y_true[order]
    s = scores[order]
    tps = np.cumsum(y > 0.5)
    fps = np.cumsum(y <= 0.5)
    distinct = np.where(np.diff(s))[0]
    idx = np.concatenate([distinct, [len(y) - 1]])
    tpr = tps[idx] / max(tps[-1], 1)
    fpr = fps[idx] / max(fps[-1], 1)
    return (np.concatenate([[0.0], fpr]), np.concatenate([[0.0], tpr]),
            np.concatenate([[np.inf], s[idx]]))


class ROC:
    """Binary ROC: labels single column {0,1} (or 2-col one-hot with class 1
    as positive, matching reference ROC.eval)."""

    def __init__(self):
        self.scores: List[np.ndarray] = []
        self.labels: List[np.ndarray] = []

    def eval(self, labels, predictions):
        labels = np.asarray(labels)
        predictions = np.asarray(predictions)
        if labels.ndim == 2 and labels.shape[1] == 2:
            labels = labels[:, 1]
            predictions = predictions[:, 1]
        elif labels.ndim == 2:
            labels = labels[:, 0]
            predictions = predictions[:, 0]
        self.labels.append(labels.astype(float))
        self.scores.append(predictions.astype(float))

    def merge(self, other: "ROC"):
        """Accumulate another ROC's raw samples (the Spark-side eval-merge
        capability, reference ROC.merge used by treeAggregate)."""
        self.labels.extend(other.labels)
        self.scores.extend(other.scores)
        return self

    def _all(self):
        return np.concatenate(self.labels), np.concatenate(self.scores)

    def calculate_auc(self) -> float:
        y, s = self._all()
        return _auc_from_scores(y, s)

    def get_roc_curve(self):
        y, s = self._all()
        return _curve(y, s)

    def calculate_auprc(self) -> float:
        y, s = self._all()
        order = np.argsort(-s, kind="mergesort")
        y = y[order]
        tps = np.cumsum(y > 0.5)
        precision = tps / np.arange(1, len(y) + 1)
        recall = tps / max(tps[-1], 1)
        # step-wise integration
        d_recall = np.diff(np.concatenate([[0.0], recall]))
        return float(np.sum(precision * d_recall))

    # ----------------------------------------------------------------- serde
    def to_json(self) -> str:
        """Exact-mode state is the raw (label, score) samples — the JSON
        carries them whole (reference BaseEvaluation.toJson; its exact-mode
        ROC serializes the underlying arrays the same way)."""
        y, s = (self._all() if self.labels
                else (np.empty(0), np.empty(0)))
        return json.dumps({"type": type(self).__name__,
                           "labels": y.tolist(), "scores": s.tolist()})

    @classmethod
    def from_json(cls, payload: str) -> "ROC":
        d = json.loads(payload)
        if d.get("type") != cls.__name__:
            raise ValueError(f"not a {cls.__name__} JSON payload: "
                             f"{d.get('type')!r}")
        r = cls()
        if d["labels"]:
            r.labels.append(np.asarray(d["labels"], float))
            r.scores.append(np.asarray(d["scores"], float))
        return r


class ROCBinary:
    """Independent binary ROC per output column (reference ROCBinary.java)."""

    def __init__(self):
        self._rocs: Optional[List[ROC]] = None

    def eval(self, labels, predictions):
        labels = np.asarray(labels)
        predictions = np.asarray(predictions)
        n = labels.shape[-1]
        if self._rocs is None:
            self._rocs = [ROC() for _ in range(n)]
        for i in range(n):
            self._rocs[i].labels.append(labels[:, i].astype(float))
            self._rocs[i].scores.append(predictions[:, i].astype(float))

    def calculate_auc(self, output: int) -> float:
        return self._rocs[output].calculate_auc()

    def calculate_average_auc(self) -> float:
        aucs = [r.calculate_auc() for r in self._rocs]
        return float(np.nanmean(aucs))

    def merge(self, other: "ROCBinary"):
        if other._rocs is None:
            return self
        if self._rocs is None:
            self._rocs = [ROC() for _ in other._rocs]
        if len(self._rocs) != len(other._rocs):
            raise ValueError(f"Cannot merge: {len(self._rocs)} vs "
                             f"{len(other._rocs)} output columns")
        for mine, theirs in zip(self._rocs, other._rocs):
            mine.merge(theirs)
        return self

    def to_json(self) -> str:
        return _multi_to_json(self)

    @classmethod
    def from_json(cls, payload: str) -> "ROCBinary":
        return _multi_from_json(cls, payload)


class ROCMultiClass:
    """One-vs-all ROC per class (reference ROCMultiClass.java)."""

    def __init__(self):
        self._rocs: Optional[List[ROC]] = None

    def eval(self, labels, predictions):
        labels = np.asarray(labels)
        predictions = np.asarray(predictions)
        n = labels.shape[-1]
        if self._rocs is None:
            self._rocs = [ROC() for _ in range(n)]
        for i in range(n):
            self._rocs[i].labels.append(labels[:, i].astype(float))
            self._rocs[i].scores.append(predictions[:, i].astype(float))

    def calculate_auc(self, cls: int) -> float:
        return self._rocs[cls].calculate_auc()

    def calculate_average_auc(self) -> float:
        return float(np.nanmean([r.calculate_auc() for r in self._rocs]))

    def merge(self, other: "ROCMultiClass"):
        if other._rocs is None:
            return self
        if self._rocs is None:
            self._rocs = [ROC() for _ in other._rocs]
        if len(self._rocs) != len(other._rocs):
            raise ValueError(f"Cannot merge: {len(self._rocs)} vs "
                             f"{len(other._rocs)} output columns")
        for mine, theirs in zip(self._rocs, other._rocs):
            mine.merge(theirs)
        return self

    def to_json(self) -> str:
        return _multi_to_json(self)

    @classmethod
    def from_json(cls, payload: str) -> "ROCMultiClass":
        return _multi_from_json(cls, payload)


def _multi_to_json(obj) -> str:
    rocs = obj._rocs
    return json.dumps({
        "type": type(obj).__name__,
        "rocs": ([json.loads(r.to_json()) for r in rocs]
                 if rocs is not None else None)})


def _multi_from_json(cls, payload: str):
    d = json.loads(payload)
    if d.get("type") != cls.__name__:
        raise ValueError(f"not a {cls.__name__} JSON payload: "
                         f"{d.get('type')!r}")
    obj = cls()
    if d["rocs"] is not None:
        obj._rocs = [ROC.from_json(json.dumps(rd)) for rd in d["rocs"]]
    return obj
