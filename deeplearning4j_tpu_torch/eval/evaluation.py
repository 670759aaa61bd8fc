"""Classification evaluation: accuracy/precision/recall/F1 + confusion matrix.

A copy of ``deeplearning4j_tpu/eval/evaluation.py`` (numpy only, no JAX): the
port's networks hand it their outputs as numpy arrays.

Reference: eval/Evaluation.java:72 (eval(realOutcomes, guesses) :288),
stats() text report, per-class precision/recall/f1, top-N accuracy;
metadata-aware eval (:297-361), getPredictionErrors (:1490),
getPredictionByPredictedClass (:1567) via eval/meta/Prediction.java.
Computed host-side in numpy — evaluation is not a hot path; the device only
produces the network output.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .meta import Prediction


class Evaluation:
    def __init__(self, n_classes: Optional[int] = None, labels: Optional[List[str]] = None,
                 top_n: int = 1):
        self.n_classes = n_classes
        self.label_names = labels
        self.top_n = max(1, top_n)
        self.confusion: Optional[np.ndarray] = None
        self.top_n_correct = 0
        self.count = 0
        # (actual, predicted) -> list of (metadata, predicted-class score);
        # populated only by metadata-aware eval calls (reference
        # confusionMatrixMetaData, Evaluation.java:297)
        self.meta_confusion: Optional[
            Dict[Tuple[int, int], List[Tuple[Any, Optional[float]]]]] = None

    def _ensure(self, n):
        if self.confusion is None:
            self.n_classes = self.n_classes or n
            self.confusion = np.zeros((self.n_classes, self.n_classes), dtype=np.int64)

    def eval(self, labels, predictions, mask=None, record_meta_data=None):
        """labels: one-hot [N,C] (or int [N]); predictions: scores [N,C].
        For time series, [N,T,C] with optional mask [N,T].

        ``record_meta_data``: optional sequence of per-EXAMPLE metadata
        (length N). When given, every example's (actual, predicted) cell
        records the metadata + the predicted-class score, enabling
        get_prediction_errors / get_predictions_by_* / worst-k debugging
        (reference eval(INDArray,INDArray,List), Evaluation.java:297).
        Supported for per-example ([N,C] / [N]) evaluation only."""
        labels = np.asarray(labels)
        predictions = np.asarray(predictions)
        if labels.ndim == 3:
            if record_meta_data is not None:
                raise ValueError(
                    "record_meta_data is per-example; time-series labels "
                    "[N,T,C] flatten to N*T rows — evaluate per-step "
                    "metadata by flattening yourself")
            c = labels.shape[-1]
            m = None if mask is None else np.asarray(mask).reshape(-1).astype(bool)
            labels = labels.reshape(-1, c)
            predictions = predictions.reshape(-1, c)
            if m is not None:
                labels, predictions = labels[m], predictions[m]
        elif mask is not None:
            m = np.asarray(mask).reshape(-1).astype(bool)
            labels, predictions = labels[m], predictions[m]
            if record_meta_data is not None:
                # length-check against the PRE-mask row count: zip would
                # silently truncate a misaligned list and the post-filter
                # guard below could then pass with wrong records attached
                if len(record_meta_data) != len(m):
                    raise ValueError(
                        f"record_meta_data has {len(record_meta_data)} "
                        f"entries for {len(m)} pre-mask examples")
                record_meta_data = [md for md, keep in
                                    zip(record_meta_data, m) if keep]
        if labels.ndim == 2:
            true_idx = np.argmax(labels, axis=-1)
        else:
            true_idx = labels.astype(np.int64)
        self._ensure(predictions.shape[-1])
        pred_idx = np.argmax(predictions, axis=-1)
        np.add.at(self.confusion, (true_idx, pred_idx), 1)
        if self.top_n > 1:
            topn = np.argsort(-predictions, axis=-1)[:, :self.top_n]
            self.top_n_correct += int(np.sum(topn == true_idx[:, None]))
        self.count += len(true_idx)
        if record_meta_data is not None:
            # exact length: a longer list means the caller's metadata is
            # misaligned with these rows — silent zip-truncation would
            # attach WRONG records to predictions
            if len(record_meta_data) != len(true_idx):
                raise ValueError(
                    f"record_meta_data has {len(record_meta_data)} entries "
                    f"for {len(true_idx)} examples")
            if self.meta_confusion is None:
                self.meta_confusion = {}
            scores = predictions[np.arange(len(pred_idx)), pred_idx]
            for a, p, md, s in zip(true_idx, pred_idx, record_meta_data,
                                   scores):
                self.meta_confusion.setdefault(
                    (int(a), int(p)), []).append((md, float(s)))

    # -------------------------------------------------- prediction metadata
    def get_prediction_errors(self) -> Optional[List[Prediction]]:
        """All misclassified examples (off-diagonal cells), sorted by
        (actual, predicted) like the reference (Evaluation.java:1490).
        None when no metadata-aware eval call was made."""
        if self.meta_confusion is None:
            return None
        out: List[Prediction] = []
        for (a, p) in sorted(self.meta_confusion):
            if a == p:
                continue
            for md, s in self.meta_confusion[(a, p)]:
                out.append(Prediction(a, p, md, s))
        return out

    def get_predictions_by_actual_class(self, actual: int) -> Optional[List[Prediction]]:
        """Every prediction whose ACTUAL class is ``actual``
        (reference getPredictionsByActualClass, Evaluation.java:1539)."""
        if self.meta_confusion is None:
            return None
        return [Prediction(a, p, md, s)
                for (a, p), items in sorted(self.meta_confusion.items())
                if a == actual for md, s in items]

    def get_prediction_by_predicted_class(self, predicted: int) -> Optional[List[Prediction]]:
        """Every prediction whose PREDICTED class is ``predicted``
        (reference getPredictionByPredictedClass, Evaluation.java:1567)."""
        if self.meta_confusion is None:
            return None
        return [Prediction(a, p, md, s)
                for (a, p), items in sorted(self.meta_confusion.items())
                if p == predicted for md, s in items]

    def get_predictions(self, actual: int, predicted: int) -> Optional[List[Prediction]]:
        """Predictions in one confusion-matrix cell (reference
        getPredictions, Evaluation.java:1593)."""
        if self.meta_confusion is None:
            return None
        return [Prediction(actual, predicted, md, s)
                for md, s in self.meta_confusion.get((actual, predicted), [])]

    def get_worst_predictions(self, k: int = 10) -> Optional[List[Prediction]]:
        """The k most-confidently-WRONG predictions (errors ranked by the
        predicted class's score, descending) — the debugging workflow the
        metadata exists for. Net-new convenience over the reference."""
        errors = self.get_prediction_errors()
        if errors is None:
            return None
        return sorted(errors, key=lambda pr: -(pr.probability or 0.0))[:k]

    # ----------------------------------------------------------------- stats
    def accuracy(self) -> float:
        c = self.confusion
        return float(np.trace(c) / max(c.sum(), 1))

    def top_n_accuracy(self) -> float:
        if self.top_n == 1:
            return self.accuracy()
        return self.top_n_correct / max(self.count, 1)

    def precision(self, cls: Optional[int] = None) -> float:
        c = self.confusion
        if cls is not None:
            denom = c[:, cls].sum()
            return float(c[cls, cls] / denom) if denom else 0.0
        vals = [self.precision(i) for i in range(c.shape[0]) if c[:, i].sum() or c[i].sum()]
        return float(np.mean(vals)) if vals else 0.0

    def recall(self, cls: Optional[int] = None) -> float:
        c = self.confusion
        if cls is not None:
            denom = c[cls, :].sum()
            return float(c[cls, cls] / denom) if denom else 0.0
        vals = [self.recall(i) for i in range(c.shape[0]) if c[:, i].sum() or c[i].sum()]
        return float(np.mean(vals)) if vals else 0.0

    def f1(self, cls: Optional[int] = None) -> float:
        p, r = self.precision(cls), self.recall(cls)
        return 2 * p * r / (p + r) if (p + r) else 0.0

    def false_positive_rate(self, cls: int) -> float:
        c = self.confusion
        fp = c[:, cls].sum() - c[cls, cls]
        tn = c.sum() - c[cls, :].sum() - c[:, cls].sum() + c[cls, cls]
        return float(fp / max(fp + tn, 1))

    def false_negative_rate(self, cls: int) -> float:
        c = self.confusion
        fn = c[cls, :].sum() - c[cls, cls]
        return float(fn / max(c[cls, :].sum(), 1))

    def stats(self) -> str:
        lines = ["========================Evaluation Metrics========================",
                 f" # of classes:  {self.confusion.shape[0]}",
                 f" Examples:      {self.confusion.sum()}",
                 f" Accuracy:      {self.accuracy():.4f}",
                 f" Precision:     {self.precision():.4f}",
                 f" Recall:        {self.recall():.4f}",
                 f" F1 Score:      {self.f1():.4f}"]
        if self.top_n > 1:
            lines.append(f" Top-{self.top_n} Accuracy: {self.top_n_accuracy():.4f}")
        lines.append("\nConfusion matrix (rows=actual, cols=predicted):")
        lines.append(str(self.confusion))
        return "\n".join(lines)

    def merge(self, other: "Evaluation"):
        if other.confusion is None:
            return self
        self._ensure(other.confusion.shape[0])
        self.confusion += other.confusion
        self.top_n_correct += other.top_n_correct
        self.count += other.count
        if other.meta_confusion:
            if self.meta_confusion is None:
                self.meta_confusion = {}
            for key, items in other.meta_confusion.items():
                self.meta_confusion.setdefault(key, []).extend(items)
        return self

    # ----------------------------------------------------------------- serde
    def to_json(self) -> str:
        """JSON round-trip (reference BaseEvaluation.toJson) — metadata
        must itself be JSON-serializable (ints/strings/dicts...)."""
        d = {"type": "Evaluation", "n_classes": self.n_classes,
             "label_names": self.label_names, "top_n": self.top_n,
             "confusion": (self.confusion.tolist()
                           if self.confusion is not None else None),
             "top_n_correct": self.top_n_correct, "count": self.count,
             "meta_confusion": (
                 [[list(k), [[md, s] for md, s in v]]
                  for k, v in sorted(self.meta_confusion.items())]
                 if self.meta_confusion is not None else None)}
        return json.dumps(d)

    @classmethod
    def from_json(cls, s: str) -> "Evaluation":
        d = json.loads(s)
        if d.get("type") != "Evaluation":
            raise ValueError(f"not an Evaluation JSON payload: {d.get('type')!r}")
        e = cls(n_classes=d["n_classes"], labels=d["label_names"],
                top_n=d["top_n"])
        if d["confusion"] is not None:
            e.confusion = np.asarray(d["confusion"], dtype=np.int64)
        e.top_n_correct = d["top_n_correct"]
        e.count = d["count"]
        if d.get("meta_confusion") is not None:
            e.meta_confusion = {
                tuple(k): [(md, s) for md, s in v]
                for k, v in d["meta_confusion"]}
        return e
