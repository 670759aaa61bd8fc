"""Per-example prediction records for evaluation debugging.

A copy of ``deeplearning4j_tpu/eval/meta.py`` (numpy only, no JAX): the
port's networks hand it their outputs as numpy arrays.

Reference: eval/meta/Prediction.java (actualClass, predictedClass,
recordMetaData) and the metadata-aware eval path of Evaluation.java:297-361
— record WHICH examples landed in each confusion-matrix cell so "show me
the worst predictions" is answerable after an evaluate() run.

Net-new beyond the reference: each Prediction also carries the predicted
class's score, so errors can be ranked most-confidently-wrong first
(get_worst_predictions) instead of only grouped by cell.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional


@dataclass
class Prediction:
    actual_class: int
    predicted_class: int
    record_meta_data: Any = None
    probability: Optional[float] = None   # score of the PREDICTED class

    def __repr__(self):
        return (f"Prediction(actual={self.actual_class}, "
                f"predicted={self.predicted_class}, "
                f"meta={self.record_meta_data!r}"
                + (f", p={self.probability:.4f})" if self.probability is not None
                   else ")"))
