"""Evaluation: a copy of ``deeplearning4j_tpu/eval`` (numpy only)."""
from .binary import EvaluationBinary, EvaluationCalibration
from .evaluation import Evaluation
from .meta import Prediction
from .regression import RegressionEvaluation
from .roc import ROC, ROCBinary, ROCMultiClass
from .tools import (calibration_chart_html, export_calibration_charts,
                    export_roc_charts, roc_chart_html)

__all__ = [
    "Evaluation", "EvaluationBinary", "EvaluationCalibration", "Prediction",
    "RegressionEvaluation", "ROC", "ROCBinary", "ROCMultiClass",
    "calibration_chart_html", "export_calibration_charts",
    "export_roc_charts", "roc_chart_html",
]
