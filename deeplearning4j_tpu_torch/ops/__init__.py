"""Counterpart of ``deeplearning4j_tpu/ops``."""
from .compression import (ThresholdPayload, threshold_decode,
                          threshold_encode, threshold_encode_dense,
                          threshold_encode_signs, threshold_roundtrip)

__all__ = ["ThresholdPayload", "threshold_decode", "threshold_encode",
           "threshold_encode_dense", "threshold_encode_signs",
           "threshold_roundtrip"]
