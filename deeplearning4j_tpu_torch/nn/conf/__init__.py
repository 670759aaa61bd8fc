"""Counterpart of ``deeplearning4j_tpu/nn/conf``."""
