"""Counterpart of ``deeplearning4j_tpu/parallel``."""
