"""Counterpart of ``deeplearning4j_tpu/optimize``: the solver, the updaters,
the training listeners, the second-order solvers and the training step as
a CUDA graph."""
