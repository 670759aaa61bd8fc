"""Serving kernels of the port (counterpart of ``deeplearning4j_tpu/ops/kernels``):
the fused 1x1 conv + bias + relu (``conv``, K7) and the int8 matmul
(``quantized``, K8). The registry, autotune and reporting of the reference's
kernel library are not ported yet (ROADMAP A11)."""
