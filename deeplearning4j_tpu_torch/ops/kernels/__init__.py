"""Kernel library of the port (counterpart of
``deeplearning4j_tpu/ops/kernels``): the registry of the hand-written
kernels and their plain versions (``registry``, the five builtin names in
``builtins``), the autotune decision cache (``autotune``), and two serving
kernels, the fused 1x1 conv + bias + relu (``conv``, K7) and the int8
matmul (``quantized``, K8).

Import-light on purpose: ``registry`` only; the builtin registrations load
on the first registry query. The reference's ``envutil`` (kill switches,
interpret mode) has no counterpart: the device picks the implementation.
"""
from .registry import (KernelSpec, ParityPin, active_impl, get,  # noqa: F401
                       kernels_snapshot, names, record_kernel_timing,
                       register)

__all__ = ["KernelSpec", "ParityPin", "active_impl", "get",
           "kernels_snapshot", "names", "record_kernel_timing", "register"]
