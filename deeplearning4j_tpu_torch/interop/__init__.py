"""Counterpart of ``deeplearning4j_tpu/interop``: the Java reference's
on-disk formats (``dl4j_zip``) and a JAX network's weights and updater
state (``jax_params``)."""
from .dl4j_zip import (import_dl4j_zip, is_dl4j_zip, read_nd4j_array,
                       write_nd4j_array)

__all__ = ["import_dl4j_zip", "is_dl4j_zip", "read_nd4j_array",
           "write_nd4j_array"]
