"""deeplearning4j_tpu_torch: the PyTorch/CUDA port of the JAX package
``deeplearning4j_tpu``.

The JAX package beside it is the reference. Each module here mirrors the
path of its counterpart there and names it in its docstring. The port
imports torch and numpy, never jax or deeplearning4j_tpu; its kernels are
hand-written CUDA C++ for Hopper (sm_90a) under ``csrc/``.

Ported so far: serving ``models.zoo_extra.transformer_lm`` through the
paged ``serving.generation.GenerationEngine``, with the flash-attention
forward kernel (``ops.flash_attention``).
"""
