"""PyTorch/CUDA port of zero_transformer_tpu for one NVIDIA H100.

The JAX package ``zero_transformer_tpu`` stays the reference; this package
imports torch, numpy and the standard library only, never JAX and nothing
of the JAX package. Its hand-written CUDA kernels live in ``csrc/`` and
build on first use (``ops/_build.py``).
"""
