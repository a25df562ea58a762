"""mogptk_tpu_torch — the multi-output GP toolkit on PyTorch and CUDA.

The port of mogptk_tpu (JAX on a TPU) to PyTorch on an NVIDIA H100. JAX
counterpart: mogptk_tpu/__init__.py. This package imports torch and never
jax, pandas or matplotlib. It covers the exact-GP training step (probe-trace
gradient) and prediction so far;
see README.md, "PyTorch/CUDA port".
"""
from . import gpr

__all__ = ["gpr"]
