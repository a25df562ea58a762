"""Kernels and linear algebra of the port. JAX counterpart:
mogptk_tpu/ops/. Modules that hold a hand-written CUDA kernel
(mosm_gram, blocked_cholesky) keep its plain PyTorch twin beside it."""
