"""Kernels and linear algebra of the port. JAX counterpart:
mogptk_tpu/ops/. Modules that hold a hand-written CUDA kernel keep its
plain PyTorch twin beside it: mosm_gram (K-gram, K-gram-bwd), block_mosm
(K-gram-lower, K-lowrank-vjp, K-gram-lowrank-vjp), mosm_matvec (K-matvec,
K-matvec-reduce, K-gram-matvec), block_families (K-fam-gram, K-fam-gram-bwd, K-fam-matvec,
K-fam-lowrank-vjp), blocked_cholesky (K-spanel, K-colwrite, K-sdiag,
K-below-trsm, K-commit), blocked_trisolve (K-syrk) and fused_solve
(K-solve). pallas_mosm holds no kernel: it is the JAX module's public
surface (the MOSM Gram, its matvec and its low-rank VJP from the raw
parameters) over those wrappers. _build compiles csrc/ and loads it."""
