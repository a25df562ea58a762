"""Dense linear algebra of the exact-GP path.

JAX counterpart: mogptk_tpu/ops/linalg.py (`cholesky` :19-59,
`jittered_cholesky` :94-160, `solve_triangular` :287-296, `cholesky_solve`
:307-339). The factorization routes to ops/blocked_cholesky (the hand-written
kernels on CUDA) by gpr.config.blocked_cholesky_enabled, else to
torch.linalg.cholesky. The solves were XLA code in the JAX package and are
torch.linalg calls here. The jitter ladder is not ported.
"""
import torch

from .blocked_cholesky import blocked_cholesky


def cholesky(K, diag_shift=None):
    """Lower Cholesky factor of K + diag(diag_shift) (scalar or (n,) vector).

    The blocked path overwrites K (see ops/blocked_cholesky). Both paths
    return NaN instead of raising where K is not positive definite, as the
    JAX package does."""
    from ..gpr.config import config, blocked_cholesky_enabled
    if blocked_cholesky_enabled(K):
        return blocked_cholesky(K, block_size=config.blocked_cholesky_block,
                                diag_shift=diag_shift)
    if diag_shift is not None:
        K = K + torch.diag(torch.as_tensor(diag_shift, dtype=K.dtype, device=K.device)
                           .expand(K.shape[-1]))
    L, info = torch.linalg.cholesky_ex(K)
    return torch.where(info != 0, torch.full_like(L, float("nan")), L)


def jittered_cholesky(K, jitter=None, extra_diag=None):
    """Cholesky factor of K + diag(extra_diag) + jitter·mean(diag(K) + extra_diag)·I.

    jitter is relative, as in the reference (mogptk/gpr/model.py:242-244);
    extra_diag (n,) rides the factorization as a vector diagonal shift.
    K may be overwritten (blocked path)."""
    shift = extra_diag
    if jitter is not None:
        d = torch.diagonal(K) if extra_diag is None else torch.diagonal(K) + extra_diag
        rel = jitter * torch.mean(d)
        shift = rel if extra_diag is None else extra_diag + rel
    return cholesky(K, diag_shift=shift)


def solve_triangular(L, B):
    """Solve L X = B for lower-triangular L (only its lower triangle is read)."""
    return torch.linalg.solve_triangular(L, B, upper=False)


def cholesky_solve(L, B):
    """Solve K X = B given the lower Cholesky factor L of K."""
    return torch.cholesky_solve(B, L, upper=False)
