"""Fused narrow-RHS Cholesky solve: the K-solve kernel's wrapper.

JAX counterpart: mogptk_tpu/ops/pallas_solve.py (`fused_cho_solve`
:146-157, the Pallas kernel `_solve_kernel` :46-131 launched at :186).
(L Lᵀ)⁻¹·B from the lower factor L and the stacked inverses of its diagonal
blocks, both substitution sweeps in one call of csrc/fused_cho_solve.cu,
reading only L's strictly lower blocks; Lᵀ is never formed. Its plain twin is
ops/blocked_trisolve.blocked_cho_solve with the same inverses.

Not differentiable, like the JAX kernel: its caller is the forward of the
torch.autograd.Function ops/linalg.LmlCholFused, whose backward never goes
through the solve.
"""
import torch

from . import _build
from .blocked_trisolve import blocked_cho_solve

MAX_RHS = 64


def fused_cho_solve(L, invs, B):
    """X = (L Lᵀ)⁻¹ B. L (n, n) lower factor (strict upper ignored), invs
    (n/Bs, Bs, Bs) lower diagonal-block inverses, B (n, r) with r ≤ 64.
    CPU: the plain twin. CUDA: float32, or raises."""
    if L.device.type == "cpu":
        return blocked_cho_solve(L, B, invs=invs)
    n = L.shape[0]
    nb, Bs = invs.shape[0], invs.shape[-1]
    if (L.shape != (n, n) or invs.shape != (nb, Bs, Bs) or nb * Bs != n or B.ndim != 2
            or B.shape[0] != n or not 1 <= B.shape[1] <= MAX_RHS):
        raise ValueError("fused_cho_solve: L (n, n), invs (n/Bs, Bs, Bs) and B (n, r), "
                         "r <= %d, expected" % MAX_RHS)
    V = B.clone(memory_format=torch.contiguous_format)   # overwritten by the forward sweep
    Z = torch.empty_like(V)
    X = torch.empty_like(V)
    _build.require_cuda_inputs("fused_cho_solve", floats=(L, invs, V))
    err = _build.library().fused_cho_solve_f32(L.data_ptr(), invs.data_ptr(), V.data_ptr(),
                                               Z.data_ptr(), X.data_ptr(), n, Bs, B.shape[1],
                                               _build.stream_ptr(L))
    _build.check(err, "fused_cho_solve_f32")
    fused_cho_solve.launches += 1
    return X


fused_cho_solve.launches = 0
