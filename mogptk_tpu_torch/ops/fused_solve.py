"""Fused narrow-RHS Cholesky solve: the K-solve kernel's wrapper.

JAX counterpart: mogptk_tpu/ops/pallas_solve.py (`fused_cho_solve`
:146-157, the Pallas kernel `_solve_kernel` :46-131 launched at :186).
(L Lᵀ)⁻¹·B from the lower factor L and the stacked inverses of its diagonal
blocks, both substitution sweeps in one persistent launch of
csrc/fused_cho_solve.cu, reading only L's strictly lower blocks; Lᵀ is never
formed. Its plain twin is ops/blocked_trisolve.blocked_cho_solve with the
same inverses.

The launch hands out work items by an atomic ticket: per panel p of Bs
rows and per 64-row tile, the forward update (v_p = b_p − Σ_{i<p} L_pi z_i)
and inverse (z_p = inv_p v_p), then, panels in reverse, the backward update
(w_p = z_p − Σ_{i>p} L_ipᵀ x_i) and inverse (x_p = inv_pᵀ w_p). The kernel
works out each ticket's item and the items it waits on (all of lower
tickets, so no grid can deadlock it); the counts it waits on live in a
zeroed int32 tensor allocated per call.

Not differentiable, like the JAX kernel: its caller is the forward of the
torch.autograd.Function ops/linalg.LmlCholFused, whose backward never goes
through the solve.
"""
import torch

from . import _build
from .blocked_trisolve import blocked_cho_solve

MAX_RHS = 64
# a cap on the kernel's grid, for tests only (0: every CTA that fits)
_GRID_CAP = 0


def fused_cho_solve(L, invs, B):
    """X = (L Lᵀ)⁻¹ B. L (n, n) lower factor (strict upper ignored), invs
    (n/Bs, Bs, Bs) lower diagonal-block inverses, B (n, r) with r ≤ 64.
    CPU or float64: the plain twin. float32 CUDA: the kernel, or raises."""
    if _build.runs_plain(L):
        return blocked_cho_solve(L, B, invs=invs)
    n = L.shape[0]
    nb, Bs = invs.shape[0], invs.shape[-1]
    if (L.shape != (n, n) or invs.shape != (nb, Bs, Bs) or nb * Bs != n or B.ndim != 2
            or B.shape[0] != n or not 1 <= B.shape[1] <= MAX_RHS):
        raise ValueError("fused_cho_solve: L (n, n), invs (n/Bs, Bs, Bs) and B (n, r), "
                         "r <= %d, expected" % MAX_RHS)
    B = B.contiguous()
    R = B.shape[1]
    counts = torch.zeros(1 + 4 * nb, dtype=torch.int32, device=L.device)
    lib = _build.library()
    # v, z and x, each row padded to the kernel's stride (whole 16-byte copies)
    V, Z, Xp = torch.empty((3, n, lib.fused_cho_solve_rhs_stride(R)), dtype=B.dtype,
                           device=B.device)
    X = torch.empty_like(B)
    _build.require_cuda_inputs("fused_cho_solve", floats=(L, invs, B), ints=(counts,))
    err = lib.fused_cho_solve_f32(
        L.data_ptr(), invs.data_ptr(), B.data_ptr(), V.data_ptr(), Z.data_ptr(), Xp.data_ptr(),
        X.data_ptr(), counts.data_ptr(), n, Bs, R, _GRID_CAP, _build.stream_ptr(L))
    _build.check(err, "fused_cho_solve_f32")
    fused_cho_solve.launches += 1
    return X


fused_cho_solve.launches = 0
