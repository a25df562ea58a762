"""Blocked triangular solves against explicit diagonal-block inverses (the
plain twin of the K-solve kernel, ops/fused_solve), and K⁻¹ from the
Cholesky factor for the closed-form LML gradient.

JAX counterpart: mogptk_tpu/ops/blocked_trisolve.py (`panel_inverses`
:30-42, `blocked_trisolve` :45-95, `blocked_cho_solve` :98-113,
`blocked_tri_inverse` :116-155, `spd_inverse_from_factor` :244-294). Each
block row is one GEMM over the solved prefix and one GEMM against the block's
inverse. Only L's strictly lower blocks and the inverses are read (the upper
sweep reads Lᵀ as a view of the same lower blocks), so L's strict upper
triangle may hold anything. n must be a multiple of the block. The products
are plain large GEMMs (torch.matmul, full float32 on the card: TF32 stays
off); the JAX package's Pallas syrk (`syrk_lower`, default off and TPU only)
is not on this path.
"""
import torch


def panel_inverses(L, block_size=512):
    """Explicit inverses of the B×B diagonal blocks of lower-triangular L,
    in solve order, as an (n/B, B, B) tensor."""
    n = L.shape[-1]
    Bs = int(min(block_size, n))
    if n % Bs:
        raise ValueError("panel_inverses: the block must divide n")
    eye = torch.eye(Bs, dtype=L.dtype, device=L.device)
    return torch.stack([torch.linalg.solve_triangular(
        L[i * Bs:(i + 1) * Bs, i * Bs:(i + 1) * Bs], eye, upper=False) for i in range(n // Bs)])


def blocked_trisolve(L, B, invs, lower=True):
    """Solve T X = B for triangular T (T = L if lower, else L read as upper).

    Block row i, in solve order: B_i ← B_i − T[i, solved]·X[solved], then
    X_i = T_ii⁻¹·B_i with the explicit inverses invs (n/Bs, Bs, Bs), in the
    same order."""
    n = L.shape[-1]
    if L.ndim != 2 or B.ndim != 2:
        raise ValueError("blocked_trisolve expects 2-D L and B")
    Bs = invs.shape[-1]
    if n % Bs:
        raise ValueError("blocked_trisolve: the block must divide n")
    nb = n // Bs
    order = range(nb) if lower else range(nb - 1, -1, -1)
    X = torch.empty_like(B)
    for step, i in enumerate(order):
        r0 = i * Bs
        Bi = B[r0:r0 + Bs]
        if step > 0:
            if lower:
                Bi = Bi - L[r0:r0 + Bs, :r0] @ X[:r0]
            else:
                Bi = Bi - L[r0:r0 + Bs, r0 + Bs:] @ X[r0 + Bs:]
        X[r0:r0 + Bs] = invs[step] @ Bi
    return X


def blocked_cho_solve(L, B, invs):
    """(L Lᵀ)⁻¹ B from the lower Cholesky factor L: forward then back solve.

    invs: the lower-sweep inverses (blocked_cholesky(return_panel_invs=True)
    or panel_inverses(L)); the upper sweep uses their transposes reversed,
    (Lᵀ)_ii⁻¹ = (L_ii⁻¹)ᵀ."""
    Z = blocked_trisolve(L, B, invs)
    return blocked_trisolve(L.T, Z, invs.flip(0).transpose(1, 2), lower=False)


def blocked_tri_inverse(L, block_size=1024, invs=None):
    """W = L⁻¹ for lower-triangular L (strict upper ignored), by the row-block
    recursion W_ii = L_ii⁻¹, W[i, :i] = −W_ii·(L[i, :i]·W[:i, :i]): one GEMM
    pair per block row, ≈ n³/3 multiply-adds. W is one preallocated buffer
    written strip by strip (the JAX package's concatenate chain rebuilt the
    growing W every block row). Returns W with its strict upper zero."""
    n = L.shape[-1]
    Bs = int(min(block_size, n)) if invs is None else invs.shape[-1]
    if n % Bs:
        raise ValueError("blocked_tri_inverse: the block must divide n")
    if invs is None:
        invs = panel_inverses(L, block_size=Bs)
    W = torch.zeros_like(L)
    W[:Bs, :Bs] = invs[0]
    for i in range(1, n // Bs):
        r0 = i * Bs
        torch.matmul(-invs[i], L[r0:r0 + Bs, :r0] @ W[:r0, :r0], out=W[r0:r0 + Bs, :r0])
        W[r0:r0 + Bs, r0:r0 + Bs] = invs[i]
    return W


def spd_inverse_from_factor(L, block_size=1024, invs=None):
    """K⁻¹ = WᵀW from the lower Cholesky factor L of K, W = L⁻¹
    (blocked_tri_inverse). Block row i of the lower triangle is one GEMM,
    K⁻¹[i, :i+1] = W[i:, i]ᵀ·W[i:, :i+1] (W is lower, so the rows above i add
    nothing): ≈ n³/6 multiply-adds. Each strict lower block row is then
    mirrored into the upper blocks in place. ≈ n³/2 multiply-adds in all,
    against ≈ n³ for a column-blocked double solve; W is freed before the
    mirror."""
    n = L.shape[-1]
    W = blocked_tri_inverse(L, block_size=block_size, invs=invs)
    Bs = int(min(block_size, n)) if invs is None else invs.shape[-1]
    Kinv = torch.empty_like(W)
    for i in range(n // Bs):
        r0 = i * Bs
        torch.matmul(W[r0:, r0:r0 + Bs].T, W[r0:, :r0 + Bs], out=Kinv[r0:r0 + Bs, :r0 + Bs])
    del W
    for i in range(1, n // Bs):
        r0 = i * Bs
        Kinv[:r0, r0:r0 + Bs] = Kinv[r0:r0 + Bs, :r0].T
    return Kinv
