"""Iterative linear algebra on matrix products: batched preconditioned
conjugate gradients, Lanczos (plain and fully reorthogonalized), stochastic
Lanczos quadrature, the Woodbury pieces of a low-rank-plus-diagonal
preconditioner, and the partial pivoted Cholesky that builds it.

JAX counterpart: mogptk_tpu/ops/iterative.py (`cg_solve` :17-120,
`cg_logdet_quadrature` :123-163, `lanczos` :166, `lanczos_reorth` :197,
`woodbury_m_inv` :242, `woodbury_half_powers` :263,
`preconditioned_slq_logdet` :294, `slq_logdet` :329, `pivoted_cholesky`
:353-384), with the arithmetic unchanged: the same latches, floors and
guards, in the same order. `lax.scan` becomes a Python loop of fixed length
with no host read inside it, so a training step stays queued on the device.
Random draws are arguments here (the JAX functions take a PRNG key): the
caller hands in the probes.

Every product runs in full precision: this package never enables TF32, so a
float32 matmul on the card is FP32 (the JAX package's "highest").
"""
import torch


def cg_solve(matvec, B, max_iters=100, tol=1e-6, M_inv=None, track_coeffs=False, X0=None):
    """Batched (preconditioned) conjugate gradients: solve A X = B.

    Args:
        matvec: V -> A @ V for V of shape (N, R).
        B: right-hand sides (N, R).
        max_iters: fixed iteration budget; the loop always runs it all
            (frozen columns stop moving).
        tol: relative residual tolerance, floored at 32 eps of B's dtype.
        M_inv: optional preconditioner V -> M⁻¹ V.
        track_coeffs: also return the per-iteration CG coefficients
            (alphas, betas, actives, rz0), each (m, R) / (R,), for
            cg_logdet_quadrature.
        X0: optional warm start (restarted CG); the relative residual stays
            measured against ‖B‖.

    Returns (X, res[, coeffs]): the solution (N, R), the final relative
    residual (R,), and the coefficients with track_coeffs.
    """
    if M_inv is None:
        M_inv = lambda v: v
    # a tol below what the arithmetic reaches would never freeze a column,
    # and CG's coefficients on round-off noise poison the log-det quadrature
    tol = max(float(tol), 32.0 * torch.finfo(B.dtype).eps)

    b_norm = torch.sqrt(torch.sum(B * B, dim=0))
    b_norm = torch.where(b_norm == 0.0, torch.ones_like(b_norm), b_norm)
    if X0 is None:
        X = torch.zeros_like(B)
        R = B
    else:
        X = X0
        R = B - matvec(X0)
    Z = M_inv(R)
    P = Z
    rz = torch.sum(R * Z, dim=0)
    rz0 = rz
    nR = B.shape[1]
    frozen = torch.zeros(nR, dtype=torch.bool, device=B.device)
    best = torch.full((nR,), float("inf"), dtype=b_norm.dtype, device=B.device)
    stall = torch.zeros(nR, dtype=torch.int32, device=B.device)
    zero = torch.zeros((), dtype=B.dtype, device=B.device)
    one = torch.ones((), dtype=B.dtype, device=B.device)
    alphas, betas, actives = [], [], []
    for _ in range(int(max_iters)):
        res = torch.sqrt(torch.sum(R * R, dim=0)) / b_norm
        # latched freeze: converged, broken down, or (when the coefficients
        # feed a quadrature) stalled 24 iterations on the round-off plateau
        if track_coeffs:
            improved = res < 0.998 * best
            stall = torch.where(improved, torch.zeros_like(stall), stall + 1)
            frozen = frozen | (stall >= 24)
        frozen = frozen | (res <= tol)
        best = torch.minimum(best, res)
        AP = matvec(P)
        pAp = torch.sum(P * AP, dim=0)
        # pAp ≤ 0 is breakdown: freeze BEFORE `active` is recorded, so the
        # quadrature decouples the breakdown row from the last valid one
        frozen = frozen | (pAp <= 0.0)
        active = ~frozen
        alpha = torch.where(pAp > 0.0, rz / torch.where(pAp == 0.0, one, pAp), zero)
        alpha = torch.where(active, alpha, zero)
        X = X + alpha[None, :] * P
        R = R - alpha[None, :] * AP
        Z = M_inv(R)
        rz_new = torch.sum(R * Z, dim=0)
        beta = torch.where(rz > 0.0, rz_new / torch.where(rz == 0.0, one, rz), zero)
        beta = torch.where(active, beta, zero)
        P = Z + beta[None, :] * P
        rz = rz_new
        if track_coeffs:
            alphas.append(alpha)
            betas.append(beta)
            actives.append(active)
    res = torch.sqrt(torch.sum(R * R, dim=0)) / b_norm
    if track_coeffs:
        empty = B.new_zeros((0, nR))
        stack = lambda xs, like: torch.stack(xs) if xs else like
        return X, res, (stack(alphas, empty), stack(betas, empty),
                        stack(actives, empty.bool()), rz0)
    return X, res


def _tridiag_quadrature(diag, off, weights):
    """Σ_k U[0,k]² log max(λ_k, 1e-12) · w for each column of the (m, R)
    diagonals and (m−1, R) off-diagonals: one batched eigh over the R
    tridiagonals."""
    m, R = diag.shape
    T = torch.diag_embed(diag.T)
    if m > 1:
        T = T + torch.diag_embed(off.T, 1) + torch.diag_embed(off.T, -1)
    lam, U = torch.linalg.eigh(T)
    lam = torch.clamp(lam, min=1e-12)
    return torch.sum(U[:, 0, :] ** 2 * torch.log(lam), dim=1) * weights


def cg_logdet_quadrature(coeffs):
    """Per-probe log-det contributions (R,) from CG coefficients (Gardner
    et al. 2018): CG's step sizes and direction updates are the Lanczos
    tridiagonal of P^{-1/2} A P^{-1/2} for the start z̃ = P^{-1/2} z,

        T[k,k] = 1/α_k + β_{k−1}/α_{k−1},   T[k,k+1] = √β_k / α_k,

    and z̃ᵀ log(Ã) z̃ ≈ (zᵀP⁻¹z) · e₁ᵀ log(T) e₁. Frozen iterations are
    identity rows; non-finite coefficients count as frozen."""
    alphas, betas, actives, rz0 = coeffs
    m, R = alphas.shape
    safe_a = torch.where(alphas > 0.0, alphas, torch.ones_like(alphas))
    inv_a = 1.0 / safe_a
    prev_ba = torch.cat([alphas.new_zeros((1, R)), betas[:-1] * inv_a[:-1]], dim=0)
    diag = torch.where(actives, inv_a + prev_ba, torch.ones_like(inv_a))
    diag = torch.where(torch.isfinite(diag), diag, torch.ones_like(diag))
    off = torch.sqrt(torch.clamp(betas, min=0.0)) * inv_a
    off = torch.where(torch.isfinite(off), off, torch.zeros_like(off))
    # off-diagonal k couples iterations k and k+1: zero once either froze
    both = actives[:-1] & actives[1:]
    off = torch.where(both, off[:-1], torch.zeros_like(off[:-1]))
    return _tridiag_quadrature(diag, off, rz0)


def lanczos(matvec, Z, m):
    """m-step Lanczos tridiagonalization of A, batched over the probes Z
    (N, R), which must be in the operator's dtype. Returns alphas (m, R) and
    betas (m−1, R). Plain three-term recurrence, no reorthogonalization."""
    q = Z / torch.linalg.norm(Z, dim=0, keepdim=True)
    q_prev = torch.zeros_like(q)
    beta_prev = Z.new_zeros(Z.shape[1])
    alphas, betas = [], []
    for _ in range(int(m)):
        v = matvec(q)
        alpha = torch.sum(q * v, dim=0)
        v = v - alpha[None, :] * q - beta_prev[None, :] * q_prev
        beta = torch.linalg.norm(v, dim=0)
        q_prev, q = q, v / torch.where(beta == 0.0, torch.ones_like(beta), beta)[None, :]
        beta_prev = beta
        alphas.append(alpha)
        betas.append(beta)
    return torch.stack(alphas), torch.stack(betas)[:-1]


def lanczos_reorth(matvec, Z, m):
    """Fully reorthogonalized Lanczos, batched over the probes Z (n, R) in
    the operator's dtype: every new vector is projected off the stored basis
    twice (classical Gram-Schmidt, "twice is enough"). The basis is (m, R, n)
    memory. Returns alphas (m, R) and betas (m−1, R).

    The JAX package projects against all m rows (those past k are zero);
    here only the k+1 filled rows are read, which adds the same nonzero
    terms."""
    n, R = Z.shape
    q = Z / torch.linalg.norm(Z, dim=0, keepdim=True)
    Qb = Z.new_zeros((int(m), R, n))
    alphas, betas = [], []
    for k in range(int(m)):
        Qb[k] = q.T
        Qk = Qb[:k + 1]
        v = matvec(q)
        alpha = torch.sum(q * v, dim=0)
        proj = torch.einsum("krn,nr->kr", Qk, v)
        v = v - torch.einsum("krn,kr->nr", Qk, proj)
        proj2 = torch.einsum("krn,nr->kr", Qk, v)
        v = v - torch.einsum("krn,kr->nr", Qk, proj2)
        beta = torch.linalg.norm(v, dim=0)
        q = v / torch.where(beta == 0.0, torch.ones_like(beta), beta)[None, :]
        alphas.append(alpha)
        betas.append(beta)
    return torch.stack(alphas), torch.stack(betas)[:-1]


def woodbury_m_inv(L, sigma2, Linner=None):
    """P⁻¹ application for P = σ²I + L Lᵀ by the Woodbury identity. Pass a
    precomputed `Linner` = chol(σ²I + LᵀL) to reuse the r×r factor.
    Returns (M_inv, Linner)."""
    sigma2 = torch.as_tensor(sigma2, dtype=L.dtype, device=L.device)
    if Linner is None:
        r = L.shape[1]
        inner = sigma2 * torch.eye(r, dtype=L.dtype, device=L.device) + L.T @ L
        Linner = torch.linalg.cholesky(inner)

    def M_inv(V):
        t = torch.cholesky_solve(L.T @ V, Linner, upper=False)
        return (V - L @ t) / sigma2

    return M_inv, Linner


def woodbury_half_powers(L, sigma2):
    """Exact P^{±1/2} for P = σ²I + L Lᵀ from the r×r eigendecomposition
    LᵀL = V Λ Vᵀ: U = L V Λ^{−1/2} has orthonormal columns and
    P^s = σ^{2s} (I + U ((1 + Λ/σ²)^s − 1) Uᵀ). Returns (apply_half,
    apply_neg_half, logdetP)."""
    r = L.shape[1]
    sigma2 = torch.as_tensor(sigma2, dtype=L.dtype, device=L.device)
    lam, V = torch.linalg.eigh(L.T @ L)
    lam = torch.clamp(lam, min=0.0)
    # rank-deficient columns (duplicate pivots): their U column is ~0
    inv_sqrt = torch.where(lam > 0.0, 1.0 / torch.sqrt(torch.clamp(lam, min=1e-30)),
                           torch.zeros_like(lam))
    U = L @ (V * inv_sqrt[None, :])
    ratio = 1.0 + lam / sigma2

    def apply_pow(X, s):
        t = (ratio ** s - 1.0)[:, None] * (U.T @ X)
        return (sigma2 ** s) * (X + U @ t)

    logdetP = (L.shape[0] - r) * torch.log(sigma2) + torch.sum(torch.log(sigma2 * ratio))
    return (lambda X: apply_pow(X, 0.5)), (lambda X: apply_pow(X, -0.5)), logdetP


def preconditioned_slq_terms(matvec, L, sigma2, Z, lanczos_iters=64):
    """The two halves of preconditioned_slq_logdet: (logdetP, the per-probe
    quadratures (R,) of tr log(P^{-1/2} A P^{-1/2}), whose mean estimates
    it)."""
    apply_half, apply_neg_half, logdetP = woodbury_half_powers(L, sigma2)

    def matvec_tilde(V):
        return apply_neg_half(matvec(apply_neg_half(V)))

    alphas, betas = lanczos_reorth(matvec_tilde, Z, lanczos_iters)
    return logdetP, _tridiag_quadrature(alphas, betas, torch.sum(Z * Z, dim=0))


def preconditioned_slq_logdet(matvec, L, sigma2, Z, lanczos_iters=64):
    """Evaluation-grade logdet(A): the exact logdet(P) plus reorthogonalized
    SLQ of tr log(P^{-1/2} A P^{-1/2}), P = σ²I + L Lᵀ, with the Rademacher
    probes Z (n, R) in the operator's dtype (the JAX function draws them
    from its key)."""
    logdetP, trlogs = preconditioned_slq_terms(matvec, L, sigma2, Z, lanczos_iters)
    return logdetP + torch.mean(trlogs)


def slq_logdet(matvec, Z, lanczos_iters=32):
    """Stochastic Lanczos quadrature of log det(A) for SPD A with the
    Rademacher probes Z (n, R): zᵀ log(A) z ≈ ‖z‖² Σ_k w_k log λ_k from
    each probe's Lanczos tridiagonal (Ubaru, Chen & Saad 2017)."""
    alphas, betas = lanczos(matvec, Z, lanczos_iters)
    return torch.mean(_tridiag_quadrature(alphas, betas, torch.sum(Z * Z, dim=0)))


def pivoted_cholesky(K_diag, K_row, n, rank, jitter=1e-6):
    """Partial pivoted Cholesky factor L (n, rank) with K ≈ L Lᵀ (Gardner
    et al. 2018). K_row(i) returns row i of K (n,) for a 0-d index tensor i:
    the pivot stays on the device (argmax returns the first maximum, as
    jnp.argmax does), so the loop reads nothing back to the host."""
    L = K_diag.new_zeros((n, int(rank)))
    d = K_diag
    jit = torch.as_tensor(jitter, dtype=K_diag.dtype, device=K_diag.device)
    for k in range(int(rank)):
        i = torch.argmax(d)
        i1 = i.reshape(1)
        sval = torch.sqrt(torch.maximum(d.index_select(0, i1), jit))
        row = K_row(i)
        Li = L.index_select(0, i1)[0, :k]
        l = (row - L[:, :k] @ Li) / sval
        l = l.index_copy(0, i1, sval)
        L[:, k] = l
        d = torch.clamp(d - l * l, min=0.0).index_fill(0, i1, 0.0)
    return L
