"""Dense linear algebra of the exact-GP path, and the training LMLs.

JAX counterpart: mogptk_tpu/ops/linalg.py (`cholesky` :19-59,
`jittered_cholesky` :94-160, `solve_triangular` :287-296, `cholesky_solve`
:307-339, `_stoch_lowrank` :391-396, `_dense_lml_cotangents` :425-496,
`lml_quadform_logdet_shifted` :553-576,
`lml_quadform_logdet_stochastic_shifted` :579-606, `lml_chol_fused`
:650-715). The
factorization routes to ops/blocked_cholesky (the hand-written kernels on
CUDA) by gpr.config.blocked_cholesky_enabled, else to torch.linalg.cholesky.
A solve given the panel inverses goes to ops/fused_solve (the K-solve kernel
on CUDA); the other solves are torch.linalg calls. The jitter ladder is not
ported.
"""
import torch

from .blocked_cholesky import blocked_cholesky, effective_block
from .blocked_trisolve import blocked_cho_solve, spd_inverse_from_factor
from .block_mosm import (channel_ids, mosm_gram_sorted_lower, mosm_lowrank_vjp_sorted)
from .fused_solve import MAX_RHS, fused_cho_solve
from .mosm_gram import mosm_gram


def cholesky(K, diag_shift=None, return_panel_invs=False, zero_upper=True):
    """Lower Cholesky factor of K + diag(diag_shift) (scalar or (n,) vector).

    The blocked path overwrites K (see ops/blocked_cholesky); zero_upper=False
    leaves its strict upper undefined, for callers that read only the lower
    blocks. return_panel_invs=True returns (L, invs) with the diagonal-block
    inverses for cholesky_solve(invs=...), None where the blocked path did not
    run or padded. Both paths return NaN instead of raising where K is not
    positive definite, as the JAX package does."""
    from ..gpr.config import config, blocked_cholesky_enabled
    if K.ndim == 2 and blocked_cholesky_enabled(K.shape[0], K.device, K.dtype):
        return blocked_cholesky(K, block_size=config.blocked_cholesky_block,
                                diag_shift=diag_shift, zero_upper=zero_upper,
                                return_panel_invs=return_panel_invs)
    if diag_shift is not None:
        K = K + torch.diag(torch.as_tensor(diag_shift, dtype=K.dtype, device=K.device)
                           .expand(K.shape[-1]))
    L, info = torch.linalg.cholesky_ex(K)
    L = torch.where(info != 0, torch.full_like(L, float("nan")), L)
    return (L, None) if return_panel_invs else L


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


def cholesky_solve(L, B, invs=None):
    """Solve K X = B given the lower Cholesky factor L of K.

    invs: the diagonal-block inverses from cholesky(return_panel_invs=True).
    With them both sweeps read only L's lower blocks: up to 64 right-hand
    sides through ops/fused_solve (the K-solve kernel for CUDA tensors, its
    plain twin on the CPU; not differentiable on CUDA), wider ones through
    the blocked GEMM sweeps (as the JAX package routes them)."""
    if invs is not None and L.ndim == 2 and B.ndim == 2:
        if B.shape[1] <= MAX_RHS:
            return fused_cho_solve(L, invs, B)
        return blocked_cho_solve(L, B, invs=invs)
    return torch.cholesky_solve(B, L, upper=False)


def _stoch_lowrank(alpha, U, Z, g, num_probes):
    """dK = ½g(ααᵀ − R⁻¹ U Zᵀ) as an explicit low-rank pair (A, B):
    dK = A Bᵀ."""
    A = (0.5 * g) * torch.cat([alpha, -U / num_probes], dim=1)
    B = torch.cat([alpha, Z], dim=1)
    return A, B


def _chol_lml(K, diag, rhs):
    """Shared LML forward core: factor K + diag(diag) (the shift applied
    inside the factorization, K overwritten on the blocked route), solve
    rhs = [y, Z...] in one call. Returns (val, L, invs, K⁻¹rhs)."""
    L, invs = cholesky(K, diag_shift=diag, return_panel_invs=True, zero_upper=False)
    X = cholesky_solve(L, rhs, invs=invs)
    val = -torch.sum(torch.log(torch.diagonal(L))) - 0.5 * torch.sum(rhs[:, :1] * X[:, :1])
    return val, L, invs, X


def _dense_lml_cotangents(L, alpha, g, invs=None):
    """dK = ½g(ααᵀ − K⁻¹) and dy = −gα from the lower factor L of K (its
    strict upper is never read). On the blocked route K⁻¹ comes from the
    factor (spd_inverse_from_factor, ≈ n³/2 multiply-adds in GEMMs) when the
    panel width divides n, else from a column-blocked double triangular
    solve of the identity (2,048 columns at a time); on the unblocked route
    from torch.cholesky_inverse. dK is formed in K⁻¹'s buffer."""
    from ..gpr.config import blocked_cholesky_enabled
    n = L.shape[0]
    if blocked_cholesky_enabled(n, L.device, L.dtype):
        if invs is not None and invs.shape[0] * invs.shape[-1] != n:
            invs = None
        eff = invs.shape[-1] if invs is not None else effective_block(n, 1024)
        if n % eff == 0:
            Kinv = spd_inverse_from_factor(L, block_size=eff, invs=invs)
        else:
            Kinv = torch.empty_like(L)
            eye = torch.eye(n, dtype=L.dtype, device=L.device)
            for c0 in range(0, n, 2048):
                Zb = torch.linalg.solve_triangular(L, eye[:, c0:c0 + 2048], upper=False)
                Kinv[:, c0:c0 + 2048] = torch.linalg.solve_triangular(L.mT, Zb, upper=True)
    else:
        Kinv = torch.cholesky_inverse(L, upper=False)
    dK = Kinv.neg_().addr_(alpha[:, 0], alpha[:, 0]).mul_(0.5 * g)
    return dK, -g * alpha


class LmlQuadformLogdetShifted(torch.autograd.Function):
    """−Σ log diag(chol(K+D)) − ½ yᵀ(K+D)⁻¹y with D = diag(`diag`) applied
    inside the factorization, and the closed-form gradient (JAX:
    lml_quadform_logdet_shifted).

    Forward: the factor (blocked: every panel inverse, zero_upper=False) and
    α = (K+D)⁻¹y. The blocked factorization overwrites K in place, so nothing
    may have saved K for its backward (ops/mosm_gram.MosmGram saves its
    inputs, never its output). Backward: dK = ½g(ααᵀ − (K+D)⁻¹) (dense),
    ddiag = diag(dK), dy = −gα."""

    @staticmethod
    def forward(ctx, K, diag, y):
        val, L, invs, alpha = _chol_lml(K.detach(), diag.detach(), y.detach())
        ctx.save_for_backward(L, alpha, invs)
        return val

    @staticmethod
    def backward(ctx, g):
        L, alpha, invs = ctx.saved_tensors
        dK, dy = _dense_lml_cotangents(L, alpha, g, invs)
        return dK, torch.diagonal(dK).clone(), dy


def lml_quadform_logdet_shifted(K, diag, y):
    """LmlQuadformLogdetShifted.apply: K (n, n) noiseless Gram (overwritten
    on the blocked route), diag (n,), y (n, 1)."""
    return LmlQuadformLogdetShifted.apply(K, diag, y)


class LmlQuadformLogdetStochasticShifted(torch.autograd.Function):
    """The same value with the probe-trace gradient (JAX:
    lml_quadform_logdet_stochastic_shifted) for an explicit (n, R) probe
    matrix Z: y and Z are solved in one call, and the backward forms the
    dense dK = A·Bᵀ, A = ½g[α, −U/R], B = [α, Z] (_stoch_lowrank), for the
    Gram's own backward (unsorted channels: K-gram-bwd); ddiag = Σ_r A∘B,
    dy = −gα."""

    @staticmethod
    def forward(ctx, K, diag, y, Z):
        val, _, _, AU = _chol_lml(K.detach(), diag.detach(), torch.cat([y.detach(), Z], dim=1))
        ctx.save_for_backward(AU, Z)
        return val

    @staticmethod
    def backward(ctx, g):
        AU, Z = ctx.saved_tensors
        alpha = AU[:, :1]
        A, B = _stoch_lowrank(alpha, AU[:, 1:], Z, g, Z.shape[1])
        return A @ B.T, torch.sum(A * B, dim=1), -g * alpha, None


def lml_quadform_logdet_stochastic_shifted(K, diag, y, Z):
    """LmlQuadformLogdetStochasticShifted.apply; Z (n, R) the probes."""
    return LmlQuadformLogdetStochasticShifted.apply(K, diag, y, Z)


def _sorted_gram(x, counts, st3, st2, lower_only):
    """The channel-sorted MOSM Gram; lower_only asks for the band-lower
    variant, legal only when the blocked factorization consumes it (the
    band is tied to the factorization's panel width, as in the JAX
    package's ops/linalg._sorted_gram)."""
    from ..gpr.config import config
    n = x.shape[0]
    if lower_only:
        band = effective_block(n, config.blocked_cholesky_block)
        K = mosm_gram_sorted_lower(x, counts, st3, st2, band=band)
        if K is not None:
            return K
    c = channel_ids(counts, x.device)
    return mosm_gram(x, c, x, c, st3, st2)


class LmlCholFused(torch.autograd.Function):
    """−Σ log diag(chol(K+D)) − ½ yᵀ(K+D)⁻¹y for the channel-sorted MOSM Gram
    K of the pair statistics (st3, st2) and D = diag(`diag`) applied inside
    the factorization; the probe-trace gradient (Hutchinson, R probes Z).

    Forward: the Gram (band-lower on the blocked route), the blocked factor
    with every panel inverse and zero_upper=False, one solve of (K+D)⁻¹[y, Z].
    Backward: dK = A·Bᵀ with A = ½g[α, −U/R], B = [α, Z] goes straight to
    the low-rank VJP (never forming dK), giving dst3/dst2; ddiag = Σ_r A∘B,
    dy = −gα, dx = 0 (training inputs are constant, as in the JAX backward).
    Autograd chains dst3/dst2 through mosm_pair_stats and ddiag through the
    noise diagonal.
    """

    @staticmethod
    def forward(ctx, static, x, diag, y, st3, st2, Z):
        _, counts, _ = static
        from ..gpr.config import blocked_cholesky_enabled
        x, diag, y, st3, st2 = (t.detach() for t in (x, diag, y, st3, st2))
        n = x.shape[0]
        lower_ok = blocked_cholesky_enabled(n, x.device, x.dtype)
        K = _sorted_gram(x, counts, st3, st2, lower_only=lower_ok)
        val, _, _, AU = _chol_lml(K, diag, torch.cat([y, Z], dim=1))
        alpha, U = AU[:, :1], AU[:, 1:]
        ctx.static = static
        ctx.save_for_backward(x, alpha, U, Z, st3, st2)
        return val

    @staticmethod
    def backward(ctx, g):
        _, counts, num_probes = ctx.static
        x, alpha, U, Z, st3, st2 = ctx.saved_tensors
        A, B = _stoch_lowrank(alpha, U, Z, g, num_probes)
        dst3, dst2 = mosm_lowrank_vjp_sorted(x, counts, st3, st2, A, B)
        ddiag = torch.sum(A * B, dim=1)
        dy = -g * alpha
        dx = torch.zeros_like(x) if ctx.needs_input_grad[1] else None
        return None, dx, ddiag, dy, dst3, dst2, None


def lml_chol_fused(static, x, diag, y, st3, st2, Z):
    """LmlCholFused.apply. static = (family, counts, num_probes): the family
    id ("mosm", (twopi, True)), the per-channel counts tuple and R; x (N, D)
    channel-sorted inputs, diag (N,), y (N, 1), st3/st2 the pair statistics,
    Z (N, R) the probes."""
    return LmlCholFused.apply(static, x, diag, y, st3, st2, Z)
