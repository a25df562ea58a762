"""Dense linear algebra of the exact-GP path, and the training LMLs.

JAX counterpart: mogptk_tpu/ops/linalg.py (`cholesky` :19-59,
`jittered_cholesky` :94-260 with the jitter ladder, `solve_triangular`
:287-296, `cholesky_solve`
:307-339, `_stoch_lowrank` :391-396, `_dense_lml_cotangents` :425-496,
`lml_quadform_logdet_shifted` :553-576,
`lml_quadform_logdet_stochastic_shifted` :579-606, `_sorted_gram` and
`lml_chol_fused` :611-715, whose `_sorted_lowrank_vjp` is
ops/block_families.lowrank_vjp_of here). The
factorization routes to ops/blocked_cholesky (the hand-written kernels on
CUDA) by gpr.config.blocked_cholesky_enabled, else to torch.linalg.cholesky;
the training LMLs ask for its fused below-TRSM loop (JAX :363, :381, :689),
which gpr.config.blocked_cholesky_fused_trsm switches on.
A solve given the panel inverses goes to ops/fused_solve (the K-solve kernel
on CUDA); the other solves are torch.linalg calls.
"""
import torch

from .blocked_cholesky import blocked_cholesky, effective_block
from .blocked_trisolve import blocked_cho_solve, spd_inverse_from_factor
from .block_families import gram_of, lowrank_vjp_of
from .block_mosm import channel_ids, mosm_gram_sorted_lower
from .fused_solve import MAX_RHS, fused_cho_solve


def cholesky(K, diag_shift=None, return_panel_invs=False, zero_upper=True,
             fused_trsm=False):
    """Lower Cholesky factor of K + diag(diag_shift) (scalar or (n,) vector).

    The blocked path overwrites K (see ops/blocked_cholesky); zero_upper=False
    leaves its strict upper undefined, for callers that read only the lower
    blocks. return_panel_invs=True returns (L, invs) with the diagonal-block
    inverses for cholesky_solve(invs=...), None where the blocked path did not
    run or padded. fused_trsm asks the blocked path for its fused below-TRSM
    column loop, taken when gpr.config.blocked_cholesky_fused_trsm is on too.
    Both paths return NaN instead of raising where K is not positive
    definite, as the JAX package does."""
    from ..gpr.config import config, blocked_cholesky_enabled
    if K.ndim == 2 and blocked_cholesky_enabled(K.shape[0], K.device, K.dtype):
        return blocked_cholesky(K, block_size=config.blocked_cholesky_block,
                                diag_shift=diag_shift, zero_upper=zero_upper,
                                return_panel_invs=return_panel_invs,
                                fused_trsm=fused_trsm and config.blocked_cholesky_fused_trsm)
    if diag_shift is not None:
        K = K + torch.diag(torch.as_tensor(diag_shift, dtype=K.dtype, device=K.device)
                           .expand(K.shape[-1]))
    L, info = torch.linalg.cholesky_ex(K)
    L = torch.where(info != 0, torch.full_like(L, float("nan")), L)
    return (L, None) if return_panel_invs else L


def jittered_cholesky(K, jitter=None, extra_diag=None, ladder=None, ladder_base=None):
    """Cholesky factor of K + diag(extra_diag) + jitter·mean(diag(K) + extra_diag)·I.

    jitter is relative, as in the reference (mogptk/gpr/model.py:242-244);
    extra_diag (n,) rides the factorization as a vector diagonal shift. K
    may be overwritten (blocked path) unless the ladder runs.

    ladder > 0 (None: gpr.config.jitter_ladder) retries an unusable factor,
    one with a NaN or with min|Lii|/max|Lii| < 1000·eps(dtype), with the
    relative jitter rung_base·10^k at rung k = 1 … ladder, where rung_base is
    `jitter`, else `ladder_base`, else 1e-8 (JAX: ops/linalg.jittered_cholesky
    and _ladder_cholesky). A barely successful factor matters as much as a
    NaN: its backward contains L⁻¹, and the gradient overflows first. The
    gradient flows through the returned factor only (Murray's explicit
    Cholesky backward, _LadderCholesky), so a failed rung never poisons it;
    the relative-jitter shift carries no gradient, as in the JAX ladder. Each
    factor's check is read on the host: one synchronization per
    factorization, and one more per rung that fires. Rungs that fire are
    counted in jittered_cholesky.rungs."""
    from ..gpr.config import config
    ladder = config.jitter_ladder if ladder is None else int(ladder)
    if ladder <= 0:
        shift = extra_diag
        if jitter is not None:
            d = torch.diagonal(K) if extra_diag is None else torch.diagonal(K) + extra_diag
            rel = jitter * torch.mean(d)
            shift = rel if extra_diag is None else extra_diag + rel
        return cholesky(K, diag_shift=shift)
    rung_base = jitter if jitter else (ladder_base if ladder_base else 1e-8)
    extra = K.new_zeros(0) if extra_diag is None else extra_diag
    return _LadderCholesky.apply(K, extra, jitter, ladder, rung_base)


jittered_cholesky.rungs = 0


def _unusable(L, tol):
    """NaN anywhere, or min|Lii| <= tol·max|Lii| (one host read)."""
    d = torch.diagonal(L).abs()
    return bool(torch.isnan(L).any() | (d.min() <= tol * d.max()))


class _LadderCholesky(torch.autograd.Function):
    """The jitter-laddered factor (jittered_cholesky with ladder > 0).
    Forward: factor with the base shift, then retry rung by rung while the
    factor is unusable. Backward, from the returned factor L alone (JAX:
    ops/linalg._ladder_bwd): dK = ½(G + Gᵀ), G = L⁻ᵀ Φ(Lᵀ tril(gL)) L⁻¹ with
    Φ the lower triangle with its diagonal halved; d extra = diag(dK)."""

    @staticmethod
    def forward(ctx, K, extra, base, ladder, rung_base):
        from ..gpr.config import blocked_cholesky_enabled
        K = K.detach()
        e = extra.detach() if extra.numel() else None
        md = torch.mean(torch.diagonal(K) if e is None else torch.diagonal(K) + e)
        tol = 1000.0 * torch.finfo(K.dtype).eps

        def shift(rel):
            if rel is None:
                return e
            return rel * md if e is None else e + rel * md

        # the blocked route factors in place: each attempt gets its own copy
        inplace = blocked_cholesky_enabled(K.shape[0], K.device, K.dtype)

        def factor(rel):
            return cholesky(K.clone() if inplace else K, diag_shift=shift(rel))

        L = factor(base if base else None)
        for k in range(1, ladder + 1):
            if not _unusable(L, tol):
                break
            jittered_cholesky.rungs += 1
            L = factor(rung_base * 10.0 ** k)
        ctx.has_extra = e is not None
        ctx.save_for_backward(L)
        return L

    @staticmethod
    def backward(ctx, gL):
        L, = ctx.saved_tensors
        Lt = torch.tril(L)
        middle = torch.tril(Lt.mT @ torch.tril(gL))
        middle.diagonal().mul_(0.5)
        T1 = torch.linalg.solve_triangular(Lt.mT, middle, upper=True)
        G = torch.linalg.solve_triangular(Lt.mT, T1.mT, upper=True).mT
        dK = 0.5 * (G + G.mT)
        dextra = torch.diagonal(dK).clone() if ctx.has_extra else None
        return dK, dextra, None, None, None


def solve_triangular(L, B, lower=True):
    """Solve L X = B for triangular L (only its lower triangle is read when
    lower, its upper triangle otherwise)."""
    return torch.linalg.solve_triangular(L, B, upper=not lower)


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
    """Shared LML forward core of the three training LMLs: factor K +
    diag(diag) (the shift applied inside the factorization, K overwritten on
    the blocked route, which takes the fused below-TRSM loop when
    gpr.config.blocked_cholesky_fused_trsm is on), solve rhs = [y, Z...] in
    one call. Returns (val, L, invs, K⁻¹rhs)."""
    L, invs = cholesky(K, diag_shift=diag, return_panel_invs=True, zero_upper=False,
                       fused_trsm=True)
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


def _sorted_gram(family, x, counts, pack, lower_only):
    """The channel-sorted Gram of the engine's pack (ops/block_families.
    pack_of). For MOSM, lower_only asks for the band-lower variant, legal
    only when the blocked factorization consumes it (the band is tied to
    the factorization's panel width, as in the JAX package's
    ops/linalg._sorted_gram); the other families have no band-lower variant
    and build the full Gram (K-fam-gram), as the JAX package does."""
    from ..gpr.config import config
    if family[0] == "mosm" and lower_only:
        band = effective_block(x.shape[0], config.blocked_cholesky_block)
        K = mosm_gram_sorted_lower(x, counts, *pack, band=band)
        if K is not None:
            return K
    c = channel_ids(counts, x.device)
    return gram_of(family, x, c, x, c, pack, counts, counts)


class LmlCholFused(torch.autograd.Function):
    """−Σ log diag(chol(K+D)) − ½ yᵀ(K+D)⁻¹y for the channel-sorted Gram K
    of a block engine's pack (MOSM's pair statistics (st3, st2), or a
    family's (O, O, S) pack) and D = diag(`diag`) applied inside the
    factorization; the probe-trace gradient (Hutchinson, R probes Z).

    Forward: the Gram (MOSM: band-lower on the blocked route; the families:
    the full Gram), the blocked factor with every panel inverse and
    zero_upper=False, one solve of (K+D)⁻¹[y, Z]. Backward: dK = A·Bᵀ with
    A = ½g[α, −U/R], B = [α, Z] goes straight to the engine's low-rank VJP
    (K-lowrank-vjp or K-fam-lowrank-vjp, never forming dK), giving the
    pack's cotangents; ddiag = Σ_r A∘B, dy = −gα, dx = 0 (training inputs
    are constant, as in the JAX backward). Autograd chains the pack's
    cotangents through its pack function and ddiag through the noise
    diagonal.
    """

    @staticmethod
    def forward(ctx, static, x, diag, y, Z, *pack):
        family, counts, _ = static
        from ..gpr.config import blocked_cholesky_enabled
        x, diag, y = (t.detach() for t in (x, diag, y))
        pack = tuple(t.detach() for t in pack)
        n = x.shape[0]
        lower_ok = blocked_cholesky_enabled(n, x.device, x.dtype)
        K = _sorted_gram(family, x, counts, pack, lower_only=lower_ok)
        val, _, _, AU = _chol_lml(K, diag, torch.cat([y, Z], dim=1))
        alpha, U = AU[:, :1], AU[:, 1:]
        ctx.static = static
        ctx.save_for_backward(x, alpha, U, Z, *pack)
        return val

    @staticmethod
    def backward(ctx, g):
        family, counts, num_probes = ctx.static
        x, alpha, U, Z, *pack = ctx.saved_tensors
        A, B = _stoch_lowrank(alpha, U, Z, g, num_probes)
        dpack = lowrank_vjp_of(family, x, counts, pack, A, B)
        ddiag = torch.sum(A * B, dim=1)
        dy = -g * alpha
        dx = torch.zeros_like(x) if ctx.needs_input_grad[1] else None
        return (None, dx, ddiag, dy, None) + tuple(dpack)


def lml_chol_fused(static, x, diag, y, pack, Z):
    """LmlCholFused.apply. static = (family, counts, num_probes): the family
    id (name, statics), e.g. ("mosm", (twopi, True)), the per-channel counts
    tuple and R; x (N, D) channel-sorted inputs, diag (N,), y (N, 1), pack
    the engine's pack tuple (ops/block_families.pack_of), Z (N, R) the
    probes."""
    return LmlCholFused.apply(static, x, diag, y, Z, *pack)
