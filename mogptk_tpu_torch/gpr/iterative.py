"""ExactIterative: exact GP regression without a Cholesky factor and without
forming the Gram (BBMM, Gardner et al. 2018).

JAX counterpart: mogptk_tpu/gpr/iterative.py (`_lml_iter` :77-338,
`ExactIterative` :341-673). The LML's quadratic form comes from one batched
preconditioned CG, its log-determinant from the Lanczos quadrature that CG's
own coefficients define, and the gradient from the probe-trace identity with
a low-rank cotangent dK = A·Bᵀ that is never formed. The kernel is one of
the block-engine families (`_family_of`: MOSM, uMOSM, CSM, CONV, MOHSM,
SM-LMC), whose pack (ops/block_families.pack_of) the engine's kernels take.
On CUDA tensors every product K·V goes through the hand-written K-matvec or
K-fam-matvec kernel, the cotangent through K-lowrank-vjp or
K-fam-lowrank-vjp, and the preconditioner's pivot rows and predict's
cross-Gram through K-gram or K-fam-gram (ops/block_families.matvec_of,
lowrank_vjp_of, gram_of); on CPU tensors their plain twins run.

Channel order: the JAX package runs unsorted channel IDs through its generic
one-hot kernels. Here the rows are put in channel order once, at
construction (a stable sort), the sorted kernels run, and α, the predictions
and the cotangents of y and the noise are put back in the caller's order.
The pivoted Cholesky factor is built in the caller's order, so that argmax's
ties break as in the JAX package, and then permuted. The ring mesh and the
row mask of mesh sharding are ROADMAP queue 1, item 10; sub-float32 dtypes
are not ported.

Random draws: the JAX package draws its Rademacher probes from
PRNGKey(seed + 1), the normal draws of its preconditioner probes from
split(PRNGKey(seed)) and the readout's probes from PRNGKey(seed + 1 +
7919·s). Here they are arguments (probes=, p_normals=, and the readout's
probes=), so a test can hand in the JAX package's; without them they come
from torch.Generators on the model's device seeded the same way (the two
generators give different numbers).
"""
import numpy as np
import torch

from .model import Model, generator, rademacher
from .likelihood import GaussianLikelihood
from .config import config
from ..ops.block_families import pack_of, gram_of, matvec_of, lowrank_vjp_of
from ..ops.mosm_gram import channel_counts
from ..ops.iterative import (cg_solve, cg_logdet_quadrature, woodbury_m_inv,
                             preconditioned_slq_terms, pivoted_cholesky)

READOUT_CHUNK = 48


def _as_draws(a, shape, dtype, device, what):
    a = torch.as_tensor(a if torch.is_tensor(a) else np.array(a), dtype=dtype, device=device)
    if tuple(a.shape) != tuple(shape):
        raise ValueError("%s must have shape %s, got %s" % (what, tuple(shape), tuple(a.shape)))
    return a


def _family_of(kernel):
    """The kernel's fused-family id (name, statics) (JAX:
    gpr/iterative._family_of); ValueError for a kernel without a block
    engine."""
    family = getattr(kernel, "family", None)
    if family is None:
        raise ValueError("ExactIterative supports the fused multi-output spectral families "
                         "(MOSM, MOSM-Q, uMOSM, CSM, CONV, MOHSM, SM-LMC); use Exact for "
                         "other kernels")
    return family


def _fused_kernel_params(kernel):
    """The parameter tuple of the family's pack (JAX:
    gpr/iterative._fused_kernel_params)."""
    return kernel._fused_params()


def make_matvec(family, x, c, pack, noise):
    """V -> (K + diag(noise))·V for the family's Gram of (x, c), K-matvec or
    K-fam-matvec on CUDA tensors, the plain twin on the CPU."""
    def matvec(V):
        return matvec_of(family, x, c, pack, V) + noise[:, None] * V
    return matvec


def pivoted_factor(family, x, c, kdiag, pack, rank):
    """Rank-`rank` partial pivoted Cholesky factor of the noiseless Gram of
    (x, c) in that row order, each pivot row one K-gram (K-fam-gram) call of
    one row."""
    def K_row(i):
        i1 = i.reshape(1)
        return gram_of(family, x.index_select(0, i1), c.index_select(0, i1), x, c, pack)[0]
    return pivoted_cholesky(kdiag, K_row, x.shape[0], rank)


def preconditioner(L, sigma2, u0, u1):
    """(M_inv, z, logdetP) of P = σ²I + L Lᵀ (JAX: _make_preconditioner with
    full=True): the Woodbury inverse, the probes z = σu₀ + L u₁ ~ N(0, P)
    and the exact log det P = (n − r) log σ² + 2 Σ log diag chol(σ²I + LᵀL).
    L None (no preconditioner): (None, u₀, 0)."""
    if L is None:
        return None, u0, torch.zeros((), dtype=u0.dtype, device=u0.device)
    n, r = L.shape
    M_inv, Linner = woodbury_m_inv(L, sigma2)
    z = torch.sqrt(sigma2) * u0 + L @ u1
    logdetP = (n - r) * torch.log(sigma2) + 2.0 * torch.sum(torch.log(torch.diagonal(Linner)))
    return M_inv, z, logdetP


def lml_iter_value(matvec, L, sigma2, y, Z, u0, u1, max_cg, tol):
    """The training-path estimate −½ yᵀα − ½ log det(K + σ²): one batched CG
    on [y, Z, z] (z the preconditioner probes) with its coefficients
    tracked, then the CG-coefficient quadrature of the z columns plus the
    exact log det P (JAX: _lml_iter_fwd, unmasked). Returns (value, α,
    U = K⁻¹Z, parts): parts holds log det P, the per-probe quadratures and
    the CG's final relative residuals and active iterations per column."""
    P = Z.shape[1]
    M_inv, Zl, logdetP = preconditioner(L, sigma2, u0, u1)
    sols, res, coeffs = cg_solve(matvec, torch.cat([y, Z, Zl], dim=1), max_iters=max_cg,
                                 tol=tol, M_inv=M_inv, track_coeffs=True)
    alphas, betas, actives, rz0 = coeffs
    quads = cg_logdet_quadrature((alphas[:, 1 + P:], betas[:, 1 + P:], actives[:, 1 + P:],
                                  rz0[1 + P:]))
    alpha = sols[:, :1]
    val = -0.5 * torch.sum(y * alpha) - 0.5 * (logdetP + torch.mean(quads))
    parts = dict(logdetP=logdetP, quads=quads, res=res, active=torch.sum(actives, dim=0))
    return val, alpha, sols[:, 1:1 + P], parts


class _LmlIter(torch.autograd.Function):
    """−½ yᵀK̃⁻¹y − ½ log det K̃ for K̃ = K(pack) + diag(noise), the
    iterative estimate (JAX: the custom_vjp `_lml_iter`).

    Forward: the pivoted preconditioner, one batched CG on [y, Z, z] and
    the quadrature, all under no autograd. Backward: dK = A·Bᵀ with
    A = ½g[α, −U/R], B = [α, Z] goes to K-lowrank-vjp (K-fam-lowrank-vjp)
    in channel order (the pack's cotangents, which autograd chains through
    the pack function); the cotangents of the noise diagonal, rowsum(A∘B),
    and of y, −gα, are put back in the caller's order. dK's parameter
    cotangent is the same when rows and columns are permuted together, so
    the sorted kernel serves unsorted data."""

    @staticmethod
    def forward(ctx, model, noise, y, kdiag, *pack):
        noise, y = noise.detach(), y.detach()
        pack = tuple(t.detach() for t in pack)
        lay, family = model._layout, model.family
        matvec = make_matvec(family, lay["x"], lay["c"], pack, lay.sort(noise))
        L, sigma2 = model._factor(noise, pack, kdiag, model.precond_rank)
        val, alpha, U, _ = lml_iter_value(matvec, L, sigma2, lay.sort(y), model._Z, model._u0,
                                          model._u1, model.max_cg_iters, model.cg_tol)
        ctx.model = model
        ctx.save_for_backward(alpha, U, *pack)
        return val

    @staticmethod
    def backward(ctx, g):
        model = ctx.model
        lay = model._layout
        alpha, U, *pack = ctx.saved_tensors
        A = (0.5 * g) * torch.cat([alpha, -U / model.num_probes], dim=1)
        B = torch.cat([alpha, model._Z], dim=1)
        dpack = lowrank_vjp_of(model.family, lay["x"], lay["counts"], pack, A, B)
        dnoise = lay.unsort(torch.sum(A * B, dim=1))
        dy = lay.unsort(-g * alpha)
        return (None, dnoise, dy, None) + tuple(dpack)


class _Layout(dict):
    """The channel-sorted copy of the training inputs: x (N, D) and c (N,)
    int32 in channel order, the per-channel counts, and the stable sort's
    permutation (None when the data are already in channel order)."""

    def sort(self, a):
        return a if self["perm"] is None else a.index_select(0, self["perm"])

    def unsort(self, a):
        return a if self["perm"] is None else a.index_select(0, self["inv"])


class ExactIterative(Model):
    """Exact GP regression with iterative (CG and Lanczos) inference, for
    the block-engine families (JAX: gpr.ExactIterative).

    - the LML's quadratic form: batched CG (`max_cg_iters`, `cg_tol`),
      preconditioned by a rank-`precond_rank` pivoted Cholesky factor;
    - its log-determinant: the Lanczos quadrature of CG's coefficients on
      `num_probes` preconditioner probes plus the exact log det P, a
      stochastic estimate whose value carries probe noise while the
      gradients stay unbiased;
    - gradients: the probe-trace identity with a low-rank cotangent.

    Args mirror `Exact` plus the solver controls, and:
        device: None = config.device.
        probes: an explicit (N, num_probes) Rademacher matrix (e.g. the JAX
            package's rademacher(PRNGKey(seed + 1), ...)).
        p_normals: explicit normal draws (u0 (N, num_probes), u1
            (precond_rank, num_probes)) of the preconditioner probes
            z = σ̄u0 + L u1 (the JAX package's normal(split(PRNGKey(seed)))
            pair; with precond_rank 0, z = u0 and u1 is ignored).
    """

    def __init__(self, kernel, X, y, variance=1.0, data_variance=None, jitter=1e-8, mean=None,
                 max_cg_iters=100, cg_tol=1e-5, num_probes=16, lanczos_iters=32, seed=0,
                 precond_rank=64, device=None, probes=None, p_normals=None):
        family = _family_of(kernel)
        if config.dtype not in (torch.float32, torch.float64):
            raise NotImplementedError("ExactIterative runs in float32 or float64; sub-float32 "
                                      "precision is not ported")
        variance = np.asarray(variance, dtype=np.float64)
        channels = kernel.output_dims
        if 1 < variance.ndim or (variance.ndim == 1 and variance.shape[0] != channels):
            raise ValueError("variance must be float or have shape (channels,)")
        super().__init__(kernel, X, y, GaussianLikelihood(np.sqrt(variance)), jitter, mean, device)
        self.family = family
        n = self.X.shape[0]
        if data_variance is not None:
            data_variance = torch.as_tensor(data_variance, dtype=config.dtype,
                                            device=self.device).reshape(-1)
            if data_variance.shape[0] != n:
                raise ValueError("data variance must have shape (data_points,)")
        self.data_variance = data_variance
        self.max_cg_iters = int(max_cg_iters)
        self.cg_tol = float(cg_tol)
        self.num_probes = int(num_probes)
        self.lanczos_iters = int(lanczos_iters)
        self.seed = int(seed)
        self.precond_rank = min(int(precond_rank), n)
        self.log_marginal_likelihood_constant = 0.5 * n * np.log(2.0 * np.pi)
        self._row_mask = None

        c, x = kernel._split(self.X)
        counts = channel_counts(c, channels)
        perm = torch.argsort(c, stable=True)
        if bool(torch.all(perm == torch.arange(n, device=perm.device))):
            perm = inv = None
        else:
            inv = torch.argsort(perm)
        self._layout = _Layout(perm=perm, inv=inv, counts=counts, x_orig=x, c_orig=c)
        self._layout.update(x=self._layout.sort(x).contiguous(), c=self._layout.sort(c).contiguous())

        dt, dev, P, r = config.dtype, self.device, self.num_probes, self.precond_rank
        if probes is None:
            probes = rademacher(generator(self.seed + 1, dev), (n, P), dt, dev)
        if p_normals is None:
            gen = generator(self.seed, dev)
            p_normals = (torch.randn((n, P), generator=gen, device=dev, dtype=dt),
                         torch.randn((r, P), generator=gen, device=dev, dtype=dt))
        u0, u1 = p_normals
        self._Z = self._layout.sort(_as_draws(probes, (n, P), dt, dev, "probes"))
        self._u0 = self._layout.sort(_as_draws(u0, (n, P), dt, dev, "p_normals[0]"))
        self._u1 = None if r == 0 else _as_draws(u1, (r, P), dt, dev, "p_normals[1]")

    def use_ring(self, mesh, axis="data"):
        """The ring-mesh matvec of the JAX package is not ported; mesh=None
        (single device) is what runs."""
        if mesh is not None:
            raise NotImplementedError("the ring mesh is not ported yet (ROADMAP queue 1, item 10)")

    def _check_unported(self):
        if self._row_mask is not None:
            raise NotImplementedError("row masks (mesh sharding) are not ported yet "
                                      "(ROADMAP queue 1, item 10)")

    def _noise_diag(self):
        """Per-point noise: the channel's likelihood variance, the optional
        data variance, and the jitter as an absolute floor (N,)."""
        noise = self._index_channel(self.likelihood.scale() ** 2, self.X)
        diag = noise.reshape(-1).expand(self.X.shape[0])
        if self.data_variance is not None:
            diag = diag + self.data_variance
        return diag + self.jitter

    def _pack(self):
        """The engine's pack (differentiable) and the Gram's diagonal in the
        caller's order (detached; it only picks pivots)."""
        lay = self._layout
        return (pack_of(self.family, _fused_kernel_params(self.kernel)),
                self.kernel.K_mo_diag(lay["c_orig"], lay["x_orig"]).detach())

    def _factor(self, noise, pack, kdiag, rank):
        """(L, σ̄²): the rank-`rank` pivoted factor in channel order (None for
        rank 0) and the mean noise, from the caller's order."""
        sigma2 = torch.mean(noise)
        if not rank:
            return None, sigma2
        lay = self._layout
        L = pivoted_factor(self.family, lay["x_orig"], lay["c_orig"], kdiag, pack, rank)
        return lay.sort(L), sigma2

    def _operator(self, rank):
        """(matvec, M_inv or None, L, σ̄², pack) at the current parameters,
        detached."""
        pack, kdiag = self._pack()
        pack = tuple(t.detach() for t in pack)
        noise = self._noise_diag().detach()
        lay = self._layout
        matvec = make_matvec(self.family, lay["x"], lay["c"], pack, lay.sort(noise))
        L, sigma2 = self._factor(noise, pack, kdiag, rank)
        M_inv = None if L is None else woodbury_m_inv(L, sigma2)[0]
        return matvec, M_inv, L, sigma2, pack

    @torch.no_grad()
    def cg_diagnostics(self):
        """The CG relative residuals at the current parameters, (residual
        of y, largest residual of the probes): above cg_tol, the LML and the
        gradients are under-converged."""
        self._check_unported()
        matvec, M_inv = self._operator(self.precond_rank)[:2]
        y = self._layout.sort(self._residual_y())
        _, res = cg_solve(matvec, torch.cat([y, self._Z], dim=1), max_iters=self.max_cg_iters,
                          tol=self.cg_tol, M_inv=M_inv)
        res = res.cpu().numpy()
        return float(res[0]), float(res[1:].max())

    def log_marginal_likelihood(self):
        """The training-path LML estimate, differentiable in the raws."""
        self._check_unported()
        pack, kdiag = self._pack()
        val = _LmlIter.apply(self, self._noise_diag(), self._residual_y(), kdiag, *pack)
        return val - self.log_marginal_likelihood_constant

    @torch.no_grad()
    def readout_terms(self, max_cg_iters=None, cg_tol=None, num_probes=None, lanczos_iters=None,
                      precond_rank=None, seeds=1, probes=None):
        """The pieces of log_marginal_likelihood_readout, as a dict: 0-d
        tensors `quad` = −½ yᵀα (chunked CG), `logdetP` (exact), `trlog`
        (the quadrature of tr log(P⁻¹K), averaged over the seeds) and
        `value` = quad − ½ mean_s(logdetP + trlog_s) − the constant; and
        `trlog_probes`, the per-probe quadratures of every seed (seeds ·
        num_probes,), and `alpha` = (K + σ²)⁻¹y (N, 1) in the caller's row
        order, from which a caller can judge each half's error."""
        self._check_unported()
        max_cg = int(max_cg_iters if max_cg_iters is not None else max(250, self.max_cg_iters))
        tol = float(cg_tol if cg_tol is not None else min(self.cg_tol, 1e-10))
        P = int(num_probes if num_probes is not None else max(64, self.num_probes))
        lanczos = int(lanczos_iters if lanczos_iters is not None else max(64, self.lanczos_iters))
        n = self.X.shape[0]
        rank = min(int(precond_rank if precond_rank is not None else max(256, self.precond_rank)), n)
        seeds = int(seeds)
        if probes is None:
            probes = [rademacher(generator(self.seed + 1 + 7919 * s, self.device), (n, P),
                                  config.dtype, self.device) for s in range(seeds)]
        elif torch.is_tensor(probes) or np.ndim(probes) == 2:
            probes = [probes]
        if len(probes) != seeds:
            raise ValueError("readout probes: one (N, %d) matrix per seed expected" % P)
        lay = self._layout
        probes = [lay.sort(_as_draws(Z, (n, P), config.dtype, self.device, "readout probes"))
                  for Z in probes]

        # K-matvec is FP32 FFMA on every path: the readout's full-precision
        # operator is the training operator (the JAX package switches its
        # matvec to precision "highest" here)
        matvec, M_inv, L, sigma2, _ = self._operator(rank)
        y = lay.sort(self._residual_y())
        # restarted CG in chunks of 48 iterations with a warm start, as the
        # JAX package runs it: a restart recomputes the residual and resets
        # the direction, so the chunks are kept for parity of the arithmetic
        tol_eff = max(tol, 32.0 * torch.finfo(y.dtype).eps)
        alpha = torch.zeros_like(y)
        for _ in range(-(-max_cg // READOUT_CHUNK)):
            alpha, res = cg_solve(matvec, y, max_iters=READOUT_CHUNK, tol=tol, M_inv=M_inv, X0=alpha)
            if float(torch.max(res)) <= tol_eff:
                break
        quad = -0.5 * torch.sum(y * alpha)
        logdetP, per_probe = None, []
        for Z in probes:
            logdetP, vals = preconditioned_slq_terms(matvec, L, sigma2, Z, lanczos)
            per_probe.append(vals)
        trlogs = torch.stack([torch.mean(v) for v in per_probe])
        value = (quad - 0.5 * torch.mean(logdetP + trlogs)
                 - self.log_marginal_likelihood_constant)
        return dict(quad=quad, logdetP=logdetP, trlog=torch.mean(trlogs), value=value,
                    trlog_probes=torch.cat(per_probe), alpha=lay.unsort(alpha))

    def log_marginal_likelihood_readout(self, max_cg_iters=None, cg_tol=None, num_probes=None,
                                        lanczos_iters=None, precond_rank=None, seeds=1,
                                        probes=None):
        """Evaluation-grade LML of the current parameters, a 0-d tensor
        (JAX: ExactIterative.log_marginal_likelihood_readout): the quadratic
        term by restarted preconditioned CG at a raised budget (250
        iterations, tol 1e-10), the log-determinant as the exact log det P
        of a rank-256 pivoted factor plus reorthogonalized stochastic
        Lanczos quadrature (64 probes, 64 steps) of tr log(P^{-1/2} K
        P^{-1/2}). `seeds` averages independent probe streams; `probes`
        gives them explicitly (one (N, num_probes) matrix per seed).
        Forward only."""
        return self.readout_terms(max_cg_iters, cg_tol, num_probes, lanczos_iters, precond_rank,
                                  seeds, probes)["value"]

    @torch.no_grad()
    def predict_f(self, X, full=False, block_size=1024):
        """Posterior mean and variance (M, 1) of f at X by CG solves. The
        variances are computed over blocks of `block_size` query points, one
        CG of that width each, so the N×M cross-Gram is never formed whole;
        full=True returns the (M, M) posterior covariance and forms it."""
        self._check_unported()
        X = self._check_input(X)
        lay = self._layout
        matvec, M_inv, _, _, pack = self._operator(self.precond_rank)
        y = lay.sort(self._residual_y())
        alpha, _ = cg_solve(matvec, y, max_iters=self.max_cg_iters, tol=self.cg_tol, M_inv=M_inv)
        cs, xs = self.kernel._split(X)

        def cross(cb, xb):
            # K(X_train in channel order, X block): (N, B)
            return gram_of(self.family, lay["x"], lay["c"], xb, cb, pack, lay["counts"], None)

        if full:
            Kfs = cross(cs, xs)
            V, _ = cg_solve(matvec, Kfs, max_iters=self.max_cg_iters, tol=self.cg_tol, M_inv=M_inv)
            return self._add_mean(Kfs.T @ alpha, X), self.kernel.K(X) - Kfs.T @ V
        S = xs.shape[0]
        B = int(min(block_size, S))
        mus, qfs = [], []
        for b0 in range(0, S, B):
            Kfs_b = cross(cs[b0:b0 + B], xs[b0:b0 + B])
            V_b, _ = cg_solve(matvec, Kfs_b, max_iters=self.max_cg_iters, tol=self.cg_tol,
                              M_inv=M_inv)
            mus.append(Kfs_b.T @ alpha[:, 0])
            qfs.append(torch.sum(Kfs_b * V_b, dim=0))
        mu = self._add_mean(torch.cat(mus).reshape(-1, 1), X)
        var = (self.kernel.K_diag(X) - torch.cat(qfs)).reshape(-1, 1)
        return mu, var
