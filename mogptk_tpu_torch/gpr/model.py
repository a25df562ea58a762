"""GP models: the base Model, exact GP regression (training and prediction)
and the sparse and variational models: Snelson (FITC), OpperArchambeau,
Titsias (the collapsed bound) and SparseHensman/Hensman (SVGP).

JAX counterpart: mogptk_tpu/gpr/model.py (`init_inducing_points` :36-97,
`Model` :126-360, `Exact` :489-784, `Snelson` :787-856, `OpperArchambeau`
:859-923, `Titsias` :926-1008, `SparseHensman` :1011-1117, `Hensman`
:1120-1125). Ported: construction, the objective `loss()` = −LML − log
prior, the noise diagonal, `predict_f(full=)`/`predict_y` on the unmasked
single-device branch, and every model's differentiable objective: the exact
LML with the closed-form gradient or the probe-trace gradient (`trace_probes`;
on channel-sorted data with a block-engine kernel the fused path
ops/linalg.lml_chol_fused), and the
sparse models' ELBOs and LML, whose trained inducing points Z get their
gradient from the Gram's input cotangents (ops/mosm_gram.MosmGram, the
K-gram-bwd kernel on the card). The sparse and variational models take the
Gaussian likelihood only (others: ROADMAP queue 1, item 9). Means, masks,
meshes and sampling are later work. Prediction recomputes the Grams and
their factors on every call, as the JAX package does. Factorizations go
through ops/linalg.jittered_cholesky, with the jitter ladder when
gpr.use_jitter_ladder asks for it.

On channel-sorted data the exact Gram goes through the K-gram kernel in one
launch (training: K-gram-lower, only the tiles the factorization reads; the
other block-engine families: K-fam-gram, and K-fam-gram-bwd or
K-fam-lowrank-vjp in the backward), and
on CUDA float32 with n ≥ 4096 and n a multiple of 512 the factorization goes
through the K-spanel and K-colwrite kernels, the training solve through
K-solve and its backward through K-lowrank-vjp (ops/). The sparse models'
Grams Kuf, Kuu and Kus go through K-gram and K-gram-bwd; their M×M factors,
triangular solves and products are plain torch.
"""
import math

import numpy as np
import torch

from .module import Module
from .kernel import Kernel
from .likelihood import GaussianLikelihood
from .config import config, resolve_device
from ..ops.block_families import pack_of
from ..ops.block_mosm import sorted_channel_counts
from ..ops.linalg import (jittered_cholesky, solve_triangular, cholesky_solve, lml_chol_fused,
                          lml_quadform_logdet_shifted, lml_quadform_logdet_stochastic_shifted)
from .parameter import Parameter


def _init_grid(N, X):
    """Grid-distributed inducing points (JAX: gpr/model.py _init_grid)."""
    n = int(round(np.power(N, 1.0 / X.shape[1])))
    if n ** X.shape[1] != N:
        raise ValueError("number of inducing points must equal N = n^%d" % X.shape[1])
    axes = [np.linspace(X[:, i].min(), X[:, i].max(), n) for i in range(X.shape[1])]
    grid = np.meshgrid(*axes, indexing="ij")
    return np.stack([g.flatten() for g in grid], axis=1)


def _init_random(N, X):
    """Halton-sequence inducing points (JAX: gpr/model.py _init_random). The
    JAX package scrambles the sequence from an unseeded generator; here the
    scrambling is drawn from the package's numpy Generator
    (gpr.config.numpy_rng, seeded by set_seed), so a seed reproduces Z."""
    from scipy.stats import qmc
    samples = qmc.Halton(d=X.shape[1], seed=config.numpy_rng()).random(n=N)
    lo, hi = X.min(axis=0), X.max(axis=0)
    return lo + (hi - lo) * samples


def _init_density(N, X):
    """KDE-resampled inducing points (JAX: gpr/model.py _init_density),
    drawn from the package's numpy Generator."""
    from scipy.stats import gaussian_kde
    return gaussian_kde(X.T, bw_method="scott").resample(N, seed=config.numpy_rng()).T


def init_inducing_points(Z, X, method="grid", output_dims=None):
    """Initial inducing points as a float64 numpy array (JAX:
    gpr/model.py:68-97).

    Args:
        Z (int, list of int, or array): the number of inducing points (per
            channel for a list, or for each channel for an int with
            output_dims), or the points themselves, returned as given.
        X: the training inputs; column 0 holds channel IDs when output_dims
            is set.
        method: 'grid', 'random' (Halton) or 'density' (KDE).
        output_dims: the number of channels of multi-output data.
    """
    _init = {"random": _init_random, "density": _init_density}.get(method, _init_grid)
    X = np.asarray(X.detach().cpu() if torch.is_tensor(X) else X, dtype=np.float64)
    if torch.is_tensor(Z):
        return Z.detach().cpu().numpy().astype(np.float64)
    if output_dims is not None:
        if isinstance(Z, int) or (all(isinstance(z, int) for z in Z) and len(Z) == output_dims):
            M = [Z] * output_dims if isinstance(Z, int) else list(Z)
            Zs = np.zeros((sum(M), X.shape[1]))
            for j, m in enumerate(M):
                m0 = sum(M[:j])
                Zs[m0:m0 + m, 0] = j
                Zs[m0:m0 + m, 1:] = _init(m, X[X[:, 0] == j, 1:])
            return Zs
    elif isinstance(Z, int):
        return _init(Z, X)
    return np.asarray(Z, dtype=np.float64)


def _posterior_var(kernel, X, full, a, b=None):
    """Kss − aᵀa (+ bᵀb): the posterior covariance (M, M) at X when full,
    else its diagonal as (M, 1), in the JAX package's order of operations."""
    if full:
        var = kernel.K(X) - a.T @ a
        return var if b is None else var + b.T @ b
    var = kernel.K_diag(X) - torch.sum(a * a, dim=0)
    if b is not None:
        var = var + torch.sum(b * b, dim=0)
    return var.reshape(-1, 1)


def generator(seed, device):
    """A torch.Generator on `device` seeded with `seed`."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return gen


def rademacher(gen, shape, dtype, device):
    """A ±1 matrix drawn from `gen`."""
    return (2 * torch.randint(0, 2, shape, generator=gen, device=device) - 1).to(dtype)


class Model(Module):
    """Base GP model.

    Args:
        kernel: a Kernel.
        X (N, input_dims), y (N,) or (N, 1): training data, converted to
            config.dtype on `device`.
        likelihood: defaults to GaussianLikelihood(1.0).
        jitter: relative jitter; at least 1e-6 in float32, 1e-15 in float64.
        device: None = config.device. Parameters move there too.
    """

    def __init__(self, kernel, X, y, likelihood=None, jitter=1e-8, mean=None, device=None):
        super().__init__()
        if mean is not None:
            raise NotImplementedError("mean functions are not ported yet (ROADMAP queue 1, item 9)")
        if likelihood is None:
            likelihood = GaussianLikelihood(1.0)
        if not isinstance(kernel, Kernel):
            raise ValueError("kernel must derive from mogptk_tpu_torch.gpr.Kernel")
        self.device = resolve_device(device)
        X, y = self._check_input(X, y)
        if config.dtype == torch.float32:
            jitter = max(jitter, 1e-6)
        else:
            jitter = max(jitter, 1e-15)
        self.kernel = kernel
        self.likelihood = likelihood
        self.X = X
        self.y = y
        self.jitter = jitter
        self.input_dims = X.shape[1]
        self.to(device=self.device, dtype=config.dtype)
        # per-channel counts when X is channel-sorted (merge_data's layout):
        # the Gram then takes the sorted path
        self._channel_counts = None
        if kernel.output_dims is not None and hasattr(kernel, "K_sorted"):
            self._channel_counts = sorted_channel_counts(X[:, 0].cpu().numpy(), kernel.output_dims)

    def _check_input(self, X, y=None):
        X = torch.as_tensor(X, dtype=config.dtype, device=self.device)
        if X.ndim == 0:
            X = X.reshape(1, 1)
        elif X.ndim == 1:
            X = X.reshape(-1, 1)
        elif X.ndim != 2:
            raise ValueError("X must have dimensions (data_points,input_dims) with input_dims optional")
        if X.shape[0] == 0 or X.shape[1] == 0:
            raise ValueError("X must not be empty")
        if y is None:
            if X.shape[1] != self.input_dims:
                raise ValueError("X must have %s input dimensions" % self.input_dims)
            return X
        y = torch.as_tensor(y, dtype=config.dtype, device=self.device)
        if y.ndim == 0:
            y = y.reshape(1, 1)
        elif y.ndim == 1:
            y = y.reshape(-1, 1)
        elif y.ndim != 2 or y.shape[1] != 1:
            raise ValueError("y must have one dimension (data_points,)")
        if X.shape[0] != y.shape[0]:
            raise ValueError("number of data points for X and y must match")
        return X, y

    def _cholesky(self, K, add_jitter=False):
        """Lower factor of K with the model's relative jitter when
        add_jitter, through jittered_cholesky (its ladder when enabled)."""
        return jittered_cholesky(K, self.jitter if add_jitter else None)

    def _index_channel(self, value, X):
        """Per-point gather of a per-channel quantity."""
        if self.kernel.output_dims is not None and 0 < value.ndim and value.shape[0] == self.kernel.output_dims:
            return value[X[:, 0].long()]
        return value

    def _residual_y(self):
        return self.y

    def log_marginal_likelihood(self):
        raise NotImplementedError()

    def log_prior(self):
        return sum(p.log_prior() for _, p in self.gp_parameters())

    def forward(self):
        return -self.log_marginal_likelihood() - self.log_prior()

    def loss(self):
        """The training objective −LML − log prior as a 0-d tensor; call
        .backward() on it for the raws' gradients."""
        return self()

    def predict_f(self, X, full=False):
        raise NotImplementedError()

    @torch.no_grad()
    def predict_y(self, X, ci=None, sigma=None):
        """Predictive mean and, with ci=[lo, hi] quantiles or sigma, the
        (mean, lower, upper) bands of y."""
        X = self._check_input(X)
        mu, var = self.predict_f(X)
        if ci is None and sigma is not None:
            p = 0.5 * (1.0 + math.erf(sigma / math.sqrt(2.0)))
            ci = [1.0 - p, p]
        return self.likelihood.predict(X, mu, var, ci, sigma=sigma)


class Exact(Model):
    """Exact GP regression, y ~ N(0, K + σ²I).

    Args:
        variance: noise variance, a float or one per channel.
        data_variance: optional fixed per-point noise variance (N,).
        trace_probes: None, or the number R of Rademacher probes of the
            Hutchinson probe-trace LML gradient (the training path).
        seed: seed of the probes: they are drawn once, as an (N, R) ±1
            matrix from a torch.Generator on the model's device seeded with
            `seed`, and reused every step (the JAX package draws
            jax.random.rademacher(PRNGKey(seed), (N, R)) every step, the
            same matrix each time; the two generators differ).
        probes: an explicit (N, R) probe matrix instead (e.g. the JAX
            package's, to compare the two); sets trace_probes to R.
    """

    def __init__(self, kernel, X, y, variance=1.0, data_variance=None, jitter=1e-8, mean=None,
                 device=None, trace_probes=None, seed=0, probes=None):
        variance = np.asarray(variance, dtype=np.float64)
        channels = 1 if kernel.output_dims is None else kernel.output_dims
        if 1 < variance.ndim or (variance.ndim == 1 and variance.shape[0] != channels):
            raise ValueError("variance must be float or have shape (channels,)")
        super().__init__(kernel, X, y, GaussianLikelihood(np.sqrt(variance)), jitter, mean, device)
        if data_variance is not None:
            data_variance = torch.as_tensor(data_variance, dtype=config.dtype,
                                            device=self.device).reshape(-1)
            if data_variance.shape[0] != self.X.shape[0]:
                raise ValueError("data variance must have shape (data_points,)")
        self.data_variance = data_variance
        self.log_marginal_likelihood_constant = 0.5 * self.X.shape[0] * np.log(2.0 * np.pi)
        n = self.X.shape[0]
        if probes is not None:
            probes = torch.as_tensor(probes if torch.is_tensor(probes) else np.array(probes),
                                     dtype=config.dtype, device=self.device)
            if probes.ndim != 2 or probes.shape[0] != n or probes.shape[1] < 1:
                raise ValueError("probes must have shape (data_points, R)")
            if trace_probes is not None and int(trace_probes) != probes.shape[1]:
                raise ValueError("trace_probes must equal the number of columns of probes")
            trace_probes = probes.shape[1]
        elif trace_probes:
            probes = rademacher(generator(seed, self.device), (n, int(trace_probes)),
                                config.dtype, self.device)
        self.trace_probes = None if not trace_probes else int(trace_probes)
        self.seed = seed
        self.probes = probes

    def _fused_static(self):
        """Static id of the fused probe-trace LML (ops/linalg.lml_chol_fused),
        (family, counts, R), or None unless the data are channel-sorted, the
        kernel has a block engine (MOSM, uMOSM, CSM, CONV, MOHSM, SM-LMC) and
        trace_probes is set (JAX: Exact._fused_static; the port has no
        Pallas switch, row mask, Gram sharding, jitter ladder or Gram storage
        format to gate on)."""
        if not self.trace_probes or self._channel_counts is None:
            return None
        family = getattr(self.kernel, "family", None)
        if family is None:
            return None
        return (family, self._channel_counts, self.trace_probes)

    def _noise_diag(self, add_jitter=False):
        """The (N,) diagonal added to the Gram: likelihood noise per channel,
        the optional data variance, and the optional relative jitter
        jitter·mean(diag K + noise)."""
        noise = self._index_channel(self.likelihood.scale() ** 2, self.X)
        diag = noise.reshape(-1).expand(self.X.shape[0])
        if self.data_variance is not None:
            diag = diag + self.data_variance
        if add_jitter:
            diag = diag + self.jitter * torch.mean(self.kernel.K_diag(self.X) + diag)
        return diag

    def _Kff(self):
        """The noiseless training Gram (the noise rides the factorization)."""
        if self._channel_counts is not None:
            return self.kernel.K_sorted(self.X, self._channel_counts)
        return self.kernel.K(self.X)

    def log_marginal_likelihood(self):
        """LML via Cholesky (JAX: Exact.log_marginal_likelihood, the unmasked
        single-device branches). With trace_probes on channel-sorted data,
        the fused path (Gram, factor, solve and probe-trace backward in one
        Function); otherwise the differentiable Gram _Kff() with the noise
        diagonal riding the factorization, then the closed-form gradient
        (trace_probes=None) or the probe-trace gradient on the dense dK."""
        static = self._fused_static()
        if static is not None:
            _, x = self.kernel._split(self.X)
            pack = pack_of(static[0], self.kernel._fused_params())
            diag = self._noise_diag(add_jitter=True)
            val = lml_chol_fused(static, x, diag, self._residual_y(), pack, self.probes)
            return val - self.log_marginal_likelihood_constant
        y = self._residual_y()
        K = self._Kff()
        diag = self._noise_diag(add_jitter=True)
        if self.trace_probes:
            val = lml_quadform_logdet_stochastic_shifted(K, diag, y, self.probes)
        else:
            val = lml_quadform_logdet_shifted(K, diag, y)
        return val - self.log_marginal_likelihood_constant

    @torch.no_grad()
    def predict_f(self, X, full=False):
        """Posterior mean (M, 1) of f at X and its variance (M, 1), or with
        full=True its covariance (M, M)."""
        X = self._check_input(X)
        y = self._residual_y()
        Kff = self._Kff()
        Kfs = self.kernel.K(self.X, X)
        Lff = jittered_cholesky(Kff, extra_diag=self._noise_diag(add_jitter=True),
                                ladder_base=self.jitter)
        v = solve_triangular(Lff, Kfs)
        mu = Kfs.T @ cholesky_solve(Lff, y)
        return mu, _posterior_var(self.kernel, X, full, v)


def _gaussian_only(likelihood, model):
    """The sparse and variational models take the Gaussian likelihood only."""
    if likelihood is None:
        return GaussianLikelihood(1.0)
    if not isinstance(likelihood, GaussianLikelihood):
        raise NotImplementedError("%s with a %s: only the Gaussian likelihood is ported; the "
                                  "others are ROADMAP queue 1, item 9"
                                  % (model, type(likelihood).__name__))
    return likelihood


class _Inducing(Model):
    """A model with trained inducing points Z: the Parameter
    "induction_points", column 0 the channel ID for a multi-output kernel.
    The channel column goes to the Gram as an integer, so its gradient is
    zero and an optimizer step leaves it as it is."""

    def _set_inducing(self, Z, Z_init, train=True):
        Z = init_inducing_points(Z, self.X, method=Z_init, output_dims=self.kernel.output_dims)
        self.Z = Parameter(self._check_input(Z), name="induction_points", train=train)
        if train and self.kernel.output_dims is not None:
            self.Z.num_parameters -= self.Z.shape[0]
        self.to(device=self.device)


class Snelson(_Inducing):
    """Sparse GP with FITC inducing points, Snelson & Ghahramani 2005 (JAX:
    gpr/model.py:787-856).

    Args:
        Z: inducing points, or their number (init_inducing_points).
        Z_init: 'grid', 'random' or 'density'.
        variance: noise variance, a float or one per channel.
    """

    def __init__(self, kernel, X, y, Z=10, Z_init="grid", variance=1.0, jitter=1e-8, mean=None,
                 device=None):
        variance = np.asarray(variance, dtype=np.float64).squeeze()
        if 1 < variance.ndim or (variance.ndim == 1 and variance.shape[0] != kernel.output_dims):
            raise ValueError("variance must be float or have shape (channels,)")
        super().__init__(kernel, X, y, GaussianLikelihood(np.sqrt(variance)), jitter, mean, device)
        self._set_inducing(Z, Z_init)
        self.log_marginal_likelihood_constant = 0.5 * self.X.shape[0] * np.log(2.0 * np.pi)

    def _common(self):
        y = self._residual_y()
        Kff_diag = self.kernel.K_diag(self.X)
        Z = self.Z()
        Kuf = self.kernel.K(Z, self.X)
        Kuu = self.kernel.K(Z)
        Luu = self._cholesky(Kuu, add_jitter=True)
        v = solve_triangular(Luu, Kuf)                       # Kuu^(-1/2)·Kuf
        noise = self._index_channel(self.likelihood.scale() ** 2, self.X)
        noise = noise.reshape(-1).expand(self.X.shape[0])
        g = Kff_diag - torch.sum(v * v, dim=0) + noise      # diag(Kff − Qff) + σ²
        eye = torch.eye(Z.shape[0], dtype=y.dtype, device=y.device)
        vG = v / g[None, :]
        L = self._cholesky(vG @ v.T + eye)
        return y, Luu, v, g, vG, L

    def log_marginal_likelihood(self):
        """FITC LML (JAX: Snelson.log_marginal_likelihood)."""
        y, Luu, v, g, vG, L = self._common()
        c = solve_triangular(L, vG @ y)
        p = -self.log_marginal_likelihood_constant
        p = p - torch.sum(torch.log(torch.diagonal(L)))
        p = p - 0.5 * torch.sum(torch.log(g))
        p = p - 0.5 * torch.sum(y * (y / g[:, None]))
        p = p + 0.5 * torch.sum(c * c)
        return p

    @torch.no_grad()
    def predict_f(self, X, full=False):
        """FITC posterior mean and variance, or covariance with full=True."""
        X = self._check_input(X)
        y, Luu, v, g, vG, L = self._common()
        Kus = self.kernel.K(self.Z(), X)
        a = solve_triangular(Luu, Kus)
        b = solve_triangular(L, a)
        c = solve_triangular(L, vG @ y)
        return b.T @ c, _posterior_var(self.kernel, X, full, a, b)


class OpperArchambeau(Model):
    """Variational GP, Opper & Archambeau 2009 (JAX: gpr/model.py:859-923),
    with the Gaussian likelihood: q(f) has one mean parameter q_nu and one
    precision parameter q_lambda per data point."""

    def __init__(self, kernel, X, y, likelihood=None, jitter=1e-8, mean=None, device=None):
        likelihood = _gaussian_only(likelihood, "OpperArchambeau")
        super().__init__(kernel, X, y, likelihood, jitter, mean, device)
        n = self.X.shape[0]
        self.q_nu = Parameter(np.zeros((n, 1)))
        self.q_lambda = Parameter(np.ones((n, 1)), lower=config.positive_minimum)
        self.to(device=self.device)

    def elbo(self):
        """The ELBO (JAX: OpperArchambeau.elbo; y is the residual of the
        mean, as there)."""
        y = self._residual_y()
        q_nu = self.q_nu()
        q_lambda = self.q_lambda()
        n = q_nu.shape[0]
        eye = torch.eye(n, dtype=y.dtype, device=y.device)
        Kff = self.kernel.K(self.X)
        L = self._cholesky(q_lambda * q_lambda.T * Kff + eye)
        invL = solve_triangular(L, eye)
        qf_mu = Kff @ q_nu
        qf_var_diag = 1.0 / q_lambda ** 2 - torch.diagonal(
            (invL.T @ invL) / q_lambda / q_lambda.T).reshape(-1, 1)
        kl = torch.sum(q_nu * qf_mu)
        kl = kl + torch.sum(torch.log(torch.diagonal(L) ** 2))
        kl = kl + torch.sum(invL ** 2)
        kl = kl - n
        var_exp = self.likelihood.variational_expectation(self.X, y, qf_mu, qf_var_diag)
        return var_exp - 0.5 * kl

    def log_marginal_likelihood(self):
        return self.elbo()

    @torch.no_grad()
    def predict_f(self, X, full=False):
        X = self._check_input(X)
        Kff = self.kernel.K(self.X)
        Kfs = self.kernel.K(self.X, X)
        L = self._cholesky(Kff + torch.diag((1.0 / self.q_lambda() ** 2).reshape(-1)))
        a = solve_triangular(L, Kfs)
        return Kfs.T @ self.q_nu(), _posterior_var(self.kernel, X, full, a)


class Titsias(_Inducing):
    """Collapsed sparse variational GP, Titsias 2009 (JAX: gpr/model.py:926-1008).

    Args:
        Z: inducing points, or their number (init_inducing_points).
        Z_init: 'grid', 'random' or 'density'.
        variance: the noise variance, a scalar (the collapsed bound treats
            σ² as one number, as the JAX package does).
    """

    def __init__(self, kernel, X, y, Z, Z_init="grid", variance=1.0, jitter=1e-8, mean=None,
                 device=None):
        variance = np.asarray(variance, dtype=np.float64)
        if variance.ndim != 0:
            raise ValueError("Titsias requires a scalar variance")
        super().__init__(kernel, X, y, GaussianLikelihood(np.sqrt(variance)), jitter, mean, device)
        self._set_inducing(Z, Z_init)
        self.log_marginal_likelihood_constant = 0.5 * self.X.shape[0] * np.log(2.0 * np.pi)

    def _whitened(self, Z):
        """Luu = chol(Kuu + jitter), v = Luu⁻¹Kuf, L = chol(vvᵀ/σ² + I). The
        wide product v·vᵀ is full float32 on the card (TF32 stays off)."""
        Kuf = self.kernel.K(Z, self.X)
        Kuu = self.kernel.K(Z)
        Luu = self._cholesky(Kuu, add_jitter=True)
        v = solve_triangular(Luu, Kuf)
        Q = v @ v.T
        eye = torch.eye(Z.shape[0], dtype=Q.dtype, device=Q.device)
        L = self._cholesky(Q / self.likelihood.scale() ** 2 + eye)
        return Luu, v, Q, L

    def elbo(self):
        """The collapsed ELBO (JAX: Titsias.elbo)."""
        y = self._residual_y()
        scale = self.likelihood.scale()
        sigma2 = scale ** 2
        Kff_diag = self.kernel.K_diag(self.X)
        _, v, Q, L = self._whitened(self.Z())
        c = solve_triangular(L, v @ y) / sigma2
        p = -self.log_marginal_likelihood_constant
        p = p - torch.sum(torch.log(torch.diagonal(L)))
        p = p - self.X.shape[0] * torch.log(scale)
        p = p - 0.5 * torch.sum(y * y) / sigma2
        p = p + 0.5 * torch.sum(c * c)
        p = p - 0.5 * (torch.sum(Kff_diag) - torch.trace(Q)) / sigma2
        return p

    def log_marginal_likelihood(self):
        return self.elbo()

    @torch.no_grad()
    def predict_f(self, X, full=False):
        """Posterior mean and variance, or covariance with full=True (JAX:
        Titsias.predict_f)."""
        X = self._check_input(X)
        y = self._residual_y()
        Z = self.Z()
        Kus = self.kernel.K(Z, X)
        Luu, v, _, L = self._whitened(Z)
        a = solve_triangular(Luu, Kus)
        b = solve_triangular(L, a)
        c = solve_triangular(L, v @ y) / self.likelihood.scale() ** 2
        return b.T @ c, _posterior_var(self.kernel, X, full, a, b)


class SparseHensman(_Inducing):
    """Sparse variational GP with whitened q(u), Hensman et al. 2015 (JAX:
    gpr/model.py:1011-1117), with the Gaussian likelihood:
    q(u) = N(L·q_mu, L·q_sqrt·q_sqrtᵀ·Lᵀ) with L Lᵀ = Kuu.

    Args:
        Z: inducing points or their number; None for the non-sparse case
            (inducing points = the data points, fixed; see Hensman).
        Z_init: 'grid', 'random' or 'density'.
    """

    def __init__(self, kernel, X, y, Z=None, Z_init="grid", likelihood=None, jitter=1e-8,
                 mean=None, device=None):
        likelihood = _gaussian_only(likelihood, type(self).__name__)
        super().__init__(kernel, X, y, likelihood, jitter, mean, device)
        self.is_sparse = Z is not None
        n = self.X.shape[0] if not self.is_sparse else None
        if self.is_sparse:
            Z = init_inducing_points(Z, self.X, method=Z_init, output_dims=kernel.output_dims)
            n = Z.shape[0]
        self.log_marginal_likelihood_constant = 0.5 * self.X.shape[0] * np.log(2.0 * np.pi)
        self.q_mu = Parameter(np.zeros((n, 1)))
        self.q_sqrt = Parameter(np.eye(n))
        self.q_sqrt.num_parameters = n * (n + 1) // 2
        if self.is_sparse:
            self._set_inducing(Z, Z_init)
        else:
            self._set_inducing(self.X, Z_init, train=False)

    def kl_gaussian(self, q_mu, q_sqrt):
        """KL(q(u) ‖ N(0, I)) in whitened space, with the trace term over
        every entry of the lower-triangular C (the JAX package's correction
        of the reference, which used diag(C)² only)."""
        C = torch.tril(q_sqrt)
        kl = torch.sum(q_mu * q_mu)
        kl = kl - torch.sum(torch.log(torch.diagonal(C) ** 2))
        kl = kl + torch.sum(C * C)
        kl = kl - q_mu.shape[0]
        return 0.5 * kl

    def elbo(self):
        """The SVGP ELBO (JAX: SparseHensman.elbo)."""
        y = self._residual_y()
        if self.is_sparse:
            qf_mu, qf_var_diag = self._predict_f(self.X)
        else:
            Kff = self.kernel.K(self.X)
            Lff = self._cholesky(Kff, add_jitter=True)
            qf_mu = Lff @ self.q_mu()
            qf_sqrt = Lff @ torch.tril(self.q_sqrt())
            qf_var_diag = torch.sum(qf_sqrt * qf_sqrt, dim=1).reshape(-1, 1)
        var_exp = self.likelihood.variational_expectation(self.X, y, qf_mu, qf_var_diag)
        return var_exp - self.kl_gaussian(self.q_mu(), self.q_sqrt())

    def log_marginal_likelihood(self):
        return self.elbo()

    def _predict_f(self, X, full=False):
        """The whitened posterior (JAX: SparseHensman._predict_f)."""
        Z = self.Z()
        Kuu = self.kernel.K(Z)
        Kus = self.kernel.K(Z, X)
        Luu = self._cholesky(Kuu, add_jitter=True)
        a = solve_triangular(Luu, Kus)
        b = torch.tril(self.q_sqrt()).T @ a
        mu = Kus.T @ solve_triangular(Luu.T, self.q_mu(), lower=False)
        return mu, _posterior_var(self.kernel, X, full, a, b)

    @torch.no_grad()
    def predict_f(self, X, full=False):
        X = self._check_input(X)
        return self._predict_f(X, full=full)


class Hensman(SparseHensman):
    """The non-sparse SparseHensman: the inducing points are the data points
    (JAX: gpr/model.py:1120-1125)."""

    def __init__(self, kernel, X, y, likelihood=None, jitter=1e-8, mean=None, device=None):
        super().__init__(kernel, X, y, None, "grid", likelihood, jitter, mean, device)
