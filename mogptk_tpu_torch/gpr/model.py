"""GP models: the base Model and exact GP regression (training and
prediction).

JAX counterpart: mogptk_tpu/gpr/model.py (`Model` :126-360, `Exact`
:489-784). Ported: construction, the objective `loss()` = −LML − log prior,
the noise diagonal, the noiseless Gram `_Kff`, `predict_f`/`predict_y` on the
unmasked single-device branch, and `log_marginal_likelihood` with the probe-
trace gradient on channel-sorted data (`trace_probes`, the fused path
ops/linalg.lml_chol_fused). Elsewhere the LML is a value only: its backward
raises NotImplementedError (the closed-form gradient is ROADMAP queue 1,
item 2). Means, masks, meshes, sampling and the jitter ladder are later work.
Prediction recomputes the Gram and its factor on every call, as the JAX
package does.

On channel-sorted data the Gram goes through the K-gram kernel in one launch
(training: K-gram-lower, only the tiles the factorization reads), and on CUDA
float32 with n ≥ 4096 and n a multiple of 512 the factorization goes through
the K-spanel and K-colwrite kernels, the training solve through K-solve and
its backward through K-lowrank-vjp (ops/).
"""
import math

import numpy as np
import torch

from .module import Module
from .kernel import Kernel
from .likelihood import GaussianLikelihood
from .config import config, resolve_device
from ..ops.block_mosm import sorted_channel_counts, mosm_pair_stats
from ..ops.linalg import (jittered_cholesky, solve_triangular, cholesky_solve, lml_chol_fused,
                          lml_quadform_logdet_shifted, lml_quadform_logdet_stochastic_shifted)


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

    def predict_f(self, X):
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
        (family, counts, R), or None unless the data are channel-sorted (for
        the MOSM kernel, the one with a sorted Gram) and trace_probes is set (JAX:
        Exact._fused_static; the port has no Pallas switch, row mask, Gram
        sharding, jitter ladder or Gram storage format to gate on)."""
        if not self.trace_probes or self._channel_counts is None:
            return None
        return (self.kernel.family, self._channel_counts, self.trace_probes)

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
            st3, st2 = mosm_pair_stats(*self.kernel._params(), self.kernel.twopi)
            diag = self._noise_diag(add_jitter=True)
            val = lml_chol_fused(static, x, diag, self._residual_y(), st3, st2, self.probes)
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
    def predict_f(self, X):
        """Posterior mean and variance (M, 1) of f at X."""
        X = self._check_input(X)
        y = self._residual_y()
        Kff = self._Kff()
        Kfs = self.kernel.K(self.X, X)
        Lff = jittered_cholesky(Kff, extra_diag=self._noise_diag(add_jitter=True))
        v = solve_triangular(Lff, Kfs)
        mu = Kfs.T @ cholesky_solve(Lff, y)
        var = (self.kernel.K_diag(X) - torch.sum(v * v, dim=0)).reshape(-1, 1)
        return mu, var
