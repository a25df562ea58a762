"""Likelihoods: the base class and the Gaussian likelihood.

JAX counterpart: mogptk_tpu/gpr/likelihood.py (`Likelihood` :88-135,
`GaussianLikelihood` :261-320). Ported: the Gaussian likelihood's
closed-form predictive bands, log density and variational expectation, what
exact and sparse Gaussian inference need. Quadrature, Monte Carlo bands and
the other likelihoods are later work (ROADMAP queue 1, item 9).
"""
import numpy as np
import torch

from .module import Module
from .parameter import Parameter
from .config import config


class Likelihood(Module):
    """Base likelihood."""

    def __init__(self):
        super().__init__()
        self.output_dims = None

    def predict(self, X, mu, var, ci=None, sigma=None):
        """Predictive mean and optional (lower, upper) bands of y."""
        raise NotImplementedError("only the Gaussian likelihood's predict is ported "
                                  "(ROADMAP queue 1, item 9)")

    def log_prob(self, X, y, f):
        """log p(y|f), per point."""
        raise NotImplementedError("only the Gaussian likelihood's log density is ported "
                                  "(ROADMAP queue 1, item 9)")

    def variational_expectation(self, X, y, mu, var, weights=None):
        """∫ log p(y|f) N(f|mu, var) df, summed over the points (each scaled
        by `weights` (N,) when given)."""
        raise NotImplementedError("only the Gaussian likelihood's variational expectation is "
                                  "ported; quadrature is ROADMAP queue 1, item 9")


def _weighted_sum(p, weights):
    """Sum of per-point terms p (N, 1), each scaled by weights (N,) when
    given (JAX: gpr/likelihood._weighted_sum)."""
    if weights is None:
        return torch.sum(p)
    return torch.sum(p * weights.reshape(-1, 1))


class GaussianLikelihood(Likelihood):
    """p(y|f) = N(y|f, σ²); σ is a scalar or one per channel."""

    def __init__(self, scale=1.0):
        super().__init__()
        self.scale = Parameter(scale, lower=config.positive_minimum)
        if self.scale.ndim == 1:
            self.output_dims = self.scale.shape[0]

    def _scale_per_point(self, X):
        s = self.scale()
        if self.output_dims is None or s.ndim != 1:
            return s
        return s[X[:, 0].long()][:, None]

    def log_prob(self, X, y, f):
        s = self._scale_per_point(X)
        return -0.5 * (np.log(2.0 * np.pi) + 2.0 * torch.log(s) + ((y - f) / s) ** 2)

    def variational_expectation(self, X, y, mu, var, weights=None):
        """Closed form (JAX: gpr/likelihood.py:289-294)."""
        s2 = self._scale_per_point(X) ** 2
        p = -((y - mu) ** 2 + var) / s2
        p = p - np.log(2.0 * np.pi) - torch.log(s2)
        return 0.5 * _weighted_sum(p, weights)

    def predict(self, X, mu, var, ci=None, sigma=None):
        if ci is None and sigma is None:
            return mu
        var_y = var + self._scale_per_point(X) ** 2
        if sigma is None:
            lo = mu + torch.sqrt(2.0 * var_y) * torch.special.erfinv(
                torch.tensor(2.0 * ci[0] - 1.0, dtype=mu.dtype, device=mu.device))
            up = mu + torch.sqrt(2.0 * var_y) * torch.special.erfinv(
                torch.tensor(2.0 * ci[1] - 1.0, dtype=mu.dtype, device=mu.device))
        else:
            lo = mu - sigma * torch.sqrt(var_y)
            up = mu + sigma * torch.sqrt(var_y)
        return mu, lo, up
