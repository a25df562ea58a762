"""Likelihoods: the base class and the Gaussian likelihood.

JAX counterpart: mogptk_tpu/gpr/likelihood.py (`Likelihood` :88-135,
`GaussianLikelihood` :261-320). Only what exact-GP prediction needs is ported:
the Gaussian likelihood's closed-form predictive bands. Quadrature, Monte
Carlo bands and the other likelihoods are later work.
"""
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
        raise NotImplementedError("only the Gaussian likelihood's predict is ported")


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
