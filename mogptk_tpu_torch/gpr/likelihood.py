"""Likelihoods with Gauss-Hermite quadrature and Monte Carlo predictive bands.

JAX counterpart: mogptk_tpu/gpr/likelihood.py (the link functions :28-65,
`GaussHermiteQuadrature` :68-85, `Likelihood` :88-135,
`MultiOutputLikelihood` :138-258 and the twelve likelihoods :261-668).

- Quadrature is one (N, deg) broadcast and a matvec on the device of mu.
- MultiOutputLikelihood evaluates every channel's likelihood over the whole
  batch on masked, in-support values (`_SAFE_Y`) and sums the one-hot masked
  results, as the JAX package does: no scatter, and no NaN gradient from a
  channel's rows under another channel's likelihood.
- Draws come from an explicit torch.Generator (`generator=`; None takes
  gpr.config.generator on the tensor's device), never from torch's global
  RNG. Gamma and Beta draws go through torch._standard_gamma, Student's t
  is a normal over √(2·Gamma(ν/2)/ν), Laplace and logistic draws come from
  uniforms on (0, 1). They follow the same laws as jax.random's, not the
  same bits.
"""
import math

import numpy as np
import torch
from torch import nn

from .module import Module
from .parameter import Parameter
from .config import config


# -- link functions -----------------------------------------------------------

def identity(x):
    """y = x"""
    return x


def square(x):
    """y = x²"""
    return torch.square(x)


def exp(x):
    """y = eˣ"""
    return torch.exp(x)


def probit(x):
    """y = √2 · erf⁻¹(2x−1)"""
    return np.sqrt(2.0) * torch.special.erfinv(2.0 * x - 1.0)


def inv_probit(x):
    """y = ½(1 + erf(x/√2)), jittered away from {0,1}"""
    jitter = 1e-3
    return 0.5 * (1.0 + torch.special.erf(x / np.sqrt(2.0))) * (1.0 - 2.0 * jitter) + jitter


def sigmoid(x):
    """y = 1/(1+e⁻ˣ)"""
    return 1.0 / (1.0 + torch.exp(-x))


def _weighted_sum(p, weights):
    """Sum of per-point terms p (N, 1), each scaled by weights (N,) when
    given (a weight of 0 drops a row)."""
    if weights is None:
        return torch.sum(p)
    return torch.sum(p * weights.reshape(-1, 1))


def _generator(generator, like):
    """`generator`, or the package's generator on `like`'s device."""
    return config.generator(like.device) if generator is None else generator


def _uniform_open(shape, generator, like):
    """Uniform draws on the open interval (0, 1): torch.rand's [0, 1) kept
    one machine epsilon away from both ends."""
    eps = torch.finfo(like.dtype).eps
    u = torch.rand(shape, generator=generator, dtype=like.dtype, device=like.device)
    return u.clamp_(eps, 1.0 - eps)


def _standard_gamma(alpha, shape, generator, like):
    """Gamma(alpha, 1) draws of `shape` (alpha broadcast to it)."""
    alpha = torch.as_tensor(alpha, dtype=like.dtype, device=like.device)
    return torch._standard_gamma(alpha.expand(shape).contiguous(), generator=generator)


def _log_standard_gamma(alpha, shape, generator, like):
    """log Gamma(alpha, 1) draws, finite for small alpha: Gamma(α) is
    Gamma(α + 1)·U^(1/α), whose draws underflow to 0 in float32 for α ≲ 1e-2
    while their logarithms do not."""
    alpha = torch.as_tensor(alpha, dtype=like.dtype, device=like.device).expand(shape)
    g = _standard_gamma(alpha + 1.0, shape, generator, like)
    return torch.log(g) + torch.log(_uniform_open(shape, generator, like)) / alpha


class GaussHermiteQuadrature:
    """∫F(f)N(f|μ,σ²)df ≈ Σ_k w_k F(μ + σ t_k), batched over data points.
    The nodes and weights are numpy's hermgauss(deg), scaled."""

    def __init__(self, deg=20, t_scale=None, w_scale=None):
        t, w = np.polynomial.hermite.hermgauss(deg)
        if t_scale is not None:
            t = t * t_scale
        if w_scale is not None:
            w = w * w_scale
        self._t = t
        self._w = w
        self.deg = deg

    def __call__(self, mu, var, F):
        t = torch.as_tensor(self._t, dtype=mu.dtype, device=mu.device).reshape(1, -1)  # 1xdeg
        w = torch.as_tensor(self._w, dtype=mu.dtype, device=mu.device).reshape(-1, 1)  # degx1
        return F(mu + torch.sqrt(var) * t) @ w  # Nx1


class Likelihood(Module):
    """Base likelihood: the variational expectation by quadrature and the
    predictive mean by quadrature with Monte Carlo bands."""

    def __init__(self, quadratures=20):
        super().__init__()
        self.quadrature = GaussHermiteQuadrature(deg=quadratures, t_scale=np.sqrt(2),
                                                 w_scale=1.0 / np.sqrt(np.pi))
        self.output_dims = None

    def validate_y(self, X, y):
        """Raise ValueError where y (numpy, on the host) is outside the
        likelihood's support."""

    def log_prob(self, X, y, f):
        """log p(y|f); y is (N, 1), f is (N, deg) → (N, deg)."""
        raise NotImplementedError()

    def variational_expectation(self, X, y, mu, var, weights=None):
        """∫ log p(y|f) N(f|mu, var) df by quadrature, summed over the points
        (each scaled by `weights` (N,) when given)."""
        q = self.quadrature(mu, var, lambda f: self.log_prob(X, y, f))
        return _weighted_sum(q, weights)

    def conditional_mean(self, X, f):
        raise NotImplementedError()

    def conditional_sample(self, X, f, generator=None):
        """Draws of y ~ p(y|f); f is (S, N), (S, N, 1) or (N, deg). None
        where the likelihood cannot draw y."""
        raise NotImplementedError()

    def predict(self, X, mu, var, ci=None, sigma=None, n=10000, generator=None):
        """The predictive mean of y by quadrature and, with ci = [lower,
        upper] quantiles, the (mean, lower, upper) bands from n Monte Carlo
        draws of f ~ N(mu, var) and y ~ p(y|f)."""
        mean = self.quadrature(mu, var, lambda f: self.conditional_mean(X, f))
        if ci is None:
            return mean

        generator = _generator(generator, mu)
        eps = torch.randn((n,) + tuple(mu.shape), generator=generator, dtype=mu.dtype,
                          device=mu.device)
        samples_f = mu[None, :, :] + torch.sqrt(var)[None, :, :] * eps
        samples_y = self.conditional_sample(X, samples_f, generator=generator)  # nxNx1
        if samples_y is None:
            return mean, mean, mean
        samples_y = torch.sort(samples_y, dim=0).values
        # ci = 1.0 gives index n: clamp it to the last draw, as JAX's gather does
        lower = min(int(ci[0] * n + 0.5), n - 1)
        upper = min(int(ci[1] * n + 0.5), n - 1)
        return mean, samples_y[lower, :], samples_y[upper, :]


class MultiOutputLikelihood(Likelihood):
    """A likelihood per channel; column 0 of X holds the channel IDs. Each
    channel's likelihood runs over the whole batch on in-support values and
    one-hot masks combine them."""

    _SAFE_Y = 0.5  # inside the support of every likelihood

    def __init__(self, *likelihoods):
        super().__init__()
        if len(likelihoods) == 1 and isinstance(likelihoods[0], list):
            likelihoods = likelihoods[0]
        likelihoods = list(likelihoods)
        if len(likelihoods) == 0:
            raise ValueError("must pass at least one likelihood")
        for likelihood in likelihoods:
            if not issubclass(type(likelihood), Likelihood):
                raise ValueError("must pass likelihoods")
            elif isinstance(likelihood, MultiOutputLikelihood):
                raise ValueError("can not nest MultiOutputLikelihoods")
        self.output_dims = len(likelihoods)
        self.likelihoods = nn.ModuleList(likelihoods)

    def name(self):
        return "[%s]" % ",".join(likelihood.name() for likelihood in self.likelihoods)

    def _channel_masks(self, X):
        c = X[:, 0].long()
        return [(c == i) for i in range(self.output_dims)]

    def validate_y(self, X, y):
        if self.output_dims == 1:
            self.likelihoods[0].validate_y(X, y)
            return
        c = np.asarray(X[:, 0]).astype(np.int64)
        y = np.asarray(y)
        for i in range(self.output_dims):
            self.likelihoods[i].validate_y(X, y[c == i, :])

    def log_prob(self, X, y, f):
        masks = self._channel_masks(X)
        out = torch.zeros(torch.broadcast_shapes(y.shape, f.shape), dtype=f.dtype, device=f.device)
        for i in range(self.output_dims):
            m = masks[i][:, None]
            y_safe = torch.where(m, y, self._SAFE_Y)
            out = out + torch.where(m, self.likelihoods[i].log_prob(X, y_safe, f), 0.0)
        return out

    def variational_expectation(self, X, y, mu, var, weights=None):
        """By quadrature for every channel, a Gaussian one included."""
        masks = self._channel_masks(X)
        total = torch.zeros((), dtype=mu.dtype, device=mu.device)
        for i, likelihood in enumerate(self.likelihoods):
            m = masks[i][:, None]
            y_safe = torch.where(m, y, self._SAFE_Y)
            q = likelihood.quadrature(mu, var, lambda f: likelihood.log_prob(X, y_safe, f))
            total = total + _weighted_sum(torch.where(m, q, 0.0), weights)
        return total

    def conditional_mean(self, X, f):
        masks = self._channel_masks(X)
        out = torch.zeros(f.shape, dtype=f.dtype, device=f.device)
        for i in range(self.output_dims):
            m = masks[i][:, None]
            out = out + torch.where(m, self.likelihoods[i].conditional_mean(X, f), 0.0)
        return out

    def conditional_sample(self, X, f, generator=None):
        generator = _generator(generator, f)
        masks = self._channel_masks(X)
        out = torch.zeros(f.shape, dtype=f.dtype, device=f.device)
        for i in range(self.output_dims):
            s = self.likelihoods[i].conditional_sample(X, f, generator=generator)
            if s is None:
                # a channel that cannot draw y (Bernoulli) leaves the whole
                # draw undefined, rather than passing f off as y
                return None
            # f carries the data axis second for ndim >= 2: (S, N) from
            # sample_y, (S, N, 1) from predict's Monte Carlo bands
            m = (masks[i][None, :, None] if f.ndim == 3
                 else masks[i][None, :] if f.ndim == 2 else masks[i])
            out = out + torch.where(m, s, 0.0)
        return out

    def predict(self, X, mu, var, ci=None, sigma=None, n=10000, generator=None):
        masks = self._channel_masks(X)
        if ci is None:
            out = torch.zeros(mu.shape, dtype=mu.dtype, device=mu.device)
            for i in range(self.output_dims):
                m = masks[i][:, None]
                # the mean only: sigma=None, since a Gaussian channel with
                # sigma set returns a (mu, lo, up) tuple, which cannot be
                # masked (predict_y turns sigma into ci before this)
                p = self.likelihoods[i].predict(X, mu, var, ci=None, sigma=None, n=n,
                                                generator=generator)
                out = out + torch.where(m, p, 0.0)
            return out
        generator = _generator(generator, mu)
        mean = torch.zeros(mu.shape, dtype=mu.dtype, device=mu.device)
        lower = torch.zeros(mu.shape, dtype=mu.dtype, device=mu.device)
        upper = torch.zeros(mu.shape, dtype=mu.dtype, device=mu.device)
        for i in range(self.output_dims):
            m = masks[i][:, None]
            p, lo, up = self.likelihoods[i].predict(X, mu, var, ci=ci, sigma=sigma, n=n,
                                                    generator=generator)
            mean = mean + torch.where(m, p, 0.0)
            lower = lower + torch.where(m, lo, 0.0)
            upper = upper + torch.where(m, up, 0.0)
        return mean, lower, upper


class GaussianLikelihood(Likelihood):
    """p(y|f) = N(y|f, σ²); σ is a scalar or one per channel. Closed-form
    variational expectation and bands."""

    def __init__(self, scale=1.0):
        super().__init__()
        self.scale = Parameter(scale, lower=config.positive_minimum)
        if self.scale.ndim == 1:
            self.output_dims = self.scale.shape[0]

    def _scale_per_point(self, X, like=None, n_axis=0):
        """Per-point noise scale, shaped to broadcast against `like` with the
        data axis at `n_axis` (f is (N, deg) in log_prob, (S, N[, 1]) in
        conditional_sample)."""
        s = self.scale()
        if self.output_dims is None or s.ndim != 1:
            return s
        s = s[X[:, 0].long()]  # N
        if like is None:
            return s[:, None]
        shape = [1] * like.ndim
        shape[n_axis] = X.shape[0]
        return s.reshape(shape)

    def log_prob(self, X, y, f):
        s = self._scale_per_point(X)
        return -0.5 * (np.log(2.0 * np.pi) + 2.0 * torch.log(s) + ((y - f) / s) ** 2)

    def variational_expectation(self, X, y, mu, var, weights=None):
        """Closed form."""
        s2 = self._scale_per_point(X) ** 2
        p = -((y - mu) ** 2 + var) / s2
        p = p - np.log(2.0 * np.pi) - torch.log(s2)
        return 0.5 * _weighted_sum(p, weights)

    def conditional_mean(self, X, f):
        return f

    def conditional_sample(self, X, f, generator=None):
        generator = _generator(generator, f)
        # the data axis is second for (S, N) and (S, N, 1), whatever S is
        n_axis = 1 if f.ndim >= 2 else 0
        s = self._scale_per_point(X, like=f, n_axis=n_axis)
        return f + s * torch.randn(f.shape, generator=generator, dtype=f.dtype, device=f.device)

    def predict(self, X, mu, var, ci=None, sigma=None, n=10000, generator=None):
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


class StudentTLikelihood(Likelihood):
    """Student's t likelihood with `dof` degrees of freedom."""

    def __init__(self, dof=3, scale=1.0, quadratures=20):
        super().__init__(quadratures)
        self.dof = float(dof)
        self.scale = Parameter(scale, lower=config.positive_minimum)

    def log_prob(self, X, y, f):
        s = self.scale()
        p = -0.5 * (self.dof + 1.0) * torch.log1p(((y - f) / s) ** 2 / self.dof)
        p = p + (math.lgamma((self.dof + 1.0) / 2.0) - math.lgamma(self.dof / 2.0))
        p = p - (0.5 * (np.log(self.dof) + np.log(np.pi)) + torch.log(s))
        return p

    def conditional_mean(self, X, f):
        if self.dof <= 1.0:
            return torch.full(f.shape, float("nan"), dtype=f.dtype, device=f.device)
        return f

    def conditional_sample(self, X, f, generator=None):
        generator = _generator(generator, f)
        z = torch.randn(f.shape, generator=generator, dtype=f.dtype, device=f.device)
        g = _standard_gamma(self.dof / 2.0, f.shape, generator, f)
        return f + self.scale() * z / torch.sqrt(2.0 * g / self.dof)


class ExponentialLikelihood(Likelihood):
    """p(y|f) = Exp(y | rate = 1/h(f))."""

    def __init__(self, link=exp, quadratures=20):
        super().__init__(quadratures)
        self.link = link

    def validate_y(self, X, y):
        if np.any(np.asarray(y) < 0.0):
            raise ValueError("y must be positive")

    def log_prob(self, X, y, f):
        if self.link is exp:
            return -y / self.link(f) - f
        return -y / self.link(f) - torch.log(self.link(f))

    def variational_expectation(self, X, y, mu, var, weights=None):
        if self.link is not exp:
            return super().variational_expectation(X, y, mu, var, weights)
        p = -mu - y * torch.exp(var / 2.0 - mu)
        return _weighted_sum(p, weights)

    def conditional_mean(self, X, f):
        return self.link(f)

    def conditional_sample(self, X, f, generator=None):
        if self.link is not exp:
            raise ValueError("only exponential link function is supported")
        generator = _generator(generator, f)
        e = torch.empty(f.shape, dtype=f.dtype, device=f.device).exponential_(generator=generator)
        return self.link(f) * e


class LaplaceLikelihood(Likelihood):
    """Laplace likelihood."""

    def __init__(self, scale=1.0, quadratures=20):
        super().__init__(quadratures)
        self.scale = Parameter(scale, lower=config.positive_minimum)

    def log_prob(self, X, y, f):
        return -torch.log(2.0 * self.scale()) - torch.abs(y - f) / self.scale()

    def conditional_mean(self, X, f):
        return f

    def conditional_sample(self, X, f, generator=None):
        generator = _generator(generator, f)
        u = _uniform_open(f.shape, generator, f)
        z = torch.where(u < 0.5, torch.log(2.0 * u), -torch.log(2.0 * (1.0 - u)))
        return f + self.scale() * z


class BernoulliLikelihood(Likelihood):
    """Bernoulli likelihood; with the probit link its predictive mean is
    closed-form."""

    def __init__(self, link=inv_probit):
        super().__init__()
        self.link = link

    def validate_y(self, X, y):
        y = np.asarray(y)
        if np.any((y != 0.0) & (y != 1.0)):
            raise ValueError("y must have only 0.0 and 1.0 values")

    def log_prob(self, X, y, f):
        p = self.link(f)
        return torch.log(torch.where(0.5 <= y, p, 1.0 - p))

    def conditional_mean(self, X, f):
        return self.link(f)

    def conditional_sample(self, X, f, generator=None):
        return None

    def predict(self, X, mu, var, ci=None, sigma=None, n=10000, generator=None):
        if self.link is not inv_probit:
            return super().predict(X, mu, var, ci=ci, sigma=sigma, n=n, generator=generator)
        p = self.link(mu / torch.sqrt(1.0 + var))
        if ci is None and sigma is None:
            return p
        return p, p, p


class BetaLikelihood(Likelihood):
    """Beta likelihood with mean h(f) and precision `scale`."""

    def __init__(self, scale=1.0, link=inv_probit, quadratures=20):
        super().__init__(quadratures)
        self.link = link
        self.scale = Parameter(scale, lower=config.positive_minimum)

    def validate_y(self, X, y):
        y = np.asarray(y)
        if np.any((y <= 0.0) | (1.0 <= y)):
            raise ValueError("y must be in the range (0.0,1.0)")

    def log_prob(self, X, y, f):
        mixture = self.link(f)
        alpha = mixture * self.scale()
        beta = self.scale() - alpha
        p = (alpha - 1.0) * torch.log(y)
        p = p + (beta - 1.0) * torch.log1p(-y)
        p = p + (torch.special.gammaln(alpha + beta) - torch.special.gammaln(alpha)
                 - torch.special.gammaln(beta))
        return p

    def conditional_mean(self, X, f):
        return self.link(f)

    def conditional_sample(self, X, f, generator=None):
        if self.link is not inv_probit:
            raise ValueError("only inverse probit link function is supported")
        generator = _generator(generator, f)
        alpha = self.link(f) * self.scale()
        beta = self.scale() - alpha
        # Gα/(Gα + Gβ) from the logarithms of the two draws
        la = _log_standard_gamma(alpha, f.shape, generator, f)
        lb = _log_standard_gamma(beta, f.shape, generator, f)
        return torch.sigmoid(la - lb)


class GammaLikelihood(Likelihood):
    """Gamma likelihood with shape `shape` and scale h(f)."""

    def __init__(self, shape=1.0, link=exp, quadratures=20):
        super().__init__(quadratures)
        self.link = link
        self.shape = Parameter(shape, lower=config.positive_minimum)

    def validate_y(self, X, y):
        if np.any(np.asarray(y) <= 0.0):
            raise ValueError("y must be in the range (0.0,inf)")

    def log_prob(self, X, y, f):
        p = -y / self.link(f)
        p = p + (self.shape() - 1.0) * torch.log(y)
        p = p - torch.special.gammaln(self.shape())
        if self.link is exp:
            p = p - self.shape() * f
        else:
            p = p - self.shape() * torch.log(self.link(f))
        return p

    def variational_expectation(self, X, y, mu, var, weights=None):
        if self.link is not exp:
            return super().variational_expectation(X, y, mu, var, weights)
        p = -self.shape() * mu
        p = p - torch.special.gammaln(self.shape())
        p = p + (self.shape() - 1.0) * torch.log(y)
        p = p - y * torch.exp(var / 2.0 - mu)
        return _weighted_sum(p, weights)

    def conditional_mean(self, X, f):
        return self.shape() * self.link(f)

    def conditional_sample(self, X, f, generator=None):
        if self.link is not exp:
            raise ValueError("only exponential link function is supported")
        generator = _generator(generator, f)
        return self.link(f) * _standard_gamma(self.shape(), f.shape, generator, f)


class PoissonLikelihood(Likelihood):
    """Poisson likelihood with rate h(f)."""

    def __init__(self, link=exp, quadratures=20):
        super().__init__(quadratures)
        self.link = link

    def validate_y(self, X, y):
        y = np.asarray(y)
        if np.any(y < 0.0):
            raise ValueError("y must be in the range [0.0,inf)")
        if not np.all(y == y.astype(np.int64)):
            raise ValueError("y must have integer count values")

    def log_prob(self, X, y, f):
        if self.link is exp:
            p = y * f
        else:
            p = y * torch.log(self.link(f))
        p = p - torch.special.gammaln(y + 1.0)
        p = p - self.link(f)
        return p

    def variational_expectation(self, X, y, mu, var, weights=None):
        if self.link is not exp:
            return super().variational_expectation(X, y, mu, var, weights)
        p = y * mu - torch.exp(var / 2.0 + mu) - torch.special.gammaln(y + 1.0)
        return _weighted_sum(p, weights)

    def conditional_mean(self, X, f):
        return self.link(f)

    def conditional_sample(self, X, f, generator=None):
        if self.link is not exp:
            raise ValueError("only exponential link function is supported")
        generator = _generator(generator, f)
        return torch.poisson(self.link(f), generator=generator)


class WeibullLikelihood(Likelihood):
    """Weibull likelihood with shape `shape` and scale h(f)."""

    def __init__(self, shape=1.0, link=exp, quadratures=20):
        super().__init__(quadratures)
        self.link = link
        self.shape = Parameter(shape, lower=config.positive_minimum)

    def validate_y(self, X, y):
        if np.any(np.asarray(y) <= 0.0):
            raise ValueError("y must be in the range (0.0,inf)")

    def log_prob(self, X, y, f):
        if self.link is exp:
            p = -self.shape() * f
        else:
            p = -self.shape() * torch.log(self.link(f))
        p = p + torch.log(self.shape()) + (self.shape() - 1.0) * torch.log(y)
        p = p - (y / self.link(f)) ** self.shape()
        return p

    def conditional_mean(self, X, f):
        return self.link(f) * torch.exp(torch.special.gammaln(1.0 + 1.0 / self.shape()))

    def conditional_sample(self, X, f, generator=None):
        if self.link is not exp:
            raise ValueError("only exponential link function is supported")
        generator = _generator(generator, f)
        u = _uniform_open(f.shape, generator, f)
        return self.link(f) * (-torch.log(u)) ** (1.0 / self.shape())


class LogLogisticLikelihood(Likelihood):
    """Log-logistic likelihood with shape `shape` and scale h(f)."""

    def __init__(self, shape=1.0, link=exp, quadratures=20):
        super().__init__(quadratures)
        self.link = link
        self.shape = Parameter(shape, lower=config.positive_minimum)

    def validate_y(self, X, y):
        if np.any(np.asarray(y) < 0.0):
            raise ValueError("y must be in the range [0.0,inf)")

    def log_prob(self, X, y, f):
        if self.link is exp:
            p = -self.shape() * f
        else:
            p = -self.shape() * torch.log(self.link(f))
        p = p - 2.0 * torch.log1p((y / self.link(f)) ** self.shape())
        p = p + torch.log(self.shape())
        p = p + (self.shape() - 1.0) * torch.log(y)
        return p

    def conditional_mean(self, X, f):
        return self.link(f) / torch.sinc(1.0 / self.shape())

    def conditional_sample(self, X, f, generator=None):
        if self.link is not exp:
            raise ValueError("only exponential link function is supported")
        generator = _generator(generator, f)
        # log-logistic = exp(logistic(loc=f, scale=1/shape))
        u = _uniform_open(f.shape, generator, f)
        z = torch.log(u) - torch.log1p(-u)
        return torch.exp(f + z / self.shape())


class LogGaussianLikelihood(Likelihood):
    """Log-Gaussian likelihood: log y ~ N(f, scale²)."""

    def __init__(self, scale=1.0, quadratures=20):
        super().__init__(quadratures)
        self.scale = Parameter(scale, lower=config.positive_minimum)

    def validate_y(self, X, y):
        if np.any(np.asarray(y) <= 0.0):
            raise ValueError("y must be in the range (0.0,inf)")

    def log_prob(self, X, y, f):
        logy = torch.log(y)
        p = -0.5 * (np.log(2.0 * np.pi) + 2.0 * torch.log(self.scale())
                    + ((logy - f) / self.scale()) ** 2)
        return p - logy

    def conditional_mean(self, X, f):
        return torch.exp(f + 0.5 * self.scale() ** 2)

    def conditional_sample(self, X, f, generator=None):
        generator = _generator(generator, f)
        z = torch.randn(f.shape, generator=generator, dtype=f.dtype, device=f.device)
        return torch.exp(f + self.scale() * z)


class ChiSquaredLikelihood(Likelihood):
    """Chi-squared likelihood with h(f) degrees of freedom."""

    def __init__(self, link=exp, quadratures=20):
        super().__init__(quadratures)
        self.link = link

    def validate_y(self, X, y):
        if np.any(np.asarray(y) <= 0.0):
            raise ValueError("y must be in the range (0.0,inf)")

    def log_prob(self, X, y, f):
        k = self.link(f)
        return (-0.5 * k * np.log(2.0) - torch.special.gammaln(k / 2.0)
                + (k / 2.0 - 1.0) * torch.log(y) - 0.5 * y)

    def conditional_mean(self, X, f):
        return self.link(f)

    def conditional_sample(self, X, f, generator=None):
        if self.link is not exp:
            raise ValueError("only exponential link function is supported")
        generator = _generator(generator, f)
        # Chi2(k) = Gamma(k/2, scale=2)
        return 2.0 * _standard_gamma(self.link(f) / 2.0, f.shape, generator, f)
