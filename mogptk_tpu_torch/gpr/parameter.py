"""Constrained parameters: a raw nn.Parameter behind a bijector.

JAX counterpart: mogptk_tpu/gpr/parameter.py (Transform, Softplus, Sigmoid,
Parameter). The raw value is unconstrained; calling the Parameter returns the
constrained value. Inverses are computed on the host in float64 numpy exactly
as in the JAX package, so both packages store identical raw values for the
same assignment. Priors and pegging are not ported yet: a prior raises at
construction, so log_prior is 0.
"""
import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .config import config


class Transform:
    """Bijector between unconstrained and constrained space."""

    def forward(self, x):
        raise NotImplementedError()

    def inverse(self, y):
        raise NotImplementedError()


class Softplus(Transform):
    """y = lower + softplus(x; beta, threshold): beta > 0 bounds from below,
    beta < 0 from above. Above beta·x > threshold softplus is the identity,
    as in torch.nn.functional.softplus and the JAX package."""

    def __init__(self, lower=0.0, beta=0.1, threshold=20.0):
        self.lower = lower
        self.beta = beta
        self.threshold = threshold

    def forward(self, x):
        return _as_like(self.lower, x) + F.softplus(x, beta=self.beta, threshold=self.threshold)

    def inverse(self, y):
        d = np.asarray(y, dtype=np.float64) - np.asarray(self.lower, dtype=np.float64)
        bd = np.maximum(self.beta * d, 1e-300)
        return d + np.log(-np.expm1(-bd)) / self.beta


class Sigmoid(Transform):
    """y = lower + (upper − lower)·σ(x)."""

    def __init__(self, lower=0.0, upper=1.0):
        self.lower = lower
        self.upper = upper

    def forward(self, x):
        lower = _as_like(self.lower, x)
        return lower + (_as_like(self.upper, x) - lower) * torch.sigmoid(x)

    def inverse(self, y):
        y = np.asarray(y, dtype=np.float64)
        span = np.asarray(self.upper, dtype=np.float64) - np.asarray(self.lower, dtype=np.float64)
        span = np.where(span == 0.0, 1.0, span)
        eps = float(np.finfo(np.float64).eps)
        t = np.clip((y - self.lower) / span, eps, 1.0 - eps)
        return np.log(t) - np.log1p(-t)


def _as_like(bound, x):
    """A bound (float or numpy array) as a scalar or a tensor beside x."""
    if np.ndim(bound) == 0:
        return float(bound)
    return torch.as_tensor(bound, dtype=x.dtype, device=x.device)


def _align(value, shape, what):
    """Align trailing singleton dims of `value` to `shape`, as the JAX
    package does (mogptk_tpu/gpr/parameter.py:210-216)."""
    orig = value.shape
    while value.ndim < len(shape) and shape[value.ndim] == 1:
        value = value[..., None]
    while len(shape) < value.ndim and value.shape[-1] == 1:
        value = value[..., 0]
    if value.shape != tuple(shape):
        raise ValueError("%s shape must match: %s != %s" % (what, orig, tuple(shape)))
    return value


class Parameter(nn.Module):
    """A trainable parameter with optional bounds. The constrained value is
    `param()`; the unconstrained value is the nn.Parameter `param.raw`.
    `name` is an explicit name (the JAX package's, e.g. "induction_points"),
    else gpr.convert.parameter_names gives "<OwnerClass>.<attribute>".
    `num_parameters` is the count of free values it contributes (BIC, AIC):
    its size, less what a model fixes (the inducing points' channel IDs,
    the upper triangle of a Cholesky factor), as in the JAX package."""

    def __init__(self, value, lower=None, upper=None, prior=None, train=True, name=None):
        super().__init__()
        self.name = name
        if prior is not None:
            raise NotImplementedError("parameter priors are not ported yet")
        value = np.asarray(value.detach().cpu() if torch.is_tensor(value) else value,
                           dtype=np.float64)
        self.lower = None
        self.upper = None
        self.transform = None
        self.raw = nn.Parameter(torch.empty(value.shape, dtype=config.dtype),
                                requires_grad=bool(train))
        self.num_parameters = int(np.prod(value.shape)) if value.ndim else 1
        self.assign(value, lower=lower, upper=upper)

    @property
    def shape(self):
        return tuple(self.raw.shape)

    @property
    def ndim(self):
        return self.raw.ndim

    @property
    def train(self):
        return self.raw.requires_grad

    @train.setter
    def train(self, val):
        self.raw.requires_grad_(bool(val))

    def forward(self):
        if self.transform is None:
            return self.raw
        return self.transform.forward(self.raw)

    def numpy(self):
        """The constrained value as a new numpy array (never a view of the
        live raw, which later steps update in place)."""
        return np.array(self().detach().cpu())

    def log_prior(self):
        """Log density of the prior at the constrained value: 0, since no
        prior can be set yet."""
        return 0.0

    @staticmethod
    def to_transform(lower, upper):
        """Bound spec → bijector (mogptk_tpu/gpr/parameter.py:191-202)."""
        if lower is not None and upper is not None:
            if np.any(np.asarray(upper) < np.asarray(lower)):
                raise ValueError("lower limit %s must be lower than upper limit %s" % (lower, upper))
            return Sigmoid(lower=lower, upper=upper)
        elif lower is not None:
            return Softplus(lower=lower)
        elif upper is not None:
            return Softplus(lower=upper, beta=-0.1)
        return None

    def assign(self, value=None, lower=None, upper=None, train=None):
        """Assign a constrained value and/or new bounds, and optionally the
        train flag; unspecified fields are kept. The value is clamped to the
        bounds, then inverted."""
        if value is None:
            value = self.numpy().astype(np.float64)
        else:
            value = np.asarray(value.detach().cpu() if torch.is_tensor(value) else value,
                               dtype=np.float64)
            value = _align(value, self.shape, "parameter")
            # round to the storage dtype first, as the JAX package does
            value = torch.as_tensor(value, dtype=self.raw.dtype).double().numpy()

        def coerce(b):
            b = np.asarray(b, dtype=np.float64)
            return b if b.ndim == 0 else _align(b, value.shape, "bound")

        lower = self.lower if lower is None else coerce(lower)
        upper = self.upper if upper is None else coerce(upper)
        transform = Parameter.to_transform(lower, upper)
        if lower is not None:
            value = np.maximum(value, lower)
        if upper is not None:
            value = np.minimum(value, upper)
        raw = value if transform is None else transform.inverse(value)
        with torch.no_grad():
            self.raw.copy_(torch.as_tensor(raw, dtype=self.raw.dtype))
        self.lower, self.upper, self.transform = lower, upper, transform
        if train is not None:
            self.train = train
