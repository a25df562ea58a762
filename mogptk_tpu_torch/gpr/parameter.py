"""Constrained parameters: a raw nn.Parameter behind a bijector, with an
optional prior and an optional peg to another Parameter.

JAX counterpart: mogptk_tpu/gpr/parameter.py (Transform, Softplus, Sigmoid,
Parameter). The raw value is unconstrained; calling the Parameter returns the
constrained value. Inverses are computed on the host in float64 numpy exactly
as in the JAX package, so both packages store identical raw values for the
same assignment. A prior is any object with log_prob(tensor) -> tensor (a
torch.distributions object, for example); log_prior() sums it at the
constrained value. A pegged Parameter reads its value from its target,
optionally through a transform, and is not trained.
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


def _prior_tensors(obj, depth=0):
    """The tensors an object holds in its attributes, two levels down (a
    torch.distributions object's parameters, a transformed distribution's
    base)."""
    if torch.is_tensor(obj):
        return [obj]
    if depth > 2 or not hasattr(obj, "__dict__"):
        return []
    out = []
    for v in vars(obj).values():
        if isinstance(v, (list, tuple)):
            for item in v:
                out += _prior_tensors(item, depth + 1)
        else:
            out += _prior_tensors(v, depth + 1)
    return out


class Parameter(nn.Module):
    """A trainable parameter with optional bounds, prior and peg. The
    constrained value is `param()`; the unconstrained value is the
    nn.Parameter `param.raw`.
    `name` is an explicit name (the JAX package's, e.g. "induction_points"),
    else gpr.convert.parameter_names gives "<OwnerClass>.<attribute>".
    `num_parameters` is the count of free values it contributes (BIC, AIC):
    its size, less what a model fixes (the inducing points' channel IDs,
    the upper triangle of a Cholesky factor), as in the JAX package.
    `prior` is an object with log_prob(tensor) -> tensor, or None."""

    def __init__(self, value, lower=None, upper=None, prior=None, train=True, name=None):
        super().__init__()
        self.name = name
        # a name given to assign() for a Parameter named by its owner: it
        # replaces the attribute in "<OwnerClass>.<attribute>"
        self.rename = None
        value = np.asarray(value.detach().cpu() if torch.is_tensor(value) else value,
                           dtype=np.float64)
        self.lower = None
        self.upper = None
        self.transform = None
        self.prior = prior
        # the peg target is held outside nn.Module's registry: registered as
        # a submodule it would appear a second time in named_modules(), under
        # this Parameter's path, and move or drop from gp_parameters()' order
        object.__setattr__(self, "pegged_parameter", None)
        self.pegged_transform = None
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

    @property
    def pegged(self):
        return self.pegged_parameter is not None

    def forward(self):
        if self.pegged_parameter is not None:
            other = self.pegged_parameter()
            return other if self.pegged_transform is None else self.pegged_transform(other)
        if self.transform is None:
            return self.raw
        return self.transform.forward(self.raw)

    def numpy(self):
        """The constrained value as a new numpy array (never a view of the
        live raw, which later steps update in place)."""
        return np.array(self().detach().cpu())

    def log_prior(self):
        """Log density of the prior at the constrained value, summed: a 0-d
        tensor on the parameter's device, or 0.0 without a prior
        (mogptk_tpu/gpr/parameter.py:298-305). A prior whose tensors lie on
        another device raises ValueError: it is never copied over."""
        if self.prior is None:
            return 0.0
        device = self.raw.device
        for t in _prior_tensors(self.prior):
            if t.device != device:
                raise ValueError("the prior's tensors are on %s and the parameter on %s; build "
                                 "the prior on the parameter's device" % (t.device, device))
        return self.prior.log_prob(self()).sum()

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

    def assign(self, value=None, name=None, lower=None, upper=None, prior=None, train=None):
        """Assign a constrained value, a name, new bounds, a prior and the
        train flag; unspecified fields are kept
        (mogptk_tpu/gpr/parameter.py:204-284). The value is clamped to the
        bounds, then inverted. A new name keeps the owner's prefix. Assigning
        to a pegged Parameter removes the peg and, unless train is given,
        trains it again."""
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
        if name is not None:
            if self.name is None:
                self.rename = name
            else:
                self.name = self.name[:self.name.rfind(".") + 1] + name
        if train is None and self.pegged:
            train = True
        with torch.no_grad():
            self.raw.copy_(torch.as_tensor(raw, dtype=self.raw.dtype))
        self.lower, self.upper, self.transform = lower, upper, transform
        if prior is not None:
            self.prior = prior
        object.__setattr__(self, "pegged_parameter", None)
        self.pegged_transform = None
        if train is not None:
            self.train = train

    def peg(self, other, transform=None):
        """Tie this parameter's value to `other`'s, as transform(other())
        when a transform is given; a pegged parameter is not trained
        (mogptk_tpu/gpr/parameter.py:286-296)."""
        if not isinstance(other, Parameter):
            raise ValueError("parameter must be pegged to other parameter object")
        elif other.pegged:
            raise ValueError("cannot peg parameter to another pegged parameter")
        object.__setattr__(self, "pegged_parameter", other)
        self.pegged_transform = transform
        self.train = False
