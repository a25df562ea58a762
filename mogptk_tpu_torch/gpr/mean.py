"""Trainable mean functions.

JAX counterpart: mogptk_tpu/gpr/mean.py (:13-93); reference
mogptk/gpr/mean.py:4-151. A model with a mean fits y − m(X) and adds m(X)
back to its predictive mean.
"""
import numpy as np
import torch
from torch import nn

from .module import Module
from .parameter import Parameter
from .config import config


class Mean(Module):
    """Base trainable mean function: `mean(X)` maps (N, input_dims) to (N, 1)."""

    def forward(self, X):
        return self.mean(self._check_input(X))

    def _check_input(self, X):
        X = torch.as_tensor(X, dtype=config.dtype)
        if X.ndim != 2:
            raise ValueError("X should have two dimensions (data_points,input_dims)")
        if X.shape[0] == 0 or X.shape[1] == 0:
            raise ValueError("X must not be empty")
        return X

    def mean(self, X):
        raise NotImplementedError()


class MultiOutputMean(Mean):
    """One mean per channel; column 0 of X holds the channel IDs."""

    def __init__(self, *means):
        super().__init__()
        if len(means) == 1 and isinstance(means[0], list):
            means = means[0]
        else:
            means = list(means)
        if len(means) == 0:
            raise ValueError("must pass at least one mean")
        for mean in means:
            if not isinstance(mean, Mean):
                raise ValueError("must pass means")
            elif isinstance(mean, MultiOutputMean):
                raise ValueError("can not nest MultiOutputMeans")
        self.output_dims = len(means)
        self.means = nn.ModuleList(means)

    def name(self):
        return "[%s]" % ",".join(mean.name() for mean in self.means)

    def mean(self, X):
        # a one-hot sum over the channels; each sub-mean sees its own rows and,
        # on the other rows, its channel's first row: a mean that is not
        # finite off its channel (a log) cannot reach another channel through
        # 0·NaN, in the value or the gradient
        c = X[:, 0].long()
        x = X[:, 1:]
        out = torch.zeros(X.shape[0], 1, dtype=X.dtype, device=X.device)
        for i in range(self.output_dims):
            sel = (c == i)[:, None]
            anchor = x[torch.argmax(sel[:, 0].to(torch.uint8))][None, :]
            x_safe = torch.where(sel, x, anchor)
            mi = self.means[i].mean(x_safe).reshape(-1, 1)
            out = out + torch.where(sel, mi, out.new_zeros(()))
        return out


class ConstantMean(Mean):
    """m(X) = b."""

    def __init__(self):
        super().__init__()
        self.bias = Parameter(0.0)

    def mean(self, X):
        return torch.ones(X.shape[0], 1, dtype=X.dtype, device=X.device) * self.bias()


class LinearMean(Mean):
    """m(X) = X·a + b."""

    def __init__(self, input_dims=1):
        super().__init__()
        self.bias = Parameter(0.0)
        self.slope = Parameter(np.zeros(input_dims))

    def mean(self, X):
        return self.bias() + X @ self.slope().reshape(-1, 1)
