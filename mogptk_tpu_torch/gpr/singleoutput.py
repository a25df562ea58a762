"""Single-output kernels.

JAX counterpart: mogptk_tpu/gpr/singleoutput.py. Only `SpectralKernel`
(:351-376) is ported, without active_dims: BNSE (init.py) fits it. Its Gram
is plain torch, so autograd differentiates it inside the closed-form LML.
The other kernels are ROADMAP queue 1, item 9.
"""
import numpy as np
import torch

from .kernel import Kernel
from .parameter import Parameter
from .config import config

_pi = np.pi


class SpectralKernel(Kernel):
    """K(x,x') = σ² Σ_d exp(−2π²τ_d²Σ_d) cos(2πμ_dτ_d), Wilson & Adams'
    spectral component (reference: gpr/singleoutput.py:520-561)."""

    def __init__(self, input_dims=1):
        super().__init__(input_dims)
        self.magnitude = Parameter(1.0, lower=config.positive_minimum)
        self.mean = Parameter(np.zeros(input_dims), lower=config.positive_minimum)
        self.variance = Parameter(np.ones(input_dims), lower=config.positive_minimum)

    def K(self, X1, X2=None):
        X2e = X1 if X2 is None else X2
        var = self.variance()
        mu = self.mean()
        acc = None
        for d in range(self.input_dims):
            taud = X1[:, d][:, None] - X2e[:, d][None, :]
            t = torch.exp(-2.0 * _pi ** 2 * taud * taud * var[d]) * torch.cos(2.0 * _pi * taud * mu[d])
            acc = t if acc is None else acc + t
        return self.magnitude() * acc

    def K_diag(self, X1):
        return torch.ones(X1.shape[0], dtype=X1.dtype, device=X1.device) * (
            self.magnitude() * self.input_dims)
