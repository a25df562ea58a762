"""Single-output kernels.

JAX counterpart: mogptk_tpu/gpr/singleoutput.py (the 15 kernels and the
helpers `_prec_factor`, `_quadform_gemm`, `_quadform_unrolled` and
`_lengthscale_matrix` :143-195). Every Gram is plain torch over (N, M)
temporaries, the small input dimension unrolled in Python, and autograd
differentiates it. The formulations that decide the numbers are the JAX
package's: the GEMM squared-distance identity clamped at 0 for the SE, RQ
and Matern family's τᵀMτ, Sinc's guard against 0/0, and SpectralMixture's
sum of per-dimension exp·cos terms.

The identity ‖z1‖² + ‖z2‖² − 2 z1·z2ᵀ cancels to ~‖τ‖² for nearby points,
so its cross GEMM needs full float32: this package never enables TF32
(torch.backends.cuda.matmul.allow_tf32 stays False and the float32 matmul
precision "highest"), which is what the JAX package's
sensitive_matmul_scope asks of XLA there.
"""
import numpy as np
import torch

from .kernel import Kernel
from .parameter import Parameter
from .config import config

_pi = np.pi


def _ones(X):
    """(N,) ones beside X."""
    return torch.ones(X.shape[0], dtype=X.dtype, device=X.device)


def _diff(X1, X2e, d):
    """τ_d: the (N, M) differences of input dimension d."""
    return X1[:, d][:, None] - X2e[:, d][None, :]


class WhiteKernel(Kernel):
    """K(x,x') = σ² I (reference: gpr/singleoutput.py:5-35)."""

    def __init__(self, input_dims=1, active_dims=None):
        super().__init__(input_dims, active_dims)
        self.magnitude = Parameter(1.0, lower=config.positive_minimum)

    def K(self, X1, X2=None):
        X1, X2 = self._active_input(X1, X2)
        if X2 is None:
            return self.magnitude() * torch.eye(X1.shape[0], dtype=X1.dtype, device=X1.device)
        return torch.zeros(X1.shape[0], X2.shape[0], dtype=X1.dtype, device=X1.device)

    def K_diag(self, X1):
        X1, _ = self._active_input(X1)
        return _ones(X1) * self.magnitude()


class ConstantKernel(Kernel):
    """K(x,x') = σ² (reference: gpr/singleoutput.py:37-67)."""

    def __init__(self, input_dims=1, active_dims=None):
        super().__init__(input_dims, active_dims)
        self.magnitude = Parameter(1.0, lower=config.positive_minimum)

    def K(self, X1, X2=None):
        X1, X2 = self._active_input(X1, X2)
        if X2 is None:
            X2 = X1
        return self.magnitude() * torch.ones(X1.shape[0], X2.shape[0], dtype=X1.dtype,
                                             device=X1.device)

    def K_diag(self, X1):
        X1, _ = self._active_input(X1)
        return _ones(X1) * self.magnitude()


class LinearKernel(Kernel):
    """K(x,x') = σ² x·x' + c (reference: gpr/singleoutput.py:69-101)."""

    def __init__(self, input_dims=1, active_dims=None):
        super().__init__(input_dims, active_dims)
        self.bias = Parameter(0.0, lower=0.0)
        self.magnitude = Parameter(1.0, lower=config.positive_minimum)

    def K(self, X1, X2=None):
        X1, X2 = self._active_input(X1, X2)
        if X2 is None:
            X2 = X1
        return self.magnitude() * (X1 @ X2.T) + self.bias()

    def K_diag(self, X1):
        X1, _ = self._active_input(X1)
        return self.magnitude() * torch.sum(X1 * X1, dim=1) + self.bias()


class PolynomialKernel(Kernel):
    """K(x,x') = (σ² x·x' + c)^d (reference: gpr/singleoutput.py:103-138)."""

    def __init__(self, degree, input_dims=1, active_dims=None):
        super().__init__(input_dims, active_dims)
        self.degree = degree
        self.bias = Parameter(0.0, lower=0.0)
        self.magnitude = Parameter(1.0, lower=config.positive_minimum)

    def K(self, X1, X2=None):
        X1, X2 = self._active_input(X1, X2)
        if X2 is None:
            X2 = X1
        return (self.magnitude() * (X1 @ X2.T) + self.bias()) ** self.degree

    def K_diag(self, X1):
        X1, _ = self._active_input(X1)
        return (self.magnitude() * torch.sum(X1 * X1, dim=1) + self.bias()) ** self.degree


class FunctionKernel(Kernel):
    """K(x,x') = φ(x)ᵀ diag(σ²) φ(x') for a feature map φ that takes and
    returns torch tensors, (N, input_dims) → (N, feature_dims)
    (reference: gpr/singleoutput.py:140-179)."""

    def __init__(self, phi, input_dims=1, active_dims=None):
        super().__init__(input_dims, active_dims)
        out = phi(torch.ones(42, input_dims, dtype=config.dtype))
        if not torch.is_tensor(out) or out.ndim != 2 or out.shape[0] != 42:
            raise ValueError("phi must take (data_points,input_dims) as input, and return "
                             "(data_points,feature_dims) as output")
        self.magnitude = Parameter(np.ones(out.shape[1]), lower=config.positive_minimum)
        self.phi = phi

    def K(self, X1, X2=None):
        X1, X2 = self._active_input(X1, X2)
        f1 = self.phi(X1)
        f2 = f1 if X2 is None else self.phi(X2)
        return (f1 * self.magnitude()[None, :]) @ f2.T

    def K_diag(self, X1):
        X1, _ = self._active_input(X1)
        f1 = self.phi(X1)
        return torch.sum(f1 * self.magnitude()[None, :] * f1, dim=1)


class ExponentialKernel(Kernel):
    """K(x,x') = σ² exp(−½ Σ_d |τ_d|/l_d) (reference: gpr/singleoutput.py:181-216)."""

    def __init__(self, input_dims=1, active_dims=None):
        super().__init__(input_dims, active_dims)
        self.magnitude = Parameter(1.0, lower=config.positive_minimum)
        self.lengthscale = Parameter(np.ones(input_dims), lower=config.positive_minimum)

    def K(self, X1, X2=None):
        X1, X2 = self._active_input(X1, X2)
        X2e = X1 if X2 is None else X2
        invl = 1.0 / self.lengthscale()
        acc = None
        for d in range(self.input_dims):
            t = torch.abs(_diff(X1, X2e, d)) * invl[d]
            acc = t if acc is None else acc + t
        return self.magnitude() * torch.exp(-0.5 * acc)

    def K_diag(self, X1):
        X1, _ = self._active_input(X1)
        return _ones(X1) * self.magnitude()


def _lengthscale_matrix(kernel):
    """The precision matrix M = LLᵀ + diag(l)⁻² of the SE, RQ and periodic
    family: order −1 one lengthscale for every dimension, order 0 one per
    dimension, order > 0 also the (D, order) cross-lengthscales L."""
    inv2 = 1.0 / kernel.lengthscale() ** 2
    if kernel.order == -1:
        return torch.diag(inv2.reshape(1).repeat(kernel.input_dims))
    if kernel.order == 0:
        return torch.diag(inv2)
    L = kernel.cross_lengthscale()
    return L @ L.T + torch.diag(inv2)


def _prec_factor(kernel):
    """The upper factor R of M = RᵀR (D × D)."""
    return torch.linalg.cholesky(_lengthscale_matrix(kernel)).mT


def _quadform_gemm(kernel, X1, X2):
    """τᵀMτ for every pair by the GEMM squared-distance identity: with
    z = X Rᵀ, τᵀMτ = ‖z1‖² + ‖z2‖² − 2 z1·z2ᵀ, clamped at 0. The cross term
    is one GEMM, at full float32 (module docstring)."""
    R = _prec_factor(kernel)
    z1 = X1 @ R.T
    z2 = z1 if X2 is None else X2 @ R.T
    sq1 = torch.sum(z1 * z1, dim=1)
    sq2 = sq1 if X2 is None else torch.sum(z2 * z2, dim=1)
    q = sq1[:, None] + sq2[None, :] - 2.0 * (z1 @ z2.T)
    # maximum, not clamp: at q = 0 its gradient splits in half, as JAX's does
    return torch.maximum(q, q.new_zeros(()))


def _quadform_unrolled(tau_fn, D, Mmat):
    """τᵀMτ unrolled over the input dimensions, for a non-linear per-dimension
    transform (sin(πτ/p)); tau_fn(d) returns the (N, M) slice of dimension d."""
    cols = [tau_fn(d) for d in range(D)]
    out = None
    for i in range(D):
        row = None
        for j in range(D):
            term = Mmat[i, j] * cols[j]
            row = term if row is None else row + term
        contrib = cols[i] * row
        out = contrib if out is None else out + contrib
    return out


class _PrecisionKernel(Kernel):
    """Magnitude, lengthscale(s) and, for order > 0, cross-lengthscales, the
    parameters of the SE, RQ and periodic family, registered in the JAX
    package's order (`period` between the magnitude and the lengthscale for
    the periodic kernels)."""

    def __init__(self, order, input_dims, active_dims, period=False):
        super().__init__(input_dims, active_dims)
        lengthscale = 1.0 if order == -1 else np.ones(input_dims)
        self.order = order
        self.magnitude = Parameter(1.0, lower=config.positive_minimum)
        if period:
            self.period = Parameter(np.ones(input_dims), lower=config.positive_minimum)
        self.lengthscale = Parameter(lengthscale, lower=config.positive_minimum)
        if 0 < order:
            self.cross_lengthscale = Parameter(np.ones((input_dims, order)),
                                               lower=config.positive_minimum)

    def K_diag(self, X1):
        X1, _ = self._active_input(X1)
        return _ones(X1) * self.magnitude()


class SquaredExponentialKernel(_PrecisionKernel):
    """K(x,x') = σ² exp(−½ τᵀMτ) with optional cross-lengthscales
    (reference: gpr/singleoutput.py:218-268)."""

    def __init__(self, order=0, input_dims=1, active_dims=None):
        super().__init__(order, input_dims, active_dims)

    def K(self, X1, X2=None):
        X1, X2 = self._active_input(X1, X2)
        return self.magnitude() * torch.exp(-0.5 * _quadform_gemm(self, X1, X2))


class RationalQuadraticKernel(_PrecisionKernel):
    """K(x,x') = σ² (1 + τᵀMτ/(2α))^(−α) (reference: gpr/singleoutput.py:270-323)."""

    def __init__(self, alpha=1.0, order=0, input_dims=1, active_dims=None):
        super().__init__(order, input_dims, active_dims)
        self.alpha = alpha

    def K(self, X1, X2=None):
        X1, X2 = self._active_input(X1, X2)
        power = 1.0 + 0.5 * _quadform_gemm(self, X1, X2) / self.alpha
        return self.magnitude() * power ** (-self.alpha)


class PeriodicKernel(_PrecisionKernel):
    """K(x,x') = σ² exp(−2 sᵀMs), s_d = sin(πτ_d/p_d)
    (reference: gpr/singleoutput.py:325-379)."""

    def __init__(self, order=0, input_dims=1, active_dims=None):
        super().__init__(order, input_dims, active_dims, period=True)

    def _sin(self, X1, X2e):
        p = self.period()
        return lambda d: torch.sin(_pi * _diff(X1, X2e, d) / p[d])

    def K(self, X1, X2=None):
        X1, X2 = self._active_input(X1, X2)
        X2e = X1 if X2 is None else X2
        M = _lengthscale_matrix(self)
        q = _quadform_unrolled(self._sin(X1, X2e), self.input_dims, M)
        return self.magnitude() * torch.exp(-2.0 * q)


class LocallyPeriodicKernel(PeriodicKernel):
    """The periodic kernel times a squared-exponential envelope,
    σ² exp(−2 sᵀMs − ½ τᵀMτ) (reference: gpr/singleoutput.py:381-436)."""

    def K(self, X1, X2=None):
        X1, X2 = self._active_input(X1, X2)
        X2e = X1 if X2 is None else X2
        M = _lengthscale_matrix(self)
        q1 = _quadform_unrolled(self._sin(X1, X2e), self.input_dims, M)
        q2 = _quadform_unrolled(lambda d: _diff(X1, X2e, d), self.input_dims, M)
        return self.magnitude() * torch.exp(-2.0 * q1 - 0.5 * q2)


class CosineKernel(Kernel):
    """K(x,x') = σ² cos(2π Σ_d τ_d/l_d) (reference: gpr/singleoutput.py:438-473)."""

    def __init__(self, input_dims=1, active_dims=None):
        super().__init__(input_dims, active_dims)
        self.magnitude = Parameter(1.0, lower=config.positive_minimum)
        self.lengthscale = Parameter(np.ones(input_dims), lower=config.positive_minimum)

    def K(self, X1, X2=None):
        # the contraction with 1/l is linear in τ: (X1·v)[:, None] − (X2·v)[None, :]
        X1, X2 = self._active_input(X1, X2)
        v = 1.0 / self.lengthscale()
        z1 = X1 @ v
        z2 = z1 if X2 is None else X2 @ v
        return self.magnitude() * torch.cos(2.0 * _pi * (z1[:, None] - z2[None, :]))

    def K_diag(self, X1):
        X1, _ = self._active_input(X1)
        return _ones(X1) * self.magnitude()


class SincKernel(Kernel):
    """K(x,x') = σ² sinc(Δ·τ) cos(2π ξ·τ) (reference: gpr/singleoutput.py:475-518)."""

    def __init__(self, input_dims=1, active_dims=None):
        super().__init__(input_dims, active_dims)
        self.magnitude = Parameter(1.0, lower=config.positive_minimum)
        self.frequency = Parameter(np.ones(input_dims), lower=config.positive_minimum)
        self.bandwidth = Parameter(np.ones(input_dims), lower=config.positive_minimum)

    @staticmethod
    def _sinc(x):
        # 0 replaced by 1e-20 before the division: no 0/0, no NaN in the gradient
        x = torch.where(x == 0.0, torch.full_like(x, 1e-20), x)
        return torch.sin(_pi * x) / (_pi * x)

    def K(self, X1, X2=None):
        # both contractions are linear in τ: rank-1 projections
        X1, X2 = self._active_input(X1, X2)
        b1 = X1 @ self.bandwidth()
        b2 = b1 if X2 is None else X2 @ self.bandwidth()
        f1 = X1 @ self.frequency()
        f2 = f1 if X2 is None else X2 @ self.frequency()
        sinc = b1[:, None] - b2[None, :]
        cos = 2.0 * _pi * (f1[:, None] - f2[None, :])
        return self.magnitude() * self._sinc(sinc) * torch.cos(cos)

    def K_diag(self, X1):
        X1, _ = self._active_input(X1)
        return _ones(X1) * self.magnitude()


class SpectralKernel(Kernel):
    """K(x,x') = σ² Σ_d exp(−2π²τ_d²Σ_d) cos(2πμ_dτ_d), Wilson & Adams'
    spectral component (reference: gpr/singleoutput.py:520-561)."""

    def __init__(self, input_dims=1, active_dims=None):
        super().__init__(input_dims, active_dims)
        self.magnitude = Parameter(1.0, lower=config.positive_minimum)
        self.mean = Parameter(np.zeros(input_dims), lower=config.positive_minimum)
        self.variance = Parameter(np.ones(input_dims), lower=config.positive_minimum)

    def K(self, X1, X2=None):
        X1, X2 = self._active_input(X1, X2)
        X2e = X1 if X2 is None else X2
        return self.magnitude() * _spectral_sum(X1, X2e, self.mean(), self.variance())

    def K_diag(self, X1):
        X1, _ = self._active_input(X1)
        return _ones(X1) * (self.magnitude() * self.input_dims)


def _spectral_sum(X1, X2e, mu, var):
    """Σ_d exp(−2π²τ_d²var_d) cos(2πτ_d mu_d) over (N, M)."""
    acc = None
    for d in range(X1.shape[1]):
        taud = _diff(X1, X2e, d)
        t = torch.exp(-2.0 * _pi ** 2 * taud * taud * var[d]) * torch.cos(2.0 * _pi * taud * mu[d])
        acc = t if acc is None else acc + t
    return acc


class SpectralMixtureKernel(Kernel):
    """K(x,x') = Σ_q σ_q² Σ_d exp(−2π²τ_d²Σ_qd) cos(2πμ_qd τ_d): the
    per-dimension exp·cos terms are summed, as in SpectralKernel, so that
    SpectralMixtureKernel(Q, D) == MixtureKernel(SpectralKernel(D), Q)
    (reference: gpr/singleoutput.py:563-605)."""

    def __init__(self, Q=1, input_dims=1, active_dims=None):
        super().__init__(input_dims, active_dims)
        self.Q = Q
        self.magnitude = Parameter(np.ones(Q), lower=config.positive_minimum)
        self.mean = Parameter(np.zeros((Q, input_dims)), lower=config.positive_minimum)
        self.variance = Parameter(np.ones((Q, input_dims)), lower=config.positive_minimum)

    def K(self, X1, X2=None):
        X1, X2 = self._active_input(X1, X2)
        X2e = X1 if X2 is None else X2
        mag, var, mu = self.magnitude(), self.variance(), self.mean()
        K = None
        for q in range(self.Q):
            Kq = mag[q] * _spectral_sum(X1, X2e, mu[q], var[q])
            K = Kq if K is None else K + Kq
        return K

    def K_diag(self, X1):
        X1, _ = self._active_input(X1)
        return _ones(X1) * (torch.sum(self.magnitude()) * self.input_dims)


class MaternKernel(Kernel):
    """Matérn kernel for ν ∈ {1/2, 3/2, 5/2} of r = |Σ_d τ_d/l_d|
    (reference: gpr/singleoutput.py:607-655)."""

    def __init__(self, nu=0.5, input_dims=1, active_dims=None):
        super().__init__(input_dims, active_dims)
        if nu not in [0.5, 1.5, 2.5]:
            raise ValueError("nu parameter must be 0.5, 1.5, or 2.5")
        self.nu = nu
        self.magnitude = Parameter(1.0, lower=1e-6)
        self.lengthscale = Parameter(np.ones(input_dims), lower=1e-6)

    def K(self, X1, X2=None):
        X1, X2 = self._active_input(X1, X2)
        X2e = X1 if X2 is None else X2
        v = 1.0 / self.lengthscale()
        dist = torch.abs((X1 @ v)[:, None] - (X2e @ v)[None, :])
        if self.nu == 0.5:
            constant = 1.0
        elif self.nu == 1.5:
            constant = 1.0 + np.sqrt(3.0) * dist
        else:
            constant = 1.0 + np.sqrt(5.0) * dist + 5.0 / 3.0 * dist ** 2
        return self.magnitude() * constant * torch.exp(-np.sqrt(self.nu * 2.0) * dist)

    def K_diag(self, X1):
        X1, _ = self._active_input(X1)
        return _ones(X1) * self.magnitude()
