"""Bayesian Nonparametric Spectral Estimation (BNSE), Tobar 2018.

JAX counterpart: mogptk_tpu/init.py (:56-139); reference mogptk/init.py:5-122.
Fit an exact GP with a spectral kernel to the signal (gpr.train, Adam, the
closed-form gradient), then compute the closed-form posterior over the
Fourier transform of f via time↔frequency cross-kernels; the PSD follows a
generalized chi-squared distribution. The frequency-domain algebra is plain
torch on the model's device.
"""
import numpy as np
import torch

from . import gpr
from .ops.linalg import jittered_cholesky, cholesky_solve, solve_triangular

_pi = np.pi


def _kernel_ff(f1, f2, magnitude, mean, variance, alpha):
    """Freq-freq covariance of the windowed spectral GP
    (reference: mogptk/init.py:61-70)."""
    mean = mean.reshape(1, 1, -1)
    variance = variance.reshape(1, 1, -1)
    gamma = 2.0 * _pi ** 2 * variance
    const = 0.5 * _pi * magnitude / torch.sqrt(alpha ** 2 + 2.0 * alpha * torch.prod(gamma))
    sqdist = (f1[:, None, :] - f2[None, :, :]) ** 2
    avg = 0.5 * (f1[:, None, :] + f2[None, :, :])
    exp1 = -0.5 * _pi ** 2 / alpha * sqdist
    exp2a = -2.0 * _pi ** 2 / (alpha + 2.0 * gamma) * (avg - mean) ** 2
    exp2b = -2.0 * _pi ** 2 / (alpha + 2.0 * gamma) * (avg + mean) ** 2
    return const * torch.sum(torch.exp(exp1 + exp2a) + torch.exp(exp1 + exp2b), dim=2)


def _kernel_tf(t, f, magnitude, mean, variance, alpha):
    """Time-freq cross covariance, real and imaginary parts
    (reference: mogptk/init.py:72-90, including the empirically corrected
    Lq_inv inversion at init.py:78)."""
    mean = mean.reshape(1, -1)
    variance = variance.reshape(1, -1)
    gamma = 2.0 * _pi ** 2 * variance
    Lq_inv = 1.0 / (_pi ** 2 * (1.0 / alpha + 1.0 / gamma))

    const = torch.sqrt(_pi / (alpha + torch.prod(gamma)))
    exp1 = -_pi ** 2 * (t ** 2 @ Lq_inv.T)                                    # Nx1
    exp2a = -((_pi ** 2 / (alpha + gamma)) @ ((f - mean).T ** 2))             # 1xM
    exp2b = -((_pi ** 2 / (alpha + gamma)) @ ((f + mean).T ** 2))             # 1xM
    exp3a = -2.0 * _pi * ((t @ Lq_inv) @ (_pi ** 2 * (f / alpha + mean / gamma).T))  # NxM
    exp3b = -2.0 * _pi * ((t @ Lq_inv) @ (_pi ** 2 * (f / alpha - mean / gamma).T))  # NxM

    a = 0.5 * magnitude * const * torch.exp(exp1)
    real = torch.exp(exp2a) * torch.cos(exp3a) + torch.exp(exp2b) * torch.cos(exp3b)
    imag = torch.exp(exp2a) * torch.sin(exp3a) + torch.exp(exp2b) * torch.sin(exp3b)
    return a * real, a * imag


def BNSE(x, y, y_err=None, max_freq=None, n=1000, iters=100):
    """Estimate the PSD of a signal via BNSE (reference: mogptk/init.py:5-122).

    Args:
        x: Input data of shape (data_points,).
        y: Output data of shape (data_points,).
        y_err: Optional std.dev. per point.
        max_freq: Maximum frequency (defaults to the Nyquist estimate).
        n: Number of frequency grid points.
        iters: Training iterations for the inner GP fit.

    Returns:
        (frequencies, psd_mean, psd_variance) as numpy arrays of shape (n,).
    """
    x = np.asarray(x, dtype=np.float64).copy()
    y = np.asarray(y, dtype=np.float64)
    x -= np.median(x)
    x_range = np.max(x) - np.min(x)
    x_dist = x_range / len(x)
    if max_freq is None:
        max_freq = 0.5 / x_dist

    x2 = x.reshape(-1, 1)
    y2 = y.reshape(-1, 1)

    kernel = gpr.SpectralKernel()
    model = gpr.Exact(kernel, x2, y2,
                      data_variance=(np.asarray(y_err) ** 2 if y_err is not None else None))

    # initialize parameters as the reference does (init.py:40-48)
    magnitude = float(np.var(y))
    mean = 0.01
    variance = 0.25 / _pi ** 2 / x_dist ** 2
    noise = float(np.std(y)) / 10.0
    model.kernel.magnitude.assign(magnitude)
    model.kernel.mean.assign(mean, upper=max_freq)
    model.kernel.variance.assign(variance)
    model.likelihood.scale.assign(noise)

    # train the inner GP (Adam lr=2.0 as in the reference, init.py:54-56)
    gpr.train(model, method="Adam", lr=2.0, iters=iters)

    with torch.no_grad():
        dtype, dev = model.X.dtype, model.X.device
        alpha = float(0.5 / x_range ** 2)
        w = torch.linspace(0.0, max_freq, n, dtype=dtype, device=dev).reshape(-1, 1)
        xt, yt = model.X, model.y

        mag = kernel.magnitude()
        mu = kernel.mean()
        var = kernel.variance()

        Ktt = kernel.K(xt)
        Ktt = Ktt + model.likelihood.scale() ** 2 * torch.eye(xt.shape[0], dtype=dtype, device=dev)
        if model.data_variance is not None:
            Ktt = Ktt + torch.diag(model.data_variance)
        Ltt = jittered_cholesky(Ktt, model.jitter)

        Kff = _kernel_ff(w, w, mag, mu, var, alpha)
        Pff = _kernel_ff(w, -w, mag, mu, var, alpha)
        Kff_real = 0.5 * (Kff + Pff)
        Kff_imag = 0.5 * (Kff - Pff)

        Ktf_real, Ktf_imag = _kernel_tf(xt, w, mag, mu, var, alpha)

        a = cholesky_solve(Ltt, yt)
        b = solve_triangular(Ltt, Ktf_real)
        c = solve_triangular(Ltt, Ktf_imag)

        mu_real = Ktf_real.T @ a
        mu_imag = Ktf_imag.T @ a
        var_real = torch.diagonal(Kff_real - b.T @ b).reshape(-1, 1)
        var_imag = torch.diagonal(Kff_imag - c.T @ c).reshape(-1, 1)

        # PSD = N(mu_r,var_r)² + N(mu_i,var_i)², generalized chi-squared moments
        psd_mean = mu_real ** 2 + mu_imag ** 2 + var_real + var_imag
        psd_var = (2.0 * var_real ** 2 + 2.0 * var_imag ** 2
                   + 4.0 * var_real * mu_real ** 2 + 4.0 * var_imag * mu_imag ** 2)

    return tuple(t.reshape(-1).cpu().numpy() for t in (w, psd_mean, psd_var))
