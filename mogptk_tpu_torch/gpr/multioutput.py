"""Multi-output kernels.

JAX counterpart: mogptk_tpu/gpr/multioutput.py (the classes :24-701 and
their plain per-point formulations `_mosm_K`, `_umosm_cross_weight`,
`_umosm_K`, `_csm_K`, `_lmc_sm_K`, `_conv_K`, `_mohsm_K` :74-263).

- MOSM (`MultiOutputSpectralMixtureKernel`, and `MultiOutputSpectralKernel`
  with Q = 1): every Gram goes through ops/mosm_gram.mosm_gram on the pair
  statistics, the K-gram kernel on the card and its plain twin on the CPU.
- uMOSM, MOHSM, CSM, CONV and SM-LMC (the LMC over plain spectral
  kernels): `K_sorted`, the square Gram of channel-sorted data, goes
  through ops/block_families.family_gram_sorted (K-fam-gram and
  K-fam-gram-bwd on the card); `K_mo`, every other Gram (unsorted data,
  cross Grams, the sparse models), is the plain formulation below on every
  device, as the JAX package ran its jnp formulation there, and autograd
  differentiates it.
- `IndependentMultiOutputKernel`: plain torch over its subkernels.

`family` is the fused-family id (name, statics) of the block engines, None
for a kernel without one, and `_fused_params()` the parameter tuple the
engine's pack takes (JAX: gpr/iterative._family_of, _fused_kernel_params).
"""
import numpy as np
import torch
from torch import nn

from .kernel import MultiOutputKernel
from .parameter import Parameter
from .config import config
from ..ops.block_mosm import mosm_pair_stats, mosm_gram_sorted
from ..ops.block_families import family_gram_sorted
from ..ops.mosm_gram import mosm_gram

_pi = np.pi


class IndependentMultiOutputKernel(MultiOutputKernel):
    """Block-diagonal kernel: one subkernel per channel, no cross-channel
    correlation."""

    def __init__(self, *kernels, output_dims=None):
        if output_dims is None:
            output_dims = len(kernels)
        super().__init__(output_dims)
        self.kernels = nn.ModuleList(self._check_kernels(kernels, output_dims))

    def __getitem__(self, key):
        return self.kernels[key]

    def name(self):
        return "%s[%s]" % (type(self).__name__, ",".join(k.name() for k in self.kernels))

    def K_mo(self, c1, x1, c2, x2=None):
        x2e = x1 if x2 is None else x2
        out = torch.zeros((x1.shape[0], x2e.shape[0]), dtype=x1.dtype, device=x1.device)
        for i in range(self.output_dims):
            m1 = (c1 == i).to(x1.dtype)[:, None]
            m2 = (c2 == i).to(x1.dtype)[None, :]
            out = out + m1 * self.kernels[i].K(x1, x2) * m2
        return out

    def K_mo_diag(self, c1, x1):
        out = torch.zeros((x1.shape[0],), dtype=x1.dtype, device=x1.device)
        for i in range(self.output_dims):
            out = out + (c1 == i).to(x1.dtype) * self.kernels[i].K_diag(x1)
        return out


def _mosm_K(c1, x1, c2, x2, params, twopi, phase_inside_2pi=True, cross_weight=None,
            alpha_extra=None):
    """The MOSM Gram from per-point parameter gathers, params = (w, mu, var,
    theta, phi) shaped (O, Q), (O, Q, D) ×3, (O, Q). `cross_weight` (N, M)
    replaces wᵢwⱼ (uMOSM), `alpha_extra` (N, M) multiplies the magnitude
    (MOHSM), and phase_inside_2pi=False puts the phase outside 2π."""
    w, mu, var, theta, phi = params
    x2e = x1 if x2 is None else x2
    i1, i2 = c1.long(), c2.long()
    K = None
    for q in range(mu.shape[1]):
        expo = ang = mag = var_prod = None
        for d in range(mu.shape[2]):
            v1, v2 = var[i1, q, d][:, None], var[i2, q, d][None, :]
            m1, m2 = mu[i1, q, d][:, None], mu[i2, q, d][None, :]
            taud = x1[:, d][:, None] - x2e[:, d][None, :]
            td = taud + (theta[i1, q, d][:, None] - theta[i2, q, d][None, :])
            inv = 1.0 / (v1 + v2)
            diffm = m1 - m2
            mean_nm = inv * (v1 * m2 + v2 * m1)
            var_nm = 2.0 * v1 * inv * v2
            e, a_, g = td * td * var_nm, td * mean_nm, diffm * diffm * inv
            expo = e if expo is None else expo + e
            ang = a_ if ang is None else ang + a_
            mag = g if mag is None else mag + g
            var_prod = var_nm if var_prod is None else var_prod * var_nm
        w1w2 = w[i1, q][:, None] * w[i2, q][None, :] if cross_weight is None else cross_weight
        alpha = w1w2 * torch.exp(-_pi ** 2 * mag) * twopi * torch.sqrt(var_prod)
        if alpha_extra is not None:
            alpha = alpha * alpha_extra
        pdiff = phi[i1, q][:, None] - phi[i2, q][None, :]
        if phase_inside_2pi:
            cos = torch.cos(2.0 * _pi * (ang + pdiff))
        else:
            cos = torch.cos(2.0 * _pi * ang + pdiff)
        Kq = alpha * torch.exp(-0.5 * expo) * cos
        K = Kq if K is None else K + Kq
    return K


def _umosm_cross_weight(W, c1, c2):
    """uMOSM's cross-channel magnitude tril(W)·tril(W)ᵀ per point pair, as
    the one-hot product chain of the JAX package."""
    O = W.shape[0]
    mag = torch.tril(W) @ torch.tril(W).T
    ar = torch.arange(O, device=W.device)
    onehot1 = (c1.long()[:, None] == ar[None, :]).to(mag.dtype)
    onehot2 = (c2.long()[:, None] == ar[None, :]).to(mag.dtype)
    return onehot1 @ (mag @ onehot2.T)


def _umosm_K(c1, x1, c2, x2, params, twopi):
    """uMOSM Gram of params = (W, mu, var, theta, phi), the phase outside 2π."""
    W, mu, var, theta, phi = params
    cw = _umosm_cross_weight(W, c1, c1 if c2 is None else c2)
    return _mosm_K(c1, x1, c2, x2, (None, mu, var, theta, phi), twopi,
                   phase_inside_2pi=False, cross_weight=cw)


def _csm_K(c1, x1, c2, x2, params):
    """CSM Gram of params = (amp (O, Rq), mu (1, D), var (1, D), shift (O, Rq))."""
    amp, mu, var, shift = params
    x2e = x1 if x2 is None else x2
    i1, i2 = c1.long(), (c1 if c2 is None else c2).long()
    expo = ang = None
    for d in range(x1.shape[1]):
        taud = x1[:, None, d] - x2e[None, :, d]
        e, a_ = taud * taud * var[0, d], taud * mu[0, d]
        expo = e if expo is None else expo + e
        ang = a_ if ang is None else ang + a_
    expo = torch.exp(-0.5 * expo)
    K = None
    for r in range(amp.shape[1]):
        amplitude = torch.sqrt(amp[i1, r][:, None] * amp[i2, r][None, :])
        sh = shift[i1, r][:, None] - shift[i2, r][None, :]
        Kr = amplitude * expo * torch.cos(2.0 * _pi * (ang + sh))
        K = Kr if K is None else K + Kr
    return K


def _lmc_sm_K(c1, x1, c2, x2, params):
    """SM-LMC Gram of params = (W (O, Q, Rq), mag (Q, 1), mu (Q, D),
    var (Q, D)): K_ij = Σ_q (W_iq·W_jq) σ²_q Σ_d exp(−2π²τ_d²Σ_qd) cos(2πμ_qd τ_d)."""
    W, mag, mu, var = params
    x2e = x1 if x2 is None else x2
    i1, i2 = c1.long(), (c1 if c2 is None else c2).long()
    K = None
    for q in range(W.shape[1]):
        Bq = W[i1, q, :] @ W[i2, q, :].T
        acc = None
        for d in range(x1.shape[1]):
            taud = x1[:, None, d] - x2e[None, :, d]
            t = (torch.exp(-2.0 * _pi ** 2 * taud * taud * var[q, d])
                 * torch.cos(2.0 * _pi * taud * mu[q, d]))
            acc = t if acc is None else acc + t
        Kq = (mag[q, 0] * Bq) * acc
        K = Kq if K is None else K + Kq
    return K


def _conv_K(c1, x1, c2, x2, params):
    """CONV Gram of params = (w (O, 1), var (O, D), base (1, D))."""
    w, var, base = params
    x2e = x1 if x2 is None else x2
    i1, i2 = c1.long(), (c1 if c2 is None else c2).long()
    expo = prod_var = None
    for d in range(x1.shape[1]):
        taud2 = (x1[:, None, d] - x2e[None, :, d]) ** 2
        vd = var[i1, d][:, None] + var[i2, d][None, :] + base[0, d]
        e = taud2 / vd
        expo = e if expo is None else expo + e
        prod_var = vd if prod_var is None else prod_var * vd
    magnitude = w[i1, 0][:, None] * w[i2, 0][None, :] * torch.sqrt(torch.prod(base) / prod_var)
    return magnitude * torch.exp(-0.5 * expo)


def _mohsm_K(c1, x1, c2, x2, params, twopi):
    """MOHSM Gram of the MOSM-lifted params (w (O, 1), mu/var/theta
    (O, 1, D), phi (O, 1), ls (O, 1), center (1, D)): MOSM Q = 1 with the
    phase outside 2π, times (√l_ij)^D exp(−½‖(x + x')/2 − center‖² l_ij)."""
    w, mu, var, theta, phi, ls, center = params
    x2e = x1 if x2 is None else x2
    i1, i2 = c1.long(), (c1 if c2 is None else c2).long()
    D = x1.shape[1]
    l2 = ls[:, 0] ** 2
    l1, l2m = l2[i1][:, None], l2[i2][None, :]
    l_nm = 2.0 * l1 * l2m / (l1 + l2m)
    dist2 = None
    for d in range(D):
        avgd = 0.5 * (x1[:, d][:, None] + x2e[:, d][None, :]) - center[0, d]
        dist2 = avgd * avgd if dist2 is None else dist2 + avgd * avgd
    alpha_extra = torch.pow(torch.sqrt(l_nm), float(D)) * torch.exp(-0.5 * dist2 * l_nm)
    return _mosm_K(c1, x1, c2, x2, (w, mu, var, theta, phi), twopi,
                   phase_inside_2pi=False, alpha_extra=alpha_extra)


class _MosmKernel(MultiOutputKernel):
    """The MOSM Grams of both MOSM kernels from `_params()` (w (O, Q),
    mu, var, theta (O, Q, D), phi (O, Q)) through the pair statistics."""

    @property
    def family(self):
        """MOSM with the phase inside 2π."""
        return ("mosm", (self.twopi, True))

    def _fused_params(self):
        return self._params()

    def K_mo(self, c1, x1, c2, x2=None):
        st3, st2 = mosm_pair_stats(*self._params(), self.twopi)
        return mosm_gram(x1, c1, x1 if x2 is None else x2, c2, st3, st2)

    def K_sorted(self, X, counts):
        """Square Gram of channel-sorted X with per-channel `counts`."""
        _, x = self._split(X)
        return mosm_gram_sorted(x, counts, *self._params(), self.twopi)

    def K_mo_diag(self, c1, x1):
        w, _, var, _, _ = self._params()
        alpha = w ** 2 * self.twopi * torch.sqrt(torch.prod(var, dim=-1))
        return torch.sum(alpha, dim=-1)[c1.long()]


class MultiOutputSpectralKernel(_MosmKernel):
    """MOSM with one component per channel, Parra & Tobar 2017."""

    def __init__(self, output_dims, input_dims=1, active_dims=None):
        super().__init__(output_dims, input_dims, active_dims)
        self.weight = Parameter(np.ones(output_dims), lower=config.positive_minimum)
        self.mean = Parameter(np.zeros((output_dims, input_dims)), lower=config.positive_minimum)
        self.variance = Parameter(np.ones((output_dims, input_dims)), lower=config.positive_minimum)
        self.delay = Parameter(np.zeros((output_dims, input_dims)))
        self.phase = Parameter(np.zeros(output_dims))
        if output_dims == 1:
            self.delay.train = False
            self.phase.train = False
        self.twopi = float(np.power(2.0 * np.pi, float(input_dims) / 2.0))

    def _params(self):
        return (self.weight()[:, None], self.mean()[:, None, :], self.variance()[:, None, :],
                self.delay()[:, None, :], self.phase()[:, None])


class MultiOutputSpectralMixtureKernel(_MosmKernel):
    """MOSM with Q components per channel, Parra & Tobar 2017.

    Args:
        Q (int): number of components.
        output_dims (int): number of channels.
        input_dims (int): number of input dimensions.
    """

    def __init__(self, Q, output_dims, input_dims=1, active_dims=None):
        super().__init__(output_dims, input_dims, active_dims)
        self.Q = Q
        self.weight = Parameter(np.ones((output_dims, Q)), lower=config.positive_minimum)
        self.mean = Parameter(np.zeros((output_dims, Q, input_dims)), lower=config.positive_minimum)
        self.variance = Parameter(np.ones((output_dims, Q, input_dims)), lower=config.positive_minimum)
        self.delay = Parameter(np.zeros((output_dims, Q, input_dims)))
        self.phase = Parameter(np.zeros((output_dims, Q)))
        if output_dims == 1:
            self.delay.train = False
            self.phase.train = False
        self.twopi = float(np.power(2.0 * np.pi, float(input_dims) / 2.0))

    def _params(self):
        return (self.weight(), self.mean(), self.variance(), self.delay(), self.phase())


class UncoupledMultiOutputSpectralKernel(MultiOutputKernel):
    """uMOSM: MOSM with a trained lower-triangular cross-channel weight and
    the phase outside 2π."""

    def __init__(self, output_dims, input_dims=1, active_dims=None):
        super().__init__(output_dims, input_dims, active_dims)
        self.weight = Parameter(np.tril(np.ones((output_dims, output_dims))))
        self.weight.num_parameters = int((output_dims * output_dims + output_dims) / 2)
        self.mean = Parameter(np.zeros((output_dims, input_dims)), lower=config.positive_minimum)
        self.variance = Parameter(np.ones((output_dims, input_dims)), lower=config.positive_minimum)
        self.delay = Parameter(np.zeros((output_dims, input_dims)))
        self.phase = Parameter(np.zeros(output_dims))
        if output_dims == 1:
            self.delay.train = False
            self.phase.train = False
        self.twopi = float(np.power(2.0 * np.pi, float(input_dims) / 2.0))

    @property
    def family(self):
        return ("umosm", (self.twopi,))

    def _params(self):
        return (None, self.mean()[:, None, :], self.variance()[:, None, :],
                self.delay()[:, None, :], self.phase()[:, None])

    def _fused_params(self):
        return (self.weight(),) + self._params()[1:]

    def K_sorted(self, X, counts):
        _, x = self._split(X)
        return family_gram_sorted(self.family, x, counts, self._fused_params())

    def K_mo(self, c1, x1, c2, x2=None):
        return _umosm_K(c1, x1, c2, x2, self._fused_params(), self.twopi)

    def K_mo_diag(self, c1, x1):
        W = torch.tril(self.weight())
        alpha = (torch.diagonal(W @ W.T) * self.twopi
                 * torch.sqrt(torch.prod(self.variance(), dim=-1)))
        return alpha[c1.long()]


class MultiOutputHarmonizableSpectralKernel(MultiOutputKernel):
    """MOHSM: the nonstationary harmonizable spectral kernel, Altamirano
    2021. `psd_safe=True` caps the envelope precision at the locally
    stationary PSD bound (see _effective_l2); off by default, which keeps
    the reference's formula."""

    def __init__(self, output_dims, input_dims=1, active_dims=None, psd_safe=False):
        super().__init__(output_dims, input_dims, active_dims)
        self.psd_safe = bool(psd_safe)
        self.weight = Parameter(np.ones(output_dims), lower=config.positive_minimum)
        self.mean = Parameter(np.zeros((output_dims, input_dims)), lower=config.positive_minimum)
        self.variance = Parameter(np.ones((output_dims, input_dims)), lower=config.positive_minimum)
        self.lengthscale = Parameter(np.ones(output_dims), lower=config.positive_minimum)
        self.center = Parameter(np.zeros(input_dims))
        self.delay = Parameter(np.zeros((output_dims, input_dims)))
        self.phase = Parameter(np.zeros(output_dims))
        if output_dims == 1:
            self.delay.train = False
            self.phase.train = False
        self.twopi = float(np.power(2.0 * np.pi, float(input_dims)))

    @property
    def family(self):
        return ("mohsm", (self.twopi, self.input_dims))

    def _params(self):
        return (self.weight()[:, None], self.mean()[:, None, :], self.variance()[:, None, :],
                self.delay()[:, None, :], self.phase()[:, None])

    def _effective_l2(self):
        """The envelope precision l² per channel. A channel block is PSD iff
        l² ≤ 4Σ_d for every input dim, and capping each channel at
        l_i² ≤ 2·min_d Σ_id keeps every pair block inside its own bound;
        psd_safe applies the cap as the smooth saturation c·tanh(l²/c)
        (JAX: MultiOutputHarmonizableSpectralKernel._effective_l2)."""
        l2 = self.lengthscale() ** 2
        if not self.psd_safe:
            return l2
        cap = 2.0 * torch.min(self.variance(), dim=-1).values
        return cap * torch.tanh(l2 / cap)

    def _fused_params(self):
        return self._params() + (torch.sqrt(self._effective_l2()).reshape(-1, 1),
                                 self.center().reshape(1, -1))

    def K_sorted(self, X, counts):
        _, x = self._split(X)
        return family_gram_sorted(self.family, x, counts, self._fused_params())

    def K_mo(self, c1, x1, c2, x2=None):
        return _mohsm_K(c1, x1, c2, x2, self._fused_params(), self.twopi)

    def K_mo_diag(self, c1, x1):
        l2 = self._effective_l2()
        alpha = (self.weight() ** 2 * self.twopi
                 * torch.sqrt(torch.prod(self.variance(), dim=-1))
                 * torch.pow(torch.sqrt(l2), float(self.input_dims)))
        dist2 = torch.sum((x1 - self.center()) ** 2, dim=-1)
        i1 = c1.long()
        return alpha[i1] * torch.exp(-0.5 * dist2 * l2[i1])


class CrossSpectralKernel(MultiOutputKernel):
    """Cross-spectral kernel (CSM) with Rq phase-shifted subcomponents,
    Ulrich et al. 2015."""

    def __init__(self, output_dims, input_dims=1, Rq=1, active_dims=None):
        super().__init__(output_dims, input_dims, active_dims)
        self.Rq = Rq
        self.amplitude = Parameter(np.ones((output_dims, Rq)), lower=config.positive_minimum)
        self.mean = Parameter(np.zeros(input_dims), lower=config.positive_minimum)
        self.variance = Parameter(np.ones(input_dims), lower=config.positive_minimum)
        self.shift = Parameter(np.zeros((output_dims, Rq)))

    @property
    def family(self):
        return ("csm", (self.Rq, self.input_dims))

    def _fused_params(self):
        return (self.amplitude(), self.mean().reshape(1, -1), self.variance().reshape(1, -1),
                self.shift())

    def K_sorted(self, X, counts):
        _, x = self._split(X)
        return family_gram_sorted(self.family, x, counts, self._fused_params())

    def K_mo(self, c1, x1, c2, x2=None):
        return _csm_K(c1, x1, c2, x2, self._fused_params())

    def K_mo_diag(self, c1, x1):
        return torch.sum(self.amplitude(), dim=-1)[c1.long()]


class LinearModelOfCoregionalizationKernel(MultiOutputKernel):
    """LMC: K_ij = Σ_q (Σ_r w_iqr w_jqr) k_q(x, x'), Goovaerts 1997. Over
    plain spectral kernels (SM-LMC) it is the "lmc_sm" family."""

    def __init__(self, *kernels, output_dims, input_dims=1, Q=None, Rq=1):
        super().__init__(output_dims, input_dims)
        if Q is None:
            Q = len(kernels)
        self.kernels = nn.ModuleList(self._check_kernels(kernels, Q))
        self.Q = Q
        self.Rq = Rq
        self.weight = Parameter(np.ones((output_dims, Q, Rq)), lower=config.positive_minimum)

    def __getitem__(self, key):
        return self.kernels[key]

    def name(self):
        return "%s[%s]" % (type(self).__name__, ",".join(k.name() for k in self.kernels))

    def _all_spectral(self):
        """Every base kernel a plain SpectralKernel over all of this kernel's
        input dims: the SM-LMC case of the block engines."""
        from .singleoutput import SpectralKernel
        return all(type(k) is SpectralKernel and k.active_dims is None
                   and k.input_dims == self.input_dims for k in self.kernels)

    @property
    def family(self):
        return ("lmc_sm", (self.Q, self.input_dims)) if self._all_spectral() else None

    def _fused_params(self):
        """(W (O, Q, Rq), mag (Q, 1), mu (Q, D), var (Q, D)); SM-LMC only."""
        mag = torch.stack([k.magnitude() for k in self.kernels]).reshape(-1, 1)
        mu = torch.stack([k.mean() for k in self.kernels])
        var = torch.stack([k.variance() for k in self.kernels])
        return (self.weight(), mag, mu, var)

    def K_sorted(self, X, counts):
        """Through the block engine when the bases are all spectral
        (SM-LMC), else the generic assembly."""
        if not self._all_spectral():
            return self.K(X)
        _, x = self._split(X)
        return family_gram_sorted(self.family, x, counts, self._fused_params())

    def K_mo(self, c1, x1, c2, x2=None):
        w = self.weight()
        i1, i2 = c1.long(), c2.long()
        K = None
        for q, kernel in enumerate(self.kernels):
            Kq = (w[i1, q, :] @ w[i2, q, :].T) * kernel.K(x1, x2)
            K = Kq if K is None else K + Kq
        return K

    def K_mo_diag(self, c1, x1):
        w1 = self.weight()[c1.long()]
        B = torch.sum(w1 * w1, dim=-1)
        Ks = torch.stack([k.K_diag(x1) for k in self.kernels], dim=-1)
        return torch.sum(B * Ks, dim=-1)


class GaussianConvolutionProcessKernel(MultiOutputKernel):
    """Gaussian convolution process kernel (CONV), Álvarez & Lawrence 2009."""

    def __init__(self, output_dims, input_dims=1, active_dims=None):
        super().__init__(output_dims, input_dims, active_dims)
        self.weight = Parameter(np.ones(output_dims), lower=config.positive_minimum)
        self.variance = Parameter(np.ones((output_dims, input_dims)), lower=0.0)
        self.base_variance = Parameter(np.ones(input_dims), lower=config.positive_minimum)

    @property
    def family(self):
        return ("conv", (self.input_dims,))

    def _fused_params(self):
        return (self.weight().reshape(-1, 1), self.variance(), self.base_variance().reshape(1, -1))

    def K_sorted(self, X, counts):
        _, x = self._split(X)
        return family_gram_sorted(self.family, x, counts, self._fused_params())

    def K_mo(self, c1, x1, c2, x2=None):
        return _conv_K(c1, x1, c2, x2, self._fused_params())

    def K_mo_diag(self, c1, x1):
        variances = 2.0 * self.variance() + self.base_variance()
        magnitude = self.weight() ** 2 * torch.sqrt(
            torch.prod(self.base_variance()) / torch.prod(variances, dim=-1))
        return magnitude[c1.long()]
