"""MOSM: Multi-Output Spectral Mixture model, Parra & Tobar 2017.

JAX counterpart: mogptk_tpu/models/mosm.py (:14-199); reference
mogptk/models/mosm.py:10-257. Initialization by 'BNSE', 'LS' and 'SM' (the
estimate of a pre-fitted SM model, Data.get_sm_estimation).
"""
import numpy as np

from ..gpr.config import config as gpr_config
from ..dataset import DataSet
from ..model import Model, Exact, logger
from ..gpr import MultiOutputSpectralMixtureKernel, GaussianLikelihood
from ..util import plot_spectrum


class MOSM(Model):
    """Multi-output spectral mixture model with Q components
    (reference: mogptk/models/mosm.py:10-60)."""

    def __init__(self, dataset, Q=1, inference=None, mean=None, name="MOSM", **kwargs):
        if inference is None:
            inference = Exact()
        if not isinstance(dataset, DataSet):
            dataset = DataSet(dataset)

        output_dims = dataset.get_output_dims()
        input_dims = dataset.get_input_dims()[0]
        for input_dim in dataset.get_input_dims()[1:]:
            if input_dim != input_dims:
                raise ValueError("input dimensions for all channels must match")

        kernel = MultiOutputSpectralMixtureKernel(Q=Q, output_dims=output_dims, input_dims=input_dims)
        rng = gpr_config.numpy_rng()
        kernel.weight.assign(rng.random((output_dims, Q)))
        kernel.mean.assign(rng.random((output_dims, Q, input_dims)))
        kernel.variance.assign(rng.random((output_dims, Q, input_dims)))

        super().__init__(dataset, kernel, inference, mean, name, **kwargs)
        self.Q = Q
        nyquist = np.array(self.dataset.get_nyquist_estimation())[:, None, :].repeat(Q, axis=1)
        nyquist = self._x_to_kernel_units(nyquist, xpow=-1)
        lower = np.asarray(self.gpr.kernel.mean.lower)
        self.gpr.kernel.mean.assign(upper=np.maximum(lower, nyquist))

    def init_parameters(self, method="BNSE", iters=500):
        """Initialize from BNSE/LS/SM spectral estimates with weight =
        10·mean amplitude (reference: mogptk/models/mosm.py:62-113)."""
        input_dims = self.dataset.get_input_dims()
        output_dims = self.dataset.get_output_dims()

        if method.lower() not in ["bnse", "ls", "sm"]:
            raise ValueError("valid methods of estimation are BNSE, LS, and SM")

        if method.lower() == "bnse":
            amplitudes, means, variances = self.dataset.get_bnse_estimation(self.Q, iters=iters)
        elif method.lower() == "ls":
            amplitudes, means, variances = self.dataset.get_ls_estimation(self.Q)
        else:
            amplitudes, means, variances = self.dataset.get_sm_estimation(self.Q, iters=iters)
        if len(amplitudes) == 0:
            logger.warning("{} could not find peaks for MOSM".format(method))
            return

        weight = np.zeros((output_dims, self.Q))
        mean = np.zeros((output_dims, self.Q, input_dims[0]))
        variance = np.zeros((output_dims, self.Q, input_dims[0]))
        for q in range(self.Q):
            for j in range(output_dims):
                weight[j, q] = 10.0 * amplitudes[j][q, :].mean()
                mean[j, q, :] = means[j][q, :]
                variance[j, q, :] = variances[j][q, :]

        self.gpr.kernel.weight.assign(weight)
        self.gpr.kernel.mean.assign(self._x_to_kernel_units(mean, xpow=-1))
        self.gpr.kernel.variance.assign(self._x_to_kernel_units(variance, xpow=-2))

        if isinstance(self.gpr.likelihood, GaussianLikelihood):
            _, Y = self.dataset.get_train_data(transformed=True)
            Y_std = [Y[j].std() for j in range(self.dataset.get_output_dims())]
            if self.gpr.likelihood.scale().ndim == 0:
                self.gpr.likelihood.scale.assign(np.mean(Y_std))
            else:
                self.gpr.likelihood.scale.assign(Y_std)

    def check(self):
        """Warn when a component approaches RBF degeneracy
        (reference: mogptk/models/mosm.py:115-124)."""
        for j in range(self.dataset.get_output_dims()):
            for q in range(self.Q):
                mean = self._x_from_kernel_units(self.gpr.kernel.mean.numpy()[j, q, :], xpow=-1)
                var = self._x_from_kernel_units(self.gpr.kernel.variance.numpy()[j, q, :], xpow=-2)
                if np.linalg.norm(mean) < np.linalg.norm(var):
                    print("- MOSM approaches RBF kernel for q=%d in channel='%s'" % (q, self.dataset[j].name))

    def plot_spectrum(self, method="LS", maxfreq=None, log=False, noise=False, title=None):
        """Plot the mixture PSD per channel (reference: mogptk/models/mosm.py:126-157)."""
        names = self.dataset.get_names()
        if maxfreq is not None:
            maxfreq = [maxfreq] * len(self.dataset)
        means = self._x_from_kernel_units(
            self.gpr.kernel.mean.numpy().transpose([1, 0, 2]), xpow=-1)
        scales = self._x_from_kernel_units(
            np.sqrt(self.gpr.kernel.variance.numpy().transpose([1, 0, 2])), xpow=-1)
        weights = self.gpr.kernel.weight.numpy().transpose([1, 0]) ** 2

        noises = None
        if noise:
            if not isinstance(self.gpr.likelihood, GaussianLikelihood):
                raise ValueError("likelihood must be Gaussian to enable spectral noise")
            if getattr(self.gpr, "data_variance", None) is not None:
                raise ValueError("likelihood variance must not be per data point to enable spectral noise")
            noises = self.gpr.likelihood.scale.numpy()

        return plot_spectrum(means, scales, dataset=self.dataset, weights=weights,
                             noises=noises, method=method, maxfreq=maxfreq, log=log,
                             titles=names, title=title)

    def plot_cross_spectrum(self, title=None, figsize=(12, 12)):
        """Plot the closed-form power (cross-)spectral densities between all
        channel pairs (reference: mogptk/models/mosm.py:159-257)."""
        import matplotlib.pyplot as plt

        if not all(input_dims == 1 for input_dims in self.dataset.get_input_dims()):
            raise RuntimeError("not implemented for multiple input dimensions")

        input_dims = self.dataset.get_input_dims()[0]
        output_dims = self.dataset.get_output_dims()
        Q = self.Q

        cross = {
            "covariance": np.zeros((output_dims, output_dims, input_dims, Q)),
            "mean": np.zeros((output_dims, output_dims, input_dims, Q)),
            "magnitude": np.zeros((output_dims, output_dims, Q)),
            "delay": np.zeros((output_dims, output_dims, input_dims, Q)),
            "phase": np.zeros((output_dims, output_dims, Q)),
        }

        weight = self.gpr.kernel.weight.numpy()
        mean = self._x_from_kernel_units(self.gpr.kernel.mean.numpy(), xpow=-1)
        variance = self._x_from_kernel_units(self.gpr.kernel.variance.numpy(), xpow=-2)
        phase = self.gpr.kernel.phase.numpy()
        delay = self._x_from_kernel_units(self.gpr.kernel.delay.numpy(), xpow=1)
        for q in range(Q):
            for i in range(output_dims):
                for j in range(output_dims):
                    sv = variance[i, q, :] + variance[j, q, :]
                    cross["covariance"][i, j, :, q] = 2 * (variance[i, q, :] * variance[j, q, :]) / sv
                    num = variance[i, q, :].dot(mean[j, q, :]) + variance[j, q, :].dot(mean[i, q, :])
                    cross["mean"][i, j, :, q] = num / sv
                    exp_term = -0.25 * (((mean[i, q, :] - mean[j, q, :]) ** 2) / sv).sum()
                    cross["magnitude"][i, j, q] = weight[i, q] * weight[j, q] * np.exp(exp_term)
                    cross["delay"][i, j, :, q] = delay[i, q, :] - delay[j, q, :]
                    cross["phase"][i, j, q] = phase[i, q] - phase[j, q]

        h = figsize[1]
        fig, axes = plt.subplots(output_dims, output_dims, figsize=figsize, squeeze=False, constrained_layout=True)
        if title is not None:
            fig.suptitle(title, y=(h + 0.8) / h, fontsize=18)

        for j in range(output_dims):
            for i in range(j + 1):
                magn = cross["magnitude"][j, i, :]
                mu = cross["mean"][j, i, 0, :]
                cov = cross["covariance"][j, i, 0, :]
                dly = cross["delay"][j, i, 0, :]
                ph = cross["phase"][j, i, :]

                w_high = (mu + 2 * np.sqrt(cov)).max()
                w = np.linspace(-w_high, w_high, 1000)
                if i == j:
                    psd_total = np.zeros(len(w))
                    for q in range(self.Q):
                        psd_q = np.exp(-0.5 * (w - mu[q]) ** 2 / cov[q])
                        psd_q += np.exp(-0.5 * (w + mu[q]) ** 2 / cov[q])
                        psd_q *= magn[q] * 0.5
                        axes[j, i].plot(w, psd_q, ls="--", c="k")
                        psd_total += psd_q
                    axes[j, i].plot(w, psd_total, c="k")
                else:
                    psd_total = np.zeros(len(w)) + 0.0j
                    for q in range(self.Q):
                        psd_q = np.exp(-0.5 * (w - mu[q]) ** 2 / cov[q] + 1.0j * (w * dly[q] + ph[q]))
                        psd_q += np.exp(-0.5 * (w + mu[q]) ** 2 / cov[q] + 1.0j * (w * dly[q] + ph[q]))
                        psd_q *= magn[q] * 0.5
                        axes[j, i].plot(w, np.real(psd_q), ls="--", c="k")
                        axes[j, i].plot(w, np.imag(psd_q), ls="--", c="silver")
                        psd_total += psd_q
                    axes[j, i].plot(w, np.real(psd_total), c="k")
                    axes[j, i].plot(w, np.imag(psd_total), c="silver")
                axes[j, i].set_yticks([])
            for i in range(j + 1, output_dims):
                axes[j, i].set_axis_off()

        legends = [
            plt.Line2D([0], [0], ls="-", color="k", label="Total (real)"),
            plt.Line2D([0], [0], ls="--", color="k", label="Mixture (real)"),
            plt.Line2D([0], [0], ls="-", color="silver", label="Total (imag)"),
            plt.Line2D([0], [0], ls="--", color="silver", label="Mixture (imag)"),
        ]
        fig.legend(handles=legends)
        return fig, axes
