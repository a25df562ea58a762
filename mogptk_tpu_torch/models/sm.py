"""SM: an independent spectral mixture kernel per channel, Wilson & Adams 2013.

JAX counterpart: mogptk_tpu/models/sm.py (:15-124); reference
mogptk/models/sm.py:9-154. Initialization by 'IPS' (independent parameter
sampling, drawn from gpr.config.numpy_rng as in the JAX package), 'LS'
(Lomb-Scargle peaks) and 'BNSE'. On channel-sorted data the exact Gram goes
through IndependentMultiOutputKernel.K_sorted, one block a channel.
"""
import numpy as np

from ..gpr.config import config as gpr_config
from ..dataset import DataSet
from ..model import Model, Exact, logger
from ..gpr import SpectralMixtureKernel, IndependentMultiOutputKernel, GaussianLikelihood
from ..util import plot_spectrum


class SM(Model):
    """Independent spectral mixture model with Q components per channel
    (reference: mogptk/models/sm.py:9-60)."""

    def __init__(self, dataset, Q=1, inference=None, mean=None, name="SM", **kwargs):
        if inference is None:
            inference = Exact()
        if not isinstance(dataset, DataSet):
            dataset = DataSet(dataset)

        output_dims = dataset.get_output_dims()
        input_dims = dataset.get_input_dims()[0]
        for other in dataset.get_input_dims()[1:]:
            if other != input_dims:
                raise ValueError("input dimensions for all channels must match")
        kernel = IndependentMultiOutputKernel(
            [SpectralMixtureKernel(Q=Q, input_dims=input_dims) for _ in range(output_dims)],
            output_dims=output_dims)
        rng = gpr_config.numpy_rng()
        for j in range(output_dims):
            kernel[j].magnitude.assign(rng.random(Q))
            kernel[j].mean.assign(rng.random((Q, input_dims)))
            kernel[j].variance.assign(rng.random((Q, input_dims)))

        super().__init__(dataset, kernel, inference, mean, name, **kwargs)
        self.Q = Q
        # the Nyquist frequency bounds the component means from above
        nyquist = np.array(self.dataset.get_nyquist_estimation())[:, None, :].repeat(Q, axis=1)
        nyquist = self._x_to_kernel_units(nyquist, xpow=-1)
        for j in range(output_dims):
            lower = np.asarray(self.gpr.kernel[j].mean.lower)
            self.gpr.kernel[j].mean.assign(upper=np.maximum(lower, nyquist[j, :, :]))

    def init_parameters(self, method="LS", iters=500):
        """Initialize from spectral estimates: IPS (independent parameter
        sampling, Wilson 2014), LS (Lomb-Scargle peaks) or BNSE
        (reference: mogptk/models/sm.py:62-121)."""
        input_dims = self.dataset.get_input_dims()
        output_dims = self.dataset.get_output_dims()

        if method.lower() not in ["ips", "ls", "bnse"]:
            raise ValueError("valid methods of estimation are IPS, LS, and BNSE")

        if method.lower() == "ips":
            rng = gpr_config.numpy_rng()
            for j in range(output_dims):
                nyquist = self.dataset[j].get_nyquist_estimation()
                x = self.dataset[j].X[self.dataset[j].mask, :]
                y = self.dataset[j].Y_transformer.forward(self.dataset[j].Y[self.dataset[j].mask], x)
                x_range = np.max(x, axis=0) - np.min(x, axis=0)

                weights = [2.0 * y.std() / self.Q] * self.Q
                means = nyquist * rng.random((self.Q, input_dims[j]))
                variances = 1.0 / (np.abs(rng.standard_normal((self.Q, input_dims[j]))) * x_range)

                self.gpr.kernel[j].magnitude.assign(weights)
                self.gpr.kernel[j].mean.assign(self._x_to_kernel_units(means, xpow=-1))
                self.gpr.kernel[j].variance.assign(self._x_to_kernel_units(variances, xpow=-2))
            return
        elif method.lower() == "ls":
            amplitudes, means, variances = self.dataset.get_ls_estimation(self.Q)
            if len(amplitudes) == 0:
                logger.warning("LS could not find peaks for SM")
                return
        else:
            amplitudes, means, variances = self.dataset.get_bnse_estimation(self.Q, iters=iters)
            if np.sum(amplitudes) == 0.0:
                logger.warning("BNSE could not find peaks for SM")
                return

        for j in range(output_dims):
            self.gpr.kernel[j].magnitude.assign(amplitudes[j].mean(axis=1) ** 2)
            self.gpr.kernel[j].mean.assign(self._x_to_kernel_units(means[j], xpow=-1))
            self.gpr.kernel[j].variance.assign(self._x_to_kernel_units(variances[j], xpow=-2))

        # the noise from each channel's Y std (reference: models/sm.py:115-121)
        if isinstance(self.gpr.likelihood, GaussianLikelihood):
            _, Y = self.dataset.get_train_data(transformed=True)
            Y_std = [Y[j].std() for j in range(self.dataset.get_output_dims())]
            if self.gpr.likelihood.scale().ndim == 0:
                self.gpr.likelihood.scale.assign(np.mean(Y_std))
            else:
                self.gpr.likelihood.scale.assign(Y_std)

    def plot_spectrum(self, method="LS", maxfreq=None, log=False, noise=False, title=None):
        """Plot the mixture PSD per channel (reference: mogptk/models/sm.py:123-154)."""
        output_dims = self.dataset.get_output_dims()
        names = self.dataset.get_names()
        if maxfreq is not None:
            maxfreq = [maxfreq] * len(self.dataset)
        means = np.array([self._x_from_kernel_units(self.gpr.kernel[j].mean.numpy(), xpow=-1)
                          for j in range(output_dims)]).transpose([1, 0, 2])
        scales = np.array([self._x_from_kernel_units(np.sqrt(self.gpr.kernel[j].variance.numpy()),
                                                     xpow=-1)
                           for j in range(output_dims)]).transpose([1, 0, 2])
        weights = np.array([self.gpr.kernel[j].magnitude.numpy()
                            for j in range(output_dims)]).transpose([1, 0])

        noises = None
        if noise:
            if not isinstance(self.gpr.likelihood, GaussianLikelihood):
                raise ValueError("likelihood must be Gaussian to enable spectral noise")
            if getattr(self.gpr, "data_variance", None) is not None:
                raise ValueError("likelihood variance must not be per data point to enable "
                                 "spectral noise")
            noises = self.gpr.likelihood.scale.numpy()

        return plot_spectrum(means, scales, dataset=self.dataset, weights=weights,
                             noises=noises, method=method, maxfreq=maxfreq, log=log,
                             titles=names, title=title)
