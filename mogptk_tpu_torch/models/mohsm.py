"""MOHSM: Multi-Output Harmonizable Spectral Mixture model, Altamirano 2021.

JAX counterpart: mogptk_tpu/models/mohsm.py; reference
mogptk/models/mohsm.py:8-145. Initialization by 'BNSE', 'LS' and 'SM' (the
estimate of a pre-fitted SM model, Data.get_sm_estimation).
"""
import numpy as np

from ..gpr.config import config as gpr_config
from ..dataset import DataSet
from ..model import Model, Exact, logger
from ..gpr import MultiOutputHarmonizableSpectralKernel, MixtureKernel, GaussianLikelihood


class MOHSM(Model):
    """Nonstationary multi-output model with P components × Q subcomponents
    (reference: mogptk/models/mohsm.py:8-62)."""

    def __init__(self, dataset, P=1, Q=1, inference=None, mean=None, name="MOHSM",
                 psd_safe=False, **kwargs):
        if inference is None:
            inference = Exact()
        if not isinstance(dataset, DataSet):
            dataset = DataSet(dataset)

        output_dims = dataset.get_output_dims()
        input_dims = dataset.get_input_dims()[0]
        for input_dim in dataset.get_input_dims()[1:]:
            if input_dim != input_dims:
                raise ValueError("input dimensions for all channels must match")

        # psd_safe: cap the envelope precision at the locally-stationary PSD
        # bound (gpr.MultiOutputHarmonizableSpectralKernel._effective_l2) —
        # trainable where the reference formula NaNs (narrow LS-estimated
        # spectral variances over wide X ranges)
        spectral = MultiOutputHarmonizableSpectralKernel(
            output_dims=output_dims, input_dims=input_dims, psd_safe=psd_safe)
        kernel = MixtureKernel(spectral, P * Q)
        rng = gpr_config.numpy_rng()
        for p in range(P):
            for q in range(Q):
                kernel[p * Q + q].weight.assign(rng.random(output_dims))
                kernel[p * Q + q].mean.assign(rng.random((output_dims, input_dims)))
                kernel[p * Q + q].variance.assign(rng.random((output_dims, input_dims)))
                kernel[p * Q + q].lengthscale.assign(rng.random(output_dims))

        super().__init__(dataset, kernel, inference, mean, name, **kwargs)
        self.Q = Q
        self.P = P

    def init_parameters(self, method="BNSE", iters=500):
        """Initialize from BNSE/LS/SM estimates with center/lengthscale
        spreading for P>1 and variance scaling 4+20(D−1)
        (reference: mogptk/models/mohsm.py:64-145)."""
        input_dims = self.dataset.get_input_dims()
        output_dims = self.dataset.get_output_dims()

        if method.lower() not in ["bnse", "ls", "sm"]:
            raise ValueError("valid methods of estimation are BNSE, LS, and SM")

        # the spectral estimation is loop-invariant (the reference recomputes
        # it per p only because its commented-out per-p data filtering would
        # have changed the inputs): run the expensive estimate ONCE
        if method.lower() == "bnse":
            amplitudes, means, variances = self.dataset.get_bnse_estimation(self.Q, iters=iters)
        elif method.lower() == "ls":
            amplitudes, means, variances = self.dataset.get_ls_estimation(self.Q)
        else:
            amplitudes, means, variances = self.dataset.get_sm_estimation(self.Q, iters=iters)
        if len(amplitudes) == 0:
            logger.warning("{} could not find peaks for MOHSM".format(method))
            return

        for p in range(self.P):
            for q in range(self.Q):
                if self.P != 1:
                    self.gpr.kernel[p * self.Q + q].center.assign(
                        (1000 * p / (self.P - 1)) * np.ones(input_dims[0]))
                    self.gpr.kernel[p * self.Q + q].lengthscale.assign(
                        ((self.P + 1) / 1000) * np.ones(output_dims))

            weight = np.zeros((output_dims, self.Q))
            for q in range(self.Q):
                mean = np.zeros((output_dims, input_dims[0]))
                variance = np.zeros((output_dims, input_dims[0]))
                for j in range(output_dims):
                    if q < amplitudes[j].shape[0]:
                        weight[j, q] = amplitudes[j][q, :].mean()
                        mean[j, :] = means[j][q, :]
                        variance[j, :] = variances[j][q, :] * (4 + 20 * (max(input_dims) - 1))
                self.gpr.kernel[p * self.Q + q].mean.assign(
                    self._x_to_kernel_units(mean, xpow=-1))
                self.gpr.kernel[p * self.Q + q].variance.assign(
                    self._x_to_kernel_units(variance, xpow=-2))

            # normalize proportionally to channel variances
            # (reference: models/mohsm.py:129-136)
            for j, channel in enumerate(self.dataset):
                x, y = channel.get_train_data(transformed=True)
                if 0.0 < weight[j, :].sum():
                    weight[j, :] = np.sqrt(weight[j, :] / weight[j, :].sum() * y.var()) * 2

            for q in range(self.Q):
                self.gpr.kernel[p * self.Q + q].weight.assign(
                    weight[:, q] / np.sqrt(self.gpr.kernel[p * self.Q + q].lengthscale.numpy()))

        if isinstance(self.gpr.likelihood, GaussianLikelihood):
            _, Y = self.dataset.get_train_data(transformed=True)
            Y_std = [Y[j].std() for j in range(self.dataset.get_output_dims())]
            if self.gpr.likelihood.scale().ndim == 0:
                self.gpr.likelihood.scale.assign(np.mean(Y_std))
            else:
                self.gpr.likelihood.scale.assign(Y_std)
