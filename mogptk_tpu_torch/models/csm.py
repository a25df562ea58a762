"""CSM: Cross Spectral Mixture model, Ulrich et al. 2015.

JAX counterpart: mogptk_tpu/models/csm.py; reference
mogptk/models/csm.py:8-111. Initialization by 'BNSE', 'LS' and 'SM' (the
estimate of a pre-fitted SM model, Data.get_sm_estimation).
"""
import numpy as np

from ..gpr.config import config as gpr_config
from ..dataset import DataSet
from ..model import Model, Exact, logger
from ..gpr import CrossSpectralKernel, MixtureKernel, GaussianLikelihood


class CSM(Model):
    """Cross spectral mixture model with Q components and Rq latent functions
    (reference: mogptk/models/csm.py:8-64)."""

    def __init__(self, dataset, Q=1, Rq=1, inference=None, mean=None, name="CSM", **kwargs):
        if inference is None:
            inference = Exact()
        if not isinstance(dataset, DataSet):
            dataset = DataSet(dataset)

        output_dims = dataset.get_output_dims()
        input_dims = dataset.get_input_dims()[0]
        for input_dim in dataset.get_input_dims()[1:]:
            if input_dim != input_dims:
                raise ValueError("input dimensions for all channels must match")

        spectral = CrossSpectralKernel(output_dims=output_dims, input_dims=input_dims, Rq=Rq)
        kernel = MixtureKernel(spectral, Q)
        rng = gpr_config.numpy_rng()
        for q in range(Q):
            kernel[q].amplitude.assign(rng.random((output_dims, Rq)))
            kernel[q].mean.assign(rng.random(input_dims))
            kernel[q].variance.assign(rng.random(input_dims))

        super().__init__(dataset, kernel, inference, mean, name, **kwargs)
        self.Q = Q
        self.Rq = Rq
        nyquist = self._x_to_kernel_units(
            np.amin(self.dataset.get_nyquist_estimation(), axis=0), xpow=-1)
        for q in range(Q):
            lower = np.asarray(self.gpr.kernel[q].mean.lower)
            self.gpr.kernel[q].mean.assign(upper=np.maximum(lower, nyquist))

    def init_parameters(self, method="BNSE", iters=500):
        """Initialize from BNSE/LS/SM estimates with amplitude = mean²/Rq
        (reference: mogptk/models/csm.py:66-111)."""
        if method.lower() not in ["bnse", "ls", "sm"]:
            raise ValueError("valid methods of estimation are BNSE, LS, and SM")

        if method.lower() == "bnse":
            amplitudes, means, variances = self.dataset.get_bnse_estimation(self.Q, iters=iters)
        elif method.lower() == "ls":
            amplitudes, means, variances = self.dataset.get_ls_estimation(self.Q)
        else:
            amplitudes, means, variances = self.dataset.get_sm_estimation(self.Q, iters=iters)
        if len(amplitudes) == 0:
            logger.warning("{} could not find peaks for CSM".format(method))
            return

        output_dims = self.dataset.get_output_dims()
        means = np.concatenate(means, axis=0)
        variances = np.concatenate(variances, axis=0)
        constant = np.zeros((output_dims, self.Q, self.Rq))
        for q in range(self.Q):
            for j in range(len(self.dataset)):
                constant[j, q, :] = amplitudes[j][q, :].mean() ** 2 / self.Rq
            self.gpr.kernel[q].amplitude.assign(constant[:, q, :])
            self.gpr.kernel[q].mean.assign(self._x_to_kernel_units(means[q, :], xpow=-1))
            self.gpr.kernel[q].variance.assign(self._x_to_kernel_units(variances[q, :], xpow=-2))

        if isinstance(self.gpr.likelihood, GaussianLikelihood):
            _, Y = self.dataset.get_train_data(transformed=True)
            Y_std = [Y[j].std() for j in range(self.dataset.get_output_dims())]
            if self.gpr.likelihood.scale().ndim == 0:
                self.gpr.likelihood.scale.assign(np.mean(Y_std))
            else:
                self.gpr.likelihood.scale.assign(Y_std)
