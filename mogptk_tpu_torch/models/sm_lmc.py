"""SM-LMC: Spectral Mixture Linear Model of Coregionalization.

JAX counterpart: mogptk_tpu/models/sm_lmc.py; reference
mogptk/models/sm_lmc.py:8-114. Initialization by 'BNSE' and 'LS'; 'SM' needs
the SM model, which is not ported yet: it raises NotImplementedError
(ROADMAP queue 1, item 9).
"""
import numpy as np

from ..gpr.config import config as gpr_config
from ..dataset import DataSet
from ..model import Model, Exact, logger
from ..gpr import LinearModelOfCoregionalizationKernel, SpectralKernel, GaussianLikelihood


class SM_LMC(Model):
    """LMC over Q spectral kernels with Rq latent functions; per-component
    magnitudes are fixed to 1 and the coregionalization weight carries the
    scale (reference: mogptk/models/sm_lmc.py:8-67)."""

    def __init__(self, dataset, Q=1, Rq=1, inference=None, mean=None, name="SM-LMC", **kwargs):
        if inference is None:
            inference = Exact()
        if not isinstance(dataset, DataSet):
            dataset = DataSet(dataset)

        output_dims = dataset.get_output_dims()
        input_dims = dataset.get_input_dims()[0]
        for input_dim in dataset.get_input_dims()[1:]:
            if input_dim != input_dims:
                raise ValueError("input dimensions for all channels must match")

        spectral = [SpectralKernel(input_dims) for _ in range(Q)]
        kernel = LinearModelOfCoregionalizationKernel(
            spectral, output_dims=output_dims, input_dims=input_dims, Q=Q, Rq=Rq)
        rng = gpr_config.numpy_rng()
        kernel.weight.assign(rng.random((output_dims, Q, Rq)))
        for q in range(Q):
            kernel[q].magnitude.assign(rng.random(1))
            kernel[q].mean.assign(rng.random(input_dims))
            kernel[q].variance.assign(rng.random(input_dims))

        super().__init__(dataset, kernel, inference, mean, name, **kwargs)
        self.Q = Q
        self.Rq = Rq
        nyquist = self._x_to_kernel_units(
            np.amin(self.dataset.get_nyquist_estimation(), axis=0), xpow=-1)
        for q in range(Q):
            # magnitude handled by the LMC weight (reference: models/sm_lmc.py:66)
            self.gpr.kernel[q].magnitude.assign(1.0, train=False)
            lower = np.asarray(self.gpr.kernel[q].mean.lower)
            self.gpr.kernel[q].mean.assign(upper=np.maximum(lower, nyquist))

    def init_parameters(self, method="BNSE", iters=500):
        """Initialize from BNSE/LS/SM estimates with weight = amp/Rq
        (reference: mogptk/models/sm_lmc.py:69-114)."""
        if method.lower() not in ["bnse", "ls", "sm"]:
            raise ValueError("valid methods of estimation are BNSE, LS, and SM")

        if method.lower() == "bnse":
            amplitudes, means, variances = self.dataset.get_bnse_estimation(self.Q, iters=iters)
        elif method.lower() == "ls":
            amplitudes, means, variances = self.dataset.get_ls_estimation(self.Q)
        else:
            amplitudes, means, variances = self.dataset.get_sm_estimation(self.Q, iters=iters)
        if len(amplitudes) == 0:
            logger.warning("{} could not find peaks for SM-LMC".format(method))
            return

        output_dims = self.dataset.get_output_dims()
        means = np.concatenate(means, axis=0)
        variances = np.concatenate(variances, axis=0)
        constant = np.zeros((output_dims, self.Q, self.Rq))
        for q in range(self.Q):
            for j in range(len(self.dataset)):
                constant[j, q, :] = amplitudes[j][q, :].mean() / self.Rq
            self.gpr.kernel[q].mean.assign(self._x_to_kernel_units(means[q, :], xpow=-1))
            self.gpr.kernel[q].variance.assign(self._x_to_kernel_units(variances[q, :], xpow=-2))
        self.gpr.kernel.weight.assign(constant)

        if isinstance(self.gpr.likelihood, GaussianLikelihood):
            _, Y = self.dataset.get_train_data(transformed=True)
            Y_std = [Y[j].std() for j in range(self.dataset.get_output_dims())]
            if self.gpr.likelihood.scale().ndim == 0:
                self.gpr.likelihood.scale.assign(np.mean(Y_std))
            else:
                self.gpr.likelihood.scale.assign(Y_std)
