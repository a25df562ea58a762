"""CONV: Gaussian Convolution Process model, Álvarez & Lawrence 2009.

JAX counterpart: mogptk_tpu/models/conv.py; reference
mogptk/models/conv.py:8-103. Initialization by 'BNSE', 'LS' and 'SM' (the
estimate of a pre-fitted SM model, Data.get_sm_estimation).
"""
import numpy as np

from ..gpr.config import config as gpr_config
from ..dataset import DataSet
from ..model import Model, Exact, logger
from ..gpr import GaussianConvolutionProcessKernel, MixtureKernel, GaussianLikelihood


class CONV(Model):
    """Convolution process model with Q components
    (reference: mogptk/models/conv.py:8-59)."""

    def __init__(self, dataset, Q=1, inference=None, mean=None, name="CONV", **kwargs):
        if inference is None:
            inference = Exact()
        if not isinstance(dataset, DataSet):
            dataset = DataSet(dataset)

        output_dims = dataset.get_output_dims()
        input_dims = dataset.get_input_dims()[0]
        for input_dim in dataset.get_input_dims()[1:]:
            if input_dim != input_dims:
                raise ValueError("input dimensions for all channels must match")

        conv = GaussianConvolutionProcessKernel(output_dims=output_dims, input_dims=input_dims)
        kernel = MixtureKernel(conv, Q)
        rng = gpr_config.numpy_rng()
        for q in range(Q):
            kernel[q].weight.assign(rng.random(output_dims))
            kernel[q].variance.assign(rng.random((output_dims, input_dims)))
            kernel[q].base_variance.assign(rng.random(input_dims))

        super().__init__(dataset, kernel, inference, mean, name, **kwargs)
        self.Q = Q

    def init_parameters(self, method="SM", iters=500):
        """Initialize from BNSE/LS/SM estimates using the reference's 5×/10×
        heuristic scaling (reference: mogptk/models/conv.py:61-103)."""
        if method.lower() not in ["bnse", "ls", "sm"]:
            raise ValueError("valid methods of estimation are BNSE, LS, and SM")

        if method.lower() == "bnse":
            amplitudes, means, variances = self.dataset.get_bnse_estimation(self.Q, iters=iters)
        elif method.lower() == "ls":
            amplitudes, means, variances = self.dataset.get_ls_estimation(self.Q)
        else:
            amplitudes, means, variances = self.dataset.get_sm_estimation(self.Q, iters=iters)
        if len(amplitudes) == 0:
            logger.warning("{} could not find peaks for CONV".format(method))
            return

        for q in range(self.Q):
            self.gpr.kernel[q].weight.assign([5.0 * amplitude[q, :].mean() for amplitude in amplitudes])
            # the estimate is a spectral variance (x⁻² units), so it converts
            # by ITS unit: rescale_x="normalize" init is defined as the
            # reference's heuristic run on pre-normalized data (the 10×
            # unit conflation is the reference's, models/conv.py:61-103)
            self.gpr.kernel[q].variance.assign(self._x_to_kernel_units(
                np.array([10.0 * variance[q, :] for variance in variances]), xpow=-2))

        if isinstance(self.gpr.likelihood, GaussianLikelihood):
            _, Y = self.dataset.get_train_data(transformed=True)
            Y_std = [Y[j].std() for j in range(self.dataset.get_output_dims())]
            if self.gpr.likelihood.scale().ndim == 0:
                self.gpr.likelihood.scale.assign(np.mean(Y_std))
            else:
                self.gpr.likelihood.scale.assign(Y_std)
