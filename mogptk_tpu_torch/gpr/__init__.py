"""GP core of the port: config, parameters, kernels, likelihood, the exact
model and its trainer. JAX counterpart: mogptk_tpu/gpr/__init__.py (the
exports of the exact-GP training and prediction paths, and the Spectral
kernel BNSE fits)."""
from .config import (Config, config, set_seed, use_single_precision, use_double_precision,
                     use_blocked_cholesky, blocked_cholesky_enabled, resolve_device)
from .parameter import Parameter, Transform, Softplus, Sigmoid
from .module import Module
from .kernel import Kernel, MultiOutputKernel
from .singleoutput import SpectralKernel
from .multioutput import MultiOutputSpectralMixtureKernel
from .likelihood import Likelihood, GaussianLikelihood
from .model import Model, Exact
from .training import train
from .util import merge_data
from .convert import load_raw_state, raw_state_numpy, parameter_names
