"""GP core of the port: config, parameters, kernels, likelihood and the
exact model. JAX counterpart: mogptk_tpu/gpr/__init__.py (the exports of
the exact-GP prediction path only)."""
from .config import (Config, config, set_seed, use_single_precision, use_double_precision,
                     use_blocked_cholesky, blocked_cholesky_enabled, resolve_device)
from .parameter import Parameter, Transform, Softplus, Sigmoid
from .module import Module
from .kernel import Kernel, MultiOutputKernel
from .multioutput import MultiOutputSpectralMixtureKernel
from .likelihood import Likelihood, GaussianLikelihood
from .model import Model, Exact
from .util import merge_data
from .convert import load_raw_state, raw_state_numpy, parameter_names
