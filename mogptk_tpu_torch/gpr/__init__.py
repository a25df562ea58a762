"""GP core of the port: config, parameters, kernels, likelihood, the exact
model, the sparse and variational models, the iterative exact model and the
trainer. JAX counterpart: mogptk_tpu/gpr/__init__.py (the exports of the
exact and sparse training and prediction paths, the iterative engine, the
multi-output kernels, the compositors and the Spectral kernel)."""
from .config import (Config, config, set_seed, use_single_precision, use_double_precision,
                     use_blocked_cholesky, blocked_cholesky_enabled, resolve_device,
                     use_jitter_ladder)
from .parameter import Parameter, Transform, Softplus, Sigmoid
from .module import Module
from .kernel import Kernel, Kernels, AddKernel, MulKernel, MixtureKernel, MultiOutputKernel
from .singleoutput import SpectralKernel
from .multioutput import (IndependentMultiOutputKernel, MultiOutputSpectralKernel,
                          MultiOutputSpectralMixtureKernel, UncoupledMultiOutputSpectralKernel,
                          MultiOutputHarmonizableSpectralKernel, CrossSpectralKernel,
                          LinearModelOfCoregionalizationKernel, GaussianConvolutionProcessKernel)
from .likelihood import Likelihood, GaussianLikelihood
from .model import (Model, Exact, Snelson, OpperArchambeau, Titsias, SparseHensman, Hensman,
                    init_inducing_points)
from .iterative import ExactIterative
from .training import train
from .util import merge_data
from .convert import load_raw_state, raw_state_numpy, parameter_names
