"""GP core of the port: config, parameters, kernels, likelihood, the exact
model, the sparse and variational models, the iterative exact model and the
trainer (Adam, SGD, AdaGrad on torch.optim; L-BFGS in gpr/lbfgs.py). JAX
counterpart: mogptk_tpu/gpr/__init__.py (the exports of the
exact and sparse training and prediction paths, the iterative engine, the
kernels, the compositors, the mean functions and the likelihoods)."""
from .config import (Config, config, set_seed, use_single_precision, use_double_precision,
                     use_blocked_cholesky, blocked_cholesky_enabled, resolve_device,
                     use_jitter_ladder)
from .parameter import Parameter, Transform, Softplus, Sigmoid
from .module import Module
from .mean import Mean, MultiOutputMean, ConstantMean, LinearMean
from .kernel import (Kernel, Kernels, AddKernel, MulKernel, MixtureKernel,
                     AutomaticRelevanceDeterminationKernel, ChangePointsKernel,
                     MultiOutputKernel)
from .singleoutput import (WhiteKernel, ConstantKernel, LinearKernel,
                           PolynomialKernel, FunctionKernel, ExponentialKernel,
                           SquaredExponentialKernel, RationalQuadraticKernel,
                           PeriodicKernel, LocallyPeriodicKernel, CosineKernel,
                           SincKernel, SpectralKernel, SpectralMixtureKernel,
                           MaternKernel)
from .multioutput import (IndependentMultiOutputKernel, MultiOutputSpectralKernel,
                          MultiOutputSpectralMixtureKernel, UncoupledMultiOutputSpectralKernel,
                          MultiOutputHarmonizableSpectralKernel, CrossSpectralKernel,
                          LinearModelOfCoregionalizationKernel, GaussianConvolutionProcessKernel)
from .likelihood import (identity, square, exp, probit, inv_probit, sigmoid,
                         GaussHermiteQuadrature, Likelihood, MultiOutputLikelihood,
                         GaussianLikelihood, StudentTLikelihood, ExponentialLikelihood,
                         LaplaceLikelihood, BernoulliLikelihood, BetaLikelihood,
                         GammaLikelihood, PoissonLikelihood, WeibullLikelihood,
                         LogLogisticLikelihood, LogGaussianLikelihood, ChiSquaredLikelihood)
from .model import (Model, Exact, Snelson, OpperArchambeau, Titsias, SparseHensman, Hensman,
                    init_inducing_points)
from .iterative import ExactIterative
from .training import train
from .util import merge_data
from .convert import load_raw_state, raw_state_numpy, parameter_names
