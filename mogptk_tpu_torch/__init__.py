"""mogptk_tpu_torch — the multi-output GP toolkit on PyTorch and CUDA.

The port of mogptk_tpu (JAX on a TPU) to PyTorch on an NVIDIA H100. JAX
counterpart: mogptk_tpu/__init__.py. This package imports torch and never
jax; pandas and matplotlib are imported lazily, inside the functions that
load data frames or draw, never when the package is imported. It covers the
MOSM quick start (DataSet → MOSM → init_parameters → train → predict) on exact
inference with the closed-form or the probe-trace gradient; see README.md,
"PyTorch/CUDA port".
"""
from . import gpr
from .gpr import config, set_seed, use_single_precision, use_double_precision
from .transformer import (Transformer, TransformBase, TransformDetrend,
                          TransformLinear, TransformNormalize, TransformLog,
                          TransformStandard)
from .util import (mean_absolute_error, mean_absolute_percentage_error,
                   symmetric_mean_absolute_percentage_error,
                   mean_squared_error, root_mean_squared_error, error,
                   plot_spectrum)
from .data import Data, LoadFunction, LoadSplitData
from .dataset import DataSet, LoadCSV, LoadDataFrame
from .init import BNSE
from .model import (Model, Exact, Snelson, OpperArchambeau, Titsias, Hensman,
                    Iterative, LoadModel)
from .models import MOSM
