"""Multi-output spectral mixture kernel (MOSM), Parra & Tobar 2017.

JAX counterpart: mogptk_tpu/gpr/multioutput.py `MultiOutputSpectralMixtureKernel`
(:324-379). Its plain per-point formulation `_mosm_K` (:74-141) is the same
function as ops/mosm_gram.mosm_gram_pairstats_plain, which every Gram here
goes through: on CUDA the hand-written K-gram kernel, on the CPU that plain
twin. `family` and `_params()` are what the fused training LML
(ops/linalg.lml_chol_fused) needs: it builds the band-lower Gram itself from
the pair statistics. The other multi-output families are not
ported yet.
"""
import numpy as np
import torch

from .kernel import MultiOutputKernel
from .parameter import Parameter
from .config import config
from ..ops.block_mosm import mosm_pair_stats, mosm_gram_sorted
from ..ops.mosm_gram import mosm_gram


class MultiOutputSpectralMixtureKernel(MultiOutputKernel):
    """MOSM with Q components per channel.

    Args:
        Q (int): number of components.
        output_dims (int): number of channels.
        input_dims (int): number of input dimensions.
    """

    def __init__(self, Q, output_dims, input_dims=1):
        super().__init__(output_dims, input_dims)
        self.Q = Q
        self.weight = Parameter(np.ones((output_dims, Q)), lower=config.positive_minimum)
        self.mean = Parameter(np.zeros((output_dims, Q, input_dims)), lower=config.positive_minimum)
        self.variance = Parameter(np.ones((output_dims, Q, input_dims)), lower=config.positive_minimum)
        self.delay = Parameter(np.zeros((output_dims, Q, input_dims)))
        self.phase = Parameter(np.zeros((output_dims, Q)))
        if output_dims == 1:
            self.delay.train = False
            self.phase.train = False
        self.twopi = float(np.power(2.0 * np.pi, float(input_dims) / 2.0))

    @property
    def family(self):
        """Fused-family id (name, statics): MOSM with the phase inside 2π
        (JAX: gpr/iterative._family_of)."""
        return ("mosm", (self.twopi, True))

    def _params(self):
        return (self.weight(), self.mean(), self.variance(), self.delay(), self.phase())

    def K_mo(self, c1, x1, c2, x2=None):
        st3, st2 = mosm_pair_stats(*self._params(), self.twopi)
        return mosm_gram(x1, c1, x1 if x2 is None else x2, c2, st3, st2)

    def K_sorted(self, X, counts):
        """Square Gram of channel-sorted X with per-channel `counts`."""
        _, x = self._split(X)
        return mosm_gram_sorted(x, counts, *self._params(), self.twopi)

    def K_mo_diag(self, c1, x1):
        alpha = self.weight() ** 2 * self.twopi * torch.sqrt(torch.prod(self.variance(), dim=-1))
        return torch.sum(alpha, dim=-1)[c1.long()]
