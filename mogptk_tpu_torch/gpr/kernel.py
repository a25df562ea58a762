"""Kernel base classes.

JAX counterpart: mogptk_tpu/gpr/kernel.py (Kernel, MultiOutputKernel). The
compositors (Add, Mul, Mixture, ARD, ChangePoints) are not ported yet.
Multi-output kernels take X with the channel ID in column 0 and implement
`K_mo(c1, x1, c2, x2)` on integer channel vectors.
"""
import torch

from .module import Module


class Kernel(Module):
    """Base kernel.

    Args:
        input_dims (int): number of input dimensions.
    """

    def __init__(self, input_dims=None):
        super().__init__()
        self.input_dims = input_dims
        self.output_dims = None

    def forward(self, X1, X2=None):
        X1, X2 = self._check_input(X1, X2)
        return self.K(X1, X2)

    def _check_input(self, X1, X2=None):
        if X1.ndim != 2:
            raise ValueError("X should have two dimensions (data_points,input_dims)")
        if X1.shape[0] == 0 or X1.shape[1] == 0:
            raise ValueError("X must not be empty")
        if X2 is not None:
            if X2.ndim != 2:
                raise ValueError("X should have two dimensions (data_points,input_dims)")
            if X2.shape[0] == 0:
                raise ValueError("X must not be empty")
            if X1.shape[1] != X2.shape[1]:
                raise ValueError("input dimensions for X1 and X2 must match")
        return X1, X2

    def K(self, X1, X2=None):
        raise NotImplementedError()

    def K_diag(self, X1):
        return torch.diagonal(self.K(X1))


class MultiOutputKernel(Kernel):
    """Base for multi-output kernels; column 0 of X holds channel IDs."""

    def __init__(self, output_dims, input_dims=None):
        super().__init__(input_dims)
        self.output_dims = output_dims

    def _check_input(self, X1, X2=None):
        X1, X2 = super()._check_input(X1, X2)
        for X in (X1, X2):
            if X is None:
                continue
            c = X[:, 0]
            if not bool(torch.all((c == torch.round(c)) & (0 <= c) & (c < self.output_dims))):
                raise ValueError("X must have integers in [0, output_dims) for the channel IDs in the first input dimension")
        return X1, X2

    @staticmethod
    def _split(X):
        """(channel IDs as int32, the inputs without the ID column), both
        contiguous as the CUDA kernels require."""
        return X[:, 0].to(torch.int32), X[:, 1:].contiguous()

    def K(self, X1, X2=None):
        c1, x1 = self._split(X1)
        if X2 is None:
            c2, x2 = c1, None
        else:
            c2, x2 = self._split(X2)
        return self.K_mo(c1, x1, c2, x2)

    def K_diag(self, X1):
        c1, x1 = self._split(X1)
        return self.K_mo_diag(c1, x1)

    def K_mo(self, c1, x1, c2, x2=None):
        raise NotImplementedError()

    def K_mo_diag(self, c1, x1):
        raise NotImplementedError()
