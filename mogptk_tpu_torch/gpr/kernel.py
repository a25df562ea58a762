"""Kernel base classes and the sum, product and mixture compositors.

JAX counterpart: mogptk_tpu/gpr/kernel.py (Kernel, Kernels, AddKernel,
MulKernel, MixtureKernel :156-245, AutomaticRelevanceDeterminationKernel
:246-256, ChangePointsKernel :259-322, MultiOutputKernel). Multi-output kernels take X
with the channel ID in column 0 and implement `K_mo(c1, x1, c2, x2)` on
integer channel vectors. A compositor keeps its children in an
nn.ModuleList, so their Parameters register in the JAX package's
`parameters()` order.
"""
import copy

import numpy as np
import torch
from torch import nn

from .module import Module
from .parameter import Parameter
from .config import config


class Kernel(Module):
    """Base kernel.

    Args:
        input_dims (int): number of input dimensions.
        active_dims (list of int): the columns of X this kernel reads.
    """

    def __init__(self, input_dims=None, active_dims=None):
        super().__init__()
        self.input_dims = input_dims
        self.output_dims = None
        self.active_dims = active_dims

    @property
    def active_dims(self):
        return self._active_dims

    @active_dims.setter
    def active_dims(self, active_dims):
        if active_dims is not None:
            if not isinstance(active_dims, list):
                active_dims = [active_dims]
            if not all(isinstance(item, (int, np.integer)) for item in active_dims):
                raise ValueError("active dimensions must be a list of integers")
            if self.input_dims is not None and self.input_dims != len(active_dims):
                raise ValueError("input dimensions must match the number of active dimensions")
            self.input_dims = len(active_dims)
            active_dims = [int(d) for d in active_dims]
        self._active_dims = active_dims

    def _active_input(self, X1, X2=None):
        if self._active_dims is not None:
            X1 = X1[:, self._active_dims]
            if X2 is not None:
                X2 = X2[:, self._active_dims]
        return X1, X2

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

    def _check_kernels(self, kernels, length=None):
        """A list of kernels from a kernel, a list or a tuple of them, padded
        with clones of the first to `length`; single-output children of a
        multi-output composite skip the channel column (JAX:
        Kernel._check_kernels)."""
        if isinstance(kernels, tuple):
            if len(kernels) == 1 and isinstance(kernels[0], list):
                kernels = kernels[0]
            else:
                kernels = list(kernels)
        elif not isinstance(kernels, list):
            kernels = [kernels]
        kernels = list(kernels)
        if len(kernels) == 0:
            raise ValueError("must pass at least one kernel")
        elif length is not None and len(kernels) != length:
            if len(kernels) != 1:
                raise ValueError("must pass %d kernels" % length)
            for _ in range(length - len(kernels)):
                kernels.append(kernels[0].clone())
        for kernel in kernels:
            if not isinstance(kernel, Kernel):
                raise ValueError("must pass kernels")
        if any(kernel.input_dims != kernels[0].input_dims for kernel in kernels[1:]):
            raise ValueError("kernels must have same input dimensions")
        output_dims = [kernel.output_dims for kernel in kernels if kernel.output_dims is not None]
        if any(output_dim != output_dims[0] for output_dim in output_dims[1:]):
            raise ValueError("multi-output kernels must have same output dimensions")
        if len(output_dims) != 0:
            for kernel in kernels:
                if kernel.active_dims is None and kernel.output_dims is None:
                    input_dims = kernel.input_dims if kernel.input_dims is not None else 1
                    kernel.active_dims = [input_dim + 1 for input_dim in range(input_dims)]
        return kernels

    def clone(self):
        return copy.deepcopy(self)

    def K(self, X1, X2=None):
        raise NotImplementedError()

    def K_diag(self, X1):
        return torch.diagonal(self.K(X1))

    @staticmethod
    def average(X1, X2=None):
        if X2 is None:
            X2 = X1
        return 0.5 * (X1[:, None, :] + X2[None, :, :])

    @staticmethod
    def distance(X1, X2=None):
        if X2 is None:
            X2 = X1
        return X1[:, None, :] - X2[None, :, :]

    @staticmethod
    def squared_distance(X1, X2=None):
        if X2 is None:
            X2 = X1
        return (X1[:, None, :] - X2[None, :, :]) ** 2

    def __add__(self, other):
        return AddKernel(self, other)

    def __mul__(self, other):
        return MulKernel(self, other)


class Kernels(Kernel):
    """Base of the kernels composed of a list of kernels. A child
    compositor of the same associative kind (sum in a sum, product in a
    product) without active_dims of its own is flattened into this one
    (JAX: Kernels._assoc)."""

    _assoc = None

    def __init__(self, *kernels):
        super().__init__()
        kernels = self._check_kernels(kernels)
        i = 0
        while i < len(kernels):
            if (self._assoc is not None
                    and getattr(kernels[i], "_assoc", None) == self._assoc
                    and kernels[i].active_dims is None):
                subkernels = list(kernels[i].kernels)
                kernels = kernels[:i] + subkernels + kernels[i + 1:]
                i += len(subkernels) - 1
            i += 1
        self.kernels = nn.ModuleList(kernels)
        self.input_dims = kernels[0].input_dims
        output_dims = [kernel.output_dims for kernel in kernels if kernel.output_dims is not None]
        self.output_dims = output_dims[0] if output_dims else None

    def name(self):
        return "[%s]" % ",".join(kernel.name() for kernel in self.kernels)

    def __getitem__(self, key):
        return self.kernels[key]


class AddKernel(Kernels):
    """Sum of kernels."""

    _assoc = "sum"

    def K(self, X1, X2=None):
        X1, X2 = self._active_input(X1, X2)
        return sum(kernel.K(X1, X2) for kernel in self.kernels)

    def K_diag(self, X1):
        X1, _ = self._active_input(X1)
        return sum(kernel.K_diag(X1) for kernel in self.kernels)


class MulKernel(Kernels):
    """Product of kernels."""

    _assoc = "prod"

    def K(self, X1, X2=None):
        X1, X2 = self._active_input(X1, X2)
        out = None
        for kernel in self.kernels:
            k = kernel.K(X1, X2)
            out = k if out is None else out * k
        return out

    def K_diag(self, X1):
        X1, _ = self._active_input(X1)
        out = None
        for kernel in self.kernels:
            k = kernel.K_diag(X1)
            out = k if out is None else out * k
        return out


class MixtureKernel(AddKernel):
    """Sum of Q clones of a kernel."""

    def __init__(self, kernel, Q):
        if not isinstance(kernel, Kernel):
            raise ValueError("must pass kernel")
        kernels = self._check_kernels(kernel, Q)
        super().__init__(*kernels)


class AutomaticRelevanceDeterminationKernel(MulKernel):
    """Product of clones of a one-dimensional kernel, clone i reading input
    dimension i."""

    def __init__(self, kernel, input_dims):
        if not isinstance(kernel, Kernel):
            raise ValueError("must pass kernel")
        kernels = self._check_kernels(kernel, input_dims)
        for i, k in enumerate(kernels):
            k.active_dims = i
        super().__init__(*kernels)


class ChangePointsKernel(Kernels):
    """Kernels switching at sorted `locations` of a one-dimensional input,
    each regime weighted by sigmoids of the given steepness. Parameters
    register as in the JAX package: the kernels', then `locations`, then
    `steepness`."""

    def __init__(self, locations, steepnesses=1.0, *kernels):
        if not isinstance(locations, list):
            locations = [locations]
        if len(kernels) != len(locations) + 1:
            raise ValueError(
                "Must pass one more kernel than the number of locations points. "
                "Got %d kernels and %d locations points." % (len(kernels), len(locations)))
        if isinstance(steepnesses, list) and len(steepnesses) > 1:
            if len(locations) != len(steepnesses):
                raise ValueError(
                    "Must pass as many locations as steepness point(s). "
                    "Got %d locations and %d steepness points." % (len(locations), len(steepnesses)))
        if list(locations) != sorted(locations):
            raise ValueError("'locations' must be sorted ascendingly and 'steepnesses' should be "
                             "ordered correspondingly.")
        super().__init__(*kernels)
        if self.input_dims != 1:
            raise ValueError("Must pass kernels defined over a 1D input domain.")
        self.locations = Parameter(locations)
        self.steepness = Parameter(steepnesses, lower=config.positive_minimum)

    def _weight_sigmoid(self, X):
        return 1.0 / (1.0 + torch.exp(-self.steepness() * (X - self.locations())))

    def K(self, X1, X2=None):
        X1, X2 = self._active_input(X1, X2)
        w1 = self._weight_sigmoid(X1)[:, None, :]
        w2 = w1.transpose(0, 1) if X2 is None else self._weight_sigmoid(X2)[None, :, :]
        ones = torch.ones(w1.shape[0], w2.shape[1], 1, dtype=X1.dtype, device=X1.device)
        start_weights = torch.cat((ones, w1 * w2), dim=-1)
        end_weights = torch.cat(((1.0 - w1) * (1.0 - w2), ones), dim=-1)
        kernel_stack = torch.stack([kernel.K(X1, X2) for kernel in self.kernels], dim=-1)
        return torch.sum(start_weights * kernel_stack * end_weights, dim=-1)

    def K_diag(self, X1):
        X1, _ = self._active_input(X1)
        w = self._weight_sigmoid(X1)
        ones = torch.ones(X1.shape[0], 1, dtype=X1.dtype, device=X1.device)
        start_weights = torch.cat((ones, w ** 2), dim=-1)
        end_weights = torch.cat(((1.0 - w) ** 2, ones), dim=-1)
        kernel_stack = torch.stack([kernel.K_diag(X1) for kernel in self.kernels], dim=-1)
        return torch.sum(start_weights * kernel_stack * end_weights, dim=-1)


class MultiOutputKernel(Kernel):
    """Base for multi-output kernels; column 0 of X holds channel IDs."""

    def __init__(self, output_dims, input_dims=None, active_dims=None):
        super().__init__(input_dims, active_dims)
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

    @staticmethod
    def _channels(n, i, like):
        """(n,) int32 channel IDs, all i, beside `like`."""
        return torch.full((n,), i, dtype=torch.int32, device=like.device)

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

    def Ksub(self, i, j, X1, X2=None):
        """The Gram between channel i at X1 and channel j at X2 (inputs
        without the channel column)."""
        X1, X2 = self._active_input(X1, X2)
        c1 = self._channels(X1.shape[0], i, X1)
        c2 = self._channels(X1.shape[0] if X2 is None else X2.shape[0], j, X1)
        return self.K_mo(c1, X1, c2, X2)

    def Ksub_diag(self, i, X1):
        return torch.diagonal(self.Ksub(i, i, X1))
