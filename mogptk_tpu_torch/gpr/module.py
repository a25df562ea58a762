"""Module base: parameter order and raw state, on torch.nn.Module.

JAX counterpart: mogptk_tpu/gpr/module.py. There a Module walks its
attributes in assignment order; torch.nn.Module registers submodules in the
same order, so `parameters()` (torch's own) yields the raw values of the
constrained Parameters in the JAX package's `parameters()` order. The tests
and gpr/convert.py rely on that.
"""
from torch import nn

from .parameter import Parameter


class Module(nn.Module):
    def name(self):
        return type(self).__name__

    def gp_parameters(self):
        """(path, Parameter) pairs in registration order, e.g.
        ("kernel.weight", <Parameter>); named_modules() deduplicates."""
        return [(name, mod) for name, mod in self.named_modules()
                if isinstance(mod, Parameter)]

    def raw_state(self):
        """The raw (unconstrained) tensors of all Parameters, in order,
        pegged ones included (JAX: Module.raw_state)."""
        return [p.raw.detach() for _, p in self.gp_parameters()]

    def trainable_raws(self):
        """The raw nn.Parameters the optimizer updates, in order: those of
        Parameters that are trained and not pegged (JAX: the True entries of
        Module.train_mask)."""
        return [p.raw for _, p in self.gp_parameters() if p.train and not p.pegged]
