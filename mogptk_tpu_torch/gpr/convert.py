"""Carry parameters between the JAX package and the port.

No JAX counterpart. The JAX package's `Module.raw_state()`
(mogptk_tpu/gpr/module.py:98-100) lists the raw (unconstrained) arrays in its
`parameters()` order; the port registers the same Parameters in the same
order (gpr/module.py), so copying raw values one to one makes both packages
apply the same bijector to the same numbers.
"""
import numpy as np
import torch


def parameter_names(model):
    """JAX-style names of the port's Parameters ("<OwnerClass>.<attr>", as
    the JAX package names them), in order."""
    modules = dict(model.named_modules())
    names = []
    for path, _ in model.gp_parameters():
        owner, _, attr = path.rpartition(".")
        names.append("%s.%s" % (type(modules[owner]).__name__, attr))
    return names


def load_raw_state(model, raws, names=None):
    """Copy a JAX model's raw_state() (numpy arrays, in parameters() order)
    into the port's raw nn.Parameters.

    Args:
        model: the port's gpr model or module, or a top-level model
            (mogptk_tpu_torch.Model, e.g. MOSM), which loads into its .gpr:
            so a trained JAX mogptk_tpu.MOSM's raws carry into the port's.
        raws: list of arrays, e.g. [np.asarray(r) for r in jax_model.raw_state()].
        names: optional JAX parameter names ([p.name for p in
            jax_model.parameters()]) checked against parameter_names(model).

    Raises ValueError on a count, shape or name mismatch, before copying.
    """
    if not hasattr(model, "gp_parameters") and hasattr(model, "gpr"):
        model = model.gpr
    params = model.gp_parameters()
    if len(raws) != len(params):
        raise ValueError("expected %d raw arrays, got %d" % (len(params), len(raws)))
    if names is not None:
        ours = parameter_names(model)
        if list(names) != ours:
            raise ValueError("parameter names differ: %s != %s" % (list(names), ours))
    raws = [np.asarray(r) for r in raws]
    for (path, p), r in zip(params, raws):
        if tuple(r.shape) != p.shape:
            raise ValueError("%s: shape %s != %s" % (path, tuple(r.shape), p.shape))
    with torch.no_grad():
        for (_, p), r in zip(params, raws):
            p.raw.copy_(torch.as_tensor(np.array(r), dtype=p.raw.dtype))


def raw_state_numpy(model):
    """The port's raw values as numpy arrays, in parameters() order: copies,
    which later training steps leave as they are."""
    return [r.cpu().numpy().copy() for r in model.raw_state()]
