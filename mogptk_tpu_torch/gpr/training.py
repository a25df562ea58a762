"""Optimizer-driven training of a gpr model.

JAX counterpart: mogptk_tpu/gpr/training.py (`_make_optimizer` :19-32,
`_build_lbfgs_step` :39-56, `train` :130-208). There the whole step ran as
one jitted optax program on a flat parameter vector. Here an Adam, SGD or
AdaGrad step is model.loss() (the forward, on the hand-written kernels for
CUDA tensors), .backward() and one torch.optim step over the trainable raw
nn.Parameters. Adam per leaf is optax Adam on the flat vector elementwise:
the same β1 = 0.9, β2 = 0.999 and ε = 1e-8 outside the square root, with the
same bias corrections. LBFGS runs gpr/lbfgs.py, optax.lbfgs()'s L-BFGS and
zoom line search, on the trainable raws packed into one flat vector; each
evaluation of the line search is one model.loss() and its backward.
"""
import time

import numpy as np
import torch

from .lbfgs import LBFGS


def _make_optimizer(method, params, lr):
    # default learning rates follow the torch optimizers the reference uses
    # (mogptk/model.py:541-561): Adam 1e-3, SGD/AdaGrad 1e-2
    method_l = method.lower().replace("-", "")
    if method_l == "adam":
        return torch.optim.Adam(params, lr=1e-3 if lr is None else lr)
    if method_l == "sgd":
        return torch.optim.SGD(params, lr=1e-2 if lr is None else lr)
    if method_l == "adagrad":
        # optax.adagrad's accumulator starts at 0.1 (its ε, 1e-7 inside the
        # square root, stays torch's 1e-10 outside it)
        return torch.optim.Adagrad(params, lr=1e-2 if lr is None else lr,
                                   initial_accumulator_value=0.1)
    raise ValueError("optimizer method %s unknown; use Adam, SGD, AdaGrad, or LBFGS" % method)


def _flat_loss(model, raws):
    """fun(x) for gpr/lbfgs.py: x written into the raws, then the loss and
    its gradient with respect to the raws, flattened in their order."""
    sizes = [r.numel() for r in raws]

    def fun(x):
        _write(raws, sizes, x)
        loss = model.loss()
        grads = torch.autograd.grad(loss, raws, allow_unused=True)
        return loss.detach(), torch.cat([torch.zeros_like(r).reshape(-1) if g is None
                                         else g.reshape(-1) for r, g in zip(raws, grads)])

    return fun, sizes


def _write(raws, sizes, x):
    with torch.no_grad():
        for r, v in zip(raws, torch.split(x, sizes)):
            r.copy_(v.reshape(r.shape))


def train(model, method="Adam", lr=None, iters=500, verbose=False, callback=None, **kwargs):
    """Train a gpr model in place; returns (losses, elapsed_seconds).

    Args:
        model: a mogptk_tpu_torch.gpr.Model.
        method: 'Adam', 'SGD', 'AdaGrad' or 'LBFGS'.
        lr: learning rate (None: the method's default; LBFGS ignores it, its
            line search sets the step).
        iters: number of optimizer steps (LBFGS: iterations, each as many
            evaluations of the loss as its line search needs).
        verbose: print the loss about 20 times.
        callback: called as callback(i, loss) after step i, loss a float,
            with the model holding step i's parameters.
        memory_size, scale_init_precond: LBFGS's options (gpr/lbfgs.py);
            any other keyword raises TypeError.

    losses[i] is the loss before step i's update, as in the JAX package.
    The Adam, SGD and AdaGrad losses stay on the device until the end, so a
    step waits for nothing but its own kernels (verbose printing and a
    callback synchronize); the line search reads each evaluation's value."""
    iters = int(iters)
    if iters < 0:
        raise ValueError("iters must be non-negative")
    lbfgs = method.lower().replace("-", "") == "lbfgs"
    if kwargs and not lbfgs:
        raise TypeError("train() got unexpected keyword arguments for %s: %s"
                        % (method, ", ".join(kwargs)))
    params = model.trainable_raws()
    # LBFGS's TypeError names any keyword but its two options
    optimizer = LBFGS(**kwargs) if lbfgs else _make_optimizer(method, params, lr)
    if not params or iters == 0:
        return np.zeros(0), 0.0
    if lbfgs:
        fun, sizes = _flat_loss(model, params)
        x = torch.cat([r.detach().reshape(-1) for r in params])
    losses = []
    start = time.time()
    for i in range(iters):
        if lbfgs:
            x, value = optimizer.step(fun, x)
            _write(params, sizes, x)
            losses.append(value)
        else:
            optimizer.zero_grad(set_to_none=True)
            loss = model.loss()
            loss.backward()
            optimizer.step()
            losses.append(loss.detach())
        if verbose and (i % max(1, iters // 20) == 0 or i == iters - 1):
            print("  iter %5d/%d  loss %.6g" % (i + 1, iters, float(losses[-1])))
        if callback is not None:
            callback(i, float(losses[-1]))
    losses = np.asarray(losses) if lbfgs else torch.stack(losses).cpu().numpy()
    elapsed = time.time() - start
    if not np.isfinite(losses[-1]):
        raise RuntimeError("training loss is not finite: %r" % (losses[-1],))
    return losses, elapsed
