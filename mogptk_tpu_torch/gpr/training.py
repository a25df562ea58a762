"""Optimizer-driven training of a gpr model on torch.optim.

JAX counterpart: mogptk_tpu/gpr/training.py (`_make_optimizer` :19-32,
`train` :130-208). There the whole step ran as one jitted optax program on a
flat parameter vector; here each step is model.loss() (the forward, on the
hand-written kernels for CUDA tensors), .backward() and one torch.optim
step over the trainable raw nn.Parameters. Adam per leaf is optax Adam on the
flat vector elementwise: the same β1 = 0.9, β2 = 0.999 and ε = 1e-8 outside
the square root, with the same bias corrections. LBFGS is not ported:
optax.lbfgs and torch.optim.LBFGS differ (line search, history handling).
"""
import time

import numpy as np
import torch


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
    if method_l == "lbfgs":
        raise NotImplementedError("LBFGS is not ported yet (ROADMAP queue 1, item 8): "
                                  "optax.lbfgs and torch.optim.LBFGS differ")
    raise ValueError("optimizer method %s unknown; use Adam, SGD, AdaGrad, or LBFGS" % method)


def train(model, method="Adam", lr=None, iters=500, verbose=False, callback=None):
    """Train a gpr model in place; returns (losses, elapsed_seconds).

    Args:
        model: a mogptk_tpu_torch.gpr.Model.
        method: 'Adam', 'SGD' or 'AdaGrad' ('LBFGS' raises).
        lr: learning rate (None: the method's default).
        iters: number of optimizer steps.
        verbose: print the loss about 20 times.
        callback: called as callback(i, loss) after step i, loss a float.

    losses[i] is the loss before step i's update, as in the JAX package.
    The losses stay on the device until the end, so a step waits for nothing
    but its own kernels (verbose printing and a callback synchronize)."""
    iters = int(iters)
    if iters < 0:
        raise ValueError("iters must be non-negative")
    params = model.trainable_raws()
    optimizer = _make_optimizer(method, params, lr)
    if not params or iters == 0:
        return np.zeros(0), 0.0
    losses = []
    start = time.time()
    for i in range(iters):
        optimizer.zero_grad(set_to_none=True)
        loss = model.loss()
        loss.backward()
        optimizer.step()
        losses.append(loss.detach())
        if verbose and (i % max(1, iters // 20) == 0 or i == iters - 1):
            print("  iter %5d/%d  loss %.6g" % (i + 1, iters, float(losses[-1])))
        if callback is not None:
            callback(i, float(losses[-1]))
    losses = torch.stack(losses).cpu().numpy()
    elapsed = time.time() - start
    if not np.isfinite(losses[-1]):
        raise RuntimeError("training loss is not finite: %r" % (losses[-1],))
    return losses, elapsed
