"""Channel packing between per-channel lists and the (N, 1+input_dims)
channel-ID format.

JAX counterpart: mogptk_tpu/gpr/util.py `merge_data` (:10-41).
"""
import numpy as np
import torch

from .config import config, resolve_device


def merge_data(xs, ys=None, device=None):
    """Stack per-channel (x, y) lists into channel-ID format.

    Returns (N, X) or (N, X, Y): N is the per-channel point count list, X has
    the channel ID in column 0. Tensors are in config.dtype on `device`
    (None = config.device)."""
    if not isinstance(xs, list) or (ys is not None and not isinstance(ys, list)):
        raise ValueError("input must be a list of channels")
    if ys is not None and len(ys) != len(xs):
        raise ValueError("inputs must have the same number of output dimensions")
    device = resolve_device(device)
    xs = [np.asarray(x).reshape(len(np.asarray(x)), -1) for x in xs]
    N = [x.shape[0] for x in xs]
    X = np.concatenate([np.concatenate([np.full((n, 1), float(c)), x], axis=1)
                        for c, (n, x) in enumerate(zip(N, xs))], axis=0)
    X = torch.as_tensor(X, dtype=config.dtype, device=device)
    if ys is None:
        return N, X
    ys = [np.asarray(y).reshape(-1, 1) for y in ys]
    if not all(y.shape[0] == N[i] for i, y in enumerate(ys)):
        raise ValueError("inputs must have the same number of data points per output dimension")
    Y = torch.as_tensor(np.concatenate(ys, axis=0), dtype=config.dtype, device=device)
    return N, X, Y
