"""Channel-pair statistics and the channel-sorted MOSM Gram.

JAX counterpart: mogptk_tpu/ops/block_mosm.py (`mosm_pair_stats` :57-76,
`mosm_gram_sorted` :446-473, `sorted_channel_counts` :669-680). Within one
channel pair every cross-statistic of the MOSM algebra is a scalar, computed
here once at O² cost. The JAX package then launched one Pallas kernel per
upper channel pair and assembled the Gram from transposes; here the channel
of each row is spelled out from `counts` and the whole N×N Gram is one call of
ops/mosm_gram.mosm_gram.
"""
import numpy as np
import torch

from .mosm_gram import mosm_gram


def mosm_pair_stats(w, mu, var, theta, phi, twopi):
    """(O, O)-pair statistics of the MOSM spectral product.

    Args: w (O, Q), mu/var/theta (O, Q, D), phi (O, Q), twopi = (2π)^(D/2).
    Returns:
        st3: (O, O, Q, D, 3) — [var_nm, mean_nm, θ_i−θ_j] per input dim.
        st2: (O, O, Q, 2)    — [α (full magnitude), φ_i−φ_j].
    """
    v1, v2 = var[:, None], var[None, :]
    m1, m2 = mu[:, None], mu[None, :]
    inv = 1.0 / (v1 + v2)
    mean_nm = inv * (v1 * m2 + v2 * m1)
    var_nm = 2.0 * v1 * inv * v2
    mag = torch.sum((m1 - m2) ** 2 * inv, dim=-1)
    alpha = ((w[:, None] * w[None, :]) * torch.exp(-np.pi ** 2 * mag)
             * twopi * torch.sqrt(torch.prod(var_nm, dim=-1)))
    dth = theta[:, None] - theta[None, :]
    dph = phi[:, None] - phi[None, :]
    st3 = torch.stack([var_nm, mean_nm, dth], dim=-1)
    st2 = torch.stack([alpha, dph], dim=-1)
    return st3, st2


def mosm_gram_sorted(x, counts, w, mu, var, theta, phi, twopi):
    """Full (N, N) MOSM Gram for channel-sorted x with per-channel `counts`."""
    counts = tuple(int(n) for n in counts)
    if len(counts) != w.shape[0]:
        raise ValueError("counts must have one entry per output dim")
    if sum(counts) != x.shape[0]:
        raise ValueError("counts must sum to the number of rows of x")
    c = torch.repeat_interleave(
        torch.arange(len(counts), dtype=torch.int32, device=x.device),
        torch.tensor(counts, device=x.device), output_size=x.shape[0])
    st3, st2 = mosm_pair_stats(w, mu, var, theta, phi, twopi)
    return mosm_gram(x, c, x, c, st3, st2)


def sorted_channel_counts(c, output_dims):
    """Per-channel counts if the channel IDs `c` are sorted, else None."""
    c = np.asarray(c).astype(np.int64)
    if c.ndim != 1 or c.size == 0:
        return None
    if np.any(np.diff(c) < 0) or c.min() < 0 or c.max() >= output_dims:
        return None
    return tuple(int(v) for v in np.bincount(c, minlength=output_dims))
