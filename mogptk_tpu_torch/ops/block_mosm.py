"""Channel-pair statistics, the channel-sorted MOSM Gram, its band-lower
variant (the K-gram-lower kernel) and the low-rank parameter VJP (the
K-lowrank-vjp kernel), each kernel with its plain PyTorch twin.

JAX counterpart: mogptk_tpu/ops/block_mosm.py (`mosm_pair_stats` :57-76,
`mosm_gram_sorted_lower` :380-443, `mosm_gram_sorted` :446-473,
`_batched_pair_layout` :555-591, `mosm_lowrank_vjp_sorted` :594-666,
`sorted_channel_counts` :669-680). Within one channel pair every
cross-statistic of the MOSM algebra is a scalar, computed here once at O²
cost. The JAX package then launched one Pallas kernel per upper channel pair
and assembled the Gram from transposes; here the channel of each row is
spelled out from `counts` and the whole N×N Gram is one call of
ops/mosm_gram.mosm_gram (differentiable; its backward is K-gram-bwd).

The kernels take the pair statistics (st3, st2), not the parameters: the
training path (ops/linalg.lml_chol_fused) receives the statistics as inputs
and autograd chains their cotangents through `mosm_pair_stats`.
"""
import functools

import numpy as np
import torch
import torch.nn.functional as F

from . import _build
from .mosm_gram import (mosm_gram, mosm_gram_pairstats_plain, stats_table, check_gram_inputs,
                        generic_flag)

# tile edge of the band-lower Gram's tile list (its band and every channel
# count are multiples of it), and of the low-rank VJP's tile list
TILE = 512
BWD_TILE = 256
LOWRANK_MAX_CHUNK = 64   # columns of A and B that K-lowrank-vjp stages at a time

_two_pi = 2.0 * np.pi


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


def pair_stats_vjp(params, twopi, dst3, dst2):
    """Parameter cotangents (dw, dmu, dvar, dtheta, dphi) from cotangents of
    the pair statistics, through mosm_pair_stats by autograd (the chain the
    training path applies to K-lowrank-vjp's output)."""
    params = [p.detach().requires_grad_() for p in params]
    with torch.enable_grad():
        st3, st2 = mosm_pair_stats(*params, twopi)
        return torch.autograd.grad((st3, st2), params, (dst3, dst2))


def channel_ids(counts, device):
    """(N,) int32 channel ID of every row of channel-sorted data."""
    return torch.repeat_interleave(
        torch.arange(len(counts), dtype=torch.int32, device=device),
        torch.tensor(counts, device=device), output_size=sum(counts))


def mosm_gram_sorted(x, counts, w, mu, var, theta, phi, twopi):
    """Full (N, N) MOSM Gram for channel-sorted x with per-channel `counts`,
    differentiable in the parameters through ops/mosm_gram.MosmGram (JAX:
    `_gram_block`'s custom VJP, B2; there the lower blocks are transposes of
    upper ones, here one launch covers the whole N×N each way)."""
    counts = tuple(int(n) for n in counts)
    if len(counts) != w.shape[0]:
        raise ValueError("counts must have one entry per output dim")
    if sum(counts) != x.shape[0]:
        raise ValueError("counts must sum to the number of rows of x")
    c = channel_ids(counts, x.device)
    st3, st2 = mosm_pair_stats(w, mu, var, theta, phi, twopi)
    return mosm_gram(x, c, x, c, st3, st2, counts, counts)


# -- K-gram-lower (TPU kernel A1) ----------------------------------------------

def mosm_gram_sorted_lower_plain(x, c, st3, st2, band):
    """Plain twin of K-gram-lower: the full Gram with every tile the kernel
    leaves unwritten set to NaN, so that a consumer that reads one shows it."""
    K = mosm_gram_pairstats_plain(x, c, x, c, st3, st2)
    bandT = band // TILE
    for ti in range(x.shape[0] // TILE):
        # unwritten: tj > ti outside ti's band, i.e. every column past the band
        K[ti * TILE:(ti + 1) * TILE, (ti // bandT + 1) * band:] = float("nan")
    return K


def mosm_gram_sorted_lower(x, counts, st3, st2, band=1024):
    """(N, N) Gram buffer with only the tiles the blocked Cholesky reads
    written: tile row ti ≥ tile column tj, or both inside one band-aligned
    diagonal panel (the factorization's diagonal blocks). The other tiles are
    never written; their memory is undefined, and only a consumer that never
    reads them may take this buffer (ops/linalg.lml_chol_fused: the blocked
    factorization with panel width `band`, zero_upper=False, and the fused
    solve).

    Returns None unless every count, N and the band are multiples of TILE and
    the band divides N; callers then take mosm_gram_sorted. CPU: the plain
    twin (unwritten tiles NaN), as in float64. float32 CUDA: one launch of
    csrc/mosm_gram.cu mosm_gram_lower_f32, or raises."""
    counts = tuple(int(n) for n in counts)
    n = int(sum(counts))
    if (any(k % TILE for k in counts) or n % TILE or band % TILE or n % band
            or x.shape[0] != n):
        return None
    c = channel_ids(counts, x.device)
    if _build.runs_plain(x):
        return mosm_gram_sorted_lower_plain(x, c, st3, st2, band)
    O, _, Q, D, _ = st3.shape
    stats = stats_table(st3, st2)
    check_gram_inputs("mosm_gram_sorted_lower", x, c, x, c, stats, D)
    out = torch.empty((n, n), dtype=torch.float32, device=x.device)
    err = _build.library().mosm_gram_lower_f32(
        x.data_ptr(), c.data_ptr(), stats.data_ptr(), out.data_ptr(), n, O, Q, D, TILE, band,
        generic_flag("forward", st3), _build.stream_ptr(x))
    _build.check(err, "mosm_gram_lower_f32")
    mosm_gram_sorted_lower.launches += 1
    return out


mosm_gram_sorted_lower.launches = 0


# -- K-lowrank-vjp (TPU kernel A5) ---------------------------------------------

def _bwd_scalars_plain(x1, x2, s3, s2, g):
    """Cotangents of one pair's statistics s3 (Q, D, 3), s2 (Q, 2) for the
    Gram block between x1 (n1, D) and x2 (n2, D) under cotangent g (n1, n2):
    the hand-derived backward of the τ chain (JAX: block_mosm._bwd_scalars
    with phase_inside). Returns (ds3, ds2) shaped like (s3, s2)."""
    Q, D, _ = s3.shape
    ds3 = torch.zeros_like(s3)
    ds2 = torch.zeros_like(s2)
    for q in range(Q):
        tds = [x1[:, d, None] - x2[None, :, d] + s3[q, d, 2] for d in range(D)]
        e = sum(td * td * s3[q, d, 0] for d, td in enumerate(tds))
        a = sum(td * s3[q, d, 1] for d, td in enumerate(tds))
        ang = _two_pi * (a + s2[q, 1])
        E = torch.exp(-0.5 * e)
        C, S = torch.cos(ang), torch.sin(ang)
        gE = g * E
        P = s2[q, 0] * gE
        dang = -P * S
        de = -0.5 * P * C
        da = _two_pi * dang
        ds2[q, 0] = torch.sum(gE * C)
        ds2[q, 1] = torch.sum(dang) * _two_pi
        for d, td in enumerate(tds):
            ds3[q, d, 0] = torch.sum(de * td * td)
            ds3[q, d, 1] = torch.sum(da * td)
            ds3[q, d, 2] = torch.sum(de * (2.0 * s3[q, d, 0]) * td + da * s3[q, d, 1])
    return ds3, ds2


def mosm_lowrank_vjp_plain(x, counts, st3, st2, A, B):
    """Plain twin of K-lowrank-vjp: for every upper pair (a ≤ b) the block
    cotangent g = (ABᵀ)_ab + [a≠b]·((ABᵀ)_ba)ᵀ, reduced by the same hand
    formula. The diagonal pairs reduce their whole block, where the kernel
    folds each lower tile into its upper mirror; the Δθ and Δφ rows of a
    diagonal pair differ between the two, and those statistics (θ_a − θ_a,
    φ_a − φ_a) carry no parameter gradient, so the parameter cotangents
    agree. Compare parameter cotangents, not rows."""
    O = st3.shape[0]
    offs = np.concatenate([[0], np.cumsum(counts)]).astype(int)
    dst3 = torch.zeros_like(st3)
    dst2 = torch.zeros_like(st2)
    for a in range(O):
        sa = slice(offs[a], offs[a + 1])
        for b in range(a, O):
            sb = slice(offs[b], offs[b + 1])
            if counts[a] == 0 or counts[b] == 0:
                continue
            g = A[sa] @ B[sb].T
            if a != b:
                g = g + (A[sb] @ B[sa].T).T
            dst3[a, b], dst2[a, b] = _bwd_scalars_plain(x[sa], x[sb], st3[a, b], st2[a, b], g)
    return dst3, dst2


@functools.lru_cache(maxsize=16)
def _pair_layout(counts, T):
    """The kernel's work lists for channel counts `counts` (JAX:
    _batched_pair_layout). Each present channel is padded to a multiple of
    T rows. Returns (idx, pairs): idx (S, 3) int32 [row tile, column tile,
    pair id a·O + b] over the upper tiles of every upper pair, grouped by
    pair; pairs (P, 3) int32 [pair id, first partial row, partial rows],
    four partial rows (one per quarter-tile block) per tile."""
    O = len(counts)
    pres = [i for i in range(O) if counts[i] > 0]
    start, ntiles, first = {}, {}, 0
    for i in pres:
        start[i], ntiles[i] = first, -(-counts[i] // T)
        first += ntiles[i]
    idx, pairs = [], []
    for ai, a in enumerate(pres):
        for b in pres[ai:]:
            s0 = len(idx)
            for ti in range(start[a], start[a] + ntiles[a]):
                for tj in range(ti if a == b else start[b], start[b] + ntiles[b]):
                    idx.append((ti, tj, a * O + b))
            pairs.append((a * O + b, 4 * s0, 4 * (len(idx) - s0)))
    return (np.asarray(idx, np.int32).reshape(-1, 3), np.asarray(pairs, np.int32).reshape(-1, 3))


@functools.lru_cache(maxsize=16)
def _device_layout(counts, T, device):
    """_pair_layout's lists as int32 tensors on `device`, uploaded once."""
    return tuple(torch.as_tensor(a, device=device) for a in _pair_layout(counts, T))


def _pad_channels(a, counts, T):
    """Rows of each channel padded with zeros to a multiple of T (empty
    channels dropped); a itself when nothing needs padding."""
    if all(k % T == 0 for k in counts):
        return a.contiguous()
    pieces, off = [], 0
    for k in counts:
        if k:
            pieces.append(F.pad(a[off:off + k], (0, 0, 0, (-k) % T)))
        off += k
    return torch.cat(pieces).contiguous()


def lowrank_chunk(R):
    """The columns of A and B that K-lowrank-vjp stages in shared memory at a
    time for rank R: min(R, 64). The kernel accumulates the cotangent tile
    over ceil(R / chunk) chunks in order, so it takes any R."""
    if R < 1:
        raise ValueError("the rank R must be at least 1")
    return min(int(R), LOWRANK_MAX_CHUNK)


def mosm_lowrank_vjp_sorted(x, counts, st3, st2, A, B):
    """Cotangents (dst3, dst2) of the pair statistics for dK = A·Bᵀ, without
    forming dK, for channel-sorted x (N, D) with per-channel `counts` and A,
    B (N, R), any R. Rows of lower pairs (a > b) stay zero: each upper pair's
    rows carry both of its blocks. CPU or float64: the plain twin. float32
    CUDA: one call of csrc/mosm_lowrank_vjp.cu (the tile kernel, R in chunks
    of lowrank_chunk(R) columns, and its per-pair reduction), or raises."""
    counts = tuple(int(n) for n in counts)
    if _build.runs_plain(x):
        return mosm_lowrank_vjp_plain(x, counts, st3, st2, A, B)
    O, _, Q, D, _ = st3.shape
    R = A.shape[1]
    if sum(counts) != x.shape[0] or A.shape != B.shape or A.shape[0] != x.shape[0]:
        raise ValueError("mosm_lowrank_vjp_sorted: x (N, D), A and B (N, R) with N = sum(counts)")
    idx_np, pairs_np = _pair_layout(counts, BWD_TILE)
    nout = 3 * Q * D + 2 * Q
    out = torch.zeros((O * O, nout), dtype=torch.float32, device=x.device)
    if idx_np.shape[0]:
        xp, ap, bp = (_pad_channels(t, counts, BWD_TILE) for t in (x, A, B))
        idx, pairs = _device_layout(counts, BWD_TILE, x.device)
        stats = stats_table(st3, st2)
        partial = torch.empty((4 * idx_np.shape[0], nout), dtype=torch.float32, device=x.device)
        _build.require_cuda_inputs("mosm_lowrank_vjp_sorted", floats=(xp, ap, bp, stats),
                                   ints=(idx, pairs))
        err = _build.library().mosm_lowrank_vjp_f32(
            idx.data_ptr(), xp.data_ptr(), ap.data_ptr(), bp.data_ptr(), stats.data_ptr(),
            partial.data_ptr(), pairs.data_ptr(), out.data_ptr(), idx_np.shape[0],
            pairs_np.shape[0], Q, D, R, lowrank_chunk(R), generic_flag("backward", st3),
            _build.stream_ptr(x))
        _build.check(err, "mosm_lowrank_vjp_f32")
        mosm_lowrank_vjp_sorted.launches += 1
    return (out[:, :3 * Q * D].reshape(O, O, Q, D, 3), out[:, 3 * Q * D:].reshape(O, O, Q, 2))


mosm_lowrank_vjp_sorted.launches = 0


def sorted_channel_counts(c, output_dims):
    """Per-channel counts if the channel IDs `c` are sorted, else None."""
    c = np.asarray(c).astype(np.int64)
    if c.ndim != 1 or c.size == 0:
        return None
    if np.any(np.diff(c) < 0) or c.min() < 0 or c.max() >= output_dims:
        return None
    return tuple(int(v) for v in np.bincount(c, minlength=output_dims))
