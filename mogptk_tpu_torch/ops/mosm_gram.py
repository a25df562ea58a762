"""MOSM Gram from channel-pair statistics, differentiable: the K-gram kernel
(forward) and the K-gram-bwd kernel (backward), each wrapper with its plain
PyTorch twin, behind one torch.autograd.Function, `MosmGram`.

JAX counterparts: mogptk_tpu/ops/pallas_mosm.py `mosm_gram` (forward,
pallas_call at :207; backward `_mosm_gram_bwd`, pallas_call at :274) and
mogptk_tpu/ops/block_mosm.py `_gram_block` (pallas_call at :304; backward
`_gram_block_bwd`, pallas_call at :345). The first gathers per-point
parameters for arbitrary channel IDs, the second runs one channel-pair block
of sorted data per launch. Both compute the same function of the (O, O) pair
statistics (ops/block_mosm.mosm_pair_stats), so one forward kernel,
csrc/mosm_gram.cu, serves both over all of N x M in one launch, and one
backward kernel, csrc/mosm_gram_bwd.cu, turns a dense (N, M) cotangent into
cotangents of the pair statistics; autograd chains those through
mosm_pair_stats to the parameters. Input cotangents (the JAX backward's
`input_grads`, for trained inducing points) are not ported.

`MosmGram` is the graph on both devices; only its body dispatches: on a CPU
tensor the plain twins, on a CUDA tensor the kernels or an exception.
"""
import functools

import numpy as np
import torch

from . import _build

_two_pi = 2.0 * np.pi
_SMEM_LIMIT = 48 * 1024   # the pair table lives in (static-limit) shared memory
BWD_TILE = 256            # K-gram-bwd's tile edge: channels are padded to it
BWD_MAX_Q, BWD_MAX_D = 4, 2   # the (Q, D) instances csrc/mosm_gram_bwd.cu compiles


def mosm_gram_pairstats_plain(x1, c1, x2, c2, st3, st2):
    """(N, M) MOSM Gram in plain torch: per element, the pair (c1[i], c2[j])
    selects its statistics; large temporaries are (N, M), Q and D unrolled.

    Args:
        x1 (N, D), c1 (N,) int, x2 (M, D), c2 (M,) int,
        st3 (O, O, Q, D, 3) [var, mean, Δθ], st2 (O, O, Q, 2) [α, Δφ].
    """
    _, _, Q, D, _ = st3.shape
    i1 = c1.long()[:, None]
    i2 = c2.long()[None, :]
    K = None
    for q in range(Q):
        e = a = None
        for d in range(D):
            s = st3[:, :, q, d]
            td = (x1[:, d, None] - x2[None, :, d]) + s[:, :, 2][i1, i2]
            ed = td * td * s[:, :, 0][i1, i2]
            ad = td * s[:, :, 1][i1, i2]
            e = ed if e is None else e + ed
            a = ad if a is None else a + ad
        alpha = st2[:, :, q, 0][i1, i2]
        dphi = st2[:, :, q, 1][i1, i2]
        Kq = alpha * torch.exp(-0.5 * e) * torch.cos(_two_pi * (a + dphi))
        K = Kq if K is None else K + Kq
    return K


def mosm_gram_bwd_plain(x1, c1, x2, c2, st3, st2, g):
    """Plain twin of K-gram-bwd: the cotangents (dst3, dst2) of the pair
    statistics for the Gram's cotangent g (N, M). The hand-derived backward
    of the τ chain (ops/block_mosm._bwd_scalars_plain, JAX
    block_mosm._bwd_scalars) with per-element pair gathers; each element's
    terms are summed into its pair (c1[i], c2[j])."""
    O, _, Q, D, _ = st3.shape
    i1 = c1.long()[:, None]
    i2 = c2.long()[None, :]
    pid = (i1 * O + i2).reshape(-1)
    dst3 = torch.zeros_like(st3)
    dst2 = torch.zeros_like(st2)

    def pair_sum(t):
        # accumulated in float64, as the kernel's per-pair reduction is: a
        # float32 index_add_ over 2.7e8 elements loses ~1e-4 of the sum
        return torch.zeros(O * O, dtype=torch.float64, device=t.device).index_add_(
            0, pid, t.reshape(-1).double()).reshape(O, O).to(t.dtype)

    for q in range(Q):
        s3 = [st3[:, :, q, d] for d in range(D)]
        tds = [(x1[:, d, None] - x2[None, :, d]) + s3[d][:, :, 2][i1, i2] for d in range(D)]
        e = sum(td * td * s3[d][:, :, 0][i1, i2] for d, td in enumerate(tds))
        a = sum(td * s3[d][:, :, 1][i1, i2] for d, td in enumerate(tds))
        ang = _two_pi * (a + st2[:, :, q, 1][i1, i2])
        gE = g * torch.exp(-0.5 * e)
        C, S = torch.cos(ang), torch.sin(ang)
        P = st2[:, :, q, 0][i1, i2] * gE
        dang = -P * S
        de = -0.5 * P * C
        da = _two_pi * dang
        dst2[:, :, q, 0] = pair_sum(gE * C)
        dst2[:, :, q, 1] = pair_sum(dang) * _two_pi
        for d, td in enumerate(tds):
            dst3[:, :, q, d, 0] = pair_sum(de * td * td)
            dst3[:, :, q, d, 1] = pair_sum(da * td)
            dst3[:, :, q, d, 2] = pair_sum(de * (2.0 * s3[d][:, :, 0][i1, i2]) * td
                                           + da * s3[d][:, :, 1][i1, i2])
    return dst3, dst2


def stats_table(st3, st2):
    """The (O·O, 3QD + 2Q) pair table the CUDA kernels read: per pair
    [V, M, Δθ] × (q, d), then [α, Δφ] × q."""
    O = st3.shape[0]
    return torch.cat([st3.reshape(O * O, -1), st2.reshape(O * O, -1)], dim=1).contiguous()


def check_gram_inputs(name, x1, c1, x2, c2, stats, D):
    """The K-gram kernels' input checks; raises instead of falling back."""
    _build.require_cuda_inputs(name, floats=(x1, x2, stats), ints=(c1, c2))
    N, M = x1.shape[0], x2.shape[0]
    if x1.shape[1] != D or x2.shape[1] != D or c1.shape != (N,) or c2.shape != (M,):
        raise ValueError("%s: x1 (N, D), c1 (N,), x2 (M, D), c2 (M,) expected" % name)
    if stats.numel() * 4 > _SMEM_LIMIT:
        raise ValueError("%s: %d channel-pair statistics exceed shared memory" % (name, stats.numel()))


def _mosm_gram_kernel(x1, c1, x2, c2, st3, st2):
    """(N, M) Gram: one launch of csrc/mosm_gram.cu (float32, contiguous,
    CUDA), or raises."""
    O, _, Q, D, _ = st3.shape
    stats = stats_table(st3, st2)
    check_gram_inputs("mosm_gram", x1, c1, x2, c2, stats, D)
    N, M = x1.shape[0], x2.shape[0]
    out = torch.empty((N, M), dtype=torch.float32, device=x1.device)
    err = _build.library().mosm_gram_f32(
        x1.data_ptr(), c1.data_ptr(), x2.data_ptr(), c2.data_ptr(), stats.data_ptr(),
        out.data_ptr(), N, M, O, Q, D, _build.stream_ptr(x1))
    _build.check(err, "mosm_gram_f32")
    mosm_gram.launches += 1
    return out


# -- K-gram-bwd (TPU kernels B2 and C1b) ----------------------------------------

@functools.lru_cache(maxsize=32)
def _gram_layout(counts1, counts2, T):
    """K-gram-bwd's work lists for row channel counts `counts1` and column
    channel counts `counts2`, each channel padded to a multiple of T rows
    (columns). Returns (idx, pairs): idx (S, 3) int32 [row tile, column
    tile, pair id a·O + b] over every tile of every present pair (a, b),
    grouped by pair; pairs (P, 3) int32 [pair id, first partial row, partial
    rows], four partial rows (one per quarter-tile block) per tile."""
    O = len(counts1)

    def tiles(counts):
        first, out = 0, {}
        for a, k in enumerate(counts):
            if k:
                out[a] = range(first, first + -(-k // T))
                first += len(out[a])
        return out

    rows, cols = tiles(counts1), tiles(counts2)
    idx, pairs = [], []
    for a, rt in rows.items():
        for b, ct in cols.items():
            s0 = len(idx)
            idx.extend((ti, tj, a * O + b) for ti in rt for tj in ct)
            pairs.append((a * O + b, 4 * s0, 4 * (len(idx) - s0)))
    return (np.asarray(idx, np.int32).reshape(-1, 3), np.asarray(pairs, np.int32).reshape(-1, 3))


@functools.lru_cache(maxsize=32)
def _device_gram_layout(counts1, counts2, T, device):
    """_gram_layout's lists as int32 tensors on `device`, uploaded once."""
    return tuple(torch.as_tensor(a, device=device) for a in _gram_layout(counts1, counts2, T))


def channel_counts(c, O):
    """Per-channel counts of the channel IDs c (a host read of O numbers)."""
    counts = tuple(int(k) for k in torch.bincount(c.long(), minlength=O).tolist())
    if len(counts) != O:
        raise ValueError("channel IDs must lie in [0, %d)" % O)
    return counts


def channel_map(c, counts, T=BWD_TILE):
    """(Np,) int32: for each position of the channel-sorted layout whose
    channels are padded to multiples of T, the index of the point of c that
    sits there, −1 for padding. `counts` are c's per-channel counts."""
    order = torch.argsort(c, stable=True).to(torch.int32)   # the identity for sorted c
    pieces, off = [], 0
    for k in counts:
        if k:
            pieces.append(order[off:off + k])
            pieces.append(torch.full(((-k) % T,), -1, dtype=torch.int32, device=c.device))
        off += k
    return torch.cat(pieces) if pieces else order


def mosm_gram_bwd(x1, c1, x2, c2, st3, st2, g, counts1=None, counts2=None):
    """Cotangents (dst3, dst2) of the pair statistics for a dense cotangent
    g (N, M) of mosm_gram(x1, c1, x2, c2, st3, st2). counts1/counts2: the
    per-channel counts of c1/c2 when known (channel-sorted data), else read
    from them. CPU: the plain twin. CUDA: float32, contiguous; one call of
    csrc/mosm_gram_bwd.cu (the tile kernel and its per-pair reduction), or
    raises."""
    if x1.device.type == "cpu":
        return mosm_gram_bwd_plain(x1, c1, x2, c2, st3, st2, g)
    O, _, Q, D, _ = st3.shape
    stats = stats_table(st3, st2)
    check_gram_inputs("mosm_gram_bwd", x1, c1, x2, c2, stats, D)
    N, M = x1.shape[0], x2.shape[0]
    if g.shape != (N, M):
        raise ValueError("mosm_gram_bwd: the cotangent must be (N, M) = (%d, %d)" % (N, M))
    if not (1 <= Q <= BWD_MAX_Q and 1 <= D <= BWD_MAX_D):
        raise ValueError("mosm_gram_bwd: the CUDA kernel takes Q <= %d and D <= %d"
                         % (BWD_MAX_Q, BWD_MAX_D))
    counts1 = channel_counts(c1, O) if counts1 is None else tuple(int(k) for k in counts1)
    counts2 = channel_counts(c2, O) if counts2 is None else tuple(int(k) for k in counts2)
    idx_np, pairs_np = _gram_layout(counts1, counts2, BWD_TILE)
    nout = 3 * Q * D + 2 * Q
    out = torch.zeros((O * O, nout), dtype=torch.float32, device=x1.device)
    if idx_np.shape[0]:
        rmap, cmap = channel_map(c1, counts1), channel_map(c2, counts2)
        idx, pairs = _device_gram_layout(counts1, counts2, BWD_TILE, x1.device)
        partial = torch.empty((4 * idx_np.shape[0], nout), dtype=torch.float32, device=x1.device)
        _build.require_cuda_inputs("mosm_gram_bwd", floats=(g, partial),
                                   ints=(idx, pairs, rmap, cmap))
        err = _build.library().mosm_gram_bwd_f32(
            idx.data_ptr(), g.data_ptr(), x1.data_ptr(), rmap.data_ptr(), x2.data_ptr(),
            cmap.data_ptr(), stats.data_ptr(), partial.data_ptr(), pairs.data_ptr(),
            out.data_ptr(), idx_np.shape[0], pairs_np.shape[0], M, Q, D, _build.stream_ptr(x1))
        _build.check(err, "mosm_gram_bwd_f32")
        mosm_gram_bwd.launches += 1
    return (out[:, :3 * Q * D].reshape(O, O, Q, D, 3), out[:, 3 * Q * D:].reshape(O, O, Q, 2))


mosm_gram_bwd.launches = 0


class MosmGram(torch.autograd.Function):
    """The (N, M) MOSM Gram of the pair statistics, differentiable in them.

    Forward: K-gram on CUDA, the plain twin on the CPU. It saves its inputs
    and never its output: the exact-GP LML factors the Gram in place
    (ops/linalg.LmlQuadformLogdetShifted), so nothing may keep the Gram for
    the backward. Backward: dst3, dst2 from K-gram-bwd (CUDA) or its plain
    twin (CPU); autograd chains them through mosm_pair_stats. The inputs x1
    and x2 get no cotangent (training inputs are constant)."""

    @staticmethod
    def forward(ctx, x1, c1, x2, c2, st3, st2, counts1, counts2):
        x1, x2, st3, st2 = (t.detach() for t in (x1, x2, st3, st2))
        ctx.counts = (counts1, counts2)
        ctx.save_for_backward(x1, c1, x2, c2, st3, st2)
        if x1.device.type == "cpu":
            return mosm_gram_pairstats_plain(x1, c1, x2, c2, st3, st2)
        return _mosm_gram_kernel(x1, c1, x2, c2, st3, st2)

    @staticmethod
    def backward(ctx, g):
        x1, c1, x2, c2, st3, st2 = ctx.saved_tensors
        dst3, dst2 = mosm_gram_bwd(x1, c1, x2, c2, st3, st2, g.contiguous(), *ctx.counts)
        return None, None, None, None, dst3, dst2, None, None


def mosm_gram(x1, c1, x2, c2, st3, st2, counts1=None, counts2=None):
    """(N, M) MOSM Gram, differentiable in st3/st2 (MosmGram); see
    mosm_gram_pairstats_plain for the arguments. counts1/counts2: the
    per-channel counts when c1/c2 are channel-sorted (saves the backward a
    host read). CUDA: float32, contiguous; K-gram forward, K-gram-bwd
    backward. Inputs that need a gradient for x1 or x2 raise."""
    if x1.requires_grad or x2.requires_grad:
        raise NotImplementedError("cotangents of the MOSM Gram's inputs (trained inducing points) "
                                  "are not ported yet (ROADMAP queue 1, item 7)")
    return MosmGram.apply(x1, c1, x2, c2, st3, st2, counts1, counts2)


mosm_gram.launches = 0
