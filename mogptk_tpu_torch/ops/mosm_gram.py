"""MOSM Gram from channel-pair statistics: the K-gram kernel's wrapper and its
plain PyTorch twin.

JAX counterparts: mogptk_tpu/ops/pallas_mosm.py `mosm_gram` (forward,
pallas_call at :207) and mogptk_tpu/ops/block_mosm.py `_gram_block` (pallas_call
at :304). The first gathers per-point parameters for arbitrary channel IDs,
the second runs one channel-pair block of sorted data per launch. Both compute
the same function of the (O, O) pair statistics (ops/block_mosm.mosm_pair_stats),
so one kernel, csrc/mosm_gram.cu, serves both, over all of N x M in one launch.

On a CPU tensor `mosm_gram` runs `mosm_gram_pairstats_plain`; on a CUDA tensor
it launches the kernel or raises.
"""
import numpy as np
import torch

from . import _build

_two_pi = 2.0 * np.pi
_SMEM_LIMIT = 48 * 1024   # the pair table lives in (static-limit) shared memory


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


def mosm_gram(x1, c1, x2, c2, st3, st2):
    """(N, M) MOSM Gram; see mosm_gram_pairstats_plain for the arguments.
    CUDA: float32, contiguous, no autograd; one launch of csrc/mosm_gram.cu."""
    if x1.device.type == "cpu":
        return mosm_gram_pairstats_plain(x1, c1, x2, c2, st3, st2)
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


mosm_gram.launches = 0
