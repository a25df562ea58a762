"""K-matvec: the MOSM Gram times a block of vectors, K(x, x)·V, with the
Gram never formed, and its plain PyTorch twin.

JAX counterparts: mogptk_tpu/ops/block_mosm.py `mosm_matvec_sorted`
(pallas_call at :507 and :530), the channel-sorted matvec of the iterative
engine, and mogptk_tpu/ops/fused.py `fused_gram_matvec` (pallas_call at
:288), the same product for any channel IDs. Both are one function of the
channel-pair statistics (ops/block_mosm.mosm_pair_stats), as K-gram is;
csrc/mosm_matvec.cu computes it for any channel order in one launch (the
iterative engine, gpr/iterative.py, passes channel-sorted rows). On a CPU
tensor the wrapper runs the plain twin; on a CUDA tensor it launches the
kernel (float32, FP32 FFMA, no TF32) or raises.
"""
import torch

from . import _build
from .mosm_gram import mosm_gram_pairstats_plain, stats_table, check_gram_inputs, generic_flag

PLAIN_ROWS = 2048    # rows of the Gram the plain twin forms at a time
MAX_R = 2048         # columns of V one launch takes


def mosm_matvec_plain(x, c, st3, st2, V):
    """Plain twin of K-matvec: K(x, x)·V from Gram row blocks of at most
    2,048 rows (mosm_gram_pairstats_plain), one matmul each."""
    N = x.shape[0]
    out = V.new_empty((N, V.shape[1]))
    for r0 in range(0, N, PLAIN_ROWS):
        r1 = min(N, r0 + PLAIN_ROWS)
        out[r0:r1] = mosm_gram_pairstats_plain(x[r0:r1], c[r0:r1], x, c, st3, st2) @ V
    return out


def mosm_matvec(x, c, st3, st2, V):
    """K(x, x)·V for the MOSM Gram of the pair statistics (st3, st2), with
    x (N, D), channel IDs c (N,) int32 and V (N, R). Not differentiable: the
    iterative engine calls it inside the forward of its autograd Function.
    CPU or float64: the plain twin. float32 CUDA, contiguous: one launch of
    csrc/mosm_matvec.cu per 2,048 columns of V, or raises."""
    if _build.runs_plain(x):
        return mosm_matvec_plain(x, c, st3, st2, V)
    O, _, Q, D, _ = st3.shape
    N, R = V.shape
    stats = stats_table(st3, st2)
    check_gram_inputs("mosm_matvec", x, c, x, c, stats, D)
    _build.require_cuda_inputs("mosm_matvec", floats=(V,))
    if N != x.shape[0] or R < 1:
        raise ValueError("mosm_matvec: V must be (N, R) with N = %d rows and R >= 1" % x.shape[0])
    out = torch.empty((N, R), dtype=torch.float32, device=x.device)
    for r0 in range(0, R, MAX_R):
        r1 = min(R, r0 + MAX_R)
        Vg = V if (r0, r1) == (0, R) else V[:, r0:r1].contiguous()
        og = out if (r0, r1) == (0, R) else torch.empty((N, r1 - r0), dtype=torch.float32,
                                                       device=x.device)
        err = _build.library().mosm_matvec_f32(
            x.data_ptr(), c.data_ptr(), stats.data_ptr(), Vg.data_ptr(), og.data_ptr(),
            N, r1 - r0, O, Q, D, generic_flag("forward", st3), _build.stream_ptr(x))
        _build.check(err, "mosm_matvec_f32")
        mosm_matvec.launches += 1
        if og is not out:
            out[:, r0:r1] = og
    return out


mosm_matvec.launches = 0
