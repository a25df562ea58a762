"""K-matvec: the MOSM Gram times a block of vectors, K(x, x)·V, and
K-gram-matvec, the same product for two point sets, K(x1, x2)·V, each with
the Gram never formed and with its plain PyTorch twin.

JAX counterparts: mogptk_tpu/ops/block_mosm.py `mosm_matvec_sorted`
(pallas_call at :507 and :530), the channel-sorted matvec of the iterative
engine, mogptk_tpu/ops/fused.py `fused_gram_matvec` (pallas_call at :288),
the same product for any channel IDs, and mogptk_tpu/ops/pallas_mosm.py
`mosm_gram_matvec` (pallas_call at :351), K(x1, x2)·V for any channel IDs
and x1 ≠ x2 (K-gram-matvec; its raw-parameter entry point is this port's
ops/pallas_mosm.py). All are one function of the channel-pair statistics
(ops/block_mosm.mosm_pair_stats), as K-gram is; csrc/mosm_matvec.cu
computes it for any channel order in one launch, K-matvec as the square
case (the iterative engine, gpr/iterative.py, passes channel-sorted rows).
On a CPU tensor the wrappers run the plain twins; on a CUDA tensor they
launch the kernel (float32, FP32 FFMA, no TF32) or raise.
"""
import torch

from . import _build
from .mosm_gram import mosm_gram_pairstats_plain, stats_table, check_gram_inputs, generic_flag

PLAIN_ROWS = 2048    # rows of the Gram the plain twins form at a time
MAX_R = 2048         # columns of V one launch takes


def mosm_gram_matvec_plain(x1, c1, x2, c2, st3, st2, V):
    """Plain twin of K-gram-matvec: K(x1, x2)·V from Gram row blocks of at
    most 2,048 rows (mosm_gram_pairstats_plain), one matmul each."""
    N = x1.shape[0]
    out = V.new_empty((N, V.shape[1]))
    for r0 in range(0, N, PLAIN_ROWS):
        r1 = min(N, r0 + PLAIN_ROWS)
        out[r0:r1] = mosm_gram_pairstats_plain(x1[r0:r1], c1[r0:r1], x2, c2, st3, st2) @ V
    return out


def mosm_matvec_plain(x, c, st3, st2, V):
    """Plain twin of K-matvec: mosm_gram_matvec_plain with x2 = x1."""
    return mosm_gram_matvec_plain(x, c, x, c, st3, st2, V)


def _launch_matvec(name, x1, c1, x2, c2, st3, st2, V):
    """K(x1, x2)·V by csrc/mosm_matvec.cu mosm_gram_matvec_f32, one launch
    per 2,048 columns of V (float32, contiguous, CUDA), or raises. Returns
    (out, launches)."""
    O, _, Q, D, _ = st3.shape
    N, M = x1.shape[0], x2.shape[0]
    stats = stats_table(st3, st2)
    check_gram_inputs(name, x1, c1, x2, c2, stats, D)
    _build.require_cuda_inputs(name, floats=(V,))
    if V.dim() != 2 or V.shape[0] != M or V.shape[1] < 1:
        raise ValueError("%s: V must be (M, R) with M = %d rows and R >= 1" % (name, M))
    R = V.shape[1]
    out = torch.empty((N, R), dtype=torch.float32, device=x1.device)
    launches = 0
    for r0 in range(0, R, MAX_R):
        r1 = min(R, r0 + MAX_R)
        Vg = V if (r0, r1) == (0, R) else V[:, r0:r1].contiguous()
        og = out if (r0, r1) == (0, R) else torch.empty((N, r1 - r0), dtype=torch.float32,
                                                       device=x1.device)
        err = _build.library().mosm_gram_matvec_f32(
            x1.data_ptr(), c1.data_ptr(), x2.data_ptr(), c2.data_ptr(), stats.data_ptr(),
            Vg.data_ptr(), og.data_ptr(), N, M, r1 - r0, O, Q, D, generic_flag("forward", st3),
            _build.stream_ptr(x1))
        _build.check(err, "mosm_gram_matvec_f32")
        launches += 1
        if og is not out:
            out[:, r0:r1] = og
    return out, launches


def mosm_matvec(x, c, st3, st2, V):
    """K(x, x)·V for the MOSM Gram of the pair statistics (st3, st2), with
    x (N, D), channel IDs c (N,) int32 and V (N, R). Not differentiable: the
    iterative engine calls it inside the forward of its autograd Function.
    CPU or float64: the plain twin. float32 CUDA, contiguous: one launch of
    csrc/mosm_matvec.cu per 2,048 columns of V, or raises."""
    if _build.runs_plain(x):
        return mosm_matvec_plain(x, c, st3, st2, V)
    out, launches = _launch_matvec("mosm_matvec", x, c, x, c, st3, st2, V)
    mosm_matvec.launches += launches
    return out


mosm_matvec.launches = 0


def mosm_gram_matvec_pairstats(x1, c1, x2, c2, st3, st2, V):
    """K(x1, x2)·V for the MOSM Gram of the pair statistics (st3, st2), with
    x1 (N, D), channel IDs c1 (N,) int32, x2 (M, D), c2 (M,) int32, in any
    channel order, and V (M, R). Not differentiable. CPU or float64: the
    plain twin. float32 CUDA, contiguous: one launch of csrc/mosm_matvec.cu
    per 2,048 columns of V, or raises."""
    if _build.runs_plain(x1):
        return mosm_gram_matvec_plain(x1, c1, x2, c2, st3, st2, V)
    out, launches = _launch_matvec("mosm_gram_matvec", x1, c1, x2, c2, st3, st2, V)
    mosm_gram_matvec_pairstats.launches += launches
    return out


mosm_gram_matvec_pairstats.launches = 0
