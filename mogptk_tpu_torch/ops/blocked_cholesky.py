"""Left-looking blocked Cholesky, in place, with the K-spanel, K-colwrite,
K-sdiag, K-below-trsm and K-commit kernels' wrappers and their plain PyTorch
twins.

JAX counterpart: mogptk_tpu/ops/blocked_cholesky.py (`blocked_cholesky`
:642-856, `effective_block` :624-639). Per block column j (r0 = j·B):

1. S = K[r0:, r0:r0+B] − L[r0:, :r0]·L[r0:r0+B, :r0]ᵀ  (`s_panel`; the JAX
   Pallas kernel `_s_panel_pallas`; on the card with k split into chunks
   where the output tiles fill the SMs poorly, `spanel_plan`, and the
   chunks' partial products summed by `s_panel_reduce`);
2. Ljj = chol(S[:B] + diag shift), inv = Ljj⁻¹ on the B×B block (library
   calls; the JAX package's recursive `_panel_factor_inv` worked around the
   TPU's expander and is not ported); with return_panel_invs every inverse,
   the last one included, is kept for the solves (ops/fused_solve);
3. L[r0:r0+B, r0:r0+B] = Ljj, L[r0+B:, r0:r0+B] = S[B:]·invᵀ, and the strip
   right of the diagonal block zeroed (`col_write`; the JAX Pallas kernels
   `_col_strip_write`, and `_panel_write` when zero_upper is off).

The fused below-TRSM variant (`fused_trsm`, JAX :751-779) runs every block
column after the first as: S_jj = K_jj − C·Cᵀ, C = L[r0:r0+B, :r0]
(`s_diag`, JAX `_s_diag_pallas`); step 2; the rows below finished in one
call, (K_below − L[r0+B:, :r0]·Cᵀ)·invᵀ written straight into column j
(`below_trsm`, JAX `_below_trsm_pallas` and the below half of
`_col_commit`; on the card the two products on the tensor cores, S below
the diagonal block in a scratch strip between them, `below_trsm_plan`'s
split-K); then Ljj into the diagonal block (times the range scale's 1/r)
and, with zero_upper, the strip zeroed (K-commit, JAX `_col_commit` and
`_upper_zero_impl`: on the card inside K-below-trsm's TRSM launch, and
for the last column, which has no rows below, `col_commit`'s own launch).
Block column 0 takes steps 1-3, as in the JAX package.

The factor is built in the buffer that holds K: K is overwritten. When n is
not a multiple of the block, K is copied into a padded buffer with an
identity tail first, and K itself is left as it was. Every step reads and
writes the same buffer and runs on one stream in order.

Two shape and range rules hold where the kernels run (float32 on the card;
the plain twins need neither). The width: K-colwrite takes panels of a
multiple of 64 columns, so `factor_plan` rounds the panel width up to one
and the identity-tail padding covers n (a shape gate, decided from n and
the block alone). The range: the 3xTF32 kernels scale their operands by
2^16 and so need every sum of |products| below ~7.9e28, which for a factor
is max diag(K). `range_scale` takes, on the device and with no host read,
an exact power of two s = r^2 from max diag(K + shift) that brings it
below 1 (exactly 1 below 2^64), and the kernels apply it inside their
epilogues: the factorization runs on s K, L comes out unscaled by 1/r and
the panel inverses by r, all exact, so a factor in range is bit-identical
to the unscaled one and one out of range is the factor of s K, unscaled.
"""
import functools

import torch

from . import _build


def effective_block(n, block_size):
    """The panel width used for an n×n matrix: the block clamped to n, or,
    when it does not divide n, the largest multiple of 512 below it that
    does (so the factorization stays unpadded)."""
    B = int(min(block_size, n))
    if n % B and B % 512 == 0:
        for cand in range(B, 511, -512):
            if n % cand == 0:
                return cand
    return B


# K-colwrite's panel widths (its GEMM's tiles and float4 copies)
KERNEL_WIDTH_MULTIPLE = 64
# below this max diag(K + shift) the range scale is exactly 1; far inside
# the 3xTF32 kernels' cap of ~7.9e28 (2^96) on the sums of |products|
RANGE_LIMIT = 2.0 ** 64


def factor_plan(n, block_size, kernels):
    """(B, npad): the panel width blocked_cholesky factors an n×n matrix
    with, and n padded to a multiple of it (the identity tail). B is
    effective_block's; where the kernels run (kernels=True: float32 on the
    card) a width that is no multiple of 64 is rounded up to one, the width
    K-colwrite takes (n = 300 factors as one 320-wide panel, a 200-wide
    block at n = 4,000 as sixteen 256-wide ones). The twins take any
    width."""
    B = effective_block(n, block_size)
    if kernels:
        B += -B % KERNEL_WIDTH_MULTIPLE
    return B, -(-n // B) * B


def range_scale(diag):
    """The factor's range scale from the diagonal of K + shift, computed on
    its device with no host read: a (3,) tensor [s, r, 1/r] with r = 2^-k
    and s = r², k = 0 where max(diag) < 2^64 (RANGE_LIMIT) and otherwise
    the least k with max(diag)·s < 1. Exact powers of two, so scaling by
    them is exact (the kernels' use: module docstring)."""
    m = torch.amax(diag)
    e = torch.frexp(m).exponent
    k = torch.where(m < RANGE_LIMIT, 0, torch.div(e + 1, 2, rounding_mode="floor")).to(torch.int32)
    r = torch.bitwise_left_shift(127 - k, 23).view(torch.float32)
    rinv = torch.bitwise_left_shift(127 + k, 23).view(torch.float32)
    return torch.stack([r * r, r, rinv]).to(diag.dtype)


def _scale_ptr(scale):
    return None if scale is None else scale.data_ptr()


def s_panel_plain(L, S, j, B):
    """S[:m] = L[r0:, r0:r0+B] − L[r0:, :r0]·L[r0:r0+B, :r0]ᵀ, m = n − r0,
    where columns r0.. of L still hold K."""
    r0 = j * B
    torch.sub(L[r0:, r0:r0 + B], L[r0:, :r0] @ L[r0:r0 + B, :r0].T, out=S[:L.shape[0] - r0])


def col_write_plain(L, S, Ljj, inv, j, B, zero_upper=True):
    """Finish block column j of L in place from S (the s_panel result), the
    diagonal factor Ljj and its inverse inv (None for the last column)."""
    n = L.shape[0]
    r0 = j * B
    L[r0:r0 + B, r0:r0 + B] = Ljj
    if r0 + B < n:
        L[r0 + B:, r0:r0 + B] = S[B:n - r0] @ inv.T
        if zero_upper:
            L[r0:r0 + B, r0 + B:] = 0


# csrc/gemm_tf32x3.cuh's output tile (rows and columns) and k slice, and
# the H100 SXM's SM count, which spanel_plan fills
TF32X3_TILE = 128
TF32X3_K_SLICE = 32
H100_SMS = 132
# spanel_plan's cost model: a k chunk holds at least this many slices; one
# slice of one CTA (3 x 2 x 128 x 128 x 32 flops) takes about this long on an
# H100 at 700 W (block column 24 of the N = 16,384 factor: one full wave of
# 384 slices in 0.542 ms, kernel_ab.py); a split must save a tenth of the
# one-pass cost
SPANEL_MIN_SLICES = 8
SPANEL_SLICE_S = 1.4e-6
H100_BYTES_PER_S = 3.35e12


@functools.lru_cache(maxsize=4096)
def spanel_plan(n, r0, B):
    """K-spanel's split-K plan for block column offset r0: (splits, k_chunk).

    Chunk z covers k in [z·k_chunk, min(r0, (z+1)·k_chunk)), z < splits:
    the chunks cover [0, r0) once, in order, each a whole number of 32-deep
    k slices (k_chunk is a multiple of TF32X3_K_SLICE; only the last chunk
    may end early, at r0). The count minimises the modelled time: waves of
    CTAs on the SMs (m/128 × B/128 output tiles, m = n − r0, times the
    chunks) × (slices a CTA runs + 2 for its fill and epilogue), plus the
    partial slabs' traffic (written once, read once by s_panel_reduce); a
    split is taken only where it saves a tenth of the one-pass time: where
    the tiles cannot fill the SMs (block columns j ≥ 26 at N = 16,384,
    B = 512) or leave most of a last wave empty (j = 12-15 and 19-23).
    Otherwise splits is 1 and k_chunk ≥ r0. r0 = 0 gives (1, 0): no k."""
    return _split_k_plan(n - r0, r0, B)


def _split_k_plan(m, r0, B):
    """spanel_plan's model for an m × B product over k = r0."""
    slices = -(-r0 // TF32X3_K_SLICE)
    if slices == 0:
        return 1, 0
    tiles = -(-m // TF32X3_TILE) * -(-B // TF32X3_TILE)

    def cost(s):
        per = -(-slices // s)
        splits = -(-slices // per)
        c = -(-tiles * splits // H100_SMS) * (per + 2)
        if splits > 1:
            c += 4 * m * B * (2 * splits + 2) / H100_BYTES_PER_S / SPANEL_SLICE_S
        return c, splits, per * TF32X3_K_SLICE

    one = best = cost(1)
    for s in range(2, slices // SPANEL_MIN_SLICES + 1):
        c = cost(s)
        if c[0] < best[0]:
            best = c
    if best[0] > 0.9 * one[0]:
        best = one
    return best[1], best[2]


def s_panel(L, S, j, B, scale=None):
    """Step 1 for block column j, into S's first n − j·B rows. CPU or
    float64: plain twin. float32 CUDA: csrc/blocked_cholesky.cu s_panel_f32
    (3xTF32 tensor cores), with spanel_plan's split-K and, for more than one
    chunk, s_panel_reduce; or raises. For j > 0 the kernel's TMA copies
    need n a multiple of 4 (16-byte rows of L) and L on 16 bytes. scale:
    the factor's range_scale (a CUDA tensor) or None for 1; with it S is
    s·K − (r·L)(r·L)ᵀ, which keeps the tensor cores' sums below max
    diag(s·K) (without it they must stay below ~7.9e28)."""
    if _build.runs_plain(L):
        return s_panel_plain(L, S, j, B)
    _check_shapes("s_panel", L, S, B)
    _build.require_cuda_inputs("s_panel", floats=(L, S))
    n, r0 = L.shape[0], j * B
    if r0 and (n % 4 or L.data_ptr() % 16):
        raise ValueError("s_panel: for j > 0 the TMA copies need n a multiple of 4 (16-byte rows) "
                         "and L on 16 bytes")
    splits, k_chunk = spanel_plan(n, r0, B)
    part = torch.empty((splits, n - r0, B), dtype=L.dtype, device=L.device) if splits > 1 else None
    err = _build.library().s_panel_f32(L.data_ptr(), S.data_ptr(),
                                       None if part is None else part.data_ptr(), n, r0, B,
                                       k_chunk, _scale_ptr(scale), _build.stream_ptr(L))
    _build.check(err, "s_panel_f32")
    s_panel.launches += 1
    if part is not None:
        s_panel_reduce(L, part, S, j, B, scale)


def s_panel_reduce_plain(L, part, S, j, B):
    """S[:m] = L[r0:, r0:r0+B] − Σ_z part[z], the (splits, m, B) partial
    products of K-spanel's k chunks summed in order, z = 0 first."""
    r0 = j * B
    acc = part[0].clone()
    for z in range(1, part.shape[0]):
        acc += part[z]
    torch.sub(L[r0:, r0:r0 + B], acc, out=S[:L.shape[0] - r0])


def s_panel_reduce(L, part, S, j, B, scale=None):
    """K-spanel's second pass where its plan split k. CPU or float64: plain
    twin. float32 CUDA: csrc/blocked_cholesky.cu s_panel_reduce_f32 (the
    same order of sums; K times s of the range scale), or raises."""
    if _build.runs_plain(L):
        return s_panel_reduce_plain(L, part, S, j, B)
    _check_shapes("s_panel_reduce", L, S, B)
    n, r0 = L.shape[0], j * B
    if part.ndim != 3 or part.shape[1:] != (n - r0, B):
        raise ValueError("s_panel_reduce: part must be (splits, n − j·B, B)")
    _build.require_cuda_inputs("s_panel_reduce", floats=(L, part, S))
    err = _build.library().s_panel_reduce_f32(L.data_ptr(), part.data_ptr(), S.data_ptr(), n, r0,
                                              B, part.shape[0], _scale_ptr(scale),
                                              _build.stream_ptr(L))
    _build.check(err, "s_panel_reduce_f32")
    s_panel_reduce.launches += 1


def col_write(L, S, Ljj, inv, j, B, zero_upper=True, scale=None):
    """Step 3 for block column j. CPU or float64: plain twin. float32 CUDA:
    csrc/blocked_cholesky.cu col_write_f32 (3xTF32 tensor cores for the
    rows below), or raises. B must be a multiple of 64 (factor_plan), and
    the TMA copies and float4 stores need L, S, Ljj and inv on 16 bytes.
    scale: the factor's range_scale or None; with it S, Ljj and inv are
    those of s·K and the kernel writes Ljj and S[B:]·invᵀ times 1/r, the
    true factor's rows."""
    if _build.runs_plain(L):
        return col_write_plain(L, S, Ljj, inv, j, B, zero_upper)
    _check_shapes("col_write", L, S, B)
    if inv is None:
        if j * B + B != L.shape[0]:
            raise ValueError("col_write: the panel inverse is needed below the last column")
        inv = Ljj  # no rows below: never read
    if B % 64 or Ljj.shape != (B, B) or inv.shape != (B, B):
        raise ValueError("col_write: Ljj and inv must be (B, B) with B a multiple of 64")
    _build.require_cuda_inputs("col_write", floats=(L, S, Ljj, inv))
    if any(t.data_ptr() % 16 for t in (L, S, Ljj, inv)):
        raise ValueError("col_write: L, S, Ljj and inv must start on 16 bytes (TMA, float4)")
    err = _build.library().col_write_f32(L.data_ptr(), S.data_ptr(), Ljj.data_ptr(),
                                         inv.data_ptr(), L.shape[0], j * B, B,
                                         int(bool(zero_upper)), _scale_ptr(scale),
                                         _build.stream_ptr(L))
    _build.check(err, "col_write_f32")
    col_write.launches += 1


s_panel.launches = 0
s_panel_reduce.launches = 0
col_write.launches = 0


# K-sdiag's plan: a k chunk holds at least this many 32-deep slices
SDIAG_MIN_SLICES = 4
# the blocks the fused kernels take on the card (the JAX package's gate is
# its own tiling's)
FUSED_BLOCKS = (256, 512)


def fused_applicable(L, B):
    """Whether blocked_cholesky(fused_trsm=True) takes the fused column loop
    for this buffer: always for the plain twins; on the card for a block in
    FUSED_BLOCKS (the JAX package's gate is its own tiling's, B a multiple
    of 512). Otherwise the unfused loop."""
    return _build.runs_plain(L) or B in FUSED_BLOCKS


def sdiag_tiles(B):
    """K-sdiag's output tiles in its launch order: the 128 × 128 tiles
    (ti, tj) on and below the diagonal of the B × B block, row by row."""
    t1 = -(-B // TF32X3_TILE)
    return [(ti, tj) for ti in range(t1) for tj in range(ti + 1)]


@functools.lru_cache(maxsize=4096)
def sdiag_plan(r0, B):
    """K-sdiag's split-K plan for block column offset r0 > 0: the number of
    k chunks. Chunk z covers the 32-deep slices [z·S/splits, (z+1)·S/splits)
    of S = ⌈r0/32⌉ (sdiag_chunks): each lower tile's k once, in order. As
    many chunks as fill the 132 SMs with the lower tiles × chunks in one
    wave, each at least SDIAG_MIN_SLICES slices long: 13 × 10 tiles at
    B = 512 from j = 4 on, 44 × 3 at B = 256."""
    slices = -(-r0 // TF32X3_K_SLICE)
    return max(1, min(H100_SMS // len(sdiag_tiles(B)), slices // SDIAG_MIN_SLICES))


def sdiag_chunks(r0, splits):
    """The k range [begin, end) of each of K-sdiag's chunks, as the kernel
    computes them."""
    slices = -(-r0 // TF32X3_K_SLICE)
    return [(z * slices // splits * TF32X3_K_SLICE,
             min(r0, (z + 1) * slices // splits * TF32X3_K_SLICE)) for z in range(splits)]


def s_diag_plain(L, j, B):
    """S_jj = L[r0:r0+B, r0:r0+B] − C·Cᵀ with C = L[r0:r0+B, :r0], where the
    diagonal block still holds K; a new (B, B) tensor."""
    r0 = j * B
    C = L[r0:r0 + B, :r0]
    return L[r0:r0 + B, r0:r0 + B] - C @ C.T


def below_trsm_plain(L, inv, j, B, Ljj=None, zero_upper=True, scale=None):
    """L[r0+B:, r0:r0+B] = (K_below − L[r0+B:, :r0]·Cᵀ)·invᵀ in place, with
    K_below the rows below the diagonal block of column j (still K) and
    inv = Ljj⁻¹; then, with Ljj, the commit col_commit_plain(L, Ljj, j, B,
    zero_upper, scale)."""
    r0 = j * B
    C = L[r0:r0 + B, :r0]
    below = L[r0 + B:, r0:r0 + B]
    below.copy_((below - L[r0 + B:, :r0] @ C.T) @ inv.T)
    if Ljj is not None:
        col_commit_plain(L, Ljj, j, B, zero_upper, scale)


@functools.lru_cache(maxsize=4096)
def below_trsm_plan(n, r0, B):
    """K-below-trsm's split-K plan for block column offset r0 > 0:
    (splits, k_chunk), as spanel_plan's (the same cost model and chunks) for
    the m = n − r0 − B rows below the diagonal block."""
    return _split_k_plan(n - r0 - B, r0, B)


def col_commit_plain(L, Ljj, j, B, zero_upper=True, scale=None):
    """L[r0:r0+B, r0:r0+B] = Ljj (times scale[2], the range scale's 1/r,
    where given: exact, a power of two) and, with zero_upper, the strip of
    block row j right of it zeroed."""
    r0 = j * B
    L[r0:r0 + B, r0:r0 + B] = Ljj if scale is None else Ljj * scale[2]
    if zero_upper:
        L[r0:r0 + B, r0 + B:] = 0


def s_diag(L, j, B, scale=None):
    """S_jj for block column j > 0, a new (B, B) symmetric tensor. CPU or
    float64: plain twin. float32 CUDA: csrc/fused_trsm.cu s_diag_f32
    (3xTF32 tensor cores on the lower tiles, sdiag_plan's split-K, the
    strict upper's product the mirror of the lower's), or raises. scale as
    s_panel's: with it S_jj is s·K_jj − (r·C)(r·C)ᵀ."""
    if _build.runs_plain(L):
        return s_diag_plain(L, j, B)
    _check_fused("s_diag", L, j, B)
    _build.require_cuda_inputs("s_diag", floats=(L,))
    if L.shape[0] % 4 or L.data_ptr() % 16:
        raise ValueError("s_diag: the TMA copies need n a multiple of 4 and L on 16 bytes")
    splits = sdiag_plan(j * B, B)
    out = torch.empty((B, B), dtype=L.dtype, device=L.device)
    part = torch.empty((splits, B, B), dtype=L.dtype, device=L.device)
    err = _build.library().s_diag_f32(L.data_ptr(), part.data_ptr(), out.data_ptr(), L.shape[0],
                                      j * B, B, splits, _scale_ptr(scale), _build.stream_ptr(L))
    _build.check(err, "s_diag_f32")
    s_diag.launches += 1
    return out


def below_trsm(L, inv, j, B, scale=None, Ljj=None, zero_upper=True):
    """Finish the rows of block column j below its diagonal block, in place,
    for 0 < j < n/B − 1, and with Ljj commit the diagonal block as
    col_commit(L, Ljj, j, B, zero_upper, scale) does. CPU or float64: plain
    twin. float32 CUDA: csrc/fused_trsm.cu below_trsm_f32 (both products on
    the 3xTF32 tensor cores: A·Cᵀ with below_trsm_plan's split-K and, where
    split, its fixed-order second pass into a scratch strip S, then S·invᵀ
    into column j; the commit in more CTAs of that last launch, counted on
    below_trsm.commits), or raises. The TMA copies need n a multiple of 4
    and L and inv on 16 bytes. scale as col_write's: with the factor's
    range_scale, inv is the inverse of s·K's Ljj and the kernel writes
    (s·K_below − (r·A)(r·C)ᵀ)·invᵀ/r, the true factor's rows."""
    if _build.runs_plain(L):
        return below_trsm_plain(L, inv, j, B, Ljj, zero_upper, scale)
    _check_fused("below_trsm", L, j, B)
    n, r0 = L.shape[0], j * B
    if inv.shape != (B, B) or r0 + B >= n:
        raise ValueError("below_trsm: inv must be (B, B) and column j must have rows below")
    if Ljj is not None and Ljj.shape != (B, B):
        raise ValueError("below_trsm: Ljj must be (B, B)")
    _build.require_cuda_inputs("below_trsm",
                               floats=(L, inv) + (() if Ljj is None else (Ljj,)))
    if n % 4 or L.data_ptr() % 16 or inv.data_ptr() % 16:
        raise ValueError("below_trsm: the TMA copies need n a multiple of 4 and L and inv on "
                         "16 bytes")
    splits, k_chunk = below_trsm_plan(n, r0, B)
    m = n - r0 - B
    S = torch.empty((m, B), dtype=L.dtype, device=L.device)
    part = torch.empty((splits, m, B), dtype=L.dtype, device=L.device) if splits > 1 else None
    err = _build.library().below_trsm_f32(L.data_ptr(), inv.data_ptr(), S.data_ptr(),
                                          None if part is None else part.data_ptr(),
                                          None if Ljj is None else Ljj.data_ptr(), n, r0, B,
                                          k_chunk, int(bool(zero_upper)), _scale_ptr(scale),
                                          _build.stream_ptr(L))
    _build.check(err, "below_trsm_f32")
    below_trsm.launches += 1
    below_trsm.commits += Ljj is not None


def col_commit(L, Ljj, j, B, zero_upper=True, scale=None):
    """Write Ljj (times scale[2] where the factor's range_scale is given)
    into the diagonal block of column j and, with zero_upper, zero the strip
    right of it. CPU or float64: plain twin. float32 CUDA: csrc/fused_trsm.cu
    col_commit_f32, or raises. The fused factor calls it for its last
    column only; the others commit inside K-below-trsm's launch."""
    if _build.runs_plain(L):
        return col_commit_plain(L, Ljj, j, B, zero_upper, scale)
    _check_fused("col_commit", L, j, B)
    if Ljj.shape != (B, B):
        raise ValueError("col_commit: Ljj must be (B, B)")
    _build.require_cuda_inputs("col_commit", floats=(L, Ljj))
    err = _build.library().col_commit_f32(L.data_ptr(), Ljj.data_ptr(), L.shape[0], j * B, B,
                                          int(bool(zero_upper)), _scale_ptr(scale),
                                          _build.stream_ptr(L))
    _build.check(err, "col_commit_f32")
    col_commit.launches += 1


s_diag.launches = 0
below_trsm.launches = 0
below_trsm.commits = 0      # K-commits inside K-below-trsm's launches
col_commit.launches = 0


def _check_shapes(name, L, S, B):
    n = L.shape[0]
    if L.shape != (n, n) or n % B or S.shape != (n, B):
        raise ValueError("%s: L must be (n, n) and S (n, B) with B dividing n" % name)


def _check_fused(name, L, j, B):
    n = L.shape[0]
    if L.shape != (n, n) or n % B or not 0 < j < n // B or B not in FUSED_BLOCKS:
        raise ValueError("%s: L must be (n, n), B one of %s dividing n, and 0 < j < n/B"
                         % (name, FUSED_BLOCKS))


def blocked_cholesky(K, block_size=512, diag_shift=None, zero_upper=True,
                     return_panel_invs=False, fused_trsm=False):
    """Lower Cholesky factor of K + diag(diag_shift), blocked by columns.

    Args:
        K: (n, n) symmetric positive-definite matrix. Overwritten by the
            factor when it is contiguous and the block divides n.
        block_size: panel width B (see factor_plan).
        diag_shift: None, a scalar or an (n,) vector added to the diagonal
            inside the factorization (the noisy Gram is never formed).
        zero_upper: zero the strict upper triangle (L's contract). False
            leaves K's values there, for callers that read only the lower
            triangle. Only the lower triangle and the diagonal blocks of K
            are read, so with zero_upper=False K's strict upper outside the
            diagonal blocks may hold anything (the band-lower Gram,
            ops/block_mosm.mosm_gram_sorted_lower).
        return_panel_invs: also return the inverses of the diagonal blocks.
        fused_trsm: the fused below-TRSM column loop (module docstring) for
            every block column after the first, where fused_applicable
            says so; the same factor up to rounding.

    Returns the (n, n) factor, or with return_panel_invs (L, invs): invs is
    an (n/B, B, B) tensor, one lower inverse per block column in solve order,
    or None when n needed padding. Where a diagonal block is not positive
    definite, that block and every later one come out NaN, as in the JAX
    package (which returns NaN rows instead of raising). Where the kernels
    run, any n and block_size factor (factor_plan pads), and K up to
    FP32's range (range_scale).
    """
    if K.ndim != 2 or K.shape[0] != K.shape[1]:
        raise ValueError("blocked_cholesky expects a square 2-D matrix; got shape %r" % (tuple(K.shape),))
    n = K.shape[0]
    kernels = not _build.runs_plain(K)
    B, npad = factor_plan(n, block_size, kernels)
    nb = npad // B
    shift = None
    if diag_shift is not None:
        shift = torch.as_tensor(diag_shift, dtype=K.dtype, device=K.device)
        if shift.ndim == 1 and shift.shape[0] != n:
            raise ValueError("vector diag_shift must have shape (n,); got %r" % (tuple(shift.shape),))
        shift = shift.expand(n)
    if npad != n:
        L = torch.zeros((npad, npad), dtype=K.dtype, device=K.device)
        L[:n, :n] = K
        L.diagonal()[n:] = 1.0
        if shift is not None:
            shift = torch.cat([shift, shift.new_zeros(npad - n)])
    else:
        L = K if K.is_contiguous() else K.contiguous()
    scale = None
    if kernels:
        d = L.diagonal()
        scale = range_scale(d if shift is None else d + shift)
        if shift is not None:
            shift = shift * scale[0]
    S = torch.empty((npad, B), dtype=K.dtype, device=K.device)
    eye = torch.eye(B, dtype=K.dtype, device=K.device)
    invs = None
    if return_panel_invs and npad == n:
        invs = torch.empty((nb, B, B), dtype=K.dtype, device=K.device)
    failed = torch.zeros((), dtype=torch.bool, device=K.device)
    fused = fused_trsm and fused_applicable(L, B)
    for j in range(nb):
        r0 = j * B
        if fused and j > 0:
            Sjj = s_diag(L, j, B, scale)
        else:
            s_panel(L, S, j, B, scale)
            Sjj = S[:B]
        if shift is not None:
            Sjj = Sjj + torch.diag(shift[r0:r0 + B])
        Ljj, info = torch.linalg.cholesky_ex(Sjj)
        # no host sync: a failed block poisons it and, through the rows
        # below it, every later one
        failed = failed | (info != 0)
        Ljj = torch.where(failed, torch.full_like(Ljj, float("nan")), Ljj).contiguous()
        inv = None
        if j < nb - 1 or invs is not None:
            inv = torch.linalg.solve_triangular(Ljj, eye, upper=False).contiguous()
            if invs is not None:   # Ljj, inv are s·K's: the true inverse is inv·r
                torch.mul(inv, 1.0 if scale is None else scale[1], out=invs[j])
        if fused and j > 0:
            if j < nb - 1:
                below_trsm(L, inv, j, B, scale, Ljj, zero_upper)
            else:
                col_commit(L, Ljj, j, B, zero_upper, scale)
        else:
            col_write(L, S, Ljj, inv, j, B, zero_upper, scale)
    L = L[:n, :n] if npad != n else L
    return (L, invs) if return_panel_invs else L
