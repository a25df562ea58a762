"""Left-looking blocked Cholesky, in place, with the K-spanel, K-colwrite,
K-sdiag, K-below-trsm and K-commit kernels' wrappers and their plain PyTorch
twins.

JAX counterpart: mogptk_tpu/ops/blocked_cholesky.py (`blocked_cholesky`
:642-856, `effective_block` :624-639). Per block column j (r0 = j·B):

1. S = K[r0:, r0:r0+B] − L[r0:, :r0]·L[r0:r0+B, :r0]ᵀ  (`s_panel`; the JAX
   Pallas kernel `_s_panel_pallas`);
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
pass, (K_below − L[r0+B:, :r0]·Cᵀ)·invᵀ written straight into column j
(`below_trsm`, JAX `_below_trsm_pallas` and the below half of
`_col_commit`), so S below the diagonal block never goes to device memory;
then Ljj into the diagonal block and, with zero_upper, the strip zeroed
(`col_commit`, JAX `_col_commit` and `_upper_zero_impl`). Block column 0
takes steps 1-3, as in the JAX package.

The factor is built in the buffer that holds K: K is overwritten. When n is
not a multiple of the block, K is copied into a padded buffer with an
identity tail first, and K itself is left as it was. Every step reads and
writes the same buffer and runs on one stream in order.
"""
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


def s_panel(L, S, j, B):
    """Step 1 for block column j, into S's first n − j·B rows. CPU or
    float64: plain twin. float32 CUDA: csrc/blocked_cholesky.cu s_panel_f32,
    or raises."""
    if _build.runs_plain(L):
        return s_panel_plain(L, S, j, B)
    _check_shapes("s_panel", L, S, B)
    _build.require_cuda_inputs("s_panel", floats=(L, S))
    err = _build.library().s_panel_f32(L.data_ptr(), S.data_ptr(), L.shape[0], j * B, B,
                                       _build.stream_ptr(L))
    _build.check(err, "s_panel_f32")
    s_panel.launches += 1


def col_write(L, S, Ljj, inv, j, B, zero_upper=True):
    """Step 3 for block column j. CPU or float64: plain twin. float32 CUDA:
    csrc/blocked_cholesky.cu col_write_f32, or raises."""
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
    err = _build.library().col_write_f32(L.data_ptr(), S.data_ptr(), Ljj.data_ptr(),
                                         inv.data_ptr(), L.shape[0], j * B, B,
                                         int(bool(zero_upper)), _build.stream_ptr(L))
    _build.check(err, "col_write_f32")
    col_write.launches += 1


s_panel.launches = 0
col_write.launches = 0


# k columns per block of K-sdiag's split sum (its partials are summed in a
# fixed order, so repeats are bit-identical)
SDIAG_K_CHUNK = 512
# the blocks the fused kernels take on the card: K-below-trsm keeps whole
# B-wide rows of the accumulator on chip, 4 or 8 columns a thread
FUSED_BLOCKS = (256, 512)


def fused_applicable(L, B):
    """Whether blocked_cholesky(fused_trsm=True) takes the fused column loop
    for this buffer: always for the plain twins; on the card for a block in
    FUSED_BLOCKS (the JAX package's gate is its own tiling's, B a multiple
    of 512). Otherwise the unfused loop."""
    return _build.runs_plain(L) or B in FUSED_BLOCKS


def s_diag_plain(L, j, B):
    """S_jj = L[r0:r0+B, r0:r0+B] − C·Cᵀ with C = L[r0:r0+B, :r0], where the
    diagonal block still holds K; a new (B, B) tensor."""
    r0 = j * B
    C = L[r0:r0 + B, :r0]
    return L[r0:r0 + B, r0:r0 + B] - C @ C.T


def below_trsm_plain(L, inv, j, B):
    """L[r0+B:, r0:r0+B] = (K_below − L[r0+B:, :r0]·Cᵀ)·invᵀ in place, with
    K_below the rows below the diagonal block of column j (still K) and
    inv = Ljj⁻¹."""
    r0 = j * B
    C = L[r0:r0 + B, :r0]
    below = L[r0 + B:, r0:r0 + B]
    below.copy_((below - L[r0 + B:, :r0] @ C.T) @ inv.T)


def col_commit_plain(L, Ljj, j, B, zero_upper=True):
    """L[r0:r0+B, r0:r0+B] = Ljj and, with zero_upper, the strip of block
    row j right of it zeroed."""
    r0 = j * B
    L[r0:r0 + B, r0:r0 + B] = Ljj
    if zero_upper:
        L[r0:r0 + B, r0 + B:] = 0


def s_diag(L, j, B):
    """S_jj for block column j > 0, a new (B, B) tensor. CPU or float64:
    plain twin. float32 CUDA: csrc/fused_trsm.cu s_diag_f32, or raises."""
    if _build.runs_plain(L):
        return s_diag_plain(L, j, B)
    _check_fused("s_diag", L, j, B)
    _build.require_cuda_inputs("s_diag", floats=(L,))
    splits = -(-j * B // SDIAG_K_CHUNK)
    out = torch.empty((B, B), dtype=L.dtype, device=L.device)
    part = torch.empty((splits, B, B), dtype=L.dtype, device=L.device)
    err = _build.library().s_diag_f32(L.data_ptr(), part.data_ptr(), out.data_ptr(), L.shape[0],
                                      j * B, B, SDIAG_K_CHUNK, _build.stream_ptr(L))
    _build.check(err, "s_diag_f32")
    s_diag.launches += 1
    return out


def below_trsm(L, inv, j, B):
    """Finish the rows of block column j below its diagonal block, in place,
    for 0 < j < n/B − 1. CPU or float64: plain twin. float32 CUDA:
    csrc/fused_trsm.cu below_trsm_f32, or raises."""
    if _build.runs_plain(L):
        return below_trsm_plain(L, inv, j, B)
    _check_fused("below_trsm", L, j, B)
    if inv.shape != (B, B) or (j + 1) * B >= L.shape[0]:
        raise ValueError("below_trsm: inv must be (B, B) and column j must have rows below")
    _build.require_cuda_inputs("below_trsm", floats=(L, inv))
    if L.data_ptr() % 16 or inv.data_ptr() % 16:
        raise ValueError("below_trsm: L and inv must start on 16 bytes (float4 loads)")
    err = _build.library().below_trsm_f32(L.data_ptr(), inv.data_ptr(), L.shape[0], j * B, B,
                                          _build.stream_ptr(L))
    _build.check(err, "below_trsm_f32")
    below_trsm.launches += 1


def col_commit(L, Ljj, j, B, zero_upper=True):
    """Write Ljj into the diagonal block of column j and, with zero_upper,
    zero the strip right of it. CPU or float64: plain twin. float32 CUDA:
    csrc/fused_trsm.cu col_commit_f32, or raises."""
    if _build.runs_plain(L):
        return col_commit_plain(L, Ljj, j, B, zero_upper)
    _check_fused("col_commit", L, j, B)
    if Ljj.shape != (B, B):
        raise ValueError("col_commit: Ljj must be (B, B)")
    _build.require_cuda_inputs("col_commit", floats=(L, Ljj))
    err = _build.library().col_commit_f32(L.data_ptr(), Ljj.data_ptr(), L.shape[0], j * B, B,
                                          int(bool(zero_upper)), _build.stream_ptr(L))
    _build.check(err, "col_commit_f32")
    col_commit.launches += 1


s_diag.launches = 0
below_trsm.launches = 0
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
        block_size: panel width B (see effective_block).
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
    package (which returns NaN rows instead of raising).
    """
    if K.ndim != 2 or K.shape[0] != K.shape[1]:
        raise ValueError("blocked_cholesky expects a square 2-D matrix; got shape %r" % (tuple(K.shape),))
    n = K.shape[0]
    B = effective_block(n, block_size)
    nb = -(-n // B)
    npad = nb * B
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
            Sjj = s_diag(L, j, B)
        else:
            s_panel(L, S, j, B)
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
            if invs is not None:
                invs[j] = inv
        if fused and j > 0:
            if j < nb - 1:
                below_trsm(L, inv, j, B)
            col_commit(L, Ljj, j, B, zero_upper)
        else:
            col_write(L, S, Ljj, inv, j, B, zero_upper)
    L = L[:n, :n] if npad != n else L
    return (L, invs) if return_panel_invs else L
