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
computes it for any channel order.

K-gram-matvec: K-gram's element on 128² tiles, the products on the tensor
cores in 3xTF32, the column axis split over CTAs so that the grid fills the
card at every N (`gram_matvec_plan`, from the card's SM count); each split
writes its partial sums to a slab and a second pass
(`mosm_gram_matvec_reduce`) adds the slabs in split order, or, with one
split, the first pass writes the product itself.

K-matvec, the square case (the iterative engine, gpr/iterative.py, passes
channel-sorted rows), is the fold (csrc/matvec_fold.cuh, which K-fam-matvec
shares, with `fold_matvec` and this module's plan and second pass): each
128 × 128 tile of the upper triangle of the tile grid evaluated once and
used for both K·V and Kᵀ·V, the products on the tensor cores in 3xTF32, the
transposed contributions summed through partial slabs by a fixed-order
second pass (`mosm_matvec_reduce`, K-matvec-reduce). The folded operator is
exactly symmetric, as the JAX D1's is.

On a CPU tensor the wrappers run the plain twins; on a CUDA tensor they
launch the kernels (float32) or raise. No atomics: repeats are
bit-identical.
"""
import functools

import numpy as np
import torch

from . import _build
from .mosm_gram import mosm_gram_pairstats_plain, stats_table, check_gram_inputs, generic_flag

PLAIN_ROWS = 2048    # rows of the Gram the plain twins form at a time
MAX_R = 2048         # columns of V one K-gram-matvec launch takes
GRAM_MATVEC_TILE = 128      # K-gram-matvec's row and column tile edge
GRAM_MATVEC_WAVES = 4       # the split aims for this many times the CTAs the card holds at once
GRAM_MATVEC_SLAB_BYTES = 1 << 30   # the partial slabs one K-gram-matvec launch may fill
FOLD_TILE = 128      # K-matvec's tile edge
FOLD_SUPER = 4       # tiles per super-block of a work item
FOLD_MAX_NB = 5      # n-blocks of 8 columns of V a K-matvec CTA takes
FOLD_SLAB_BYTES = 4 << 30   # the partial slabs one K-matvec launch may fill


def mosm_matvec_plain(x, c, st3, st2, V):
    """Plain twin of K-matvec: mosm_gram_matvec_plain with x2 = x1."""
    return mosm_gram_matvec_plain(x, c, x, c, st3, st2, V)


def fold_tiles(N):
    """(ntiles, nsupers): K-matvec's 128-row tiles of N rows and its
    super-blocks of four tiles."""
    ntiles = -(-N // FOLD_TILE)
    return ntiles, -(-ntiles // FOLD_SUPER)


def fold_slot_count(t, nsupers):
    """The partial slab slots of row tile t: t for the transposed products
    of row tiles 0..t-1, then one for each super-block t/4..nsupers-1."""
    return t + nsupers - t // FOLD_SUPER


def fold_slab_base(t, nsupers):
    """The first slot of row tile t (the sum of the counts before it), in
    the closed form csrc/mosm_matvec.cu fold_slab_base computes."""
    q, rem = divmod(t, FOLD_SUPER)
    return t * (t - 1) // 2 + t * nsupers - (2 * q * (q - 1) + rem * q)


def fold_item_tiles(i, J, ntiles):
    """The column tiles work item (row tile i, super-block J) evaluates:
    J's tiles from i on."""
    return range(max(FOLD_SUPER * J, i), min(FOLD_SUPER * J + FOLD_SUPER, ntiles))


def fold_row_slot(i, J, nsupers):
    """The slot item (i, J) writes its G·V[J] rows into (row tile i's)."""
    return fold_slab_base(i, nsupers) + i + (J - i // FOLD_SUPER)


def fold_col_slot(j, i, nsupers):
    """The slot item (i, ·) writes Gᵀ·V[i] into for column tile j > i."""
    return fold_slab_base(j, nsupers) + i


@functools.lru_cache(maxsize=64)
def fold_items(N):
    """K-matvec's work items, (n_items, 2) int32: (row tile i, super-block
    J) for every J from i's own on, so the tile pairs (i, j ≥ i) of the
    upper triangle are each evaluated once. The items with four column
    tiles first and the diagonal super-block's shorter ones last, so these
    fill the tail of the last wave."""
    ntiles, nsupers = fold_tiles(N)
    full = [(i, J) for i in range(ntiles) for J in range(i // FOLD_SUPER + 1, nsupers)]
    diag = [(i, i // FOLD_SUPER) for i in range(ntiles)]
    return np.asarray(full + diag, dtype=np.int32).reshape(-1, 2)


_fold_items_on = {}


def fold_items_on(N, device):
    """fold_items(N) on `device`, made once per (N, device)."""
    key = (N, str(device))
    if key not in _fold_items_on:
        _fold_items_on[key] = torch.as_tensor(fold_items(N), device=device).contiguous()
    return _fold_items_on[key]


def fold_group(N, R):
    """(nb, columns): K-matvec's n-blocks of 8 columns a CTA takes and the
    columns of V one launch takes, so its partial slabs stay within
    FOLD_SLAB_BYTES (every R up to 3,000 at N = 16,384, up to ~200 at
    65,536)."""
    ntiles, nsupers = fold_tiles(N)
    nb = min(FOLD_MAX_NB, -(-R // 8))
    per_col = 4 * FOLD_TILE * fold_slab_base(ntiles, nsupers)
    cols = max(8 * nb, FOLD_SLAB_BYTES // per_col // (8 * nb) * (8 * nb))
    return nb, min(R, cols)


def fold_partials(x, c, st3, st2, V):
    """K-matvec's first pass on the card: the (slots·128, R) partial slabs
    of K(x, x)·V, one launch of csrc/mosm_matvec.cu mosm_matvec_fold_f32
    (counted on mosm_matvec), R within one fold_group. Raises on what the
    kernel does not take."""
    O, _, Q, D, _ = st3.shape
    N = x.shape[0]
    stats = stats_table(st3, st2)
    check_gram_inputs("mosm_matvec", x, c, x, c, stats, D)
    _build.require_cuda_inputs("mosm_matvec", floats=(V,))
    if V.dim() != 2 or V.shape[0] != N or V.shape[1] < 1:
        raise ValueError("mosm_matvec: V must be (N, R) with N = %d rows and R >= 1" % N)
    R = V.shape[1]
    nb, cols = fold_group(N, R)
    if cols < R:
        raise ValueError("mosm_matvec: R = %d exceeds one launch's %d columns" % (R, cols))
    ntiles, nsupers = fold_tiles(N)
    part = torch.empty((fold_slab_base(ntiles, nsupers) * FOLD_TILE, R), dtype=torch.float32,
                       device=x.device)
    items = fold_items_on(N, x.device)
    err = _build.library().mosm_matvec_fold_f32(
        x.data_ptr(), c.data_ptr(), stats.data_ptr(), V.data_ptr(), items.data_ptr(),
        items.shape[0], part.data_ptr(), N, R, nb, O, Q, D, generic_flag("forward", st3),
        _build.stream_ptr(x))
    _build.check(err, "mosm_matvec_fold_f32")
    mosm_matvec.launches += 1
    return part


def fold_partials_plain_of(gram, V):
    """The fold's first pass in plain torch for any symmetric Gram: the
    partial slabs the kernels fill, from gram(ri, rj), the plain Gram of the
    rows ri against the rows rj (two slices), for each tile pair (i, j ≥ i)
    of fold_items: G·V[j] summed over the item's tiles into slot
    fold_row_slot(i, J) and Gᵀ·V[i] into slot fold_col_slot(j, i); rows past
    N stay NaN."""
    N, R = V.shape
    T = FOLD_TILE
    ntiles, nsupers = fold_tiles(N)
    part = V.new_full((fold_slab_base(ntiles, nsupers) * T, R), float("nan"))
    for i, J in fold_items(N).tolist():
        ri = slice(i * T, min(N, (i + 1) * T))
        acc = V.new_zeros((ri.stop - ri.start, R))
        for j in fold_item_tiles(i, J, ntiles):
            rj = slice(j * T, min(N, (j + 1) * T))
            G = gram(ri, rj)
            acc += G @ V[rj]
            if j != i:
                s = fold_col_slot(j, i, nsupers) * T
                part[s:s + rj.stop - rj.start] = G.T @ V[ri]
        s = fold_row_slot(i, J, nsupers) * T
        part[s:s + ri.stop - ri.start] = acc
    return part


def fold_partials_plain(x, c, st3, st2, V):
    """Plain twin of K-matvec's first pass (fold_partials_plain_of with the
    MOSM Gram of the pair statistics)."""
    return fold_partials_plain_of(
        lambda ri, rj: mosm_gram_pairstats_plain(x[ri], c[ri], x[rj], c[rj], st3, st2), V)


def mosm_matvec_reduce_plain(part, N):
    """Plain twin of the fold's second pass (K-matvec's and K-fam-matvec's): each row the sum of its row
    tile's slots in slot order (slot 0 first), from part
    (slots·128, R)."""
    ntiles, nsupers = fold_tiles(N)
    R = part.shape[1]
    P = part.view(-1, FOLD_TILE, R)
    counts = [fold_slot_count(t, nsupers) for t in range(ntiles)]
    bases = torch.tensor([fold_slab_base(t, nsupers) for t in range(ntiles)], device=part.device)
    out = P[bases].clone()
    for k in range(1, max(counts)):
        t0 = next(t for t in range(ntiles) if counts[t] > k)   # counts grow with t
        out[t0:] += P[bases[t0:] + k]
    return out.reshape(-1, R)[:N]


def mosm_matvec_reduce(part, N):
    """The fold's second pass, K-matvec-reduce: (N, R) from the partial
    slabs of fold_partials or block_families.family_fold_partials. CPU or float64: the plain twin. float32 CUDA:
    csrc/mosm_matvec.cu mosm_matvec_reduce_f32 (the same order of sums), or
    raises."""
    if _build.runs_plain(part):
        return mosm_matvec_reduce_plain(part, N)
    ntiles, nsupers = fold_tiles(N)
    R = part.shape[1] if part.dim() == 2 else 0
    if part.shape != (fold_slab_base(ntiles, nsupers) * FOLD_TILE, R) or R < 1:
        raise ValueError("mosm_matvec_reduce: part must be (slots·128, R) for N = %d" % N)
    _build.require_cuda_inputs("mosm_matvec_reduce", floats=(part,))
    out = torch.empty((N, R), dtype=torch.float32, device=part.device)
    err = _build.library().mosm_matvec_reduce_f32(part.data_ptr(), out.data_ptr(), N, R,
                                                  _build.stream_ptr(part))
    _build.check(err, "mosm_matvec_reduce_f32")
    mosm_matvec_reduce.launches += 1
    return out


def mosm_matvec(x, c, st3, st2, V):
    """K(x, x)·V for the MOSM Gram of the pair statistics (st3, st2), with
    x (N, D), channel IDs c (N,) int32 and V (N, R). Not differentiable: the
    iterative engine calls it inside the forward of its autograd Function.
    CPU or float64: the plain twin. float32 CUDA, contiguous: per
    fold_group of columns of V one K-matvec launch (fold_partials) and one
    K-matvec-reduce launch, or raises. (The fold beats the FFMA kernel at
    every R measured, R = 1 included: PERF.md §6.)"""
    if _build.runs_plain(x):
        return mosm_matvec_plain(x, c, st3, st2, V)
    return fold_matvec(lambda Vg: fold_partials(x, c, st3, st2, Vg), x.shape[0], V)


def fold_matvec(first_pass, N, V):
    """K(x, x)·V on the card through the fold: per fold_group of columns of
    V, first_pass(V's columns, contiguous) gives the partial slabs (one
    K-matvec or K-fam-matvec launch) and mosm_matvec_reduce sums them."""
    R = V.shape[1] if V.dim() == 2 else 0
    _, cols = fold_group(N, max(R, 1))
    if cols >= R:
        return mosm_matvec_reduce(first_pass(V), N)
    out = torch.empty((N, R), dtype=torch.float32, device=V.device)
    for r0 in range(0, R, cols):
        r1 = min(R, r0 + cols)
        out[:, r0:r1] = mosm_matvec_reduce(first_pass(V[:, r0:r1].contiguous()), N)
    return out


mosm_matvec.launches = 0
mosm_matvec_reduce.launches = 0


# -- K-gram-matvec (TPU kernel E3a) -----------------------------------------------

def gram_matvec_plan(N, M, R, sms):
    """K-gram-matvec's launch plan for K(x1, x2)·V with N ≥ 1 rows, M ≥ 1
    columns and 1 ≤ R ≤ MAX_R columns of V on a card of `sms` SMs: (nb,
    splits, tps).

    nb: n-blocks of 8 columns of V a CTA takes, 1 (R ≤ 8), 5 (R ≤ 40) or 16
    (chunks of 128: the element is evaluated once per chunk, R/128 times in
    all). A CTA takes a row tile of 128 rows, one chunk and a split: tps
    consecutive column tiles of 128 points; there are splits =
    ceil(ceil(M/128) / tps) of them. Enough splits that the grid holds
    GRAM_MATVEC_WAVES times the CTAs the card runs at once (two an SM at
    nb ≤ 5, one at 16), no more than there are column tiles, and at most as
    many (splits, N, R) float32 slabs as GRAM_MATVEC_SLAB_BYTES holds."""
    T = GRAM_MATVEC_TILE
    nb = 1 if R <= 8 else 5 if R <= 40 else 16
    per_sm = 2 if nb <= 5 else 1
    nrt, nct = -(-N // T), -(-M // T)
    chunks = -(-R // (8 * nb))
    want = -(-GRAM_MATVEC_WAVES * sms * per_sm // (nrt * chunks))
    cap = max(1, GRAM_MATVEC_SLAB_BYTES // (4 * N * R))
    tps = -(-nct // min(want, nct, cap))
    return nb, -(-nct // tps), tps


def gram_matvec_split_tiles(M, tps, s):
    """The column tiles of 128 points that split s of K-gram-matvec takes."""
    nct = -(-M // GRAM_MATVEC_TILE)
    return range(s * tps, min(nct, (s + 1) * tps))


@functools.lru_cache(maxsize=8)
def sm_count(device):
    """The SM count of a CUDA device, read once."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def mosm_gram_matvec_plain(x1, c1, x2, c2, st3, st2, V):
    """Plain twin of K-gram-matvec: K(x1, x2)·V from Gram row blocks of at
    most 2,048 rows (mosm_gram_pairstats_plain), one matmul each."""
    N = x1.shape[0]
    out = V.new_empty((N, V.shape[1]))
    for r0 in range(0, N, PLAIN_ROWS):
        r1 = min(N, r0 + PLAIN_ROWS)
        out[r0:r1] = mosm_gram_pairstats_plain(x1[r0:r1], c1[r0:r1], x2, c2, st3, st2) @ V
    return out


def mosm_gram_matvec_partials_plain(x1, c1, x2, c2, st3, st2, V, tps):
    """Plain twin of K-gram-matvec's first pass: the (splits, N, R) slabs,
    slab s = K(x1, x2[s's columns])·V[s's rows] over the column tiles
    gram_matvec_split_tiles(M, tps, s)."""
    M, T = x2.shape[0], GRAM_MATVEC_TILE
    splits = -(-(-(-M // T)) // tps)
    slabs = []
    for s in range(splits):
        tiles = gram_matvec_split_tiles(M, tps, s)
        cols = slice(tiles.start * T, min(M, tiles.stop * T))
        slabs.append(mosm_gram_matvec_plain(x1, c1, x2[cols], c2[cols], st3, st2, V[cols]))
    return torch.stack(slabs)


def mosm_gram_matvec_reduce_plain(part):
    """Plain twin of K-gram-matvec's second pass: the sum of the slabs of
    part (splits, N, R) in split order, slab 0 first."""
    out = part[0].clone()
    for s in range(1, part.shape[0]):
        out += part[s]
    return out


def mosm_gram_matvec_partials(x1, c1, x2, c2, st3, st2, V, stats=None):
    """K-gram-matvec's first pass on the card: one launch of
    csrc/mosm_matvec.cu mosm_gram_matvec_f32 (counted on
    mosm_gram_matvec_pairstats) into the (splits, N, R) slabs of
    gram_matvec_plan, N ≥ 1, M ≥ 1, 1 ≤ R ≤ MAX_R; stats: stats_table(st3,
    st2) where the caller has it. Returns (part, plan); with one split
    part[0] is K(x1, x2)·V. Raises on what the kernel does not take."""
    O, _, Q, D, _ = st3.shape
    N, M, R = x1.shape[0], x2.shape[0], V.shape[1]
    if stats is None:
        stats = stats_table(st3, st2)
        check_gram_inputs("mosm_gram_matvec", x1, c1, x2, c2, stats, D)
        _build.require_cuda_inputs("mosm_gram_matvec", floats=(V,))
    if V.shape != (M, R) or not (N >= 1 and M >= 1 and 1 <= R <= MAX_R):
        raise ValueError("mosm_gram_matvec: N, M >= 1 and V (M, R) with 1 <= R <= %d" % MAX_R)
    plan = gram_matvec_plan(N, M, R, sm_count(x1.device))
    nb, splits, tps = plan
    part = torch.empty((splits, N, R), dtype=torch.float32, device=x1.device)
    err = _build.library().mosm_gram_matvec_f32(
        x1.data_ptr(), c1.data_ptr(), x2.data_ptr(), c2.data_ptr(), stats.data_ptr(),
        V.data_ptr(), part.data_ptr(), N, M, R, O, Q, D, nb, tps,
        generic_flag("gram_matvec", st3), _build.stream_ptr(x1))
    _build.check(err, "mosm_gram_matvec_f32")
    mosm_gram_matvec_pairstats.launches += 1
    return part, plan


def mosm_gram_matvec_reduce(part):
    """K-gram-matvec's second pass, (N, R) from its (splits, N, R) slabs.
    CPU or float64: the plain twin. float32 CUDA: csrc/mosm_matvec.cu
    mosm_gram_matvec_reduce_f32 (the same sums in the same order), or
    raises."""
    if _build.runs_plain(part):
        return mosm_gram_matvec_reduce_plain(part)
    if part.dim() != 3 or min(part.shape) < 1:
        raise ValueError("mosm_gram_matvec_reduce: part must be (splits, N, R)")
    _build.require_cuda_inputs("mosm_gram_matvec_reduce", floats=(part,))
    splits, N, R = part.shape
    out = torch.empty((N, R), dtype=torch.float32, device=part.device)
    err = _build.library().mosm_gram_matvec_reduce_f32(part.data_ptr(), out.data_ptr(), N, R,
                                                       splits, _build.stream_ptr(part))
    _build.check(err, "mosm_gram_matvec_reduce_f32")
    mosm_gram_matvec_reduce.launches += 1
    return out


def mosm_gram_matvec_pairstats(x1, c1, x2, c2, st3, st2, V):
    """K(x1, x2)·V for the MOSM Gram of the pair statistics (st3, st2), with
    x1 (N, D), channel IDs c1 (N,) int32, x2 (M, D), c2 (M,) int32, in any
    channel order, and V (M, R). Not differentiable. CPU or float64: the
    plain twin. float32 CUDA, contiguous: per MAX_R columns of V one
    K-gram-matvec launch (mosm_gram_matvec_partials) and, where its plan
    splits the columns of K, one launch of its second pass
    (mosm_gram_matvec_reduce); or raises."""
    if _build.runs_plain(x1):
        return mosm_gram_matvec_plain(x1, c1, x2, c2, st3, st2, V)
    D = st3.shape[3]
    N, M = x1.shape[0], x2.shape[0]
    stats = stats_table(st3, st2)
    check_gram_inputs("mosm_gram_matvec", x1, c1, x2, c2, stats, D)
    _build.require_cuda_inputs("mosm_gram_matvec", floats=(V,))
    if V.dim() != 2 or V.shape[0] != M or V.shape[1] < 1:
        raise ValueError("mosm_gram_matvec: V must be (M, R) with M = %d rows and R >= 1" % M)
    R = V.shape[1]
    if N == 0 or M == 0:
        return torch.zeros((N, R), dtype=torch.float32, device=x1.device)

    def group(Vg):
        part, (_, splits, _) = mosm_gram_matvec_partials(x1, c1, x2, c2, st3, st2, Vg, stats)
        return part[0] if splits == 1 else mosm_gram_matvec_reduce(part)

    if R <= MAX_R:
        return group(V)
    out = torch.empty((N, R), dtype=torch.float32, device=x1.device)
    for r0 in range(0, R, MAX_R):
        r1 = min(R, r0 + MAX_R)
        out[:, r0:r1] = group(V[:, r0:r1].contiguous())
    return out


mosm_gram_matvec_pairstats.launches = 0
mosm_gram_matvec_reduce.launches = 0
