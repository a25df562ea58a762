// Channel-pair and input cotangents of the MOSM Gram for a dense cotangent
// g (N, M), for Hopper (sm_90a), float32: K-gram-bwd, the backward of
// csrc/mosm_gram.cu.
//
// Replaces two Pallas kernels of the JAX package:
//   mogptk_tpu/ops/block_mosm.py  _gram_block_bwd (pallas_call at :345),
//     one channel-pair block of the sorted Gram per launch, 256^2 tiles
//     accumulated over the TPU's sequential grid;
//   mogptk_tpu/ops/pallas_mosm.py _mosm_gram_bwd (pallas_call at :274), the
//     backward for arbitrary channel IDs, whose _bwd_kernel (:103-160) also
//     emits dx1 and per-row-tile slabs of dx2 under input_grads (trained
//     inducing points).
// The parameter half reduces g to the 3QD + 2Q scalars [dV, dM, dtheta] x
// (q, d), then [dalpha, dphi] x q, of each channel pair's statistics:
//   dst[a, b] = sum over (i, j) with (c1[i], c2[j]) = (a, b) of g_ij dK_ij/dst[a, b];
// autograd chains them through ops/block_mosm.mosm_pair_stats. The input
// half (inputs != 0) reduces the same per-element cotangent of tau_qd,
//   dx1[i, d] = sum_j sum_q g_ij dK_ij/dtau_qd,   dx2[j, d] = -sum_i sum_q (the same),
// a row and a column reduction.
//
// Layout: the host lays rows and columns out channel by channel, each
// channel padded to a multiple of T = 256 (ops/mosm_gram._gram_layout), and
// passes rmap (Np,) and cmap (Mp,): the row (column) of g and x1 (x2) at each
// laid-out position, -1 for padding. A tile then belongs to one channel pair,
// and the work list names every tile of every present pair, grouped by pair.
// For channel-sorted data with channels that are multiples of 256 (the bench
// model) the maps are the identity and g is read in place; for unsorted data
// they gather, and no permuted copy of g is made. Padded positions carry
// g = 0, contribute nothing and are written nowhere.
//
// Bound: the read of g, N*M*4 bytes (1.07 GB at N = 16,384; 67 MB for the
// sparse models' Kuf at M = 1,024, N = 16,384), against Q expf and Q sincosf
// with ~20 FMAs per element. Design: K-lowrank-vjp's (same tau chain and
// reductions, mosm_pair_vjp.cuh) with g loaded from memory instead of formed
// as A_i B_j^T: a block takes a 128 x 128 quarter of a tile, 256 threads of
// 8 x 8 elements, rows ty + 16u and columns tx + 16v, so 16 neighbouring
// threads read 16 neighbouring columns of a row. Each thread first loads its
// 64 values of g (64 loads in flight), then runs the chain. Each block
// writes its partial sums; a second kernel sums each pair's partials in a
// fixed order in float64. The input half keeps per-thread sums of d tau per
// row and per column in registers, sums them over the block in a fixed order
// (shuffles, then the warps in order) into per-block 128 x D row and column
// slabs, and two more small kernels sum each laid-out row over the tiles of
// its row and each column over the tiles of its column, in a fixed order in
// float64, and scatter to the caller's rows. The input half is a template
// flag, so the parameter-only instance is the same code as before it; its
// instances are compiled from csrc/mosm_gram_bwd_inputs.cu, beside this
// file's, in parallel (csrc/mosm_gram_bwd.cuh holds the shared tile kernel).
// No atomics anywhere: deterministic.
//
// Two instances (ops/mosm_gram.kernel_instance chooses): unrolled over Q and
// D for Q <= 4, D <= 2, and a generic one for any Q and D
// (mosm_pair_vjp.cuh generic_tile: runtime loops, the pair statistics read
// from global memory).
#include "mosm_gram_bwd.cuh"

namespace {

template <bool kInputs>
__global__ void __launch_bounds__(kThreads)
gram_bwd_generic_kernel(const int* __restrict__ idx, const float* __restrict__ g, int64_t M,
                        const float* __restrict__ x1, const int* __restrict__ rmap,
                        const float* __restrict__ x2, const int* __restrict__ cmap,
                        const float* __restrict__ stats, float* __restrict__ partial, int Q,
                        int D, float* __restrict__ rowpart, float* __restrict__ colpart,
                        bool rows, bool cols) {
    const int NOUT = 3 * Q * D + 2 * Q;
    int ri[kMicro], cj[kMicro], pair;
    float gt[kMicro][kMicro];
    load_tile(idx, g, M, rmap, cmap, ri, cj, gt, pair);
    // padded positions (g = 0 there) read row 0: any finite inputs will do
    const float* xr[kMicro];
    const float* xc[kMicro];
#pragma unroll
    for (int u = 0; u < kMicro; ++u) {
        xr[u] = x1 + (int64_t)(ri[u] >= 0 ? ri[u] : 0) * D;
        xc[u] = x2 + (int64_t)(cj[u] >= 0 ? cj[u] : 0) * D;
    }
    generic_tile<kInputs>(gt, xr, xc, stats + (int64_t)pair * NOUT, Q, D,
                          partial + (int64_t)blockIdx.x * NOUT,
                          kInputs ? rowpart + (int64_t)blockIdx.x * kSub * D : nullptr,
                          kInputs ? colpart + (int64_t)blockIdx.x * kSub * D : nullptr, rows,
                          cols);
}

// The input half's second pass: for each laid-out row (cols = 0) or column
// (cols = 1) position p = 128 h + threadIdx.x, the sum of its slab rows over
// every tile of its row (column) of tiles and both halves of each, in order,
// in float64, times sign, scattered to out[map[p]]. tiles (nrt, nct): the
// work-list index of tile (ti, tj).
__global__ void input_reduce_kernel(const float* __restrict__ part, const int* __restrict__ tiles,
                                    int nrt, int nct, const int* __restrict__ map,
                                    float* __restrict__ out, int D, int cols, float sign) {
    const int h = blockIdx.x, r = threadIdx.x;
    const int m = map[(int64_t)h * kSub + r];
    if (m < 0) return;
    const int tile = h / 2, half = h % 2;
    const int n_other = cols ? nrt : nct;
    for (int d = 0; d < D; ++d) {
        double s = 0.0;
        for (int o = 0; o < n_other; ++o) {
            const int st = cols ? tiles[o * nct + tile] : tiles[tile * nct + o];
            for (int k = 0; k < 2; ++k) {
                const int quarter = cols ? 2 * k + half : 2 * half + k;
                s += (double)part[((int64_t)(4 * st + quarter) * kSub + r) * D + d];
            }
        }
        out[(int64_t)m * D + d] = (float)(sign * s);
    }
}

}  // namespace

// idx (S, 3) int32 tiles [ti, tj, pair]; g (N, M) row-major; x1 (N, D),
// rmap (Np,) int32, x2 (M, D), cmap (Mp,) int32, Np and Mp multiples of 256;
// stats (O*O, 3QD+2Q); partial (4S, 3QD+2Q) scratch; pairs (P, 3) int32;
// out (O*O, 3QD+2Q), rows of absent pairs left as given. generic: 0 for the
// unrolled instance (Q <= 4, D <= 2), 1 for the generic one. inputs: bit 0
// asks for dx1 (N, D), bit 1 for dx2 (M, D), with rowpart and colpart
// (4S, 128, D) scratch and tiles (nrt, nct) int32, the work-list index of
// each tile (every pair of present row and column channels is in the list).
extern "C" int mosm_gram_bwd_f32(const int* idx, const float* g, const float* x1,
                                 const int* rmap, const float* x2, const int* cmap,
                                 const float* stats, float* partial, const int* pairs,
                                 float* out, int S, int P, int64_t M, int Q, int D, int generic,
                                 int inputs, float* rowpart, float* colpart, const int* tiles,
                                 int nrt, int nct, float* dx1, float* dx2,
                                 cudaStream_t stream) {
    if (S == 0) return 0;
    const bool rows = inputs & 1, cols = inputs & 2, any = rows || cols;
    const unsigned blocks = (unsigned)(4 * S);
    bool launched = false;
    if (generic) {
        if (Q < 1 || D < 1) return (int)cudaErrorInvalidValue;
        if (any)
            gram_bwd_generic_kernel<true><<<blocks, kThreads, 0, stream>>>(
                idx, g, M, x1, rmap, x2, cmap, stats, partial, Q, D, rowpart, colpart, rows, cols);
        else
            gram_bwd_generic_kernel<false><<<blocks, kThreads, 0, stream>>>(
                idx, g, M, x1, rmap, x2, cmap, stats, partial, Q, D, rowpart, colpart, rows, cols);
        launched = true;
    } else if (any) {
        const int e = launch_gram_bwd_inputs_unrolled(Q, D, blocks, idx, g, M, x1, rmap, x2, cmap,
                                                      stats, partial, rowpart, colpart, rows,
                                                      cols, stream);
        if (e == (int)cudaErrorInvalidValue) return e;
        launched = true;
    }
#define MOGPTK_BWD_CASE(q, d)                                                                \
    else if (Q == q && D == d) {                                                             \
        gram_bwd_kernel<q, d, false><<<blocks, kThreads, 0, stream>>>(                       \
            idx, g, M, x1, rmap, x2, cmap, stats, partial, rowpart, colpart, rows, cols);    \
        launched = true;                                                                     \
    }
    MOGPTK_BWD_CASE(1, 1) MOGPTK_BWD_CASE(2, 1) MOGPTK_BWD_CASE(3, 1) MOGPTK_BWD_CASE(4, 1)
    MOGPTK_BWD_CASE(1, 2) MOGPTK_BWD_CASE(2, 2) MOGPTK_BWD_CASE(3, 2) MOGPTK_BWD_CASE(4, 2)
#undef MOGPTK_BWD_CASE
    if (!launched) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    pair_reduce_kernel<<<(unsigned)P, 32, 0, stream>>>(partial, pairs, out, 3 * Q * D + 2 * Q);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    if (rows) {
        input_reduce_kernel<<<(unsigned)(2 * nrt), kSub, 0, stream>>>(rowpart, tiles, nrt, nct,
                                                                      rmap, dx1, D, 0, 1.0f);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    if (cols) {
        input_reduce_kernel<<<(unsigned)(2 * nct), kSub, 0, stream>>>(colpart, tiles, nrt, nct,
                                                                      cmap, dx2, D, 1, -1.0f);
        err = cudaGetLastError();
    }
    return (int)err;
}
