// K-gram-lowrank-vjp: channel-pair cotangents of the MOSM Gram K(x1, x2) for
// a low-rank cotangent dK = A B^T, for Hopper (sm_90a), float32, without
// forming dK. Any channel order, x1 (N, D) and x2 (M, D) apart.
//
// Replaces mogptk_tpu/ops/pallas_mosm.py mosm_gram_lowrank_vjp (pallas_call
// at :431, body _lowrank_vjp_kernel :369), which formed each 256^2 tile of
// A B^T in VMEM, ran jax.vjp of the tile's forward inside it, and carried
// the five parameter cotangents across its sequential grid. Here the
// reduction goes to the 3QD + 2Q scalars [dV, dM, dtheta] x (q, d), then
// [dalpha, dphi] x q, of each channel pair's statistics (the hand-derived
// backward of the tau chain, mosm_pair_vjp.cuh, as K-gram-bwd and
// K-lowrank-vjp); autograd chains them through ops/block_mosm.mosm_pair_stats
// to the parameters.
//
// Layout: K-gram-bwd's (csrc/mosm_gram_bwd.cu). The host lays the rows out
// channel by channel, each channel padded to a multiple of T = 256
// (ops/mosm_gram._gram_layout), and passes rmap (Np,) and cmap (Mp,): the row
// of x1 and A (of x2 and B) at each laid-out position, -1 for padding. A tile
// then belongs to one channel pair, and the work list names every tile of
// every present (row channel, column channel) pair, grouped by pair. There
// is no fold: K-lowrank-vjp folds each transposed tile into its mirror,
// which is right only for x1 = x2 and a symmetrised cotangent; here every
// tile of the N x M Gram is its own.
//
// Bound: operations. Per element 2R multiply-adds for g and, per component,
// one exp and one sin/cos with ~20 FP32 operations; the inputs are
// (N + M)(R + D) floats, read from L2 after the first touch.
//
// Design: K-lowrank-vjp's (csrc/lowrank_vjp.cuh, its cross mode). A block
// of 8 warps takes a 128 x 128 quarter of a tile; g = A_i B_j^T (k = R) is one
// 3xTF32 mma.sync product whose accumulator fragments are the thread's 8 x 8
// elements, R in chunks of lowrank_chunk(R) columns padded to lowrank_kpad.
// The maps are applied in the staging loads (the quarter's 128 row and 128
// column positions read once into shared memory, each staged row of A and B
// gathered through them, padding staged as zero rows, so its g is 0): no
// channel-padded copies of x1, x2, A and B, which would cost the wrapper
// (N + M)(R + D) floats of gathers and four launches a call. The fragments
// go from registers into the MOSM tau chain four elements at a time
// (MosmChain: add_pair_cotangents4, the hardware's exp and sin/cos after an
// exact reduction by whole turns, mosm_pair_vjp.cuh), the inputs of padded
// positions 0. Each block writes its 3QD + 2Q partial sums (a fixed-order
// warp and block reduction), and pair_reduce_wide_kernel sums each pair's
// partials in a fixed order in float64, 256 threads a pair. No atomics: a
// repeated call is bit-identical.
//
// Two instances (ops/mosm_gram.kernel_instance chooses): unrolled over Q and
// D for Q <= 4, D <= 2, and a generic one for any Q and D
// (mosm_pair_vjp.cuh generic_tile, on the library's expf and sincosf).
#include "lowrank_vjp.cuh"

namespace {

// The quarter's laid-out positions: rows[r] (cols[r]) the point of x1 (x2)
// at row (column) r of this block's quarter, -1 for padding. Every thread
// calls it; the first barrier of lowrank_g follows.
__device__ __forceinline__ void stage_maps(const int* __restrict__ idx,
                                           const int* __restrict__ rmap,
                                           const int* __restrict__ cmap, int* rows, int* cols) {
    const int s = blockIdx.x / 4, quarter = blockIdx.x % 4, t = threadIdx.x;
    const int64_t row0 = (int64_t)idx[3 * s] * kTile + (quarter / 2) * kSub;
    const int64_t col0 = (int64_t)idx[3 * s + 1] * kTile + (quarter % 2) * kSub;
    if (t < kSub)
        rows[t] = rmap[row0 + t];
    else
        cols[t - kSub] = cmap[col0 + t - kSub];
}

template <class E>
__global__ void __launch_bounds__(kThreads, E::kMinBlocks)
gram_lowrank_vjp_kernel(const int* __restrict__ idx, const float* __restrict__ x1,
                        const int* __restrict__ rmap, const float* __restrict__ x2,
                        const int* __restrict__ cmap, const float* __restrict__ A,
                        const float* __restrict__ Bm, const float* __restrict__ stats,
                        float* __restrict__ partial, int R, int RC, int KH) {
    constexpr int NS = E::kSlots, D = E::kD;
    extern __shared__ __align__(16) float ops[];
    __shared__ float st[NS];
    __shared__ float red[kThreads / 32][NS];
    __shared__ int rows[kSub], cols[kSub];
    const int pair = idx[3 * (blockIdx.x / 4) + 2];
    for (int e = threadIdx.x; e < NS; e += kThreads) st[e] = stats[(int64_t)pair * NS + e];
    stage_maps(idx, rmap, cmap, rows, cols);
    float g[4][4][4];
    int64_t row0, col0;
    lowrank_g<true>(idx, A, Bm, rows, cols, R, RC, KH, ops, g, row0, col0);   // syncs first

    // padded positions (g = 0 there) take inputs 0: any finite values will do
    float xi[8][D], xj[8][D];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
        const int i = rows[elem_row(u)], j = cols[elem_col(u)];
#pragma unroll
        for (int d = 0; d < D; ++d) {
            xi[u][d] = i >= 0 ? x1[(int64_t)i * D + d] : 0.0f;
            xj[u][d] = j >= 0 ? x2[(int64_t)j * D + d] : 0.0f;
        }
    }
    lowrank_chain<E>(g, xi, xj, st, red, partial + (int64_t)blockIdx.x * NS);
}

__global__ void __launch_bounds__(kThreads)
gram_lowrank_vjp_generic_kernel(const int* __restrict__ idx, const float* __restrict__ x1,
                                const int* __restrict__ rmap, const float* __restrict__ x2,
                                const int* __restrict__ cmap, const float* __restrict__ A,
                                const float* __restrict__ Bm, const float* __restrict__ stats,
                                float* __restrict__ partial, int R, int RC, int KH, int Q, int D) {
    extern __shared__ __align__(16) float ops[];
    __shared__ int rows[kSub], cols[kSub];
    const int NOUT = 3 * Q * D + 2 * Q;
    stage_maps(idx, rmap, cmap, rows, cols);
    float g[4][4][4];
    int64_t row0, col0;
    lowrank_g<true>(idx, A, Bm, rows, cols, R, RC, KH, ops, g, row0, col0);
    float gt[kMicro][kMicro];
    const float* xr[kMicro];
    const float* xc[kMicro];
#pragma unroll
    for (int u = 0; u < kMicro; ++u) {
        const int i = rows[elem_row(u)], j = cols[elem_col(u)];
        xr[u] = x1 + (int64_t)(i >= 0 ? i : 0) * D;
        xc[u] = x2 + (int64_t)(j >= 0 ? j : 0) * D;
#pragma unroll
        for (int v = 0; v < kMicro; ++v) gt[u][v] = g[u >> 1][v >> 1][2 * (u & 1) + (v & 1)];
    }
    const int pair = idx[3 * (blockIdx.x / 4) + 2];
    generic_tile<false>(gt, xr, xc, stats + (int64_t)pair * NOUT, Q, D,
                        partial + (int64_t)blockIdx.x * NOUT, nullptr, nullptr, false, false);
}

}  // namespace

// idx (S, 3) int32 tiles [ti, tj, pair]; x1 (N, D), rmap (Np,) int32, x2
// (M, D), cmap (Mp,) int32, Np and Mp multiples of 256; A (N, R), B (M, R);
// stats (O*O, 3QD+2Q); partial (4S, 3QD+2Q) scratch; pairs (P, 3) int32;
// out (O*O, 3QD+2Q), rows of absent pairs left as given. RC: the chunk
// width, 1 <= RC <= min(R, 64); KH: RC rounded up to a multiple of 8.
// generic: 0 for the unrolled instance (Q <= 4, D <= 2), 1 for the generic
// one.
extern "C" int mosm_gram_lowrank_vjp_f32(const int* idx, const float* x1, const int* rmap,
                                         const float* x2, const int* cmap, const float* A,
                                         const float* Bm, const float* stats, float* partial,
                                         const int* pairs, float* out, int S, int P, int Q, int D,
                                         int R, int RC, int KH, int generic, cudaStream_t stream) {
    if (!lowrank_plan_ok(R, RC, KH) || Q < 1 || D < 1) return (int)cudaErrorInvalidValue;
    if (S == 0) return 0;
    int err = (int)cudaErrorInvalidValue;
    if (generic)
        err = launch_lowrank<true>(gram_lowrank_vjp_generic_kernel, S, KH, stream, idx, x1, rmap,
                                   x2, cmap, A, Bm, stats, partial, R, RC, KH, Q, D);
#define MOGPTK_VJP_CASE(q, d)                                                                   \
    else if (Q == q && D == d)                                                                  \
        err = launch_lowrank<true>(gram_lowrank_vjp_kernel<MosmChain<q, d>>, S, KH, stream, idx, \
                                   x1, rmap, x2, cmap, A, Bm, stats, partial, R, RC, KH);
    MOGPTK_VJP_CASE(1, 1) MOGPTK_VJP_CASE(2, 1) MOGPTK_VJP_CASE(3, 1) MOGPTK_VJP_CASE(4, 1)
    MOGPTK_VJP_CASE(1, 2) MOGPTK_VJP_CASE(2, 2) MOGPTK_VJP_CASE(3, 2) MOGPTK_VJP_CASE(4, 2)
#undef MOGPTK_VJP_CASE
    if (err != 0) return err;
    pair_reduce_wide_kernel<<<(unsigned)P, 256, 0, stream>>>(partial, pairs, out,
                                                             3 * Q * D + 2 * Q);
    return (int)cudaGetLastError();
}
