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
// is no fold: K-lowrank-vjp (csrc/mosm_lowrank_vjp.cu) folds each transposed
// tile into its mirror, which is right only for x1 = x2 and a symmetrised
// cotangent; here every tile of the N x M Gram is its own.
//
// The g tile: a block takes a 128 x 128 quarter of a tile, 256 threads of
// 8 x 8 elements at rows ty + 16u and columns tx + 16v. It gathers the
// quarter's 128 rows of A and 128 rows of B through the maps into shared
// memory, at most RC <= 64 columns at a time (ops/block_mosm.lowrank_chunk),
// R-major, and accumulates g = A_i B_j^T over the chunks in order in
// registers. Padded positions stage zero rows, so their g is 0 and they add
// nothing. dK never reaches global memory.
//
// Bound: operations. Per element 2R FMAs for g and, per component, one expf
// and one sincosf with ~20 FMAs; the inputs are (N + M)(R + D) floats, read
// from L2 after the first touch. The TPU kernel's carry across its grid
// becomes a second pass: each block writes its NOUT partial sums (a
// fixed-order warp and block reduction), and pair_reduce_kernel sums each
// pair's partials in a fixed order in float64. No atomics: a repeated call
// is bit-identical.
//
// Two instances (ops/mosm_gram.kernel_instance chooses): unrolled over Q and
// D for Q <= 4, D <= 2, and a generic one for any Q and D
// (mosm_pair_vjp.cuh generic_tile).
#include "mosm_pair_vjp.cuh"

namespace {

constexpr int kMaxRC = 64;      // columns of A and B in the slabs at a time
static_assert(kThreads == 2 * kSub, "one thread per laid-out row and column of a quarter");

// g[u][v] = (A_i B_j^T) for the thread's 8 x 8 elements of this block's
// quarter, ri / cj the rows of x1 / x2 of its rows / columns (-1 for
// padding), pair the tile's pair id. slab: two [RC][kSub] arrays. Every
// thread calls it; it ends on a barrier-free register loop.
__device__ __forceinline__ void gram_lowrank_g(const int* __restrict__ idx,
                                               const int* __restrict__ rmap,
                                               const int* __restrict__ cmap,
                                               const float* __restrict__ A,
                                               const float* __restrict__ Bm, int R, int RC,
                                               float* slab, int (&ri)[kMicro], int (&cj)[kMicro],
                                               float (&g)[kMicro][kMicro], int& pair) {
    __shared__ int rows[kSub], cols[kSub];
    float* Ai = slab;
    float* Bj = slab + RC * kSub;
    const int s = blockIdx.x / 4, quarter = blockIdx.x % 4;
    const int ti = idx[3 * s], tj = idx[3 * s + 1];
    pair = idx[3 * s + 2];
    const int64_t row0 = (int64_t)ti * kTile + (quarter / 2) * kSub;
    const int64_t col0 = (int64_t)tj * kTile + (quarter % 2) * kSub;
    const int t = threadIdx.x, tx = t % 16, ty = t / 16;
    if (t < kSub)
        rows[t] = rmap[row0 + t];
    else
        cols[t - kSub] = cmap[col0 + t - kSub];
#pragma unroll
    for (int u = 0; u < kMicro; ++u)
#pragma unroll
        for (int v = 0; v < kMicro; ++v) g[u][v] = 0.0f;
    __syncthreads();   // rows, cols
#pragma unroll
    for (int u = 0; u < kMicro; ++u) {
        ri[u] = rows[ty + 16 * u];
        cj[u] = cols[tx + 16 * u];
    }
    for (int r0 = 0; r0 < R; r0 += RC) {
        const int rc = min(RC, R - r0);
        __syncthreads();   // the previous chunk's slabs are read
        for (int e = t; e < kSub * rc; e += kThreads) {
            const int r = e % rc, k = e / rc;   // consecutive threads, consecutive addresses
            const int i = rows[k], j = cols[k];
            Ai[r * kSub + k] = i >= 0 ? A[(int64_t)i * R + r0 + r] : 0.0f;
            Bj[r * kSub + k] = j >= 0 ? Bm[(int64_t)j * R + r0 + r] : 0.0f;
        }
        __syncthreads();
        for (int r = 0; r < rc; ++r) {
            float ai[kMicro], bj[kMicro];
#pragma unroll
            for (int u = 0; u < kMicro; ++u) {
                ai[u] = Ai[r * kSub + ty + 16 * u];
                bj[u] = Bj[r * kSub + tx + 16 * u];
            }
#pragma unroll
            for (int u = 0; u < kMicro; ++u)
#pragma unroll
                for (int v = 0; v < kMicro; ++v) g[u][v] = fmaf(ai[u], bj[v], g[u][v]);
        }
    }
}

template <int Q, int D>
__global__ void __launch_bounds__(kThreads)
gram_lowrank_vjp_kernel(const int* __restrict__ idx, const float* __restrict__ x1,
                        const int* __restrict__ rmap, const float* __restrict__ x2,
                        const int* __restrict__ cmap, const float* __restrict__ A,
                        const float* __restrict__ Bm, const float* __restrict__ stats,
                        float* __restrict__ partial, int R, int RC) {
    constexpr int NOUT = 3 * Q * D + 2 * Q;
    extern __shared__ float slab[];           // Ai, Bj: each [RC][kSub]
    __shared__ float st[NOUT];
    __shared__ float red[kThreads / 32][NOUT];
    const int t = threadIdx.x;
    const int pair0 = idx[3 * (blockIdx.x / 4) + 2];
    for (int e = t; e < NOUT; e += kThreads) st[e] = stats[(int64_t)pair0 * NOUT + e];
    int ri[kMicro], cj[kMicro], pair;
    float g[kMicro][kMicro];
    gram_lowrank_g(idx, rmap, cmap, A, Bm, R, RC, slab, ri, cj, g, pair);   // syncs after st

    // padded positions (g = 0 there) take inputs 0: any finite values will do
    float xi[kMicro][D], xj[kMicro][D];
#pragma unroll
    for (int u = 0; u < kMicro; ++u)
#pragma unroll
        for (int d = 0; d < D; ++d) {
            xi[u][d] = ri[u] >= 0 ? x1[(int64_t)ri[u] * D + d] : 0.0f;
            xj[u][d] = cj[u] >= 0 ? x2[(int64_t)cj[u] * D + d] : 0.0f;
        }
    float acc[NOUT];
#pragma unroll
    for (int k = 0; k < NOUT; ++k) acc[k] = 0.0f;
#pragma unroll
    for (int u = 0; u < kMicro; ++u)
#pragma unroll
        for (int v = 0; v < kMicro; ++v) add_pair_cotangents<Q, D>(g[u][v], xi[u], xj[v], st, acc);
    block_reduce_store<NOUT>(acc, red, partial + (int64_t)blockIdx.x * NOUT);
}

__global__ void __launch_bounds__(kThreads)
gram_lowrank_vjp_generic_kernel(const int* __restrict__ idx, const float* __restrict__ x1,
                                const int* __restrict__ rmap, const float* __restrict__ x2,
                                const int* __restrict__ cmap, const float* __restrict__ A,
                                const float* __restrict__ Bm, const float* __restrict__ stats,
                                float* __restrict__ partial, int R, int RC, int Q, int D) {
    extern __shared__ float slab[];
    const int NOUT = 3 * Q * D + 2 * Q;
    int ri[kMicro], cj[kMicro], pair;
    float g[kMicro][kMicro];
    gram_lowrank_g(idx, rmap, cmap, A, Bm, R, RC, slab, ri, cj, g, pair);
    const float* xr[kMicro];
    const float* xc[kMicro];
#pragma unroll
    for (int u = 0; u < kMicro; ++u) {
        xr[u] = x1 + (int64_t)(ri[u] >= 0 ? ri[u] : 0) * D;
        xc[u] = x2 + (int64_t)(cj[u] >= 0 ? cj[u] : 0) * D;
    }
    generic_tile<false>(g, xr, xc, stats + (int64_t)pair * NOUT, Q, D,
                        partial + (int64_t)blockIdx.x * NOUT, nullptr, nullptr, false, false);
}

template <typename Kernel, typename... Args>
int launch(Kernel kernel, int S, int RC, cudaStream_t stream, Args... args) {
    const size_t smem = sizeof(float) * 2 * (size_t)RC * kSub;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<(unsigned)(4 * S), kThreads, smem, stream>>>(args...);
    return (int)cudaGetLastError();
}

}  // namespace

// idx (S, 3) int32 tiles [ti, tj, pair]; x1 (N, D), rmap (Np,) int32, x2
// (M, D), cmap (Mp,) int32, Np and Mp multiples of 256; A (N, R), B (M, R);
// stats (O*O, 3QD+2Q); partial (4S, 3QD+2Q) scratch; pairs (P, 3) int32;
// out (O*O, 3QD+2Q), rows of absent pairs left as given. RC: the chunk
// width, 1 <= RC <= min(R, 64). generic: 0 for the unrolled instance
// (Q <= 4, D <= 2), 1 for the generic one.
extern "C" int mosm_gram_lowrank_vjp_f32(const int* idx, const float* x1, const int* rmap,
                                         const float* x2, const int* cmap, const float* A,
                                         const float* Bm, const float* stats, float* partial,
                                         const int* pairs, float* out, int S, int P, int Q, int D,
                                         int R, int RC, int generic, cudaStream_t stream) {
    if (R < 1 || RC < 1 || RC > kMaxRC || RC > R || Q < 1 || D < 1)
        return (int)cudaErrorInvalidValue;
    if (S == 0) return 0;
    int err = (int)cudaErrorInvalidValue;
    if (generic)
        err = launch(gram_lowrank_vjp_generic_kernel, S, RC, stream, idx, x1, rmap, x2, cmap, A,
                     Bm, stats, partial, R, RC, Q, D);
#define MOGPTK_VJP_CASE(q, d)                                                                  \
    else if (Q == q && D == d)                                                                 \
        err = launch(gram_lowrank_vjp_kernel<q, d>, S, RC, stream, idx, x1, rmap, x2, cmap, A,  \
                     Bm, stats, partial, R, RC);
    MOGPTK_VJP_CASE(1, 1) MOGPTK_VJP_CASE(2, 1) MOGPTK_VJP_CASE(3, 1) MOGPTK_VJP_CASE(4, 1)
    MOGPTK_VJP_CASE(1, 2) MOGPTK_VJP_CASE(2, 2) MOGPTK_VJP_CASE(3, 2) MOGPTK_VJP_CASE(4, 2)
#undef MOGPTK_VJP_CASE
    if (err != 0) return err;
    pair_reduce_kernel<<<(unsigned)P, 32, 0, stream>>>(partial, pairs, out, 3 * Q * D + 2 * Q);
    return (int)cudaGetLastError();
}
