// Channel-pair cotangents of the MOSM Gram for a low-rank dK = A B^T, for
// Hopper (sm_90a), float32, without forming dK.
//
// Replaces mogptk_tpu/ops/block_mosm.py mosm_lowrank_vjp_sorted (pallas_call
// at :652, body _lowrank_bwd_batched_kernel at :214, per-tile math
// _bwd_scalars at :119 with phase_inside). The rows are channel-sorted and
// each channel is padded with zero rows of A and B to a multiple of T = 256,
// so padding adds nothing. A host-built list names every upper 256^2 tile
// (ti <= tj) of every upper channel pair (a <= b), grouped by pair. For one
// tile the cotangent is
//   g = A_i B_j^T + [ti != tj] B_i A_j^T      (the transposed lower tile folded in)
// and the tile reduces, for each component q and input dim d, to the 3QD + 2Q
// scalars [dV, dM, dtheta] x (q, d), then [dalpha, dphi] x q, of the pair's
// statistics (the hand-derived backward of the tau -> exp/cos chain of
// csrc/mosm_gram.cu).
//
// Bound: operations. Per element 2R FMAs for g (R = 17 on the training path)
// and, per component, one expf and one sincosf with ~20 FMAs; the inputs are
// a few MB, read from L2. Design: a block takes a 128 x 128 quarter of a tile
// (four blocks per tile) with 256 threads of 8 x 8 elements each, interleaved
// so neighbouring threads read neighbouring shared-memory words; the four
// (128, R) slabs of A and B sit in shared memory, R-major. Blocks run in no
// order, so nothing carries from one to the next as it did across the TPU's
// sequential grid: each block writes its 3QD + 2Q partial sums (a fixed-order
// warp and block reduction, no atomics), and a second kernel sums each pair's
// partials in a fixed order in float64. The result is deterministic. The tau
// chain and both reductions are shared with csrc/mosm_gram_bwd.cu
// (mosm_pair_vjp.cuh).
//
// Any R: the slabs hold at most RC <= 64 columns of A and B at a time
// (ops/block_mosm.lowrank_chunk chooses RC), and g accumulates over the
// chunks in order inside the block, so the tau chain runs once per element
// whatever R is, and the result stays deterministic. Two instances
// (ops/mosm_gram.kernel_instance chooses): unrolled over Q and D for Q <= 4,
// D <= 2, and a generic one for any Q and D (mosm_pair_vjp.cuh
// generic_tile).
#include "mosm_pair_vjp.cuh"

namespace {

constexpr int kMaxRC = 64;      // columns of A and B in the slabs at a time

// g[u][v] = (A_i B_j^T + [ti != tj] B_i A_j^T) for the thread's 8 x 8
// elements of this block's quarter, accumulated over R in chunks of RC
// columns staged in shared memory (slab: four [RC][kSub] arrays).
__device__ __forceinline__ void lowrank_g(const int* __restrict__ idx,
                                          const float* __restrict__ A,
                                          const float* __restrict__ Bm, int R, int RC,
                                          float* slab, float (&g)[kMicro][kMicro],
                                          int64_t& row0, int64_t& col0, int& pair) {
    float* Ai = slab;
    float* Bi = slab + RC * kSub;
    float* Aj = slab + 2 * RC * kSub;
    float* Bj = slab + 3 * RC * kSub;
    const int s = blockIdx.x / 4, quarter = blockIdx.x % 4;
    const int ti = idx[3 * s], tj = idx[3 * s + 1];
    pair = idx[3 * s + 2];
    const bool sym = ti != tj;
    row0 = (int64_t)ti * kTile + (quarter / 2) * kSub;
    col0 = (int64_t)tj * kTile + (quarter % 2) * kSub;
    const int t = threadIdx.x, tx = t % 16, ty = t / 16;   // rows ty + 16u, columns tx + 16v
#pragma unroll
    for (int u = 0; u < kMicro; ++u)
#pragma unroll
        for (int v = 0; v < kMicro; ++v) g[u][v] = 0.0f;
    for (int r0 = 0; r0 < R; r0 += RC) {
        const int rc = min(RC, R - r0);
        __syncthreads();   // the previous chunk's slabs are read
        for (int e = t; e < kSub * rc; e += kThreads) {
            const int r = e % rc, k = e / rc;   // consecutive threads, consecutive addresses
            Ai[r * kSub + k] = A[(row0 + k) * R + r0 + r];
            Bi[r * kSub + k] = Bm[(row0 + k) * R + r0 + r];
            Aj[r * kSub + k] = A[(col0 + k) * R + r0 + r];
            Bj[r * kSub + k] = Bm[(col0 + k) * R + r0 + r];
        }
        __syncthreads();
        for (int r = 0; r < rc; ++r) {
            float ai[kMicro], bi[kMicro], aj[kMicro], bj[kMicro];
#pragma unroll
            for (int u = 0; u < kMicro; ++u) {
                ai[u] = Ai[r * kSub + ty + 16 * u];
                bi[u] = Bi[r * kSub + ty + 16 * u];
                aj[u] = Aj[r * kSub + tx + 16 * u];
                bj[u] = Bj[r * kSub + tx + 16 * u];
            }
#pragma unroll
            for (int u = 0; u < kMicro; ++u)
#pragma unroll
                for (int v = 0; v < kMicro; ++v) g[u][v] = fmaf(ai[u], bj[v], g[u][v]);
            if (sym) {
#pragma unroll
                for (int u = 0; u < kMicro; ++u)
#pragma unroll
                    for (int v = 0; v < kMicro; ++v) g[u][v] = fmaf(bi[u], aj[v], g[u][v]);
            }
        }
    }
}

template <int Q, int D>
__global__ void __launch_bounds__(kThreads)
lowrank_vjp_kernel(const int* __restrict__ idx, const float* __restrict__ x,
                   const float* __restrict__ A, const float* __restrict__ Bm,
                   const float* __restrict__ stats, float* __restrict__ partial, int R, int RC) {
    constexpr int NOUT = 3 * Q * D + 2 * Q;
    extern __shared__ float slab[];           // Ai, Bi, Aj, Bj: each [RC][kSub]
    __shared__ float st[NOUT];
    __shared__ float red[kThreads / 32][NOUT];
    const int t = threadIdx.x, tx = t % 16, ty = t / 16;
    const int pair = idx[3 * (blockIdx.x / 4) + 2];
    for (int e = t; e < NOUT; e += kThreads) st[e] = stats[(int64_t)pair * NOUT + e];
    float g[kMicro][kMicro];
    int64_t row0, col0;
    int pair_;
    lowrank_g(idx, A, Bm, R, RC, slab, g, row0, col0, pair_);   // syncs after st

    float xi[kMicro][D], xj[kMicro][D];
#pragma unroll
    for (int u = 0; u < kMicro; ++u)
#pragma unroll
        for (int d = 0; d < D; ++d) {
            xi[u][d] = x[(row0 + ty + 16 * u) * D + d];
            xj[u][d] = x[(col0 + tx + 16 * u) * D + d];
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
lowrank_vjp_generic_kernel(const int* __restrict__ idx, const float* __restrict__ x,
                           const float* __restrict__ A, const float* __restrict__ Bm,
                           const float* __restrict__ stats, float* __restrict__ partial, int R,
                           int RC, int Q, int D) {
    extern __shared__ float slab[];
    const int NOUT = 3 * Q * D + 2 * Q;
    const int t = threadIdx.x, tx = t % 16, ty = t / 16;
    float g[kMicro][kMicro];
    int64_t row0, col0;
    int pair;
    lowrank_g(idx, A, Bm, R, RC, slab, g, row0, col0, pair);
    const float* xr[kMicro];
    const float* xc[kMicro];
#pragma unroll
    for (int u = 0; u < kMicro; ++u) {
        xr[u] = x + (row0 + ty + 16 * u) * D;
        xc[u] = x + (col0 + tx + 16 * u) * D;
    }
    generic_tile<false>(g, xr, xc, stats + (int64_t)pair * NOUT, Q, D,
                        partial + (int64_t)blockIdx.x * NOUT, nullptr, nullptr, false, false);
}

template <typename Kernel, typename... Args>
int launch(Kernel kernel, int S, int RC, cudaStream_t stream, Args... args) {
    const size_t smem = sizeof(float) * 4 * (size_t)RC * kSub;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<(unsigned)(4 * S), kThreads, smem, stream>>>(args...);
    return (int)cudaGetLastError();
}

}  // namespace

// idx (S, 3) int32 upper tiles [ti, tj, pair]; x (Np, D), A and B (Np, R),
// Np a multiple of 256; stats (O*O, 3QD+2Q); partial (4S, 3QD+2Q) scratch;
// pairs (P, 3) int32; out (O*O, 3QD+2Q), rows of absent pairs left as given.
// RC: the chunk width, 1 <= RC <= min(R, 64). generic: 0 for the unrolled
// instance (Q <= 4, D <= 2), 1 for the generic one.
extern "C" int mosm_lowrank_vjp_f32(const int* idx, const float* x, const float* A,
                                    const float* Bm, const float* stats, float* partial,
                                    const int* pairs, float* out, int S, int P, int Q, int D,
                                    int R, int RC, int generic, cudaStream_t stream) {
    if (R < 1 || RC < 1 || RC > kMaxRC || RC > R || Q < 1 || D < 1)
        return (int)cudaErrorInvalidValue;
    if (S == 0) return 0;
    int err = (int)cudaErrorInvalidValue;
    if (generic)
        err = launch(lowrank_vjp_generic_kernel, S, RC, stream, idx, x, A, Bm, stats, partial, R,
                     RC, Q, D);
#define MOGPTK_VJP_CASE(q, d)                                                                \
    else if (Q == q && D == d)                                                               \
        err = launch(lowrank_vjp_kernel<q, d>, S, RC, stream, idx, x, A, Bm, stats, partial, R, \
                     RC);
    MOGPTK_VJP_CASE(1, 1) MOGPTK_VJP_CASE(2, 1) MOGPTK_VJP_CASE(3, 1) MOGPTK_VJP_CASE(4, 1)
    MOGPTK_VJP_CASE(1, 2) MOGPTK_VJP_CASE(2, 2) MOGPTK_VJP_CASE(3, 2) MOGPTK_VJP_CASE(4, 2)
#undef MOGPTK_VJP_CASE
    if (err != 0) return err;
    pair_reduce_kernel<<<(unsigned)P, 32, 0, stream>>>(partial, pairs, out, 3 * Q * D + 2 * Q);
    return (int)cudaGetLastError();
}
