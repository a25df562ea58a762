// Channel-pair cotangents of the MOSM Gram for a dense cotangent g (N, M),
// for Hopper (sm_90a), float32: K-gram-bwd, the backward of csrc/mosm_gram.cu.
//
// Replaces two Pallas kernels of the JAX package:
//   mogptk_tpu/ops/block_mosm.py  _gram_block_bwd (pallas_call at :345),
//     one channel-pair block of the sorted Gram per launch, 256^2 tiles
//     accumulated over the TPU's sequential grid;
//   mogptk_tpu/ops/pallas_mosm.py _mosm_gram_bwd (pallas_call at :274), the
//     backward for arbitrary channel IDs (its parameter cotangents; the
//     input cotangents for trained inducing points are not ported).
// Both reduce g to the 3QD + 2Q scalars [dV, dM, dtheta] x (q, d), then
// [dalpha, dphi] x q, of each channel pair's statistics:
//   dst[a, b] = sum over (i, j) with (c1[i], c2[j]) = (a, b) of g_ij dK_ij/dst[a, b];
// autograd chains them through ops/block_mosm.mosm_pair_stats.
//
// Layout: the host lays rows and columns out channel by channel, each
// channel padded to a multiple of T = 256 (ops/mosm_gram._gram_layout), and
// passes rmap (Np,) and cmap (Mp,): the row (column) of g and x1 (x2) at each
// laid-out position, -1 for padding. A tile then belongs to one channel pair,
// and the work list names every tile of every present pair, grouped by pair.
// For channel-sorted data with channels that are multiples of 256 (the bench
// model) the maps are the identity and g is read in place; for unsorted data
// they gather, and no permuted copy of g is made.
//
// Bound: the read of g, N*M*4 bytes (1.07 GB at N = 16,384), against Q expf
// and Q sincosf with ~20 FMAs per element. Design: K-lowrank-vjp's (same tau
// chain and reductions, mosm_pair_vjp.cuh) with g loaded from memory instead
// of formed as A_i B_j^T: a block takes a 128 x 128 quarter of a tile, 256
// threads of 8 x 8 elements, rows ty + 16u and columns tx + 16v, so 16
// neighbouring threads read 16 neighbouring columns of a row. Each thread
// first loads its 64 values of g (64 loads in flight), then runs the chain.
// Each block writes its partial sums; a second kernel sums each pair's
// partials in a fixed order in float64. No atomics: deterministic.
#include "mosm_pair_vjp.cuh"

namespace {

constexpr int kTile = 256;      // the host tile list's tile edge
constexpr int kSub = 128;       // a block's quarter-tile edge
constexpr int kThreads = 256;   // 16 x 16 threads
constexpr int kMicro = 8;       // 8 x 8 elements per thread

template <int Q, int D>
__global__ void __launch_bounds__(kThreads)
gram_bwd_kernel(const int* __restrict__ idx, const float* __restrict__ g, int64_t M,
                const float* __restrict__ x1, const int* __restrict__ rmap,
                const float* __restrict__ x2, const int* __restrict__ cmap,
                const float* __restrict__ stats, float* __restrict__ partial) {
    constexpr int NOUT = 3 * Q * D + 2 * Q;
    __shared__ float st[NOUT];
    __shared__ float red[kThreads / 32][NOUT];

    const int s = blockIdx.x / 4, quarter = blockIdx.x % 4;
    const int ti = idx[3 * s], tj = idx[3 * s + 1], pair = idx[3 * s + 2];
    const int64_t row0 = (int64_t)ti * kTile + (quarter / 2) * kSub;
    const int64_t col0 = (int64_t)tj * kTile + (quarter % 2) * kSub;
    const int t = threadIdx.x;
    for (int e = t; e < NOUT; e += kThreads) st[e] = stats[(int64_t)pair * NOUT + e];

    const int tx = t % 16, ty = t / 16;
    int ri[kMicro], cj[kMicro];
#pragma unroll
    for (int u = 0; u < kMicro; ++u) {
        ri[u] = rmap[row0 + ty + 16 * u];
        cj[u] = cmap[col0 + tx + 16 * u];
    }
    float gt[kMicro][kMicro];
#pragma unroll
    for (int u = 0; u < kMicro; ++u)
#pragma unroll
        for (int v = 0; v < kMicro; ++v)
            gt[u][v] = (ri[u] >= 0 && cj[v] >= 0) ? g[(int64_t)ri[u] * M + cj[v]] : 0.0f;
    float xi[kMicro][D], xj[kMicro][D];
#pragma unroll
    for (int u = 0; u < kMicro; ++u)
#pragma unroll
        for (int d = 0; d < D; ++d) {
            xi[u][d] = ri[u] >= 0 ? x1[(int64_t)ri[u] * D + d] : 0.0f;
            xj[u][d] = cj[u] >= 0 ? x2[(int64_t)cj[u] * D + d] : 0.0f;
        }
    __syncthreads();   // st

    float acc[NOUT];
#pragma unroll
    for (int k = 0; k < NOUT; ++k) acc[k] = 0.0f;
#pragma unroll
    for (int u = 0; u < kMicro; ++u)
#pragma unroll
        for (int v = 0; v < kMicro; ++v) add_pair_cotangents<Q, D>(gt[u][v], xi[u], xj[v], st, acc);
    block_reduce_store<NOUT, kThreads>(acc, red, partial + (int64_t)blockIdx.x * NOUT);
}

template <int Q, int D>
int launch(const int* idx, const float* g, const float* x1, const int* rmap, const float* x2,
           const int* cmap, const float* stats, float* partial, const int* pairs, float* out,
           int S, int P, int64_t M, cudaStream_t stream) {
    gram_bwd_kernel<Q, D><<<(unsigned)(4 * S), kThreads, 0, stream>>>(idx, g, M, x1, rmap, x2,
                                                                      cmap, stats, partial);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    pair_reduce_kernel<<<(unsigned)P, 32, 0, stream>>>(partial, pairs, out, 3 * Q * D + 2 * Q);
    return (int)cudaGetLastError();
}

}  // namespace

// idx (S, 3) int32 tiles [ti, tj, pair]; g (N, M) row-major; x1 (N, D),
// rmap (Np,) int32, x2 (M, D), cmap (Mp,) int32, Np and Mp multiples of 256;
// stats (O*O, 3QD+2Q); partial (4S, 3QD+2Q) scratch; pairs (P, 3) int32;
// out (O*O, 3QD+2Q), rows of absent pairs left as given.
extern "C" int mosm_gram_bwd_f32(const int* idx, const float* g, const float* x1,
                                 const int* rmap, const float* x2, const int* cmap,
                                 const float* stats, float* partial, const int* pairs,
                                 float* out, int S, int P, int64_t M, int Q, int D,
                                 cudaStream_t stream) {
    if (S == 0) return 0;
#define MOGPTK_BWD_CASE(q, d)                                                              \
    if (Q == q && D == d)                                                                  \
        return launch<q, d>(idx, g, x1, rmap, x2, cmap, stats, partial, pairs, out, S, P, M, \
                            stream);
    MOGPTK_BWD_CASE(1, 1) MOGPTK_BWD_CASE(2, 1) MOGPTK_BWD_CASE(3, 1) MOGPTK_BWD_CASE(4, 1)
    MOGPTK_BWD_CASE(1, 2) MOGPTK_BWD_CASE(2, 2) MOGPTK_BWD_CASE(3, 2) MOGPTK_BWD_CASE(4, 2)
#undef MOGPTK_BWD_CASE
    return (int)cudaErrorInvalidValue;
}
