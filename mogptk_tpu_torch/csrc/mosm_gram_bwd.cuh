// The tile kernel of K-gram-bwd (csrc/mosm_gram_bwd.cu, which documents it),
// unrolled over Q and D, with and without the input half, shared by the two
// sources that instantiate it: csrc/mosm_gram_bwd.cu (the parameter-only
// instances, the generic instance, the reductions and the C entry point)
// and csrc/mosm_gram_bwd_inputs.cu (the instances with the input half), so
// that nvcc compiles the two halves in parallel.
#pragma once
#include "mosm_pair_vjp.cuh"

namespace {

// The 64 values of g and the thread's row/column indices of one quarter.
__device__ __forceinline__ void load_tile(const int* __restrict__ idx, const float* __restrict__ g,
                                          int64_t M, const int* __restrict__ rmap,
                                          const int* __restrict__ cmap, int (&ri)[kMicro],
                                          int (&cj)[kMicro], float (&gt)[kMicro][kMicro],
                                          int& pair) {
    const int s = blockIdx.x / 4, quarter = blockIdx.x % 4;
    const int ti = idx[3 * s], tj = idx[3 * s + 1];
    pair = idx[3 * s + 2];
    const int64_t row0 = (int64_t)ti * kTile + (quarter / 2) * kSub;
    const int64_t col0 = (int64_t)tj * kTile + (quarter % 2) * kSub;
    const int t = threadIdx.x, tx = t % 16, ty = t / 16;
#pragma unroll
    for (int u = 0; u < kMicro; ++u) {
        ri[u] = rmap[row0 + ty + 16 * u];
        cj[u] = cmap[col0 + tx + 16 * u];
    }
#pragma unroll
    for (int u = 0; u < kMicro; ++u)
#pragma unroll
        for (int v = 0; v < kMicro; ++v)
            gt[u][v] = (ri[u] >= 0 && cj[v] >= 0) ? g[(int64_t)ri[u] * M + cj[v]] : 0.0f;
}

template <int Q, int D, bool kInputs>
__global__ void __launch_bounds__(kThreads)
gram_bwd_kernel(const int* __restrict__ idx, const float* __restrict__ g, int64_t M,
                const float* __restrict__ x1, const int* __restrict__ rmap,
                const float* __restrict__ x2, const int* __restrict__ cmap,
                const float* __restrict__ stats, float* __restrict__ partial,
                float* __restrict__ rowpart, float* __restrict__ colpart, bool rows, bool cols) {
    constexpr int NOUT = 3 * Q * D + 2 * Q;
    __shared__ float st[NOUT];
    __shared__ float red[kThreads / 32][NOUT];

    int ri[kMicro], cj[kMicro], pair;
    float gt[kMicro][kMicro];
    load_tile(idx, g, M, rmap, cmap, ri, cj, gt, pair);
    const int t = threadIdx.x;
    for (int e = t; e < NOUT; e += kThreads) st[e] = stats[(int64_t)pair * NOUT + e];
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
    if constexpr (kInputs) {
        __shared__ float colred[kThreads / 32][kSub][D];
        float racc[kMicro][D], cacc[kMicro][D];
#pragma unroll
        for (int u = 0; u < kMicro; ++u)
#pragma unroll
            for (int d = 0; d < D; ++d) racc[u][d] = cacc[u][d] = 0.0f;
#pragma unroll
        for (int u = 0; u < kMicro; ++u)
#pragma unroll
            for (int v = 0; v < kMicro; ++v) {
                float tau[D];
#pragma unroll
                for (int d = 0; d < D; ++d) tau[d] = 0.0f;
                add_pair_cotangents<Q, D, true>(gt[u][v], xi[u], xj[v], st, acc, tau);
#pragma unroll
                for (int d = 0; d < D; ++d) {
                    racc[u][d] += tau[d];
                    cacc[v][d] += tau[d];
                }
            }
        block_reduce_store<NOUT>(acc, red, partial + (int64_t)blockIdx.x * NOUT);
        if (rows) store_row_sums<D>(racc, rowpart + (int64_t)blockIdx.x * kSub * D, D, 0, D);
        if (cols)
            store_col_sums<D>(cacc, colred, colpart + (int64_t)blockIdx.x * kSub * D, D, 0, D);
    } else {
#pragma unroll
        for (int u = 0; u < kMicro; ++u)
#pragma unroll
            for (int v = 0; v < kMicro; ++v)
                add_pair_cotangents<Q, D>(gt[u][v], xi[u], xj[v], st, acc);
        block_reduce_store<NOUT>(acc, red, partial + (int64_t)blockIdx.x * NOUT);
    }
}

}  // namespace

// Launches gram_bwd_kernel<Q, D, true> (csrc/mosm_gram_bwd_inputs.cu);
// returns cudaErrorInvalidValue for a (Q, D) it has no instance of.
int launch_gram_bwd_inputs_unrolled(int Q, int D, unsigned blocks, const int* idx, const float* g,
                                    int64_t M, const float* x1, const int* rmap, const float* x2,
                                    const int* cmap, const float* stats, float* partial,
                                    float* rowpart, float* colpart, bool rows, bool cols,
                                    cudaStream_t stream);
