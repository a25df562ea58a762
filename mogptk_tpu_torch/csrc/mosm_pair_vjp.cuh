// Shared parts of the two kernels that reduce a Gram cotangent to
// channel-pair statistics cotangents (csrc/mosm_lowrank_vjp.cu, where the
// cotangent is A B^T, and csrc/mosm_gram_bwd.cu, where it is read from
// memory): the per-element backward of the tau chain, the fixed-order block
// reduction and the fixed-order per-pair reduction in float64. No atomics, so
// both kernels are deterministic.
//
// Per pair the statistics are [V, M, dtheta] x (q, d), then [alpha, dphi] x q
// (ops/mosm_gram.stats_table), NOUT = 3QD + 2Q numbers, and
//   K = sum_q alpha_q exp(-1/2 sum_d V tau_d^2) cos(2 pi (sum_d M tau_d + dphi_q)),
//   tau_d = x1_d - x2_d + dtheta_qd.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kTwoPi = 6.283185307179586f;

// acc += gv * dK/dst for one element with inputs xi, xj under the pair table
// st. expf and sincosf are the full-precision library functions (no fast
// math): the cosine argument reaches ~250 rad on the bench data.
template <int Q, int D>
__device__ __forceinline__ void add_pair_cotangents(float gv, const float (&xi)[D],
                                                    const float (&xj)[D], const float* st,
                                                    float (&acc)[3 * Q * D + 2 * Q]) {
#pragma unroll
    for (int q = 0; q < Q; ++q) {
        float td[D];
        float e = 0.0f, a = 0.0f;
#pragma unroll
        for (int d = 0; d < D; ++d) {
            const float* s3 = st + 3 * (q * D + d);
            td[d] = (xi[d] - xj[d]) + s3[2];
            e += td[d] * td[d] * s3[0];
            a += td[d] * s3[1];
        }
        const float alpha = st[3 * Q * D + 2 * q];
        const float ang = kTwoPi * (a + st[3 * Q * D + 2 * q + 1]);
        const float E = expf(-0.5f * e);
        float S, C;
        sincosf(ang, &S, &C);
        const float gE = gv * E;
        const float P = alpha * gE;
        const float dang = -P * S;
        const float de = -0.5f * P * C;
        const float da = kTwoPi * dang;
        acc[3 * Q * D + 2 * q] += gE * C;
        acc[3 * Q * D + 2 * q + 1] += kTwoPi * dang;
#pragma unroll
        for (int d = 0; d < D; ++d) {
            const float* s3 = st + 3 * (q * D + d);
            acc[3 * (q * D + d)] += de * td[d] * td[d];
            acc[3 * (q * D + d) + 1] += da * td[d];
            acc[3 * (q * D + d) + 2] += de * (2.0f * s3[0]) * td[d] + da * s3[1];
        }
    }
}

// Sums acc over the block in a fixed order (warp shuffles, then the warp
// sums in order) and writes the NOUT sums to out. Every thread calls it.
template <int NOUT, int kThreads>
__device__ __forceinline__ void block_reduce_store(const float (&acc)[NOUT],
                                                   float (&red)[kThreads / 32][NOUT],
                                                   float* __restrict__ out) {
    const int t = threadIdx.x, lane = t % 32, warp = t / 32;
#pragma unroll
    for (int k = 0; k < NOUT; ++k) {
        float v = acc[k];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
        if (lane == 0) red[warp][k] = v;
    }
    __syncthreads();
    if (t < NOUT) {
        float v = 0.0f;
        for (int w = 0; w < kThreads / 32; ++w) v += red[w][t];
        out[t] = v;
    }
}

// out[pair] = sum of the pair's partial rows, in order, in float64.
// pairs: (P, 3) int32 [pair id, first partial row, row count].
__global__ void pair_reduce_kernel(const float* __restrict__ partial,
                                   const int* __restrict__ pairs,
                                   float* __restrict__ out, int nout) {
    const int p = blockIdx.x;
    const int pair = pairs[3 * p], first = pairs[3 * p + 1], count = pairs[3 * p + 2];
    for (int k = threadIdx.x; k < nout; k += blockDim.x) {
        double v = 0.0;
        for (int i = 0; i < count; ++i) v += (double)partial[(int64_t)(first + i) * nout + k];
        out[(int64_t)pair * nout + k] = (float)v;
    }
}

}  // namespace
