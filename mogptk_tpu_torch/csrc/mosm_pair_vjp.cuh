// Shared parts of the two kernels that reduce a Gram cotangent to
// channel-pair statistics cotangents (csrc/mosm_lowrank_vjp.cu, where the
// cotangent is A B^T, and csrc/mosm_gram_bwd.cu, where it is read from
// memory): the tile geometry, the per-element backward of the tau chain,
// the fixed-order block reductions, the fixed-order per-pair reduction in
// float64 and, for csrc/mosm_gram_bwd.cu's input half, the per-row and
// per-column sums of d tau and their fixed-order float64 reduction. No
// atomics, so both kernels are deterministic.
//
// Per pair the statistics are [V, M, dtheta] x (q, d), then [alpha, dphi] x q
// (ops/mosm_gram.stats_table), NOUT = 3QD + 2Q numbers, and
//   K = sum_q alpha_q exp(-1/2 sum_d V tau_d^2) cos(2 pi (sum_d M tau_d + dphi_q)),
//   tau_d = x1_d - x2_d + dtheta_qd.
// The cotangent of tau_qd is the term summed into dtheta_qd's slot; tau's
// input cotangents are then dx1_d = +sum_q dtau_qd and dx2_d = -sum_q dtau_qd.
//
// Geometry: a host list names 256^2 tiles; a block of 256 threads takes a
// 128 x 128 quarter of one (quarter = blockIdx.x % 4: row half quarter / 2,
// column half quarter % 2), each thread 8 x 8 elements at rows ty + 16u and
// columns tx + 16v (t = 16 ty + tx).
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kTwoPi = 6.283185307179586f;
constexpr int kTile = 256;      // the host tile list's tile edge
constexpr int kSub = 128;       // a block's quarter-tile edge
constexpr int kThreads = 256;   // 16 x 16 threads
constexpr int kMicro = 8;       // 8 x 8 elements per thread
constexpr int kDC = 4;          // input dims per pass of the generic instance
constexpr int kGS = 3 * kDC + 2;

// acc += gv * dK/dst for one element with inputs xi, xj under the pair table
// st; with kTau, tau[d] += sum_q (the cotangent of tau_qd). expf and sincosf
// are the full-precision library functions (no fast math): the cosine
// argument reaches ~250 rad on the bench data.
template <int Q, int D, bool kTau>
__device__ __forceinline__ void add_pair_cotangents(float gv, const float (&xi)[D],
                                                    const float (&xj)[D], const float* st,
                                                    float (&acc)[3 * Q * D + 2 * Q],
                                                    float (&tau)[D]) {
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
            const float dt = de * (2.0f * s3[0]) * td[d] + da * s3[1];
            acc[3 * (q * D + d)] += de * td[d] * td[d];
            acc[3 * (q * D + d) + 1] += da * td[d];
            acc[3 * (q * D + d) + 2] += dt;
            if constexpr (kTau) tau[d] += dt;
        }
    }
}

template <int Q, int D>
__device__ __forceinline__ void add_pair_cotangents(float gv, const float (&xi)[D],
                                                    const float (&xj)[D], const float* st,
                                                    float (&acc)[3 * Q * D + 2 * Q]) {
    float unused[D];
    add_pair_cotangents<Q, D, false>(gv, xi, xj, st, acc, unused);
}

// Sums acc over the block in a fixed order (warp shuffles, then the warp
// sums in order) and writes the NOUT sums to out. Every thread calls it.
template <int NOUT>
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

// racc[u][k]: this thread's sum of d tau_(d0+k) over its 8 columns, for row
// ty + 16u. Sums each row over its 16 threads (lanes of one half-warp, a
// fixed butterfly) and writes rowpart[row * D + d0 + k] for k < nd.
template <int W>
__device__ __forceinline__ void store_row_sums(float (&racc)[kMicro][W],
                                               float* __restrict__ rowpart, int D, int d0,
                                               int nd) {
    const int t = threadIdx.x, tx = t % 16, ty = t / 16;
#pragma unroll
    for (int u = 0; u < kMicro; ++u)
#pragma unroll
        for (int k = 0; k < W; ++k) {
            float v = racc[u][k];
#pragma unroll
            for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
            racc[u][k] = v;
        }
    if (tx == 0)
#pragma unroll
        for (int u = 0; u < kMicro; ++u)
#pragma unroll
            for (int k = 0; k < W; ++k)
                if (k < nd) rowpart[(int64_t)(ty + 16 * u) * D + d0 + k] = racc[u][k];
}

// cacc[v][k]: this thread's sum over its 8 rows, for column tx + 16v. Sums
// each column over its 16 threads (the two rows of threads of a warp by a
// shuffle, then the eight warps in order through shared memory) and writes
// colpart[col * D + d0 + k] for k < nd. Every thread calls it.
template <int W>
__device__ __forceinline__ void store_col_sums(float (&cacc)[kMicro][W],
                                               float (&colred)[kThreads / 32][kSub][W],
                                               float* __restrict__ colpart, int D, int d0,
                                               int nd) {
    const int t = threadIdx.x, lane = t % 32, warp = t / 32;
#pragma unroll
    for (int v = 0; v < kMicro; ++v)
#pragma unroll
        for (int k = 0; k < W; ++k) {
            const float s = cacc[v][k] + __shfl_xor_sync(0xffffffffu, cacc[v][k], 16);
            if (lane < 16) colred[warp][lane + 16 * v][k] = s;
        }
    __syncthreads();
    if (t < kSub)
#pragma unroll
        for (int k = 0; k < W; ++k) {
            if (k >= nd) break;
            float s = 0.0f;
            for (int w = 0; w < kThreads / 32; ++w) s += colred[w][t][k];
            colpart[(int64_t)t * D + d0 + k] = s;
        }
    __syncthreads();
}

// The generic instance's tile: any Q and D. The element's tau chain runs
// over the runtime Q and D; the parameter accumulators are those of one
// component q and at most kDC input dims at a time (the transcendental
// functions are evaluated again for each further kDC dims), each set
// block-reduced and written to its slots of prow, this block's NOUT row.
// xr[u] / xc[v]: the D inputs of the thread's rows / columns (any finite
// values where g is 0); st: the pair's NOUT statistics in global memory.
// With kInputs, the per-row (rows) and per-column (cols) sums of d tau go to
// rowpart / colpart, this block's 128 x D slabs. Every thread calls it.
template <bool kInputs>
__device__ void generic_tile(const float (&gt)[kMicro][kMicro], const float* const (&xr)[kMicro],
                             const float* const (&xc)[kMicro], const float* __restrict__ st,
                             int Q, int D, float* __restrict__ prow, float* __restrict__ rowpart,
                             float* __restrict__ colpart, bool rows, bool cols) {
    __shared__ float red[kThreads / 32][kGS];
    __shared__ float colred[kInputs ? kThreads / 32 : 1][kSub][kDC];
    const int t = threadIdx.x, lane = t % 32, warp = t / 32;
    for (int d0 = 0; d0 < D; d0 += kDC) {
        const int nd = min(kDC, D - d0);
        float racc[kMicro][kDC], cacc[kMicro][kDC];
        if constexpr (kInputs) {
#pragma unroll
            for (int u = 0; u < kMicro; ++u)
#pragma unroll
                for (int k = 0; k < kDC; ++k) racc[u][k] = cacc[u][k] = 0.0f;
        }
        for (int q = 0; q < Q; ++q) {
            const float alpha = __ldg(st + 3 * Q * D + 2 * q);
            const float dphi = __ldg(st + 3 * Q * D + 2 * q + 1);
            float acc[kGS];
#pragma unroll
            for (int k = 0; k < kGS; ++k) acc[k] = 0.0f;
            // not unrolled: the generic instance is the rare path, and its
            // code stays small (gt and the sums of d tau in local memory)
#pragma unroll 1
            for (int u = 0; u < kMicro; ++u)
#pragma unroll 1
                for (int v = 0; v < kMicro; ++v) {
                    float e = 0.0f, a = 0.0f;
                    for (int d = 0; d < D; ++d) {
                        const float* s3 = st + 3 * (q * D + d);
                        const float td = (xr[u][d] - xc[v][d]) + __ldg(s3 + 2);
                        e += td * td * __ldg(s3);
                        a += td * __ldg(s3 + 1);
                    }
                    const float ang = kTwoPi * (a + dphi);
                    const float E = expf(-0.5f * e);
                    float S, C;
                    sincosf(ang, &S, &C);
                    const float gE = gt[u][v] * E;
                    const float P = alpha * gE;
                    const float dang = -P * S;
                    const float de = -0.5f * P * C;
                    const float da = kTwoPi * dang;
                    acc[3 * kDC] += gE * C;
                    acc[3 * kDC + 1] += kTwoPi * dang;
#pragma unroll
                    for (int k = 0; k < kDC; ++k) {
                        if (k >= nd) break;
                        const int d = d0 + k;
                        const float* s3 = st + 3 * (q * D + d);
                        const float td = (xr[u][d] - xc[v][d]) + __ldg(s3 + 2);
                        const float dt = de * (2.0f * __ldg(s3)) * td + da * __ldg(s3 + 1);
                        acc[3 * k] += de * td * td;
                        acc[3 * k + 1] += da * td;
                        acc[3 * k + 2] += dt;
                        if constexpr (kInputs) {
                            racc[u][k] += dt;
                            cacc[v][k] += dt;
                        }
                    }
                }
#pragma unroll
            for (int k = 0; k < kGS; ++k) {
                float v = acc[k];
#pragma unroll
                for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
                if (lane == 0) red[warp][k] = v;
            }
            __syncthreads();
            if (t < kGS) {
                float v = 0.0f;
                for (int w = 0; w < kThreads / 32; ++w) v += red[w][t];
                int slot = -1;
                if (t < 3 * kDC) {
                    if (t / 3 < nd) slot = 3 * (q * D + d0 + t / 3) + t % 3;
                } else if (d0 == 0) {
                    slot = 3 * Q * D + 2 * q + (t - 3 * kDC);
                }
                if (slot >= 0) prow[slot] = v;
            }
            __syncthreads();   // red is written again by the next component
        }
        if constexpr (kInputs) {
            if (rows) store_row_sums<kDC>(racc, rowpart, D, d0, nd);
            if (cols) store_col_sums<kDC>(cacc, colred, colpart, D, d0, nd);
        }
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
