// Shared parts of the two kernels that reduce a Gram cotangent to
// channel-pair statistics cotangents (csrc/mosm_lowrank_vjp.cu, where the
// cotangent is A B^T, and csrc/mosm_gram_bwd.cu, where it is read from
// memory): the tile geometry, the per-element backward of the tau chain
// (at full precision one element at a time, and on the hardware's exp and
// sin/cos four elements at a time), the fixed-order block reductions, the
// fixed-order per-pair reductions in float64 (also the family kernels') and,
// for csrc/mosm_gram_bwd.cu's input half, the per-row and per-column sums of
// d tau and their fixed-order float64 reduction. No atomics, so both kernels
// are deterministic.
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

// S, C = sin, cos (2 pi y): y2 = 2 y exactly, k = rint(y2), and the reduced
// argument pi (y2 - k) in [-pi/2, pi/2], exact but for the product by pi
// (< 2^-24 relative), on the hardware's sin and cos (absolute error
// < 2^-21.4 there), the sign flipped for odd k. A float32 y of ~40 (the
// bench data's angles reach ~250 rad) carries an absolute error of 2 pi
// ulp(y) / 2 ~ 1.5e-5 rad in the plain twin's cos(2 pi y), far above these.
// A NaN y gives NaN for both ((int)k is then 0, the sign +1).
__device__ __forceinline__ void sincos_two_pi(float y, float& S, float& C) {
    const float y2 = 2.0f * y;
    const float k = rintf(y2);
    float s, c;
    __sincosf(3.14159265358979f * (y2 - k), &s, &c);
    const float sign = ((int)k & 1) ? -1.0f : 1.0f;
    S = sign * s;
    C = sign * c;
}

// acc += gv[k] * dK/dst for four elements at once (inputs xi, xj[k]) under
// the pair table st: add_pair_cotangents's arithmetic, with the component
// loop outermost so the four exp and sin/cos chains are independent, the
// exponential on the hardware's ex2 (__expf: a few ulp, plus |x| 2^-24
// relative from scaling x by log2 e, < 1.2e-6 where E > e^-20) and sin/cos
// by sincos_two_pi. Shared by K-lowrank-vjp (csrc/mosm_lowrank_vjp.cu) and
// K-gram-bwd (csrc/mosm_gram_bwd.cuh).
//
// kTau (K-gram-bwd's input half): tau[k][d] += sum_q the cotangent of tau_qd
// of element k, the term summed into dtheta_qd's slot.
template <int Q, int D, bool kTau>
__device__ __forceinline__ void pair_cotangents4(const float (&gv)[4], const float (&xi)[D],
                                                 const float (&xj)[4][D], const float* st,
                                                 float (&acc)[3 * Q * D + 2 * Q],
                                                 float (&tau)[4][D]) {
#pragma unroll
    for (int q = 0; q < Q; ++q) {
        float td[4][D], e[4], a[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            e[k] = a[k] = 0.0f;
#pragma unroll
            for (int d = 0; d < D; ++d) {
                const float* s3 = st + 3 * (q * D + d);
                td[k][d] = (xi[d] - xj[k][d]) + s3[2];
                e[k] += td[k][d] * td[k][d] * s3[0];
                a[k] += td[k][d] * s3[1];
            }
        }
        const float alpha = st[3 * Q * D + 2 * q], dphi = st[3 * Q * D + 2 * q + 1];
        float E[4], S[4], C[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            E[k] = __expf(-0.5f * e[k]);
            sincos_two_pi(a[k] + dphi, S[k], C[k]);
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            const float gE = gv[k] * E[k];
            const float P = alpha * gE;
            const float dang = -P * S[k];
            const float de = -0.5f * P * C[k];
            const float da = kTwoPi * dang;
            acc[3 * Q * D + 2 * q] += gE * C[k];
            acc[3 * Q * D + 2 * q + 1] += kTwoPi * dang;
#pragma unroll
            for (int d = 0; d < D; ++d) {
                const float* s3 = st + 3 * (q * D + d);
                acc[3 * (q * D + d)] += de * td[k][d] * td[k][d];
                acc[3 * (q * D + d) + 1] += da * td[k][d];
                if constexpr (kTau) {
                    const float dt = de * (2.0f * s3[0]) * td[k][d] + da * s3[1];
                    acc[3 * (q * D + d) + 2] += dt;
                    tau[k][d] += dt;
                } else {
                    acc[3 * (q * D + d) + 2] += de * (2.0f * s3[0]) * td[k][d] + da * s3[1];
                }
            }
        }
    }
}

// The four-element chain without the input half (K-lowrank-vjp).
template <int Q, int D>
__device__ __forceinline__ void add_pair_cotangents4(const float (&gv)[4], const float (&xi)[D],
                                                     const float (&xj)[4][D], const float* st,
                                                     float (&acc)[3 * Q * D + 2 * Q]) {
    float tau[4][D];
    pair_cotangents4<Q, D, false>(gv, xi, xj, st, acc, tau);
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

// out[pair] = the sum of the pair's partial rows in float64, in a fixed
// order: thread t sums rows t, t + 256, ... in order, then the block's sums
// meet by warp shuffles and the eight warp sums in order. pairs: (P, 3)
// int32 [pair id, first partial row, row count]. A block a pair: each
// pair's thousands of rows at N = 16,384 in a few loads a thread, where the
// 32-thread pair_reduce_kernel runs each column's rows through one thread.
// K-gram-bwd's and the family kernels' (K-fam-gram-bwd, K-fam-lowrank-vjp),
// K-gram-lowrank-vjp's too; K-lowrank-vjp keeps pair_reduce_kernel's sums.
__global__ void __launch_bounds__(256)
pair_reduce_wide_kernel(const float* __restrict__ partial, const int* __restrict__ pairs,
                        float* __restrict__ out, int nout) {
    __shared__ double wsum[8];
    const int p = blockIdx.x, t = threadIdx.x, lane = t % 32, warp = t / 32;
    const int pair = pairs[3 * p], first = pairs[3 * p + 1], count = pairs[3 * p + 2];
    for (int k = 0; k < nout; ++k) {
        double v = 0.0;
        for (int i = t; i < count; i += 256) v += (double)partial[(int64_t)(first + i) * nout + k];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
        if (lane == 0) wsum[warp] = v;
        __syncthreads();
        if (t == 0) {
            double s = 0.0;
            for (int w = 0; w < 8; ++w) s += wsum[w];
            out[(int64_t)pair * nout + k] = (float)s;
        }
        __syncthreads();
    }
}

}  // namespace
