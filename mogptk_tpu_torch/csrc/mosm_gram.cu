// MOSM Gram from channel-pair statistics, for Hopper (sm_90a), float32.
//
// Replaces two Pallas kernels of the JAX package:
//   mogptk_tpu/ops/block_mosm.py  _gram_block_impl (pallas_call at :304),
//     one channel-pair block of the channel-sorted Gram, per launch;
//   mogptk_tpu/ops/pallas_mosm.py _mosm_gram_impl (pallas_call at :207),
//     the Gram for arbitrary channel IDs through per-point one-hot gathers.
// Both compute, per element,
//   K[i,j] = sum_q alpha_q * exp(-1/2 sum_d V_qd tau_d^2) * cos(2 pi (sum_d M_qd tau_d + dphi_q)),
//   tau_d = x1[i,d] - x2[j,d] + dtheta_qd,
// where (V, M, dtheta, alpha, dphi) depend only on the channel pair
// (c1[i], c2[j]) (mosm_pair_stats). mosm_gram_lower_f32 replaces a third,
//   mogptk_tpu/ops/block_mosm.py  mosm_gram_sorted_lower (pallas_call at :437),
// the band-lower Gram of the training path.
//
// Bound: the float32 write, N*M*4 bytes (1.07 GB at N = 16,384: 0.32 ms at
// 3.35 TB/s), against Q exp and Q cos per element with ~20 FP32 operations
// each: the element's instructions, not the special-function units, set
// its rate. The element is this file's own (gram_term): expf, and
// cos(2 pi y) after an exact reduction of y by whole turns on the hardware's
// cos (cos_two_pi), so no libm range reduction of a ~250 rad argument and
// its branches run per element; K-gram-matvec and K-matvec keep
// csrc/mosm_element.cuh's full-precision one. Per tile, not per element:
//   - a block of 256 threads takes a 64 x 64 tile, each thread 4 rows
//     (ty + 16k) x 4 neighbouring columns (4 tx + m), written as one float4
//     per row (a warp is 8 tx x 4 ty, so it writes four full 128-byte rows);
//   - where the tile lies inside one channel pair (channel-sorted data,
//     decided by the block at run time), the pair's statistics sit in
//     registers, one component at a time (the component loop outermost,
//     the thread's 16 elements independent within it); a tile that
//     straddles channels indexes the pair table in shared memory per
//     element;
//   - the lower call (mosm_gram_lower_f32, x1 and x2 the same points with
//     the same channels) evaluates only the lower tiles, I >= J, one block
//     each (a one-dimensional grid over the T (T + 1) / 2 of them), and
//     writes each tile to its place and, where I and J lie in one band-wide
//     diagonal panel, transposed through shared memory to its mirror, both
//     coalesced. A diagonal tile writes its lower triangle to both halves the
//     same way. With band >= N (the square Gram of mosm_gram_sorted, any N)
//     every tile is mirrored and the result is bitwise symmetric; with the
//     blocked Cholesky's band (mosm_gram_sorted_lower) the tiles above the
//     band stay unwritten (undefined), and no block is launched for them.
//     The mirror rests on the pair table's mirror symmetry (V, M and alpha
//     symmetric in (a, b), dtheta and dphi antisymmetric, so K[j, i] =
//     K[i, j] exactly in real arithmetic).
// The cross call (mosm_gram_f32: predict's Kfs, the ops.pallas_mosm surface)
// evaluates every tile.
//
// Instances (ops/mosm_gram.kernel_instance("forward", ...) chooses
// "unrolled" or "generic"): unrolled with D <= 8 compiled in (x and each
// component's statistics in registers), the pair table in shared memory (at
// most 48 KB); within it, Q <= 4 and D <= 2 (the bench model's Q = 2, D = 1)
// also compile Q in, the pair's whole statistics in registers and each
// element's components unrolled (the component-outermost runtime loop of the
// other shapes took more than twice as long at the bench shapes on an H100:
// PERF.md). The generic instance loops over a runtime D, reads x in place and
// the pair table from global memory. A call of the unrolled instance with a
// shape it lacks is refused.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kTwoPiF = 6.283185307179586f;
constexpr int kT = 64;             // a block's tile edge
constexpr int kGThreads = 256;     // 16 x 16 threads, 4 x 4 elements each
constexpr int kLdS = kT + 1;       // the staged tile's row stride (banks r + c)
constexpr int kGMaxD = 8;          // input dims of the unrolled instances


// cos(2 pi y): r = y - rint(y) exactly (|r| <= 1/2; rint by adding and
// subtracting 1.5 * 2^23, exact for |y| < 2^22, on the FP32 pipes), then the
// hardware's cos of 2 pi r in [-pi, pi] (absolute error < 2^-21.4 there,
// plus 2^-24 relative from the product). A float32 y of ~40 (the bench
// data's angles reach ~250 rad) carries an absolute error of ~1.5e-5 rad in
// the plain twin's cos(2 pi y), far above these. NaN or inf gives NaN.
__device__ __forceinline__ float cos_two_pi(float y) {
    const float kRound = 12582912.0f;
    const float r = __fsub_rn(y, __fsub_rn(__fadd_rn(y, kRound), kRound));
    return __cosf(kTwoPiF * r);
}

// Component q's statistics of one pair, [V, M, dtheta] x d, then alpha and
// dphi, from the pair's row p of the table (ops/mosm_gram.stats_table:
// [V, M, dtheta] x (q, d), then [alpha, dphi] x q).
template <int D>
struct CompStats {
    float v[D], m[D], th[D], al, ph;
};

template <int D>
__device__ __forceinline__ void load_comp(CompStats<D>& s, const float* p, int q, int Q) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
        s.v[d] = p[3 * (q * D + d)];
        s.m[d] = p[3 * (q * D + d) + 1];
        s.th[d] = p[3 * (q * D + d) + 2];
    }
    s.al = p[3 * Q * D + 2 * q];
    s.ph = p[3 * Q * D + 2 * q + 1];
}

// Component q's term of the element: e and the angle's turns y = dphi +
// sum_d M tau_d in the plain twin's order and rounding, exp(-1/2 e) by expf
// (the hardware's ex2 after a two-part product by log2(e): within ~2 ulp, as
// the twin's), and cos(2 pi y) by cos_two_pi. The element, these terms
// summed over q in order from 0, then differs from the twin's only where the
// twin rounds 2 pi y (~1.5e-5 rad at y ~ 40) and by the hardware cos's
// 2^-21.4: closer to the exact value. (ex2.approx of a once-rounded
// product, or an argument summed by FMAs, drifted far enough from the
// twin's rounding that a sparse model's first-step gradient left the
// float64 check's bound: chip_smoke.py phase 15, SparseHensman.)
template <int D>
__device__ __forceinline__ float gram_term(const CompStats<D>& s, const float (&xi)[D],
                                           const float (&xj)[D]) {
    float e = 0.0f, a = 0.0f;
#pragma unroll
    for (int d = 0; d < D; ++d) {
        const float td = (xi[d] - xj[d]) + s.th[d];
        e += td * td * s.v[d];
        a += td * s.m[d];
    }
    return s.al * expf(-0.5f * e) * cos_two_pi(a + s.ph);
}

// val[k][m] += component q's term of the thread's 16 elements (Q components
// in all): uniform, from the pair (ca, cb)'s row of stats; else each from
// its own pair's row of table.
template <int D>
__device__ __forceinline__ void add_component(float (&val)[4][4], const float (&xi)[4][D],
                                              const float (&xj)[4][D], int q, int Q,
                                              bool uniform, const float* stats,
                                              const float* table, int64_t pa, const int (&ci)[4],
                                              const int (&cj)[4], int O, int S) {
    if (uniform) {
        CompStats<D> s;
        load_comp(s, stats + pa * S, q, Q);
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
            for (int m = 0; m < 4; ++m) val[k][m] += gram_term(s, xi[k], xj[m]);
    } else {
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
            for (int m = 0; m < 4; ++m) {
                CompStats<D> s;
                load_comp(s, table + ((int64_t)ci[k] * O + cj[m]) * S, q, Q);
                val[k][m] += gram_term(s, xi[k], xj[m]);
            }
    }
}

// With Q compiled in: a pair's whole statistics, and the element, its
// component terms summed in order from 0.
template <int Q, int D>
__device__ __forceinline__ void load_pair(CompStats<D> (&s)[Q], const float* p) {
#pragma unroll
    for (int q = 0; q < Q; ++q) load_comp(s[q], p, q, Q);
}

template <int Q, int D>
__device__ __forceinline__ float gram_element(const CompStats<D> (&s)[Q], const float (&xi)[D],
                                              const float (&xj)[D]) {
    float k = 0.0f;
#pragma unroll
    for (int q = 0; q < Q; ++q) k += gram_term(s[q], xi, xj);
    return k;
}

// The whole element for a runtime D, p the pair's row of the table.
__device__ __forceinline__ float gram_element_rt(const float* p, const float* xi, const float* xj,
                                                 int Q, int D) {
    float k = 0.0f;
    for (int q = 0; q < Q; ++q) {
        float e = 0.0f, a = 0.0f;
        for (int d = 0; d < D; ++d) {
            const float* s3 = p + 3 * (q * D + d);
            const float td = (xi[d] - xj[d]) + s3[2];
            e += td * td * s3[0];
            a += td * s3[1];
        }
        const float* s2 = p + 3 * Q * D + 2 * q;
        k += s2[0] * expf(-0.5f * e) * cos_two_pi(a + s2[1]);
    }
    return k;
}

// Tile (I, J) of block b of the lower call's tiles, row-major:
// b = I (I + 1) / 2 + J, J <= I.
__device__ __forceinline__ void lower_tile(int64_t b, int64_t& I, int64_t& J) {
    I = (int64_t)((sqrt(8.0 * (double)b + 1.0) - 1.0) * 0.5);
    while (I * (I + 1) / 2 > b) --I;
    while ((I + 1) * (I + 2) / 2 <= b) ++I;
    J = b - I * (I + 1) / 2;
}

// D > 0: D compiled in, with Q > 0 also Q (gram_element), with Q == 0 the
// runtime Qr (add_component); D == 0: runtime Qr and Dr. smem_table: the
// pair table (O*O*S floats) is copied to shared memory for tiles that
// straddle channels; else it is read where it lies.
template <int Q, int D>
__global__ void __launch_bounds__(kGThreads)
mosm_gram_kernel(const float* __restrict__ x1, const int* __restrict__ c1,
                 const float* __restrict__ x2, const int* __restrict__ c2,
                 const float* __restrict__ stats, bool smem_table, float* __restrict__ out,
                 int64_t N, int64_t M, int O, int Qr, int Dr, bool lower, int64_t band) {
    __shared__ float stage[kT * kLdS];   // a lower tile, [row][column], for its mirror
    extern __shared__ float table_s[];
    int64_t I, J;
    if (lower) {
        lower_tile(blockIdx.x, I, J);
    } else {
        I = blockIdx.y;
        J = blockIdx.x;
    }
    const int t = threadIdx.x, warp = t / 32, lane = t % 32;
    const int tx = lane % 8 + 8 * (warp % 2), ty = lane / 8 + 4 * (warp / 2);
    const int64_t row0 = I * kT, col0 = J * kT;
    const int S = 3 * Qr * Dr + 2 * Qr;
    // the thread's rows and columns, clamped into range (only written in range)
    int64_t ii[4], jj[4];
    int ci[4], cj[4];
    const int ca = c1[row0], cb = c2[col0];
    bool one_pair = true;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        ii[k] = min(row0 + ty + 16 * k, N - 1);
        jj[k] = min(col0 + 4 * tx + k, M - 1);
        ci[k] = c1[ii[k]];
        cj[k] = c2[jj[k]];
        one_pair = one_pair && ci[k] == ca && cj[k] == cb;
    }
    const bool uniform = __syncthreads_and(one_pair);
    const float* table = stats;
    if (!uniform && smem_table) {
        for (int e = t; e < O * O * S; e += kGThreads) table_s[e] = stats[e];
        __syncthreads();
        table = table_s;
    }

    float val[4][4];
    if constexpr (D > 0) {
        float xi[4][D], xj[4][D];
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
            for (int d = 0; d < D; ++d) {
                xi[k][d] = x1[ii[k] * D + d];
                xj[k][d] = x2[jj[k] * D + d];
            }
        const int64_t pa = (int64_t)ca * O + cb;
        if constexpr (Q > 0) {
            if (uniform) {
                CompStats<D> s[Q];
                load_pair(s, stats + pa * S);
#pragma unroll
                for (int k = 0; k < 4; ++k)
#pragma unroll
                    for (int m = 0; m < 4; ++m) val[k][m] = gram_element(s, xi[k], xj[m]);
            } else {
#pragma unroll
                for (int k = 0; k < 4; ++k)
#pragma unroll
                    for (int m = 0; m < 4; ++m) {
                        CompStats<D> s[Q];
                        load_pair(s, table + ((int64_t)ci[k] * O + cj[m]) * S);
                        val[k][m] = gram_element(s, xi[k], xj[m]);
                    }
            }
        } else {
            // component-outermost, the 16 elements' terms of one component
            // independent of each other
#pragma unroll
            for (int k = 0; k < 4; ++k)
#pragma unroll
                for (int m = 0; m < 4; ++m) val[k][m] = 0.0f;
            for (int q = 0; q < Qr; ++q)
                add_component<D>(val, xi, xj, q, Qr, uniform, stats, table, pa, ci, cj, O, S);
        }
    } else {
        const int cp = uniform ? ca * O + cb : 0;
        for (int k = 0; k < 4; ++k)
            for (int m = 0; m < 4; ++m) {
                const int64_t p = uniform ? cp : (int64_t)ci[k] * O + cj[m];
                val[k][m] = gram_element_rt(table + p * S, x1 + ii[k] * Dr, x2 + jj[m] * Dr, Qr,
                                            Dr);
            }
    }

    // float4 rows where the whole tile is in range and rows are 16-byte aligned
    const bool vec = row0 + kT <= N && col0 + kT <= M && M % 4 == 0;
    // the lower call: a diagonal tile, its lower triangle to both halves; an
    // off-diagonal one inside a band-wide diagonal panel, its mirror too
    const bool diag = lower && I == J;
    const bool mirror = lower && I * kT / band == J * kT / band;
    if (!diag) {   // the tile in its place
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            const int64_t i = row0 + ty + 16 * k, j = col0 + 4 * tx;
            if (vec) {
                *reinterpret_cast<float4*>(out + i * M + j) =
                    make_float4(val[k][0], val[k][1], val[k][2], val[k][3]);
            } else if (i < N) {
#pragma unroll
                for (int m = 0; m < 4; ++m)
                    if (j + m < M) out[i * M + j + m] = val[k][m];
            }
        }
    }
    if (!mirror) return;
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int m = 0; m < 4; ++m) stage[(ty + 16 * k) * kLdS + 4 * tx + m] = val[k][m];
    __syncthreads();
    // I != J: the mirror tile (J, I), its element (r, c) = stage[c][r];
    // I == J: the tile's element (r, c) from the lower triangle
    const int64_t r0 = I != J ? col0 : row0, q0 = I != J ? row0 : col0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        const int r = ty + 16 * k;
        float w[4];
#pragma unroll
        for (int m = 0; m < 4; ++m) {
            const int c = 4 * tx + m;
            w[m] = (I != J || c > r) ? stage[c * kLdS + r] : stage[r * kLdS + c];
        }
        const int64_t i = r0 + r, j = q0 + 4 * tx;
        if (vec) {
            *reinterpret_cast<float4*>(out + i * M + j) = make_float4(w[0], w[1], w[2], w[3]);
        } else if (i < N) {
#pragma unroll
            for (int m = 0; m < 4; ++m)
                if (j + m < M) out[i * M + j + m] = w[m];
        }
    }
}

int launch_gram(const float* x1, const int* c1, const float* x2, const int* c2,
                const float* stats, float* out, int64_t N, int64_t M, int O, int Q, int D,
                bool lower, int64_t band, int generic, cudaStream_t stream) {
    if (D < 1 || Q < 1 || O < 1) return (int)cudaErrorInvalidValue;
    if (!generic && D > kGMaxD) return (int)cudaErrorInvalidValue;
    if (N == 0 || M == 0) return 0;
    const size_t table = sizeof(float) * (size_t)O * O * (3 * Q * D + 2 * Q);
    const bool smem_table = !generic;
    if (smem_table && table > 48 * 1024) return (int)cudaErrorInvalidValue;
    const size_t smem = smem_table ? table : 0;
    const int64_t tr = (N + kT - 1) / kT, tc = (M + kT - 1) / kT;
    const dim3 grid =
        lower ? dim3((unsigned)(tr * (tr + 1) / 2)) : dim3((unsigned)tc, (unsigned)tr);
    cudaError_t err = cudaSuccess;
#define MOGPTK_GRAM_CASE(q, d)                                                                \
    if (!generic && (q == 0 || Q == q) && D == d) {                                           \
        err = cudaFuncSetAttribute(mosm_gram_kernel<q, d>,                                     \
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);   \
        if (err != cudaSuccess) return (int)err;                                              \
        mosm_gram_kernel<q, d><<<grid, kGThreads, smem, stream>>>(                            \
            x1, c1, x2, c2, stats, smem_table, out, N, M, O, Q, D, lower, band);               \
        return (int)cudaGetLastError();                                                       \
    }
    MOGPTK_GRAM_CASE(1, 1) MOGPTK_GRAM_CASE(2, 1) MOGPTK_GRAM_CASE(3, 1) MOGPTK_GRAM_CASE(4, 1)
    MOGPTK_GRAM_CASE(1, 2) MOGPTK_GRAM_CASE(2, 2) MOGPTK_GRAM_CASE(3, 2) MOGPTK_GRAM_CASE(4, 2)
    MOGPTK_GRAM_CASE(0, 1) MOGPTK_GRAM_CASE(0, 2) MOGPTK_GRAM_CASE(0, 3) MOGPTK_GRAM_CASE(0, 4)
    MOGPTK_GRAM_CASE(0, 5) MOGPTK_GRAM_CASE(0, 6) MOGPTK_GRAM_CASE(0, 7) MOGPTK_GRAM_CASE(0, 8)
#undef MOGPTK_GRAM_CASE
    err = cudaFuncSetAttribute(mosm_gram_kernel<0, 0>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    mosm_gram_kernel<0, 0><<<grid, kGThreads, smem, stream>>>(x1, c1, x2, c2, stats, smem_table,
                                                              out, N, M, O, Q, D, lower, band);
    return (int)cudaGetLastError();
}

}  // namespace

// (N, M) Gram of x1 (N, D), c1 (N,) against x2 (M, D), c2 (M,), every tile.
// generic: 0 for the unrolled instance (D <= 8), 1 for the generic one.
extern "C" int mosm_gram_f32(const float* x1, const int* c1, const float* x2, const int* c2,
                             const float* stats, float* out, int64_t N, int64_t M,
                             int O, int Q, int D, int generic, cudaStream_t stream) {
    return launch_gram(x1, c1, x2, c2, stats, out, N, M, O, Q, D, false, 1, generic, stream);
}

// (N, N) Gram of x (N, D), c (N,) against itself, the lower tiles only,
// each mirrored where it lies in a band-wide diagonal panel. band >= N: the
// whole Gram, bitwise symmetric, any N; else band a multiple of 64 that
// divides N, and the tiles above the band are left unwritten.
extern "C" int mosm_gram_lower_f32(const float* x, const int* c, const float* stats, float* out,
                                   int64_t N, int O, int Q, int D, int64_t band, int generic,
                                   cudaStream_t stream) {
    if (band < 1 || (band < N && (band % kT || N % band))) return (int)cudaErrorInvalidValue;
    return launch_gram(x, c, x, c, stats, out, N, N, O, Q, D, true, band, generic, stream);
}
