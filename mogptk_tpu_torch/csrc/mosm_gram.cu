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
// its rate. The element (gram_term, csrc/mosm_gram_element.cuh, shared with
// K-gram-matvec): expf, and cos(2 pi y) after an exact reduction of y by
// whole turns on the hardware's cos (cos_two_pi), so no libm range
// reduction of a ~250 rad argument and its branches run per element;
// K-matvec keeps its full-precision one. Per tile, not per element
// (the tile skeleton, csrc/gram_tile.cuh, which K-fam-gram shares):
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

#include "gram_tile.cuh"
#include "mosm_gram_element.cuh"

namespace {

constexpr int kT = gram_tile::kT;
constexpr int kGThreads = gram_tile::kThreads;
constexpr int kGMaxD = 8;          // input dims of the unrolled instances

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
    __shared__ float stage[kT * gram_tile::kLdS];   // a lower tile, for its mirror
    extern __shared__ float table_s[];
    gram_tile::Tile g;
    gram_tile::begin(g, c1, c2, N, M, lower);
    const int S = 3 * Qr * Dr + 2 * Qr;
    const float* table = stats;
    if (!g.uniform && smem_table) {
        for (int e = g.t; e < O * O * S; e += kGThreads) table_s[e] = stats[e];
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
                xi[k][d] = x1[g.ii[k] * D + d];
                xj[k][d] = x2[g.jj[k] * D + d];
            }
        const int64_t pa = (int64_t)g.ca * O + g.cb;
        if constexpr (Q > 0) {
            if (g.uniform) {
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
                        load_pair(s, table + ((int64_t)g.ci[k] * O + g.cj[m]) * S);
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
                add_component<D>(val, xi, xj, q, Qr, g.uniform, stats, table, pa, g.ci, g.cj, O,
                                 S);
        }
    } else {
        const int cp = g.uniform ? g.ca * O + g.cb : 0;
        for (int k = 0; k < 4; ++k)
            for (int m = 0; m < 4; ++m) {
                const int64_t p = g.uniform ? cp : (int64_t)g.ci[k] * O + g.cj[m];
                val[k][m] = gram_element_rt(table + p * S, x1 + g.ii[k] * Dr, x2 + g.jj[m] * Dr,
                                            Qr, Dr);
            }
    }
    gram_tile::store(g, val, out, N, M, lower, band, stage);
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
