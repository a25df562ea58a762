// K-fam-gram: the Gram of a non-MOSM multi-output family (uMOSM, CSM, CONV,
// MOHSM, SM-LMC) from its channel-pair scalar pack, for Hopper (sm_90a),
// float32.
//
// Replaces the forward Pallas kernel of the JAX package's family engine,
//   mogptk_tpu/ops/block_families.py  _block_impl / _fwd_kernel (pallas_call
//     at :392), one channel-pair block of the channel-sorted Gram per launch,
//     the lower blocks assembled as transposes of the upper ones,
// and, for the families, mogptk_tpu/ops/fused.py fused_gram (pallas_call at
// :386), the Gram for any channel IDs (the iterative engine's pivot rows and
// predict's cross blocks). Per element the S scalars are those of the pair
// (c1[i], c2[j]) (the pack in ops/block_families.family_pack), so one launch
// covers all of N x M for any channel order.
//
// Bound: the (N, M) float32 write (1.07 GB at N = 16,384: 0.32 ms at
// 3.35 TB/s), against one exp and one cos per element (per component for
// CSM; Q D of each for SM-LMC) with ~10-30 FP32 operations: as K-gram, the
// element's instructions set the rate unless each element is evaluated
// once and cheaply. The design is K-gram's (csrc/mosm_gram.cu), on the tile
// skeleton the two share (csrc/gram_tile.cuh):
//   - 64 x 64 tiles of 256 threads, 4 x 4 elements a thread, rows written
//     as float4;
//   - the square call (family_gram_square_f32: x1 and x2 the same points
//     with the same channels, the training Gram) evaluates only the lower
//     tiles, one block each, and writes each to its place and, transposed
//     through shared memory, to its mirror: half the elements, and a Gram
//     that is bitwise symmetric for any N. The mirror rests on the pair
//     swap, K(xi, xj; pack[a, b]) = K(xj, xi; pack[b, a]) (the
//     antisymmetric scalars dtheta, dphi and CSM's shift flip sign with
//     tau); the JAX package's transposed lower blocks rest on the same;
//   - the cross call (family_gram_f32: predict's blocks, the pivot rows)
//     evaluates every tile;
//   - a tile inside one channel pair (channel-sorted data, decided by the
//     block at run time) keeps that pair's S scalars in registers; a tile
//     that straddles channels reads each element's pair from the table, in
//     shared memory where it fits in 48 KB;
//   - the element (GramElement) is Family::value's formula
//     (csrc/family_element.cuh, the plain twins' _VALUE) on expf, with CSM's
//     and SM-LMC's cosine of an angle in turns (CSM's a + s_r, SM-LMC's
//     tau mu_qd, formed in the twin's order) by an exact reduction by whole
//     turns and the hardware's cos (gram_tile.cuh cos_two_pi), no libm
//     range reduction; uMOSM's and MOHSM's angle, 2 pi a + dphi, is in
//     radians, and keeps cosf (the backward kernels keep sincosf there for
//     the same reason: csrc/family_pair_vjp.cuh HardwareMath).
//     Family::value itself stays as it is for K-fam-matvec's fold.
// Instances: the (family, D, A) of MOGPTK_FAMILY_UNROLLED with D and A
// compiled in (x, the pair's scalars and the component loops in registers),
// and one generic instance per family for any D and A (runtime loops, x read
// in place).
#include <cuda_runtime.h>
#include <stdint.h>

#include "family_element.cuh"
#include "gram_tile.cuh"

namespace {

constexpr int kMaxTableBytes = 48 * 1024;

using gram_tile::cos_two_pi;

// K-fam-gram's element: Family<F, kD, kA>::value but for CSM's and
// SM-LMC's cosine, cos_two_pi of the angle in turns.
template <int F, int kD, int kA>
struct GramElement {
    static __device__ __forceinline__ float value(const float* s, const float* xi,
                                                  const float* xj, int D, int A) {
        return Family<F, kD, kA>::value(s, xi, xj, D, A);
    }
};

template <int kD, int kA>
struct GramElement<kCsm, kD, kA> {
    static __device__ __forceinline__ float value(const float* s, const float* xi,
                                                  const float* xj, int D_, int A_) {
        const int D = kD ? kD : D_;
        const int A = kA ? kA : A_;
        float e = 0.0f, a = 0.0f;
#pragma unroll
        for (int d = 0; d < D; ++d) {
            const float tau = xi[d] - xj[d];
            e += tau * tau * s[d];
            a += tau * s[D + d];
        }
        const float E = expf(-0.5f * e);
        float k = 0.0f;
#pragma unroll
        for (int r = 0; r < A; ++r) k += s[2 * D + r] * E * cos_two_pi(a + s[2 * D + A + r]);
        return k;
    }
};

template <int kD, int kA>
struct GramElement<kLmcSm, kD, kA> {
    static __device__ __forceinline__ float value(const float* s, const float* xi,
                                                  const float* xj, int D_, int A_) {
        const int D = kD ? kD : D_;
        const int A = kA ? kA : A_;
        float k = 0.0f;
#pragma unroll
        for (int q = 0; q < A; ++q) {
            float acc = 0.0f;
#pragma unroll
            for (int d = 0; d < D; ++d) {
                const float tau = xi[d] - xj[d];
                acc += expf(-kFamTwoPiSq * tau * tau * s[A + q * D + d])
                       * cos_two_pi(tau * s[A + A * D + q * D + d]);
            }
            k += s[q] * acc;
        }
        return k;
    }
};

// kD > 0: the unrolled instance (D and A compiled in, kS scalars a pair);
// kD == 0: the generic one. smem_table: the O*O*S pair table is copied to
// shared memory for tiles that straddle channels; else it is read where it
// lies. lower: the square call's lower tiles, each mirrored.
template <int F, int kD, int kA>
__global__ void __launch_bounds__(gram_tile::kThreads)
family_gram_kernel(const float* __restrict__ x1, const int* __restrict__ c1,
                   const float* __restrict__ x2, const int* __restrict__ c2,
                   const float* __restrict__ stats, bool smem_table, float* __restrict__ out,
                   int64_t N, int64_t M, int O, int S, int D, int A, bool lower) {
    __shared__ float stage[gram_tile::kT * gram_tile::kLdS];   // a lower tile, for its mirror
    extern __shared__ float table_s[];
    gram_tile::Tile g;
    gram_tile::begin(g, c1, c2, N, M, lower);
    const float* table = stats;
    if (!g.uniform && smem_table) {
        for (int e = g.t; e < O * O * S; e += gram_tile::kThreads) table_s[e] = stats[e];
        __syncthreads();
        table = table_s;
    }
    const int64_t pa = (int64_t)g.ca * O + g.cb;
    float val[4][4];
    if constexpr (kD > 0) {
        constexpr int kS = family_slots(F, kD, kA);
        float xi[4][kD], xj[4][kD];
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
            for (int d = 0; d < kD; ++d) {
                xi[k][d] = x1[g.ii[k] * kD + d];
                xj[k][d] = x2[g.jj[k] * kD + d];
            }
        if (g.uniform) {
            float s[kS];
#pragma unroll
            for (int k = 0; k < kS; ++k) s[k] = stats[pa * kS + k];
#pragma unroll
            for (int k = 0; k < 4; ++k)
#pragma unroll
                for (int m = 0; m < 4; ++m)
                    val[k][m] = GramElement<F, kD, kA>::value(s, xi[k], xj[m], kD, kA);
        } else {
#pragma unroll
            for (int k = 0; k < 4; ++k)
#pragma unroll
                for (int m = 0; m < 4; ++m)
                    val[k][m] = GramElement<F, kD, kA>::value(
                        table + ((int64_t)g.ci[k] * O + g.cj[m]) * kS, xi[k], xj[m], kD, kA);
        }
    } else {
        for (int k = 0; k < 4; ++k)
            for (int m = 0; m < 4; ++m) {
                const int64_t p = g.uniform ? pa : (int64_t)g.ci[k] * O + g.cj[m];
                val[k][m] = GramElement<F, 0, 0>::value(table + p * S, x1 + g.ii[k] * D,
                                                        x2 + g.jj[m] * D, D, A);
            }
    }
    gram_tile::store(g, val, out, N, M, lower, N, stage);
}

template <int F, int kD, int kA>
int launch_instance(const float* x1, const int* c1, const float* x2, const int* c2,
                    const float* stats, float* out, int64_t N, int64_t M, int O, int S, int D,
                    int A, bool lower, cudaStream_t stream) {
    const size_t table = sizeof(float) * (size_t)O * O * S;
    const bool smem_table = table <= kMaxTableBytes;
    const size_t smem = smem_table ? table : 0;
    const int64_t tr = (N + gram_tile::kT - 1) / gram_tile::kT;
    const int64_t tc = (M + gram_tile::kT - 1) / gram_tile::kT;
    const dim3 grid =
        lower ? dim3((unsigned)(tr * (tr + 1) / 2)) : dim3((unsigned)tc, (unsigned)tr);
    cudaError_t err = cudaFuncSetAttribute(family_gram_kernel<F, kD, kA>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    family_gram_kernel<F, kD, kA><<<grid, gram_tile::kThreads, smem, stream>>>(
        x1, c1, x2, c2, stats, smem_table, out, N, M, O, S, D, A, lower);
    return (int)cudaGetLastError();
}

int launch(const float* x1, const int* c1, const float* x2, const int* c2, const float* stats,
           float* out, int64_t N, int64_t M, int O, int S, int D, int A, int fam, bool lower,
           cudaStream_t stream) {
    if (D < 1 || O < 1 || ((fam == kCsm || fam == kLmcSm) && A < 1) ||
        S != family_slots(fam, D, A))
        return (int)cudaErrorInvalidValue;
    if (N == 0 || M == 0) return 0;
#define MOGPTK_GRAM_INSTANCE(F, d, a)                                                         \
    if (fam == F && D == d && (a == 0 || A == a))                                             \
        return launch_instance<F, d, a>(x1, c1, x2, c2, stats, out, N, M, O, S, D, A, lower,  \
                                        stream);
    MOGPTK_FAMILY_UNROLLED(MOGPTK_GRAM_INSTANCE)
#undef MOGPTK_GRAM_INSTANCE
    switch (fam) {
        case kUmosm:
            return launch_instance<kUmosm, 0, 0>(x1, c1, x2, c2, stats, out, N, M, O, S, D, A,
                                                 lower, stream);
        case kCsm:
            return launch_instance<kCsm, 0, 0>(x1, c1, x2, c2, stats, out, N, M, O, S, D, A,
                                               lower, stream);
        case kConv:
            return launch_instance<kConv, 0, 0>(x1, c1, x2, c2, stats, out, N, M, O, S, D, A,
                                                lower, stream);
        case kMohsm:
            return launch_instance<kMohsm, 0, 0>(x1, c1, x2, c2, stats, out, N, M, O, S, D, A,
                                                 lower, stream);
        case kLmcSm:
            return launch_instance<kLmcSm, 0, 0>(x1, c1, x2, c2, stats, out, N, M, O, S, D, A,
                                                 lower, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

// out (N, M) = the family's Gram for x1 (N, D) with channel IDs c1 (N,),
// x2 (M, D) with c2 (M,), all row-major, every tile; stats is the (O*O, S)
// pair table. fam: the FamilyId; A: CSM's Rq, SM-LMC's Q, else 0.
extern "C" int family_gram_f32(const float* x1, const int* c1, const float* x2, const int* c2,
                               const float* stats, float* out, int64_t N, int64_t M, int O,
                               int S, int D, int A, int fam, cudaStream_t stream) {
    return launch(x1, c1, x2, c2, stats, out, N, M, O, S, D, A, fam, false, stream);
}

// out (N, N) = the family's Gram of x (N, D), c (N,) against itself: the
// lower tiles, each written to its place and its mirror (bitwise symmetric).
extern "C" int family_gram_square_f32(const float* x, const int* c, const float* stats,
                                      float* out, int64_t N, int O, int S, int D, int A, int fam,
                                      cudaStream_t stream) {
    return launch(x, c, x, c, stats, out, N, N, O, S, D, A, fam, true, stream);
}
