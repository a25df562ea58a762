// K-fam-gram-bwd: the cotangent of a non-MOSM family's pair pack for a
// dense cotangent g (N, M) of its Gram, for Hopper (sm_90a), float32: the
// backward of csrc/family_gram.cu.
//
// Replaces the backward Pallas kernel of the JAX package's family engine,
//   mogptk_tpu/ops/block_families.py  _gram_block_bwd / _bwd_kernel
//     (pallas_call at :431), one channel-pair block per launch, whose
//     in-kernel jax.vjp over the pair's S scalars was summed over the TPU's
//     sequential grid:
//   dpack[a, b, k] = sum over (i, j) with (c1[i], c2[j]) = (a, b) of g_ij dK_ij/ds_k.
// The inputs' cotangents are zero, as in the JAX package (training inputs
// are constant); autograd chains dpack through the family's pack function.
//
// Layout, as K-gram-bwd's (csrc/mosm_gram_bwd.cu, whose load_tile this
// reuses): rows and columns are laid out channel by channel, each channel
// padded to a multiple of 256 (ops/mosm_gram._gram_layout), rmap and cmap
// give the row (column) of g at each laid-out position, -1 for padding, and
// a host list names every 256^2 tile of every present channel pair, grouped
// by pair. For channel-sorted data with channels that are multiples of 256
// the maps are the identity and g is read in place.
//
// Bound: the read of g, N*M*4 bytes (1.07 GB at N = 16,384), against one
// exp and one sincos per element (per component for CSM; Q D of each for
// SM-LMC) and ~4 FMAs per scalar of the pack. Design: a block takes a
// 128 x 128 quarter of a tile, 256 threads of 8 x 8 elements (rows ty + 16u,
// columns tx + 16v), so 16 neighbouring threads read 16 neighbouring
// columns; each thread loads its 64 values of g first, then runs the
// element derivatives (csrc/family_pair_vjp.cuh). Blocks run in no order,
// so nothing carries over between them as it did across the TPU's grid:
// each block writes its S partial sums (a fixed-order reduction), and a
// second kernel sums each pair's partials in a fixed order in float64. No
// atomics: a repeated call is bit-identical.
#include "family_pair_vjp.cuh"
#include "mosm_gram_bwd.cuh"

namespace {

template <int F, int kD, int kA>
__global__ void __launch_bounds__(kThreads)
family_gram_bwd_kernel(const int* __restrict__ idx, const float* __restrict__ g, int64_t M,
                       const float* __restrict__ x1, const int* __restrict__ rmap,
                       const float* __restrict__ x2, const int* __restrict__ cmap,
                       const float* __restrict__ stats, float* __restrict__ partial, int S) {
    int ri[kMicro], cj[kMicro], pair;
    float gt[kMicro][kMicro];
    load_tile(idx, g, M, rmap, cmap, ri, cj, gt, pair);
    float xi[kMicro][kD], xj[kMicro][kD];
#pragma unroll
    for (int u = 0; u < kMicro; ++u)
#pragma unroll
        for (int d = 0; d < kD; ++d) {
            xi[u][d] = ri[u] >= 0 ? x1[(int64_t)ri[u] * kD + d] : 0.0f;
            xj[u][d] = cj[u] >= 0 ? x2[(int64_t)cj[u] * kD + d] : 0.0f;
        }
    family_tile_unrolled<F, kD, kA>(gt, xi, xj, stats + (int64_t)pair * S,
                                    partial + (int64_t)blockIdx.x * S);
}

template <int F>
__global__ void __launch_bounds__(kThreads)
family_gram_bwd_generic_kernel(const int* __restrict__ idx, const float* __restrict__ g,
                               int64_t M, const float* __restrict__ x1,
                               const int* __restrict__ rmap, const float* __restrict__ x2,
                               const int* __restrict__ cmap, const float* __restrict__ stats,
                               float* __restrict__ partial, int S, int D, int A) {
    int ri[kMicro], cj[kMicro], pair;
    float gt[kMicro][kMicro];
    load_tile(idx, g, M, rmap, cmap, ri, cj, gt, pair);
    // padded positions (g = 0 there) read row 0: any finite inputs will do
    const float* xr[kMicro];
    const float* xc[kMicro];
#pragma unroll
    for (int u = 0; u < kMicro; ++u) {
        xr[u] = x1 + (int64_t)(ri[u] >= 0 ? ri[u] : 0) * D;
        xc[u] = x2 + (int64_t)(cj[u] >= 0 ? cj[u] : 0) * D;
    }
    family_tile_generic<F>(gt, xr, xc, stats + (int64_t)pair * S, S, D, A,
                           partial + (int64_t)blockIdx.x * S);
}

}  // namespace

// idx (T, 3) int32 tiles [ti, tj, pair]; g (N, M) row-major; x1 (N, D),
// rmap (Np,) int32, x2 (M, D), cmap (Mp,) int32, Np and Mp multiples of 256;
// stats (O*O, S) the pair table; partial (4T, S) scratch; pairs (P, 3)
// int32 [pair, first partial row, rows]; out (O*O, S), rows of absent pairs
// left as given. fam: the FamilyId; A: CSM's Rq, SM-LMC's Q, else 0.
extern "C" int family_gram_bwd_f32(const int* idx, const float* g, const float* x1,
                                   const int* rmap, const float* x2, const int* cmap,
                                   const float* stats, float* partial, const int* pairs,
                                   float* out, int T, int P, int64_t M, int S, int D, int A,
                                   int fam, cudaStream_t stream) {
    if (D < 1 || ((fam == kCsm || fam == kLmcSm) && A < 1) || fam < 0 || fam > kLmcSm ||
        S != family_slots(fam, D, A))
        return (int)cudaErrorInvalidValue;
    if (T == 0) return 0;
    const unsigned blocks = (unsigned)(4 * T);
    bool launched = false;
#define MOGPTK_CASE(f, d, a)                                                                 \
    if (!launched && fam == f && D == d && A == a) {                                         \
        family_gram_bwd_kernel<f, d, a><<<blocks, kThreads, 0, stream>>>(                    \
            idx, g, M, x1, rmap, x2, cmap, stats, partial, S);                               \
        launched = true;                                                                     \
    }
    MOGPTK_FAMILY_UNROLLED(MOGPTK_CASE)
#undef MOGPTK_CASE
#define MOGPTK_GENERIC(f)                                                                    \
    if (!launched && fam == f) {                                                             \
        family_gram_bwd_generic_kernel<f><<<blocks, kThreads, 0, stream>>>(                  \
            idx, g, M, x1, rmap, x2, cmap, stats, partial, S, D, A);                         \
        launched = true;                                                                     \
    }
    MOGPTK_GENERIC(kUmosm) MOGPTK_GENERIC(kCsm) MOGPTK_GENERIC(kConv) MOGPTK_GENERIC(kMohsm)
    MOGPTK_GENERIC(kLmcSm)
#undef MOGPTK_GENERIC
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    pair_reduce_kernel<<<(unsigned)P, 32, 0, stream>>>(partial, pairs, out, S);
    return (int)cudaGetLastError();
}
