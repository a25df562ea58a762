// K-fam-matvec: out = K(x, x) · V for the Gram of a non-MOSM multi-output
// family (uMOSM, CSM, CONV, MOHSM, SM-LMC), without ever forming K. For
// Hopper (sm_90a), float32.
//
// Replaces the Pallas matvec of the JAX package's family engine,
//   mogptk_tpu/ops/block_families.py  family_matvec_sorted (pallas_call at
//     :504 for the diagonal channel pairs, :525 for the off-diagonal ones;
//     kernels _matvec_diag_kernel and _matvec_offdiag_kernel), the
//     channel-sorted matvec of the iterative engine's CG and Lanczos,
// and, for the families, mogptk_tpu/ops/fused.py fused_gram_matvec
// (pallas_call at :288), the same product for any channel IDs (the engine
// sorts the rows by channel first). Per element the S scalars of the pair
// (c[i], c[j]) (csrc/family_element.cuh, K-fam-gram's element).
//
// Bound: operations. Each element costs one exp and one cos (per component
// for CSM; Q D of each for SM-LMC) and a few FP32 operations per input dim,
// and 2R more for the product, while the bytes are O(N (D + R)). Design:
// K-matvec's fold (matvec_fold.cuh). K(x, x) is symmetric in every family
// (the pair-swapped scalars Δθ, Δφ and CSM's s_r flip sign with τ, the
// others are symmetric), so each 128 x 128 tile of the upper triangle of the
// tile grid is evaluated once and used for G . V[J] and G^T . V[I], as the
// TPU kernel's _matvec_offdiag_kernel did; the products run on the tensor
// cores as 3xTF32 mma.sync, and the partial slabs go to K-matvec's second
// pass (csrc/mosm_matvec.cu mosm_matvec_reduce_f32), which sums them in a
// fixed order: repeats are bit-identical. The pair table is read from
// global memory through the read-only path (it is O^2 S floats, 96 for the
// bench CSM, and stays in L1), so a CTA's shared memory is the fold's alone
// and two CTAs fit on an SM for every O and S. Two instances per family: the
// input-dim loop unrolled for D = 1, and at the runtime D otherwise (SM-LMC's
// element is a sum over d, the others' a product of per-d factors: both are
// family_element.cuh's value).
#include <cuda_runtime.h>
#include <stdint.h>

#include "family_element.cuh"
#include "matvec_fold.cuh"

namespace {

// the family's element for the fold: four independent value() chains,
// which the scheduler interleaves once inlined
template <int F, int kD>
struct FamilyFold {
    static constexpr bool kTableInSmem = false;
    static __device__ __forceinline__ void eval4(const float* const (&p)[4],
                                                 const float* const (&xi)[4],
                                                 const float* const (&xj)[4], int D, int A,
                                                 float (&k)[4]) {
#pragma unroll
        for (int e = 0; e < 4; ++e) k[e] = Family<F, kD, 0>::value(p[e], xi[e], xj[e], D, A);
    }
};

template <int F>
int launch_family(int nb, const float* x, const int* c, const float* stats, const float* V,
                  const int* items, int64_t n_items, float* part, int64_t N, int R, int O, int S,
                  int D, int A, cudaStream_t stream) {
    if (D == 1)
        return launch_fold_nb<FamilyFold<F, 1>>(nb, x, c, stats, V, items, n_items, part, N, R, O,
                                                S, D, A, stream);
    return launch_fold_nb<FamilyFold<F, 0>>(nb, x, c, stats, V, items, n_items, part, N, R, O, S,
                                            D, A, stream);
}

}  // namespace

// K-fam-matvec's first pass: the partial slabs of out (N, R) = K(x, x) @ V
// for x (N, D), channel IDs c (N,), V (N, R), all row-major; stats is the
// (O*O, S) pair table. part holds fold_slab_base(ntiles, nsupers) slots of
// 128 x R floats, which mosm_matvec_reduce_f32 sums; items and nb as
// mosm_matvec_fold_f32's (ops/mosm_matvec.fold_items, fold_group). fam: the
// FamilyId; A: CSM's Rq, SM-LMC's Q, else 0.
extern "C" int family_matvec_fold_f32(const float* x, const int* c, const float* stats,
                                      const float* V, const int* items, int64_t n_items,
                                      float* part, int64_t N, int R, int nb, int O, int S, int D,
                                      int A, int fam, cudaStream_t stream) {
    if (D < 1 || O < 1 || ((fam == kCsm || fam == kLmcSm) && A < 1) || S != family_slots(fam, D, A))
        return (int)cudaErrorInvalidValue;
    switch (fam) {
        case kUmosm: return launch_family<kUmosm>(nb, x, c, stats, V, items, n_items, part, N, R, O, S, D, A, stream);
        case kCsm: return launch_family<kCsm>(nb, x, c, stats, V, items, n_items, part, N, R, O, S, D, A, stream);
        case kConv: return launch_family<kConv>(nb, x, c, stats, V, items, n_items, part, N, R, O, S, D, A, stream);
        case kMohsm: return launch_family<kMohsm>(nb, x, c, stats, V, items, n_items, part, N, R, O, S, D, A, stream);
        case kLmcSm: return launch_family<kLmcSm>(nb, x, c, stats, V, items, n_items, part, N, R, O, S, D, A, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}
