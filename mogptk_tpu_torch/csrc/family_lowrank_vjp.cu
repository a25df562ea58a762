// K-fam-lowrank-vjp: the cotangent of a non-MOSM family's pair pack for a
// low-rank dK = A B^T, without forming dK. For Hopper (sm_90a), float32.
//
// Replaces mogptk_tpu/ops/block_families.py family_lowrank_vjp_sorted
// (pallas_call at :590, body _lowrank_bwd_batched_kernel at :319, which
// summed each pair's in-kernel jax.vjp over the TPU's sequential grid), and
// for the families mogptk_tpu/ops/fused.py fused_gram_lowrank_vjp
// (pallas_call at :346; the engine sorts the rows by channel first). Each
// upper 256^2 tile of each upper channel pair reduces to the S scalars of
// the pair's pack through the family's hand-derived element derivatives
// (csrc/family_element.cuh, csrc/family_pair_vjp.cuh).
//
// Bound: operations. Per element 2R multiply-adds for g (R = 17 on the
// probe-trace path, 33 on the iterative one), one exp and one sin/cos (per
// component for CSM; Q D of each for SM-LMC) and ~4 FMAs per scalar of the
// pack; the inputs are a few MB, read from L2.
//
// Design: K-lowrank-vjp's (csrc/lowrank_vjp.cuh, shared with
// csrc/mosm_lowrank_vjp.cu): g = [A_i | B_i] . [B_j | A_j]^T as one 3xTF32
// mma.sync product, R in chunks of lowrank_chunk(R) columns padded to
// lowrank_kpad, each warp's accumulator fragments the thread's elements,
// which go from registers into the family's element chain four at a time
// (family_pair_vjp.cuh FamilyChain: the pair's S scalars in registers, the
// exponential on ex2 and sin/cos after an exact reduction by whole turns,
// shared with K-fam-gram-bwd). The generic instance (any D and component
// count) runs family_pair_vjp.cuh's generic tile on the library functions.
// Each block writes its S partial sums (a fixed-order reduction, no
// atomics), and a second kernel sums each pair's partials in a fixed order
// in float64, 256 threads a pair (mosm_pair_vjp.cuh
// pair_reduce_wide_kernel): a repeated call is bit-identical.
#include "family_pair_vjp.cuh"
#include "lowrank_vjp.cuh"

namespace {

template <int F>
__global__ void __launch_bounds__(kThreads)
family_lowrank_vjp_generic_kernel(const int* __restrict__ idx, const float* __restrict__ x,
                                  const float* __restrict__ A, const float* __restrict__ Bm,
                                  const float* __restrict__ stats, float* __restrict__ partial,
                                  int R, int RC, int KH, int S, int D, int ncomp) {
    extern __shared__ __align__(16) float ops[];
    float gt[kMicro][kMicro];
    const float* xr[kMicro];
    const float* xc[kMicro];
    lowrank_generic_input(idx, x, A, Bm, R, RC, KH, D, ops, gt, xr, xc);
    const int pair = idx[3 * (blockIdx.x / 4) + 2];
    family_tile_generic<F>(gt, xr, xc, stats + (int64_t)pair * S, S, D, ncomp,
                           partial + (int64_t)blockIdx.x * S);
}

}  // namespace

// idx (T, 3) int32 upper tiles [ti, tj, pair]; x (Np, D), A and B (Np, R),
// Np a multiple of 256; stats (O*O, S) the pair table; partial (4T, S)
// scratch; pairs (P, 3) int32; out (O*O, S), rows of absent and lower
// pairs left as given. RC: the chunk width, 1 <= RC <= min(R, 64); KH: RC
// rounded up to a multiple of 8. fam: the FamilyId; ncomp: CSM's Rq,
// SM-LMC's Q, else 0.
extern "C" int family_lowrank_vjp_f32(const int* idx, const float* x, const float* A,
                                      const float* Bm, const float* stats, float* partial,
                                      const int* pairs, float* out, int T, int P, int R, int RC,
                                      int KH, int S, int D, int ncomp, int fam,
                                      cudaStream_t stream) {
    if (!lowrank_plan_ok(R, RC, KH) || D < 1 || fam < 0 || fam > kLmcSm ||
        ((fam == kCsm || fam == kLmcSm) && ncomp < 1) || S != family_slots(fam, D, ncomp))
        return (int)cudaErrorInvalidValue;
    if (T == 0) return 0;
    int err = -1;
#define MOGPTK_CASE(f, d, a)                                                                 \
    if (err < 0 && fam == f && D == d && ncomp == a)                                         \
        err = launch_lowrank(lowrank_vjp_kernel<FamilyChain<f, d, a>>, T, KH, stream, idx, x, A, \
                             Bm, stats, partial, R, RC, KH);
    MOGPTK_FAMILY_UNROLLED(MOGPTK_CASE)
#undef MOGPTK_CASE
#define MOGPTK_GENERIC(f)                                                                    \
    if (err < 0 && fam == f)                                                                 \
        err = launch_lowrank(family_lowrank_vjp_generic_kernel<f>, T, KH, stream, idx, x, A, Bm, \
                             stats, partial, R, RC, KH, S, D, ncomp);
    MOGPTK_GENERIC(kUmosm) MOGPTK_GENERIC(kCsm) MOGPTK_GENERIC(kConv) MOGPTK_GENERIC(kMohsm)
    MOGPTK_GENERIC(kLmcSm)
#undef MOGPTK_GENERIC
    if (err != 0) return err;
    pair_reduce_wide_kernel<<<(unsigned)P, 256, 0, stream>>>(partial, pairs, out, S);
    return (int)cudaGetLastError();
}
