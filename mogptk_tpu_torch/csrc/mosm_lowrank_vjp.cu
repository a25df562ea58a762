// Channel-pair cotangents of the MOSM Gram for a low-rank dK = A B^T, for
// Hopper (sm_90a), float32, without forming dK: K-lowrank-vjp.
//
// Replaces mogptk_tpu/ops/block_mosm.py mosm_lowrank_vjp_sorted (pallas_call
// at :652, body _lowrank_bwd_batched_kernel at :214, per-tile math
// _bwd_scalars at :119 with phase_inside), and the MOSM case of
// mogptk_tpu/ops/fused.py fused_gram_lowrank_vjp (:346) after the channel
// sort. Each upper 256^2 tile of each upper channel pair reduces, for each
// component q and input dim d, to the 3QD + 2Q scalars [dV, dM, dtheta] x
// (q, d), then [dalpha, dphi] x q, of the pair's statistics (the
// hand-derived backward of the tau -> exp/cos chain of csrc/mosm_gram.cu).
//
// Bound: operations. Per element 2R multiply-adds for g (R = 17 on the
// training and iterative paths) and, per component, one exp, one sin/cos
// pair and ~20 FP32 operations; the inputs are a few MB, read from L2.
//
// Design: csrc/lowrank_vjp.cuh, shared with K-fam-lowrank-vjp: g as one
// 3xTF32 mma.sync product whose accumulator fragments feed the tau chain
// from registers, R in chunks. The chain runs four elements at a time with
// the component loop outermost, so four independent exp and sin/cos chains
// overlap, on the special-function units: sin/cos(2 pi (a + dphi)) after an
// exact reduction by whole turns, where sincosf's slow path past |x| ~ 1e5
// keeps the chains apart (add_pair_cotangents4 and sincos_two_pi in
// mosm_pair_vjp.cuh, shared with K-gram-bwd, say why its error is far below
// the float32 twin's; the unrolled instance only, the generic one keeps
// mosm_pair_vjp.cuh's library functions). The pair's statistics sit in
// shared memory. Blocks run in no order, so nothing carries from one to the
// next as it did across the TPU's sequential grid: each block writes its
// 3QD + 2Q partial sums, and a second kernel sums each pair's partials in a
// fixed order in float64 (pair_reduce_kernel). The result is deterministic.
// Two instances (ops/mosm_gram.kernel_instance chooses): unrolled over Q and
// D for Q <= 4, D <= 2, and a generic one for any Q and D (mosm_pair_vjp.cuh
// generic_tile).
#include "lowrank_vjp.cuh"

namespace {

__global__ void __launch_bounds__(kThreads)
lowrank_vjp_generic_kernel(const int* __restrict__ idx, const float* __restrict__ x,
                           const float* __restrict__ A, const float* __restrict__ Bm,
                           const float* __restrict__ stats, float* __restrict__ partial, int R,
                           int RC, int KH, int Q, int D) {
    extern __shared__ __align__(16) float ops[];
    const int NOUT = 3 * Q * D + 2 * Q;
    float gt[kMicro][kMicro];
    const float* xr[kMicro];
    const float* xc[kMicro];
    lowrank_generic_input(idx, x, A, Bm, R, RC, KH, D, ops, gt, xr, xc);
    const int pair = idx[3 * (blockIdx.x / 4) + 2];
    generic_tile<false>(gt, xr, xc, stats + (int64_t)pair * NOUT, Q, D,
                        partial + (int64_t)blockIdx.x * NOUT, nullptr, nullptr, false, false);
}

}  // namespace

// idx (S, 3) int32 upper tiles [ti, tj, pair]; x (Np, D), A and B (Np, R),
// Np a multiple of 256; stats (O*O, 3QD+2Q); partial (4S, 3QD+2Q) scratch;
// pairs (P, 3) int32; out (O*O, 3QD+2Q), rows of absent pairs left as given.
// RC: the chunk width, 1 <= RC <= min(R, 64); KH: RC rounded up to a
// multiple of 8. generic: 0 for the unrolled instance (Q <= 4, D <= 2), 1
// for the generic one.
extern "C" int mosm_lowrank_vjp_f32(const int* idx, const float* x, const float* A,
                                    const float* Bm, const float* stats, float* partial,
                                    const int* pairs, float* out, int S, int P, int Q, int D,
                                    int R, int RC, int KH, int generic, cudaStream_t stream) {
    if (!lowrank_plan_ok(R, RC, KH) || Q < 1 || D < 1) return (int)cudaErrorInvalidValue;
    if (S == 0) return 0;
    int err = (int)cudaErrorInvalidValue;
    if (generic)
        err = launch_lowrank(lowrank_vjp_generic_kernel, S, KH, stream, idx, x, A, Bm, stats,
                             partial, R, RC, KH, Q, D);
#define MOGPTK_VJP_CASE(q, d)                                                                \
    else if (Q == q && D == d)                                                               \
        err = launch_lowrank(lowrank_vjp_kernel<MosmChain<q, d>>, S, KH, stream, idx, x, A, Bm, \
                             stats, partial, R, RC, KH);
    MOGPTK_VJP_CASE(1, 1) MOGPTK_VJP_CASE(2, 1) MOGPTK_VJP_CASE(3, 1) MOGPTK_VJP_CASE(4, 1)
    MOGPTK_VJP_CASE(1, 2) MOGPTK_VJP_CASE(2, 2) MOGPTK_VJP_CASE(3, 2) MOGPTK_VJP_CASE(4, 2)
#undef MOGPTK_VJP_CASE
    if (err != 0) return err;
    pair_reduce_kernel<<<(unsigned)P, 32, 0, stream>>>(partial, pairs, out, 3 * Q * D + 2 * Q);
    return (int)cudaGetLastError();
}
