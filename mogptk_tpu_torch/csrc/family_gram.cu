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
// (c1[i], c2[j]) (csrc/family_element.cuh; the pack in
// ops/block_families.family_pack), so one launch covers all of N x M for
// any channel order, and a lower block comes from its own pair's scalars
// (the families' elements are unchanged when the points and the pair swap).
//
// Bound: the (N, M) float32 write (1.07 GB at N = 16,384), against one exp
// and one cos per element (per component for CSM; Q D of each for SM-LMC).
// The O*O*S pair table sits in shared memory when it fits in 48 KB, else it
// is read from global memory; each thread keeps its column's inputs and
// channel and walks kRows rows, so neighbouring threads write neighbouring
// addresses. Two instances per family: the input-dim loop unrolled for
// D = 1, and a generic one for any D (family_element.cuh).
#include <cuda_runtime.h>
#include <stdint.h>

#include "family_element.cuh"

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;
constexpr int kRows = 4;               // rows per thread
constexpr int kMaxTableBytes = 48 * 1024;

template <int F, int kD>
__global__ void family_gram_kernel(const float* __restrict__ x1, const int* __restrict__ c1,
                                   const float* __restrict__ x2, const int* __restrict__ c2,
                                   const float* __restrict__ stats, float* __restrict__ out,
                                   int64_t N, int64_t M, int O, int S, int D, int A,
                                   bool table_in_smem) {
    extern __shared__ float smem_table[];
    const float* table = stats;
    if (table_in_smem) {
        for (int t = threadIdx.y * blockDim.x + threadIdx.x; t < O * O * S;
             t += blockDim.x * blockDim.y)
            smem_table[t] = stats[t];
        __syncthreads();
        table = smem_table;
    }
    const int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (j >= M) return;
    const int cj = c2[j];
    const int64_t i0 = ((int64_t)blockIdx.y * blockDim.y + threadIdx.y) * kRows;
    float xj1[1];
    const float* xj = x2 + j * D;
    if constexpr (kD == 1) {
        xj1[0] = xj[0];
        xj = xj1;
    }
    for (int r = 0; r < kRows; ++r) {
        const int64_t i = i0 + r;
        if (i >= N) break;
        out[i * M + j] = Family<F, kD, 0>::value(table + ((int64_t)c1[i] * O + cj) * S,
                                                 x1 + i * D, xj, D, A);
    }
}

template <int F>
int launch(const float* x1, const int* c1, const float* x2, const int* c2, const float* stats,
           float* out, int64_t N, int64_t M, int O, int S, int D, int A, cudaStream_t stream) {
    const size_t table = sizeof(float) * (size_t)O * O * S;
    const bool in_smem = table <= kMaxTableBytes;
    const size_t smem = in_smem ? table : 0;
    dim3 block(kBlockX, kBlockY);
    dim3 grid((unsigned)((M + kBlockX - 1) / kBlockX),
              (unsigned)((N + (int64_t)kBlockY * kRows - 1) / ((int64_t)kBlockY * kRows)));
    if (D == 1)
        family_gram_kernel<F, 1><<<grid, block, smem, stream>>>(x1, c1, x2, c2, stats, out, N, M,
                                                                O, S, D, A, in_smem);
    else
        family_gram_kernel<F, 0><<<grid, block, smem, stream>>>(x1, c1, x2, c2, stats, out, N, M,
                                                                O, S, D, A, in_smem);
    return (int)cudaGetLastError();
}

}  // namespace

// out (N, M) = the family's Gram for x1 (N, D) with channel IDs c1 (N,),
// x2 (M, D) with c2 (M,), all row-major; stats is the (O*O, S) pair table.
// fam: the FamilyId; A: CSM's Rq, SM-LMC's Q, else 0.
extern "C" int family_gram_f32(const float* x1, const int* c1, const float* x2, const int* c2,
                               const float* stats, float* out, int64_t N, int64_t M, int O,
                               int S, int D, int A, int fam, cudaStream_t stream) {
    if (D < 1 || O < 1 || ((fam == kCsm || fam == kLmcSm) && A < 1) ||
        S != family_slots(fam, D, A))
        return (int)cudaErrorInvalidValue;
    if (N == 0 || M == 0) return 0;
    switch (fam) {
        case kUmosm: return launch<kUmosm>(x1, c1, x2, c2, stats, out, N, M, O, S, D, A, stream);
        case kCsm: return launch<kCsm>(x1, c1, x2, c2, stats, out, N, M, O, S, D, A, stream);
        case kConv: return launch<kConv>(x1, c1, x2, c2, stats, out, N, M, O, S, D, A, stream);
        case kMohsm: return launch<kMohsm>(x1, c1, x2, c2, stats, out, N, M, O, S, D, A, stream);
        case kLmcSm: return launch<kLmcSm>(x1, c1, x2, c2, stats, out, N, M, O, S, D, A, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}
