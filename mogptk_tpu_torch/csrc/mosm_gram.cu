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
// (c1[i], c2[j]) (mosm_pair_stats). One launch covers all of N x M.
//
// Bound: the (N, M) float32 write (1.07 GB at N = 16,384), with Q exp and
// Q cos per element and no reuse. The O*O pair table is tiny and sits in
// shared memory; each thread keeps its column's x2 and channel in registers
// and walks ROWS rows, so neighbouring threads write neighbouring addresses.
// The element is csrc/mosm_element.cuh (full-precision expf/cosf, no fast
// math: the cosine argument reaches ~250 rad on the bench data).
//
// Two instances (ops/mosm_gram.kernel_instance chooses, mode 0 or 1): the
// unrolled one above (D <= kMaxD, the pair table within 48 KB of shared
// memory), and a generic one for any D and O: the input-dim loop runs to
// the runtime D, x2 is read in place, and the pair table is read from
// global memory through the read-only path instead of shared memory.
//
// mosm_gram_lower_f32 replaces a third Pallas kernel,
//   mogptk_tpu/ops/block_mosm.py  mosm_gram_sorted_lower (pallas_call at :437),
// the band-lower Gram of the training path: of the (N/tile)^2 tiles it writes
// only those the blocked Cholesky reads, tile row ti >= tile column tj or both
// inside one band-wide diagonal panel; the rest of the buffer stays unwritten
// (undefined). Same math and layout as the full Gram: a block covers 32 rows x
// 32 columns, inside one tile (tile is a multiple of 32), and a block whose tile
// lies strictly above the band returns before it loads anything. Bound: the
// written half of the float32 write (0.55 GB at N = 16,384), and like the full
// Gram it is instruction-bound on expf/cosf.
#include <cuda_runtime.h>
#include <stdint.h>

#include "mosm_element.cuh"

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;
constexpr int kRows = 4;     // rows per thread

template <bool kUnrolled>
__global__ void mosm_gram_kernel(const float* __restrict__ x1, const int* __restrict__ c1,
                                 const float* __restrict__ x2, const int* __restrict__ c2,
                                 const float* __restrict__ stats, float* __restrict__ out,
                                 int64_t N, int64_t M, int O, int Q, int D,
                                 int64_t tile, int64_t band) {
    if (tile > 0) {  // band-lower: skip the tiles the factorization never reads
        const int64_t ti = ((int64_t)blockIdx.y * blockDim.y * kRows) / tile;
        const int64_t tj = ((int64_t)blockIdx.x * blockDim.x) / tile;
        if (ti < tj && ti * tile / band != tj * tile / band) return;
    }
    extern __shared__ float smem_table[];
    const int S = 3 * Q * D + 2 * Q;  // per pair: [V, M, dtheta] x (Q, D), then [alpha, dphi] x Q
    const float* table = stats;
    if constexpr (kUnrolled) {
        const int total = O * O * S;
        for (int t = threadIdx.y * blockDim.x + threadIdx.x; t < total;
             t += blockDim.x * blockDim.y)
            smem_table[t] = stats[t];
        __syncthreads();
        table = smem_table;
    }

    const int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (j >= M) return;
    const int cj = c2[j];
    const int64_t i0 = ((int64_t)blockIdx.y * blockDim.y + threadIdx.y) * kRows;
    if constexpr (kUnrolled) {
        float xj[kMaxD];
        for (int d = 0; d < D; ++d) xj[d] = x2[j * D + d];
        for (int r = 0; r < kRows; ++r) {
            const int64_t i = i0 + r;
            if (i >= N) break;
            out[i * M + j] = mosm_element<true>(table + (c1[i] * O + cj) * S, x1 + i * D, xj, Q, D);
        }
    } else {
        for (int r = 0; r < kRows; ++r) {
            const int64_t i = i0 + r;
            if (i >= N) break;
            out[i * M + j] = mosm_element<false>(table + ((int64_t)c1[i] * O + cj) * S, x1 + i * D,
                                                 x2 + j * D, Q, D);
        }
    }
}

int launch_gram(const float* x1, const int* c1, const float* x2, const int* c2,
                const float* stats, float* out, int64_t N, int64_t M, int O, int Q, int D,
                int64_t tile, int64_t band, int generic, cudaStream_t stream) {
    if (D < 1 || (!generic && D > kMaxD)) return (int)cudaErrorInvalidValue;
    if (N == 0 || M == 0) return 0;
    const size_t smem = generic ? 0 : sizeof(float) * (size_t)O * O * (3 * Q * D + 2 * Q);
    if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
    dim3 block(kBlockX, kBlockY);
    dim3 grid((unsigned)((M + kBlockX - 1) / kBlockX),
              (unsigned)((N + (int64_t)kBlockY * kRows - 1) / ((int64_t)kBlockY * kRows)));
    if (generic)
        mosm_gram_kernel<false><<<grid, block, 0, stream>>>(x1, c1, x2, c2, stats, out, N, M, O,
                                                            Q, D, tile, band);
    else
        mosm_gram_kernel<true><<<grid, block, smem, stream>>>(x1, c1, x2, c2, stats, out, N, M,
                                                              O, Q, D, tile, band);
    return (int)cudaGetLastError();
}

}  // namespace

// generic: 0 for the unrolled instance, 1 for the generic one.
extern "C" int mosm_gram_f32(const float* x1, const int* c1, const float* x2, const int* c2,
                             const float* stats, float* out, int64_t N, int64_t M,
                             int O, int Q, int D, int generic, cudaStream_t stream) {
    return launch_gram(x1, c1, x2, c2, stats, out, N, M, O, Q, D, 0, 1, generic, stream);
}

// Square (N, N) band-lower Gram of channel-sorted x; tile and band must be
// multiples of 32 and divide N, band a multiple of tile.
extern "C" int mosm_gram_lower_f32(const float* x, const int* c, const float* stats, float* out,
                                   int64_t N, int O, int Q, int D, int64_t tile, int64_t band,
                                   int generic, cudaStream_t stream) {
    if (tile <= 0 || tile % kBlockX || band % tile || N % band)
        return (int)cudaErrorInvalidValue;
    return launch_gram(x, c, x, c, stats, out, N, N, O, Q, D, tile, band, generic, stream);
}
