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
// expf/cosf are the full-precision library functions (no fast math): the
// cosine argument reaches ~250 rad on the bench data.
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

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;
constexpr int kRows = 4;     // rows per thread
constexpr int kMaxD = 8;     // input dims kept in registers

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
    extern __shared__ float table[];
    const int S = 3 * Q * D + 2 * Q;  // per pair: [V, M, dtheta] x (Q, D), then [alpha, dphi] x Q
    const int total = O * O * S;
    for (int t = threadIdx.y * blockDim.x + threadIdx.x; t < total; t += blockDim.x * blockDim.y)
        table[t] = stats[t];
    __syncthreads();

    const int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (j >= M) return;
    float xj[kMaxD];
    for (int d = 0; d < D; ++d) xj[d] = x2[j * D + d];
    const int cj = c2[j];
    const float two_pi = 6.283185307179586f;

    const int64_t i0 = ((int64_t)blockIdx.y * blockDim.y + threadIdx.y) * kRows;
    for (int r = 0; r < kRows; ++r) {
        const int64_t i = i0 + r;
        if (i >= N) break;
        const float* p = table + (c1[i] * O + cj) * S;
        float k = 0.0f;
        for (int q = 0; q < Q; ++q) {
            float e = 0.0f, a = 0.0f;
            for (int d = 0; d < D; ++d) {
                const float* s3 = p + 3 * (q * D + d);
                const float td = (x1[i * D + d] - xj[d]) + s3[2];
                e += td * td * s3[0];
                a += td * s3[1];
            }
            const float* s2 = p + 3 * Q * D + 2 * q;
            k += s2[0] * expf(-0.5f * e) * cosf(two_pi * (a + s2[1]));
        }
        out[i * M + j] = k;
    }
}

int launch_gram(const float* x1, const int* c1, const float* x2, const int* c2,
                const float* stats, float* out, int64_t N, int64_t M, int O, int Q, int D,
                int64_t tile, int64_t band, cudaStream_t stream) {
    if (D > kMaxD) return (int)cudaErrorInvalidValue;
    if (N == 0 || M == 0) return 0;
    const size_t smem = sizeof(float) * (size_t)O * O * (3 * Q * D + 2 * Q);
    dim3 block(kBlockX, kBlockY);
    dim3 grid((unsigned)((M + kBlockX - 1) / kBlockX),
              (unsigned)((N + (int64_t)kBlockY * kRows - 1) / ((int64_t)kBlockY * kRows)));
    mosm_gram_kernel<<<grid, block, smem, stream>>>(x1, c1, x2, c2, stats, out, N, M, O, Q, D,
                                                    tile, band);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int mosm_gram_f32(const float* x1, const int* c1, const float* x2, const int* c2,
                             const float* stats, float* out, int64_t N, int64_t M,
                             int O, int Q, int D, cudaStream_t stream) {
    return launch_gram(x1, c1, x2, c2, stats, out, N, M, O, Q, D, 0, 1, stream);
}

// Square (N, N) band-lower Gram of channel-sorted x; tile and band must be
// multiples of 32 and divide N, band a multiple of tile.
extern "C" int mosm_gram_lower_f32(const float* x, const int* c, const float* stats, float* out,
                                   int64_t N, int O, int Q, int D, int64_t tile, int64_t band,
                                   cudaStream_t stream) {
    if (tile <= 0 || tile % kBlockX || band % tile || N % band)
        return (int)cudaErrorInvalidValue;
    return launch_gram(x, c, x, c, stats, out, N, N, O, Q, D, tile, band, stream);
}
