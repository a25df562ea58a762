// Left-looking blocked Cholesky column kernels, for Hopper (sm_90a), float32.
//
// The factor L (n x n, row-major, leading dimension n) is built in place in
// the buffer that holds K: block column j (rows r0 = j*B .. n, columns
// r0 .. r0+B) still holds K when its turn comes, the columns left of it hold
// finished L. Both kernels run on PyTorch's current stream, in order; the
// S-panel kernel reads the buffer the column-write kernel writes.
//
// s_panel_f32 replaces mogptk_tpu/ops/blocked_cholesky.py _s_panel_impl
// (pallas_call at :96, body _s_panel_kernel at :35):
//   S (m x B) = K[r0:, r0:r0+B] - L[r0:, :r0] . L[r0:r0+B, :r0]^T,  m = n - r0.
//   This is the N^3/3 bulk of the factorization. Bound: FP32 FMA throughput
//   (2*m*B*r0 flops per column). The JAX kernel emulated f32 with three bf16
//   MXU passes; plain FP32 FFMA is at least as accurate, and TF32 is not used.
//   Design: the shared-memory tiled GEMM of gemm_tile.cuh, 64x64 output tile
//   per 256-thread block, 16-deep k slices, 4x4 outputs per thread,
//   accumulator subtracted from the K tile in the epilogue. wgmma/TMA/3xTF32
//   are later work.
//
// col_write_f32 replaces _col_strip_write_impl (pallas_call at :292, body
// _col_strip_kernel at :245) and, with zero_upper = 0, _panel_write_impl
// (pallas_call at :184, body _panel_write_kernel at :149):
//   L[r0:r0+B, r0:r0+B] = Ljj;  L[r0+B:, r0:r0+B] = S[B:] . inv^T (inv = Ljj^-1,
//   the TRSM as a GEMM against the explicit panel inverse);  with zero_upper,
//   L[r0:r0+B, r0+B:] = 0 (the strip still holds K). Bound: the (m-B) x B x B
//   GEMM plus the column and strip writes. One launch: each block takes one
//   64x64 tile of the column (copy or GEMM) or of the strip (zero).
//
// All offsets are 64-bit: n^2 exceeds 2^31 from n = 46,341 on.
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_tile.cuh"

namespace {

__global__ void __launch_bounds__(THREADS)
s_panel_kernel(const float* __restrict__ L, float* __restrict__ S, int64_t n, int64_t r0, int64_t B) {
    __shared__ float As[BK][BM + PAD];
    __shared__ float Bs[BK][BN + PAD];
    const int64_t m = n - r0;
    const int64_t row0 = (int64_t)blockIdx.y * BM, col0 = (int64_t)blockIdx.x * BN;
    const float* left = L + r0 * n;  // L[r0:, :r0]; its first B rows are L[r0:r0+B, :r0]
    float acc[4][4];
    gemm_nt_tile(left, n, m, left, n, B, r0, row0, col0, acc, As, Bs);
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
    for (int i = 0; i < 4; ++i) {
        const int64_t r = row0 + ty * 4 + i;
        if (r >= m) continue;
        for (int j = 0; j < 4; ++j) {
            const int64_t c = col0 + tx * 4 + j;
            if (c < B) S[r * B + c] = L[(r0 + r) * n + r0 + c] - acc[i][j];
        }
    }
}

__global__ void __launch_bounds__(THREADS)
col_write_kernel(float* __restrict__ L, const float* __restrict__ S, const float* __restrict__ Ljj,
                 const float* __restrict__ inv, int64_t n, int64_t r0, int64_t B) {
    __shared__ float As[BK][BM + PAD];
    __shared__ float Bs[BK][BN + PAD];
    const int64_t m = n - r0;
    const int64_t tiles_b = (B + BN - 1) / BN;
    const int64_t n_col = ((m + BM - 1) / BM) * tiles_b;
    int64_t t = blockIdx.x;
    if (t < n_col) {
        const int64_t row0 = (t / tiles_b) * BM, col0 = (t % tiles_b) * BN;
        if (row0 < B) {  // diagonal block: copy Ljj (B % 64 == 0, so no tile straddles)
            for (int e = threadIdx.x; e < BM * BN; e += THREADS) {
                const int64_t r = row0 + e / BN, c = col0 + e % BN;
                if (r < B && c < B) L[(r0 + r) * n + r0 + c] = Ljj[r * B + c];
            }
            return;
        }
        const int64_t brow0 = row0 - B;  // row inside S[B:]
        float acc[4][4];
        gemm_nt_tile(S + B * B, B, m - B, inv, B, B, B, brow0, col0, acc, As, Bs);
        const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
        for (int i = 0; i < 4; ++i) {
            const int64_t r = brow0 + ty * 4 + i;
            if (r >= m - B) continue;
            for (int j = 0; j < 4; ++j) {
                const int64_t c = col0 + tx * 4 + j;
                if (c < B) L[(r0 + B + r) * n + r0 + c] = acc[i][j];
            }
        }
        return;
    }
    // strip of block row j right of the diagonal: zero
    t -= n_col;
    const int64_t w = n - r0 - B;
    const int64_t tiles_w = (w + BN - 1) / BN;
    const int64_t row0 = (t / tiles_w) * BM, col0 = (t % tiles_w) * BN;
    for (int e = threadIdx.x; e < BM * BN; e += THREADS) {
        const int64_t r = row0 + e / BN, c = col0 + e % BN;
        if (r < B && c < w) L[(r0 + r) * n + r0 + B + c] = 0.0f;
    }
}

}  // namespace

extern "C" int s_panel_f32(const float* L, float* S, int64_t n, int64_t r0, int64_t B,
                           cudaStream_t stream) {
    const int64_t m = n - r0;
    if (m <= 0 || B <= 0) return 0;
    dim3 grid((unsigned)((B + BN - 1) / BN), (unsigned)((m + BM - 1) / BM));
    s_panel_kernel<<<grid, THREADS, 0, stream>>>(L, S, n, r0, B);
    return (int)cudaGetLastError();
}

extern "C" int col_write_f32(float* L, const float* S, const float* Ljj, const float* inv,
                             int64_t n, int64_t r0, int64_t B, int zero_upper,
                             cudaStream_t stream) {
    const int64_t m = n - r0;
    if (m <= 0 || B <= 0 || B % BM != 0) return (int)cudaErrorInvalidValue;
    const int64_t tiles_b = (B + BN - 1) / BN;
    int64_t tiles = ((m + BM - 1) / BM) * tiles_b;
    const int64_t w = n - r0 - B;
    if (zero_upper && w > 0) tiles += tiles_b * ((w + BN - 1) / BN);
    col_write_kernel<<<(unsigned)tiles, THREADS, 0, stream>>>(L, S, Ljj, inv, n, r0, B);
    return (int)cudaGetLastError();
}

extern "C" const char* mogptk_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
