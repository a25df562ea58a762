// The shared-memory tiled FP32 GEMM tile of the blocked Cholesky kernels
// (blocked_cholesky.cu's K-spanel and K-colwrite, fused_trsm.cu's K-sdiag):
// a 64x64 output tile per 256-thread block, 16-deep k slices, 4x4 outputs
// per thread, FFMA only (TF32 is not used).
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64, BN = 64, BK = 16, PAD = 4, THREADS = 256;

// acc[i][j] = sum_k A[row0+ty*4+i, k] * Bm[col0+tx*4+j, k] for k < K, with
// A (rows x K, leading dim lda) and Bm (cols x K, leading dim ldb) both
// k-contiguous; out-of-range rows, columns and k read as zero.
__device__ __forceinline__ void gemm_nt_tile(const float* __restrict__ A, int64_t lda, int64_t rows,
                                             const float* __restrict__ Bm, int64_t ldb, int64_t cols,
                                             int64_t K, int64_t row0, int64_t col0,
                                             float (&acc)[4][4],
                                             float (*As)[BM + PAD], float (*Bs)[BN + PAD]) {
    const int t = threadIdx.x;
    const int lr = t / 4;           // tile row (of A) / column (of Bm) this thread loads
    const int lk = (t % 4) * 4;     // its 4 k offsets inside the slice
    const int ty = t / 16, tx = t % 16;
    for (int i = 0; i < 4; ++i)
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
    const int64_t ar = row0 + lr, bc = col0 + lr;
    for (int64_t k0 = 0; k0 < K; k0 += BK) {
        for (int u = 0; u < 4; ++u) {
            const int64_t k = k0 + lk + u;
            As[lk + u][lr] = (ar < rows && k < K) ? A[ar * lda + k] : 0.0f;
            Bs[lk + u][lr] = (bc < cols && k < K) ? Bm[bc * ldb + k] : 0.0f;
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < BK; ++kk) {
            float a[4], b[4];
            for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
            for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx * 4 + j];
            for (int i = 0; i < 4; ++i)
                for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
        __syncthreads();
    }
}

}  // namespace
