// Both substitution sweeps of a Cholesky solve for a narrow right-hand side,
// for Hopper (sm_90a), float32: X = (L L^T)^-1 B from the lower factor L and
// the inverses of its B x B diagonal blocks, reading only L's strictly lower
// blocks (its upper triangle may hold anything) and never forming L^T.
//
// Replaces mogptk_tpu/ops/pallas_solve.py fused_cho_solve (pallas_call at
// :186, body _solve_kernel at :46), which ran the 2*nb panel steps as one
// sequential TPU grid with the right-hand side resident in VMEM:
//   forward  z_i = inv_i   (b_i - sum_{k<i} L_ik z_k),
//   backward x_i = inv_i^T (z_i - sum_{k>i} L_ki^T x_k).
//
// Bound: bytes. Each sweep reads L's strict lower triangle once (0.54 GB each
// at n = 16,384), and the right-hand side is only 1 + R = 17 columns wide, so
// the work per byte is tiny. The panel steps depend on each other, so the
// design is right-looking and runs 4*nb short launches of one kernel on the
// stream, in order (grid-wide order between panels comes from the stream,
// not from a cooperative launch):
//   forward step i:  z_i = inv_i v_i (B / 64 blocks), then
//                    v_k -= L_ki z_i for every row below the panel, 64 rows
//                    of L a block, as many blocks as rows / 64;
//   backward step i: x_i = inv_i^T z_i, then z_k -= L_ik^T x_i for every row
//                    above it (L's rows r0..r0+B read 64 columns a block).
// Every block reads a 64 x B slab of L exactly once, so the sweep reads the
// lower triangle twice in all, with all SMs busy while many rows remain. The
// three (n, R) vectors (v, z, x) are separate buffers, so no block reads what
// another block of the same launch writes. Plain FP32 FFMA.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64, kK = 32, kThreads = 256, kMaxR = 64;

// Out[r, c] = (subtract ? Out[r, c] : 0) +- sum_k A(r, k) X[k, c] for r < rows,
// c < R, with A(r, k) = A[r * rs + k * cs] and X, Out row-major with R columns.
// rs == 1 marks A stored with r contiguous (a transposed read), else k
// contiguous; the tile load follows the contiguous index either way. A
// thread keeps NJ = ceil(R / 4) columns, c = cg + 4j, so no instruction is
// spent on columns that do not exist.
template <int NJ>
__global__ void __launch_bounds__(kThreads)
panel_gemm_kernel(const float* __restrict__ A, int64_t rs, int64_t cs,
                  const float* __restrict__ X, float* __restrict__ Out,
                  int64_t rows, int64_t K, int R, int subtract) {
    __shared__ float As[kK][kRows + 1];
    __shared__ float Xs[kK][4 * NJ];
    const int t = threadIdx.x;
    const int row = t % kRows, cg = t / kRows;   // 4 column groups: c = cg + 4j
    const int64_t r0 = (int64_t)blockIdx.x * kRows;
    float acc[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[j] = 0.0f;
    for (int64_t k0 = 0; k0 < K; k0 += kK) {
        for (int e = t; e < kRows * kK; e += kThreads) {
            int rr, kk;
            if (rs == 1) { rr = e % kRows; kk = e / kRows; }
            else { kk = e % kK; rr = e / kK; }
            const int64_t gr = r0 + rr, gk = k0 + kk;
            As[kk][rr] = (gr < rows && gk < K) ? A[gr * rs + gk * cs] : 0.0f;
        }
        for (int e = t; e < kK * 4 * NJ; e += kThreads) {
            const int kk = e / (4 * NJ), c = e % (4 * NJ);
            Xs[kk][c] = (k0 + kk < K && c < R) ? X[(k0 + kk) * R + c] : 0.0f;
        }
        __syncthreads();
#pragma unroll 8
        for (int kk = 0; kk < kK; ++kk) {
            const float a = As[kk][row];
#pragma unroll
            for (int j = 0; j < NJ; ++j) acc[j] = fmaf(a, Xs[kk][cg + 4 * j], acc[j]);
        }
        __syncthreads();
    }
    const int64_t gr = r0 + row;
    if (gr >= rows) return;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
        const int c = cg + 4 * j;
        if (c < R) {
            float* o = Out + gr * R + c;
            *o = subtract ? *o - acc[j] : acc[j];
        }
    }
}

template <int NJ>
void launch(const float* A, int64_t rs, int64_t cs, const float* X, float* Out, int64_t rows,
            int64_t K, int R, int subtract, cudaStream_t stream) {
    const unsigned blocks = (unsigned)((rows + kRows - 1) / kRows);
    panel_gemm_kernel<NJ><<<blocks, kThreads, 0, stream>>>(A, rs, cs, X, Out, rows, K, R, subtract);
}

int gemm(const float* A, int64_t rs, int64_t cs, const float* X, float* Out, int64_t rows,
         int64_t K, int R, int subtract, cudaStream_t stream) {
    switch ((R + 3) / 4) {
#define MOGPTK_NJ(nj) case nj: launch<nj>(A, rs, cs, X, Out, rows, K, R, subtract, stream); break;
        MOGPTK_NJ(1) MOGPTK_NJ(2) MOGPTK_NJ(3) MOGPTK_NJ(4) MOGPTK_NJ(5) MOGPTK_NJ(6)
        MOGPTK_NJ(7) MOGPTK_NJ(8) MOGPTK_NJ(9) MOGPTK_NJ(10) MOGPTK_NJ(11) MOGPTK_NJ(12)
        MOGPTK_NJ(13) MOGPTK_NJ(14) MOGPTK_NJ(15) MOGPTK_NJ(16)
#undef MOGPTK_NJ
        default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

}  // namespace

// L (n, n) row-major lower factor; invs (n/B, B, B) inverses of its diagonal
// blocks; V (n, R) holds the right-hand side and is overwritten; Z (n, R)
// scratch; X (n, R) the solution. 1 <= R <= 64, B divides n.
extern "C" int fused_cho_solve_f32(const float* L, const float* invs, float* V, float* Z,
                                   float* X, int64_t n, int64_t B, int R, cudaStream_t stream) {
    if (R < 1 || R > kMaxR || B <= 0 || n % B) return (int)cudaErrorInvalidValue;
    const int64_t nb = n / B;
    int err;
    for (int64_t i = 0; i < nb; ++i) {           // L z = b
        const int64_t r0 = i * B;
        if ((err = gemm(invs + i * B * B, B, 1, V + r0 * R, Z + r0 * R, B, B, R, 0, stream)))
            return err;
        if (r0 + B < n &&
            (err = gemm(L + (r0 + B) * n + r0, n, 1, Z + r0 * R, V + (r0 + B) * R, n - r0 - B,
                        B, R, 1, stream)))
            return err;
    }
    for (int64_t i = nb - 1; i >= 0; --i) {      // L^T x = z
        const int64_t r0 = i * B;
        if ((err = gemm(invs + i * B * B, 1, B, Z + r0 * R, X + r0 * R, B, B, R, 0, stream)))
            return err;
        if (r0 > 0 && (err = gemm(L + r0 * n, 1, n, X + r0 * R, Z, r0, B, R, 1, stream)))
            return err;
    }
    return 0;
}
