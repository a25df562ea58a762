// K-syrk: the block-lower half of W^T W for a lower-triangular W, for Hopper
// (sm_90a), float32.
//
// syrk_lower_f32 replaces mogptk_tpu/ops/blocked_trisolve.py syrk_lower
// (pallas_call at :212, body _syrk_lower_kernel at :170), the closed-form
// gradient's K^-1 = W^T W with W = L^-1 (ops/blocked_trisolve
// spd_inverse_from_factor):
//   out[a][b] = sum_k W[k][a] * W[k][b]  for every (a, b) in a block (I, J)
//   of `block` x `block` with I >= J; the diagonal blocks whole, the strict
//   upper blocks left unwritten (the caller mirrors the strict lower ones).
//   W (n x n, row-major) has a zero strict upper, so W[k][a] = 0 for k < a:
//   a tile starting at row a0 and column b0 sums k from max(a0, b0) only.
// Bound: operations, n^3/6 multiply-adds over the lower triangle (1.47
// TFLOP, 21.9 ms at n = 16,384 on 67 TFLOP/s FP32). Design: FP32 FFMA (no
// TF32), a 128 x 128 output tile per 256-thread block, 8 x 8 outputs per
// thread, 8-deep k slices of W's rows staged in shared memory as float4s
// (both operands are column ranges of the same rows, so every load is a
// contiguous row segment); the next slice's loads are issued into registers
// before the current one is multiplied. The grid covers every tile pair and the tiles of
// strict upper blocks return at once; the tiles with the longest k (small
// row index) come first in launch order. One thread owns each output
// element and sums k in a fixed order: repeats are bit-identical. The TPU
// kernel ran a folded triangular grid of 1024^2 tiles with a manual bf16x3
// product; wgmma, TMA and double buffering are later work.
//
// All offsets are 64-bit: n^2 exceeds 2^31 from n = 46,341 on.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TS = 128, KS = 8, S_THREADS = 256;

__global__ void __launch_bounds__(S_THREADS)
syrk_lower_kernel(const float* __restrict__ W, float* __restrict__ out, int64_t n, int64_t block) {
    const int64_t ti = blockIdx.y, tj = blockIdx.x;
    const int64_t a0 = ti * TS, b0 = tj * TS;
    if (a0 / block < b0 / block) return;          // a strict upper block
    __shared__ __align__(16) float As[KS][TS];
    __shared__ __align__(16) float Bs[KS][TS];
    const int t = threadIdx.x;
    const int lk = t / (TS / 4), lq = (t % (TS / 4)) * 4;   // the float4 this thread stages
    const int ty = t / 16, tx = t % 16;
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
    const int64_t kstart = a0 > b0 ? a0 : b0;
    const float* row = W + (kstart + lk) * n;
    float4 pa = *reinterpret_cast<const float4*>(row + a0 + lq);
    float4 pb = *reinterpret_cast<const float4*>(row + b0 + lq);
    for (int64_t k0 = kstart; k0 < n; k0 += KS) {
        *reinterpret_cast<float4*>(&As[lk][lq]) = pa;
        *reinterpret_cast<float4*>(&Bs[lk][lq]) = pb;
        __syncthreads();
        if (k0 + KS < n) {        // the next slice's loads fly during the product
            row += KS * n;
            pa = *reinterpret_cast<const float4*>(row + a0 + lq);
            pb = *reinterpret_cast<const float4*>(row + b0 + lq);
        }
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
            float a[8], b[8];
            const float4 a_lo = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
            const float4 a_hi = *reinterpret_cast<const float4*>(&As[kk][64 + ty * 4]);
            const float4 b_lo = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
            const float4 b_hi = *reinterpret_cast<const float4*>(&Bs[kk][64 + tx * 4]);
            a[0] = a_lo.x; a[1] = a_lo.y; a[2] = a_lo.z; a[3] = a_lo.w;
            a[4] = a_hi.x; a[5] = a_hi.y; a[6] = a_hi.z; a[7] = a_hi.w;
            b[0] = b_lo.x; b[1] = b_lo.y; b[2] = b_lo.z; b[3] = b_lo.w;
            b[4] = b_hi.x; b[5] = b_hi.y; b[6] = b_hi.z; b[7] = b_hi.w;
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
                for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
        __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        const int64_t r = a0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
        float* orow = out + r * n + b0;
        *reinterpret_cast<float4*>(orow + tx * 4) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
        *reinterpret_cast<float4*>(orow + 64 + tx * 4) = make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
    }
}

}  // namespace

extern "C" int syrk_lower_f32(const float* W, float* out, int64_t n, int64_t block,
                              cudaStream_t stream) {
    // whole tiles and 16-byte aligned rows: n and block multiples of 128
    if (n <= 0 || block <= 0 || block % TS != 0 || n % block != 0 || n / TS > 65535)
        return (int)cudaErrorInvalidValue;
    dim3 grid((unsigned)(n / TS), (unsigned)(n / TS));
    syrk_lower_kernel<<<grid, S_THREADS, 0, stream>>>(W, out, n, block);
    return (int)cudaGetLastError();
}
