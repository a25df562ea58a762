// Left-looking blocked Cholesky column kernels, for Hopper (sm_90a), float32.
//
// The factor L (n x n, row-major, leading dimension n) is built in place in
// the buffer that holds K: block column j (rows r0 = j*B .. n, columns
// r0 .. r0+B) still holds K when its turn comes, the columns left of it hold
// finished L. The kernels run on PyTorch's current stream, in order; the
// S-panel kernel reads the buffer the column-write kernel writes.
//
// Both GEMMs run on the 3xTF32 tensor-core mainloop of gemm_tf32x3.cuh:
// TMA copies into a 3-stage ring, each operand split into TF32 big and small
// parts, three wgmma products per 8-deep k step, FP32 accumulators. Each
// product is within ~12 u |a.b| (u = 2^-24), under the 2 (k + 1) u bound
// that the factor's checks hold a length-k float32 sum to for every k >= 5;
// the sums themselves stay in FP32. The operands are scaled by 2^16 before
// the split and the sums by 2^-32 after, so products that FP32 keeps as
// subnormals are not flushed by the tensor cores (gemm_tf32x3.cuh, "Range":
// the sums of |products| must stay below ~7.9e28). Every entry point takes
// the factor's range scale `scale` (device memory, [s, r, 1/r], or null for
// 1): K-spanel forms s K - (r L)(r L)^T, the scaled S, K-colwrite writes
// the rows below from the scaled S and the scaled panel inverse times 1/r
// and copies the scaled Ljj times 1/r, so the buffer always holds the true
// L and every tensor-core sum stays below max diag(s K) <= 1 once max
// diag(K) passes 2^64 (ops/blocked_cholesky.range_scale). With s = r = 1
// every operation is the unscaled one. The tiles are 128 x 128; the column
// tiles of one row block are adjacent in the launch order, so X's row block
// comes from DRAM once and from L2 after that.
//
// s_panel_f32 replaces mogptk_tpu/ops/blocked_cholesky.py _s_panel_impl
// (pallas_call at :96, body _s_panel_kernel at :35):
//   S (m x B) = K[r0:, r0:r0+B] - L[r0:, :r0] . L[r0:r0+B, :r0]^T,  m = n - r0.
//   This is the N^3/3 bulk of the factorization. Bound: operations,
//   2*m*B*r0 flops per column; at j = 16 of the N = 16,384 factor (B = 512)
//   68.7 GFLOP, 1.026 ms at the 67 TFLOP/s FP32 peak and 0.42 ms for the
//   three TF32 passes at 495 TFLOP/s (bytes 0.32 ms). The JAX kernel
//   emulated f32 with three bf16 MXU passes (less accurate than 3xTF32).
//   Both operands are rows of L (one tensor map, inner extent r0: k past r0
//   reads as zero). The epilogue writes S = K - acc from the K tile.
//   Split-K: where the m/128 x B/128 output tiles cannot fill the 132 SMs
//   (j >= 26 at N = 16,384) or leave most of a last wave empty (j = 12-15,
//   19-23), the wrapper's plan (ops/blocked_cholesky.py spanel_plan) cuts k
//   into chunks of k_chunk columns, whole 32-deep slices; one CTA per
//   (tile, chunk) writes its raw partial tile to slab z
//   of `part` (splits x m x B), and s_panel_reduce_f32 sums the slabs in a
//   fixed order and subtracts the sum from K: no atomics, so repeats are
//   bit-identical. The TPU kernel ran the k chunks as a sequential grid
//   axis with the sum in VMEM.
//
// s_panel_reduce_f32 replaces that sequential axis's carry (the same
// pallas_call): S = K_panel - sum_z part[z], z in order. Bound: bytes
// (splits + 2) * m * B * 4.
//
// col_write_f32 replaces _col_strip_write_impl (pallas_call at :292, body
// _col_strip_kernel at :245) and, with zero_upper = 0, _panel_write_impl
// (pallas_call at :184, body _panel_write_kernel at :149):
//   L[r0:r0+B, r0:r0+B] = Ljj;  L[r0+B:, r0:r0+B] = S[B:] . inv^T (inv = Ljj^-1,
//   the TRSM as a GEMM against the explicit panel inverse);  with zero_upper,
//   L[r0:r0+B, r0+B:] = 0 (the strip still holds K). Bound: operations for
//   the (m-B) x B x B GEMM (4.0 GFLOP at j = 16: 0.060 ms FP32, 0.024 ms
//   3xTF32), bytes for the copy and the zeroing. One launch: the first CTAs
//   each take one 128 x 128 tile of the GEMM (tensor maps over S[B:] and
//   inv, k = B), the rest copy Ljj and zero the strip in coalesced float4
//   stores, grid-strided.
//
// All offsets are 64-bit: n^2 exceeds 2^31 from n = 46,341 on.
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_tf32x3.cuh"

namespace {

using tf32x3::BM;
using tf32x3::BN;
using tf32x3::BK;
using tf32x3::THREADS;

__global__ void __launch_bounds__(THREADS, 1)
col_write_kernel(const __grid_constant__ CUtensorMap map_s, const __grid_constant__ CUtensorMap map_inv,
                 float* __restrict__ L, const float* __restrict__ Ljj, int64_t n, int64_t r0,
                 int64_t B, int zero_upper, int64_t n_gemm, const float* __restrict__ scale) {
    extern __shared__ uint8_t smem_raw[];
    const float unscale = tf32x3::scale_at(scale, 2);
    const int64_t below = n - r0 - B;   // rows below the diagonal block; also the strip's width
    if ((int64_t)blockIdx.x < n_gemm) {
        const int64_t tiles_b = (B + BN - 1) / BN;
        solve_tile(&map_s, &map_inv, L, n, r0, B, (blockIdx.x / tiles_b) * BM,
                   (blockIdx.x % tiles_b) * BN, unscale, tf32x3::aligned_smem(smem_raw));
        return;
    }
    // the copy of Ljj, then (zero_upper) the strip of block row j right of
    // the diagonal block; B, r0 and n are multiples of 4, so every float4 is
    // aligned
    const int64_t b4 = B / 4, w4 = below / 4;
    const int64_t diag = B * b4, total = diag + (zero_upper ? B * w4 : 0);
    const int64_t stride = ((int64_t)gridDim.x - n_gemm) * THREADS;
    const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int64_t e = ((int64_t)blockIdx.x - n_gemm) * THREADS + threadIdx.x; e < total; e += stride) {
        if (e < diag) {
            const int64_t r = e / b4, c = (e % b4) * 4;
            float4 v = *reinterpret_cast<const float4*>(Ljj + r * B + c);
            v.x *= unscale;
            v.y *= unscale;
            v.z *= unscale;
            v.w *= unscale;
            *reinterpret_cast<float4*>(L + (r0 + r) * n + r0 + c) = v;
        } else {
            const int64_t f = e - diag, r = f / w4, c = (f % w4) * 4;
            *reinterpret_cast<float4*>(L + (r0 + r) * n + r0 + B + c) = zero;
        }
    }
}

constexpr int64_t SMS = 132;   // the H100 SXM's: the copy CTAs fill the card once at most

}  // namespace

extern "C" int s_panel_f32(const float* L, float* S, float* part, int64_t n, int64_t r0, int64_t B,
                           int64_t k_chunk, const float* scale, cudaStream_t stream) {
    const int64_t m = n - r0;
    if (m <= 0 || B <= 0) return 0;
    int64_t splits = 1;
    CUtensorMap map;
    memset(&map, 0, sizeof(map));
    if (r0 > 0) {
        if (k_chunk <= 0 || k_chunk % BK) return (int)cudaErrorInvalidValue;
        splits = (r0 + k_chunk - 1) / k_chunk;
        if (splits > 1 && part == nullptr) return (int)cudaErrorInvalidValue;
        // L[:, :r0], every row: k past r0 and rows past n read as zero
        const int err = tf32x3::make_map(&map, L, r0, n, n);
        if (err) return err;
    }
    const int err = tf32x3::allow_smem(panel_product_kernel<false>);
    if (err) return err;
    const int64_t blocks = ((m + BM - 1) / BM) * ((B + BN - 1) / BN) * splits;
    panel_product_kernel<false><<<(unsigned)blocks, THREADS, tf32x3::SMEM_BYTES, stream>>>(
        map, L, S, splits > 1 ? part : nullptr, n, r0, B, splits > 1 ? k_chunk : r0, scale);
    return (int)cudaGetLastError();
}

extern "C" int s_panel_reduce_f32(const float* L, const float* part, float* S, int64_t n,
                                  int64_t r0, int64_t B, int64_t splits, const float* scale,
                                  cudaStream_t stream) {
    const int64_t total = (n - r0) * B;
    if (total <= 0 || splits < 1) return (int)cudaErrorInvalidValue;
    int64_t blocks = (total + 255) / 256;
    if (blocks > 8 * SMS) blocks = 8 * SMS;
    panel_reduce_kernel<<<(unsigned)blocks, 256, 0, stream>>>(L, part, S, n, r0, 0, B, splits,
                                                              scale);
    return (int)cudaGetLastError();
}

extern "C" int col_write_f32(float* L, const float* S, const float* Ljj, const float* inv,
                             int64_t n, int64_t r0, int64_t B, int zero_upper, const float* scale,
                             cudaStream_t stream) {
    const int64_t m = n - r0;
    if (m <= 0 || B <= 0 || B % 64 != 0 || n % 4 != 0) return (int)cudaErrorInvalidValue;
    const int64_t below = m - B;
    CUtensorMap map_s, map_inv;
    memset(&map_s, 0, sizeof(map_s));
    memset(&map_inv, 0, sizeof(map_inv));
    int64_t n_gemm = 0;
    if (below > 0) {
        int err = tf32x3::make_map(&map_s, S + B * B, B, below, B);   // S[B:m]
        if (!err) err = tf32x3::make_map(&map_inv, inv, B, B, B);
        if (err) return err;
        n_gemm = ((below + BM - 1) / BM) * ((B + BN - 1) / BN);
    }
    const int64_t copy4 = B * B / 4 + (zero_upper ? B * below / 4 : 0);
    int64_t n_copy = (copy4 + THREADS - 1) / THREADS;
    if (n_copy > SMS) n_copy = SMS;
    const int err = tf32x3::allow_smem(col_write_kernel);
    if (err) return err;
    col_write_kernel<<<(unsigned)(n_gemm + n_copy), THREADS, tf32x3::SMEM_BYTES, stream>>>(
        map_s, map_inv, L, Ljj, n, r0, B, zero_upper, n_gemm, scale);
    return (int)cudaGetLastError();
}

extern "C" const char* mogptk_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
