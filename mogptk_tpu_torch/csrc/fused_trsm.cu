// The fused below-TRSM column pipeline of the left-looking blocked Cholesky,
// for Hopper (sm_90a), float32: K-sdiag, K-below-trsm and K-commit.
//
// The factor L (n x n, row-major, leading dimension n) is built in place in
// the buffer that holds K (see blocked_cholesky.cu). For block column j > 0
// (r0 = j*B) the columns left of r0 hold finished L, column j still holds K.
// Per column, on PyTorch's current stream in order: K-sdiag, the B x B panel
// factor and its inverse inv = Ljj^-1 (library calls), K-below-trsm with
// K-commit in its TRSM launch (the last column, with no rows below: K-commit
// alone).
//
// s_diag_f32 replaces mogptk_tpu/ops/blocked_cholesky.py _s_diag_pallas
// (pallas_call at :414, body _s_diag_kernel at :391):
//   S_jj (B x B) = s K[r0:r0+B, r0:r0+B] - (r C) . (r C)^T,  C = L[r0:r0+B, :r0],
//   with the factor's range scale [s, r, 1/r] (1 without one; see
//   blocked_cholesky.cu). Bound: operations, B*(B+1)*r0 flops for the lower
//   triangle, all that the panel factor reads (2.1 GFLOP at j = 16 of the
//   N = 16,384 factor: 0.032 ms at the FP32 peak, 0.013 ms for three TF32
//   passes). Design: the product runs on gemm_tf32x3.cuh's 3xTF32 wgmma
//   mainloop (TMA ring, big/small split, 2^16 prescale), as K-spanel's, on
//   the lower 128 x 128 tiles only: 10 of the 16 at B = 512, 3 of 4 at
//   B = 256. Ten tiles cannot fill 132 SMs, and k runs up to 15,872, so the
//   wrapper's plan (ops/blocked_cholesky.sdiag_plan) cuts k into `splits`
//   chunks of whole 32-deep slices, one CTA per (tile, chunk), each writing
//   its raw partial tile to slab z of `part`. A second kernel sums the
//   slabs in a fixed order (no atomics, so repeats are bit-identical) and
//   subtracts the sum from s K_jj; in the strict upper triangle the product
//   is the mirror of the lower one's (C . C^T is symmetric), transposed
//   through 32 x 32 tiles in shared memory, so the output is the full
//   S_jj, symmetric where K_jj is. The TPU kernel ran the k chunks as a
//   sequential grid axis with the sum in VMEM.
//
// below_trsm_f32 replaces _below_trsm_pallas (pallas_call at :465, body
// _below_trsm_kernel at :431) and the below half of _col_commit (:504):
//   for the rows below the diagonal block,
//   L[r0+B:, r0:r0+B] = (s K[r0+B:, r0:r0+B] - (r A) . (r C)^T) . inv^T / r,
//   A = L[r0+B:, :r0], C = L[r0:r0+B, :r0], inv the inverse of s K's Ljj,
//   written straight into column j, with the factor's range scale [s, r, 1/r]
//   (1 without one) as K-spanel and K-colwrite take it. Bound: operations,
//   2*(m-B)*B*(r0+B) flops (68.5 GFLOP at j = 16 of the N = 16,384 factor:
//   0.415 ms for three TF32 passes, 1.022 ms at the FP32 peak). The TPU
//   kernel computes the product with three bf16 passes (_bf16x3); here both
//   products run on gemm_tf32x3.cuh's 3xTF32 wgmma mainloop (TMA ring,
//   big/small split, 2^16 prescale) through the panel kernels K-spanel and
//   K-colwrite run (panel_product_kernel<true>, from row r0 + B;
//   panel_reduce_kernel, solve_tile):
//   (1) A . C^T over 128 x 128 tiles of the m - B rows below, k split into
//   chunks where the tiles fill the SMs poorly (ops/blocked_cholesky.
//   below_trsm_plan, K-spanel's cost model on the rows below), each chunk's
//   partial tile in a slab of its own; (2) where split, a second pass that
//   sums the slabs in a fixed order (repeats bit-identical) and subtracts the
//   sum from s K; either way the scaled S goes to a scratch strip of
//   (m - B) x B floats (15.7 MB at j = 16, within the 50 MB L2); (3) the TRSM
//   as K-colwrite's product S . inv^T, read through tensor maps, each tile
//   written into column j's rows below. Column j's K rows are read by (1) or
//   (2) and written by (3), a later launch on the same stream: no CTA reads
//   rows another has overwritten. The unfused pair (K-spanel over all m rows,
//   then K-colwrite) does the same work and the diagonal block's; the fused
//   column's diagonal block is K-sdiag's lower tiles instead.
//
// K-commit replaces _col_commit (pallas_call at :504, the diagonal half; the
// rows below are K-below-trsm's store) and, with zero_upper = 1,
// _upper_zero_impl (pallas_call at :540):
//   L[r0:r0+B, r0:r0+B] = Ljj / r;  with zero_upper, L[r0:r0+B, r0+B:] = 0,
//   Ljj the factor of s K's diagonal block and 1/r the range scale's third
//   entry (1 without one), an exact power of two, so the product is exact.
//   Bound: bytes (a copy and a fill). Where block column j has rows below,
//   the commit runs inside K-below-trsm's TRSM launch: B/8 more CTAs of
//   below_solve_kernel, after its tiles (they fill the last wave's idle
//   SMs), 8 rows of the diagonal block each, rows as float4 (commit_rows),
//   with no launch and no separate product of its own. No CTA of that
//   launch, and no launch before it on the stream, reads what the commit
//   writes (block row j at columns >= r0): the product and its second pass
//   read C = L[r0:r0+B, :r0] (columns < r0) and column j's rows below, the
//   TRSM reads only the strip S and inv and writes column j's rows below;
//   Ljj and inv are finished before the launch. The last column, with no
//   rows below, takes col_commit_f32's launch of the same rows.
// All offsets are 64-bit: n^2 exceeds 2^31 from n = 46,341 on.
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_tf32x3.cuh"

namespace {

// -- K-sdiag ------------------------------------------------------------------

// One CTA per (lower tile, k chunk): tile t of the lower triangle in
// row-major order, chunk z of `splits` over the r0/32 slices of k.
__global__ void __launch_bounds__(tf32x3::THREADS, 1)
s_diag_kernel(const __grid_constant__ CUtensorMap map, float* __restrict__ part, int64_t r0,
              int64_t B, int64_t splits, int tiles, const float* __restrict__ scale) {
    extern __shared__ uint8_t smem_raw[];
    const int t = (int)(blockIdx.x % tiles);
    const int64_t z = blockIdx.x / tiles;
    int ti = 0;
    while ((ti + 1) * (ti + 2) / 2 <= t) ++ti;
    const int tj = t - ti * (ti + 1) / 2;
    const int64_t row0 = (int64_t)ti * tf32x3::BM, col0 = (int64_t)tj * tf32x3::BN;
    const int64_t slices = (r0 + tf32x3::BK - 1) / tf32x3::BK;
    const int64_t s0 = z * slices / splits, s1 = (z + 1) * slices / splits;
    float acc[64];
    if (!tf32x3::mainloop(&map, &map, (int)(r0 + row0), (int)(r0 + col0), (int)(s0 * tf32x3::BK),
                          (int)(s1 - s0), tf32x3::PRESCALE * tf32x3::scale_at(scale, 1),
                          tf32x3::aligned_smem(smem_raw), acc))
        return;
    float* out = part + z * B * B;
    const int64_t c0 = col0 + tf32x3::col_of();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int64_t r = row0 + tf32x3::row_of(h);
        if (r >= B) continue;
#pragma unroll
        for (int i = 0; i < 16; ++i) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int64_t c = c0 + 8 * i + e;
                if (c < B) out[r * B + c] = acc[4 * i + 2 * h + e] * tf32x3::POSTSCALE;
            }
        }
    }
}

// Output tile (blockIdx.y, blockIdx.x) of 32 x 32: the product of its
// lower partner tile (the tile itself on and below the diagonal) summed
// over the chunks in order into shared memory, then subtracted, as it is or
// transposed, from s K at the output position; on a diagonal tile the
// strict upper takes the lower's product.
__global__ void __launch_bounds__(256)
s_diag_reduce_kernel(const float* __restrict__ L, const float* __restrict__ part,
                     float* __restrict__ out, int64_t n, int64_t r0, int64_t B, int64_t splits,
                     const float* __restrict__ scale) {
    __shared__ float tile[32][33];
    const int64_t tr = blockIdx.y, tc = blockIdx.x;
    const int64_t lr = tr > tc ? tr : tc, lc = tr > tc ? tc : tr;
    const float s = tf32x3::scale_at(scale, 0);
    const int x = threadIdx.x % 32, y = threadIdx.x / 32;
    for (int i = y; i < 32; i += 8) {
        const int64_t r = lr * 32 + i, c = lc * 32 + x;
        if (r < B && c < B) {
            const int64_t e = r * B + c;
            float acc = part[e];
            for (int64_t z = 1; z < splits; ++z) acc += part[z * B * B + e];   // fixed order
            tile[i][x] = acc;
        }
    }
    __syncthreads();
    for (int i = y; i < 32; i += 8) {
        const int64_t r = tr * 32 + i, c = tc * 32 + x;
        if (r < B && c < B) {
            float p;
            if (tr > tc)
                p = tile[i][x];
            else if (tr < tc)
                p = tile[x][i];
            else
                p = i >= x ? tile[i][x] : tile[x][i];
            out[r * B + c] = L[(r0 + r) * n + r0 + c] * s - p;
        }
    }
}

// -- K-commit -------------------------------------------------------------------

constexpr int64_t COMMIT_ROWS = 8;   // rows of the diagonal block a CTA commits

// Rows [rb, re) of block row j, by the block's threads: L[r0 + r, r0 + c] =
// Ljj[r, c] * unscale for c < B, 0 for B <= c < width; float4 where L's and
// Ljj's rows are 16-byte aligned.
__device__ __forceinline__ void commit_rows(float* __restrict__ L, const float* __restrict__ Ljj,
                                            int64_t n, int64_t r0, int64_t B, int64_t width,
                                            float unscale, int64_t rb, int64_t re) {
    const int64_t tid = threadIdx.x, step = blockDim.x;
    const bool vec = ((reinterpret_cast<uintptr_t>(L) | reinterpret_cast<uintptr_t>(Ljj)) & 15)
                     == 0 && (n | r0 | B | width) % 4 == 0;
    if (vec) {
        const int64_t w4 = width / 4;
        for (int64_t e = tid; e < (re - rb) * w4; e += step) {
            const int64_t r = rb + e / w4, c = 4 * (e % w4);
            float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            if (c < B) {
                v = *reinterpret_cast<const float4*>(Ljj + r * B + c);
                v.x *= unscale;
                v.y *= unscale;
                v.z *= unscale;
                v.w *= unscale;
            }
            *reinterpret_cast<float4*>(L + (r0 + r) * n + r0 + c) = v;
        }
    } else {
        for (int64_t e = tid; e < (re - rb) * width; e += step) {
            const int64_t r = rb + e / width, c = e % width;
            L[(r0 + r) * n + r0 + c] = c < B ? Ljj[r * B + c] * unscale : 0.0f;
        }
    }
}

__global__ void __launch_bounds__(256)
col_commit_kernel(float* __restrict__ L, const float* __restrict__ Ljj, int64_t n, int64_t r0,
                  int64_t B, int64_t width, const float* __restrict__ scale) {
    const int64_t rb = blockIdx.x * COMMIT_ROWS;
    commit_rows(L, Ljj, n, r0, B, width, tf32x3::scale_at(scale, 2), rb,
                rb + COMMIT_ROWS < B ? rb + COMMIT_ROWS : B);
}

// -- K-below-trsm ---------------------------------------------------------------

// The TRSM: one CTA per 128 x 128 tile of the rows below (gemm_tf32x3.cuh
// solve_tile), the maps over the strip S and inv; with Ljj, the CTAs past
// the tiles commit the diagonal block, COMMIT_ROWS rows each (K-commit).
__global__ void __launch_bounds__(tf32x3::THREADS, 1)
below_solve_kernel(const __grid_constant__ CUtensorMap map_s, const __grid_constant__ CUtensorMap map_inv,
                   float* __restrict__ L, int64_t n, int64_t r0, int64_t B,
                   const float* __restrict__ scale, const float* __restrict__ Ljj, int64_t width,
                   int64_t tiles) {
    extern __shared__ uint8_t smem_raw[];
    if ((int64_t)blockIdx.x >= tiles) {
        const int64_t rb = (blockIdx.x - tiles) * COMMIT_ROWS;
        commit_rows(L, Ljj, n, r0, B, width, tf32x3::scale_at(scale, 2), rb,
                    rb + COMMIT_ROWS < B ? rb + COMMIT_ROWS : B);
        return;
    }
    const int64_t tiles_b = (B + tf32x3::BN - 1) / tf32x3::BN;
    solve_tile(&map_s, &map_inv, L, n, r0, B, (blockIdx.x / tiles_b) * tf32x3::BM,
               (blockIdx.x % tiles_b) * tf32x3::BN, tf32x3::scale_at(scale, 2),
               tf32x3::aligned_smem(smem_raw));
}

constexpr int64_t SMS = 132;   // the H100 SXM's: the second pass's grid fills the card 8 times

}  // namespace

// part holds `splits` (B, B) slabs; splits <= r0/32 (every chunk at least
// one slice). The TMA copies need n a multiple of 4 and L on 16 bytes.
extern "C" int s_diag_f32(const float* L, float* part, float* out, int64_t n, int64_t r0, int64_t B,
                          int64_t splits, const float* scale, cudaStream_t stream) {
    const int64_t slices = (r0 + tf32x3::BK - 1) / tf32x3::BK;
    if (r0 <= 0 || B <= 0 || r0 + B > n || n % 4 || splits < 1 || splits > slices)
        return (int)cudaErrorInvalidValue;
    CUtensorMap map;
    int err = tf32x3::make_map(&map, L, r0, n, n);   // L[:, :r0]: k past r0 reads as zero
    if (!err) err = tf32x3::allow_smem(s_diag_kernel);
    if (err) return err;
    const int64_t t1 = (B + tf32x3::BM - 1) / tf32x3::BM;
    const int tiles = (int)(t1 * (t1 + 1) / 2);
    s_diag_kernel<<<(unsigned)(tiles * splits), tf32x3::THREADS, tf32x3::SMEM_BYTES, stream>>>(
        map, part, r0, B, splits, tiles, scale);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    dim3 grid((unsigned)((B + 31) / 32), (unsigned)((B + 31) / 32));
    s_diag_reduce_kernel<<<grid, 256, 0, stream>>>(L, part, out, n, r0, B, splits, scale);
    return (int)cudaGetLastError();
}

// The rows of block column j below its diagonal block, in place, and with
// Ljj (non-null) the commit of its diagonal block (K-commit: Ljj times the
// range scale's 1/r and, with zero_upper, the strip right of it zeroed) in
// the TRSM's launch: first pass, with k in chunks of k_chunk (a multiple of
// 32; part holds the ceil(r0 / k_chunk) > 1 slabs of (n - r0 - B) x B
// floats, else null), then the second pass where split, then the TRSM; S is
// the (n - r0 - B) x B strip of the scaled S. inv is the panel inverse of
// s K's Ljj and scale the factor's range scale [s, r, 1/r] (null for 1).
// B 256 or 512, n and r0 multiples of B with rows below, n a multiple of 4
// and L, S, inv on 16 bytes (TMA).
extern "C" int below_trsm_f32(float* L, const float* inv, float* S, float* part,
                              const float* Ljj, int64_t n, int64_t r0, int64_t B, int64_t k_chunk,
                              int zero_upper, const float* scale, cudaStream_t stream) {
    if ((B != 256 && B != 512) || r0 <= 0 || r0 % B != 0 || n % B != 0 || r0 + B >= n
        || k_chunk <= 0 || k_chunk % tf32x3::BK)
        return (int)cudaErrorInvalidValue;
    const int64_t splits = (r0 + k_chunk - 1) / k_chunk, m = n - r0 - B;
    if (splits > 1 && part == nullptr) return (int)cudaErrorInvalidValue;
    CUtensorMap map, map_s, map_inv;
    int err = tf32x3::make_map(&map, L, r0, n, n);   // L[:, :r0]: k past r0 reads as zero
    if (!err) err = tf32x3::make_map(&map_s, S, B, m, B);
    if (!err) err = tf32x3::make_map(&map_inv, inv, B, B, B);
    if (!err) err = tf32x3::allow_smem(panel_product_kernel<true>);
    if (!err) err = tf32x3::allow_smem(below_solve_kernel);
    if (err) return err;
    const int64_t tiles = ((m + tf32x3::BM - 1) / tf32x3::BM) * ((B + tf32x3::BN - 1) / tf32x3::BN);
    panel_product_kernel<true><<<(unsigned)(tiles * splits), tf32x3::THREADS, tf32x3::SMEM_BYTES, stream>>>(
        map, L, S, splits > 1 ? part : nullptr, n, r0, B, splits > 1 ? k_chunk : r0, scale);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    if (splits > 1) {
        int64_t blocks = (m * B + 255) / 256;
        if (blocks > 8 * SMS) blocks = 8 * SMS;
        panel_reduce_kernel<<<(unsigned)blocks, 256, 0, stream>>>(L, part, S, n, r0, B, B, splits,
                                                                  scale);
        e = cudaGetLastError();
        if (e != cudaSuccess) return (int)e;
    }
    const int64_t commits = Ljj != nullptr ? (B + COMMIT_ROWS - 1) / COMMIT_ROWS : 0;
    below_solve_kernel<<<(unsigned)(tiles + commits), tf32x3::THREADS, tf32x3::SMEM_BYTES,
                         stream>>>(map_s, map_inv, L, n, r0, B, scale, Ljj,
                                   zero_upper ? n - r0 : B, tiles);
    return (int)cudaGetLastError();
}

// Block row j's diagonal block and, with zero_upper, the strip right of it,
// as K-below-trsm's commit does: the standalone launch of the last column.
extern "C" int col_commit_f32(float* L, const float* Ljj, int64_t n, int64_t r0, int64_t B,
                              int zero_upper, const float* scale, cudaStream_t stream) {
    if (B <= 0 || r0 < 0 || r0 + B > n) return (int)cudaErrorInvalidValue;
    const int64_t width = zero_upper ? n - r0 : B;
    col_commit_kernel<<<(unsigned)((B + COMMIT_ROWS - 1) / COMMIT_ROWS), 256, 0, stream>>>(
        L, Ljj, n, r0, B, width, scale);
    return (int)cudaGetLastError();
}
