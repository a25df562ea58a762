// The 3xTF32 tensor-core GEMM mainloop of the blocked Cholesky kernels
// (blocked_cholesky.cu's K-spanel and K-colwrite, fused_trsm.cu's K-sdiag
// and K-below-trsm), for Hopper (sm_90a), and the panel kernels at its end
// that K-spanel, K-colwrite and K-below-trsm share.
//
// One CTA computes a 128 x 128 tile of out = X . Y^T over a range of k, with
// X (rows x k) and Y (cols x k) both k-contiguous (K-major, the only layout
// wgmma takes for TF32), float32 in device memory, described by TMA tensor
// maps (make_map) with a 32 x 128 box: 32 k columns (128 bytes, the 128-byte
// swizzle span) by 128 rows.
//
// Copies: one producer thread (warp 8) keeps a ring of STAGES k slices in
// dynamic shared memory, each slice an X tile and a Y tile brought by TMA
// (cp.async.bulk.tensor, 128-byte swizzle) and signalled on the slice's
// `full` mbarrier; the consumer warps release a slice on its `empty`
// mbarrier once their products have read it. Reads outside the tensor
// (rows past its end, k past its inner extent) arrive as zeros.
//
// Math: the two consumer warpgroups (threads 0-255) each own 64 rows of
// the tile and run wgmma.mma_async m64n128k8 .tf32 with FP32 accumulators
// in registers (64 floats a thread). The tensor core reads only the top 19
// bits of an FP32 value (it truncates to TF32), so each slice is split in
// shared memory first, elementwise and in place: big = cvt.rna.tf32(x),
// small = cvt.rna.tf32(x - big), big over the loaded tile and small into a
// second buffer of the same (swizzled) layout. Per 8-deep k step three
// products go into the accumulator: small.big, big.small, big.big. Each
// product a.b is then within ~12 u |a.b| (u = 2^-24: the dropped
// small.small term is <= 2^-22 |a.b|, and rounding the small parts costs
// 2^-11 of them, 2^-22 |a.b| each); one-pass TF32 would be ~2^-11 |a.b|
// and is not used. The split of slice s overlaps the products of slice
// s - 1, which run asynchronously (wgmma.wait_group 1).
//
// Range: the tensor cores flush a product below FLT_MIN (2^-126) to zero,
// where FP32 FFMA keeps it as a subnormal; in the tails of a Gram's factor
// such products decide whole entries of S. So both operands are scaled by
// PRESCALE = 2^16 before the split (exact) and the accumulators by
// POSTSCALE = 2^-32 in the epilogues (one rounding where the result is
// subnormal): every product down to the smallest subnormal, 2^-149, stays
// normal on the tensor cores. In exchange the scaled operands and sums
// must stay finite: |x| < 2^112 and sum_k |a_k.b_k| < 2^96 (~7.9e28); for
// a Cholesky factor of K, sum_k |L_ik L_jk| <= max_i K_ii (Cauchy-Schwarz).
// The blocked factor keeps its sums inside that range with a second, exact
// power-of-two scale taken on the device from max diag(K) (ops/
// blocked_cholesky.range_scale: a (3,) tensor [s, r, 1/r], s = r^2, all 1
// below max diag 2^64): the callers pass `pre` = PRESCALE * r for operands
// that are rows of the true factor, so the products are those of r L, and
// scale K by s and their outputs by 1/r in the epilogues.
//
// Shared memory: STAGES x 64 KB (X big, X small, Y big, Y small, 16 KB
// each, 1024-byte aligned as the swizzle needs) + the barriers: ~193 KB,
// one CTA per SM.
#pragma once
#include <cuda.h>  // CUtensorMap and its enums (types only: the encoder is fetched at run time)
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace tf32x3 {

constexpr int BM = 128;                    // tile rows: two warpgroups of 64
constexpr int BN = 128;                    // tile columns: one m64n128 wgmma
constexpr int BK = 32;                     // k columns of a slice: 128 bytes
constexpr int STAGES = 3;
constexpr int CONSUMERS = 256;             // two warpgroups
constexpr int THREADS = CONSUMERS + 32;    // and the producer warp
constexpr int TILE_BYTES = BM * BK * 4;    // 16 KB (BN == BM)
constexpr int X_BIG = 0, X_SMALL = TILE_BYTES, Y_BIG = 2 * TILE_BYTES, Y_SMALL = 3 * TILE_BYTES;
constexpr int STAGE_BYTES = 4 * TILE_BYTES;
constexpr int BARRIERS = STAGES * STAGE_BYTES;           // offset of the mbarriers
constexpr int SMEM_BYTES = 1024 + BARRIERS + 2 * STAGES * 8;   // + alignment slack
constexpr float PRESCALE = 65536.0f;                             // 2^16 on each operand
constexpr float POSTSCALE = 1.0f / (65536.0f * 65536.0f);        // 2^-32 on each sum

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

// spins until the phase of parity `parity` of the barrier has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    uint32_t done = 0;
    while (!done) {
        asm volatile("{\n\t.reg .pred p;\n\t"
                     "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
                     "selp.u32 %0, 1, 0, p;\n\t}\n"
                     : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    }
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int k, int row,
                                            uint32_t bar) {
    asm volatile("cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
                 "[%0], [%1, {%2, %3}], [%4];\n"
                 :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(k), "r"(row), "r"(bar)
                 : "memory");
}

__device__ __forceinline__ float tf32_rna(float x) {
    uint32_t r;
    asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
    return __uint_as_float(r);
}

// with x' = pre x: big = rna(x') over the tile in place, small =
// rna(x' - big) into `small`; elementwise, so the swizzled layout needs no
// index arithmetic
__device__ __forceinline__ void split_tile(uint8_t* big, uint8_t* small, int tid, float pre) {
    float4* b = reinterpret_cast<float4*>(big);
    float4* s = reinterpret_cast<float4*>(small);
#pragma unroll
    for (int q = 0; q < TILE_BYTES / 16 / CONSUMERS; ++q) {
        const int i = tid + q * CONSUMERS;
        float4 v = b[i];
        v.x *= pre;
        v.y *= pre;
        v.z *= pre;
        v.w *= pre;
        float4 hi, lo;
        hi.x = tf32_rna(v.x); lo.x = tf32_rna(v.x - hi.x);
        hi.y = tf32_rna(v.y); lo.y = tf32_rna(v.y - hi.y);
        hi.z = tf32_rna(v.z); lo.z = tf32_rna(v.z - hi.z);
        hi.w = tf32_rna(v.w); lo.w = tf32_rna(v.w - hi.w);
        b[i] = hi;
        s[i] = lo;
    }
}

// wgmma descriptor of a K-major tile with the 128-byte swizzle: rows of 128
// bytes, 8-row groups 1024 bytes apart (SBO); LBO unused for this layout
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr) {
    return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16)
           | (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

// d += A . B^T for one m64n128k8 step, A and B from shared memory
__device__ __forceinline__ void wgmma_m64n128k8(float (&d)[64], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
        " %64, %65, p, 1, 1;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(1));
}

// ties the accumulators to this point of the program: the compiler may not
// move their reads or writes across it (wgmma writes them asynchronously)
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
    for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// The mainloop. Every thread of the block calls it. Accumulates, from
// zero, acc = pre^2 X[xrow : xrow+128, kbeg : kbeg+32*nslices] .
// Y[yrow : yrow+128, same k]^T (rows and k absolute coordinates of the
// maps; pre is PRESCALE times an exact power of two, and the epilogues
// multiply by POSTSCALE). Returns false in the
// producer warp, which has nothing left to do, and true in the consumer
// threads, whose acc then holds the tile: acc[4i + 2h + e] is element
// (row_of(h), 8i + col_of() + e).
__device__ __forceinline__ bool mainloop(const CUtensorMap* mx, const CUtensorMap* my, int xrow,
                                         int yrow, int kbeg, int nslices, float pre,
                                         uint8_t* smem, float (&acc)[64]) {
    const uint32_t base = smem_u32(smem);
    const uint32_t full = base + BARRIERS, empty = full + STAGES * 8;
    const int tid = threadIdx.x;
    if (tid == 0) {
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(full + 8 * s, 1);
            mbar_init(empty + 8 * s, CONSUMERS / 32);   // one arrival per consumer warp
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (tid >= CONSUMERS) {   // the producer warp: one thread starts every load
        if (tid == CONSUMERS) {
            for (int s = 0; s < nslices; ++s) {
                const int st = s % STAGES;
                if (s >= STAGES) mbar_wait(empty + 8 * st, ((s / STAGES) & 1) ^ 1);
                mbar_expect_tx(full + 8 * st, 2 * TILE_BYTES);
                const uint32_t stage = base + st * STAGE_BYTES;
                tma_load_2d(stage + X_BIG, mx, kbeg + s * BK, xrow, full + 8 * st);
                tma_load_2d(stage + Y_BIG, my, kbeg + s * BK, yrow, full + 8 * st);
            }
        }
        return false;
    }

    const int wg = tid / 128;
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
    fence_acc(acc);
    for (int s = 0; s < nslices; ++s) {
        const int st = s % STAGES;
        mbar_wait(full + 8 * st, (s / STAGES) & 1);
        uint8_t* stage = smem + st * STAGE_BYTES;
        split_tile(stage + X_BIG, stage + X_SMALL, tid, pre);
        split_tile(stage + Y_BIG, stage + Y_SMALL, tid, pre);
        // the split's generic stores before the tensor cores' reads
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        asm volatile("bar.sync 1, %0;\n" :: "n"(CONSUMERS) : "memory");
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
        const uint32_t sb = base + st * STAGE_BYTES;
        const uint32_t xb = sb + X_BIG + wg * 64 * 128, xs = sb + X_SMALL + wg * 64 * 128;
        const uint32_t yb = sb + Y_BIG, ys = sb + Y_SMALL;
#pragma unroll
        for (int kk = 0; kk < BK / 8; ++kk) {
            const uint32_t o = kk * 32;   // 8 floats further along k, inside the swizzle span
            wgmma_m64n128k8(acc, sw128_desc(xs + o), sw128_desc(yb + o));
            wgmma_m64n128k8(acc, sw128_desc(xb + o), sw128_desc(ys + o));
            wgmma_m64n128k8(acc, sw128_desc(xb + o), sw128_desc(yb + o));
        }
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        if (s > 0) {   // slice s - 1's products are done: release its stage
            __syncwarp();
            if (tid % 32 == 0) mbar_arrive(empty + 8 * ((s - 1) % STAGES));
        }
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(acc);
    return true;
}

// the range scale's entries (ops/blocked_cholesky.range_scale): K's factor
// s = r^2, the operand factor r and the output factor 1/r; 1 without one
__device__ __forceinline__ float scale_at(const float* scale, int i) {
    return scale != nullptr ? scale[i] : 1.0f;
}

// tile row of a consumer thread's accumulators with h = 0 or 1, and the
// tile column of its first one (mainloop's layout)
__device__ __forceinline__ int row_of(int h) {
    const int t = threadIdx.x;
    return (t / 128) * 64 + ((t % 128) / 32) * 16 + (t % 32) / 4 + 8 * h;
}

__device__ __forceinline__ int col_of() { return 2 * (threadIdx.x % 4); }

// the dynamic shared memory of a block, aligned to 1024 bytes
__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* raw) {
    return raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
}

// -- host side -----------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of libcuda, looked up through the runtime (the library
// does not link libcuda)
inline EncodeTiledFn encode_tiled() {
    static EncodeTiledFn fn = nullptr;
    if (fn == nullptr) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
        cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                         cudaEnableDefault, &q);
#else
        cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
        if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiledFn>(p);
    }
    return fn;
}

// The tensor map of a row-major float32 matrix (rows x cols, leading
// dimension ld elements) with mainloop's 32 x 128 box and the 128-byte
// swizzle. TMA needs `base` on 16 bytes and ld a multiple of 4 (16-byte
// rows); the wrappers check both. Returns a cudaError_t.
inline int make_map(CUtensorMap* map, const float* base, int64_t cols, int64_t rows, int64_t ld) {
    memset(map, 0, sizeof(*map));
    EncodeTiledFn fn = encode_tiled();
    if (fn == nullptr) return (int)cudaErrorSymbolNotFound;
    const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
    const cuuint64_t strides[1] = {(cuuint64_t)ld * 4};
    const cuuint32_t box[2] = {(cuuint32_t)BK, (cuuint32_t)BM};
    const cuuint32_t elem[2] = {1, 1};
    CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(base), dims, strides,
                    box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                    CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// lets `kernel` take SMEM_BYTES of dynamic shared memory
template <typename Kernel>
inline int allow_smem(Kernel kernel) {
    return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
}

}  // namespace tf32x3

// -- the panel kernels of K-spanel, K-colwrite and K-below-trsm ---------------

namespace {

// One CTA per (128 x 128 output tile, k chunk) of the product A . C^T over
// the m = n - r0 - rbeg rows of block column j from row r0 + rbeg
// (A = L[r0+rbeg:, :r0], C = L[r0:r0+B, :r0], one tensor map over
// L[:, :r0]): K-spanel's (kBelow false, rbeg = 0) and K-below-trsm's
// (kBelow, rbeg = B; a compile-time choice, so K-spanel's instance is the
// code it had before K-below-trsm shared it). The
// column tiles of a row tile are adjacent in the launch order, so A's rows
// come from DRAM once. Chunk z covers k in [z k_chunk, min(r0, (z+1)
// k_chunk)). With part null the epilogue writes S (m x B) = s K - acc from
// the K rows of column j (s: the range scale's); else the raw partial tile
// into slab z of part (splits x m x B).
template <bool kBelow>
__global__ void __launch_bounds__(tf32x3::THREADS, 1)
panel_product_kernel(const __grid_constant__ CUtensorMap map, const float* __restrict__ L,
                     float* __restrict__ S, float* __restrict__ part, int64_t n, int64_t r0,
                     int64_t B, int64_t k_chunk, const float* __restrict__ scale) {
    extern __shared__ uint8_t smem_raw[];
    const int64_t rbeg = kBelow ? B : 0;
    const int64_t m = n - r0 - rbeg;
    const int64_t tiles_b = (B + tf32x3::BN - 1) / tf32x3::BN;
    const int64_t tiles_m = (m + tf32x3::BM - 1) / tf32x3::BM;
    const int64_t col0 = (blockIdx.x % tiles_b) * tf32x3::BN;
    const int64_t row0 = ((blockIdx.x / tiles_b) % tiles_m) * tf32x3::BM;
    const int64_t z = blockIdx.x / (tiles_b * tiles_m);
    const int64_t kbeg = z * k_chunk, kend = kbeg + k_chunk < r0 ? kbeg + k_chunk : r0;
    const int nslices = (int)((kend - kbeg + tf32x3::BK - 1) / tf32x3::BK);
    float acc[64];
    if (!tf32x3::mainloop(&map, &map, (int)(r0 + rbeg + row0), (int)(r0 + col0), (int)kbeg, nslices,
                          tf32x3::PRESCALE * tf32x3::scale_at(scale, 1),
                          tf32x3::aligned_smem(smem_raw), acc))
        return;
    const float s = tf32x3::scale_at(scale, 0);
    const int64_t c0 = col0 + tf32x3::col_of();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int64_t r = row0 + tf32x3::row_of(h);
        if (r >= m) continue;
#pragma unroll
        for (int i = 0; i < 16; ++i) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int64_t c = c0 + 8 * i + e;
                if (c >= B) continue;
                const float v = acc[4 * i + 2 * h + e] * tf32x3::POSTSCALE;
                if (part != nullptr)
                    part[(z * m + r) * B + c] = v;
                else
                    S[r * B + c] = L[(r0 + rbeg + r) * n + r0 + c] * s - v;
            }
        }
    }
}

// The split product's second pass: S = s K - sum_z part[z], z in order (no
// atomics: repeats are bit-identical), rows as panel_product_kernel's.
__global__ void __launch_bounds__(256)
panel_reduce_kernel(const float* __restrict__ L, const float* __restrict__ part,
                    float* __restrict__ S, int64_t n, int64_t r0, int64_t rbeg, int64_t B,
                    int64_t splits, const float* __restrict__ scale) {
    const int64_t total = (n - r0 - rbeg) * B;
    const float sc = tf32x3::scale_at(scale, 0);
    const int64_t stride = (int64_t)gridDim.x * blockDim.x;
    for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < total; e += stride) {
        float s = part[e];
        for (int64_t z = 1; z < splits; ++z) s += part[z * total + e];
        S[e] = L[(r0 + rbeg + e / B) * n + r0 + e % B] * sc - s;
    }
}

// One 128 x 128 tile (row0, col0) of the TRSM as a product with the
// explicit inverse, K-colwrite's and K-below-trsm's: the rows below block
// column j's diagonal block, L[r0+B+r, r0+c] = (S . inv^T)[r, c] * unscale,
// map_s over S's m - B rows below (B columns), map_inv over inv (B x B).
// Every thread of the block calls it.
__device__ __forceinline__ void solve_tile(const CUtensorMap* map_s, const CUtensorMap* map_inv,
                                           float* __restrict__ L, int64_t n, int64_t r0,
                                           int64_t B, int64_t row0, int64_t col0, float unscale,
                                           uint8_t* smem) {
    const int64_t below = n - r0 - B;
    float acc[64];
    if (!tf32x3::mainloop(map_s, map_inv, (int)row0, (int)col0, 0,
                          (int)((B + tf32x3::BK - 1) / tf32x3::BK), tf32x3::PRESCALE, smem, acc))
        return;
    const float post = tf32x3::POSTSCALE * unscale;
    const int64_t c0 = col0 + tf32x3::col_of();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int64_t r = row0 + tf32x3::row_of(h);
        if (r >= below) continue;
        float* dst = L + (r0 + B + r) * n + r0;
#pragma unroll
        for (int i = 0; i < 16; ++i) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int64_t c = c0 + 8 * i + e;
                if (c < B) dst[c] = acc[4 * i + 2 * h + e] * post;
            }
        }
    }
}

}  // namespace

