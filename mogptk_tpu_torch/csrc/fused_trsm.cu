// The fused below-TRSM column pipeline of the left-looking blocked Cholesky,
// for Hopper (sm_90a), float32: K-sdiag, K-below-trsm and K-commit.
//
// The factor L (n x n, row-major, leading dimension n) is built in place in
// the buffer that holds K (see blocked_cholesky.cu). For block column j > 0
// (r0 = j*B) the columns left of r0 hold finished L, column j still holds K.
// Per column, on PyTorch's current stream in order: K-sdiag, the B x B panel
// factor and its inverse inv = Ljj^-1 (library calls), K-below-trsm, K-commit.
//
// s_diag_f32 replaces mogptk_tpu/ops/blocked_cholesky.py _s_diag_pallas
// (pallas_call at :414, body _s_diag_kernel at :391):
//   S_jj (B x B) = K[r0:r0+B, r0:r0+B] - C . C^T,  C = L[r0:r0+B, :r0].
//   Bound: operations, B*(B+1)*r0 flops for the lower triangle, all that the
//   panel factor reads (2.1 GFLOP, 0.032 ms at j = 16 of the N = 16,384
//   factor); this kernel computes the whole square, twice that.
//   One B x B output is only (B/64)^2 = 64 tiles of 64^2,
//   which cannot fill 132 SMs over a k of up to 15,872: the k range is split
//   into chunks of k_chunk columns, one block per (tile, chunk), each writing
//   its partial product to a scratch slab; a second kernel sums the slabs in
//   a fixed order (no atomics, so repeats are bit-identical) and subtracts
//   the sum from the K block. The TPU kernel ran the k chunks as a
//   sequential grid axis with the sum in VMEM.
//
// below_trsm_f32 replaces _below_trsm_pallas (pallas_call at :465, body
// _below_trsm_kernel at :432) and the below half of _col_commit (:504):
//   for the rows below the diagonal block,
//   L[r0+B:, r0:r0+B] = (K[r0+B:, r0:r0+B] - A . C^T) . inv^T,  A = L[r0+B:, :r0],
//   written straight into column j: S below the diagonal block never goes to
//   device memory (the unfused K-spanel + K-colwrite pair writes and reads
//   it). Bound: operations, 2*(m-B)*B*(r0+B) flops (68.5 GFLOP, 1.02 ms at
//   j = 16). B is 256 or 512. Design: one block owns TR = 4*RPT whole rows
//   (all B columns), 256 threads, each RPT rows x B/64 columns of the
//   accumulator in registers (64 floats at TR = 32, B = 512; columns
//   g*256 + tx*4 + q, so the product reads shared memory as float4s). The k
//   loop stages 8-deep slices of A's rows and of C k-major in shared memory;
//   the next slice's global loads are issued into registers before the
//   current slice is multiplied, so their latency hides behind the FFMAs.
//   The TRSM epilogue stores the finished S rows in dynamic shared memory
//   (TR x B floats, 64 KB at TR = 32, above the 48 KB static limit) and
//   streams inv^T through the same slice buffer. Each block reads its own K
//   rows of column j before it writes them, and no block reads another
//   block's rows of column j; the left columns are read only. Late columns
//   have few rows below and a long k: TR shrinks (32, 16, 8, 4) until the
//   row tiles fill the SMs once, trading shared-memory reuse of C for
//   occupancy.
//
// col_commit_f32 replaces _col_commit (pallas_call at :504, the diagonal
// half; the rows below are K-below-trsm's store) and, with zero_upper = 1,
// _upper_zero_impl (pallas_call at :540):
//   L[r0:r0+B, r0:r0+B] = Ljj;  with zero_upper, L[r0:r0+B, r0+B:] = 0.
//   Bound: bytes (a copy and a fill). One thread per element, coalesced.
//
// All offsets are 64-bit: n^2 exceeds 2^31 from n = 46,341 on.
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_tile.cuh"

namespace {

// -- K-sdiag ------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS)
s_diag_partial_kernel(const float* __restrict__ L, float* __restrict__ part, int64_t n, int64_t r0,
                      int64_t B, int64_t k_chunk) {
    __shared__ float As[BK][BM + PAD];
    __shared__ float Bs[BK][BN + PAD];
    const int64_t k0 = (int64_t)blockIdx.z * k_chunk;
    const int64_t klen = (r0 - k0 < k_chunk) ? r0 - k0 : k_chunk;
    const float* C = L + r0 * n + k0;  // C[:, k0:k0+klen], leading dim n
    const int64_t row0 = (int64_t)blockIdx.y * BM, col0 = (int64_t)blockIdx.x * BN;
    float acc[4][4];
    gemm_nt_tile(C, n, B, C, n, B, klen, row0, col0, acc, As, Bs);
    float* out = part + (int64_t)blockIdx.z * B * B;
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
    for (int i = 0; i < 4; ++i) {
        const int64_t r = row0 + ty * 4 + i;
        if (r >= B) continue;
        for (int j = 0; j < 4; ++j) {
            const int64_t c = col0 + tx * 4 + j;
            if (c < B) out[r * B + c] = acc[i][j];
        }
    }
}

__global__ void s_diag_reduce_kernel(const float* __restrict__ L, const float* __restrict__ part,
                                     float* __restrict__ out, int64_t n, int64_t r0, int64_t B,
                                     int splits) {
    const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= B * B) return;
    float s = 0.0f;
    for (int z = 0; z < splits; ++z) s += part[(int64_t)z * B * B + e];  // fixed order
    const int64_t r = e / B, c = e % B;
    out[e] = L[(r0 + r) * n + r0 + c] - s;
}

// -- K-below-trsm ---------------------------------------------------------------

constexpr int T_THREADS = 256, T_BK = 8;

// One 8-deep k slice of `rows` rows of M (leading dim ld; M[r*ld + k0 ..]),
// two float4s per row, held in registers between its global load and its
// store to shared memory, so the next slice's loads fly while this one is
// multiplied.
template <int NV>
struct Slice {
    float4 v[NV];

    __device__ __forceinline__ void load(const float* __restrict__ M, int64_t ld, int rows,
                                         int64_t k0) {
#pragma unroll
        for (int s = 0; s < NV; ++s) {
            const int e = threadIdx.x + s * T_THREADS;
            if (e < rows * 2)
                v[s] = *reinterpret_cast<const float4*>(M + (int64_t)(e >> 1) * ld + k0 + (e & 1) * 4);
        }
    }

    // k-major into dst[kk * pitch + r]: with pitch = 4 (mod 32) the 16 rows
    // and two k halves of a warp land in distinct banks
    __device__ __forceinline__ void store(float* __restrict__ dst, int pitch, int rows) const {
#pragma unroll
        for (int s = 0; s < NV; ++s) {
            const int e = threadIdx.x + s * T_THREADS;
            if (e < rows * 2) {
                const int r = e >> 1, kq = (e & 1) * 4;
                dst[(kq + 0) * pitch + r] = v[s].x;
                dst[(kq + 1) * pitch + r] = v[s].y;
                dst[(kq + 2) * pitch + r] = v[s].z;
                dst[(kq + 3) * pitch + r] = v[s].w;
            }
        }
    }
};

// acc[i][g*4+q] += sum_kk a(kk, ty*RPT+i) * b(kk, g*256 + tx*4 + q) over one
// staged slice; a from As (k-major, pitch apitch), b from Bs (k-major, pitch
// bpitch), both 16-byte aligned rows.
template <int RPT, int G>
__device__ __forceinline__ void slice_product(const float* __restrict__ As, int apitch,
                                              const float* __restrict__ Bs, int bpitch,
                                              float (&acc)[RPT][4 * G]) {
    const int ty = threadIdx.x / 64, tx = threadIdx.x % 64;
#pragma unroll
    for (int kk = 0; kk < T_BK; ++kk) {
        float a[RPT], b[4 * G];
        const float* arow = As + kk * apitch + ty * RPT;
        if constexpr (RPT % 4 == 0) {
#pragma unroll
            for (int i = 0; i < RPT; i += 4) {
                const float4 v = *reinterpret_cast<const float4*>(arow + i);
                a[i] = v.x; a[i + 1] = v.y; a[i + 2] = v.z; a[i + 3] = v.w;
            }
        } else {
#pragma unroll
            for (int i = 0; i < RPT; ++i) a[i] = arow[i];
        }
#pragma unroll
        for (int g = 0; g < G; ++g) {
            const float4 v = *reinterpret_cast<const float4*>(Bs + kk * bpitch + g * 256 + tx * 4);
            b[4 * g] = v.x; b[4 * g + 1] = v.y; b[4 * g + 2] = v.z; b[4 * g + 3] = v.w;
        }
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
            for (int c = 0; c < 4 * G; ++c) acc[i][c] = fmaf(a[i], b[c], acc[i][c]);
    }
}

// TR = 4*RPT whole rows of column j below its diagonal block per block, B =
// 256*G columns: thread (ty, tx) owns rows ty*RPT + i and columns
// g*256 + tx*4 + q.
template <int RPT, int G>
__global__ void __launch_bounds__(T_THREADS, 2)
below_trsm_kernel(float* __restrict__ L, const float* __restrict__ inv, int64_t n, int64_t r0) {
    constexpr int TR = 4 * RPT, B = 256 * G;
    constexpr int bpitch = B + 4, apitch = TR + 4, spitch = B + 4;
    extern __shared__ __align__(16) float smem[];
    float* Ss = smem;                      // TR x spitch: the finished S rows
    float* Bs = Ss + TR * spitch;          // T_BK x bpitch: C's (then inv's) k slice
    float* As = Bs + T_BK * bpitch;        // T_BK x apitch: A's k slice
    const int ty = threadIdx.x / 64, tx = threadIdx.x % 64;
    const int64_t row0 = r0 + B + (int64_t)blockIdx.x * TR;  // first global row of the tile
    const float* Arows = L + row0 * n;     // A = L[row0:row0+TR, :r0]
    const float* Crows = L + r0 * n;       // C = L[r0:r0+B, :r0]

    float acc[RPT][4 * G];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int c = 0; c < 4 * G; ++c) acc[i][c] = 0.0f;

    Slice<(2 * B + T_THREADS - 1) / T_THREADS> cs;
    Slice<1> as;                           // 2*TR <= 64 float4s
    cs.load(Crows, n, B, 0);
    as.load(Arows, n, TR, 0);
    for (int64_t k0 = 0; k0 < r0; k0 += T_BK) {
        cs.store(Bs, bpitch, B);
        as.store(As, apitch, TR);
        __syncthreads();
        if (k0 + T_BK < r0) {              // the next slice's loads fly during the product
            cs.load(Crows, n, B, k0 + T_BK);
            as.load(Arows, n, TR, k0 + T_BK);
        }
        slice_product<RPT, G>(As, apitch, Bs, bpitch, acc);
        __syncthreads();
    }

    // S rows = K rows of column j minus the product, kept on chip
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
        const int r = ty * RPT + i;
        const float* krow = L + (row0 + r) * n + r0;
#pragma unroll
        for (int g = 0; g < G; ++g) {
            const int c = g * 256 + tx * 4;
            const float4 k = *reinterpret_cast<const float4*>(krow + c);
            float4 s;
            s.x = k.x - acc[i][4 * g]; s.y = k.y - acc[i][4 * g + 1];
            s.z = k.z - acc[i][4 * g + 2]; s.w = k.w - acc[i][4 * g + 3];
            *reinterpret_cast<float4*>(Ss + r * spitch + c) = s;
        }
#pragma unroll
        for (int c = 0; c < 4 * G; ++c) acc[i][c] = 0.0f;
    }
    __syncthreads();

    // the TRSM as a product with the explicit inverse: out = S . inv^T,
    // out[r][c] = sum_k S[r][k] * inv[c][k]; S read k-major through a
    // transposing copy of the slice into As
    cs.load(inv, B, B, 0);
    for (int k0 = 0; k0 < B; k0 += T_BK) {
        cs.store(Bs, bpitch, B);
        for (int e = threadIdx.x; e < TR * T_BK; e += T_THREADS) {
            const int r = e / T_BK, kk = e % T_BK;
            As[kk * apitch + r] = Ss[r * spitch + k0 + kk];
        }
        __syncthreads();
        if (k0 + T_BK < B) cs.load(inv, B, B, k0 + T_BK);
        slice_product<RPT, G>(As, apitch, Bs, bpitch, acc);
        __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
        float* lrow = L + (row0 + ty * RPT + i) * n + r0;
#pragma unroll
        for (int g = 0; g < G; ++g)
            *reinterpret_cast<float4*>(lrow + g * 256 + tx * 4) =
                make_float4(acc[i][4 * g], acc[i][4 * g + 1], acc[i][4 * g + 2], acc[i][4 * g + 3]);
    }
}

template <int RPT, int G>
int launch_below_trsm(float* L, const float* inv, int64_t n, int64_t r0, cudaStream_t stream) {
    constexpr int TR = 4 * RPT, B = 256 * G;
    const size_t smem = sizeof(float) * ((size_t)TR * (B + 4) + (size_t)T_BK * (B + 4)
                                         + (size_t)T_BK * (TR + 4));
    cudaError_t err = cudaFuncSetAttribute(below_trsm_kernel<RPT, G>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int64_t tiles = (n - r0 - B) / TR;
    below_trsm_kernel<RPT, G><<<(unsigned)tiles, T_THREADS, smem, stream>>>(L, inv, n, r0);
    return (int)cudaGetLastError();
}

template <int G>
int launch_below_trsm_rows(float* L, const float* inv, int64_t n, int64_t r0, cudaStream_t stream) {
    // the widest row tile whose count still fills the H100's 132 SMs once
    const int64_t rows = n - r0 - 256 * G;
    const int64_t fill = 132;
    if (rows / 32 >= fill) return launch_below_trsm<8, G>(L, inv, n, r0, stream);
    if (rows / 16 >= fill) return launch_below_trsm<4, G>(L, inv, n, r0, stream);
    if (rows / 8 >= fill) return launch_below_trsm<2, G>(L, inv, n, r0, stream);
    return launch_below_trsm<1, G>(L, inv, n, r0, stream);
}

// -- K-commit -------------------------------------------------------------------

__global__ void col_commit_kernel(float* __restrict__ L, const float* __restrict__ Ljj, int64_t n,
                                  int64_t r0, int64_t B, int64_t width) {
    const int64_t r = blockIdx.y;
    const int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (c >= width) return;
    L[(r0 + r) * n + r0 + c] = c < B ? Ljj[r * B + c] : 0.0f;
}

}  // namespace

extern "C" int s_diag_f32(const float* L, float* part, float* out, int64_t n, int64_t r0, int64_t B,
                          int64_t k_chunk, cudaStream_t stream) {
    if (r0 <= 0 || B <= 0 || r0 + B > n || k_chunk <= 0 || k_chunk % BK != 0)
        return (int)cudaErrorInvalidValue;
    const int64_t splits = (r0 + k_chunk - 1) / k_chunk;
    dim3 grid((unsigned)((B + BN - 1) / BN), (unsigned)((B + BM - 1) / BM), (unsigned)splits);
    s_diag_partial_kernel<<<grid, THREADS, 0, stream>>>(L, part, n, r0, B, k_chunk);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const int64_t elems = B * B;
    s_diag_reduce_kernel<<<(unsigned)((elems + 255) / 256), 256, 0, stream>>>(L, part, out, n, r0, B,
                                                                            (int)splits);
    return (int)cudaGetLastError();
}

extern "C" int below_trsm_f32(float* L, const float* inv, int64_t n, int64_t r0, int64_t B,
                              cudaStream_t stream) {
    // B 256 or 512, n and r0 multiples of B, rows below the block: every row
    // tile and k slice is whole, and the float4 loads are aligned
    if ((B != 256 && B != 512) || r0 <= 0 || r0 % B != 0 || n % B != 0 || r0 + B >= n)
        return (int)cudaErrorInvalidValue;
    return B == 512 ? launch_below_trsm_rows<2>(L, inv, n, r0, stream)
                    : launch_below_trsm_rows<1>(L, inv, n, r0, stream);
}

extern "C" int col_commit_f32(float* L, const float* Ljj, int64_t n, int64_t r0, int64_t B,
                              int zero_upper, cudaStream_t stream) {
    if (B <= 0 || r0 < 0 || r0 + B > n || B > 65535) return (int)cudaErrorInvalidValue;
    const int64_t width = zero_upper ? n - r0 : B;
    dim3 grid((unsigned)((width + 255) / 256), (unsigned)B);
    col_commit_kernel<<<grid, 256, 0, stream>>>(L, Ljj, n, r0, B, width);
    return (int)cudaGetLastError();
}
