// K-matvec: out = K(x, x) · V for the MOSM Gram of channel-pair statistics,
// without ever forming K. For Hopper (sm_90a), float32, FP32 FFMA throughout.
//
// Replaces two Pallas kernels of the JAX package:
//   mogptk_tpu/ops/block_mosm.py  mosm_matvec_sorted (pallas_call at :507 for
//     the diagonal channel pairs, :530 for the off-diagonal ones; kernels
//     _matvec_diag_kernel :244 and _matvec_offdiag_kernel :258), the
//     channel-sorted matvec of the iterative engine's CG and Lanczos;
//   mogptk_tpu/ops/fused.py  fused_gram_matvec (pallas_call at :288), the
//     same product for any channel IDs through one-hot gathers (its MOSM
//     family; the engine sorts the rows by channel first).
// Per element, the statistics those of the pair (c[i], c[j]), as K-gram
// (csrc/mosm_element.cuh, shared with csrc/mosm_gram.cu):
//   K[i,j] = sum_q alpha_q * exp(-1/2 sum_d V_qd tau_d^2) * cos(2 pi (sum_d M_qd tau_d + dphi_q)),
//   tau_d = x[i,d] - x[j,d] + dtheta_qd.
//
// Bound: operations. Each of the N^2 elements costs Q exp and Q cos plus
// ~6D+7 FP32 operations per component, and 2R more for the product, while
// the bytes are O(N (D + R)). Design: one block of 256 threads owns a row
// tile of BM rows and ALL R columns of its output, accumulated in shared
// memory (BM x Rpad floats). It walks the columns of K in tiles of BK = 64
// points: it evaluates the BM x BK Gram tile ONCE into shared memory (full-
// precision expf/cosf: the cosine argument reaches ~220 rad at x in
// [0, 100], where the fast-math __cosf is wrong), then loops over R in
// chunks of RC = 16*TN columns, staging the BK x RC slice of V in shared
// memory and accumulating the BM x RC product with a register micro-tile of
// (BM/16) x TN outputs per thread. Each output row is written once, at the
// end, by the block that owns it: no atomics, so a repeated call is
// bit-identical. BM shrinks (64, 32, 16) as R grows so the accumulator fits
// (at most 128 KiB); R above 2048 is split into column groups by the caller.
// Left for later: evaluating each symmetric off-diagonal tile once for both
// directions (as the TPU kernel did), and tensor cores (3xTF32 or wgmma)
// for wide R.
//
// Two instances (ops/mosm_gram.kernel_instance chooses): the unrolled one
// above (D <= kMaxD, the pair table in shared memory within 48 KB), and a
// generic one for any D and O (the element's input-dim loop to the runtime
// D, the pair table read from global memory through the read-only path;
// TN = 4 for every R).
#include <cuda_runtime.h>
#include <stdint.h>

#include "mosm_element.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBK = 64;          // columns of K per tile
constexpr int kMaxAccBytes = 128 * 1024;

__host__ __device__ inline int64_t round_up(int64_t a, int64_t b) { return (a + b - 1) / b * b; }

// shared memory layout, in floats: pair table | xr (BM x D) | cr (BM) |
// xc (BK x D) | cc (BK) | G (BM x (BK+1)) | Vs (BK x RC) | acc (BM x Rpad)
struct Layout {
    int64_t table, xr, cr, xc, cc, G, Vs, acc, total;
};

__host__ __device__ inline Layout layout(int BM, int RC, int64_t Rpad, int O, int Q, int D,
                                         bool table_in_smem) {
    Layout s;
    s.table = 0;
    s.xr = table_in_smem ? round_up((int64_t)O * O * (3 * Q * D + 2 * Q), 4) : 0;
    s.cr = s.xr + round_up((int64_t)BM * D, 4);
    s.xc = s.cr + round_up(BM, 4);
    s.cc = s.xc + round_up((int64_t)kBK * D, 4);
    s.G = s.cc + kBK;
    s.Vs = s.G + round_up((int64_t)BM * (kBK + 1), 4);
    s.acc = s.Vs + (int64_t)kBK * RC;
    s.total = s.acc + (int64_t)BM * Rpad;
    return s;
}

template <int BM, int TN, bool kUnrolled>
__global__ void __launch_bounds__(kThreads, 2)
mosm_matvec_kernel(const float* __restrict__ x, const int* __restrict__ c,
                   const float* __restrict__ stats, const float* __restrict__ V,
                   float* __restrict__ out, int64_t N, int R, int O, int Q, int D) {
    constexpr int RC = 16 * TN;     // columns of V per chunk
    constexpr int TM = BM / 16;     // rows of the micro-tile
    const int64_t Rpad = round_up(R, RC);
    const Layout L = layout(BM, RC, Rpad, O, Q, D, kUnrolled);
    extern __shared__ __align__(16) float smem[];
    const float* table = kUnrolled ? smem + L.table : stats;
    float* xr = smem + L.xr;
    int* cr = reinterpret_cast<int*>(smem + L.cr);
    float* xc = smem + L.xc;
    int* cc = reinterpret_cast<int*>(smem + L.cc);
    float* G = smem + L.G;
    float* Vs = smem + L.Vs;
    float* acc = smem + L.acc;

    const int t = threadIdx.x;
    const int S = 3 * Q * D + 2 * Q;  // per pair: [V, M, dtheta] x (Q, D), then [alpha, dphi] x Q
    const int64_t i0 = (int64_t)blockIdx.x * BM;
    if constexpr (kUnrolled)
        for (int k = t; k < O * O * S; k += kThreads) smem[L.table + k] = stats[k];
    for (int k = t; k < BM * D; k += kThreads) {
        const int64_t i = i0 + k / D;
        xr[k] = i < N ? x[i * D + k % D] : 0.0f;
    }
    for (int k = t; k < BM; k += kThreads) cr[k] = i0 + k < N ? c[i0 + k] : 0;
    for (int64_t k = t; k < (int64_t)BM * Rpad; k += kThreads) acc[k] = 0.0f;

    const int tx = t & 15;   // product: columns tx*TN .. +TN of the chunk
    const int ty = t >> 4;   //          rows ty + 16*m, m < TM

    for (int64_t j0 = 0; j0 < N; j0 += kBK) {
        __syncthreads();   // the previous tile's G and Vs are no longer read
        for (int k = t; k < kBK * D; k += kThreads) {
            const int64_t j = j0 + k / D;
            xc[k] = j < N ? x[j * D + k % D] : 0.0f;
        }
        if (t < kBK) cc[t] = j0 + t < N ? c[j0 + t] : 0;
        __syncthreads();

        // the BM x BK Gram tile, once; columns past N are zero
        for (int e = t; e < BM * kBK; e += kThreads) {
            const int r = e / kBK, col = e % kBK;
            G[r * (kBK + 1) + col] = j0 + col < N
                ? mosm_element<kUnrolled>(table + (cr[r] * O + cc[col]) * S, xr + r * D,
                                          xc + col * D, Q, D)
                : 0.0f;
        }

        for (int r0 = 0; r0 < R; r0 += RC) {
            __syncthreads();   // G is written; the previous chunk's Vs is read
            for (int k = t; k < kBK * RC; k += kThreads) {
                const int row = k / RC, col = k % RC;
                const int64_t j = j0 + row;
                Vs[k] = (j < N && r0 + col < R) ? V[j * R + r0 + col] : 0.0f;
            }
            __syncthreads();
            float a[TM][TN];
#pragma unroll
            for (int m = 0; m < TM; ++m)
#pragma unroll
                for (int n = 0; n < TN; ++n) a[m][n] = 0.0f;
#pragma unroll 8
            for (int kk = 0; kk < kBK; ++kk) {
                float v[TN];
                const float* vrow = Vs + kk * RC + tx * TN;   // aligned to TN floats
                if constexpr (TN == 4) {
                    const float4 w = *reinterpret_cast<const float4*>(vrow);
                    v[0] = w.x; v[1] = w.y; v[2] = w.z; v[3] = w.w;
                } else if constexpr (TN == 2) {
                    const float2 w = *reinterpret_cast<const float2*>(vrow);
                    v[0] = w.x; v[1] = w.y;
                } else {
                    v[0] = vrow[0];
                }
#pragma unroll
                for (int m = 0; m < TM; ++m) {
                    const float g = G[(ty + 16 * m) * (kBK + 1) + kk];
#pragma unroll
                    for (int n = 0; n < TN; ++n) a[m][n] = fmaf(g, v[n], a[m][n]);
                }
            }
#pragma unroll
            for (int m = 0; m < TM; ++m)
#pragma unroll
                for (int n = 0; n < TN; ++n) acc[(ty + 16 * m) * Rpad + r0 + tx * TN + n] += a[m][n];
        }
    }
    __syncthreads();
    for (int64_t k = t; k < (int64_t)BM * R; k += kThreads) {
        const int64_t r = k / R, col = k % R;
        if (i0 + r < N) out[(i0 + r) * R + col] = acc[r * Rpad + col];
    }
}

template <int BM, int TN, bool kUnrolled>
int launch(const float* x, const int* c, const float* stats, const float* V, float* out,
           int64_t N, int R, int O, int Q, int D, cudaStream_t stream) {
    constexpr int RC = 16 * TN;
    const Layout L = layout(BM, RC, round_up(R, RC), O, Q, D, kUnrolled);
    const size_t smem = sizeof(float) * (size_t)L.total;
    if (kUnrolled && sizeof(float) * (size_t)L.xr > 48 * 1024) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(mosm_matvec_kernel<BM, TN, kUnrolled>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const unsigned grid = (unsigned)((N + BM - 1) / BM);
    mosm_matvec_kernel<BM, TN, kUnrolled><<<grid, kThreads, smem, stream>>>(x, c, stats, V, out,
                                                                           N, R, O, Q, D);
    return (int)cudaGetLastError();
}

template <int TN, bool kUnrolled>
int launch_tn(const float* x, const int* c, const float* stats, const float* V, float* out,
              int64_t N, int R, int O, int Q, int D, cudaStream_t stream) {
    const int64_t acc = 4 * round_up(R, 16 * TN);
    if (64 * acc <= kMaxAccBytes)
        return launch<64, TN, kUnrolled>(x, c, stats, V, out, N, R, O, Q, D, stream);
    if (32 * acc <= kMaxAccBytes)
        return launch<32, TN, kUnrolled>(x, c, stats, V, out, N, R, O, Q, D, stream);
    if (16 * acc <= kMaxAccBytes)
        return launch<16, TN, kUnrolled>(x, c, stats, V, out, N, R, O, Q, D, stream);
    return (int)cudaErrorInvalidValue;
}

}  // namespace

// out (N, R) = K(x, x) @ V for x (N, D), channel IDs c (N,), V (N, R), all
// row-major; stats is the (O*O, 3QD + 2Q) pair table. R <= 2048; D <= 8
// for the unrolled instance (generic = 0), any D for the generic one (1).
extern "C" int mosm_matvec_f32(const float* x, const int* c, const float* stats, const float* V,
                               float* out, int64_t N, int R, int O, int Q, int D, int generic,
                               cudaStream_t stream) {
    if (D < 1 || (!generic && D > kMaxD) || R < 1 || R > 2048) return (int)cudaErrorInvalidValue;
    if (N == 0) return 0;
    if (generic) return launch_tn<4, false>(x, c, stats, V, out, N, R, O, Q, D, stream);
    if (R <= 16) return launch_tn<1, true>(x, c, stats, V, out, N, R, O, Q, D, stream);
    if (R <= 32) return launch_tn<2, true>(x, c, stats, V, out, N, R, O, Q, D, stream);
    return launch_tn<4, true>(x, c, stats, V, out, N, R, O, Q, D, stream);
}
