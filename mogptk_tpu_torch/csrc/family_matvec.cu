// K-fam-matvec: out = K(x, x) · V for the Gram of a non-MOSM multi-output
// family (uMOSM, CSM, CONV, MOHSM, SM-LMC), without ever forming K. For
// Hopper (sm_90a), float32, FP32 FFMA throughout.
//
// Replaces the Pallas matvec of the JAX package's family engine,
//   mogptk_tpu/ops/block_families.py  family_matvec_sorted (pallas_call at
//     :504 for the diagonal channel pairs, :525 for the off-diagonal ones;
//     kernels _matvec_diag_kernel and _matvec_offdiag_kernel), the
//     channel-sorted matvec of the iterative engine's CG and Lanczos,
// and, for the families, mogptk_tpu/ops/fused.py fused_gram_matvec
// (pallas_call at :288), the same product for any channel IDs (the engine
// sorts the rows by channel first). Per element the S scalars of the pair
// (c[i], c[j]) (csrc/family_element.cuh).
//
// Bound: operations. Each of the N^2 elements costs one exp and one cos
// (per component for CSM; Q D of each for SM-LMC) and a few FP32 operations
// per input dim, and 2R more for the product, while the bytes are
// O(N (D + R)). Design, as K-matvec's (csrc/mosm_matvec.cu): one block of
// 256 threads owns a row tile of BM rows and all R columns of its output,
// accumulated in shared memory (BM x Rpad floats). It walks the columns of K
// in tiles of BK = 64 points: it evaluates the BM x BK Gram tile once into
// shared memory, then loops over R in chunks of RC = 16*TN columns, staging
// the BK x RC slice of V in shared memory and accumulating the BM x RC
// product with a register micro-tile of (BM/16) x TN outputs per thread.
// Each output row is written once, by the block that owns it: no atomics,
// so a repeated call is bit-identical. BM is 64 while the accumulator fits
// in 128 KiB (R <= 512), else 16; the caller splits R above 2048 into column
// groups. TN = 1 for R <= 16 (the input-dim loop unrolled for D = 1), TN = 4
// otherwise. The pair table sits in shared memory when it fits in 48 KB,
// else it is read from global memory. The TPU kernel evaluated each
// symmetric off-diagonal block once for both directions; this one
// evaluates every tile, as K-matvec does (left for a later change).
#include <cuda_runtime.h>
#include <stdint.h>

#include "family_element.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBK = 64;          // columns of K per tile
constexpr int kMaxAccBytes = 128 * 1024;
constexpr int kMaxTableBytes = 48 * 1024;

__host__ __device__ inline int64_t round_up(int64_t a, int64_t b) { return (a + b - 1) / b * b; }

// shared memory layout, in floats: pair table | xr (BM x D) | cr (BM) |
// xc (BK x D) | cc (BK) | G (BM x (BK+1)) | Vs (BK x RC) | acc (BM x Rpad)
struct Layout {
    int64_t table, xr, cr, xc, cc, G, Vs, acc, total;
};

__host__ __device__ inline Layout layout(int BM, int RC, int64_t Rpad, int O, int S, int D,
                                         bool table_in_smem) {
    Layout s;
    s.table = 0;
    s.xr = table_in_smem ? round_up((int64_t)O * O * S, 4) : 0;
    s.cr = s.xr + round_up((int64_t)BM * D, 4);
    s.xc = s.cr + round_up(BM, 4);
    s.cc = s.xc + round_up((int64_t)kBK * D, 4);
    s.G = s.cc + kBK;
    s.Vs = s.G + round_up((int64_t)BM * (kBK + 1), 4);
    s.acc = s.Vs + (int64_t)kBK * RC;
    s.total = s.acc + (int64_t)BM * Rpad;
    return s;
}

template <int F, int BM, int TN, int kD>
__global__ void __launch_bounds__(kThreads, 2)
family_matvec_kernel(const float* __restrict__ x, const int* __restrict__ c,
                     const float* __restrict__ stats, const float* __restrict__ V,
                     float* __restrict__ out, int64_t N, int R, int O, int S, int D, int A,
                     bool table_in_smem) {
    constexpr int RC = 16 * TN;     // columns of V per chunk
    constexpr int TM = BM / 16;     // rows of the micro-tile
    const int64_t Rpad = round_up(R, RC);
    const Layout L = layout(BM, RC, Rpad, O, S, D, table_in_smem);
    extern __shared__ __align__(16) float smem[];
    const float* table = table_in_smem ? smem + L.table : stats;
    float* xr = smem + L.xr;
    int* cr = reinterpret_cast<int*>(smem + L.cr);
    float* xc = smem + L.xc;
    int* cc = reinterpret_cast<int*>(smem + L.cc);
    float* G = smem + L.G;
    float* Vs = smem + L.Vs;
    float* acc = smem + L.acc;

    const int t = threadIdx.x;
    const int64_t i0 = (int64_t)blockIdx.x * BM;
    if (table_in_smem)
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
                ? Family<F, kD, 0>::value(table + ((int64_t)cr[r] * O + cc[col]) * S, xr + r * D,
                                          xc + col * D, D, A)
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

template <int F, int BM, int TN, int kD>
int launch(const float* x, const int* c, const float* stats, const float* V, float* out,
           int64_t N, int R, int O, int S, int D, int A, cudaStream_t stream) {
    constexpr int RC = 16 * TN;
    const bool in_smem = sizeof(float) * (size_t)O * O * S <= kMaxTableBytes;
    const Layout L = layout(BM, RC, round_up(R, RC), O, S, D, in_smem);
    const size_t smem = sizeof(float) * (size_t)L.total;
    cudaError_t err = cudaFuncSetAttribute(family_matvec_kernel<F, BM, TN, kD>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const unsigned grid = (unsigned)((N + BM - 1) / BM);
    family_matvec_kernel<F, BM, TN, kD><<<grid, kThreads, smem, stream>>>(x, c, stats, V, out, N,
                                                                         R, O, S, D, A, in_smem);
    return (int)cudaGetLastError();
}

template <int F>
int launch_family(const float* x, const int* c, const float* stats, const float* V, float* out,
                  int64_t N, int R, int O, int S, int D, int A, cudaStream_t stream) {
    const bool wide = 64 * 4 * round_up(R, 64) > kMaxAccBytes;
    if (D == 1 && R <= 16)
        return launch<F, 64, 1, 1>(x, c, stats, V, out, N, R, O, S, D, A, stream);
    if (D == 1)
        return wide ? launch<F, 16, 4, 1>(x, c, stats, V, out, N, R, O, S, D, A, stream)
                    : launch<F, 64, 4, 1>(x, c, stats, V, out, N, R, O, S, D, A, stream);
    return wide ? launch<F, 16, 4, 0>(x, c, stats, V, out, N, R, O, S, D, A, stream)
                : launch<F, 64, 4, 0>(x, c, stats, V, out, N, R, O, S, D, A, stream);
}

}  // namespace

// out (N, R) = K(x, x) @ V for x (N, D), channel IDs c (N,), V (N, R), all
// row-major; stats is the (O*O, S) pair table; R <= 2048. fam: the
// FamilyId; A: CSM's Rq, SM-LMC's Q, else 0.
extern "C" int family_matvec_f32(const float* x, const int* c, const float* stats, const float* V,
                                 float* out, int64_t N, int R, int O, int S, int D, int A,
                                 int fam, cudaStream_t stream) {
    if (D < 1 || O < 1 || R < 1 || R > 2048 || ((fam == kCsm || fam == kLmcSm) && A < 1) ||
        S != family_slots(fam, D, A))
        return (int)cudaErrorInvalidValue;
    if (N == 0) return 0;
    switch (fam) {
        case kUmosm: return launch_family<kUmosm>(x, c, stats, V, out, N, R, O, S, D, A, stream);
        case kCsm: return launch_family<kCsm>(x, c, stats, V, out, N, R, O, S, D, A, stream);
        case kConv: return launch_family<kConv>(x, c, stats, V, out, N, R, O, S, D, A, stream);
        case kMohsm: return launch_family<kMohsm>(x, c, stats, V, out, N, R, O, S, D, A, stream);
        case kLmcSm: return launch_family<kLmcSm>(x, c, stats, V, out, N, R, O, S, D, A, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}
