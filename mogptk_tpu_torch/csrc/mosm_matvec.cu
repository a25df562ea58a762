// K-matvec and K-gram-matvec: out = K(x1, x2) · V for the MOSM Gram of
// channel-pair statistics, without ever forming K. For Hopper (sm_90a),
// float32. K-gram-matvec (x1 != x2) is the FFMA kernel described first;
// K-matvec, the square case x2 = x1, has a design of its own, the fold,
// described after it (mosm_matvec_fold_f32 and its second pass
// mosm_matvec_reduce_f32).
//
// Replaces three Pallas kernels of the JAX package:
//   mogptk_tpu/ops/block_mosm.py  mosm_matvec_sorted (pallas_call at :507 for
//     the diagonal channel pairs, :530 for the off-diagonal ones; kernels
//     _matvec_diag_kernel :244 and _matvec_offdiag_kernel :258), the
//     channel-sorted matvec of the iterative engine's CG and Lanczos;
//   mogptk_tpu/ops/fused.py  fused_gram_matvec (pallas_call at :288), the
//     same product for any channel IDs through one-hot gathers (its MOSM
//     family; the engine sorts the rows by channel first);
//   mogptk_tpu/ops/pallas_mosm.py  mosm_gram_matvec (pallas_call at :351,
//     body _matvec_kernel :313), K(x1, x2) · V for any channel IDs with
//     x1 (N, D) and x2 (M, D) apart: K-gram-matvec. The JAX wrapper padded x with channel 0
//     and V with zero rows to its tile; here the kernel masks the ragged
//     row and column edges itself and reads nothing past N or M.
// Per element, the statistics those of the pair (c1[i], c2[j]), as K-gram
// (csrc/mosm_element.cuh, at full precision):
//   K[i,j] = sum_q alpha_q * exp(-1/2 sum_d V_qd tau_d^2) * cos(2 pi (sum_d M_qd tau_d + dphi_q)),
//   tau_d = x1[i,d] - x2[j,d] + dtheta_qd.
//
// Bound: operations. Each of the N x M elements costs Q exp and Q cos plus
// ~6D+7 FP32 operations per component, and 2R more for the product, while
// the bytes are O((N + M) (D + R)). Design: one block of 256 threads owns a row
// tile of BM rows and ALL R columns of its output, accumulated in shared
// memory (BM x Rpad floats). It walks the M columns of K in tiles of BK =
// 64 points: it evaluates the BM x BK Gram tile ONCE into shared memory (full-
// precision expf/cosf: the cosine argument reaches ~220 rad at x in
// [0, 100], where the fast-math __cosf is wrong), then loops over R in
// chunks of RC = 16*TN columns, staging the BK x RC slice of V in shared
// memory and accumulating the BM x RC product with a register micro-tile of
// (BM/16) x TN outputs per thread. Each output row is written once, at the
// end, by the block that owns it: no atomics, so a repeated call is
// bit-identical. BM shrinks (64, 32, 16) as R grows so the accumulator fits
// (at most 128 KiB); R above 2048 is split into column groups by the caller.
// The fold (K-matvec). K(x, x) is symmetric whatever the channel order, so
// each 128 x 128 tile G of the upper triangle of the tile grid is evaluated
// once and used twice: out[I] += G . V[J] and, off the diagonal,
// out[J] += G^T . V[I], as the TPU kernel's _matvec_offdiag_kernel did.
// That halves the element evaluations, which bound the kernel (Q exp and
// Q cos an element). A work item is (row tile I, super-block of four column
// tiles J4) with tiles J >= I in it (ops/mosm_matvec.fold_items lists them,
// the items with four tiles first so the short diagonal ones fill the last
// wave); one CTA of 8 warps per item and per chunk of 8*NB <= 40 columns of
// V. The products run on the tensor cores as 3xTF32: mma.sync m16n8k8
// .tf32, each operand split into big = rna(x) and small = rna(x - big) in
// registers, three products (small.big, big.small, big.big) into FP32
// accumulators; each product is within ~12 u |a.b| (u = 2^-24), as in
// gemm_tf32x3.cuh. Each k step's products start from zero and are added to
// the running sums by FP32 adds (fold_step: the tensor cores truncate the
// sums they accumulate). The evaluating threads compute G in the A-fragment
// layout of the first product (warp w: tile rows 16w..16w+15), so G . V[J]
// takes its A operand straight from their registers, while V[J] comes from
// shared memory; they also store G once in shared memory (row stride 132),
// from which the second product reads its A operand, G^T, after a barrier.
// wgmma would need G twice in shared memory, K-major each way and split
// (256 KB for one tile): the warp-level product keeps one copy, 68 KB, and
// two CTAs fit on an SM. No prescale: the products of the Gram and V do not
// cancel into the subnormal range, so the tensor cores' flush of products
// below FLT_MIN moves the result by less than 2^-126 an entry, and the sums
// keep FP32's range. The sums are deterministic: G . V[J] accumulates in
// registers over the item's tiles and goes to one partial slab (slot of
// the row tile for the item's super-block); G^T . V[I] goes to a slab slot
// of its own per (column tile, row tile I). Row tile t owns
// t + nsupers - t/4 slots, slab_base(t) onward (P2 slots for tiles 0..t-1,
// then P1 slots for super-blocks t/4..nsupers-1), and the second pass sums a
// row's slots in that fixed order: no atomics, repeats bit-identical.
// Bound: operations, the folded Gram's elements and 2 N^2 R multiply-adds;
// the slabs add (t + nsupers - t/4) x 128 x R floats per row tile each way
// (2.8 GB at N = 65,536, R = 33).
//
// Two instances (ops/mosm_gram.kernel_instance chooses): the unrolled one
// above (D <= kMaxD, the pair table in shared memory within 48 KB), and a
// generic one for any D and O (the element's input-dim loop to the runtime
// D, the pair table read from global memory through the read-only path;
// TN = 4 for every R).
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tf32.cuh"
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
mosm_matvec_kernel(const float* __restrict__ x1, const int* __restrict__ c1,
                   const float* __restrict__ x2, const int* __restrict__ c2,
                   const float* __restrict__ stats, const float* __restrict__ V,
                   float* __restrict__ out, int64_t N, int64_t M, int R, int O, int Q, int D) {
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
        xr[k] = i < N ? x1[i * D + k % D] : 0.0f;
    }
    for (int k = t; k < BM; k += kThreads) cr[k] = i0 + k < N ? c1[i0 + k] : 0;
    for (int64_t k = t; k < (int64_t)BM * Rpad; k += kThreads) acc[k] = 0.0f;

    const int tx = t & 15;   // product: columns tx*TN .. +TN of the chunk
    const int ty = t >> 4;   //          rows ty + 16*m, m < TM

    for (int64_t j0 = 0; j0 < M; j0 += kBK) {
        __syncthreads();   // the previous tile's G and Vs are no longer read
        for (int k = t; k < kBK * D; k += kThreads) {
            const int64_t j = j0 + k / D;
            xc[k] = j < M ? x2[j * D + k % D] : 0.0f;
        }
        if (t < kBK) cc[t] = j0 + t < M ? c2[j0 + t] : 0;
        __syncthreads();

        // the BM x BK Gram tile, once; columns past M are zero
        for (int e = t; e < BM * kBK; e += kThreads) {
            const int r = e / kBK, col = e % kBK;
            G[r * (kBK + 1) + col] = j0 + col < M
                ? mosm_element<kUnrolled>(table + (cr[r] * O + cc[col]) * S, xr + r * D,
                                          xc + col * D, Q, D)
                : 0.0f;
        }

        for (int r0 = 0; r0 < R; r0 += RC) {
            __syncthreads();   // G is written; the previous chunk's Vs is read
            for (int k = t; k < kBK * RC; k += kThreads) {
                const int row = k / RC, col = k % RC;
                const int64_t j = j0 + row;
                Vs[k] = (j < M && r0 + col < R) ? V[j * R + r0 + col] : 0.0f;
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
int launch(const float* x1, const int* c1, const float* x2, const int* c2, const float* stats,
           const float* V, float* out, int64_t N, int64_t M, int R, int O, int Q, int D,
           cudaStream_t stream) {
    constexpr int RC = 16 * TN;
    const Layout L = layout(BM, RC, round_up(R, RC), O, Q, D, kUnrolled);
    const size_t smem = sizeof(float) * (size_t)L.total;
    if (kUnrolled && sizeof(float) * (size_t)L.xr > 48 * 1024) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(mosm_matvec_kernel<BM, TN, kUnrolled>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const unsigned grid = (unsigned)((N + BM - 1) / BM);
    mosm_matvec_kernel<BM, TN, kUnrolled><<<grid, kThreads, smem, stream>>>(
        x1, c1, x2, c2, stats, V, out, N, M, R, O, Q, D);
    return (int)cudaGetLastError();
}

template <int TN, bool kUnrolled>
int launch_tn(const float* x1, const int* c1, const float* x2, const int* c2, const float* stats,
              const float* V, float* out, int64_t N, int64_t M, int R, int O, int Q, int D,
              cudaStream_t stream) {
    const int64_t acc = 4 * round_up(R, 16 * TN);
    if (64 * acc <= kMaxAccBytes)
        return launch<64, TN, kUnrolled>(x1, c1, x2, c2, stats, V, out, N, M, R, O, Q, D, stream);
    if (32 * acc <= kMaxAccBytes)
        return launch<32, TN, kUnrolled>(x1, c1, x2, c2, stats, V, out, N, M, R, O, Q, D, stream);
    if (16 * acc <= kMaxAccBytes)
        return launch<16, TN, kUnrolled>(x1, c1, x2, c2, stats, V, out, N, M, R, O, Q, D, stream);
    return (int)cudaErrorInvalidValue;
}

}  // namespace

// out (N, R) = K(x1, x2) @ V for x1 (N, D), channel IDs c1 (N,), x2 (M, D),
// c2 (M,), V (M, R), all row-major; stats is the (O*O, 3QD + 2Q) pair
// table. R <= 2048; D <= 8 for the unrolled instance (generic = 0), any D
// for the generic one (1).
extern "C" int mosm_gram_matvec_f32(const float* x1, const int* c1, const float* x2, const int* c2,
                                    const float* stats, const float* V, float* out, int64_t N,
                                    int64_t M, int R, int O, int Q, int D, int generic,
                                    cudaStream_t stream) {
    if (D < 1 || (!generic && D > kMaxD) || R < 1 || R > 2048 || M < 0)
        return (int)cudaErrorInvalidValue;
    if (N == 0) return 0;
    if (generic)
        return launch_tn<4, false>(x1, c1, x2, c2, stats, V, out, N, M, R, O, Q, D, stream);
    if (R <= 16) return launch_tn<1, true>(x1, c1, x2, c2, stats, V, out, N, M, R, O, Q, D, stream);
    if (R <= 32) return launch_tn<2, true>(x1, c1, x2, c2, stats, V, out, N, M, R, O, Q, D, stream);
    return launch_tn<4, true>(x1, c1, x2, c2, stats, V, out, N, M, R, O, Q, D, stream);
}

// -- the fold (K-matvec) --------------------------------------------------------

namespace {

constexpr int FT = 128;            // tile edge
constexpr int FSUPER = 4;          // tiles per super-block
constexpr int FTHREADS = 256;      // 8 warps of 16 tile rows
constexpr int FGS = FT + 4;        // row stride of G in shared memory
constexpr int FMAX_NB = 5;         // n-blocks of 8 columns a CTA takes

// row stride of a staged V tile: 8 or 24 (mod 32) floats, so the B
// fragments' loads (rows q, q+4 by columns g) hit 32 distinct banks
__host__ __device__ constexpr int fold_vstride(int nb) {
    return (8 * nb) % 32 == 8 || (8 * nb) % 32 == 24 ? 8 * nb : 8 * nb + 8;
}

// first slab slot of row tile t: sum over t' < t of t' + nsupers - t'/4
__host__ __device__ inline int64_t fold_slab_base(int64_t t, int64_t nsupers) {
    const int64_t q = t / FSUPER, rem = t % FSUPER;
    return t * (t - 1) / 2 + t * nsupers - (2 * q * (q - 1) + rem * q);
}

// shared memory, in floats: pair table | xi (FT x D) | ci | xj | cj | Vi | Vj | G
struct FoldLayout {
    int64_t table, xi, ci, xj, cj, vi, vj, g, total;
};

__host__ __device__ inline FoldLayout fold_layout(int vs, int O, int Q, int D, bool table_in_smem) {
    FoldLayout s;
    s.table = 0;
    s.xi = table_in_smem ? round_up((int64_t)O * O * (3 * Q * D + 2 * Q), 4) : 0;
    s.ci = s.xi + round_up((int64_t)FT * D, 4);
    s.xj = s.ci + FT;
    s.cj = s.xj + round_up((int64_t)FT * D, 4);
    s.vi = s.cj + FT;
    s.vj = s.vi + (int64_t)FT * vs;
    s.g = s.vj + (int64_t)FT * vs;
    s.total = s.g + (int64_t)FT * FGS;
    return s;
}

// acc[u] += A . V[k rows, 8u..8u+7] over one 8-deep k step, 3xTF32
// (mma_tf32.cuh mma3_add): A split in (ab, as), V's rows ka and ka+4 from
// the staged tile vs (stride VS).
template <int NB, int VS>
__device__ __forceinline__ void fold_step(float (&acc)[NB][4], const uint32_t (&ab)[4],
                                          const uint32_t (&as)[4], const float* __restrict__ vs,
                                          int ka, int g) {
#pragma unroll
    for (int u = 0; u < NB; ++u) {
        uint32_t bb0, bs0, bb1, bs1;
        split_tf32(vs[ka * VS + 8 * u + g], bb0, bs0);
        split_tf32(vs[(ka + 4) * VS + 8 * u + g], bb1, bs1);
        mma3_add(acc[u], ab, as, bb0, bs0, bb1, bs1);
    }
}

// The four elements a thread evaluates a k step, interleaved: the component
// loop outermost, so the four exp and cos chains are independent
// instructions for the scheduler to overlap. Per element it is
// mosm_element's arithmetic in mosm_element's order.
template <bool kUnrolled>
__device__ __forceinline__ void mosm_element4(const float* const (&p)[4],
                                              const float* const (&xi)[4],
                                              const float* const (&xj)[4], int Q, int D,
                                              float (&k)[4]) {
    const float two_pi = 6.283185307179586f;
#pragma unroll
    for (int e = 0; e < 4; ++e) k[e] = 0.0f;
    for (int q = 0; q < Q; ++q) {
        float ex[4], a[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) ex[e] = a[e] = 0.0f;
        if constexpr (kUnrolled) {
#pragma unroll
            for (int d = 0; d < kMaxD; ++d) {
                if (d >= D) break;
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const float* s3 = p[e] + 3 * (q * D + d);
                    const float td = (xi[e][d] - xj[e][d]) + s3[2];
                    ex[e] += td * td * s3[0];
                    a[e] += td * s3[1];
                }
            }
        } else {
            for (int d = 0; d < D; ++d) {
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const float* s3 = p[e] + 3 * (q * D + d);
                    const float td = (xi[e][d] - xj[e][d]) + s3[2];
                    ex[e] += td * td * s3[0];
                    a[e] += td * s3[1];
                }
            }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const float* s2 = p[e] + 3 * Q * D + 2 * q;
            k[e] += s2[0] * expf(-0.5f * ex[e]) * cosf(two_pi * (a[e] + s2[1]));
        }
    }
}

// the FT points from row0 and their channels (zeros past N)
__device__ __forceinline__ void fold_stage_points(const float* __restrict__ x,
                                                  const int* __restrict__ c, int64_t row0,
                                                  int64_t N, int D, float* xs, int* cs) {
    for (int k = threadIdx.x; k < FT * D; k += FTHREADS) {
        const int64_t r = row0 + k / D;
        xs[k] = r < N ? x[r * D + k % D] : 0.0f;
    }
    for (int k = threadIdx.x; k < FT; k += FTHREADS) cs[k] = row0 + k < N ? c[row0 + k] : 0;
}

// V[row0 : row0+FT, col0 : col0+8NB] into vs (stride VS; zeros past N and R)
template <int NB, int VS>
__device__ __forceinline__ void fold_stage_v(const float* __restrict__ V, int64_t row0, int64_t N,
                                             int R, int col0, float* vs) {
    for (int k = threadIdx.x; k < FT * VS; k += FTHREADS) {
        const int r = k / VS, col = k % VS;
        vs[k] = (row0 + r < N && col < 8 * NB && col0 + col < R)
                    ? V[(row0 + r) * R + col0 + col] : 0.0f;
    }
}

// a C fragment set (rows ra and rb of a tile from row0, columns col0 + 8u +
// 2q + e) into the slab slot dst (FT x R, row-major)
template <int NB>
__device__ __forceinline__ void fold_write(float* __restrict__ dst, const float (&acc)[NB][4],
                                           int64_t row0, int64_t N, int R, int col0, int ra,
                                           int rb, int q) {
#pragma unroll
    for (int u = 0; u < NB; ++u) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int r = h ? rb : ra;
            if (row0 + r >= N) continue;
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int col = col0 + 8 * u + 2 * q + e;
                if (col < R) dst[(int64_t)r * R + col] = acc[u][2 * h + e];
            }
        }
    }
}

template <int NB, bool kUnrolled>
__global__ void __launch_bounds__(FTHREADS, 2)
matvec_fold_kernel(const float* __restrict__ x, const int* __restrict__ c,
                   const float* __restrict__ stats, const float* __restrict__ V,
                   const int* __restrict__ items, float* __restrict__ part, int64_t N, int R,
                   int O, int Q, int D) {
    constexpr int VS = fold_vstride(NB);
    const FoldLayout L = fold_layout(VS, O, Q, D, kUnrolled);
    extern __shared__ __align__(16) float smem[];
    const float* table = kUnrolled ? smem + L.table : stats;
    float* xi = smem + L.xi;
    int* ci = reinterpret_cast<int*>(smem + L.ci);
    float* xj = smem + L.xj;
    int* cj = reinterpret_cast<int*>(smem + L.cj);
    float* Vi = smem + L.vi;
    float* Vj = smem + L.vj;
    float* G = smem + L.g;

    const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31, g = lane >> 2, q = lane & 3;
    const int S = 3 * Q * D + 2 * Q;
    const int it = items[2 * blockIdx.x], J = items[2 * blockIdx.x + 1];
    const int col0 = blockIdx.y * 8 * NB;
    const int64_t ntiles = (N + FT - 1) / FT, nsupers = (ntiles + FSUPER - 1) / FSUPER;
    const int64_t i0 = (int64_t)it * FT;
    if constexpr (kUnrolled)
        for (int k = tid; k < O * O * S; k += FTHREADS) smem[L.table + k] = stats[k];
    fold_stage_points(x, c, i0, N, D, xi, ci);
    fold_stage_v<NB, VS>(V, i0, N, R, col0, Vi);

    float acc1[NB][4];
#pragma unroll
    for (int u = 0; u < NB; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc1[u][e] = 0.0f;
    const int ra = 16 * w + g, rb = ra + 8;   // this thread's tile rows in both products
    const bool va = i0 + ra < N, vb = i0 + rb < N;
    const int64_t jend = (int64_t)FSUPER * J + FSUPER < ntiles ? (int64_t)FSUPER * J + FSUPER : ntiles;
    for (int64_t jt = (int64_t)FSUPER * J > it ? (int64_t)FSUPER * J : it; jt < jend; ++jt) {
        const int64_t j0 = jt * FT;
        const bool fold = jt != it;
        __syncthreads();   // the previous tile's G, Vj and points are read
        fold_stage_points(x, c, j0, N, D, xj, cj);
        fold_stage_v<NB, VS>(V, j0, N, R, col0, Vj);
        __syncthreads();
        const float* pa = xi + ra * D;
        const float* pb = xi + rb * D;
        const int cra = ci[ra] * O, crb = ci[rb] * O;
        // G in the A layout of out[I] += G . V[J]: element (ra|rb, ka|kb)
#pragma unroll 1
        for (int s = 0; s < FT / 8; ++s) {
            const int ka = 8 * s + q, kb = ka + 4;
            const bool wa = j0 + ka < N, wb = j0 + kb < N;
            const float* const pr[4] = {table + (cra + cj[ka]) * S, table + (crb + cj[ka]) * S,
                                        table + (cra + cj[kb]) * S, table + (crb + cj[kb]) * S};
            const float* const xr[4] = {pa, pb, pa, pb};
            const float* const xc[4] = {xj + ka * D, xj + ka * D, xj + kb * D, xj + kb * D};
            float e[4];
            mosm_element4<kUnrolled>(pr, xr, xc, Q, D, e);   // past N: evaluated, then zero
            e[0] = va && wa ? e[0] : 0.0f;
            e[1] = vb && wa ? e[1] : 0.0f;
            e[2] = va && wb ? e[2] : 0.0f;
            e[3] = vb && wb ? e[3] : 0.0f;
            if (fold) {
                G[ra * FGS + ka] = e[0];
                G[rb * FGS + ka] = e[1];
                G[ra * FGS + kb] = e[2];
                G[rb * FGS + kb] = e[3];
            }
            uint32_t ab[4], as[4];
#pragma unroll
            for (int k = 0; k < 4; ++k) split_tf32(e[k], ab[k], as[k]);
            fold_step<NB, VS>(acc1, ab, as, Vj, ka, g);
        }
        if (fold) {   // out[J] += G^T . V[I]: A = G^T from shared memory
            __syncthreads();
            float acc2[NB][4];
#pragma unroll
            for (int u = 0; u < NB; ++u)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc2[u][e] = 0.0f;
#pragma unroll 2
            for (int s = 0; s < FT / 8; ++s) {
                const int ka = 8 * s + q, kb = ka + 4;
                uint32_t ab[4], as[4];
                split_tf32(G[ka * FGS + ra], ab[0], as[0]);
                split_tf32(G[ka * FGS + rb], ab[1], as[1]);
                split_tf32(G[kb * FGS + ra], ab[2], as[2]);
                split_tf32(G[kb * FGS + rb], ab[3], as[3]);
                fold_step<NB, VS>(acc2, ab, as, Vi, ka, g);
            }
            fold_write<NB>(part + (fold_slab_base(jt, nsupers) + it) * FT * R, acc2, j0, N, R, col0,
                           ra, rb, q);
        }
    }
    fold_write<NB>(part + (fold_slab_base(it, nsupers) + it + (J - it / FSUPER)) * FT * R, acc1,
                   i0, N, R, col0, ra, rb, q);
}

template <int NB, bool kUnrolled>
int launch_fold(const float* x, const int* c, const float* stats, const float* V, const int* items,
                int64_t n_items, float* part, int64_t N, int R, int O, int Q, int D,
                cudaStream_t stream) {
    const FoldLayout L = fold_layout(fold_vstride(NB), O, Q, D, kUnrolled);
    const size_t smem = sizeof(float) * (size_t)L.total;
    if (kUnrolled && sizeof(float) * (size_t)L.xi > 48 * 1024) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(matvec_fold_kernel<NB, kUnrolled>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((unsigned)n_items, (unsigned)((R + 8 * NB - 1) / (8 * NB)));
    matvec_fold_kernel<NB, kUnrolled><<<grid, FTHREADS, smem, stream>>>(x, c, stats, V, items, part,
                                                                        N, R, O, Q, D);
    return (int)cudaGetLastError();
}

template <bool kUnrolled>
int launch_fold_nb(int nb, const float* x, const int* c, const float* stats, const float* V,
                   const int* items, int64_t n_items, float* part, int64_t N, int R, int O, int Q,
                   int D, cudaStream_t stream) {
    switch (nb) {
        case 1: return launch_fold<1, kUnrolled>(x, c, stats, V, items, n_items, part, N, R, O, Q, D, stream);
        case 2: return launch_fold<2, kUnrolled>(x, c, stats, V, items, n_items, part, N, R, O, Q, D, stream);
        case 3: return launch_fold<3, kUnrolled>(x, c, stats, V, items, n_items, part, N, R, O, Q, D, stream);
        case 4: return launch_fold<4, kUnrolled>(x, c, stats, V, items, n_items, part, N, R, O, Q, D, stream);
        case 5: return launch_fold<5, kUnrolled>(x, c, stats, V, items, n_items, part, N, R, O, Q, D, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}

__global__ void __launch_bounds__(256)
matvec_reduce_kernel(const float* __restrict__ part, float* __restrict__ out, int64_t N, int R) {
    const int64_t ntiles = (N + FT - 1) / FT, nsupers = (ntiles + FSUPER - 1) / FSUPER;
    const int64_t total = N * R, stride = (int64_t)gridDim.x * blockDim.x, slot = (int64_t)FT * R;
    for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < total; e += stride) {
        const int64_t row = e / R, col = e % R, t = row / FT;
        const int64_t count = t + nsupers - t / FSUPER;
        const float* p = part + (fold_slab_base(t, nsupers) * FT + row % FT) * R + col;
        float s = p[0];
#pragma unroll 8
        for (int64_t k = 1; k < count; ++k) s += p[k * slot];   // fixed order
        out[e] = s;
    }
}

}  // namespace

// K-matvec's partial slabs: out (N, R) = K(x, x) @ V is the second pass's
// sum of part, which holds fold_slab_base(ntiles) slots of 128 x R floats.
// items: n_items (row tile, super-block) pairs (ops/mosm_matvec.fold_items);
// nb: n-blocks of 8 columns a CTA takes (1..5), the grid's second axis
// covering R. generic as mosm_gram_matvec_f32's.
extern "C" int mosm_matvec_fold_f32(const float* x, const int* c, const float* stats, const float* V,
                                    const int* items, int64_t n_items, float* part, int64_t N, int R,
                                    int nb, int O, int Q, int D, int generic, cudaStream_t stream) {
    if (D < 1 || (!generic && D > kMaxD) || R < 1 || nb < 1 || nb > FMAX_NB || N < 1
        || n_items < 1)
        return (int)cudaErrorInvalidValue;
    if (generic)
        return launch_fold_nb<false>(nb, x, c, stats, V, items, n_items, part, N, R, O, Q, D, stream);
    return launch_fold_nb<true>(nb, x, c, stats, V, items, n_items, part, N, R, O, Q, D, stream);
}

// K-matvec's second pass: out (N, R) row by row, each the sum of its row
// tile's slab slots in slot order.
extern "C" int mosm_matvec_reduce_f32(const float* part, float* out, int64_t N, int R,
                                      cudaStream_t stream) {
    if (N < 1 || R < 1) return (int)cudaErrorInvalidValue;
    const int64_t total = N * R;
    int64_t blocks = (total + 255) / 256;
    if (blocks > 65535) blocks = 65535;
    matvec_reduce_kernel<<<(unsigned)blocks, 256, 0, stream>>>(part, out, N, R);
    return (int)cudaGetLastError();
}
