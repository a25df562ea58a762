// The fold: out = K(x, x) · V for a symmetric Gram K that is never formed,
// shared by K-matvec (csrc/mosm_matvec.cu, the MOSM Gram) and K-fam-matvec
// (csrc/family_matvec.cu, the other families' Grams), for Hopper (sm_90a),
// float32.
//
// K(x, x) is symmetric whatever the channel order, so each 128 x 128 tile G
// of the upper triangle of the tile grid is evaluated once and used twice:
// out[I] += G . V[J] and, off the diagonal, out[J] += G^T . V[I], as the TPU
// kernels' _matvec_offdiag_kernel did. That halves the element evaluations,
// which bound the kernel. A work item is (row tile I, super-block of four
// column tiles J4) with tiles J >= I in it (ops/mosm_matvec.fold_items lists
// them, the items with four tiles first so the short diagonal ones fill the
// last wave); one CTA of 8 warps per item and per chunk of 8*NB <= 40
// columns of V. The products run on the tensor cores as 3xTF32: mma.sync
// m16n8k8 .tf32, each operand split into big = rna(x) and small =
// rna(x - big) in registers, three products (small.big, big.small,
// big.big) into FP32 accumulators; each product is within ~12 u |a.b|
// (u = 2^-24), as in gemm_tf32x3.cuh. Each k step's products start from
// zero and are added to the running sums by FP32 adds (fold_step: the
// tensor cores truncate the sums they accumulate). The evaluating threads
// compute G in the A-fragment layout of the first product (warp w: tile
// rows 16w..16w+15), so G . V[J] takes its A operand straight from their
// registers, while V[J] comes from shared memory; they also store G once in
// shared memory (row stride 132), from which the second product reads its A
// operand, G^T, after a barrier. wgmma would need G twice in shared memory,
// K-major each way and split (256 KB for one tile): the warp-level product
// keeps one copy, 68 KB, and two CTAs fit on an SM (~108 KB each at NB = 5).
// No prescale: the products of the Gram and V do not cancel into the
// subnormal range, so the tensor cores' flush of products below FLT_MIN
// moves the result by less than 2^-126 an entry, and the sums keep FP32's
// range. The sums are deterministic: G . V[J] accumulates in registers over
// the item's tiles and goes to one partial slab (slot of the row tile for
// the item's super-block); G^T . V[I] goes to a slab slot of its own per
// (column tile, row tile I). Row tile t owns t + nsupers - t/4 slots,
// slab_base(t) onward (P2 slots for tiles 0..t-1, then P1 slots for
// super-blocks t/4..nsupers-1), and the second pass (mosm_matvec.cu
// mosm_matvec_reduce_f32) sums a row's slots in that fixed order: no
// atomics, repeats bit-identical. The slabs add (t + nsupers - t/4) x 128 x R
// floats per row tile each way (2.8 GB at N = 65,536, R = 33).
//
// The element is a policy E:
//   E::kTableInSmem: the (O*O, S) pair table is copied to shared memory
//     (else read from global memory through the read-only path);
//   E::eval4(p, xi, xj, D, A, k): the four elements k[e] of the pairs whose
//     S scalars start at p[e], for the points xi[e], xj[e] (D floats each);
//     A is the family's component count.
// Elements past N are evaluated on zero points and channel 0, then zeroed.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tf32.cuh"

namespace {

constexpr int FT = 128;            // tile edge
constexpr int FSUPER = 4;          // tiles per super-block
constexpr int FTHREADS = 256;      // 8 warps of 16 tile rows
constexpr int FGS = FT + 4;        // row stride of G in shared memory

__host__ __device__ inline int64_t fold_round4(int64_t a) { return (a + 3) / 4 * 4; }

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

__host__ __device__ inline FoldLayout fold_layout(int vs, int O, int S, int D, bool table_in_smem) {
    FoldLayout s;
    s.table = 0;
    s.xi = table_in_smem ? fold_round4((int64_t)O * O * S) : 0;
    s.ci = s.xi + fold_round4((int64_t)FT * D);
    s.xj = s.ci + FT;
    s.cj = s.xj + fold_round4((int64_t)FT * D);
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

template <class E, int NB>
__global__ void __launch_bounds__(FTHREADS, 2)
matvec_fold_kernel(const float* __restrict__ x, const int* __restrict__ c,
                   const float* __restrict__ stats, const float* __restrict__ V,
                   const int* __restrict__ items, float* __restrict__ part, int64_t N, int R,
                   int O, int S, int D, int A) {
    constexpr int VS = fold_vstride(NB);
    const FoldLayout L = fold_layout(VS, O, S, D, E::kTableInSmem);
    extern __shared__ __align__(16) float smem[];
    const float* table = E::kTableInSmem ? smem + L.table : stats;
    float* xi = smem + L.xi;
    int* ci = reinterpret_cast<int*>(smem + L.ci);
    float* xj = smem + L.xj;
    int* cj = reinterpret_cast<int*>(smem + L.cj);
    float* Vi = smem + L.vi;
    float* Vj = smem + L.vj;
    float* G = smem + L.g;

    const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31, g = lane >> 2, q = lane & 3;
    const int it = items[2 * blockIdx.x], J = items[2 * blockIdx.x + 1];
    const int col0 = blockIdx.y * 8 * NB;
    const int64_t ntiles = (N + FT - 1) / FT, nsupers = (ntiles + FSUPER - 1) / FSUPER;
    const int64_t i0 = (int64_t)it * FT;
    if constexpr (E::kTableInSmem)
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
            E::eval4(pr, xr, xc, D, A, e);   // past N: evaluated, then zero
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

template <class E, int NB>
int launch_fold(const float* x, const int* c, const float* stats, const float* V, const int* items,
                int64_t n_items, float* part, int64_t N, int R, int O, int S, int D, int A,
                cudaStream_t stream) {
    const FoldLayout L = fold_layout(fold_vstride(NB), O, S, D, E::kTableInSmem);
    const size_t smem = sizeof(float) * (size_t)L.total;
    if (E::kTableInSmem && sizeof(float) * (size_t)L.xi > 48 * 1024) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(matvec_fold_kernel<E, NB>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((unsigned)n_items, (unsigned)((R + 8 * NB - 1) / (8 * NB)));
    matvec_fold_kernel<E, NB><<<grid, FTHREADS, smem, stream>>>(x, c, stats, V, items, part, N, R,
                                                                O, S, D, A);
    return (int)cudaGetLastError();
}

// the fold's first pass with nb n-blocks of 8 columns a CTA (1..5):
// part holds fold_slab_base(ntiles, nsupers) slots of 128 x R floats
template <class E>
int launch_fold_nb(int nb, const float* x, const int* c, const float* stats, const float* V,
                   const int* items, int64_t n_items, float* part, int64_t N, int R, int O, int S,
                   int D, int A, cudaStream_t stream) {
    if (R < 1 || N < 1 || n_items < 1) return (int)cudaErrorInvalidValue;
    switch (nb) {
        case 1: return launch_fold<E, 1>(x, c, stats, V, items, n_items, part, N, R, O, S, D, A, stream);
        case 2: return launch_fold<E, 2>(x, c, stats, V, items, n_items, part, N, R, O, S, D, A, stream);
        case 3: return launch_fold<E, 3>(x, c, stats, V, items, n_items, part, N, R, O, S, D, A, stream);
        case 4: return launch_fold<E, 4>(x, c, stats, V, items, n_items, part, N, R, O, S, D, A, stream);
        case 5: return launch_fold<E, 5>(x, c, stats, V, items, n_items, part, N, R, O, S, D, A, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace
