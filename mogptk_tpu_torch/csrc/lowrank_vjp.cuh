// The low-rank cotangent tile shared by K-lowrank-vjp
// (csrc/mosm_lowrank_vjp.cu, the MOSM pair statistics), K-fam-lowrank-vjp
// (csrc/family_lowrank_vjp.cu, a family's pack) and, in its cross mode,
// K-gram-lowrank-vjp (csrc/mosm_gram_lowrank_vjp.cu, the Gram of two point
// sets: no fold, g = A_i B_j^T with k = R, the rows of A and B gathered
// through the channel maps as they are staged, operand stride KH + 4), for
// Hopper (sm_90a), float32. The fold, described first:
//
// The rows are channel-sorted and each channel is padded with zero rows of
// A and B to a multiple of 256, so padding adds nothing. A host-built list
// (ops/block_mosm._pair_layout) names every upper 256^2 tile (ti <= tj) of
// every upper channel pair (a <= b), grouped by pair; a block of 8 warps
// takes a 128 x 128 quarter of one (four blocks per tile). Its cotangent
//   g = A_i B_j^T + [ti != tj] B_i A_j^T      (the transposed lower tile folded in)
// is one 128 x 128 x 2R product, [A_i | B_i] . [B_j | A_j]^T (k = R alone,
// A_i . B_j^T, on a diagonal tile), on the tensor cores: 3xTF32 mma.sync
// m16n8k8 (mma_tf32.cuh, each k step's products summed fresh and added to
// the running sums by FP32 adds), with both operands in shared memory as
// [row][k] (row stride 2 KH + 4 = 4 or 20 mod 32: the fragments' loads hit
// 32 banks); each half of k is padded with zeros to KH, a multiple of 8. Warp
// w owns the 64 x 32 sub-tile at rows 64 (w / 4), columns 32 (w % 4); its
// accumulator fragments are the thread's 8 x 8 elements of g (rows 16 mi +
// lane / 4 + 8h, columns 8 ni + 2 (lane % 4) + e), which go straight from
// registers into the element chain: g never touches shared memory. No 2^16
// prescale: a product below FLT_MIN that the tensor cores flush moves an
// element of g by < 2^-126 R, far below the float32 rounding of the
// cotangents it feeds (chip_smoke.py holds every case against float64).
//
// Any R: the operands hold RC <= 64 columns of A and B at a time
// (ops/block_mosm.lowrank_chunk chooses RC, lowrank_kpad its KH), and g
// accumulates over the chunks in order, so the element chain runs once per
// element whatever R is, and the result stays deterministic.
//
// The unrolled instances' element chain is a policy E:
//   E::kD, E::kSlots: the input dims and the pair's cotangent slots;
//   E::kMinBlocks: blocks an SM for __launch_bounds__;
//   E(row): built by every thread after the product from the pair's row of
//     the table, staged in shared memory (kSlots floats) before it;
//   e.add4(gv, xi, xj, acc): acc += the slot cotangents of four elements,
//     the point xi (kD floats) against xj[k], cotangents gv[k].
// Each block writes its kSlots partial sums (a fixed-order warp and block
// reduction, no atomics) to its row of the partial table; the caller's
// second kernel sums each pair's rows in a fixed order in float64.
#pragma once
#include "mma_tf32.cuh"
#include "mosm_pair_vjp.cuh"

namespace {

constexpr int kMaxRC = 64;      // columns of A and B in the operands at a time

// row stride of the operands in shared memory: [A | B] halves of KH each
// (the fold), or one half (the cross call); 4 or 20 (12, 28) mod 32, so the
// fragments' loads hit 32 distinct banks
__host__ __device__ constexpr int operand_stride(int kh, bool cross = false) {
    return cross ? kh + 4 : 2 * kh + 4;
}

// The thread's 8 x 8 elements of g for this block's quarter, accumulated
// over R in chunks of RC columns (KH: RC padded to a multiple of 8) staged
// in shared memory (ops: two [kSub][operand_stride(KH, kCross)] arrays).
// g[mi][ni][c]: row 64 (w / 4) + 16 mi + lane / 4 + 8 (c / 2), column
// 32 (w % 4) + 8 ni + 2 (lane % 4) + c % 2.
// kCross (K-gram-lowrank-vjp, the Gram of two point sets): g = A_i B_j^T,
// k = R alone, A's rows gathered through rows[r] and B's through cols[r]
// (the quarter's laid-out positions: the point there, -1 for padding, which
// stages a zero row); else the fold over one channel-sorted layout.
template <bool kCross>
__device__ __forceinline__ void lowrank_g(const int* __restrict__ idx,
                                          const float* __restrict__ A,
                                          const float* __restrict__ Bm, const int* rows,
                                          const int* cols, int R, int RC, int KH, float* ops,
                                          float (&g)[4][4][4], int64_t& row0, int64_t& col0) {
    const int SK = operand_stride(KH, kCross);
    float* Sa = ops;                 // [A_i | B_i], or A_i
    float* Sb = ops + kSub * SK;     // [B_j | A_j], or B_j
    const int s = blockIdx.x / 4, quarter = blockIdx.x % 4;
    const int ti = idx[3 * s], tj = idx[3 * s + 1];
    const int nk = (kCross || ti == tj ? KH : 2 * KH) / 8;
    row0 = (int64_t)ti * kTile + (quarter / 2) * kSub;
    col0 = (int64_t)tj * kTile + (quarter % 2) * kSub;
    const int t = threadIdx.x, w = t >> 5, lane = t & 31, gq = lane >> 2, q = lane & 3;
    const int wr = w >> 2, wc = w & 3;
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
            for (int c = 0; c < 4; ++c) g[mi][ni][c] = 0.0f;
    for (int r0 = 0; r0 < R; r0 += RC) {
        const int rc = min(RC, R - r0);
        __syncthreads();   // the previous chunk's operands are read
        for (int e = t; e < kSub * KH; e += kThreads) {
            const int r = e / KH, k = e % KH;   // consecutive threads, consecutive addresses
            const bool ok = k < rc;
            if constexpr (kCross) {
                const int i = rows[r], j = cols[r];
                Sa[r * SK + k] = ok && i >= 0 ? A[(int64_t)i * R + r0 + k] : 0.0f;
                Sb[r * SK + k] = ok && j >= 0 ? Bm[(int64_t)j * R + r0 + k] : 0.0f;
            } else {
                const int64_t ri = (row0 + r) * R + r0 + k, rj = (col0 + r) * R + r0 + k;
                Sa[r * SK + k] = ok ? A[ri] : 0.0f;
                Sa[r * SK + KH + k] = ok ? Bm[ri] : 0.0f;
                Sb[r * SK + k] = ok ? Bm[rj] : 0.0f;
                Sb[r * SK + KH + k] = ok ? A[rj] : 0.0f;
            }
        }
        __syncthreads();
        for (int ks = 0; ks < nk; ++ks) {
            const int ka = 8 * ks + q, kb = ka + 4;
            uint32_t bb0[4], bs0[4], bb1[4], bs1[4];
#pragma unroll
            for (int ni = 0; ni < 4; ++ni) {
                const float* b = Sb + (32 * wc + 8 * ni + gq) * SK;
                split_tf32(b[ka], bb0[ni], bs0[ni]);
                split_tf32(b[kb], bb1[ni], bs1[ni]);
            }
#pragma unroll
            for (int mi = 0; mi < 4; ++mi) {
                const float* a = Sa + (64 * wr + 16 * mi + gq) * SK;
                uint32_t ab[4], as[4];
                split_tf32(a[ka], ab[0], as[0]);
                split_tf32(a[8 * SK + ka], ab[1], as[1]);
                split_tf32(a[kb], ab[2], as[2]);
                split_tf32(a[8 * SK + kb], ab[3], as[3]);
#pragma unroll
                for (int ni = 0; ni < 4; ++ni)
                    mma3_add(g[mi][ni], ab, as, bb0[ni], bs0[ni], bb1[ni], bs1[ni]);
            }
        }
    }
}

// The rows and columns of the thread's elements within the quarter: element
// (u, v) is g[u / 2][v / 2][2 (u % 2) + v % 2].
__device__ __forceinline__ int elem_row(int u) {
    const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
    return 64 * (w >> 2) + 16 * (u >> 1) + (lane >> 2) + 8 * (u & 1);
}

__device__ __forceinline__ int elem_col(int v) {
    const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
    return 32 * (w & 3) + 8 * (v >> 1) + 2 * (lane & 3) + (v & 1);
}

// Each of the thread's rows (inputs xi) against its eight columns (xj) with
// cotangents g through E, four at a time; the block's sums to out (every
// thread calls it).
template <class E>
__device__ __forceinline__ void lowrank_chain(const float (&g)[4][4][4],
                                              const float (&xi)[8][E::kD],
                                              const float (&xj)[8][E::kD], const float* st,
                                              float (&red)[kThreads / 32][E::kSlots],
                                              float* __restrict__ out) {
    constexpr int NS = E::kSlots, D = E::kD;
    const E elem(st);
    float acc[NS];
#pragma unroll
    for (int k = 0; k < NS; ++k) acc[k] = 0.0f;
#pragma unroll
    for (int u = 0; u < 8; ++u)
#pragma unroll
        for (int v0 = 0; v0 < 8; v0 += 4) {
            float gv[4], xs[4][D];
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                const int v = v0 + k;
                gv[k] = g[u >> 1][v >> 1][2 * (u & 1) + (v & 1)];
#pragma unroll
                for (int d = 0; d < D; ++d) xs[k][d] = xj[v][d];
            }
            elem.add4(gv, xi[u], xs, acc);
        }
    block_reduce_store<NS>(acc, red, out);
}

// The unrolled instance: g, then each of the thread's rows against its
// eight columns through E, four at a time.
template <class E>
__global__ void __launch_bounds__(kThreads, E::kMinBlocks)
lowrank_vjp_kernel(const int* __restrict__ idx, const float* __restrict__ x,
                   const float* __restrict__ A, const float* __restrict__ Bm,
                   const float* __restrict__ stats, float* __restrict__ partial, int R, int RC,
                   int KH) {
    constexpr int NS = E::kSlots, D = E::kD;
    extern __shared__ __align__(16) float ops[];
    __shared__ float st[NS];
    __shared__ float red[kThreads / 32][NS];
    const int pair = idx[3 * (blockIdx.x / 4) + 2];
    for (int e = threadIdx.x; e < NS; e += kThreads) st[e] = stats[(int64_t)pair * NS + e];
    float g[4][4][4];
    int64_t row0, col0;
    lowrank_g<false>(idx, A, Bm, nullptr, nullptr, R, RC, KH, ops, g, row0, col0);   // syncs after st

    float xi[8][D], xj[8][D];
#pragma unroll
    for (int u = 0; u < 8; ++u)
#pragma unroll
        for (int d = 0; d < D; ++d) {
            xi[u][d] = x[(row0 + elem_row(u)) * D + d];
            xj[u][d] = x[(col0 + elem_col(u)) * D + d];
        }
    lowrank_chain<E>(g, xi, xj, st, red, partial + (int64_t)blockIdx.x * NS);
}

// The generic instances' input: g as gt[u][v] (row elem_row(u), column
// elem_col(v)) and pointers to the D inputs of those rows and columns.
__device__ __forceinline__ void lowrank_generic_input(const int* __restrict__ idx,
                                                      const float* __restrict__ x,
                                                      const float* __restrict__ A,
                                                      const float* __restrict__ Bm, int R, int RC,
                                                      int KH, int D, float* ops,
                                                      float (&gt)[kMicro][kMicro],
                                                      const float* (&xr)[kMicro],
                                                      const float* (&xc)[kMicro]) {
    float g[4][4][4];
    int64_t row0, col0;
    lowrank_g<false>(idx, A, Bm, nullptr, nullptr, R, RC, KH, ops, g, row0, col0);
#pragma unroll
    for (int u = 0; u < kMicro; ++u) {
        xr[u] = x + (row0 + elem_row(u)) * D;
        xc[u] = x + (col0 + elem_col(u)) * D;
#pragma unroll
        for (int v = 0; v < kMicro; ++v) gt[u][v] = g[u >> 1][v >> 1][2 * (u & 1) + (v & 1)];
    }
}

// The operands' shared memory for KH, and 4 T blocks of kernel on stream.
template <bool kCross = false, typename Kernel, typename... Args>
int launch_lowrank(Kernel kernel, int T, int KH, cudaStream_t stream, Args... args) {
    const size_t smem = sizeof(float) * 2 * (size_t)kSub * operand_stride(KH, kCross);
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<(unsigned)(4 * T), kThreads, smem, stream>>>(args...);
    return (int)cudaGetLastError();
}

// The MOSM tau chain as the unrolled kernels' element policy (K-lowrank-vjp,
// K-gram-lowrank-vjp): the pair's statistics read from their shared-memory
// stage, mosm_pair_vjp.cuh add_pair_cotangents4's four elements.
template <int Q, int D>
struct MosmChain {
    static constexpr int kD = D;
    static constexpr int kSlots = 3 * Q * D + 2 * Q;
    static constexpr int kMinBlocks = Q * D <= 2 ? 2 : 1;   // 128 registers a thread
    const float* st;

    __device__ __forceinline__ explicit MosmChain(const float* stage) : st(stage) {}
    __device__ __forceinline__ void add4(const float (&gv)[4], const float (&xi)[D],
                                         const float (&xj)[4][D], float (&acc)[kSlots]) const {
        add_pair_cotangents4<Q, D>(gv, xi, xj, st, acc);
    }
};

// The chunk plan's checks: 1 <= RC <= min(R, 64), KH a multiple of 8 that
// holds RC, at most 64.
inline bool lowrank_plan_ok(int R, int RC, int KH) {
    return R >= 1 && RC >= 1 && RC <= kMaxRC && RC <= R && KH >= RC && KH % 8 == 0 &&
           KH <= kMaxRC;
}

}  // namespace
