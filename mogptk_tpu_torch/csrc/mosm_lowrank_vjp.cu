// Channel-pair cotangents of the MOSM Gram for a low-rank dK = A B^T, for
// Hopper (sm_90a), float32, without forming dK.
//
// Replaces mogptk_tpu/ops/block_mosm.py mosm_lowrank_vjp_sorted (pallas_call
// at :652, body _lowrank_bwd_batched_kernel at :214, per-tile math
// _bwd_scalars at :119 with phase_inside), and the MOSM case of
// mogptk_tpu/ops/fused.py fused_gram_lowrank_vjp (:346) after the channel
// sort. The rows are channel-sorted and each channel is padded with zero
// rows of A and B to a multiple of T = 256, so padding adds nothing. A
// host-built list names every upper 256^2 tile (ti <= tj) of every upper
// channel pair (a <= b), grouped by pair. For one tile the cotangent is
//   g = A_i B_j^T + [ti != tj] B_i A_j^T      (the transposed lower tile folded in)
// and the tile reduces, for each component q and input dim d, to the 3QD + 2Q
// scalars [dV, dM, dtheta] x (q, d), then [dalpha, dphi] x q, of the pair's
// statistics (the hand-derived backward of the tau -> exp/cos chain of
// csrc/mosm_gram.cu).
//
// Bound: operations. Per element 2R multiply-adds for g (R = 17 on the
// training and iterative paths) and, per component, one exp, one sin/cos
// pair and ~20 FP32 operations; the inputs are a few MB, read from L2.
//
// Design. A block of 8 warps takes a 128 x 128 quarter of a tile (four
// blocks per tile). g is one 128 x 128 x 2R product, [A_i | B_i] .
// [B_j | A_j]^T (k = R alone, A_i . B_j^T, on a diagonal tile), on the
// tensor cores: 3xTF32 mma.sync m16n8k8 (mma_tf32.cuh, each k step's
// products summed fresh and added to the running sums by FP32 adds), with
// both operands in shared memory as [row][k] (row stride 2 KH + 4 = 4 or 20
// mod 32: the fragments' loads hit 32 banks); each half of k is padded with
// zeros to KH, a multiple of 8. Warp w owns the 64 x 32 sub-tile at rows
// 64 (w / 4), columns 32 (w % 4); its accumulator fragments are the
// thread's 8 x 8 elements of g (rows 16 mi + lane / 4 + 8h, columns 8 ni +
// 2 (lane % 4) + e), which go straight from registers into the tau chain: g
// never touches shared memory. The chain runs four elements at a time with
// the component loop outermost, so four independent exp and sin/cos chains
// overlap, on the special-function units: sin/cos(2 pi (a + dphi)) after an
// exact reduction by whole turns, where sincosf's slow path past |x| ~ 1e5
// keeps the chains apart (add_pair_cotangents4 and sincos_two_pi in
// mosm_pair_vjp.cuh, shared with K-gram-bwd, say why its error is far below
// the float32 twin's; the unrolled instance only, the generic one keeps
// mosm_pair_vjp.cuh's library functions). No 2^16
// prescale: a product below FLT_MIN that the tensor cores flush moves an
// element of g by < 2^-126 R, far below the float32 rounding of the
// cotangents it feeds (chip_smoke.py holds every case against float64).
//
// Blocks run in no order, so nothing carries from one to the next as it did
// across the TPU's sequential grid: each block writes its 3QD + 2Q partial
// sums (a fixed-order warp and block reduction, no atomics), and a second
// kernel sums each pair's partials in a fixed order in float64. The result
// is deterministic. The reductions, the four-element chain and the generic
// instance's tile are shared with csrc/mosm_gram_bwd.cu (mosm_pair_vjp.cuh).
//
// Any R: the operands hold RC <= 64 columns of A and B at a time
// (ops/block_mosm.lowrank_chunk chooses RC, lowrank_kpad its KH), and g
// accumulates over the chunks in order, so the tau chain runs once per
// element whatever R is, and the result stays deterministic. Two instances
// (ops/mosm_gram.kernel_instance chooses): unrolled over Q and D for
// Q <= 4, D <= 2, and a generic one for any Q and D (mosm_pair_vjp.cuh
// generic_tile).
#include "mma_tf32.cuh"
#include "mosm_pair_vjp.cuh"

namespace {

constexpr int kMaxRC = 64;      // columns of A and B in the operands at a time

__host__ __device__ constexpr int operand_stride(int kh) { return 2 * kh + 4; }

// The thread's 8 x 8 elements of g for this block's quarter, accumulated
// over R in chunks of RC columns (KH: RC padded to a multiple of 8) staged
// in shared memory (ops: two [kSub][2 KH + 4] arrays). g[mi][ni][c]: row
// 64 (w / 4) + 16 mi + lane / 4 + 8 (c / 2), column 32 (w % 4) + 8 ni +
// 2 (lane % 4) + c % 2.
__device__ __forceinline__ void lowrank_g(const int* __restrict__ idx,
                                          const float* __restrict__ A,
                                          const float* __restrict__ Bm, int R, int RC, int KH,
                                          float* ops, float (&g)[4][4][4], int64_t& row0,
                                          int64_t& col0) {
    const int SK = operand_stride(KH);
    float* Sa = ops;                 // [A_i | B_i]
    float* Sb = ops + kSub * SK;     // [B_j | A_j]
    const int s = blockIdx.x / 4, quarter = blockIdx.x % 4;
    const int ti = idx[3 * s], tj = idx[3 * s + 1];
    const int nk = (ti != tj ? 2 * KH : KH) / 8;
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
            const int64_t ri = (row0 + r) * R + r0 + k, rj = (col0 + r) * R + r0 + k;
            Sa[r * SK + k] = ok ? A[ri] : 0.0f;
            Sa[r * SK + KH + k] = ok ? Bm[ri] : 0.0f;
            Sb[r * SK + k] = ok ? Bm[rj] : 0.0f;
            Sb[r * SK + KH + k] = ok ? A[rj] : 0.0f;
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

template <int Q, int D>
__global__ void __launch_bounds__(kThreads, Q * D <= 2 ? 2 : 1)
lowrank_vjp_kernel(const int* __restrict__ idx, const float* __restrict__ x,
                   const float* __restrict__ A, const float* __restrict__ Bm,
                   const float* __restrict__ stats, float* __restrict__ partial, int R, int RC,
                   int KH) {
    constexpr int NOUT = 3 * Q * D + 2 * Q;
    extern __shared__ __align__(16) float ops[];
    __shared__ float st[NOUT];
    __shared__ float red[kThreads / 32][NOUT];
    const int t = threadIdx.x;
    const int pair = idx[3 * (blockIdx.x / 4) + 2];
    for (int e = t; e < NOUT; e += kThreads) st[e] = stats[(int64_t)pair * NOUT + e];
    float g[4][4][4];
    int64_t row0, col0;
    lowrank_g(idx, A, Bm, R, RC, KH, ops, g, row0, col0);   // syncs after st

    float xi[8][D], xj[8][D];
#pragma unroll
    for (int u = 0; u < 8; ++u)
#pragma unroll
        for (int d = 0; d < D; ++d) {
            xi[u][d] = x[(row0 + elem_row(u)) * D + d];
            xj[u][d] = x[(col0 + elem_col(u)) * D + d];
        }
    float acc[NOUT];
#pragma unroll
    for (int k = 0; k < NOUT; ++k) acc[k] = 0.0f;
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
            add_pair_cotangents4<Q, D>(gv, xi[u], xs, st, acc);
        }
    block_reduce_store<NOUT>(acc, red, partial + (int64_t)blockIdx.x * NOUT);
}

__global__ void __launch_bounds__(kThreads)
lowrank_vjp_generic_kernel(const int* __restrict__ idx, const float* __restrict__ x,
                           const float* __restrict__ A, const float* __restrict__ Bm,
                           const float* __restrict__ stats, float* __restrict__ partial, int R,
                           int RC, int KH, int Q, int D) {
    extern __shared__ __align__(16) float ops[];
    const int NOUT = 3 * Q * D + 2 * Q;
    float g[4][4][4];
    int64_t row0, col0;
    lowrank_g(idx, A, Bm, R, RC, KH, ops, g, row0, col0);
    const int pair = idx[3 * (blockIdx.x / 4) + 2];
    float gt[kMicro][kMicro];
    const float* xr[kMicro];
    const float* xc[kMicro];
#pragma unroll
    for (int u = 0; u < kMicro; ++u) {
        xr[u] = x + (row0 + elem_row(u)) * D;
        xc[u] = x + (col0 + elem_col(u)) * D;
#pragma unroll
        for (int v = 0; v < kMicro; ++v) gt[u][v] = g[u >> 1][v >> 1][2 * (u & 1) + (v & 1)];
    }
    generic_tile<false>(gt, xr, xc, stats + (int64_t)pair * NOUT, Q, D,
                        partial + (int64_t)blockIdx.x * NOUT, nullptr, nullptr, false, false);
}

template <typename Kernel, typename... Args>
int launch(Kernel kernel, int S, int KH, cudaStream_t stream, Args... args) {
    const size_t smem = sizeof(float) * 2 * (size_t)kSub * operand_stride(KH);
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<(unsigned)(4 * S), kThreads, smem, stream>>>(args...);
    return (int)cudaGetLastError();
}

}  // namespace

// idx (S, 3) int32 upper tiles [ti, tj, pair]; x (Np, D), A and B (Np, R),
// Np a multiple of 256; stats (O*O, 3QD+2Q); partial (4S, 3QD+2Q) scratch;
// pairs (P, 3) int32; out (O*O, 3QD+2Q), rows of absent pairs left as given.
// RC: the chunk width, 1 <= RC <= min(R, 64); KH: RC rounded up to a
// multiple of 8. generic: 0 for the unrolled instance (Q <= 4, D <= 2), 1
// for the generic one.
extern "C" int mosm_lowrank_vjp_f32(const int* idx, const float* x, const float* A,
                                    const float* Bm, const float* stats, float* partial,
                                    const int* pairs, float* out, int S, int P, int Q, int D,
                                    int R, int RC, int KH, int generic, cudaStream_t stream) {
    if (R < 1 || RC < 1 || RC > kMaxRC || RC > R || KH < RC || KH % 8 || KH > kMaxRC || Q < 1 ||
        D < 1)
        return (int)cudaErrorInvalidValue;
    if (S == 0) return 0;
    int err = (int)cudaErrorInvalidValue;
    if (generic)
        err = launch(lowrank_vjp_generic_kernel, S, KH, stream, idx, x, A, Bm, stats, partial, R,
                     RC, KH, Q, D);
#define MOGPTK_VJP_CASE(q, d)                                                                \
    else if (Q == q && D == d)                                                               \
        err = launch(lowrank_vjp_kernel<q, d>, S, KH, stream, idx, x, A, Bm, stats, partial, R, \
                     RC, KH);
    MOGPTK_VJP_CASE(1, 1) MOGPTK_VJP_CASE(2, 1) MOGPTK_VJP_CASE(3, 1) MOGPTK_VJP_CASE(4, 1)
    MOGPTK_VJP_CASE(1, 2) MOGPTK_VJP_CASE(2, 2) MOGPTK_VJP_CASE(3, 2) MOGPTK_VJP_CASE(4, 2)
#undef MOGPTK_VJP_CASE
    if (err != 0) return err;
    pair_reduce_kernel<<<(unsigned)P, 32, 0, stream>>>(partial, pairs, out, 3 * Q * D + 2 * Q);
    return (int)cudaGetLastError();
}
