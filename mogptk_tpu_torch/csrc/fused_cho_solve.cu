// Both substitution sweeps of a Cholesky solve for a narrow right-hand side,
// for Hopper (sm_90a), float32: X = (L L^T)^-1 B from the lower factor L and
// the inverses of its Bs x Bs diagonal blocks, reading only L's strictly
// lower blocks (its upper triangle and diagonal blocks may hold anything)
// and never forming L^T.
//
// Replaces mogptk_tpu/ops/pallas_solve.py fused_cho_solve (pallas_call at
// :186, body _solve_kernel at :46), which ran the 2*nb panel steps as one
// sequential TPU grid with the right-hand side resident in VMEM:
//   forward  z_p = inv_p   (b_p - sum_{i<p} L_pi z_i),
//   backward x_p = inv_p^T (z_p - sum_{k>p} L_kp^T x_k).
//
// Bound: bytes. Each sweep reads L's strict lower triangle (0.54 GB each at
// n = 16,384, far beyond the 50 MB L2, and the backward sweep cannot start
// before the forward one ends), while the right-hand side is only R <= 64
// columns wide. But the panel steps form a chain of 2 nb dependent steps, so
// a launch per step (the first design: 4 nb - 2 launches, 8.6 ms at
// n = 16,384) is bound by the chain, not by the bytes.
//
// Design: one persistent launch per call. Work items are (kind, panel p,
// 64-row tile t), T = ceil(Bs / 64) tiles a panel:
//   forward update  U(p,t): v_p[t] = b_p[t] - sum_{i<p} L[t rows, panel i] z_i
//   forward inverse I(p,t): z_p[t] = inv_p[t rows, :] v_p
//   backward update:        w_p[t] = z_p[t] - sum_{i>p} L[panel i, t cols]^T x_i
//   backward inverse:       x_p[t] = inv_p[:, t cols]^T w_p
// A CTA takes the next ticket k from a global atomic counter, finishes its
// item, and takes another. Ticket order (item_of): for p = 0 .. nb-1 the T
// forward updates of p, then its T forward inverses (k = 2 T p + ...); then
// for p = nb-1 .. 0 its T backward updates, then its T backward inverses.
// An item waits, in this order, on: U(p,.) on I(i,.) for i = 0 .. p-1;
// I(p,.) on U(p,.); a backward update on I(p,.), then on the backward
// inverses of i = nb-1 .. p+1; a backward inverse on the backward updates
// of p. Each of those holds lower tickets and was handed to a running CTA,
// so the launch cannot deadlock whatever its grid (tests/test_torch_package.py
// runs it on one CTA). Each item publishes its rows, then adds one to its
// (kind, panel) count with release semantics (__syncthreads, then one
// thread's __threadfence and atomicAdd); a waiter spins on the count with an
// acquire load and reads other CTAs' rows through L2 only (the .cg forms
// of cp.async and ld.global). The ticket counter and the counts live in a
// zeroed int32 tensor the wrapper allocates per call: no host round trip.
//
// An item is a 64 x R product over a k range walked in 64-deep slices. One
// CTA a SM, 8 warps, with 8 slices in shared memory (a whole 512-deep
// panel) for up to 40 right-hand sides, 6 for more: L's (or
// inv_p's) 64 x 64 slice is copied by cp.async S - 1 slices ahead of the
// one computed, whatever the counts (L and the inverses never depend on
// one), so a CTA streams L up to the chain's frontier and holds the next
// panel when its count arrives; the right-hand side's 64 rows (z_i, x_i,
// v_p or w_p, kept in rows of a padded stride ZS) follow by cp.async
// through L2 once the slice's panel has been seen complete, all of a
// panel's slices in flight at once. The products run on the tensor cores
// as 3xTF32 mma.sync m16n8k8 (mma_tf32.cuh): warp w takes all 64 rows by
// k rows 8w .. 8w + 7 of every slice, so each value is split into its TF32
// halves once, and each output is the fixed-order sum of eight partial
// sums: repeated calls are bit-identical. Forward items read L row-major
// (k contiguous, shared row stride 68: the A fragments' loads hit 32 banks);
// backward items read L's column strip of the panel, every row segment one
// 256-byte read (k-major, stride 72). The epilogue's b or z rows are read
// before the product. No prescale: a product below FLT_MIN that the tensor
// cores flush moves a sum of O(|b|) entries by < 2^-126.
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tf32.cuh"

namespace {

constexpr int kThreads = 256;     // 8 warps, each 8 of a slice's 64 k rows
constexpr int kTM = 64;           // rows of an item
constexpr int kKS = 64;           // k of a slice
constexpr int kMaxR = 64;
constexpr int kStrideRow = kKS + 4;   // A row-major, As[r][k]: 68 = 4 (mod 32)
constexpr int kStrideCol = kTM + 8;   // A k-major, As[k][r]: 72 = 8 (mod 32)
constexpr int kStageA = kKS * kStrideCol;
constexpr int kMaxSmemFloats = 232448 / 4 - 64;
enum Kind { kFwdUpdate = 0, kFwdInverse = 1, kBwdUpdate = 2, kBwdInverse = 3 };

// row stride of the right-hand sides v, z, x in device memory and of their
// staged slices: 8 or 24 (mod 32) floats, so the B fragments' loads (rows q,
// q + 4 by columns g) hit 32 distinct banks, and a multiple of 4, so a row
// is whole 16-byte copies
__host__ __device__ constexpr int rhs_stride(int nb) {
    return (8 * nb) % 32 == 8 || (8 * nb) % 32 == 24 ? 8 * nb : 8 * nb + 8;
}

// a stage: A's 64 x 64 slice, then the right-hand side's 64 rows
__host__ __device__ constexpr int stage_floats(int nb) { return kStageA + kKS * rhs_stride(nb); }

// slices in flight: a whole 512-deep panel (8) where shared memory holds it
__host__ __device__ constexpr int stages(int nb) {
    return kMaxSmemFloats / stage_floats(nb) < 8 ? kMaxSmemFloats / stage_floats(nb) : 8;
}

__host__ __device__ inline int64_t lmin(int64_t a, int64_t b) { return a < b ? a : b; }

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
    const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(d), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
    const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(d), "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ int ld_acquire(const int* p) {
    int v;
    asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
    return v;
}

// every thread calls it: returns once *count >= target, with the writes that
// preceded the count's increments visible to the CTA's L2 reads
__device__ __forceinline__ void wait_count(const int* count, int target) {
    if (threadIdx.x == 0) {
        while (ld_acquire(count) < target) __nanosleep(20);
        __threadfence();
    }
    __syncthreads();
}

// every thread calls it after writing its rows
__device__ __forceinline__ void signal_count(int* count) {
    __syncthreads();
    if (threadIdx.x == 0) {
        __threadfence();
        atomicAdd(count, 1);
    }
}

struct Problem {
    const float* L;
    const float* invs;
    const float* B;   // (n, R)
    float* V;         // (n, ZS): v, then w
    float* Z;         // (n, ZS)
    float* X;         // (n, ZS)
    float* Xout;      // (n, R)
    int* counts;      // [ticket | (kind, panel) counts: 4 x nb]
    int64_t n, Bs;
    int nb, tiles, R;
    bool vec;         // 16-byte copies of A: Bs % 4 == 0 and L, invs on 16 bytes
};

// One item: acc = the sum over its nseg segments (panels), and over their
// 64-deep slices in order, of A(64 rows, slice) . rhs(slice, R). Segment s
// is panel(s) = first + dir s: A(r, k) = a0[r lda + k] (row-major) or
// a0[k lda + r] (kKMajor) with a0 = a_base + a_step panel(s), k < Bs; the
// right-hand side's rows start at rhs_base + rhs_step panel(s) (stride ZS);
// they are read once count_base[panel(s)] reaches the tile count. rows: the
// tile's valid rows.
template <bool kKMajor>
struct Item {
    const float* a_base;
    int64_t a_step, lda;
    const float* rhs_base;
    int64_t rhs_step;
    const int* count_base;
    int first, dir, nseg, rows;
};

template <bool kKMajor>
__device__ __forceinline__ void load_a(const Item<kKMajor>& it, const Problem& P, int s,
                                       float* as) {
    const int spp = (int)((P.Bs + kKS - 1) / kKS);
    const int seg = s / spp, j = s % spp;
    const float* a0 = it.a_base + it.a_step * (it.first + it.dir * seg);
    const int64_t k0 = (int64_t)j * kKS;
    const int kvalid = (int)lmin(kKS, P.Bs - k0);
    const int tid = threadIdx.x;
    if (P.vec) {
#pragma unroll
        for (int m = 0; m < kKS * kTM / 4 / kThreads; ++m) {
            const int c = tid + kThreads * m;
            const int outer = c / 16, inner = 4 * (c % 16);
            if constexpr (kKMajor) {   // outer: k, inner: rows
                const bool ok = outer < kvalid && inner < it.rows;
                cp_async16(as + outer * kStrideCol + inner,
                           ok ? a0 + (k0 + outer) * it.lda + inner : a0, ok);
            } else {                   // outer: rows, inner: k
                const bool ok = outer < it.rows && inner < kvalid;
                cp_async16(as + outer * kStrideRow + inner,
                           ok ? a0 + outer * it.lda + k0 + inner : a0, ok);
            }
        }
    } else {
        for (int c = tid; c < kKS * kTM; c += kThreads) {
            const int outer = c / kKS, inner = c % kKS;
            if constexpr (kKMajor) {
                const bool ok = outer < kvalid && inner < it.rows;
                cp_async4(as + outer * kStrideCol + inner,
                          ok ? a0 + (k0 + outer) * it.lda + inner : a0, ok);
            } else {
                const bool ok = outer < it.rows && inner < kvalid;
                cp_async4(as + outer * kStrideRow + inner,
                          ok ? a0 + outer * it.lda + k0 + inner : a0, ok);
            }
        }
    }
}

// the slice's 64 rows of the right-hand side (stride ZS, rows past the
// segment zero) into zs, through L2 only: other CTAs wrote them
template <bool kKMajor, int NB>
__device__ __forceinline__ void load_rhs(const Item<kKMajor>& it, const Problem& P, int s,
                                         float* zs) {
    constexpr int ZS = rhs_stride(NB);
    const int spp = (int)((P.Bs + kKS - 1) / kKS);
    const int seg = s / spp, j = s % spp;
    const int64_t k0 = (int64_t)j * kKS;
    const float* src = it.rhs_base + it.rhs_step * (it.first + it.dir * seg) + k0 * ZS;
    const int kvalid = (int)lmin(kKS, P.Bs - k0);
    for (int c = threadIdx.x; c < kKS * ZS / 4; c += kThreads) {
        const bool ok = 4 * c < kvalid * ZS;
        cp_async16(zs + 4 * c, ok ? src + 4 * c : src, ok);
    }
}

// acc += this warp's share of the slice: all 64 rows (four m16 blocks) by
// the slice's k rows 8w .. 8w + 7, so each value of A and of the right-hand
// side is split into its TF32 halves once
template <bool kKMajor, int NB>
__device__ __forceinline__ void slice_product(const float* __restrict__ as,
                                              const float* __restrict__ zs,
                                              float (&acc)[4][NB][4], int w, int g, int q) {
    constexpr int ZS = rhs_stride(NB);
    const int ka = 8 * w + q, kb = ka + 4;
    uint32_t bb0[NB], bs0[NB], bb1[NB], bs1[NB];
#pragma unroll
    for (int u = 0; u < NB; ++u) {
        split_tf32(zs[ka * ZS + 8 * u + g], bb0[u], bs0[u]);
        split_tf32(zs[kb * ZS + 8 * u + g], bb1[u], bs1[u]);
    }
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
        const int ra = 16 * mi + g, rb = ra + 8;
        float a[4];
        if constexpr (kKMajor) {
            a[0] = as[ka * kStrideCol + ra];
            a[1] = as[ka * kStrideCol + rb];
            a[2] = as[kb * kStrideCol + ra];
            a[3] = as[kb * kStrideCol + rb];
        } else {
            a[0] = as[ra * kStrideRow + ka];
            a[1] = as[rb * kStrideRow + ka];
            a[2] = as[ra * kStrideRow + kb];
            a[3] = as[rb * kStrideRow + kb];
        }
        uint32_t ab[4], asm_[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32(a[e], ab[e], asm_[e]);
#pragma unroll
        for (int u = 0; u < NB; ++u) mma3_add(acc[mi][u], ab, asm_, bb0[u], bs0[u], bb1[u], bs1[u]);
    }
}

// Runs one item: the product over its slices, then out[rows] = src[rows] -
// acc (src != null; leading dimension src_ld) or acc, into out (stride ZS)
// and out2 (stride R) where given, then its count.
//
// The pipeline: slice s sits in stage s % S, its A part issued S - 1 slices
// ahead whatever the counts, its right-hand side with it once the slice's
// segment has been seen complete. The first slice of a segment not yet
// seen waits for the segment's count, then issues the right-hand sides of
// the segment's slices already in flight as one group and waits for
// everything in flight (cp.async.wait_group 0); any other slice waits for
// its own group (S - 2 newer ones may stay in flight).
template <bool kKMajor, int NB>
__device__ void run_item(const Item<kKMajor>& it, const Problem& P, float* smem, const float* src,
                         int64_t src_ld, float* out, float* out2, int* done) {
    constexpr int S = stages(NB), ST = stage_floats(NB);
    const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31, g = lane >> 2, q = lane & 3;
    const int spp = (int)((P.Bs + kKS - 1) / kKS);
    const int nsl = it.nseg * spp;
    float acc[4][NB][4];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int u = 0; u < NB; ++u)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mi][u][e] = 0.0f;
    // the epilogue's outputs of this thread: element e = tid + kThreads m of
    // the tile's kTM x R block, and src there, read before the product
    float sv[2 * NB];
#pragma unroll
    for (int m = 0; m < 2 * NB; ++m) {
        const int e = tid + kThreads * m, r = e / P.R;
        sv[m] = src && e < kTM * P.R && r < it.rows ? __ldcg(src + r * src_ld + e % P.R) : 0.0f;
    }
#pragma unroll
    for (int s = 0; s < S - 1; ++s) {
        if (s < nsl) load_a(it, P, s, smem + s * ST);
        cp_async_commit();
    }
    int seen = 0;   // segments whose counts this CTA has seen complete
    for (int s = 0; s < nsl; ++s) {
        const int seg = s / spp;
        if (seg == seen) {
            wait_count(it.count_base + it.first + it.dir * seg, P.tiles);
            seen = seg + 1;
            for (int j = s; j < s + S - 1 && j < nsl && j / spp == seg; ++j)
                load_rhs<kKMajor, NB>(it, P, j, smem + (j % S) * ST + kStageA);
            cp_async_commit();
            cp_async_wait<0>();
        } else {
            cp_async_wait<S - 2>();
        }
        __syncthreads();                     // slice s visible; slice s - 1 computed
        const int j = s + S - 1;
        if (j < nsl) {
            load_a(it, P, j, smem + (j % S) * ST);
            if (j / spp < seen) load_rhs<kKMajor, NB>(it, P, j, smem + (j % S) * ST + kStageA);
        }
        cp_async_commit();
        slice_product<kKMajor, NB>(smem + (s % S) * ST, smem + (s % S) * ST + kStageA, acc, w,
                                   g, q);
    }
    cp_async_wait<0>();
    __syncthreads();                         // every slice computed: the stages are free
    // each warp's partial sums over its k rows, then each output summed over
    // the eight warps in order
    constexpr int CS = 8 * NB + 4;
    float* red = smem + w * kTM * CS;
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int u = 0; u < NB; ++u) {
            const int ra = 16 * mi + g, c = 8 * u + 2 * q;
            red[ra * CS + c] = acc[mi][u][0];
            red[ra * CS + c + 1] = acc[mi][u][1];
            red[(ra + 8) * CS + c] = acc[mi][u][2];
            red[(ra + 8) * CS + c + 1] = acc[mi][u][3];
        }
    __syncthreads();
    constexpr int ZS = rhs_stride(NB);
#pragma unroll
    for (int m = 0; m < 2 * NB; ++m) {
        const int e = tid + kThreads * m, r = e / P.R, c = e % P.R;
        if (e < kTM * P.R && r < it.rows) {
            float v = 0.0f;
#pragma unroll
            for (int h = 0; h < kThreads / 32; ++h) v += smem[(h * kTM + r) * CS + c];
            if (src) v = sv[m] - v;
            out[(int64_t)r * ZS + c] = v;
            if (out2) out2[(int64_t)r * P.R + c] = v;
        }
    }
    signal_count(done);
}

// the (kind, panel, tile) of ticket k, in the order above
__device__ __forceinline__ void item_of(int k, int nb, int tiles, int& kind, int& p, int& t) {
    const int half = 2 * nb * tiles;         // tickets of a sweep
    const bool fwd = k < half;
    const int f = fwd ? k : k - half;
    kind = (fwd ? kFwdUpdate : kBwdUpdate) + (f % (2 * tiles)) / tiles;
    p = fwd ? f / (2 * tiles) : nb - 1 - f / (2 * tiles);
    t = f % tiles;
}

template <int NB>
__global__ void __launch_bounds__(kThreads, 1) cho_solve_kernel(Problem P) {
    extern __shared__ __align__(16) float smem[];
    __shared__ int ticket;
    constexpr int64_t ZS = rhs_stride(NB);
    const int tid = threadIdx.x;
    const int n_items = 4 * P.nb * P.tiles;
    int* cnt = P.counts + 1;                 // cnt[kind * nb + panel]
    for (;;) {
        if (tid == 0) ticket = atomicAdd(P.counts, 1);
        __syncthreads();
        const int k = ticket;
        if (k >= n_items) return;
        int kind, p, t;
        item_of(k, P.nb, P.tiles, kind, p, t);
        const int64_t r0 = (int64_t)p * P.Bs + (int64_t)t * kTM;   // first row of the tile
        const int rows = (int)lmin(kTM, P.Bs - (int64_t)t * kTM);
        const int64_t bs2 = P.Bs * P.Bs;
        if (kind == kFwdUpdate) {
            Item<false> it{P.L + r0 * P.n, P.Bs, P.n, P.Z, P.Bs * ZS, cnt + kFwdInverse * P.nb,
                           0, 1, p, rows};
            run_item<false, NB>(it, P, smem, P.B + r0 * P.R, P.R, P.V + r0 * ZS, nullptr,
                                cnt + kFwdUpdate * P.nb + p);
        } else if (kind == kFwdInverse) {
            Item<false> it{P.invs + p * bs2 + (int64_t)t * kTM * P.Bs, 0, P.Bs,
                           P.V + (int64_t)p * P.Bs * ZS, 0, cnt + kFwdUpdate * P.nb, p, 0, 1,
                           rows};
            run_item<false, NB>(it, P, smem, nullptr, 0, P.Z + r0 * ZS, nullptr,
                                cnt + kFwdInverse * P.nb + p);
        } else if (kind == kBwdUpdate) {
            wait_count(cnt + kFwdInverse * P.nb + p, P.tiles);     // z_p, and v_p consumed
            Item<true> it{P.L + r0, P.Bs * P.n, P.n, P.X, P.Bs * ZS, cnt + kBwdInverse * P.nb,
                          P.nb - 1, -1, P.nb - 1 - p, rows};
            run_item<true, NB>(it, P, smem, P.Z + r0 * ZS, ZS, P.V + r0 * ZS, nullptr,
                               cnt + kBwdUpdate * P.nb + p);
        } else {
            Item<true> it{P.invs + p * bs2 + (int64_t)t * kTM, 0, P.Bs,
                          P.V + (int64_t)p * P.Bs * ZS, 0, cnt + kBwdUpdate * P.nb, p, 0, 1, rows};
            run_item<true, NB>(it, P, smem, nullptr, 0, P.X + r0 * ZS, P.Xout + r0 * P.R,
                               cnt + kBwdInverse * P.nb + p);
        }
    }
}

template <int NB>
int launch(const Problem& P, int max_ctas, cudaStream_t stream) {
    const size_t smem = sizeof(float) * (size_t)stages(NB) * stage_floats(NB);
    cudaError_t err = cudaFuncSetAttribute(cho_solve_kernel<NB>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    int dev = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
        return (int)err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, cho_solve_kernel<NB>,
                                                             kThreads, smem)) != cudaSuccess)
        return (int)err;
    int grid = per_sm * sms;
    if (max_ctas > 0 && max_ctas < grid) grid = max_ctas;
    if (grid > 4 * P.nb * P.tiles) grid = 4 * P.nb * P.tiles;
    if (grid < 1) return (int)cudaErrorInvalidConfiguration;
    cho_solve_kernel<NB><<<(unsigned)grid, kThreads, smem, stream>>>(P);
    return (int)cudaGetLastError();
}

}  // namespace

// The right-hand sides' row stride in the scratch V, Z and X for R columns.
extern "C" int fused_cho_solve_rhs_stride(int R) { return rhs_stride((R + 7) / 8); }

// L (n, n) row-major lower factor (only its strictly lower Bs-blocks read);
// invs (n/Bs, Bs, Bs) inverses of its diagonal blocks; B (n, R) the
// right-hand side; V, Z, X (n, ZS) scratch, ZS = fused_cho_solve_rhs_stride(R),
// on 16 bytes; Xout (n, R) the solution; counts (1 + 4 nb) int32, zero.
// 1 <= R <= 64, Bs divides n. max_ctas > 0 caps the grid (else every CTA
// that fits on the card).
extern "C" int fused_cho_solve_f32(const float* L, const float* invs, const float* B, float* V,
                                   float* Z, float* X, float* Xout, int* counts, int64_t n,
                                   int64_t Bs, int R, int max_ctas, cudaStream_t stream) {
    if (R < 1 || R > kMaxR || Bs <= 0 || n % Bs) return (int)cudaErrorInvalidValue;
    const int tiles = (int)((Bs + kTM - 1) / kTM);
    if ((uintptr_t)V % 16 || (uintptr_t)Z % 16 || (uintptr_t)X % 16)
        return (int)cudaErrorMisalignedAddress;
    Problem P{L, invs, B, V, Z, X, Xout, counts, n, Bs, (int)(n / Bs), tiles, R,
              Bs % 4 == 0 && (uintptr_t)L % 16 == 0 && (uintptr_t)invs % 16 == 0};
    switch ((R + 7) / 8) {
        case 1: return launch<1>(P, max_ctas, stream);
        case 2: return launch<2>(P, max_ctas, stream);
        case 3: return launch<3>(P, max_ctas, stream);
        case 4: return launch<4>(P, max_ctas, stream);
        case 5: return launch<5>(P, max_ctas, stream);
        case 6: return launch<6>(P, max_ctas, stream);
        case 7: return launch<7>(P, max_ctas, stream);
        case 8: return launch<8>(P, max_ctas, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}
