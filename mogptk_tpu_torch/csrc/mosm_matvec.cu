// K-gram-matvec and K-matvec: out = K(x1, x2) · V for the MOSM Gram of
// channel-pair statistics, without ever forming K. For Hopper (sm_90a),
// float32. K-gram-matvec (x1 != x2, any channel order) is described first;
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
//     x1 (N, D) and x2 (M, D) apart: K-gram-matvec. The JAX wrapper padded x
//     with channel 0 and V with zero rows to its tile, and carried each row
//     block's sum across the sequential column axis of its grid; here the
//     kernel masks the ragged row and column edges itself and reads nothing
//     past N or M, and the column axis is split across CTAs.
// Per element, the statistics those of the pair (c1[i], c2[j]):
//   K[i,j] = sum_q alpha_q * exp(-1/2 sum_d V_qd tau_d^2) * cos(2 pi (sum_d M_qd tau_d + dphi_q)),
//   tau_d = x1[i,d] - x2[j,d] + dtheta_qd.
//
// K-gram-matvec. Bound: operations. Each of the N x M elements costs Q exp
// and Q cos with ~20 FP32 operations each, and 2R more for the product,
// while the bytes are O((N + M) (D + R)). Design:
//   - the element is K-gram's (csrc/mosm_gram_element.cuh): expf, the
//     angle's turns in the plain twin's order, reduced exactly by whole
//     turns, and the hardware cos; where a 128 x 128 tile lies inside one
//     channel pair (decided by the block at run time, __syncthreads_and) the
//     pair's statistics sit in registers, else each element reads its
//     pair's row of the table in shared memory;
//   - a CTA of 8 warps takes a row tile of 128 rows, one chunk of 8 NB
//     columns of V (NB = 1, 5 or 16: R <= 8, R <= 40, else chunks of 128),
//     and a range of column tiles of 128 points (the split): for each column
//     tile it stages x2's points and the V tile, evaluates the Gram tile in
//     the A-fragment layout of mma.sync m16n8k8 (warp w: rows 16w..16w+15,
//     each thread four elements a k step, four independent exp and cos
//     chains) and multiplies it by V on the tensor cores as 3xTF32, straight
//     from the evaluating threads' registers (matvec_fold.cuh fold_step:
//     each k step's products start from zero and are added to the running
//     sums by FP32 adds; the split clamps NaN). Elements past N or M are
//     evaluated on clamped points, then set to 0 before the split;
//   - the split (ops/mosm_matvec.gram_matvec_plan, from the card's SM
//     count): enough column ranges that the grid fills the card about four
//     times over at every N. Each CTA writes its rows' sums over its range to
//     the slab of its split (splits x N x R floats, capped), and a second
//     pass, mosm_gram_matvec_reduce_f32, sums each output entry's slabs in
//     split order: no atomics, repeats bit-identical. With one split the
//     first pass writes the output itself;
//   - at large R the CTA's 128 columns of V (NB = 16, 64 accumulators a
//     thread, one CTA an SM) keep the element's re-evaluation, once per
//     chunk, to R/128 times the Gram (8 at R = 1,024), no more than the
//     products cost.
// Instances (ops/mosm_gram.kernel_instance("gram_matvec", ...) chooses):
// unrolled with Q <= 4 and D <= 2 compiled in and the pair table in shared
// memory (at most 48 KB); a generic one for any Q and D, the table read from
// global memory, the points read where they lie.
#include <cuda_runtime.h>
#include <stdint.h>

#include "matvec_fold.cuh"
#include "mosm_gram_element.cuh"

namespace {

constexpr int kMaxD = 8;             // input dims of the fold's unrolled instance
constexpr int kGmvMaxQ = 4, kGmvMaxD = 2;   // K-gram-matvec's unrolled instances

// K-gram-matvec's shared memory, in floats: pair table | xj (FT x D) | cj
// (FT) | Vj (FT x VS)
struct GmvLayout {
    int64_t xj, cj, vj, total;
};

__host__ __device__ inline GmvLayout gmv_layout(int vs, int64_t table, int D) {
    GmvLayout s;
    s.xj = fold_round4(table);
    s.cj = s.xj + fold_round4((int64_t)FT * D);
    s.vj = s.cj + FT;
    s.total = s.vj + (int64_t)FT * vs;
    return s;
}

// acc += G . V[tile] for one k step from the four elements e (ok: in range;
// elements past N or M, evaluated on clamped points, count exactly 0), in
// 3xTF32 (matvec_fold.cuh fold_step).
template <int NB>
__device__ __forceinline__ void gmv_products(float (&acc)[NB][4], float (&e)[4], const float* Vj,
                                             bool ok0, bool ok1, bool ok2, bool ok3, int ka,
                                             int g) {
    e[0] = ok0 ? e[0] : 0.0f;
    e[1] = ok1 ? e[1] : 0.0f;
    e[2] = ok2 ? e[2] : 0.0f;
    e[3] = ok3 ? e[3] : 0.0f;
    uint32_t ab[4], as[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) split_tf32(e[k], ab[k], as[k]);
    fold_step<NB, fold_vstride(NB)>(acc, ab, as, Vj, ka, g);
}

// One column tile's products: acc += G . V[tile] over its 16 k steps, G
// evaluated four elements a thread a k step in the A-fragment layout
// (e0 (ra, ka), e1 (rb, ka), e2 (ra, kb), e3 (rb, kb)). kUniform: the tile
// in one channel pair, whose statistics s are in registers; else each
// element's pair row from table (ca, cb the thread's row channels); xa, xb
// this thread's two rows of x1, xj the tile's points.
template <int Q, int D, int NB, bool kUniform>
__device__ __forceinline__ void gmv_tile(float (&acc)[NB][4], const CompStats<D> (&s)[Q],
                                         const float* table, int O, int S, int ca, int cb,
                                         const float (&xa)[D], const float (&xb)[D],
                                         const float* xj, const int* cj, const float* Vj,
                                         int64_t j0, int64_t M, bool va, bool vb, int g, int q) {
#pragma unroll 1
    for (int k8 = 0; k8 < FT / 8; ++k8) {
        const int ka = 8 * k8 + q, kb = ka + 4;
        const bool wa = j0 + ka < M, wb = j0 + kb < M;
        float qa[D], qb[D];
#pragma unroll
        for (int d = 0; d < D; ++d) {
            qa[d] = xj[ka * D + d];
            qb[d] = xj[kb * D + d];
        }
        float e[4];
        if constexpr (kUniform) {
            e[0] = gram_element(s, xa, qa);
            e[1] = gram_element(s, xb, qa);
            e[2] = gram_element(s, xa, qb);
            e[3] = gram_element(s, xb, qb);
        } else {
            CompStats<D> p0[Q], p1[Q], p2[Q], p3[Q];
            load_pair(p0, table + (ca * O + cj[ka]) * S);
            load_pair(p1, table + (cb * O + cj[ka]) * S);
            load_pair(p2, table + (ca * O + cj[kb]) * S);
            load_pair(p3, table + (cb * O + cj[kb]) * S);
            e[0] = gram_element(p0, xa, qa);
            e[1] = gram_element(p1, xb, qa);
            e[2] = gram_element(p2, xa, qb);
            e[3] = gram_element(p3, xb, qb);
        }
        gmv_products<NB>(acc, e, Vj, va && wa, vb && wa, va && wb, vb && wb, ka, g);
    }
}

// The generic instance's column tile: runtime Q and D, the table and the
// points read where they lie (xa, xb: this thread's two rows of x1).
template <int NB>
__device__ __forceinline__ void gmv_tile_generic(float (&acc)[NB][4], const float* table, int O,
                                                 int S, int ca, int cb, const float* xa,
                                                 const float* xb, const float* x2, const int* cj,
                                                 const float* Vj, int64_t j0, int64_t M, bool va,
                                                 bool vb, int Q, int D, int g, int q) {
#pragma unroll 1
    for (int k8 = 0; k8 < FT / 8; ++k8) {
        const int ka = 8 * k8 + q, kb = ka + 4;
        const bool wa = j0 + ka < M, wb = j0 + kb < M;
        const float* qa = x2 + min(j0 + ka, M - 1) * D;
        const float* qb = x2 + min(j0 + kb, M - 1) * D;
        float e[4];
        e[0] = gram_element_rt(table + (int64_t)(ca * O + cj[ka]) * S, xa, qa, Q, D);
        e[1] = gram_element_rt(table + (int64_t)(cb * O + cj[ka]) * S, xb, qa, Q, D);
        e[2] = gram_element_rt(table + (int64_t)(ca * O + cj[kb]) * S, xa, qb, Q, D);
        e[3] = gram_element_rt(table + (int64_t)(cb * O + cj[kb]) * S, xb, qb, Q, D);
        gmv_products<NB>(acc, e, Vj, va && wa, vb && wa, va && wb, vb && wb, ka, g);
    }
}

// K-gram-matvec's first pass: CTA (row tile it, split sp) = blockIdx.x =
// it + nrt sp, its chunk of 8 NB columns of V = blockIdx.y; the split's
// column tiles tps sp .. tps (sp + 1) - 1. Writes its 128 x 8 NB sums to
// part[sp] (N x R).
template <int Q, int D, int NB>
__global__ void __launch_bounds__(FTHREADS, NB <= 5 ? 2 : 1)
gram_matvec_kernel(const float* __restrict__ x1, const int* __restrict__ c1,
                   const float* __restrict__ x2, const int* __restrict__ c2,
                   const float* __restrict__ stats, const float* __restrict__ V,
                   float* __restrict__ part, int64_t N, int64_t M, int R, int O, int Qr, int Dr,
                   int tps) {
    constexpr bool kGeneric = Q == 0;
    constexpr int DD = D > 0 ? D : 1, QQ = Q > 0 ? Q : 1, VS = fold_vstride(NB);
    const int S = 3 * Qr * Dr + 2 * Qr;
    const int64_t table_n = kGeneric ? 0 : (int64_t)O * O * S;
    const GmvLayout L = gmv_layout(VS, table_n, D);
    extern __shared__ __align__(16) float smem[];
    const float* table = kGeneric ? stats : smem;
    float* xj = smem + L.xj;
    int* cj = reinterpret_cast<int*>(smem + L.cj);
    float* Vj = smem + L.vj;

    const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31, g = lane >> 2, q = lane & 3;
    const int64_t nrt = (N + FT - 1) / FT, nct = (M + FT - 1) / FT;
    const int64_t it = blockIdx.x % nrt, sp = blockIdx.x / nrt;
    const int64_t i0 = it * FT, jt0 = sp * tps, jt1 = min(jt0 + tps, nct);
    const int col0 = blockIdx.y * 8 * NB;
    if constexpr (!kGeneric)
        for (int64_t k = tid; k < table_n; k += FTHREADS) smem[k] = stats[k];
    const int ra = 16 * w + g, rb = ra + 8;   // this thread's tile rows
    const bool va = i0 + ra < N, vb = i0 + rb < N;
    const int64_t ia = min(i0 + ra, N - 1), ib = min(i0 + rb, N - 1);
    const int ca = c1[ia], cb = c1[ib];
    float xa[DD], xb[DD];
    if constexpr (!kGeneric) {
#pragma unroll
        for (int d = 0; d < D; ++d) {
            xa[d] = x1[ia * D + d];
            xb[d] = x1[ib * D + d];
        }
    }
    // the row tile inside one channel (rows past N clamped onto the last)
    const int crow = c1[i0];
    const bool row_one = c1[min(i0 + tid % FT, N - 1)] == crow;

    float acc[NB][4];
#pragma unroll
    for (int u = 0; u < NB; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[u][e] = 0.0f;
    for (int64_t jt = jt0; jt < jt1; ++jt) {
        const int64_t j0 = jt * FT;
        const int ccol = c2[j0];
        __syncthreads();   // the previous tile's points and V are read (and the table staged)
        bool col_one = true;
        if (tid < FT) {    // columns past M clamped onto the last
            const int64_t j = min(j0 + tid, M - 1);
            cj[tid] = c2[j];
            col_one = cj[tid] == ccol;
            if constexpr (!kGeneric)
#pragma unroll
                for (int d = 0; d < D; ++d) xj[tid * D + d] = x2[j * D + d];
        }
        fold_stage_v<NB, VS>(V, j0, M, R, col0, Vj);
        const bool uniform = __syncthreads_and(row_one && col_one);
        if constexpr (kGeneric) {
            gmv_tile_generic<NB>(acc, table, O, S, ca, cb, x1 + ia * Dr, x1 + ib * Dr, x2, cj, Vj,
                                 j0, M, va, vb, Qr, Dr, g, q);
        } else if (uniform) {   // the pair's statistics in registers
            CompStats<DD> s[QQ];
            load_pair(s, table + (int64_t)(crow * O + ccol) * S);
            gmv_tile<Q, D, NB, true>(acc, s, table, O, S, ca, cb, xa, xb, xj, cj, Vj, j0, M, va,
                                     vb, g, q);
        } else {
            CompStats<DD> s[QQ];   // unread
            gmv_tile<Q, D, NB, false>(acc, s, table, O, S, ca, cb, xa, xb, xj, cj, Vj, j0, M, va,
                                      vb, g, q);
        }
    }
    fold_write<NB>(part + (sp * N + i0) * R, acc, i0, N, R, col0, ra, rb, q);
}

template <int Q, int D, int NB>
int launch_gram_matvec(const float* x1, const int* c1, const float* x2, const int* c2,
                       const float* stats, const float* V, float* part, int64_t N, int64_t M,
                       int R, int O, int Qr, int Dr, int tps, cudaStream_t stream) {
    const int64_t S = 3 * Qr * Dr + 2 * Qr, table = Q > 0 ? (int64_t)O * O * S : 0;
    if (sizeof(float) * table > 48 * 1024) return (int)cudaErrorInvalidValue;
    const GmvLayout L = gmv_layout(fold_vstride(NB), table, D);
    const size_t smem = sizeof(float) * (size_t)L.total;
    cudaError_t err = cudaFuncSetAttribute(gram_matvec_kernel<Q, D, NB>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int64_t nrt = (N + FT - 1) / FT, nct = (M + FT - 1) / FT;
    const int64_t splits = (nct + tps - 1) / tps;
    const dim3 grid((unsigned)(nrt * splits), (unsigned)((R + 8 * NB - 1) / (8 * NB)));
    gram_matvec_kernel<Q, D, NB><<<grid, FTHREADS, smem, stream>>>(x1, c1, x2, c2, stats, V, part,
                                                                  N, M, R, O, Qr, Dr, tps);
    return (int)cudaGetLastError();
}

template <int NB>
int launch_gram_matvec_nb(const float* x1, const int* c1, const float* x2, const int* c2,
                          const float* stats, const float* V, float* part, int64_t N, int64_t M,
                          int R, int O, int Q, int D, int tps, int generic, cudaStream_t stream) {
    if (generic)
        return launch_gram_matvec<0, 0, NB>(x1, c1, x2, c2, stats, V, part, N, M, R, O, Q, D, tps,
                                            stream);
#define MOGPTK_GMV_CASE(q, d)                                                                \
    if (Q == q && D == d)                                                                    \
        return launch_gram_matvec<q, d, NB>(x1, c1, x2, c2, stats, V, part, N, M, R, O, Q, D, \
                                            tps, stream);
    MOGPTK_GMV_CASE(1, 1) MOGPTK_GMV_CASE(2, 1) MOGPTK_GMV_CASE(3, 1) MOGPTK_GMV_CASE(4, 1)
    MOGPTK_GMV_CASE(1, 2) MOGPTK_GMV_CASE(2, 2) MOGPTK_GMV_CASE(3, 2) MOGPTK_GMV_CASE(4, 2)
#undef MOGPTK_GMV_CASE
    return (int)cudaErrorInvalidValue;
}

// out[e] = sum over s of part[s][e] in order s = 0, 1, ...: the float4 of
// entries 4e.. where total is a multiple of 4, else entry by entry
__global__ void __launch_bounds__(256)
gram_matvec_reduce_kernel(const float* __restrict__ part, float* __restrict__ out, int64_t total,
                          int splits) {
    const int64_t stride = (int64_t)gridDim.x * blockDim.x;
    if (total % 4 == 0) {
        const float4* p4 = reinterpret_cast<const float4*>(part);
        float4* o4 = reinterpret_cast<float4*>(out);
        const int64_t n4 = total / 4;
        for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < n4; e += stride) {
            float4 s = p4[e];
            for (int k = 1; k < splits; ++k) {   // fixed order
                const float4 v = p4[k * n4 + e];
                s.x += v.x;
                s.y += v.y;
                s.z += v.z;
                s.w += v.w;
            }
            o4[e] = s;
        }
        return;
    }
    for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < total; e += stride) {
        float s = part[e];
        for (int k = 1; k < splits; ++k) s += part[k * total + e];
        out[e] = s;
    }
}

}  // namespace

// K-gram-matvec's first pass: part (splits, N, R) holds, for each split of
// the column tiles of 128 points (tps tiles a split, splits = ceil(ceil(M /
// 128) / tps)), K(x1, x2[split's columns]) @ V[split's rows]; with one
// split that is out (N, R) = K(x1, x2) @ V itself. x1 (N, D), channel IDs
// c1 (N,), x2 (M, D), c2 (M,), V (M, R), all row-major; stats is the
// (O*O, 3QD + 2Q) pair table. nb: n-blocks of 8 columns of V a CTA takes (1,
// 5 or 16; ops/mosm_matvec.gram_matvec_plan), R <= 2048. generic: 0 for the
// unrolled instance (Q <= 4, D <= 2, the table within 48 KB), 1 for the
// generic one (any Q and D).
extern "C" int mosm_gram_matvec_f32(const float* x1, const int* c1, const float* x2, const int* c2,
                                    const float* stats, const float* V, float* part, int64_t N,
                                    int64_t M, int R, int O, int Q, int D, int nb, int tps,
                                    int generic, cudaStream_t stream) {
    if (D < 1 || Q < 1 || O < 1 || R < 1 || R > 2048 || M < 1 || tps < 1 ||
        (!generic && (Q > kGmvMaxQ || D > kGmvMaxD)))
        return (int)cudaErrorInvalidValue;
    if (N == 0) return 0;
    switch (nb) {
        case 1: return launch_gram_matvec_nb<1>(x1, c1, x2, c2, stats, V, part, N, M, R, O, Q, D,
                                                tps, generic, stream);
        case 5: return launch_gram_matvec_nb<5>(x1, c1, x2, c2, stats, V, part, N, M, R, O, Q, D,
                                                tps, generic, stream);
        case 16: return launch_gram_matvec_nb<16>(x1, c1, x2, c2, stats, V, part, N, M, R, O, Q,
                                                  D, tps, generic, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}

// K-gram-matvec's second pass: out (N, R) = sum over the splits of part
// (splits, N, R), each entry's slabs added in split order.
extern "C" int mosm_gram_matvec_reduce_f32(const float* part, float* out, int64_t N, int R,
                                           int splits, cudaStream_t stream) {
    if (N < 1 || R < 1 || splits < 1) return (int)cudaErrorInvalidValue;
    const int64_t total = N * R, work = total % 4 == 0 ? total / 4 : total;
    int64_t blocks = (work + 255) / 256;
    if (blocks > 4 * 132 * 8) blocks = 4 * 132 * 8;
    gram_matvec_reduce_kernel<<<(unsigned)blocks, 256, 0, stream>>>(part, out, total, splits);
    return (int)cudaGetLastError();
}

// -- the fold (K-matvec) --------------------------------------------------------

namespace {

// The four elements a thread evaluates a k step, interleaved: the component
// loop outermost, so the four exp and cos chains are independent
// instructions for the scheduler to overlap. Per element, at full precision
// (the library expf and cosf: the cosine argument reaches ~250 rad on the
// bench data, where __cosf is wrong),
//   K = sum_q alpha_q exp(-1/2 sum_d V_qd tau_d^2) cos(2 pi (sum_d M_qd tau_d + dphi_q)),
// the input-dim loop run to kMaxD and broken at D in the unrolled instance,
// to the runtime D in the generic one, in the same order.
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

// K-matvec's element for the fold (matvec_fold.cuh): the MOSM Gram, the
// pair table in shared memory for the unrolled instance; A is Q.
template <bool kUnrolled>
struct MosmFold {
    static constexpr bool kTableInSmem = kUnrolled;
    static __device__ __forceinline__ void eval4(const float* const (&p)[4],
                                                 const float* const (&xi)[4],
                                                 const float* const (&xj)[4], int D, int A,
                                                 float (&k)[4]) {
        mosm_element4<kUnrolled>(p, xi, xj, A, D, k);
    }
};

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
// covering R. generic: 0 for the unrolled instance (D <= 8, the pair table
// in shared memory within 48 KB), 1 for the generic one.
extern "C" int mosm_matvec_fold_f32(const float* x, const int* c, const float* stats, const float* V,
                                    const int* items, int64_t n_items, float* part, int64_t N, int R,
                                    int nb, int O, int Q, int D, int generic, cudaStream_t stream) {
    if (D < 1 || (!generic && D > kMaxD)) return (int)cudaErrorInvalidValue;
    const int S = 3 * Q * D + 2 * Q;
    if (generic)
        return launch_fold_nb<MosmFold<false>>(nb, x, c, stats, V, items, n_items, part, N, R, O, S,
                                               D, Q, stream);
    return launch_fold_nb<MosmFold<true>>(nb, x, c, stats, V, items, n_items, part, N, R, O, S, D,
                                          Q, stream);
}

// The fold's second pass, K-matvec-reduce (K-matvec's and K-fam-matvec's):
// out (N, R) row by row, each the sum of its row tile's slab slots in slot
// order.
extern "C" int mosm_matvec_reduce_f32(const float* part, float* out, int64_t N, int R,
                                      cudaStream_t stream) {
    if (N < 1 || R < 1) return (int)cudaErrorInvalidValue;
    const int64_t total = N * R;
    int64_t blocks = (total + 255) / 256;
    if (blocks > 65535) blocks = 65535;
    matvec_reduce_kernel<<<(unsigned)blocks, 256, 0, stream>>>(part, out, N, R);
    return (int)cudaGetLastError();
}
