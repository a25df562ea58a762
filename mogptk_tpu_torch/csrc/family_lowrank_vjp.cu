// K-fam-lowrank-vjp: the cotangent of a non-MOSM family's pair pack for a
// low-rank dK = A B^T, without forming dK. For Hopper (sm_90a), float32.
//
// Replaces mogptk_tpu/ops/block_families.py family_lowrank_vjp_sorted
// (pallas_call at :590, body _lowrank_bwd_batched_kernel at :319, which
// summed each pair's in-kernel jax.vjp over the TPU's sequential grid), and
// for the families mogptk_tpu/ops/fused.py fused_gram_lowrank_vjp
// (pallas_call at :346; the engine sorts the rows by channel first). The
// rows are channel-sorted and each channel is padded with zero rows of A
// and B to a multiple of 256, so padding adds nothing. A host-built list
// (ops/block_mosm._pair_layout) names every upper 256^2 tile (ti <= tj) of
// every upper channel pair (a <= b), grouped by pair. For one tile
//   g = A_i B_j^T + [ti != tj] B_i A_j^T      (the transposed lower tile folded in)
// and the tile reduces to the S scalars of the pair's pack through the
// family's hand-derived element derivatives (csrc/family_element.cuh,
// csrc/family_pair_vjp.cuh).
//
// Bound: operations. Per element 2R FMAs for g (R = 17 on the probe-trace
// path, 33 on the iterative one), one exp and one sincos (per component
// for CSM; Q D of each for SM-LMC) and ~4 FMAs per scalar of the pack; the
// inputs are a few MB, read from L2. Design, as K-lowrank-vjp's
// (csrc/mosm_lowrank_vjp.cu, whose g staging this copies): a block takes a
// 128 x 128 quarter of a tile with 256 threads of 8 x 8 elements each; the
// four (128, RC) slabs of A and B sit in shared memory, R-major, at most
// RC <= 64 columns at a time (ops/block_mosm.lowrank_chunk), and g
// accumulates over the chunks in order, so any R takes one pass of the
// element chain. Each block writes its S partial sums (a fixed-order
// reduction, no atomics), and a second kernel sums each pair's partials in
// a fixed order in float64: a repeated call is bit-identical.
#include "family_pair_vjp.cuh"

namespace {

constexpr int kMaxRC = 64;      // columns of A and B in the slabs at a time

// g[u][v] = (A_i B_j^T + [ti != tj] B_i A_j^T) for the thread's 8 x 8
// elements of this block's quarter, accumulated over R in chunks of RC
// columns staged in shared memory (slab: four [RC][kSub] arrays). The same
// staging as csrc/mosm_lowrank_vjp.cu's lowrank_g.
__device__ __forceinline__ void family_lowrank_g(const int* __restrict__ idx,
                                                 const float* __restrict__ A,
                                                 const float* __restrict__ Bm, int R, int RC,
                                                 float* slab, float (&g)[kMicro][kMicro],
                                                 int64_t& row0, int64_t& col0, int& pair) {
    float* Ai = slab;
    float* Bi = slab + RC * kSub;
    float* Aj = slab + 2 * RC * kSub;
    float* Bj = slab + 3 * RC * kSub;
    const int s = blockIdx.x / 4, quarter = blockIdx.x % 4;
    const int ti = idx[3 * s], tj = idx[3 * s + 1];
    pair = idx[3 * s + 2];
    const bool sym = ti != tj;
    row0 = (int64_t)ti * kTile + (quarter / 2) * kSub;
    col0 = (int64_t)tj * kTile + (quarter % 2) * kSub;
    const int t = threadIdx.x, tx = t % 16, ty = t / 16;
#pragma unroll
    for (int u = 0; u < kMicro; ++u)
#pragma unroll
        for (int v = 0; v < kMicro; ++v) g[u][v] = 0.0f;
    for (int r0 = 0; r0 < R; r0 += RC) {
        const int rc = min(RC, R - r0);
        __syncthreads();   // the previous chunk's slabs are read
        for (int e = t; e < kSub * rc; e += kThreads) {
            const int r = e % rc, k = e / rc;
            Ai[r * kSub + k] = A[(row0 + k) * R + r0 + r];
            Bi[r * kSub + k] = Bm[(row0 + k) * R + r0 + r];
            Aj[r * kSub + k] = A[(col0 + k) * R + r0 + r];
            Bj[r * kSub + k] = Bm[(col0 + k) * R + r0 + r];
        }
        __syncthreads();
        for (int r = 0; r < rc; ++r) {
            float ai[kMicro], bi[kMicro], aj[kMicro], bj[kMicro];
#pragma unroll
            for (int u = 0; u < kMicro; ++u) {
                ai[u] = Ai[r * kSub + ty + 16 * u];
                bi[u] = Bi[r * kSub + ty + 16 * u];
                aj[u] = Aj[r * kSub + tx + 16 * u];
                bj[u] = Bj[r * kSub + tx + 16 * u];
            }
#pragma unroll
            for (int u = 0; u < kMicro; ++u)
#pragma unroll
                for (int v = 0; v < kMicro; ++v) g[u][v] = fmaf(ai[u], bj[v], g[u][v]);
            if (sym) {
#pragma unroll
                for (int u = 0; u < kMicro; ++u)
#pragma unroll
                    for (int v = 0; v < kMicro; ++v) g[u][v] = fmaf(bi[u], aj[v], g[u][v]);
            }
        }
    }
}

template <int F, int kD, int kA>
__global__ void __launch_bounds__(kThreads)
family_lowrank_vjp_kernel(const int* __restrict__ idx, const float* __restrict__ x,
                          const float* __restrict__ A, const float* __restrict__ Bm,
                          const float* __restrict__ stats, float* __restrict__ partial, int R,
                          int RC, int S) {
    extern __shared__ float slab[];
    const int t = threadIdx.x, tx = t % 16, ty = t / 16;
    float g[kMicro][kMicro];
    int64_t row0, col0;
    int pair;
    family_lowrank_g(idx, A, Bm, R, RC, slab, g, row0, col0, pair);
    float xi[kMicro][kD], xj[kMicro][kD];
#pragma unroll
    for (int u = 0; u < kMicro; ++u)
#pragma unroll
        for (int d = 0; d < kD; ++d) {
            xi[u][d] = x[(row0 + ty + 16 * u) * kD + d];
            xj[u][d] = x[(col0 + tx + 16 * u) * kD + d];
        }
    family_tile_unrolled<F, kD, kA>(g, xi, xj, stats + (int64_t)pair * S,
                                    partial + (int64_t)blockIdx.x * S);
}

template <int F>
__global__ void __launch_bounds__(kThreads)
family_lowrank_vjp_generic_kernel(const int* __restrict__ idx, const float* __restrict__ x,
                                  const float* __restrict__ A, const float* __restrict__ Bm,
                                  const float* __restrict__ stats, float* __restrict__ partial,
                                  int R, int RC, int S, int D, int ncomp) {
    extern __shared__ float slab[];
    const int t = threadIdx.x, tx = t % 16, ty = t / 16;
    float g[kMicro][kMicro];
    int64_t row0, col0;
    int pair;
    family_lowrank_g(idx, A, Bm, R, RC, slab, g, row0, col0, pair);
    const float* xr[kMicro];
    const float* xc[kMicro];
#pragma unroll
    for (int u = 0; u < kMicro; ++u) {
        xr[u] = x + (row0 + ty + 16 * u) * D;
        xc[u] = x + (col0 + tx + 16 * u) * D;
    }
    family_tile_generic<F>(g, xr, xc, stats + (int64_t)pair * S, S, D, ncomp,
                           partial + (int64_t)blockIdx.x * S);
}

template <typename Kernel, typename... Args>
int launch(Kernel kernel, int T, int RC, cudaStream_t stream, Args... args) {
    const size_t smem = sizeof(float) * 4 * (size_t)RC * kSub;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<(unsigned)(4 * T), kThreads, smem, stream>>>(args...);
    return (int)cudaGetLastError();
}

}  // namespace

// idx (T, 3) int32 upper tiles [ti, tj, pair]; x (Np, D), A and B (Np, R),
// Np a multiple of 256; stats (O*O, S) the pair table; partial (4T, S)
// scratch; pairs (P, 3) int32; out (O*O, S), rows of absent and lower
// pairs left as given. RC: the chunk width, 1 <= RC <= min(R, 64). fam:
// the FamilyId; ncomp: CSM's Rq, SM-LMC's Q, else 0.
extern "C" int family_lowrank_vjp_f32(const int* idx, const float* x, const float* A,
                                      const float* Bm, const float* stats, float* partial,
                                      const int* pairs, float* out, int T, int P, int R, int RC,
                                      int S, int D, int ncomp, int fam, cudaStream_t stream) {
    if (R < 1 || RC < 1 || RC > kMaxRC || RC > R || D < 1 || fam < 0 || fam > kLmcSm ||
        ((fam == kCsm || fam == kLmcSm) && ncomp < 1) || S != family_slots(fam, D, ncomp))
        return (int)cudaErrorInvalidValue;
    if (T == 0) return 0;
    int err = -1;
#define MOGPTK_CASE(f, d, a)                                                                 \
    if (err < 0 && fam == f && D == d && ncomp == a)                                         \
        err = launch(family_lowrank_vjp_kernel<f, d, a>, T, RC, stream, idx, x, A, Bm, stats, \
                     partial, R, RC, S);
    MOGPTK_FAMILY_UNROLLED(MOGPTK_CASE)
#undef MOGPTK_CASE
#define MOGPTK_GENERIC(f)                                                                    \
    if (err < 0 && fam == f)                                                                 \
        err = launch(family_lowrank_vjp_generic_kernel<f>, T, RC, stream, idx, x, A, Bm,     \
                     stats, partial, R, RC, S, D, ncomp);
    MOGPTK_GENERIC(kUmosm) MOGPTK_GENERIC(kCsm) MOGPTK_GENERIC(kConv) MOGPTK_GENERIC(kMohsm)
    MOGPTK_GENERIC(kLmcSm)
#undef MOGPTK_GENERIC
    if (err != 0) return err;
    pair_reduce_kernel<<<(unsigned)P, 32, 0, stream>>>(partial, pairs, out, S);
    return (int)cudaGetLastError();
}
