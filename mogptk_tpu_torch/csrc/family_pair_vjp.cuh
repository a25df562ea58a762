// The element chain shared by the two kernels that turn a Gram cotangent
// into cotangents of a family's pack (csrc/family_gram_bwd.cu, where the
// cotangent is read from memory, and csrc/family_lowrank_vjp.cu, where it is
// A B^T): the family's hand-derived element derivatives
// (csrc/family_element.cuh grad) over a thread's 64 elements of a 128 x 128
// quarter tile (the geometry of csrc/mosm_pair_vjp.cuh, whose constants,
// fixed-order block reduction and float64 per-pair reductions are reused),
// the block's S sums written in a fixed order to its row of the partial
// table. No atomics: deterministic.
//
// Two instances, as mosm_pair_vjp.cuh's:
//   unrolled, for the (family, D, A) of MOGPTK_FAMILY_UNROLLED: the pair's S
//     scalars and the S accumulators in registers, four elements at a time
//     (FamilyChain) on the hardware's exp and turn-reduced sin/cos
//     (HardwareMath; uMOSM's and MOHSM's phase angle on sincosf), so four
//     independent chains overlap on the special-function units, as
//     add_pair_cotangents4's do for MOSM;
//   generic, for any D and A: one element at a time on the library
//     functions (LibraryMath), once per chunk of kChunk = 8 slots (the
//     transcendental functions evaluated again for each further chunk),
//     the scalars read from global memory.
#pragma once
#include "family_element.cuh"
#include "mosm_pair_vjp.cuh"

namespace {

// The generic instance's math: expf and sincosf, the full-precision library
// functions, on the angle in radians as the plain twins form it.
struct LibraryMath {
    __device__ __forceinline__ float exp(float x) const { return expf(x); }
    __device__ __forceinline__ void sincos_turns(float y, float& S, float& C) const {
        sincosf(kFamTwoPi * y, &S, &C);
    }
    __device__ __forceinline__ void sincos_turns_phase(float y, float phi, float& S,
                                                       float& C) const {
        sincosf(kFamTwoPi * y + phi, &S, &C);
    }
};

// The unrolled instances' math, that of mosm_pair_vjp.cuh's four-element
// chain: the exponential on ex2 (__expf) and sin/cos(2 pi y) by
// sincos_two_pi, an exact reduction by whole turns of y, kept in the twin's
// order (CSM's a + s_r, SM-LMC's tau mu_qd), then the hardware's sin and
// cos. uMOSM's and MOHSM's twins add the pair's phase in radians to 2 pi a:
// that angle keeps LibraryMath's sincosf, as the twin forms it. A rotation
// of the turn-reduced sin/cos(2 pi a) by the phase's cos and sin missed the
// CUDA tests' float64 check of MOHSM's phase gradient (D = 2, the
// closed-form cotangent: 1.2e-5 of its scale against the limit's 1.1e-5),
// which sincosf passes: at the moderate angles there the hardware's absolute
// error, ~2^-21.4, is above the float32 twin's.
struct HardwareMath : LibraryMath {
    __device__ __forceinline__ float exp(float x) const { return __expf(x); }
    __device__ __forceinline__ void sincos_turns(float y, float& S, float& C) const {
        sincos_two_pi(y, S, C);
    }
};

// The element chain of a family's unrolled instance, as an element policy
// of csrc/lowrank_vjp.cuh: the pair's S scalars (row, in global or shared
// memory) in registers, and add4 runs grad for four elements (the points xi
// and xj[k], cotangents gv[k]) into the slot sums acc.
template <int F, int kD_, int kA>
struct FamilyChain {
    static constexpr int kD = kD_;
    static constexpr int kSlots = family_slots(F, kD, kA);
    static constexpr int kMinBlocks = kSlots <= 8 ? 2 : 1;   // 128 registers a thread
    float s[kSlots];
    HardwareMath m;

    __device__ __forceinline__ explicit FamilyChain(const float* row) {
#pragma unroll
        for (int k = 0; k < kSlots; ++k) s[k] = row[k];
    }
    __device__ __forceinline__ void add4(const float (&gv)[4], const float (&xi)[kD],
                                         const float (&xj)[4][kD], float (&acc)[kSlots]) const {
        const float* const xs[4] = {xj[0], xj[1], xj[2], xj[3]};
        DirectEmit<kSlots> emit{acc};
        Family<F, kD, kA>::template grad<4>(m, gv, s, xi, xs, kD, kA, emit);
    }
};

// K-fam-gram-bwd's unrolled tile: xi[u] / xj[v] the inputs of the thread's
// rows ty + 16u and columns tx + 16v; stg: the pair's S scalars; prow: this
// block's partial row. Each row's eight columns go through the chain four
// at a time. Every thread calls it.
template <int F, int kD, int kA>
__device__ __forceinline__ void family_tile_unrolled(const float (&g)[kMicro][kMicro],
                                                     const float (&xi)[kMicro][kD],
                                                     const float (&xj)[kMicro][kD],
                                                     const float* __restrict__ stg,
                                                     float* __restrict__ prow) {
    using Chain = FamilyChain<F, kD, kA>;
    __shared__ float red[kThreads / 32][Chain::kSlots];
    const Chain chain(stg);
    float acc[Chain::kSlots];
#pragma unroll
    for (int k = 0; k < Chain::kSlots; ++k) acc[k] = 0.0f;
#pragma unroll
    for (int u = 0; u < kMicro; ++u)
#pragma unroll
        for (int v0 = 0; v0 < kMicro; v0 += 4) {
            float gv[4], xs[4][kD];
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                gv[k] = g[u][v0 + k];
#pragma unroll
                for (int d = 0; d < kD; ++d) xs[k][d] = xj[v0 + k][d];
            }
            chain.add4(gv, xi[u], xs, acc);
        }
    block_reduce_store<Chain::kSlots>(acc, red, prow);
}

// The generic tile: xr[u] / xc[v] pointers to the D inputs of the thread's
// rows / columns (any finite values where g is 0); st: the pair's S scalars
// in global memory. Every thread calls it.
template <int F>
__device__ void family_tile_generic(const float (&g)[kMicro][kMicro],
                                    const float* const (&xr)[kMicro],
                                    const float* const (&xc)[kMicro],
                                    const float* __restrict__ st, int S, int D, int A,
                                    float* __restrict__ prow) {
    __shared__ float red[kThreads / 32][kChunk];
    const int t = threadIdx.x, lane = t % 32, warp = t / 32;
    const LibraryMath m{};
    for (int k0 = 0; k0 < S; k0 += kChunk) {
        float acc[kChunk];
#pragma unroll
        for (int k = 0; k < kChunk; ++k) acc[k] = 0.0f;
        ChunkEmit emit{acc, k0};
        // not unrolled: the generic instance is the rare path, and its code
        // stays small (g in local memory)
#pragma unroll 1
        for (int u = 0; u < kMicro; ++u)
#pragma unroll 1
            for (int v = 0; v < kMicro; ++v) {
                const float gv[1] = {g[u][v]};
                const float* const xs[1] = {xc[v]};
                Family<F, 0, 0>::template grad<1>(m, gv, st, xr[u], xs, D, A, emit);
            }
#pragma unroll
        for (int k = 0; k < kChunk; ++k) {
            float v = acc[k];
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
            if (lane == 0) red[warp][k] = v;
        }
        __syncthreads();
        if (t < kChunk && k0 + t < S) {
            float v = 0.0f;
            for (int w = 0; w < kThreads / 32; ++w) v += red[w][t];
            prow[k0 + t] = v;
        }
        __syncthreads();   // red is written again by the next chunk
    }
}

}  // namespace
