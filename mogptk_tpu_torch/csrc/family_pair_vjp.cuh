// The tile reduction shared by the two kernels that turn a Gram cotangent
// into cotangents of a family's pack (csrc/family_gram_bwd.cu, where the
// cotangent is read from memory, and csrc/family_lowrank_vjp.cu, where it is
// A B^T): each thread holds the cotangent g of its 8 x 8 elements of a
// 128 x 128 quarter tile (the geometry of csrc/mosm_pair_vjp.cuh, whose
// constants, fixed-order block reduction and float64 per-pair reduction are
// reused), runs the family's hand-derived element derivatives
// (csrc/family_element.cuh) and writes the block's S sums, in a fixed
// order, to its row of the partial table. No atomics: deterministic.
//
// Two instances: unrolled for the (family, D, A) of MOGPTK_FAMILY_UNROLLED,
// the pair's S scalars and the S accumulators in registers; and a generic
// one for any D and A, which runs the element once per chunk of kChunk = 8
// slots (the transcendental functions evaluated again for each further
// chunk), reading the scalars from global memory.
#pragma once
#include "family_element.cuh"
#include "mosm_pair_vjp.cuh"

namespace {

// xi[u] / xj[v]: the inputs of the thread's rows ty + 16u and columns
// tx + 16v; stg: the pair's S scalars; prow: this block's partial row.
// Every thread calls it.
template <int F, int kD, int kA>
__device__ __forceinline__ void family_tile_unrolled(const float (&g)[kMicro][kMicro],
                                                     const float (&xi)[kMicro][kD],
                                                     const float (&xj)[kMicro][kD],
                                                     const float* __restrict__ stg,
                                                     float* __restrict__ prow) {
    constexpr int NS = family_slots(F, kD, kA);
    __shared__ float red[kThreads / 32][NS];
    float s[NS], acc[NS];
#pragma unroll
    for (int k = 0; k < NS; ++k) {
        s[k] = __ldg(stg + k);
        acc[k] = 0.0f;
    }
    DirectEmit<NS> emit{acc};
#pragma unroll
    for (int u = 0; u < kMicro; ++u)
#pragma unroll
        for (int v = 0; v < kMicro; ++v)
            Family<F, kD, kA>::grad(g[u][v], s, xi[u], xj[v], kD, kA, emit);
    block_reduce_store<NS>(acc, red, prow);
}

// xr[u] / xc[v]: pointers to the D inputs of the thread's rows / columns
// (any finite values where g is 0); st: the pair's S scalars in global
// memory. Every thread calls it.
template <int F>
__device__ void family_tile_generic(const float (&g)[kMicro][kMicro],
                                    const float* const (&xr)[kMicro],
                                    const float* const (&xc)[kMicro],
                                    const float* __restrict__ st, int S, int D, int A,
                                    float* __restrict__ prow) {
    __shared__ float red[kThreads / 32][kChunk];
    const int t = threadIdx.x, lane = t % 32, warp = t / 32;
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
            for (int v = 0; v < kMicro; ++v)
                Family<F, 0, 0>::grad(g[u][v], st, xr[u], xc[v], D, A, emit);
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
