// The MOSM Gram's element as K-gram computes it (csrc/mosm_gram.cu), shared
// with K-gram-matvec (csrc/mosm_matvec.cu), for Hopper (sm_90a), float32:
//   K = sum_q alpha_q exp(-1/2 sum_d V_qd tau_d^2) cos(2 pi (sum_d M_qd tau_d + dphi_q)),
//   tau_d = xi[d] - xj[d] + dtheta_qd,
// where the statistics are those of the pair's row of the table
// (ops/mosm_gram.stats_table): [V, M, dtheta] x (q, d), then [alpha, dphi] x q.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include "gram_tile.cuh"

namespace {

using gram_tile::cos_two_pi;

// Component q's statistics of one pair, [V, M, dtheta] x d, then alpha and
// dphi, from the pair's row p of the table (ops/mosm_gram.stats_table:
// [V, M, dtheta] x (q, d), then [alpha, dphi] x q).
template <int D>
struct CompStats {
    float v[D], m[D], th[D], al, ph;
};

template <int D>
__device__ __forceinline__ void load_comp(CompStats<D>& s, const float* p, int q, int Q) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
        s.v[d] = p[3 * (q * D + d)];
        s.m[d] = p[3 * (q * D + d) + 1];
        s.th[d] = p[3 * (q * D + d) + 2];
    }
    s.al = p[3 * Q * D + 2 * q];
    s.ph = p[3 * Q * D + 2 * q + 1];
}

// Component q's term of the element: e and the angle's turns y = dphi +
// sum_d M tau_d in the plain twin's order and rounding, exp(-1/2 e) by expf
// (the hardware's ex2 after a two-part product by log2(e): within ~2 ulp, as
// the twin's), and cos(2 pi y) by cos_two_pi. The element, these terms
// summed over q in order from 0, then differs from the twin's only where the
// twin rounds 2 pi y (~1.5e-5 rad at y ~ 40) and by the hardware cos's
// 2^-21.4: closer to the exact value. (ex2.approx of a once-rounded
// product, or an argument summed by FMAs, drifted far enough from the
// twin's rounding that a sparse model's first-step gradient left the
// float64 check's bound: chip_smoke.py phase 15, SparseHensman.)
template <int D>
__device__ __forceinline__ float gram_term(const CompStats<D>& s, const float (&xi)[D],
                                           const float (&xj)[D]) {
    float e = 0.0f, a = 0.0f;
#pragma unroll
    for (int d = 0; d < D; ++d) {
        const float td = (xi[d] - xj[d]) + s.th[d];
        e += td * td * s.v[d];
        a += td * s.m[d];
    }
    return s.al * expf(-0.5f * e) * cos_two_pi(a + s.ph);
}

// With Q compiled in: a pair's whole statistics, and the element, its
// component terms summed in order from 0.
template <int Q, int D>
__device__ __forceinline__ void load_pair(CompStats<D> (&s)[Q], const float* p) {
#pragma unroll
    for (int q = 0; q < Q; ++q) load_comp(s[q], p, q, Q);
}

template <int Q, int D>
__device__ __forceinline__ float gram_element(const CompStats<D> (&s)[Q], const float (&xi)[D],
                                              const float (&xj)[D]) {
    float k = 0.0f;
#pragma unroll
    for (int q = 0; q < Q; ++q) k += gram_term(s[q], xi, xj);
    return k;
}

// The whole element for a runtime D, p the pair's row of the table.
__device__ __forceinline__ float gram_element_rt(const float* p, const float* xi, const float* xj,
                                                 int Q, int D) {
    float k = 0.0f;
    for (int q = 0; q < Q; ++q) {
        float e = 0.0f, a = 0.0f;
        for (int d = 0; d < D; ++d) {
            const float* s3 = p + 3 * (q * D + d);
            const float td = (xi[d] - xj[d]) + s3[2];
            e += td * td * s3[0];
            a += td * s3[1];
        }
        const float* s2 = p + 3 * Q * D + 2 * q;
        k += s2[0] * expf(-0.5f * e) * cos_two_pi(a + s2[1]);
    }
    return k;
}

}  // namespace
