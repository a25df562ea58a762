// One element of the MOSM Gram from the channel-pair statistics, shared by
// K-gram (csrc/mosm_gram.cu) and K-matvec (csrc/mosm_matvec.cu):
//   K = sum_q alpha_q exp(-1/2 sum_d V_qd tau_d^2) cos(2 pi (sum_d M_qd tau_d + dphi_q)),
//   tau_d = xi[d] - xj[d] + dtheta_qd,
// where p is the pair's row of the table (ops/mosm_gram.stats_table):
// [V, M, dtheta] x (q, d), then [alpha, dphi] x q. expf and cosf are the
// full-precision library functions (no fast math): the cosine argument
// reaches ~250 rad on the bench data, where __cosf is wrong.
//
// Two instances (ops/mosm_gram.kernel_instance chooses): kUnrolled runs the
// input-dim loop to the compile-time maximum kMaxD and breaks at D, so the
// compiler unrolls it (D <= kMaxD); the generic instance loops to the
// runtime D. The arithmetic and its order are the same.
#pragma once
#include <cuda_runtime.h>

namespace {

constexpr int kMaxD = 8;   // input dims of the unrolled instance

template <bool kUnrolled>
__device__ __forceinline__ float mosm_element(const float* p, const float* xi, const float* xj,
                                              int Q, int D) {
    const float two_pi = 6.283185307179586f;
    float k = 0.0f;
    for (int q = 0; q < Q; ++q) {
        float e = 0.0f, a = 0.0f;
        if constexpr (kUnrolled) {
#pragma unroll
            for (int d = 0; d < kMaxD; ++d) {
                if (d >= D) break;
                const float* s3 = p + 3 * (q * D + d);
                const float td = (xi[d] - xj[d]) + s3[2];
                e += td * td * s3[0];
                a += td * s3[1];
            }
        } else {
            for (int d = 0; d < D; ++d) {
                const float* s3 = p + 3 * (q * D + d);
                const float td = (xi[d] - xj[d]) + s3[2];
                e += td * td * s3[0];
                a += td * s3[1];
            }
        }
        const float* s2 = p + 3 * Q * D + 2 * q;
        k += s2[0] * expf(-0.5f * e) * cosf(two_pi * (a + s2[1]));
    }
    return k;
}

}  // namespace
