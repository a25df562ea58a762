// One element of the Gram of a non-MOSM multi-output family, from the S
// scalars of its channel pair, and the element's hand-derived derivatives
// with respect to those S scalars. Shared by K-fam-gram, K-fam-gram-bwd,
// K-fam-matvec and K-fam-lowrank-vjp (csrc/family_*.cu); the torch twins in
// ops/block_families.py (_VALUE, _GRAD) are the same formulas.
//
// The pack (ops/block_families.family_pack, JAX ops/block_families.py
// _*_spec) gives each channel pair S scalars, in the JAX package's order:
//   uMOSM  (0): [V_d, M_d, dtheta_d] x D, alpha, dphi                  S = 3D + 2
//     K = alpha exp(-1/2 sum_d V td^2) cos(2 pi sum_d M td + dphi), td = xi - xj + dtheta
//   CSM    (1): [v_d] x D, [mu_d] x D, [amp_r] x A, [s_r] x A (A = Rq)   S = 2D + 2A
//     K = sum_r amp_r exp(-1/2 sum_d v tau^2) cos(2 pi (sum_d mu tau + s_r)), tau = xi - xj
//   CONV   (2): [1/v_d] x D, magnitude                                  S = D + 1
//     K = mag exp(-1/2 sum_d tau^2 / v_d)
//   MOHSM  (3): [V_d, M_d, dtheta_d] x D, alpha, dphi, l, [center_d] x D S = 4D + 3
//     K = alpha exp(-1/2 (sum_d V td^2 + l sum_d ((xi + xj)/2 - c_d)^2)) cos(2 pi sum_d M td + dphi)
//     (the envelope's mean-position term is not a function of tau)
//   SM-LMC (4): [a_q] x A, [var_qd] x AD, [mu_qd] x AD (A = Q)           S = A + 2AD
//     K = sum_q a_q sum_d exp(-2 pi^2 tau_d^2 var_qd) cos(2 pi tau_d mu_qd)  (a sum over d)
// value() runs expf and cosf, the full-precision library functions (no fast
// math): the cosine arguments reach hundreds of radians on the bench data.
//
// Each family is a struct with
//   value(s, xi, xj, D, A) -> K
//   grad<NE>(m, g, s, xi, xj, D, A, emit): for NE elements at once, of the
//     points xi and xj[e] with cotangents g[e], emit(k, g[e] dK/ds_k) for
//     every k and e
// templated on <kD, kA>: a nonzero kD (kA) fixes the input dims (the
// component count) at compile time, so the loops unroll and the emitted slot
// indices are constants (the unrolled instances keep their S accumulators in
// registers); 0 takes the runtime D (A). grad's component loop is outermost
// and its NE elements innermost, so the NE exp and sin/cos chains are
// independent; it takes its exp and sin/cos from the math policy m
// (csrc/family_pair_vjp.cuh: the library functions, or the hardware's with
// an exact reduction by whole turns):
//   m.exp(x) = e^x
//   m.sincos_turns(y, S, C): S, C = sin, cos (2 pi y)
//   m.sincos_turns_phase(y, phi, S, C): sin, cos (2 pi y + phi), phi in
//     radians (uMOSM's and MOHSM's phase)
#pragma once
#include <cuda_runtime.h>

namespace {

constexpr float kFamTwoPi = 6.283185307179586f;
constexpr float kFamTwoPiSq = 19.739208802178716f;   // 2 pi^2

enum FamilyId { kUmosm = 0, kCsm = 1, kConv = 2, kMohsm = 3, kLmcSm = 4 };

__host__ __device__ constexpr int family_slots(int fam, int D, int A) {
    return fam == kUmosm ? 3 * D + 2
         : fam == kCsm   ? 2 * D + 2 * A
         : fam == kConv  ? D + 1
         : fam == kMohsm ? 4 * D + 3
         :                 A + 2 * A * D;
}

template <int F, int kD, int kA> struct Family;

template <int kD, int kA> struct Family<kUmosm, kD, kA> {
    static __device__ __forceinline__ float value(const float* s, const float* xi,
                                                  const float* xj, int D_, int A_) {
        const int D = kD ? kD : D_;
        float e = 0.0f, a = 0.0f;
#pragma unroll
        for (int d = 0; d < D; ++d) {
            const float td = (xi[d] - xj[d]) + s[3 * d + 2];
            e += td * td * s[3 * d];
            a += td * s[3 * d + 1];
        }
        return s[3 * D] * expf(-0.5f * e) * cosf(kFamTwoPi * a + s[3 * D + 1]);
    }
    template <int NE, class M, class Emit>
    static __device__ __forceinline__ void grad(const M& m, const float (&g)[NE], const float* s,
                                                const float* xi, const float* const (&xj)[NE],
                                                int D_, int A_, Emit& emit) {
        const int D = kD ? kD : D_;
        float a[NE], gE[NE], S[NE], C[NE];
#pragma unroll
        for (int k = 0; k < NE; ++k) {
            float e = 0.0f;
            a[k] = 0.0f;
#pragma unroll
            for (int d = 0; d < D; ++d) {
                const float td = (xi[d] - xj[k][d]) + s[3 * d + 2];
                e += td * td * s[3 * d];
                a[k] += td * s[3 * d + 1];
            }
            gE[k] = g[k] * m.exp(-0.5f * e);
        }
#pragma unroll
        for (int k = 0; k < NE; ++k) m.sincos_turns_phase(a[k], s[3 * D + 1], S[k], C[k]);
#pragma unroll
        for (int k = 0; k < NE; ++k) {
            const float P = s[3 * D] * gE[k];
            const float dang = -P * S[k];
            const float de = -0.5f * P * C[k];
            emit(3 * D, gE[k] * C[k]);
            emit(3 * D + 1, dang);
#pragma unroll
            for (int d = 0; d < D; ++d) {
                const float td = (xi[d] - xj[k][d]) + s[3 * d + 2];
                emit(3 * d, de * td * td);
                emit(3 * d + 1, kFamTwoPi * dang * td);
                emit(3 * d + 2, de * (2.0f * s[3 * d]) * td + kFamTwoPi * dang * s[3 * d + 1]);
            }
        }
    }
};

template <int kD, int kA> struct Family<kMohsm, kD, kA> {
    static __device__ __forceinline__ float value(const float* s, const float* xi,
                                                  const float* xj, int D_, int A_) {
        const int D = kD ? kD : D_;
        float e = 0.0f, a = 0.0f, dist2 = 0.0f;
#pragma unroll
        for (int d = 0; d < D; ++d) {
            const float td = (xi[d] - xj[d]) + s[3 * d + 2];
            e += td * td * s[3 * d];
            a += td * s[3 * d + 1];
            const float avg = 0.5f * (xi[d] + xj[d]) - s[3 * D + 3 + d];
            dist2 += avg * avg;
        }
        return s[3 * D] * expf(-0.5f * (e + dist2 * s[3 * D + 2]))
               * cosf(kFamTwoPi * a + s[3 * D + 1]);
    }
    template <int NE, class M, class Emit>
    static __device__ __forceinline__ void grad(const M& m, const float (&g)[NE], const float* s,
                                                const float* xi, const float* const (&xj)[NE],
                                                int D_, int A_, Emit& emit) {
        const int D = kD ? kD : D_;
        const float l = s[3 * D + 2];
        float a[NE], dist2[NE], gE[NE], S[NE], C[NE];
#pragma unroll
        for (int k = 0; k < NE; ++k) {
            float e = 0.0f;
            a[k] = dist2[k] = 0.0f;
#pragma unroll
            for (int d = 0; d < D; ++d) {
                const float td = (xi[d] - xj[k][d]) + s[3 * d + 2];
                e += td * td * s[3 * d];
                a[k] += td * s[3 * d + 1];
                const float avg = 0.5f * (xi[d] + xj[k][d]) - s[3 * D + 3 + d];
                dist2[k] += avg * avg;
            }
            gE[k] = g[k] * m.exp(-0.5f * (e + dist2[k] * l));
        }
#pragma unroll
        for (int k = 0; k < NE; ++k) m.sincos_turns_phase(a[k], s[3 * D + 1], S[k], C[k]);
#pragma unroll
        for (int k = 0; k < NE; ++k) {
            const float P = s[3 * D] * gE[k];
            const float dang = -P * S[k];
            const float de = -0.5f * P * C[k];
            emit(3 * D, gE[k] * C[k]);
            emit(3 * D + 1, dang);
            emit(3 * D + 2, de * dist2[k]);
#pragma unroll
            for (int d = 0; d < D; ++d) {
                const float td = (xi[d] - xj[k][d]) + s[3 * d + 2];
                const float avg = 0.5f * (xi[d] + xj[k][d]) - s[3 * D + 3 + d];
                emit(3 * d, de * td * td);
                emit(3 * d + 1, kFamTwoPi * dang * td);
                emit(3 * d + 2, de * (2.0f * s[3 * d]) * td + kFamTwoPi * dang * s[3 * d + 1]);
                emit(3 * D + 3 + d, -2.0f * de * l * avg);
            }
        }
    }
};

template <int kD, int kA> struct Family<kCsm, kD, kA> {
    static __device__ __forceinline__ float value(const float* s, const float* xi,
                                                  const float* xj, int D_, int A_) {
        const int D = kD ? kD : D_;
        const int A = kA ? kA : A_;
        float e = 0.0f, a = 0.0f;
#pragma unroll
        for (int d = 0; d < D; ++d) {
            const float tau = xi[d] - xj[d];
            e += tau * tau * s[d];
            a += tau * s[D + d];
        }
        const float E = expf(-0.5f * e);
        float k = 0.0f;
#pragma unroll
        for (int r = 0; r < A; ++r) k += s[2 * D + r] * E * cosf(kFamTwoPi * (a + s[2 * D + A + r]));
        return k;
    }
    template <int NE, class M, class Emit>
    static __device__ __forceinline__ void grad(const M& m, const float (&g)[NE], const float* s,
                                                const float* xi, const float* const (&xj)[NE],
                                                int D_, int A_, Emit& emit) {
        const int D = kD ? kD : D_;
        const int A = kA ? kA : A_;
        float a[NE], gE[NE], da[NE], csum[NE];
#pragma unroll
        for (int k = 0; k < NE; ++k) {
            float e = 0.0f;
            a[k] = da[k] = csum[k] = 0.0f;
#pragma unroll
            for (int d = 0; d < D; ++d) {
                const float tau = xi[d] - xj[k][d];
                e += tau * tau * s[d];
                a[k] += tau * s[D + d];
            }
            gE[k] = g[k] * m.exp(-0.5f * e);
        }
#pragma unroll
        for (int r = 0; r < A; ++r) {
            float S[NE], C[NE];
#pragma unroll
            for (int k = 0; k < NE; ++k) m.sincos_turns(a[k] + s[2 * D + A + r], S[k], C[k]);
#pragma unroll
            for (int k = 0; k < NE; ++k) {
                const float dang = -s[2 * D + r] * gE[k] * S[k];
                emit(2 * D + r, gE[k] * C[k]);
                emit(2 * D + A + r, kFamTwoPi * dang);
                da[k] += kFamTwoPi * dang;
                csum[k] += s[2 * D + r] * C[k];
            }
        }
#pragma unroll
        for (int k = 0; k < NE; ++k) {
            const float de = -0.5f * gE[k] * csum[k];
#pragma unroll
            for (int d = 0; d < D; ++d) {
                const float tau = xi[d] - xj[k][d];
                emit(d, de * tau * tau);
                emit(D + d, da[k] * tau);
            }
        }
    }
};

template <int kD, int kA> struct Family<kConv, kD, kA> {
    static __device__ __forceinline__ float value(const float* s, const float* xi,
                                                  const float* xj, int D_, int A_) {
        const int D = kD ? kD : D_;
        float e = 0.0f;
#pragma unroll
        for (int d = 0; d < D; ++d) {
            const float tau = xi[d] - xj[d];
            e += tau * tau * s[d];
        }
        return s[D] * expf(-0.5f * e);
    }
    template <int NE, class M, class Emit>
    static __device__ __forceinline__ void grad(const M& m, const float (&g)[NE], const float* s,
                                                const float* xi, const float* const (&xj)[NE],
                                                int D_, int A_, Emit& emit) {
        const int D = kD ? kD : D_;
#pragma unroll
        for (int k = 0; k < NE; ++k) {
            float e = 0.0f;
#pragma unroll
            for (int d = 0; d < D; ++d) {
                const float tau = xi[d] - xj[k][d];
                e += tau * tau * s[d];
            }
            const float gE = g[k] * m.exp(-0.5f * e);
            const float de = -0.5f * s[D] * gE;
            emit(D, gE);
#pragma unroll
            for (int d = 0; d < D; ++d) {
                const float tau = xi[d] - xj[k][d];
                emit(d, de * tau * tau);
            }
        }
    }
};

template <int kD, int kA> struct Family<kLmcSm, kD, kA> {
    static __device__ __forceinline__ float value(const float* s, const float* xi,
                                                  const float* xj, int D_, int A_) {
        const int D = kD ? kD : D_;
        const int A = kA ? kA : A_;
        float k = 0.0f;
#pragma unroll
        for (int q = 0; q < A; ++q) {
            float acc = 0.0f;
#pragma unroll
            for (int d = 0; d < D; ++d) {
                const float tau = xi[d] - xj[d];
                acc += expf(-kFamTwoPiSq * tau * tau * s[A + q * D + d])
                       * cosf(kFamTwoPi * tau * s[A + A * D + q * D + d]);
            }
            k += s[q] * acc;
        }
        return k;
    }
    template <int NE, class M, class Emit>
    static __device__ __forceinline__ void grad(const M& m, const float (&g)[NE], const float* s,
                                                const float* xi, const float* const (&xj)[NE],
                                                int D_, int A_, Emit& emit) {
        const int D = kD ? kD : D_;
        const int A = kA ? kA : A_;
#pragma unroll
        for (int q = 0; q < A; ++q) {
            float acc[NE];
#pragma unroll
            for (int k = 0; k < NE; ++k) acc[k] = 0.0f;
#pragma unroll
            for (int d = 0; d < D; ++d) {
                const float var = s[A + q * D + d], mu = s[A + A * D + q * D + d];
                float E[NE], S[NE], C[NE];
#pragma unroll
                for (int k = 0; k < NE; ++k) {
                    const float tau = xi[d] - xj[k][d];
                    E[k] = m.exp(-kFamTwoPiSq * tau * tau * var);
                    m.sincos_turns(tau * mu, S[k], C[k]);
                }
#pragma unroll
                for (int k = 0; k < NE; ++k) {
                    const float tau = xi[d] - xj[k][d];
                    const float ga = g[k] * s[q];
                    acc[k] += E[k] * C[k];
                    emit(A + q * D + d, -kFamTwoPiSq * ga * E[k] * C[k] * tau * tau);
                    emit(A + A * D + q * D + d, -kFamTwoPi * ga * E[k] * S[k] * tau);
                }
            }
#pragma unroll
            for (int k = 0; k < NE; ++k) emit(q, g[k] * acc[k]);
        }
    }
};

// Adds every emitted term to its slot of a register array: with kD and kA
// fixed the slot indices are constants after unrolling.
template <int NS>
struct DirectEmit {
    float (&acc)[NS];
    __device__ __forceinline__ void operator()(int k, float v) const { acc[k] += v; }
};

// The generic instances' emitter: keeps only the slots [k0, k0 + kChunk),
// in registers, so a pass per chunk of kChunk slots covers any S.
constexpr int kChunk = 8;
struct ChunkEmit {
    float (&acc)[kChunk];
    int k0;
    __device__ __forceinline__ void operator()(int k, float v) const {
        const int c = k - k0;
#pragma unroll
        for (int i = 0; i < kChunk; ++i)
            if (c == i) acc[i] += v;
    }
};

}  // namespace

// Expands M(F, kD, kA) for each family and its unrolled (kD, kA) instances
// of the backward kernels: input dims 1 and 2, and 1 or 2 components for
// CSM and SM-LMC. Everything else takes the generic instance (kD = kA = 0).
#define MOGPTK_FAMILY_UNROLLED(M)                                            \
    M(kUmosm, 1, 0) M(kUmosm, 2, 0) M(kConv, 1, 0) M(kConv, 2, 0)           \
    M(kMohsm, 1, 0) M(kMohsm, 2, 0)                                          \
    M(kCsm, 1, 1) M(kCsm, 1, 2) M(kCsm, 2, 1) M(kCsm, 2, 2)                  \
    M(kLmcSm, 1, 1) M(kLmcSm, 1, 2) M(kLmcSm, 2, 1) M(kLmcSm, 2, 2)
