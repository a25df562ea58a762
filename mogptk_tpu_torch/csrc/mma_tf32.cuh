// The warp-level 3xTF32 product shared by K-matvec's fold
// (csrc/mosm_matvec.cu), K-solve (csrc/fused_cho_solve.cu) and
// K-lowrank-vjp (csrc/mosm_lowrank_vjp.cu): mma.sync m16n8k8 .tf32 with
// FP32 accumulators, each operand split in registers into big = rna(x) and
// small = rna(x - big), three products (small.big, big.small, big.big); each
// product is within ~12 u |a.b| (u = 2^-24), as in gemm_tf32x3.cuh.
//
// Fragment layout (PTX ISA, m16n8k8 .tf32), g = lane / 4, q = lane % 4:
//   A (16 x 8, row): a0 (g, q), a1 (g + 8, q), a2 (g, q + 4), a3 (g + 8, q + 4)
//   B (8 x 8, col):  b0 (q, g), b1 (q + 4, g)
//   C (16 x 8):      c0 (g, 2q), c1 (g, 2q + 1), c2 (g + 8, 2q), c3 (g + 8, 2q + 1)
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// cvt.rna.tf32.f32's result for every finite x and +-inf (round to
// nearest, ties away from zero: half a TF32 ulp added to the magnitude, the
// 13 low bits cleared), in two integer operations instead of the
// conversion, which issues at a fraction of the ALU rate. Not for NaN: the
// add carries the canonical NaN 0x7fffffff into the sign bit (-0).
__device__ __forceinline__ uint32_t tf32_rna_bits(float x) {
    return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// big = rna(x), small = rna(x - big), as TF32 bit patterns, cvt.rna's for
// finite x. NaN x spreads through small: whatever big holds, x - big is the
// canonical NaN 0x7fffffff that every FP32 operation on the card yields,
// and small clamps it below the carry (a signed min with 0x7fffefff, which
// passes every finite, infinite and negative pattern unchanged), so it
// rounds to the TF32 NaN 0x7fffe000 and each product with it is NaN: one
// operation a split, where a guard on each half takes three.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
    big = tf32_rna_bits(x);
    const int d = __float_as_int(x - __uint_as_float(big));
    small = ((uint32_t)min(d, 0x7fffefff) + 0x1000u) & 0xffffe000u;
}

// d += a . b for one m16n8k8 TF32 step (FP32 accumulators)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc += a . b over one 8-deep k step, 3xTF32, with a split in (ab, as) and
// b's two values split in (bb0, bs0), (bb1, bs1). The three products go into
// fresh accumulators and their sum into acc by FP32 adds: the tensor cores
// truncate each sum they accumulate, a bias that grows with the length of
// the chain, so the chain is one k step long and the running sums round to
// nearest.
__device__ __forceinline__ void mma3_add(float (&acc)[4], const uint32_t (&ab)[4],
                                         const uint32_t (&as)[4], uint32_t bb0, uint32_t bs0,
                                         uint32_t bb1, uint32_t bs1) {
    float t[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    mma_tf32(t, as, bb0, bb1);
    mma_tf32(t, ab, bs0, bs1);
    mma_tf32(t, ab, bb0, bb1);
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[e] += t[e];
}

}  // namespace
