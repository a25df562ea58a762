// The tile skeleton of the two Gram kernels, K-gram (csrc/mosm_gram.cu) and
// K-fam-gram (csrc/family_gram.cu), for Hopper (sm_90a), float32. Each
// kernel supplies its element (its element policy: the pair's scalars and
// the arithmetic of one element); the skeleton is the rest:
//   - a block of 256 threads takes a 64 x 64 tile, each thread 4 rows
//     (ty + 16k) x 4 neighbouring columns (4 tx + m), written as one float4
//     per row (a warp is 8 tx x 4 ty, so it writes four full 128-byte rows);
//   - begin(): the block's tile, from the two-dimensional grid of every
//     tile or, for the lower call, from a one-dimensional grid over the
//     T (T + 1) / 2 lower tiles (lower_tile, I >= J); the thread's rows and
//     columns clamped into range, their channels, and whether the whole
//     tile lies inside one channel pair, decided by the block at run time
//     (__syncthreads_and), so that the element policy can keep that pair's
//     scalars in registers (channel-sorted data) and index its pair table
//     per element only in a tile that straddles channels;
//   - store(): the tile in its place and, for the lower call where I and J
//     lie in one band-wide diagonal panel, transposed through shared memory
//     to its mirror (J, I), both coalesced; a diagonal tile writes its lower
//     triangle to both halves the same way. With band >= N every tile is
//     mirrored and the Gram is bitwise symmetric, any N; with a smaller band
//     (the blocked Cholesky's band-lower MOSM Gram) the tiles above the band
//     stay unwritten.
// The mirror rests on the element's pair swap: K(xi, xj; pair (a, b)) =
// K(xj, xi; pair (b, a)) in real arithmetic (the scalars that are
// antisymmetric in the pair flip sign with tau).
//
// cos_two_pi is the two kernels' cosine of an angle given in turns.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace gram_tile {

constexpr int kT = 64;             // a block's tile edge
constexpr int kThreads = 256;      // 16 x 16 threads, 4 x 4 elements each
constexpr int kLdS = kT + 1;       // the staged tile's row stride (banks r + c)
constexpr float kTwoPi = 6.283185307179586f;

// cos(2 pi y): r = y - rint(y) exactly (|r| <= 1/2; rint by adding and
// subtracting 1.5 * 2^23, exact for |y| < 2^22, on the FP32 pipes), then the
// hardware's cos of 2 pi r in [-pi, pi] (absolute error < 2^-21.4 there,
// plus 2^-24 relative from the product). A float32 y of ~40 (the bench
// data's angles reach ~250 rad) carries an absolute error of ~1.5e-5 rad in
// the plain twin's cos(2 pi y), far above these. NaN or inf gives NaN.
__device__ __forceinline__ float cos_two_pi(float y) {
    const float kRound = 12582912.0f;
    const float r = __fsub_rn(y, __fsub_rn(__fadd_rn(y, kRound), kRound));
    return __cosf(kTwoPi * r);
}

// Tile (I, J) of block b of the lower call's tiles, row-major:
// b = I (I + 1) / 2 + J, J <= I.
__device__ __forceinline__ void lower_tile(int64_t b, int64_t& I, int64_t& J) {
    I = (int64_t)((sqrt(8.0 * (double)b + 1.0) - 1.0) * 0.5);
    while (I * (I + 1) / 2 > b) --I;
    while ((I + 1) * (I + 2) / 2 <= b) ++I;
    J = b - I * (I + 1) / 2;
}

// The block's tile and the thread's share of it.
struct Tile {
    int64_t I, J, row0, col0;
    int t, tx, ty;
    int64_t ii[4], jj[4];   // the thread's rows and columns, clamped into range
    int ci[4], cj[4];       // their channels
    int ca, cb;             // the channels of the tile's first row and column
    bool uniform;           // every element of the tile in the pair (ca, cb)
};

// Every thread of the block calls it (it synchronises the block).
__device__ __forceinline__ void begin(Tile& g, const int* __restrict__ c1,
                                      const int* __restrict__ c2, int64_t N, int64_t M,
                                      bool lower) {
    if (lower) {
        lower_tile(blockIdx.x, g.I, g.J);
    } else {
        g.I = blockIdx.y;
        g.J = blockIdx.x;
    }
    g.t = threadIdx.x;
    const int warp = g.t / 32, lane = g.t % 32;
    g.tx = lane % 8 + 8 * (warp % 2);
    g.ty = lane / 8 + 4 * (warp / 2);
    g.row0 = g.I * kT;
    g.col0 = g.J * kT;
    g.ca = c1[g.row0];
    g.cb = c2[g.col0];
    bool one_pair = true;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        g.ii[k] = min(g.row0 + g.ty + 16 * k, N - 1);
        g.jj[k] = min(g.col0 + 4 * g.tx + k, M - 1);
        g.ci[k] = c1[g.ii[k]];
        g.cj[k] = c2[g.jj[k]];
        one_pair = one_pair && g.ci[k] == g.ca && g.cj[k] == g.cb;
    }
    g.uniform = __syncthreads_and(one_pair);
}

// The mirror of a staged tile: row r of the output block at (r0, q0) from
// column r of the stage (kOff, an off-diagonal tile's mirror (J, I)), or a
// diagonal tile's rows with the strict upper taken from the lower triangle.
// Two instances, so the off-diagonal tiles, nearly all of a square Gram's,
// test no condition per element.
template <bool kOff>
__device__ __forceinline__ void write_mirror(const float* stage, float* __restrict__ out,
                                             int64_t r0, int64_t q0, int tx, int ty, bool vec,
                                             int64_t N, int64_t M) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        const int r = ty + 16 * k;
        float w[4];
#pragma unroll
        for (int m = 0; m < 4; ++m) {
            const int c = 4 * tx + m;
            w[m] = (kOff || c > r) ? stage[c * kLdS + r] : stage[r * kLdS + c];
        }
        const int64_t i = r0 + r, j = q0 + 4 * tx;
        if (vec) {
            *reinterpret_cast<float4*>(out + i * M + j) = make_float4(w[0], w[1], w[2], w[3]);
        } else if (i < N) {
#pragma unroll
            for (int m = 0; m < 4; ++m)
                if (j + m < M) out[i * M + j + m] = w[m];
        }
    }
}

// Writes the thread's elements val[k][m] (row ty + 16k, column 4 tx + m of
// the tile) and, for the lower call, the mirror; stage is kT * kLdS floats
// of shared memory. Every thread of the block calls it.
__device__ __forceinline__ void store(const Tile& g, const float (&val)[4][4],
                                      float* __restrict__ out, int64_t N, int64_t M, bool lower,
                                      int64_t band, float* stage) {
    const int tx = g.tx, ty = g.ty;
    const int64_t I = g.I, J = g.J, row0 = g.row0, col0 = g.col0;
    // float4 rows where the whole tile is in range and rows are 16-byte aligned
    const bool vec = row0 + kT <= N && col0 + kT <= M && M % 4 == 0;
    // the lower call: a diagonal tile, its lower triangle to both halves; an
    // off-diagonal one inside a band-wide diagonal panel, its mirror too
    const bool diag = lower && I == J;
    const bool mirror = lower && I * kT / band == J * kT / band;
    if (!diag) {   // the tile in its place
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            const int64_t i = row0 + ty + 16 * k, j = col0 + 4 * tx;
            if (vec) {
                *reinterpret_cast<float4*>(out + i * M + j) =
                    make_float4(val[k][0], val[k][1], val[k][2], val[k][3]);
            } else if (i < N) {
#pragma unroll
                for (int m = 0; m < 4; ++m)
                    if (j + m < M) out[i * M + j + m] = val[k][m];
            }
        }
    }
    if (!mirror) return;
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int m = 0; m < 4; ++m) stage[(ty + 16 * k) * kLdS + 4 * tx + m] = val[k][m];
    __syncthreads();
    // I != J: the mirror tile (J, I), its element (r, c) = stage[c][r];
    // I == J: the tile's element (r, c) from the lower triangle
    if (I != J)
        write_mirror<true>(stage, out, col0, row0, tx, ty, vec, N, M);
    else
        write_mirror<false>(stage, out, row0, col0, tx, ty, vec, N, M);
}

}  // namespace gram_tile
