// The instances of K-gram-bwd's tile kernel with the input half (dx1, dx2),
// unrolled over Q <= 4 and D <= 2, compiled apart from csrc/mosm_gram_bwd.cu
// (which documents the kernel and calls this) so that the two build in
// parallel.
#include "mosm_gram_bwd.cuh"

int launch_gram_bwd_inputs_unrolled(int Q, int D, unsigned blocks, const int* idx, const float* g,
                                    int64_t M, const float* x1, const int* rmap, const float* x2,
                                    const int* cmap, const float* stats, float* partial,
                                    float* rowpart, float* colpart, bool rows, bool cols,
                                    cudaStream_t stream) {
#define MOGPTK_BWD_CASE(q, d)                                                                \
    if (Q == q && D == d) {                                                                  \
        gram_bwd_kernel<q, d, true><<<blocks, kThreads, 0, stream>>>(                        \
            idx, g, M, x1, rmap, x2, cmap, stats, partial, rowpart, colpart, rows, cols);    \
        return 0;                                                                            \
    }
    MOGPTK_BWD_CASE(1, 1) MOGPTK_BWD_CASE(2, 1) MOGPTK_BWD_CASE(3, 1) MOGPTK_BWD_CASE(4, 1)
    MOGPTK_BWD_CASE(1, 2) MOGPTK_BWD_CASE(2, 2) MOGPTK_BWD_CASE(3, 2) MOGPTK_BWD_CASE(4, 2)
#undef MOGPTK_BWD_CASE
    return (int)cudaErrorInvalidValue;
}
