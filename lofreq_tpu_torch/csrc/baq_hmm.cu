// Kernels K3 and K4 for Hopper (sm_90a): the banded glocal BAQ HMM of the
// device-BAQ engine, forward pass (K3) and backward pass with the per-row
// MAP phred and state (K4).
//
// Replace lofreq_tpu/ops/pallas_baq.py:_build.fwd_kernel (K3) and
// _build.bwd_kernel (K4), whose math is lofreq_tpu/ops/baq_jax.py:_build.
// The per-read arithmetic and the band-relative layout are in
// baq_hmm.cuh.
//
// What bounds it: each read is an L-step dependent chain (row i needs
// row i-1), and every row is a few shuffles deep (4 for the D chain, 4
// for the row sum; K4 adds two max, two sum and a ballot for the MAP).
// A read's work is about 200 shuffle-bound steps at L = 100 whatever the
// batch, so the kernels are latency-bound per read and lean on the
// number of reads in flight: one half-warp per read, 8 reads per
// 128-thread block, many blocks per SM.  The bytes are small: per read
// and row 2 x 64 B of band rows plus 4 B of scale written by K3 and read
// back by K4 (13.2 KB a read at L = 100, from device memory or L2).
//
// Design: 16 lanes per read (one per band cell, lane 15 idle), so a row
// is one float per thread and the TPU kernels' 128-lane rolls become
// 1-lane shuffles.  K3 stores the scaled M and I band rows and the row
// scales to a scratch the wrapper allocates; K4 walks the rows back and
// writes q and st.  No shared memory, no synchronisation beyond the warp;
// both launch on the caller's stream.  Keeping the rows in shared memory
// and fusing K3 with K4 is later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "baq_hmm.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kReadsPerBlock = kThreads / LFQ_BAQ_LANES;

// The half-warp's read, and whether it is a real one: the dead reads of
// the last block run on the last real read's inputs and write nothing.
__device__ __forceinline__ int64_t read_index(int64_t n, bool *live) {
    const int64_t r = (int64_t)blockIdx.x * kReadsPerBlock
                      + (threadIdx.x / LFQ_BAQ_LANES);
    *live = r < n;
    return *live ? r : n - 1;
}

__global__ void __launch_bounds__(kThreads)
baq_fwd_kernel(const uint8_t *__restrict__ refw,
               const uint8_t *__restrict__ query,
               const float *__restrict__ qualp,
               const int32_t *__restrict__ l_ref, float *__restrict__ fm,
               float *__restrict__ fi, float *__restrict__ fs, int64_t n,
               int L, int Lr) {
    bool live;
    const int64_t b = read_index(n, &live);
    const LfqBaqConsts c = lfq_baq_consts(L);
    const int64_t rows = b * L;
    lfq_baq_forward(refw + b * Lr, Lr, l_ref[b], query + rows, qualp + rows,
                    L, c, fm + rows * LFQ_BAQ_LANES,
                    fi + rows * LFQ_BAQ_LANES, fs + rows, live);
}

__global__ void __launch_bounds__(kThreads)
baq_bwd_kernel(const uint8_t *__restrict__ refw,
               const uint8_t *__restrict__ query,
               const float *__restrict__ qualp,
               const int32_t *__restrict__ l_ref,
               const float *__restrict__ fm, const float *__restrict__ fi,
               const float *__restrict__ fs, int32_t *__restrict__ q,
               int32_t *__restrict__ st, int64_t n, int L, int Lr) {
    bool live;
    const int64_t b = read_index(n, &live);
    const LfqBaqConsts c = lfq_baq_consts(L);
    const int64_t rows = b * L;
    lfq_baq_backward(refw + b * Lr, Lr, l_ref[b], query + rows, qualp + rows,
                     L, c, fm + rows * LFQ_BAQ_LANES,
                     fi + rows * LFQ_BAQ_LANES, fs + rows, q + rows,
                     st + rows, live);
}

unsigned blocks_for(long long n) {
    return (unsigned)((n + kReadsPerBlock - 1) / kReadsPerBlock);
}

}  // namespace

extern "C" {

// K3.  refw u8 [n, Lr], query u8 [n, L], qualp f32 [n, L], l_ref i32 [n]
// -> fm, fi f32 [n, L, 16] and fs f32 [n, L], all row-major on `device`.
// Returns cudaGetLastError() after the launch (0 = launched).
int lfq_baq_fwd_launch(const void *refw, const void *query, const void *qualp,
                       const void *l_ref, void *fm, void *fi, void *fs,
                       long long n, int L, int Lr, int device, void *stream) {
    if (n <= 0) return (int)cudaSuccess;
    const cudaError_t set = cudaSetDevice(device);
    if (set != cudaSuccess) return (int)set;
    baq_fwd_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t *)refw, (const uint8_t *)query, (const float *)qualp,
        (const int32_t *)l_ref, (float *)fm, (float *)fi, (float *)fs,
        (int64_t)n, L, Lr);
    return (int)cudaGetLastError();
}

// K4.  The inputs of K3 plus its fm, fi, fs -> q, st i32 [n, L].
int lfq_baq_bwd_launch(const void *refw, const void *query, const void *qualp,
                       const void *l_ref, const void *fm, const void *fi,
                       const void *fs, void *q, void *st, long long n, int L,
                       int Lr, int device, void *stream) {
    if (n <= 0) return (int)cudaSuccess;
    const cudaError_t set = cudaSetDevice(device);
    if (set != cudaSuccess) return (int)set;
    baq_bwd_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t *)refw, (const uint8_t *)query, (const float *)qualp,
        (const int32_t *)l_ref, (const float *)fm, (const float *)fi,
        (const float *)fs, (int32_t *)q, (int32_t *)st, (int64_t)n, L, Lr);
    return (int)cudaGetLastError();
}

}  // extern "C"
