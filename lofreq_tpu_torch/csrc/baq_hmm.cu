// Kernels K3 and K4 for Hopper (sm_90a): the banded glocal BAQ HMM of the
// device-BAQ engine, forward pass (K3) and backward pass with the per-row
// MAP phred and state (K4).
//
// Replace lofreq_tpu/ops/pallas_baq.py:_build.fwd_kernel (K3) and
// _build.bwd_kernel (K4), whose math is lofreq_tpu/ops/baq_jax.py:_build.
// The per-read arithmetic, the band-relative layout and the two band
// types are in baq_hmm.cuh.
//
// What bounds them: each read is an L-step dependent chain (row i needs
// row i-1).  The bytes are K3's scratch: per read and row 2 x 64 B of
// band rows plus 4 B of scale, written by K3 and read back by K4 (13.2 KB
// a read at L = 100, 432 MB at the runner's 32,768 reads: past L2, so
// from device memory).  Their byte bounds are 0.127 ms (K3) and 0.135 ms
// (K4) at that batch.
//
// K3: one half-warp per read, one lane per band cell (lane 15 idle), so a
// row is one float per thread and the TPU kernels' 128-lane rolls become
// 1-lane shuffles; 8 reads per 128-thread block.  A row costs 4 shuffles
// for the D chain and 4 for its sum.  It runs at about half its byte
// bound and stores the scaled M and I band rows and the row scales to a
// scratch the wrapper allocates.
//
// K4: one read per thread, the band in registers (LfqBand16).  In the
// half-warp form a row of the backward pass took about 23 shuffles and
// ballots and 75 warp-instructions per read-row, and the row's scalar
// work (the division by the row scale, the phred's division and logf)
// ran on every lane: K4 was bound by instruction issue and the shuffle
// unit at 3.4x its byte bound.  Here the shifts and chain steps are
// register moves under unrolled loops, the sums, maxima and the first
// maximum are the same trees written out in registers, and the scalar
// work runs once per read.  One read per thread has its own cost: a
// warp's load touches 32 reads' cache lines, 32 L1 wavefronts where a
// coalesced load takes 1 to 4, and a row loads 8 float4s of band rows
// and 16 window codes per read: about 800 wavefronts per warp and row,
// more L1 cycles than its four schedulers take to issue the row's
// arithmetic (about 1,400 instructions per warp).  So the block
// stages its band rows through shared memory two rows at a time
// (StagedRows), and the window codes slide down one code per row
// (LfqBand16::Window).  What bounds it then is, by count, latency: the
// runner's 32,768 reads are 1,024 warps, 7.75 per SM, and each row waits
// on the row before, so the schedulers would run out of ready warps (no
// stall or occupancy reading confirms it).  64
// threads per block spread the reads over 512 blocks, about 4 on each of
// the 132 SMs.
//
// Both launch on the caller's stream.  K4 reads back what K3 wrote: a
// fused pass would keep the rows on chip, but a read's 13.2 KB of rows is
// more than a thread's share of the SM's memory, so the two stay apart.

#include <cuda_runtime.h>
#include <stdint.h>

#include "baq_hmm.cuh"

namespace {

// K3: 16 threads per read; K4: one thread per read, its band rows staged
// two rows at a time through a ring of kStages chunks in shared memory
constexpr int kFwdThreads = 128;
constexpr int kFwdReadsPerBlock = kFwdThreads / LFQ_BAQ_LANES;
constexpr int kBwdThreads = 64;
constexpr int kStages = 3;
constexpr int kChunkF4 = 16;  // float4s of a read's chunk: 2 rows of fm, fi

// The half-warp's read, and whether it is a real one: the dead reads of
// the last block run on the last real read's inputs and write nothing.
__device__ __forceinline__ int64_t read_index(int64_t n, bool *live) {
    const int64_t r = (int64_t)blockIdx.x * kFwdReadsPerBlock
                      + (threadIdx.x / LFQ_BAQ_LANES);
    *live = r < n;
    return *live ? r : n - 1;
}

__global__ void __launch_bounds__(kFwdThreads)
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
    lfq_baq_forward<LfqBandLane>(
        refw + b * Lr, Lr, l_ref[b], query + rows, qualp + rows, L, c,
        fm + rows * LFQ_BAQ_LANES, fi + rows * LFQ_BAQ_LANES, fs + rows,
        live);
}

__device__ __forceinline__ void copy16_async(void *smem, const void *gmem) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(gmem)
                 : "memory");
}

// The block's M and I band rows for K4, walked down two rows (a chunk) at
// a time.  One thread's rows lie L * 64 bytes from its neighbour's, so a
// warp's own loads would touch 32 cache lines each; instead the block
// copies each chunk together (cp.async, 16 bytes a thread, a warp's copy
// covering the 128-byte row pairs of 4 reads) into a ring of kStages
// chunks, kStages - 1 ahead, and each thread reads its rows from shared
// memory.  Chunk c holds rows L-1-2c and L-2-2c: per read 16 float4s, q
// 0-3 fm row L-2-2c, 4-7 fm row L-1-2c, 8-15 fi the same, stored at
// q ^ (read & 7) so that 8 neighbouring threads' 16-byte reads hit
// distinct banks.  Every thread of the block asks for the same rows in
// the same order (one L per launch), so a chunk's first row is a block
// barrier.
struct StagedRows {
    const float *fm, *fi;  // the block's first read
    float4 *ring;          // [kStages][kBwdThreads][kChunkF4]
    int L, nreads;         // rows per read, real reads of the block

    __device__ void issue(int c) {
        const int top = L - 1 - 2 * c;
        if (top >= 0) {
#pragma unroll
            for (int k = 0; k < kChunkF4; ++k) {
                const int f = k * kBwdThreads + threadIdx.x;
                const int rd = f / kChunkF4, q = f % kChunkF4;
                const int row = top - 1 + ((q >> 2) & 1);
                // a dead read's slot takes the last real read's rows
                const int src = rd < nreads ? rd : nreads - 1;
                if (row >= 0)
                    copy16_async(
                        ring + ((c % kStages) * kBwdThreads + rd) * kChunkF4
                            + (q ^ (rd & 7)),
                        (q < 8 ? fm : fi)
                            + ((int64_t)src * L + row) * LFQ_BAQ_LANES
                            + 4 * (q & 3));
            }
        }
        asm volatile("cp.async.commit_group;\n" ::: "memory");
    }

    __device__ void start() {
#pragma unroll
        for (int c = 0; c < kStages - 1; ++c) issue(c);
    }

    __device__ void get(int r, LfqBand16 &zM, LfqBand16 &zI) {
        const int c = (L - 1 - r) >> 1;
        if (((L - 1 - r) & 1) == 0) {  // chunk c's first row
            asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2)
                         : "memory");
            __syncthreads();  // every thread's copies of chunk c landed
            issue(c + kStages - 1);  // the chunk every thread is done with
        }
        const int t = threadIdx.x, hi = (r == L - 1 - 2 * c) ? 1 : 0;
        const float4 *src =
            ring + ((c % kStages) * kBwdThreads + t) * kChunkF4;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const float4 m = src[(4 * hi + j) ^ (t & 7)];
            const float4 i = src[(8 + 4 * hi + j) ^ (t & 7)];
            zM.v[4 * j] = m.x;
            zM.v[4 * j + 1] = m.y;
            zM.v[4 * j + 2] = m.z;
            zM.v[4 * j + 3] = m.w;
            zI.v[4 * j] = i.x;
            zI.v[4 * j + 1] = i.y;
            zI.v[4 * j + 2] = i.z;
            zI.v[4 * j + 3] = i.w;
        }
    }
};

__global__ void __launch_bounds__(kBwdThreads)
baq_bwd_kernel(const uint8_t *__restrict__ refw,
               const uint8_t *__restrict__ query,
               const float *__restrict__ qualp,
               const int32_t *__restrict__ l_ref,
               const float *__restrict__ fm, const float *__restrict__ fi,
               const float *__restrict__ fs, int32_t *__restrict__ q,
               int32_t *__restrict__ st, int64_t n, int L, int Lr) {
    __shared__ float4 ring[kStages * kBwdThreads * kChunkF4];  // 48 KB
    const int64_t b0 = (int64_t)blockIdx.x * kBwdThreads;
    const int64_t r = b0 + threadIdx.x;
    // a dead thread (the ragged edge of the last block) runs on the last
    // real read and writes nothing: it takes part in the barriers
    const bool live = r < n;
    const int64_t b = live ? r : n - 1;
    const int nreads = (int)(n - b0 < kBwdThreads ? n - b0 : kBwdThreads);
    const LfqBaqConsts c = lfq_baq_consts(L);
    StagedRows rows{fm + b0 * L * LFQ_BAQ_LANES, fi + b0 * L * LFQ_BAQ_LANES,
                    ring, L, nreads};
    rows.start();
    const int64_t at = b * L;
    lfq_baq_backward<LfqBand16>(refw + b * Lr, Lr, l_ref[b], query + at,
                                qualp + at, L, c, rows, fs + at, q + at,
                                st + at, live);
}

unsigned blocks_for(long long n, int per_block) {
    return (unsigned)((n + per_block - 1) / per_block);
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
    baq_fwd_kernel<<<blocks_for(n, kFwdReadsPerBlock), kFwdThreads, 0,
                     (cudaStream_t)stream>>>(
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
    baq_bwd_kernel<<<blocks_for(n, kBwdThreads), kBwdThreads, 0,
                     (cudaStream_t)stream>>>(
        (const uint8_t *)refw, (const uint8_t *)query, (const float *)qualp,
        (const int32_t *)l_ref, (const float *)fm, (const float *)fi,
        (const float *)fs, (int32_t *)q, (int32_t *)st, (int64_t)n, L, Lr);
    return (int)cudaGetLastError();
}

}  // extern "C"
