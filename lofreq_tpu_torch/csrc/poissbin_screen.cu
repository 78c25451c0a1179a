// Kernel K1 for Hopper (sm_90a): the Poisson-binomial tail DP, with two
// entries.
//
// Replaces lofreq_tpu/ops/pallas_poissbin.py:_build.kernel.  The
// per-column arithmetic is poissbin_screen.cuh.
//
// Entry 1, screen_codes_kernel: the sub-screen over u8 error-prob codes
// [B, S], S a multiple of 16 up to 128, with the decode and compare of
// lofreq_tpu/ops/screen.py:_build_screen_fn.screen_body fused in.
//
// What bounds it: a dispatch is at most 4,096 columns x 128 code bytes
// (512 KB), and the main path sends only the prescreen survivors (16
// dispatches of 48 columns on average at 200 kb@800x), so its bound is
// nanoseconds and the kernel is latency-bound: one thread per column (the
// first design) ran a chain of 128 dependent DP steps, each with an
// accurate exp2f, about 9,000 instructions, on one SM for 48 columns, and
// took the same 17 us at 48 and at 4,096 columns.
//
// Design: each column gets 8 lanes (blocks of 64 threads, 8 columns, so
// 48 columns are 6 blocks on 6 SMs).  Lane s reads its one 16-byte vector
// of the row, codes 16s .. 16s + 15 (a lane past S holds the identity),
// and steps them into a kc-clipped partial from the identity, decoding
// through a 256-entry shared table that the block fills with the same
// lfq_decode.  The partials merge over __shfl_down_sync in a fixed tree
// (lfq_screen_merge, the levels of lfq_screen_tree_role: lane s takes
// lane s + h for h = 1, 2, 4), with no atomics, so a launch repeats bit
// for bit; the chain is 16 steps and three merges.  The merge reorders
// rounding against the serial DP (poissbin_screen.cuh), so the tails
// differ from the plain version's by rounding, far inside the screen's
// MARGIN (ops/screen.py).  lfq_step applies kc by a per-cell factor
// instead of compares and selects (the same bits).  On an H100 (700 W) it
// takes about 6 us per launch at 48 and at 4,096 columns (chip_smoke.py).
//
// Entry 2, tail_probs_kernel: the same DP over f32 probabilities, the
// counterpart of pallas_poissbin.tail_device, which the device column step
// (lofreq_tpu/ops/device_call.py:146-151) calls.  probs is [B, D] f32
// with unit stride along D and a row stride ld >= D, as the step makes
// it, any B and D >= 1.  A p > 1.5 is pad and acts as the identity; other
// values are clipped to [0, 1].
//
// What bounds entry 2: at the deployment shape B = 65,536 columns x
// D = 2,016 reads the probs are 528.5 MB, read once, so 0.158 ms at
// 3.35 TB/s.  The arithmetic has its own floor, set by instruction issue:
// with -fmad=false each cell of a step is two multiplies and an add.
//
// Design: one thread per column and the serial step order, so the linear
// tail is that of lfq_tail_column built by g++ bit for bit.  The first
// design read [D, B], which cost the step a transposing copy per call
// (1.13 ms on an H100), kept about 8 KB of loads in flight per SM, and
// applied kc by per-cell compares and selects, most of a read's
// instructions (0.60 ms per launch).  Now:
// - the DP runs in kc-relative cell order (lfq_rel_step): the tail is
//   cell 0 whatever kc is, and every cell takes the same three operations,
//   with no compare or select;
// - a block of 128 columns stages tiles of [128 columns x 32 reads]
//   (16 KB) into shared memory with 16-byte cp.async copies, in a ring of
//   3 tiles, 2 ahead of the tile being stepped: a warp's copy covers 4
//   columns' contiguous 128-byte runs, and with a 48 KB ring 4 blocks
//   share an SM, up to 128 KB of loads in flight;
// - a column's 8 16-byte pieces of a tile are stored at q ^ (column & 7),
//   so 8 neighbouring threads' 16-byte reads, and a warp's copies, hit
//   distinct banks;
// - a piece that is not 16-byte aligned in global memory (a row stride
//   not a multiple of 4) or that runs past D goes as 4-byte copies, and
//   the last tile of a D that is not a multiple of 32 is stepped read by
//   read.
// On an H100 (700 W) it takes 0.32 ms per launch at the deployment shape,
// twice the byte bound (chip_smoke.py prints the time and the bound).
//
// Both kernels allocate nothing and launch on the caller's stream.  The
// library builds with -fmad=false (_kernel_build.py), so each multiply
// and add rounds on its own, as in the plain PyTorch versions and the g++
// forms of the header (-ffp-contract=off).

#include <cuda_runtime.h>
#include <stdint.h>

#include "poissbin_screen.cuh"

namespace {

constexpr int kLanes = LFQ_SCREEN_TMAX;               // lanes per column
constexpr int kScreenThreads = 64;                    // 8 columns a block
constexpr int kScreenCols = kScreenThreads / kLanes;
static_assert(LFQ_SCREEN_SMAX == kLanes * 16, "a lane reads one uint4");

__global__ void __launch_bounds__(kScreenThreads)
screen_codes_kernel(const uint8_t *__restrict__ codes,
                    const int32_t *__restrict__ ks,
                    const float *__restrict__ log_thresh,
                    float *__restrict__ log_tail,
                    uint8_t *__restrict__ mask, int64_t n_cols, int s) {
    __shared__ float table[LFQ_NCODE];
    lfq_fill_decode_table(table, threadIdx.x, kScreenThreads);
    __syncthreads();
    const int lane = threadIdx.x % kLanes;
    const int64_t col =
        (int64_t)blockIdx.x * kScreenCols + threadIdx.x / kLanes;
    // a dead column (the ragged edge of the last block) holds the
    // identity: its lanes take part in the shuffles and write nothing
    const bool live = col < n_cols;
    const int k = live ? ks[col] : 1;
    const int kc = lfq_clip_k(k);
    float st[LFQ_NCELL];
    lfq_init(st);
    // s is a multiple of 16 and the row base 16-byte aligned (checked by
    // the wrapper), so lane `lane` has a whole vector when 16 lane < s
    if (live && 16 * lane < s) {
        const uint4 w =
            __ldg(reinterpret_cast<const uint4 *>(codes + col * s) + lane);
        const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
            for (int b = 0; b < 4; ++b)
                lfq_step(st, table[(words[i] >> (8 * b)) & 0xffu], kc);
        }
    }
    lfq_clip_cells(st, kc);
    // a column's 8 lanes are 8 aligned lanes of one warp, so lane + h
    // (h < 8) of a lane that takes is its own column's
#pragma unroll
    for (int h = 1; h < kLanes; h *= 2) {
        float other[LFQ_NCELL];
#pragma unroll
        for (int c = 0; c < LFQ_NCELL; ++c)
            other[c] = __shfl_down_sync(0xffffffffu, st[c], h);
        if (lfq_screen_tree_role(lane, h) > 0)
            lfq_screen_merge(st, other, kc);
    }
    if (live && lane == 0) {
        const float t = lfq_log_tail(st, kc);
        log_tail[col] = t;
        mask[col] = lfq_is_candidate(t, log_thresh[col], k);
    }
}

constexpr int kTailCols = 128;          // columns (threads) per block
constexpr int kChunk = 32;              // reads per tile
constexpr int kPieces = kChunk / 4;     // 16-byte pieces of a tile row
constexpr int kTailStages = 3;

__device__ __forceinline__ void copy16_async(void *smem, const void *gmem) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(gmem)
                 : "memory");
}

__device__ __forceinline__ void copy4_async(void *smem, const void *gmem) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(gmem)
                 : "memory");
}

// The block's probs tiles for tail_probs_kernel: tile t holds reads
// 32t .. 32t + 31 of the block's columns, in slot t % kTailStages of
// the ring, piece q of column c at [c][q ^ (c & 7)].  Every thread asks
// for the same tiles in the same order (one D per launch), so each tile
// starts with a block barrier.
struct ProbTiles {
    const float *probs;   // the block's first column
    float4 (*ring)[kTailCols][kPieces];
    int64_t ld, depth;
    int ncols;            // real columns of the block

    __device__ void issue(int t) {
        const int64_t d0 = (int64_t)t * kChunk;
        if (d0 < depth) {
#pragma unroll
            for (int i = 0; i < kPieces; ++i) {
                const int f = i * kTailCols + threadIdx.x;
                const int c = f / kPieces, q = f % kPieces;
                const int64_t d = d0 + 4 * q;
                if (c < ncols && d < depth) {
                    const float *src = probs + c * ld + d;
                    float4 *dst = &ring[t % kTailStages][c][q ^ (c & 7)];
                    if (d + 4 <= depth && ((uintptr_t)src & 15) == 0) {
                        copy16_async(dst, src);
                    } else {
                        for (int e = 0; e < 4 && d + e < depth; ++e)
                            copy4_async(reinterpret_cast<float *>(dst) + e,
                                        src + e);
                    }
                }
            }
        }
        asm volatile("cp.async.commit_group;\n" ::: "memory");
    }

    // tile t landed for every thread; the slot of tile t - 1 refilled
    __device__ const float4 *wait(int t) {
        asm volatile("cp.async.wait_group %0;\n" ::"n"(kTailStages - 2)
                     : "memory");
        __syncthreads();
        issue(t + kTailStages - 1);
        return ring[t % kTailStages][threadIdx.x];
    }
};

__global__ void __launch_bounds__(kTailCols)
tail_probs_kernel(const float *__restrict__ probs, int64_t ld,
                  const int32_t *__restrict__ kc_in,
                  float *__restrict__ log_tail, int64_t n_cols,
                  int64_t depth) {
    __shared__ float4 ring[kTailStages][kTailCols][kPieces];  // 48 KB
    const int64_t c0 = (int64_t)blockIdx.x * kTailCols;
    const int ncols =
        (int)(n_cols - c0 < kTailCols ? n_cols - c0 : kTailCols);
    ProbTiles tiles{probs + c0 * ld, ring, ld, depth, ncols};
    // a dead thread (the ragged edge of the last block) takes part in the
    // copies and barriers and steps nothing
    const bool live = (int)threadIdx.x < ncols;
    const int swz = threadIdx.x & 7;
    float st[LFQ_NCELL];
    lfq_rel_init(st, lfq_clip_k(live ? kc_in[c0 + threadIdx.x] : 1));
#pragma unroll
    for (int t = 0; t < kTailStages - 1; ++t) tiles.issue(t);
    const int n_tiles = (int)((depth + kChunk - 1) / kChunk);
    for (int t = 0; t < n_tiles; ++t) {
        const float4 *row = tiles.wait(t);
        if (!live) continue;
        const int64_t left = depth - (int64_t)t * kChunk;
        if (left >= kChunk) {
#pragma unroll
            for (int v = 0; v < kPieces; ++v) {
                const float4 w = row[v ^ swz];
                lfq_rel_step(st, lfq_pad_clip(w.x));
                lfq_rel_step(st, lfq_pad_clip(w.y));
                lfq_rel_step(st, lfq_pad_clip(w.z));
                lfq_rel_step(st, lfq_pad_clip(w.w));
            }
        } else {  // the last tile of a D that is not a multiple of 32
            const float *f = reinterpret_cast<const float *>(row);
            for (int j = 0; j < (int)left; ++j)
                lfq_rel_step(st, lfq_pad_clip(f[4 * ((j >> 2) ^ swz) + (j & 3)]));
        }
    }
    if (live) log_tail[c0 + threadIdx.x] = lfq_rel_log_tail(st);
}

}  // namespace

extern "C" {

// probs f32 [n_cols, depth] with row stride ld >= depth (floats) and unit
// stride along depth, kc i32 [n_cols] -> log_tail f32 [n_cols], all on
// `device`.  Returns cudaGetLastError() after the launch (0 = launched).
int lfq_tail_probs_launch(const void *probs, long long ld, const void *kc,
                          void *log_tail, long long n_cols, long long depth,
                          int device, void *stream) {
    if (n_cols <= 0) return (int)cudaSuccess;
    const cudaError_t set = cudaSetDevice(device);
    if (set != cudaSuccess) return (int)set;
    const long long blocks = (n_cols + kTailCols - 1) / kTailCols;
    tail_probs_kernel<<<(unsigned)blocks, kTailCols, 0,
                        (cudaStream_t)stream>>>(
        (const float *)probs, (int64_t)ld, (const int32_t *)kc,
        (float *)log_tail, (int64_t)n_cols, (int64_t)depth);
    return (int)cudaGetLastError();
}

// codes u8 [n_cols, s] row-major, ks i32 [n_cols], log_thresh f32
// [n_cols] -> log_tail f32 [n_cols], mask u8 (0/1) [n_cols], all on
// `device`.  Returns cudaGetLastError() after the launch (0 = launched).
int lfq_screen_codes_launch(const void *codes, const void *ks,
                            const void *log_thresh, void *log_tail,
                            void *mask, long long n_cols, int s,
                            int device, void *stream) {
    if (n_cols <= 0) return (int)cudaSuccess;
    // this library's runtime keeps its own current device per thread
    const cudaError_t set = cudaSetDevice(device);
    if (set != cudaSuccess) return (int)set;
    const long long blocks = (n_cols + kScreenCols - 1) / kScreenCols;
    screen_codes_kernel<<<(unsigned)blocks, kScreenThreads, 0,
                          (cudaStream_t)stream>>>(
        (const uint8_t *)codes, (const int32_t *)ks,
        (const float *)log_thresh, (float *)log_tail, (uint8_t *)mask,
        (int64_t)n_cols, s);
    return (int)cudaGetLastError();
}

const char *lfq_cuda_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
