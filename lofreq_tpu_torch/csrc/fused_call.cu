// Kernel K2 for Hopper (sm_90a): the fused column call.
//
// Replaces lofreq_tpu/ops/pallas_fused_call.py:_build_kernel.kernel: in one
// pass over the packed int32 column stream, the quality merge, the base
// filters, the per-ACGT kept-alt and raw-alt counts, the depth, and the
// Poisson-binomial tail DP with its full 17-cell distribution plus an
// overflow cell.  The arithmetic is fused_call.cuh.
//
// What bounds it: at the deployment shape (B = 65,536 columns x D = 2,016
// reads, tools/device_step_bench.py) the packed stream is 528.5 MB, read
// once, plus 0.26 MB of reference ids in and 2.6 MB of outputs (tail,
// depth, 4 + 4 counts per column), so 0.159 ms at 3.35 TB/s.  The
// arithmetic is at most about 75 f32 operations per read (the
// 11-operation merge, 52 in the DP step, the decodes and the clip), 9.9
// GFLOP, 0.148 ms at 67 TFLOP/s.  One thread per column looping over all
// D reads (the first design) took 8.5x the byte bound: 65,536 columns
// are 15.5 warps per SM, too few row loads in flight to reach the
// memory's rate, and a read cost about 120 instructions with four
// accurate expf.
//
// Design: Pallas ran a (column tile, depth chunk) grid with the DP state
// in VMEM carried across the sequential depth chunks.  Hopper runs blocks
// in no order, so a block takes 32 columns and splits their depth over 8
// slices: thread (slice s, lane c) steps column c's reads of slice s
// (fused_call.cuh lfq_fc_slice) into its own 18 cells, 8 counters and
// depth, in registers.  pack_columns_np lays the stream out as [D, B], so
// each warp is one slice and reads 32 neighbouring words (128 bytes) per
// row, and the card holds 8x the warps, and the loads in flight, of one
// thread per column.  Each block first fills shared decode tables, one
// of 128 entries per field, with expf(q * -ln10/10) and the field's
// missing, unused and MQ0 rules, so a decode is one lookup; the per-ACGT
// counts run as 8-bit fields of one word, flushed every 255 reads; and
// with the SQ unused its merge terms, exact identities, are not computed
// (fused_call.cuh gives the times each of these saves).  A kept read
// still costs the 52 operations of the DP step, which -fmad=false leaves
// unfused, so by count the kernel is bound by instruction issue, not by
// its bytes; no profiler reading of its stalls was taken.
//
// The 8 partials merge in shared memory in a fixed tree (lfq_fc_merge,
// the levels of lfq_fc_tree_role: slice s takes slice s + h, h = 1, 2,
// 4), with no atomics, so a launch repeats bit for bit; slice 0 applies
// kc and the log and writes the column.  The kernel masks the ragged
// edge itself: B and D need not be multiples of anything.  No
// allocation; it launches on the caller's stream and writes [B] tail,
// [B] depth and [B, 4] counts.  The library builds with -fmad=false
// (_kernel_build.py), so each multiply and add rounds on its own, as in
// the plain PyTorch version and the CPU shim.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fused_call.cuh"

namespace {

constexpr int kCols = 32;                 // columns per block: a warp's row
constexpr int kSlices = LFQ_FC_TMAX;      // depth slices per column
constexpr int kThreads = kCols * kSlices;

// 3 blocks of 256 threads per SM: up to 85 registers a thread
__global__ void __launch_bounds__(kThreads, 3)
fused_call_kernel(const int32_t *__restrict__ packed_t,
                  const int32_t *__restrict__ ref_nt4,
                  float *__restrict__ tail, int32_t *__restrict__ depth,
                  int32_t *__restrict__ acnt, int32_t *__restrict__ araw,
                  int64_t n_cols, int64_t n_rows, LfqFusedConf conf) {
    __shared__ LfqFcTables tabs;
    // the partials a tree level hands over: slot m of level h holds slice
    // 2hm + h's (116 bytes, an odd number of words: no bank conflicts)
    __shared__ LfqFusedCol slot[kSlices / 2][kCols];
    const int lane = threadIdx.x % kCols, slice = threadIdx.x / kCols;
    if (threadIdx.x < LFQ_FC_NQ) lfq_fc_table_entry(tabs, conf, threadIdx.x);
    __syncthreads();
    const int64_t col = (int64_t)blockIdx.x * kCols + lane;
    const bool live = col < n_cols;  // else the ragged edge of the last block
    const int ref = live ? ref_nt4[col] : 4;
    LfqFusedCol c;
    lfq_fc_init(c);
    if (live) {
        long long lo, hi;
        lfq_fc_slice(n_rows, kSlices, slice, &lo, &hi);
        lfq_fc_reads(c, packed_t + col, n_cols, lo, hi, ref, conf, tabs);
    }
#pragma unroll
    for (int h = 1; h < kSlices; h *= 2) {
        const int role = lfq_fc_tree_role(slice, h);
        if (role < 0) slot[slice / (2 * h)][lane] = c;
        __syncthreads();
        if (role > 0) lfq_fc_merge(c, slot[slice / (2 * h)][lane]);
        __syncthreads();
    }
    if (slice == 0 && live)
        lfq_fc_finish(c, ref, tail + col, depth + col, acnt + 4 * col,
                      araw + 4 * col);
}

}  // namespace

extern "C" {

// packed_t i32 [n_rows, n_cols] row-major, ref_nt4 i32 [n_cols] -> tail
// f32 [n_cols], depth i32 [n_cols], acnt and araw i32 [n_cols, 4], all on
// `device`.  Returns cudaGetLastError() after the launch (0 = launched).
int lfq_fused_call_launch(const void *packed_t, const void *ref_nt4,
                          void *tail, void *depth, void *acnt, void *araw,
                          long long n_cols, long long n_rows, int min_bq,
                          int min_alt_bq, int use_baq, int use_mq,
                          int use_sq, int device, void *stream) {
    if (n_cols <= 0) return (int)cudaSuccess;
    const cudaError_t set = cudaSetDevice(device);
    if (set != cudaSuccess) return (int)set;
    const LfqFusedConf conf = {min_bq, min_alt_bq, use_baq, use_mq, use_sq};
    const long long blocks = (n_cols + kCols - 1) / kCols;
    fused_call_kernel<<<(unsigned)blocks, kThreads, 0,
                        (cudaStream_t)stream>>>(
        (const int32_t *)packed_t, (const int32_t *)ref_nt4, (float *)tail,
        (int32_t *)depth, (int32_t *)acnt, (int32_t *)araw,
        (int64_t)n_cols, (int64_t)n_rows, conf);
    return (int)cudaGetLastError();
}

}  // extern "C"
