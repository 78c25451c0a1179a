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
// arithmetic is at most about 75 f32 operations per read (up to four
// decodes of one multiply and one exp, the 11-operation merge, 52 in the
// DP step), 9.9 GFLOP, 0.148 ms at 67 TFLOP/s.  So the bytes bound it, but
// only just: a straightforward kernel will sit near the arithmetic line,
// with the four expf (no fast math) the costliest part of a read.
//
// Design: Pallas ran a (column tile, depth chunk) grid with the DP state
// in VMEM carried across the sequential depth chunks.  Hopper runs blocks
// in no order, so one thread takes one column and loops over all D reads;
// the 18 cells, the 9 counters and the depth stay in registers for the
// whole column.  pack_columns_np lays the stream out as [D, B], so on
// every row the threads of a warp read 32 neighbouring words (128 bytes)
// with no transpose.  65,536 columns are 15.5 warps per SM, so the row
// loop is unrolled by 4 to keep several rows' loads in flight.  The kernel
// masks the ragged edge itself: B and D need not be multiples of anything.
// No shared memory, no allocation, no synchronisation; it launches on the
// caller's stream and writes [B] tail, [B] depth and [B, 4] counts.  The
// library builds with -fmad=false (_kernel_build.py), so each multiply and
// add rounds on its own, as in the plain PyTorch version and the CPU shim.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fused_call.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
fused_call_kernel(const int32_t *__restrict__ packed_t,
                  const int32_t *__restrict__ ref_nt4,
                  float *__restrict__ tail, int32_t *__restrict__ depth,
                  int32_t *__restrict__ acnt, int32_t *__restrict__ araw,
                  int64_t n_cols, int64_t n_rows, LfqFusedConf conf) {
    const int64_t col = (int64_t)blockIdx.x * kThreads + threadIdx.x;
    if (col >= n_cols) return;  // ragged edge of the last block
    const int ref = ref_nt4[col];
    LfqFusedCol c;
    lfq_fc_init(c);
    const int32_t *w = packed_t + col;
#pragma unroll 4
    for (int64_t d = 0; d < n_rows; ++d) {
        lfq_fc_base(c, __ldg(w + d * n_cols), ref, conf);
    }
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
    const long long blocks = (n_cols + kThreads - 1) / kThreads;
    fused_call_kernel<<<(unsigned)blocks, kThreads, 0,
                        (cudaStream_t)stream>>>(
        (const int32_t *)packed_t, (const int32_t *)ref_nt4, (float *)tail,
        (int32_t *)depth, (int32_t *)acnt, (int32_t *)araw,
        (int64_t)n_cols, (int64_t)n_rows, conf);
    return (int)cudaGetLastError();
}

}  // extern "C"
