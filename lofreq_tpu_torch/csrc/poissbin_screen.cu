// Kernel K1 for Hopper (sm_90a): the Poisson-binomial tail DP, with two
// entries.
//
// Replaces lofreq_tpu/ops/pallas_poissbin.py:_build.kernel.  The
// per-column arithmetic is poissbin_screen.cuh.
//
// Entry 1, screen_codes_kernel: the sub-screen over u8 error-prob codes,
// with the decode and compare of
// lofreq_tpu/ops/screen.py:_build_screen_fn.screen_body fused in.
//
// What bounds it: a dispatch is at most 4096 columns x 128 code bytes
// (512 KB), and the main path sends only the prescreen survivors (417
// columns in 4 dispatches on the simulated 50 kb@800x run), so the kernel is
// launch- and latency-bound, not bandwidth-bound.  Each column is a
// serial 128-step recurrence over a 17-cell state.
//
// Design: one thread per column, the 17 cells in registers, the row read
// as 16-byte vector loads.  No shared memory, no allocation, no
// synchronisation; it launches on the caller's stream.  Coalescing the
// row loads through shared memory, or splitting a column's steps over
// several threads to use more SMs at small batch, is later work.
//
// Entry 2, tail_probs_kernel: the same DP over f32 probabilities, the
// counterpart of pallas_poissbin.tail_device, which the device column step
// (lofreq_tpu/ops/device_call.py:146-151) calls.  probs_t is [D, B]
// f32 row-major, any D >= 1, as Pallas reads probs.T: with one thread per
// column a warp reads 128 contiguous bytes per row.  A p > 1.5 is pad and
// acts as the identity; other values are clipped to [0, 1].
//
// What bounds entry 2: at the deployment shape B = 65,536 columns x
// D = 2,016 reads the probs are 528.5 MB, read once, so 0.158 ms at
// 3.35 TB/s; the DP is at most 50 f32 operations per read (3 per cell
// below kc), 6.6 GFLOP, 0.099 ms at 67 TFLOP/s.  It is memory-bound.  65,536
// threads are 15.5 warps per SM, so the row loop is unrolled by 4 to keep
// several rows' loads in flight per warp while the DP of the last row runs.

#include <cuda_runtime.h>
#include <stdint.h>

#include "poissbin_screen.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
screen_codes_kernel(const uint8_t *__restrict__ codes,
                    const int32_t *__restrict__ ks,
                    const float *__restrict__ log_thresh,
                    float *__restrict__ log_tail,
                    uint8_t *__restrict__ mask, int64_t n_cols, int s) {
    const int64_t col = (int64_t)blockIdx.x * kThreads + threadIdx.x;
    if (col >= n_cols) return;  // ragged edge of the last block
    const int k = ks[col];
    const int kc = lfq_clip_k(k);
    float st[LFQ_NCELL];
    lfq_init(st);
    // s is a multiple of 16 and the row base is 16-byte aligned (checked
    // by the wrapper), so the row is s / 16 whole vectors
    const uint4 *row = reinterpret_cast<const uint4 *>(codes + col * s);
    for (int v = 0; v < s / 16; ++v) {
        const uint4 w = __ldg(row + v);
        const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
            for (int b = 0; b < 4; ++b) {
                lfq_step(st, lfq_decode((words[i] >> (8 * b)) & 0xffu), kc);
            }
        }
    }
    const float t = lfq_log_tail(st, kc);
    log_tail[col] = t;
    mask[col] = lfq_is_candidate(t, log_thresh[col], k);
}

__global__ void __launch_bounds__(kThreads)
tail_probs_kernel(const float *__restrict__ probs_t,
                  const int32_t *__restrict__ kc_in,
                  float *__restrict__ log_tail, int64_t n_cols,
                  int64_t depth) {
    const int64_t col = (int64_t)blockIdx.x * kThreads + threadIdx.x;
    if (col >= n_cols) return;  // ragged edge of the last block
    const int kc = lfq_clip_k(kc_in[col]);
    float st[LFQ_NCELL];
    lfq_init(st);
    const float *p = probs_t + col;
#pragma unroll 4
    for (int64_t d = 0; d < depth; ++d) {
        lfq_step(st, lfq_pad_clip(__ldg(p + d * n_cols)), kc);
    }
    log_tail[col] = lfq_log_tail(st, kc);
}

}  // namespace

extern "C" {

// probs_t f32 [depth, n_cols] row-major, kc i32 [n_cols] in [1, 16] ->
// log_tail f32 [n_cols], all on `device`.  Returns cudaGetLastError()
// after the launch (0 = launched).
int lfq_tail_probs_launch(const void *probs_t, const void *kc,
                          void *log_tail, long long n_cols, long long depth,
                          int device, void *stream) {
    if (n_cols <= 0) return (int)cudaSuccess;
    const cudaError_t set = cudaSetDevice(device);
    if (set != cudaSuccess) return (int)set;
    const long long blocks = (n_cols + kThreads - 1) / kThreads;
    tail_probs_kernel<<<(unsigned)blocks, kThreads, 0,
                        (cudaStream_t)stream>>>(
        (const float *)probs_t, (const int32_t *)kc, (float *)log_tail,
        (int64_t)n_cols, (int64_t)depth);
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
    const long long blocks = (n_cols + kThreads - 1) / kThreads;
    screen_codes_kernel<<<(unsigned)blocks, kThreads, 0,
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
