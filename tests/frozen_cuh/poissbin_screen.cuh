// Per-column body of the Poisson-binomial screen (kernel K1).
//
// Replaces lofreq_tpu/ops/pallas_poissbin.py:_build.kernel together with
// the u8 decode and the threshold compare of
// lofreq_tpu/ops/screen.py:_build_screen_fn.screen_body.
//
// For one pileup column it computes the clipped-K Poisson-binomial tail
// P(X >= kc), kc = min(k, KMAX), of X = sum of Bernoulli(p_i) over the
// column's top-S u8 error-prob codes, in linear f32 space: cells below kc
// hold P(X = j), cell kc accumulates the tail.  A code c decodes to
// 2^(-c/8); 255 decodes to 0, an exact identity step.  The column is a
// candidate when log(max(tail, 1e-37)) < log_thresh or when k > KMAX.
//
// This header is __host__ __device__ under nvcc and plain C++ under g++,
// so the tests compile the same arithmetic on the CPU.  The 17 cells are
// a fixed-size array indexed only by compile-time constants (every loop
// over cells is fully unrolled and kc is applied by selects), so after
// inlining they live in registers and never spill to local memory.

#pragma once

#include <math.h>
#include <stdint.h>

#ifdef __CUDACC__
#define LFQ_HD __host__ __device__ __forceinline__
#define LFQ_UNROLL _Pragma("unroll")
#else
#define LFQ_HD static inline
#define LFQ_UNROLL _Pragma("GCC unroll 17")
#endif

#define LFQ_KMAX 16
#define LFQ_NCELL (LFQ_KMAX + 1)
#define LFQ_CODE_PAD 255
#define LFQ_TAIL_FLOOR 1e-37f

LFQ_HD float lfq_decode(unsigned code) {
    // -c/8 is exact in f32; exp2f without fast-math keeps denormals and
    // stays within 2 ulp of the f64 table the host quantizer rounds to
    return code == LFQ_CODE_PAD ? 0.0f : exp2f(-(float)code * 0.125f);
}

// An f32 probability of the column step: p > 1.5 is pad (the identity,
// p = 0), other values are clipped to [0, 1] (pallas_poissbin.py:58-59).
LFQ_HD float lfq_pad_clip(float p) {
    return p > 1.5f ? 0.0f : fminf(fmaxf(p, 0.0f), 1.0f);
}

LFQ_HD int lfq_clip_k(int k) {
    return k < 1 ? 1 : (k > LFQ_KMAX ? LFQ_KMAX : k);
}

LFQ_HD void lfq_init(float (&s)[LFQ_NCELL]) {
    s[0] = 1.0f;
    LFQ_UNROLL
    for (int c = 1; c < LFQ_NCELL; ++c) s[c] = 0.0f;
}

// One read with error prob p.  Updated from the top cell down, so each
// cell still sees the previous step's value of the cell below it.
LFQ_HD void lfq_step(float (&s)[LFQ_NCELL], float p, int kc) {
    const float q = 1.0f - p;
    LFQ_UNROLL
    for (int c = LFQ_KMAX; c >= 1; --c) {
        const float adv = s[c - 1] * p;
        const float next = (c == kc) ? s[c] + adv : s[c] * q + adv;
        s[c] = (c <= kc) ? next : 0.0f;
    }
    s[0] = s[0] * q;
}

LFQ_HD float lfq_log_tail(const float (&s)[LFQ_NCELL], int kc) {
    float t = 0.0f;
    LFQ_UNROLL
    for (int c = 1; c < LFQ_NCELL; ++c) t = (c == kc) ? s[c] : t;
    return logf(fmaxf(t, LFQ_TAIL_FLOOR));
}

LFQ_HD uint8_t lfq_is_candidate(float log_tail, float log_thresh, int k) {
    return (log_tail < log_thresh) || (k > LFQ_KMAX);
}

// Whole column of f32 probabilities, `stride` floats apart (the
// host-compiled form of tail_probs_kernel that the tests use).
LFQ_HD float lfq_tail_column(const float *p, long long stride, long long d,
                             int kc_in) {
    float st[LFQ_NCELL];
    lfq_init(st);
    const int kc = lfq_clip_k(kc_in);
    for (long long j = 0; j < d; ++j) lfq_step(st, lfq_pad_clip(p[j * stride]), kc);
    return lfq_log_tail(st, kc);
}

// Whole column from a byte row (the host-compiled form the tests use; the
// CUDA kernel feeds lfq_step from 16-byte vector loads instead).
LFQ_HD uint8_t lfq_screen_column(const uint8_t *row, int s, int k,
                                 float log_thresh, float *log_tail) {
    float st[LFQ_NCELL];
    lfq_init(st);
    const int kc = lfq_clip_k(k);
    for (int j = 0; j < s; ++j) lfq_step(st, lfq_decode(row[j]), kc);
    *log_tail = lfq_log_tail(st, kc);
    return lfq_is_candidate(*log_tail, log_thresh, k);
}
