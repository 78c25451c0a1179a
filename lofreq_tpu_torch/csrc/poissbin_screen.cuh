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
// Split columns (lfq_screen_column_split and screen_codes_kernel): a row
// of at most LFQ_SCREEN_SMAX codes is cut into T slices of
// LFQ_SCREEN_SMAX / T codes (a slice past the row's end is empty and
// holds the identity).  Each slice is stepped into its own kc-clipped
// partial from the identity, decoding through a 256-entry table of the
// same lfq_decode, and the partials are merged in a fixed tree: slice s
// takes slice s + h for h = 1, 2, 4, ... when s is a multiple of 2h
// (lfq_screen_tree_role), so a result repeats bit for bit.  The merge is
// the kc-clipped truncated convolution (lfq_screen_merge): cells below
// kc as sum_{j+k=m} a_j b_k, the tail cell as a_kc sum(b) + sum_{j<kc}
// a_j P_b(>= kc - j), cells above kc 0.  Every term is a product of
// non-negative cells added to a non-negative sum, never 1 - sum, so the
// merge only reorders rounding against the serial DP.  T = 1 is the
// serial column (lfq_screen_column) bit for bit.
//
// This header is __host__ __device__ under nvcc and plain C++ under g++,
// so the tests compile the same arithmetic on the CPU.  The 17 cells are
// a fixed-size array indexed only by compile-time constants (every loop
// over cells is fully unrolled and kc is applied by per-cell factors and
// selects), so after inlining they live in registers and never spill to
// local memory.

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
#define LFQ_NCODE 256        // entries of the decode table: every u8 code
#define LFQ_SCREEN_SMAX 128  // the widest code row
#define LFQ_SCREEN_TMAX 8    // the most slices of a split column

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

// One read with error prob p at tail cell kc.  Cell c takes
// s[c] f + s[c-1] p, from the top cell down so that each cell still sees
// the previous step's value of the cell below it, with f = q = 1 - p below
// kc and f = fmaxf(q, 1) = 1 at kc: s * 1 is s exactly, so every cell at
// or below kc gets the plain version's value bit for bit (s q + s' p
// below kc, s + s' p at kc).  The cells above kc are not kept at 0: a cell
// reads only itself and the cell below, so they never reach a cell at or
// below kc, and lfq_clip_cells zeroes them where a whole partial is read.
// Per cell that is a max, two multiplies and an add, with no compare or
// select on a cell's value: the max's 1 or 0 depends on kc alone.
LFQ_HD void lfq_step(float (&s)[LFQ_NCELL], float p, int kc) {
    const float q = 1.0f - p;
    LFQ_UNROLL
    for (int c = LFQ_KMAX; c >= 1; --c)
        s[c] = s[c] * fmaxf(q, c == kc ? 1.0f : 0.0f) + s[c - 1] * p;
    s[0] = s[0] * q;
}

// Zero the cells above kc that lfq_step leaves: the kc-clipped partial.
LFQ_HD void lfq_clip_cells(float (&s)[LFQ_NCELL], int kc) {
    LFQ_UNROLL
    for (int c = 1; c < LFQ_NCELL; ++c) s[c] = c > kc ? 0.0f : s[c];
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

// The same DP in kc-relative cell order (tail_probs_kernel): cell r holds
// what lfq_step keeps in cell kc - r, so the tail is cell 0 whatever kc
// is, and a step does the same operations on every cell, with no factor
// or select: cell 0 takes s_0 + s_1 p, cell r >= 1 takes s_r q + s_(r+1) p
// (the last cell s_16 q).  Cell kc is lfq_step's cell 0, s_0 q; the cells
// past it start at 0 and stay 0, so cell kc's added s_(kc+1) p is +0, an
// exact no-op.  Every cell at or below kc in lfq_step's order takes the
// same operations on the same values, in the same order: the same bits.
LFQ_HD void lfq_rel_init(float (&s)[LFQ_NCELL], int kc) {
    LFQ_UNROLL
    for (int r = 0; r < LFQ_NCELL; ++r) s[r] = r == kc ? 1.0f : 0.0f;
}

LFQ_HD void lfq_rel_step(float (&s)[LFQ_NCELL], float p) {
    const float q = 1.0f - p;
    s[0] = s[0] + s[1] * p;
    LFQ_UNROLL
    for (int r = 1; r < LFQ_KMAX; ++r) s[r] = s[r] * q + s[r + 1] * p;
    s[LFQ_KMAX] = s[LFQ_KMAX] * q;
}

LFQ_HD float lfq_rel_log_tail(const float (&s)[LFQ_NCELL]) {
    return logf(fmaxf(s[0], LFQ_TAIL_FLOOR));
}

// Whole column of f32 probabilities, `stride` floats apart (the
// host-compiled form of tail_probs_kernel, which runs the same steps in
// the same order, that the tests and chip_smoke.py use).
LFQ_HD float lfq_tail_column(const float *p, long long stride, long long d,
                             int kc_in) {
    float st[LFQ_NCELL];
    lfq_rel_init(st, lfq_clip_k(kc_in));
    for (long long j = 0; j < d; ++j) lfq_rel_step(st, lfq_pad_clip(p[j * stride]));
    return lfq_rel_log_tail(st);
}

// Whole column from a byte row, serially (the host-compiled form the
// tests hold the split form to; the CUDA kernel runs the split form).
LFQ_HD uint8_t lfq_screen_column(const uint8_t *row, int s, int k,
                                 float log_thresh, float *log_tail) {
    float st[LFQ_NCELL];
    lfq_init(st);
    const int kc = lfq_clip_k(k);
    for (int j = 0; j < s; ++j) lfq_step(st, lfq_decode(row[j]), kc);
    *log_tail = lfq_log_tail(st, kc);
    return lfq_is_candidate(*log_tail, log_thresh, k);
}

// Entries lo, lo + step, ... of the decode table: entry c is
// lfq_decode(c), the same exp2f of the same argument, so a lookup gives
// the direct decode's bits (a block fills it together).
LFQ_HD void lfq_fill_decode_table(float *t, int lo, int step) {
    for (int c = lo; c < LFQ_NCODE; c += step) t[c] = lfq_decode((unsigned)c);
}

// Level h (1, 2, 4, ... < T) of the merge tree: slice s takes slice
// s + h's partial when s is a multiple of 2h (1), hands its own over when
// s is h past one (-1), and has handed it over already otherwise (0).
LFQ_HD int lfq_screen_tree_role(int s, int h) {
    const int r = s % (2 * h);
    return r == 0 ? 1 : (r == h ? -1 : 0);
}

// b's codes joined to a's at tail cell kc: both partials are kc-clipped
// (cells below kc hold P(X = j), cell kc the tail, cells above kc 0).
LFQ_HD void lfq_screen_merge(float (&a)[LFQ_NCELL],
                             const float (&b)[LFQ_NCELL], int kc) {
    // g[t] = b_kc + b_(kc-1) + ... + b_t = P_b(>= t) for t <= kc (the
    // cells above kc are 0, so adding them is exact); g[0] = sum(b)
    float g[LFQ_NCELL];
    g[LFQ_KMAX] = b[LFQ_KMAX];
    LFQ_UNROLL
    for (int t = LFQ_KMAX - 1; t >= 0; --t) g[t] = g[t + 1] + b[t];
    float r[LFQ_NCELL];
    r[0] = a[0] * b[0];  // kc >= 1
    LFQ_UNROLL
    for (int m = 1; m < LFQ_NCELL; ++m) {
        float conv = 0.0f;  // cell m below kc (m < KMAX, as kc <= KMAX)
        if (m < LFQ_KMAX) {
            conv = a[0] * b[m];
            LFQ_UNROLL
            for (int j = 1; j <= m; ++j) conv = conv + a[j] * b[m - j];
        }
        float tail = a[m] * g[0];  // cell m as the tail cell
        LFQ_UNROLL
        for (int j = 0; j < m; ++j) tail = tail + a[j] * g[m - j];
        r[m] = m < kc ? conv : (m == kc ? tail : 0.0f);
    }
    LFQ_UNROLL
    for (int c = 0; c < LFQ_NCELL; ++c) a[c] = r[c];
}

// The column of lfq_screen_column, s <= LFQ_SCREEN_SMAX codes, split into
// T slices (a power of two up to LFQ_SCREEN_TMAX) and merged in the
// kernel's tree (the host-compiled form the tests use; screen_codes_kernel
// runs T = LFQ_SCREEN_TMAX, one slice per lane).
LFQ_HD uint8_t lfq_screen_column_split(const uint8_t *row, int s, int k,
                                       float log_thresh, int T,
                                       float *log_tail) {
    float table[LFQ_NCODE];
    lfq_fill_decode_table(table, 0, 1);
    const int kc = lfq_clip_k(k);
    const int chunk = LFQ_SCREEN_SMAX / T;
    float part[LFQ_SCREEN_TMAX][LFQ_NCELL];
    for (int l = 0; l < T; ++l) {
        lfq_init(part[l]);
        const int hi = (l + 1) * chunk < s ? (l + 1) * chunk : s;
        for (int j = l * chunk; j < hi; ++j)
            lfq_step(part[l], table[row[j]], kc);
        lfq_clip_cells(part[l], kc);
    }
    for (int h = 1; h < T; h *= 2)
        for (int l = 0; l + h < T; ++l)
            if (lfq_screen_tree_role(l, h) > 0)
                lfq_screen_merge(part[l], part[l + h], kc);
    *log_tail = lfq_log_tail(part[0], kc);
    return lfq_is_candidate(*log_tail, log_thresh, k);
}
