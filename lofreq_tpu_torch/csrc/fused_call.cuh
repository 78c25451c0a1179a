// Per-base and per-column body of the fused column call (kernel K2).
//
// Replaces lofreq_tpu/ops/pallas_fused_call.py:_build_kernel.kernel.
//
// One pileup column is a run of packed int32 words, one per read (the
// layout of pallas_fused_call.py:pack_columns_np):
//     bits  0-6   bq   (0..93; 127 = invalid or missing row)
//     bits  7-13  baq  (stored +1: 0 = missing)
//     bits 14-20  mq   (stored +1, clamped to 125: 0 = missing)
//     bits 21-27  sq   (stored +1, clamped to 125: 0 = missing)
//     bits 28-30  nt4  (0-3 ACGT, 4 N)
// For each word: unpack, decode each quality q to exp(q * -ln10/10)
// (0 for a missing one, 0 for a field the configuration does not use;
// MQ0 -> 0.5), the joint merge PJ = PM + (1-PM)PS + (1-PM)(1-PS)PBAQ +
// (1-PM)(1-PS)(1-PBAQ)PB, the min_bq / min_alt_bq filters, the per-ACGT
// kept-alt and raw-alt counts and the depth, and one step of the
// linear-space Poisson-binomial DP.  The DP keeps the whole distribution
// P(X = j), j = 0..16, plus an overflow cell P(X > 16) that never decays,
// because the tail cell kc (the largest kept-alt count of a non-ref base,
// clipped to [1, 16]) is known only after the column's last read.  At the
// end tail = sum_{kc <= j <= 16} P(X = j) + overflow, and the column's log
// tail is log(max(tail, 1e-37)).  A filtered read is a p = 0 step, the
// exact identity, so it is skipped.
//
// The decode of a field is a lookup in a 128-entry table per field
// (LfqFcTables) that holds expf(q * -ln10/10) of the field's quality q
// (lfq_fc_qp), with the missing, unused and MQ0 rules applied when the
// table is filled: the same expf on the same argument, so its values are
// those of the direct decode.  The per-ACGT counts of the last reads
// (at most 255) are kept as 8-bit fields of one word each and flushed
// into the counters, an exact integer sum.
//
// Split depth (lfq_fc_split_column and the kernel): a column's reads are
// cut into T slices of ceil(D / T) consecutive reads, each stepped into
// its own partial (distribution, counters, depth) from the identity, and
// the partials are merged in a fixed tree, slice s taking slice s + h for
// h = 1, 2, 4, ... and s a multiple of 2h (lfq_fc_tree_role, which the
// kernel and the host form share), so a result repeats bit for bit.
// Counters and depths add exactly.  The distributions convolve
// (lfq_fc_merge): cells 0..16 exactly as sum_{j+k=m} A_j B_k, and the
// overflow cell directly as A_17 sum(B) + sum(A_0..16) B_17 +
// sum_{j+k>=17, j,k<=16} A_j B_k, never as 1 - sum.  Every term is a
// product of non-negative cells added to a non-negative sum, so the merge
// only reorders rounding against the sequential DP; kc and the log are
// applied after the merge.  T = 1 is the sequential body (lfq_fc_column).
//
// This header is __host__ __device__ under nvcc and plain C++ under g++,
// so the tests compile the same arithmetic on the CPU.  The 18 cells and
// the 9 counters are fixed-size arrays indexed only by compile-time
// constants (every loop over them is fully unrolled and the base id is
// applied by selects), so after inlining they live in registers.  Every
// multiply and add is written in the order of the plain PyTorch version
// (ops/fused_call.py:fused_column_torch) and of the Pallas kernel; the
// kernels build with -fmad=false and the CPU shim with -ffp-contract=off,
// so no multiply-add is fused.

#pragma once

#include <math.h>
#include <stdint.h>

#ifdef __CUDACC__
#define LFQ_FC_HD __host__ __device__ __forceinline__
#define LFQ_FC_UNROLL _Pragma("unroll")
#else
#define LFQ_FC_HD static inline
#define LFQ_FC_UNROLL _Pragma("GCC unroll 18")
#endif

#define LFQ_FC_KMAX 16
#define LFQ_FC_NCELL (LFQ_FC_KMAX + 2)  // P(X = 0..16) and P(X > 16)
#define LFQ_FC_INVALID_BQ 127
// -(ln 10) / 10 rounded to f32, as pallas_fused_call.py's
// jnp.float32(-LN10_10)
#define LFQ_FC_NEG_LN10_10 (-0.23025850929940458f)
#define LFQ_FC_MQ0_ERRPROB 0.5f  // defaults.MQ0_ERRPROB
#define LFQ_FC_TAIL_FLOOR 1e-37f
#define LFQ_FC_NQ 128  // entries of a decode table: every 7-bit field
#define LFQ_FC_COUNT_RUN 255  // reads between flushes of the 8-bit counts

#ifdef __CUDA_ARCH__
#define LFQ_FC_LOAD(p) __ldg(p)
#define LFQ_FC_UNROLL_READS _Pragma("unroll 6")
#else
#define LFQ_FC_LOAD(p) (*(p))
#define LFQ_FC_UNROLL_READS
#endif

struct LfqFusedConf {
    int min_bq, min_alt_bq;
    int use_baq, use_mq, use_sq;  // 0: the field's error prob is 0
};

struct LfqFusedCol {
    float s[LFQ_FC_NCELL];
    int32_t acnt[4], araw[4];  // kept-alt and raw-alt counts per ACGT id
    int32_t depth;             // kept reads
    // the last reads' kept-alt and raw-alt counts, 8 bits per ACGT id
    uint32_t kept8, raw8;
};

LFQ_FC_HD void lfq_fc_init(LfqFusedCol &c) {
    c.s[0] = 1.0f;
    LFQ_FC_UNROLL
    for (int j = 1; j < LFQ_FC_NCELL; ++j) c.s[j] = 0.0f;
    LFQ_FC_UNROLL
    for (int b = 0; b < 4; ++b) c.acnt[b] = c.araw[b] = 0;
    c.depth = 0;
    c.kept8 = c.raw8 = 0;
}

// exp(q * -ln10/10), the decode of quality q
LFQ_FC_HD float lfq_fc_qp(int q) {
    return expf((float)q * LFQ_FC_NEG_LN10_10);
}

// The error prob of each packed field value, one table per field: bq
// (stored as is), BAQ, MQ and SQ (stored +1, 0 = missing).  A missing or
// unused field's prob is 0, and MQ0 (stored 1) is MQ0_ERRPROB when the
// MQ is used: the rules of the direct decode, and the same expf.
struct LfqFcTables {
    float bq[LFQ_FC_NQ], baq[LFQ_FC_NQ], mq[LFQ_FC_NQ], sq[LFQ_FC_NQ];
};

LFQ_FC_HD void lfq_fc_table_entry(LfqFcTables &t, const LfqFusedConf &k,
                                  int f) {
    const float e = f > 0 ? lfq_fc_qp(f - 1) : 0.0f;
    t.bq[f] = lfq_fc_qp(f);
    t.baq[f] = k.use_baq ? e : 0.0f;
    t.mq[f] = !k.use_mq ? 0.0f : f == 1 ? LFQ_FC_MQ0_ERRPROB : e;
    t.sq[f] = k.use_sq ? e : 0.0f;
}

LFQ_FC_HD void lfq_fc_fill_tables(LfqFcTables &t, const LfqFusedConf &k) {
    for (int f = 0; f < LFQ_FC_NQ; ++f) lfq_fc_table_entry(t, k, f);
}

// One DP step with error prob p: every cell j >= 1 takes P(j) (1-p) +
// P(j-1) p, the overflow cell takes P(>16) + P(16) p.  From the top cell
// down, so each cell still sees the previous step's cell below it.
LFQ_FC_HD void lfq_fc_step(float (&s)[LFQ_FC_NCELL], float p) {
    const float q = 1.0f - p;
    s[LFQ_FC_NCELL - 1] = s[LFQ_FC_NCELL - 1] + s[LFQ_FC_KMAX] * p;
    LFQ_FC_UNROLL
    for (int j = LFQ_FC_KMAX; j >= 1; --j) s[j] = s[j] * q + s[j - 1] * p;
    s[0] = s[0] * q;
}

// One read of the column: its packed word and the column's reference id.
// SQ: whether the SQ is in the merge.  Without it sp = 0, and the terms
// it drops are exact identities (mp + (1-mp) 0 = mp, (1-mp)(1-0) = 1-mp),
// so both forms give the same bits.  An nt4 of 5..7 (the 3-bit field can
// hold it) is a base of no ACGT id and counts under none: its count bit,
// shifted in 64 bits where 1 << 40..56 is defined, falls past bit 31.
template <bool SQ>
LFQ_FC_HD void lfq_fc_base(LfqFusedCol &c, int32_t word, int ref,
                           const LfqFusedConf &k, const LfqFcTables &t) {
    const int bq = word & 0x7F;
    const int nt4 = (word >> 28) & 0x7;
    const bool not_n = bq != LFQ_FC_INVALID_BQ && nt4 != 4;
    const bool is_alt = not_n && nt4 != ref;
    const bool keep = not_n && bq >= k.min_bq &&
                      (!is_alt || bq >= k.min_alt_bq);
    const uint32_t one = is_alt ? (uint32_t)(1ull << (8 * nt4)) : 0u;
    c.raw8 += one;
    c.kept8 += keep ? one : 0u;
    if (!keep) return;  // p = 0: the identity step
    c.depth += 1;
    const float mp = t.mq[(word >> 14) & 0x7F];
    const float bap = t.baq[(word >> 7) & 0x7F];
    const float bp = t.bq[bq];
    float merged;
    if (SQ) {
        const float sp = t.sq[(word >> 21) & 0x7F];
        merged = mp + (1.0f - mp) * sp + (1.0f - mp) * (1.0f - sp) * bap
                 + (1.0f - mp) * (1.0f - sp) * (1.0f - bap) * bp;
    } else {
        merged = mp + (1.0f - mp) * bap + (1.0f - mp) * (1.0f - bap) * bp;
    }
    lfq_fc_step(c.s, fminf(fmaxf(merged, 0.0f), 1.0f));
}

// the 8-bit counts into the counters
LFQ_FC_HD void lfq_fc_flush(LfqFusedCol &c) {
    LFQ_FC_UNROLL
    for (int b = 0; b < 4; ++b) {
        c.acnt[b] += (c.kept8 >> (8 * b)) & 0xff;
        c.araw[b] += (c.raw8 >> (8 * b)) & 0xff;
    }
    c.kept8 = c.raw8 = 0;
}

// Reads [lo, hi) of a column whose words lie `stride` apart, in runs of
// at most COUNT_RUN reads between flushes, so no 8-bit count overflows.
template <bool SQ>
LFQ_FC_HD void lfq_fc_reads(LfqFusedCol &c, const int32_t *words,
                            long long stride, long long lo, long long hi,
                            int ref, const LfqFusedConf &k,
                            const LfqFcTables &t) {
    for (long long r0 = lo; r0 < hi; r0 += LFQ_FC_COUNT_RUN) {
        const long long r1 =
            r0 + LFQ_FC_COUNT_RUN < hi ? r0 + LFQ_FC_COUNT_RUN : hi;
        LFQ_FC_UNROLL_READS
        for (long long i = r0; i < r1; ++i)
            lfq_fc_base<SQ>(c, LFQ_FC_LOAD(words + i * stride), ref, k, t);
        lfq_fc_flush(c);
    }
}

// Two forms of the merge and the 8-bit counts: K2 is bound by instruction
// issue, and each saves a share of it.  On an H100 (700 W) at 65,536
// columns x 2,016 reads with no SQ, K2 took 0.486 ms per launch, 0.576 ms
// with the full merge, and 0.719 ms with the full merge and a counter
// step per ACGT id on every read.
LFQ_FC_HD void lfq_fc_reads(LfqFusedCol &c, const int32_t *words,
                            long long stride, long long lo, long long hi,
                            int ref, const LfqFusedConf &k,
                            const LfqFcTables &t) {
    if (k.use_sq)
        lfq_fc_reads<true>(c, words, stride, lo, hi, ref, k, t);
    else
        lfq_fc_reads<false>(c, words, stride, lo, hi, ref, k, t);
}

// b's reads joined to a's: counters and depths add, the distributions
// convolve, truncated at KMAX with the overflow cell (see the top)
LFQ_FC_HD void lfq_fc_merge(LfqFusedCol &a, const LfqFusedCol &b) {
    float sa = 0.0f, sb = 0.0f;  // sum(A_0..16), sum(B_0..17)
    LFQ_FC_UNROLL
    for (int j = 0; j <= LFQ_FC_KMAX; ++j) sa = sa + a.s[j];
    LFQ_FC_UNROLL
    for (int j = 0; j < LFQ_FC_NCELL; ++j) sb = sb + b.s[j];
    float over = a.s[LFQ_FC_NCELL - 1] * sb + sa * b.s[LFQ_FC_NCELL - 1];
    LFQ_FC_UNROLL
    for (int j = 1; j <= LFQ_FC_KMAX; ++j) {
        LFQ_FC_UNROLL
        for (int k = LFQ_FC_KMAX + 1 - j; k <= LFQ_FC_KMAX; ++k)
            over = over + a.s[j] * b.s[k];
    }
    float r[LFQ_FC_NCELL];
    LFQ_FC_UNROLL
    for (int m = 0; m <= LFQ_FC_KMAX; ++m) {
        r[m] = a.s[0] * b.s[m];
        LFQ_FC_UNROLL
        for (int j = 1; j <= m; ++j) r[m] = r[m] + a.s[j] * b.s[m - j];
    }
    r[LFQ_FC_NCELL - 1] = over;
    LFQ_FC_UNROLL
    for (int j = 0; j < LFQ_FC_NCELL; ++j) a.s[j] = r[j];
    LFQ_FC_UNROLL
    for (int x = 0; x < 4; ++x) {
        a.acnt[x] += b.acnt[x];
        a.araw[x] += b.araw[x];
    }
    a.depth += b.depth;
}

// Level h (1, 2, 4, ... < T) of the merge tree: slice s takes slice
// s + h's partial when s is a multiple of 2h (1), hands its own over when
// s is h past one (-1), and has handed it over already otherwise (0).
LFQ_FC_HD int lfq_fc_tree_role(int s, int h) {
    const int r = s % (2 * h);
    return r == 0 ? 1 : (r == h ? -1 : 0);
}

// Reads [lo, hi) of slice s of T over a depth of d: ceil(d / T) each,
// the last slices short or empty.
LFQ_FC_HD void lfq_fc_slice(long long d, int T, int s, long long *lo,
                            long long *hi) {
    const long long chunk = (d + T - 1) / T;
    const long long a = chunk * s, b = a + chunk;
    *lo = a < d ? a : d;
    *hi = b < d ? b : d;
}

// The column's outputs: log tail, depth, and the kept-alt and raw-alt
// counts of the four ACGT ids.
LFQ_FC_HD void lfq_fc_finish(const LfqFusedCol &c, int ref, float *tail,
                             int32_t *depth, int32_t *acnt, int32_t *araw) {
    int ks = 0;  // the largest kept-alt count of a non-ref ACGT id
    LFQ_FC_UNROLL
    for (int b = 0; b < 4; ++b) {
        const int v = (b != ref) ? c.acnt[b] : 0;
        ks = v > ks ? v : ks;
    }
    const int kc = ks < 1 ? 1 : (ks > LFQ_FC_KMAX ? LFQ_FC_KMAX : ks);
    float t = c.s[LFQ_FC_NCELL - 1];
    LFQ_FC_UNROLL
    for (int j = LFQ_FC_KMAX; j >= 1; --j) t = t + ((j >= kc) ? c.s[j] : 0.0f);
    *tail = logf(fmaxf(t, LFQ_FC_TAIL_FLOOR));
    *depth = c.depth;
    LFQ_FC_UNROLL
    for (int b = 0; b < 4; ++b) {
        acnt[b] = c.acnt[b];
        araw[b] = c.araw[b];
    }
}

// Whole column, its words `stride` apart, read by read (the host-compiled
// forms the tests use; the kernel runs lfq_fc_reads on its slice).
LFQ_FC_HD void lfq_fc_column(const int32_t *words, long long stride,
                             long long d, int ref, const LfqFusedConf &k,
                             const LfqFcTables &t, float *tail,
                             int32_t *depth, int32_t *acnt, int32_t *araw) {
    LfqFusedCol c;
    lfq_fc_init(c);
    lfq_fc_reads(c, words, stride, 0, d, ref, k, t);
    lfq_fc_finish(c, ref, tail, depth, acnt, araw);
}

#define LFQ_FC_TMAX 8

// The same column with its depth split into T slices (T a power of two up
// to LFQ_FC_TMAX) and merged in the kernel's tree.
LFQ_FC_HD void lfq_fc_split_column(const int32_t *words, long long stride,
                                   long long d, int T, int ref,
                                   const LfqFusedConf &k,
                                   const LfqFcTables &t, float *tail,
                                   int32_t *depth, int32_t *acnt,
                                   int32_t *araw) {
    LfqFusedCol part[LFQ_FC_TMAX];
    for (int s = 0; s < T; ++s) {
        lfq_fc_init(part[s]);
        long long lo, hi;
        lfq_fc_slice(d, T, s, &lo, &hi);
        lfq_fc_reads(part[s], words, stride, lo, hi, ref, k, t);
    }
    for (int h = 1; h < T; h *= 2)
        for (int s = 0; s + h < T; ++s)
            if (lfq_fc_tree_role(s, h) > 0) lfq_fc_merge(part[s], part[s + h]);
    lfq_fc_finish(part[0], ref, tail, depth, acnt, araw);
}
