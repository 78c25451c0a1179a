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

struct LfqFusedConf {
    int min_bq, min_alt_bq;
    int use_baq, use_mq, use_sq;  // 0: the field's error prob is 0
};

struct LfqFusedCol {
    float s[LFQ_FC_NCELL];
    int32_t acnt[4], araw[4];  // kept-alt and raw-alt counts per ACGT id
    int32_t depth;             // kept reads
};

LFQ_FC_HD void lfq_fc_init(LfqFusedCol &c) {
    c.s[0] = 1.0f;
    LFQ_FC_UNROLL
    for (int j = 1; j < LFQ_FC_NCELL; ++j) c.s[j] = 0.0f;
    LFQ_FC_UNROLL
    for (int b = 0; b < 4; ++b) c.acnt[b] = c.araw[b] = 0;
    c.depth = 0;
}

// exp(q * -ln10/10) for a used field, 0 for a missing (q < 0) or unused one
LFQ_FC_HD float lfq_fc_q2p(int q, int use) {
    return (!use || q < 0) ? 0.0f : expf((float)q * LFQ_FC_NEG_LN10_10);
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
LFQ_FC_HD void lfq_fc_base(LfqFusedCol &c, int32_t word, int ref,
                           const LfqFusedConf &k) {
    const int bq = word & 0x7F;
    const int baq = ((word >> 7) & 0x7F) - 1;
    const int mq = ((word >> 14) & 0x7F) - 1;
    const int sq = ((word >> 21) & 0x7F) - 1;
    const int nt4 = (word >> 28) & 0x7;
    const bool not_n = bq != LFQ_FC_INVALID_BQ && nt4 != 4;
    const bool is_alt = not_n && nt4 != ref;
    const bool keep = not_n && bq >= k.min_bq &&
                      (!is_alt || bq >= k.min_alt_bq);
    LFQ_FC_UNROLL
    for (int b = 0; b < 4; ++b) {
        const bool is_b = nt4 == b;
        c.araw[b] += (is_alt && is_b) ? 1 : 0;
        c.acnt[b] += (keep && is_alt && is_b) ? 1 : 0;
    }
    if (!keep) return;  // p = 0: the identity step
    c.depth += 1;
    const float sp = lfq_fc_q2p(sq, k.use_sq);
    float mp = lfq_fc_q2p(mq, k.use_mq);
    if (k.use_mq && mq == 0) mp = LFQ_FC_MQ0_ERRPROB;
    const float bap = lfq_fc_q2p(baq, k.use_baq);
    const float bp = lfq_fc_q2p(bq, 1);
    const float merged = mp + (1.0f - mp) * sp + (1.0f - mp) * (1.0f - sp) * bap
                         + (1.0f - mp) * (1.0f - sp) * (1.0f - bap) * bp;
    lfq_fc_step(c.s, fminf(fmaxf(merged, 0.0f), 1.0f));
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

// Whole column, its words `stride` apart (the host-compiled form the
// tests use; the kernel streams the words itself).
LFQ_FC_HD void lfq_fc_column(const int32_t *words, long long stride,
                             long long d, int ref, const LfqFusedConf &k,
                             float *tail, int32_t *depth, int32_t *acnt,
                             int32_t *araw) {
    LfqFusedCol c;
    lfq_fc_init(c);
    for (long long i = 0; i < d; ++i) lfq_fc_base(c, words[i * stride], ref, k);
    lfq_fc_finish(c, ref, tail, depth, acnt, araw);
}
