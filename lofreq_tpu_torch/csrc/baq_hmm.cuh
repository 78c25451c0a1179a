// Per-read body of the banded glocal BAQ HMM: the forward pass (kernel K3)
// and the backward pass with the per-row MAP (kernel K4).
//
// Replaces lofreq_tpu/ops/pallas_baq.py:_build.fwd_kernel (K3) and
// _build.bwd_kernel (K4).  The math is lofreq_tpu/ops/baq_jax.py:_build,
// BAQ-only branch (csrc/baq.c:glocal is the exact f64 host version); the
// plain PyTorch version is lofreq_tpu_torch/ops/baq_torch.py:baq_hmm_torch.
//
// Band-relative rows.  The TPU kernels span a 128-lane reference window
// per row and mask the band, though only 2*bw+1 = 15 cells of a row are
// ever non-zero.  Here a row is 16 band lanes: lane u of row i (1-based)
// is window position k = i - bw + u (1-based), and lane 15 is always
// outside the band.  With that indexing
//   fM[i-1][k-1] is lane u of the previous row,
//   fM[i-1][k]   is lane u+1 of the previous row (lfq_shr),
//   newM[i][k-1] is lane u-1 of this row (lfq_shl),
// and the D chain fD[k] = a[k] + m22 fD[k-1] is 4 doubling steps over the
// 16 lanes, the first 4 of pallas_baq's 7 over 128: a outside the band
// feeds only masked cells, so the band-limited chain is exact.
//
// Two types hold one band row, and the per-read bodies are templates
// written once for both:
//  * LfqBand16: 16 floats, one thread's registers once every loop over the
//    lanes is unrolled (each lane index is then a constant).  Its steps
//    are loops that take the half-warp's order of operations: the shifts
//    and the chain read the old row, and the sums and maxima are the same
//    butterfly trees.  K4 runs one read per thread on it; g++ builds the
//    CPU tests' form of both passes on it.
//  * LfqBandLane (nvcc only): one float in each thread of a half-warp (16
//    threads per read, 2 reads per warp); the cross-lane steps are warp
//    shuffles and ballots.  K3 runs on it.
// Both round every multiply and add on its own (the kernels build with
// -fmad=false, the CPU tests with -ffp-contract=off), so K4's q and st
// equal the g++ form's bit for bit, and K3's rows equal its rows.
//
// Held to the plain version, and where a band kernel can go wrong:
//  * st's k is the 0-based WINDOW lane, k = i - bw + u - 1, not the band
//    lane: the runner's diagonal check (st >> 2) == pos - xb + i - 1
//    needs it.  A row whose cells are all 0 gives k = 0, as the full
//    window's argmax does.
//  * MAP ties: the lowest lane wins; is_ins needs I strictly above M;
//    pfail is the row's sum minus the winning cell, not 1 - max/sum.
//  * Row 1 begins from bM = (1 - PAR_D) / l_ref and bI = PAR_D / l_ref
//    on k <= min(l_ref, bw + 1) and is scaled over M + I by division
//    (later rows multiply by 1/s).  Row L of the backward pass begins
//    from sM / s_L / s_{L+1}; bD is zero on row 1.
//  * sM = 1/(2L+2) uses the batch's read length L (the runner's L is the
//    window's mode read length).
//  * Clamps: row scales max(s, 1e-30); log(max(pfail, 1e-38)), which is
//    subnormal in f32, so nothing may flush to zero (no fast math);
//    phred > 100 -> 99.
//  * Any L: the row loops run to L and the window to Lr; nothing is
//    fixed at 128.  Window lanes at or past min(l_ref, Lr) are outside
//    every band.

#pragma once

#include <math.h>
#include <stdint.h>

#define LFQ_BAQ_BW 7
#define LFQ_BAQ_LANES 16
#define LFQ_BAQ_PAR_D 0.00001
#define LFQ_BAQ_PAR_E 0.4
#define LFQ_BAQ_EI 0.25f
#define LFQ_BAQ_EM 0.33333333333f

#ifdef __CUDACC__
#define LFQ_BAQ_HD __host__ __device__ __forceinline__
#define LFQ_BAQ_BODY __device__ __forceinline__
#define LFQ_BAQ_MEMBER static __device__ __forceinline__
#define LFQ_BAQ_METHOD __device__ __forceinline__
#define LFQ_BAQ_UNROLL _Pragma("unroll")
#else
#define LFQ_BAQ_HD static inline
#define LFQ_BAQ_BODY static inline
#define LFQ_BAQ_MEMBER static inline
#define LFQ_BAQ_METHOD inline
#define LFQ_BAQ_UNROLL _Pragma("GCC unroll 16")
#endif

// Transition constants for read length L, computed in f64 and rounded to
// f32 (baq_jax.py:38-44; baq_torch.py:hmm_consts).  w[t] = m22^(2^t) are
// the doubling weights of the D chain.
struct LfqBaqConsts {
    float sM, sI, m00, m01, m02, m10, m11, m20;
    float w[4];
    float bm_num, bi_num;  // 1 - PAR_D and PAR_D, the begin-state mass
};

LFQ_BAQ_HD LfqBaqConsts lfq_baq_consts(int L) {
    const double sM = 1.0 / (2 * L + 2), sI = sM;
    LfqBaqConsts c;
    c.sM = (float)sM;
    c.sI = (float)sI;
    c.m00 = (float)((1 - LFQ_BAQ_PAR_D - LFQ_BAQ_PAR_D) * (1 - sM));
    c.m01 = (float)(LFQ_BAQ_PAR_D * (1 - sM));
    c.m02 = c.m01;
    c.m10 = (float)((1 - LFQ_BAQ_PAR_E) * (1 - sI));
    c.m11 = (float)(LFQ_BAQ_PAR_E * (1 - sI));
    c.m20 = (float)(1 - LFQ_BAQ_PAR_E);
    double w = LFQ_BAQ_PAR_E;
    for (int t = 0; t < 4; ++t) {
        c.w[t] = (float)w;
        w = w * w;
    }
    c.bm_num = (float)(1 - LFQ_BAQ_PAR_D);
    c.bi_num = (float)LFQ_BAQ_PAR_D;
    return c;
}

// Emission of reference code r against read code qc with error prob qp.
LFQ_BAQ_HD float lfq_baq_emit(int r, int qc, float qp) {
    if (r > 3 || qc > 3) return 1.0f;
    return r == qc ? 1.0f - qp : qp * LFQ_BAQ_EM;
}

// Window code at index j: code 4 outside [0, Lr).
LFQ_BAQ_HD int lfq_baq_code(const uint8_t *refw, int Lr, int j) {
    return (j >= 0 && j < Lr) ? refw[j] : 4;
}

// Band lanes of row i: k in [max(1, i - bw), min(lim, i + bw)], lim =
// min(l_ref, Lr).  An empty band gives lo > hi.
LFQ_BAQ_HD int lfq_baq_lo(int i) {
    const int lo = 1 - i + LFQ_BAQ_BW;
    return lo > 0 ? lo : 0;
}

LFQ_BAQ_HD int lfq_baq_hi(int i, int lim) {
    const int hi = lim - i + LFQ_BAQ_BW;
    return hi < 2 * LFQ_BAQ_BW ? hi : 2 * LFQ_BAQ_BW;
}

// MAP phred from the failure mass and the winning cell.
LFQ_BAQ_HD int lfq_baq_phred(float rest, float best) {
    const float pfail = rest / fmaxf(rest + best, 1e-30f);
    const float y = -4.343f * logf(fmaxf(pfail, 1e-38f)) + 0.499f;
    const int q = (int)y;
    return q > 100 ? 99 : q;
}

// ---- one band row as 16 floats: one thread's registers ----

#define LFQ_EACH(u) LFQ_BAQ_UNROLL for (int u = 0; u < LFQ_BAQ_LANES; ++u)

struct LfqBand16 {
    float v[LFQ_BAQ_LANES];

    LFQ_BAQ_MEMBER bool leader() { return true; }

    LFQ_BAQ_MEMBER LfqBand16 splat(float x) {
        LfqBand16 r;
        LFQ_EACH(u) r.v[u] = x;
        return r;
    }

    LFQ_BAQ_MEMBER LfqBand16 load(const float *p) {
        LfqBand16 r;
        LFQ_EACH(u) r.v[u] = p[u];
        return r;
    }

    // emission row: lane u against window index k0 + u (code 4 outside
    // [0, Lr))
    LFQ_BAQ_MEMBER LfqBand16 emit_row(const uint8_t *refw, int Lr, int k0,
                                      int qc, float qp) {
        LfqBand16 r;
        LFQ_EACH(u) r.v[u] = lfq_baq_emit(lfq_baq_code(refw, Lr, k0 + u), qc,
                                          qp);
        return r;
    }

    // The 16 window codes of a row, 4 to a word.  The backward pass walks
    // the rows down, and row i-1's window is row i's one lane lower, so a
    // row loads one code instead of 16.
    struct Window {
        uint32_t w[4];

        LFQ_BAQ_METHOD void init(const uint8_t *refw, int Lr, int k0) {
            LFQ_BAQ_UNROLL
            for (int x = 0; x < 4; ++x) {
                w[x] = 0;
                LFQ_BAQ_UNROLL
                for (int y = 0; y < 4; ++y)
                    w[x] |= (uint32_t)lfq_baq_code(refw, Lr, k0 + 4 * x + y)
                            << (8 * y);
            }
        }
        // the window of k0 = the previous k0 - 1
        LFQ_BAQ_METHOD void down(const uint8_t *refw, int Lr, int k0) {
            w[3] = (w[3] << 8) | (w[2] >> 24);
            w[2] = (w[2] << 8) | (w[1] >> 24);
            w[1] = (w[1] << 8) | (w[0] >> 24);
            w[0] = (w[0] << 8) | (uint32_t)lfq_baq_code(refw, Lr, k0);
        }
        LFQ_BAQ_METHOD LfqBand16 emit(int qc, float qp) const {
            LfqBand16 r;
            LFQ_EACH(u) r.v[u] = lfq_baq_emit(
                (int)((w[u >> 2] >> (8 * (u & 3))) & 0xff), qc, qp);
            return r;
        }
    };
};

LFQ_BAQ_BODY LfqBand16 operator+(const LfqBand16 &a, const LfqBand16 &b) {
    LfqBand16 r;
    LFQ_EACH(u) r.v[u] = a.v[u] + b.v[u];
    return r;
}
LFQ_BAQ_BODY LfqBand16 operator*(const LfqBand16 &a, const LfqBand16 &b) {
    LfqBand16 r;
    LFQ_EACH(u) r.v[u] = a.v[u] * b.v[u];
    return r;
}
LFQ_BAQ_BODY LfqBand16 operator*(float a, const LfqBand16 &b) {
    LfqBand16 r;
    LFQ_EACH(u) r.v[u] = a * b.v[u];
    return r;
}
LFQ_BAQ_BODY LfqBand16 operator*(const LfqBand16 &a, float b) {
    LfqBand16 r;
    LFQ_EACH(u) r.v[u] = a.v[u] * b;
    return r;
}
LFQ_BAQ_BODY LfqBand16 operator/(const LfqBand16 &a, float b) {
    LfqBand16 r;
    LFQ_EACH(u) r.v[u] = a.v[u] / b;
    return r;
}

// a where c, else b, lane by lane
LFQ_BAQ_BODY LfqBand16 lfq_select(bool c, const LfqBand16 &a,
                                  const LfqBand16 &b) {
    LfqBand16 r;
    LFQ_EACH(u) r.v[u] = c ? a.v[u] : b.v[u];
    return r;
}

// a on lanes lo..hi, 0 elsewhere
LFQ_BAQ_BODY LfqBand16 lfq_keep(const LfqBand16 &a, int lo, int hi) {
    LfqBand16 r;
    LFQ_EACH(u) r.v[u] = (u >= lo && u <= hi) ? a.v[u] : 0.0f;
    return r;
}

LFQ_BAQ_BODY LfqBand16 lfq_zero_lane(const LfqBand16 &a, int u0) {
    LfqBand16 r;
    LFQ_EACH(u) r.v[u] = u == u0 ? 0.0f : a.v[u];
    return r;
}

// lane u <- lane u-1, lane 0 <- 0
LFQ_BAQ_BODY LfqBand16 lfq_shl(const LfqBand16 &a) {
    LfqBand16 r;
    LFQ_EACH(u) r.v[u] = u == 0 ? 0.0f : a.v[u - 1];
    return r;
}

// lane u <- lane u+1, lane 15 <- 0
LFQ_BAQ_BODY LfqBand16 lfq_shr(const LfqBand16 &a) {
    LfqBand16 r;
    LFQ_EACH(u) r.v[u] = u == LFQ_BAQ_LANES - 1 ? 0.0f : a.v[u + 1];
    return r;
}

// y[u] = sum_{j<=u} a[j] m22^(u-j) by doubling
LFQ_BAQ_BODY LfqBand16 lfq_chain_fwd(const LfqBand16 &a,
                                     const float (&w)[4]) {
    LfqBand16 y = a;
    LFQ_BAQ_UNROLL
    for (int t = 0; t < 4; ++t) {
        const int sh = 1 << t;
        const LfqBand16 old = y;
        LFQ_EACH(u) if (u >= sh) y.v[u] = old.v[u] + w[t] * old.v[u - sh];
    }
    return y;
}

// y[u] = sum_{j>=u} a[j] m22^(j-u) by doubling
LFQ_BAQ_BODY LfqBand16 lfq_chain_rev(const LfqBand16 &a,
                                     const float (&w)[4]) {
    LfqBand16 y = a;
    LFQ_BAQ_UNROLL
    for (int t = 0; t < 4; ++t) {
        const int sh = 1 << t;
        const LfqBand16 old = y;
        LFQ_EACH(u) if (u + sh < LFQ_BAQ_LANES) {
            y.v[u] = old.v[u] + w[t] * old.v[u + sh];
        }
    }
    return y;
}

// the half-warp's butterfly; lane 0's value
LFQ_BAQ_BODY float lfq_sum(const LfqBand16 &a) {
    LfqBand16 s = a;
    LFQ_BAQ_UNROLL
    for (int off = LFQ_BAQ_LANES / 2; off >= 1; off >>= 1) {
        const LfqBand16 old = s;
        LFQ_EACH(u) s.v[u] = old.v[u] + old.v[u ^ off];
    }
    return s.v[0];
}

LFQ_BAQ_BODY float lfq_max(const LfqBand16 &a) {
    LfqBand16 s = a;
    LFQ_BAQ_UNROLL
    for (int off = LFQ_BAQ_LANES / 2; off >= 1; off >>= 1) {
        const LfqBand16 old = s;
        LFQ_EACH(u) s.v[u] = fmaxf(old.v[u], old.v[u ^ off]);
    }
    return s.v[0];
}

// lowest lane with a >= x, or 16 when none: a scan from the top
LFQ_BAQ_BODY int lfq_first_ge(const LfqBand16 &a, float x) {
    int r = LFQ_BAQ_LANES;
    LFQ_BAQ_UNROLL
    for (int u = LFQ_BAQ_LANES - 1; u >= 0; --u) r = a.v[u] >= x ? u : r;
    return r;
}

LFQ_BAQ_BODY void lfq_store(float *p, const LfqBand16 &a) {
    LFQ_EACH(u) p[u] = a.v[u];
}

#undef LFQ_EACH

#ifdef __CUDACC__
// ---- one band row per half-warp: lane u holds cell u ----
#define LFQ_BAQ_FULL 0xffffffffu

__device__ __forceinline__ int lfq_lane() { return threadIdx.x & 15; }

struct LfqBandLane {
    float v;

    LFQ_BAQ_MEMBER bool leader() { return lfq_lane() == 0; }
    LFQ_BAQ_MEMBER LfqBandLane splat(float x) { return {x}; }

    // emission row: lane u against window index k0 + u (code 4 outside
    // [0, Lr))
    LFQ_BAQ_MEMBER LfqBandLane emit_row(const uint8_t *refw, int Lr, int k0,
                                        int qc, float qp) {
        return {lfq_baq_emit(lfq_baq_code(refw, Lr, k0 + lfq_lane()), qc,
                             qp)};
    }

    // a lane's own window code
    struct Window {
        int code;

        __device__ void init(const uint8_t *refw, int Lr, int k0) {
            code = lfq_baq_code(refw, Lr, k0 + lfq_lane());
        }
        __device__ void down(const uint8_t *refw, int Lr, int k0) {
            init(refw, Lr, k0);
        }
        __device__ LfqBandLane emit(int qc, float qp) const {
            return {lfq_baq_emit(code, qc, qp)};
        }
    };
};

LFQ_BAQ_BODY LfqBandLane lfq_select(bool c, LfqBandLane a, LfqBandLane b) {
    return {c ? a.v : b.v};
}

LFQ_BAQ_BODY LfqBandLane operator+(LfqBandLane a, LfqBandLane b) {
    return {a.v + b.v};
}
LFQ_BAQ_BODY LfqBandLane operator*(LfqBandLane a, LfqBandLane b) {
    return {a.v * b.v};
}
LFQ_BAQ_BODY LfqBandLane operator*(float a, LfqBandLane b) {
    return {a * b.v};
}
LFQ_BAQ_BODY LfqBandLane operator*(LfqBandLane a, float b) {
    return {a.v * b};
}
LFQ_BAQ_BODY LfqBandLane operator/(LfqBandLane a, float b) {
    return {a.v / b};
}

LFQ_BAQ_BODY LfqBandLane lfq_keep(LfqBandLane a, int lo, int hi) {
    const int u = lfq_lane();
    return {(u >= lo && u <= hi) ? a.v : 0.0f};
}

LFQ_BAQ_BODY LfqBandLane lfq_zero_lane(LfqBandLane a, int u0) {
    return {lfq_lane() == u0 ? 0.0f : a.v};
}

LFQ_BAQ_BODY LfqBandLane lfq_shl(LfqBandLane a) {
    const float r = __shfl_up_sync(LFQ_BAQ_FULL, a.v, 1, LFQ_BAQ_LANES);
    return {lfq_lane() == 0 ? 0.0f : r};
}

LFQ_BAQ_BODY LfqBandLane lfq_shr(LfqBandLane a) {
    const float r = __shfl_down_sync(LFQ_BAQ_FULL, a.v, 1, LFQ_BAQ_LANES);
    return {lfq_lane() == LFQ_BAQ_LANES - 1 ? 0.0f : r};
}

LFQ_BAQ_BODY LfqBandLane lfq_chain_fwd(LfqBandLane a, const float (&w)[4]) {
    const int u = lfq_lane();
    float y = a.v;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
        const int sh = 1 << t;
        const float r = __shfl_up_sync(LFQ_BAQ_FULL, y, sh, LFQ_BAQ_LANES);
        if (u >= sh) y = y + w[t] * r;
    }
    return {y};
}

LFQ_BAQ_BODY LfqBandLane lfq_chain_rev(LfqBandLane a, const float (&w)[4]) {
    const int u = lfq_lane();
    float y = a.v;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
        const int sh = 1 << t;
        const float r = __shfl_down_sync(LFQ_BAQ_FULL, y, sh, LFQ_BAQ_LANES);
        if (u + sh < LFQ_BAQ_LANES) y = y + w[t] * r;
    }
    return {y};
}

// butterfly over the 16 lanes; every lane ends with the same value
LFQ_BAQ_BODY float lfq_sum(LfqBandLane a) {
    float s = a.v;
#pragma unroll
    for (int off = LFQ_BAQ_LANES / 2; off >= 1; off >>= 1)
        s = s + __shfl_xor_sync(LFQ_BAQ_FULL, s, off, LFQ_BAQ_LANES);
    return s;
}

LFQ_BAQ_BODY float lfq_max(LfqBandLane a) {
    float s = a.v;
#pragma unroll
    for (int off = LFQ_BAQ_LANES / 2; off >= 1; off >>= 1)
        s = fmaxf(s, __shfl_xor_sync(LFQ_BAQ_FULL, s, off, LFQ_BAQ_LANES));
    return s;
}

LFQ_BAQ_BODY int lfq_first_ge(LfqBandLane a, float x) {
    const unsigned bal = __ballot_sync(LFQ_BAQ_FULL, a.v >= x);
    const unsigned half = (bal >> (threadIdx.x & 16)) & 0xffffu;
    return half ? __ffs(half) - 1 : LFQ_BAQ_LANES;
}

LFQ_BAQ_BODY void lfq_store(float *p, LfqBandLane a) { p[lfq_lane()] = a.v; }
#endif

// The forward pass's M and I band rows of one read, row r as it is asked
// for.  The kernel has its own source, which stages the rows in shared
// memory.
template <class Band>
struct LfqRowsDirect {
    const float *fm, *fi;  // [L][16] each

    LFQ_BAQ_METHOD void get(int r, Band &zM, Band &zI) {
        zM = Band::load(fm + (int64_t)r * LFQ_BAQ_LANES);
        zI = Band::load(fi + (int64_t)r * LFQ_BAQ_LANES);
    }
};

// ---- the per-read bodies, written once for both band types ----

// Forward pass of one read (K3).  refw [Lr] window codes, query [L] read
// codes, qualp [L] error probs.  Writes the scaled M and I band rows to
// fm and fi ([L][16]) and the row scales to fs ([L]) when live; a dead
// read (the ragged edge of the last block) computes on a live read's
// inputs, so that its half-warp's shuffles stay in step, and writes
// nothing.
template <class Band>
LFQ_BAQ_BODY void lfq_baq_forward(const uint8_t *refw, int Lr, int l_ref,
                                  const uint8_t *query, const float *qualp,
                                  int L, const LfqBaqConsts &c, float *fm,
                                  float *fi, float *fs, bool live) {
    const int bw = LFQ_BAQ_BW;
    const int lim = l_ref < Lr ? l_ref : Lr;
    const float lref = (float)l_ref;
    const float bM = c.bm_num / lref, bI = c.bi_num / lref;
    // row 1: k in [1, min(l_ref, bw + 1)], which is row 1's band
    int lo = lfq_baq_lo(1), hi = lfq_baq_hi(1, lim);
    Band e = Band::emit_row(refw, Lr, -bw, query[0], qualp[0]);
    Band fM = lfq_keep(e * bM, lo, hi);
    Band fI = lfq_keep(Band::splat(LFQ_BAQ_EI * bI), lo, hi);
    Band fD = Band::splat(0.0f);
    float s = fmaxf(lfq_sum(fM + fI), 1e-30f);
    fM = fM / s;
    fI = fI / s;
    if (live) {
        lfq_store(fm, fM);
        lfq_store(fi, fI);
        if (Band::leader()) fs[0] = s;
    }
    for (int i = 2; i <= L; ++i) {
        lo = lfq_baq_lo(i);
        hi = lfq_baq_hi(i, lim);
        e = Band::emit_row(refw, Lr, i - bw - 1, query[i - 1], qualp[i - 1]);
        Band newM = e * (c.m00 * fM + c.m10 * fI + c.m20 * fD);
        Band newI = LFQ_BAQ_EI * (c.m01 * lfq_shr(fM) + c.m11 * lfq_shr(fI));
        newM = lfq_keep(newM, lo, hi);
        newI = lfq_keep(newI, lo, hi);
        const Band newD =
            lfq_keep(lfq_chain_fwd(c.m02 * lfq_shl(newM), c.w), lo, hi);
        s = fmaxf(lfq_sum(newM + newI + newD), 1e-30f);
        const float inv = 1.0f / s;
        fM = newM * inv;
        fI = newI * inv;
        fD = newD * inv;
        if (live) {
            lfq_store(fm + (int64_t)(i - 1) * LFQ_BAQ_LANES, fM);
            lfq_store(fi + (int64_t)(i - 1) * LFQ_BAQ_LANES, fI);
            if (Band::leader()) fs[i - 1] = s;
        }
    }
}

// MAP phred and state of row i from its posterior band rows.
template <class Band>
LFQ_BAQ_BODY void lfq_baq_map(const Band &zM, const Band &zI, int i,
                              int32_t *q, int32_t *st, bool live) {
    const float best_m = lfq_max(zM), best_i = lfq_max(zI);
    const bool is_ins = best_i > best_m;
    const float best = is_ins ? best_i : best_m;
    // lane-by-lane selects: a conditional between the two rows would take
    // their addresses and put them in local memory
    const int u = lfq_first_ge(lfq_select(is_ins, zI, zM), best);
    const float rest = lfq_sum(lfq_select(is_ins, zM, lfq_zero_lane(zM, u)))
                       + lfq_sum(lfq_select(is_ins, lfq_zero_lane(zI, u), zI));
    // the full window's first maximum: a band lane when best > 0, window
    // lane 0 when the row is all zero
    const int k = best > 0.0f ? i - LFQ_BAQ_BW + u - 1 : 0;
    if (live && Band::leader()) {
        *q = lfq_baq_phred(rest, best);
        *st = (k << 2) | (is_ins ? 1 : 0);
    }
}

// Row j's backward step from row j+1's: (bM, bI) <- row j's.  e is row
// j+1's emission row; lo, hi row j's band lanes.  FULL: the band is the
// whole of lanes 0..14 (8 <= j <= lim - 7), given as constants so that
// the lane masks fold away.
template <bool FULL, class Band>
LFQ_BAQ_BODY void lfq_baq_back_step(Band &bM, Band &bI, const Band &e,
                                    int j, int lim, float inv,
                                    const LfqBaqConsts &c) {
    const int lo = FULL ? 0 : lfq_baq_lo(j);
    const int hi = FULL ? 2 * LFQ_BAQ_BW : lfq_baq_hi(j, lim);
    // row j+1's e * bM at k+1 is lane u of row j+1: the same lane
    const Band eb = e * bM;
    const Band common = LFQ_BAQ_EI * lfq_shl(bI);
    Band bD = lfq_chain_rev(lfq_keep(eb * c.m20, lo, hi), c.w);
    bD = lfq_keep(bD * (j > 1 ? 1.0f : 0.0f), lo, hi);
    const Band bD_next = lfq_shr(bD);
    const Band nM = eb * c.m00 + c.m01 * common + c.m02 * bD_next;
    const Band nI = eb * c.m10 + c.m11 * common;
    bM = lfq_keep(nM, lo, hi) * inv;
    bI = lfq_keep(nI, lo, hi) * inv;
}

// Backward pass of one read with the per-row MAP (K4), from the forward
// pass's M and I band rows (`rows`, row r of [L][16] as asked for) and its
// row scales fs ([L]).  Writes q and st ([L]) when live.  Row i's MAP and
// row i-1's backward step are independent; the window codes walk down with
// the rows (Band::Window).
template <class Band, class Rows>
LFQ_BAQ_BODY void lfq_baq_backward(const uint8_t *refw, int Lr, int l_ref,
                                   const uint8_t *query, const float *qualp,
                                   int L, const LfqBaqConsts &c, Rows &rows,
                                   const float *fs, int32_t *q, int32_t *st,
                                   bool live) {
    const int bw = LFQ_BAQ_BW;
    const int lim = l_ref < Lr ? l_ref : Lr;
    // row L begins from the end states
    Band zM, zI;
    rows.get(L - 1, zM, zI);
    const float sL1 = lfq_sum(zM * c.sM + zI * c.sI);
    const int lo = lfq_baq_lo(L), hi = lfq_baq_hi(L, lim);
    Band bM = lfq_keep(Band::splat(c.sM / fs[L - 1] / sL1), lo, hi);
    Band bI = lfq_keep(Band::splat(c.sI / fs[L - 1] / sL1), lo, hi);
    typename Band::Window win;  // row L-1's window codes
    win.init(refw, Lr, L - 1 - bw);
    for (int i = L; i >= 1; --i) {
        if (i < L) rows.get(i - 1, zM, zI);
        lfq_baq_map(zM * bM, zI * bI, i, q + i - 1, st + i - 1, live);
        if (i == 1) break;
        const int j = i - 1;
        if (i < L) win.down(refw, Lr, j - bw);
        const Band e = win.emit(query[j], qualp[j]);
        const float inv = 1.0f / fs[j - 1];
        if (j > bw && j <= lim - bw)
            lfq_baq_back_step<true>(bM, bI, e, j, lim, inv, c);
        else
            lfq_baq_back_step<false>(bM, bI, e, j, lim, inv, c);
    }
}
