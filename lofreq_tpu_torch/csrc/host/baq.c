/* baq.c — batched banded glocal HMM for base-alignment quality (BAQ) and
 * indel-alignment quality (IDAQ).
 *
 * Native exact implementation of the probabilistic realignment used by the
 * reference engine (see src/lofreq/kprobaln_ext.c:80 and
 * bam_md_ext.c:73,260 for the original per-read formulation; this is a
 * re-derivation with a batch-first API).  A forward/backward pass over a
 * banded 3-state (M/I/D) profile HMM yields per-base MAP posteriors (BAQ)
 * and, via posterior sums over repeat-equivalent indel placements, per-indel
 * alignment qualities.
 *
 * Double precision throughout, with the same quirks that are observable in
 * the reference's output:
 *   - the phred->prob table is rounded through float (g_qual2prob)
 *   - row 1 of the forward pass rescales by division, later rows by
 *     multiplication with the reciprocal
 *   - band-limit guards (u < 3 || u >= bw2*3+3) skip out-of-band cells
 *   - cigar ops >16 bases long skip IDAQ *without* advancing coordinates
 *
 * Build: gcc -O2 -shared -fPIC -o liblofreq_baq.so baq.c -lm
 */

#include <float.h>
#include <math.h>
#include <pthread.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>
#include <unistd.h>

#define EI 0.25
#define EM 0.33333333333

/* cigar ops */
#define OP_M 0
#define OP_I 1
#define OP_D 2
#define OP_N 3
#define OP_S 4
#define OP_H 5
#define OP_EQ 7
#define OP_X 8

#define SANGER_PHRED_MAX 93

static inline int band_u(int bw, int i, int k)
{
    int x = i - bw;
    if (x < 0) x = 0;
    return (k - x + 1) * 3;
}

static inline int u_ok(int u, int bw)
{
    int bw2 = bw * 2 + 1;
    return !(u < 3 || u >= bw2 * 3 + 3);
}

static float q2p_tab[256];
static int q2p_init_done = 0;

static void q2p_init(void)
{
    if (!q2p_init_done) {
        for (int i = 0; i < 256; i++)
            q2p_tab[i] = pow(10, -i / 10.);
        q2p_init_done = 1;
    }
}

/* base code tables: ASCII -> 0..4 (A C G T other) */
static uint8_t base_code[256];
static int base_code_init_done = 0;

static void base_code_init(void)
{
    if (!base_code_init_done) {
        memset(base_code, 4, 256);
        base_code['A'] = base_code['a'] = 0;
        base_code['C'] = base_code['c'] = 1;
        base_code['G'] = base_code['g'] = 2;
        base_code['T'] = base_code['t'] = 3;
        base_code_init_done = 1;
    }
}

/* Per-thread reusable scratch: the HMM previously calloc'd ~130KB per
 * read (fresh mmap pages each time); reusing warm buffers and memsetting
 * only what the algorithm reads as zero removes the page-fault churn. */
typedef struct {
    void *buf[16];
    size_t cap[16];
} baq_scratch_t;

static void *sc_get(baq_scratch_t *sc, int slot, size_t need)
{
    if (sc->cap[slot] < need) {
        free(sc->buf[slot]);
        size_t cap = (need + need / 2 + 128) & ~(size_t)63;
        /* 64B-aligned: the x4 kernel stores one v4df per band cell and
         * split-line vector stores break store-to-load forwarding in the
         * sequential D chain */
        sc->buf[slot] = aligned_alloc(64, cap);
        sc->cap[slot] = sc->buf[slot] ? cap : 0;
    }
    return sc->buf[slot];
}

static void sc_free(baq_scratch_t *sc)
{
    for (int i = 0; i < 16; i++) {
        free(sc->buf[i]);
        sc->buf[i] = NULL;
        sc->cap[i] = 0;
    }
}

/* Banded glocal fwd/bwd.  Outputs: state[l_query] (MAP ref-pos<<2|type),
 * q[l_query] (phred posterior), pd (posterior matrix, (l_query+1) rows of
 * (2*bw+1)*3+6 doubles) — pd may be NULL.  Returns effective band width.
 * This is the scalar path; glocal_x4 below runs four same-geometry reads
 * in SIMD lanes with bit-identical per-lane results (fuzz-tested). */
static int glocal(const uint8_t *ref_codes, int l_ref,
                  const uint8_t *query_codes, int l_query,
                  const uint8_t *iqual, double par_d, double par_e, int par_bw,
                  int *state, uint8_t *q, double *pd, int pd_stride,
                  baq_scratch_t *sc)
{
    q2p_init();
    if (l_ref <= 0 || l_query <= 0)
        return 0;
    const uint8_t *refb = ref_codes - 1;    /* 1-based */
    const uint8_t *qseq = query_codes - 1;
    int bw = l_ref > l_query ? l_ref : l_query;
    if (bw > par_bw) bw = par_bw;
    if (bw < abs(l_ref - l_query)) bw = abs(l_ref - l_query);
    int bw2 = bw * 2 + 1;
    int ncell = bw2 * 3 + 6;

    size_t mat_bytes = (size_t)(l_query + 1) * ncell * sizeof(double);
    double *f = sc_get(sc, 0, mat_bytes);
    double *bmat = sc_get(sc, 1, mat_bytes);
    double *s = sc_get(sc, 2, (l_query + 2) * sizeof(double));
    float *qual = sc_get(sc, 3, l_query * sizeof(float));
    memset(f, 0, mat_bytes);
    memset(bmat, 0, mat_bytes);
    memset(s, 0, (l_query + 2) * sizeof(double));
    for (int i = 0; i < l_query; i++)
        qual[i] = q2p_tab[iqual ? iqual[i] : 30];
    float *qualb = qual - 1;

    double sM, sI, m[9], bM, bI;
    sM = sI = 1. / (2 * l_query + 2);
    m[0] = (1 - par_d - par_d) * (1 - sM); m[1] = m[2] = par_d * (1 - sM);
    m[3] = (1 - par_e) * (1 - sI); m[4] = par_e * (1 - sI); m[5] = 0.;
    m[6] = 1 - par_e; m[7] = 0.; m[8] = par_e;
    bM = (1 - par_d) / l_ref;
    bI = par_d / l_ref;

#define F(i) (f + (size_t)(i) * ncell)
#define B(i) (bmat + (size_t)(i) * ncell)

    /* forward */
    {
        int k = band_u(bw, 0, 0);
        F(0)[k] = 1.;
        s[0] = 1.;
    }
    {
        double *fi = F(1), sum = 0.;
        int beg = 1, end = l_ref < bw + 1 ? l_ref : bw + 1;
        for (int k = beg; k <= end; ++k) {
            double e = (refb[k] > 3 || qseq[1] > 3) ? 1.
                       : refb[k] == qseq[1] ? 1. - qualb[1] : qualb[1] * EM;
            int u = band_u(bw, 1, k);
            fi[u + 0] = e * bM;
            fi[u + 1] = EI * bI;
            sum += fi[u] + fi[u + 1];
        }
        s[1] = sum;
        int _beg = band_u(bw, 1, beg), _end = band_u(bw, 1, end) + 2;
        for (int k = _beg; k <= _end; ++k)
            fi[k] /= sum;
    }
    for (int i = 2; i <= l_query; ++i) {
        double *fi = F(i), *f1 = F(i - 1), sum = 0., qli = qualb[i];
        uint8_t qyi = qseq[i];
        int beg = 1, end = l_ref;
        if (beg < i - bw) beg = i - bw;
        if (end > i + bw) end = i + bw;
        for (int k = beg; k <= end; ++k) {
            double e = (refb[k] > 3 || qyi > 3) ? 1.
                       : refb[k] == qyi ? 1. - qli : qli * EM;
            int u = band_u(bw, i, k);
            int v11 = band_u(bw, i - 1, k - 1);
            int v10 = band_u(bw, i - 1, k);
            int v01 = band_u(bw, i, k - 1);
            fi[u + 0] = e * (m[0] * f1[v11 + 0] + m[3] * f1[v11 + 1] +
                             m[6] * f1[v11 + 2]);
            fi[u + 1] = EI * (m[1] * f1[v10 + 0] + m[4] * f1[v10 + 1]);
            fi[u + 2] = m[2] * fi[v01 + 0] + m[8] * fi[v01 + 2];
            sum += fi[u] + fi[u + 1] + fi[u + 2];
        }
        s[i] = sum;
        int _beg = band_u(bw, i, beg), _end = band_u(bw, i, end) + 2;
        double r = 1. / sum;
        for (int k = _beg; k <= _end; ++k)
            fi[k] *= r;
    }
    {
        double sum = 0.;
        for (int k = 1; k <= l_ref; ++k) {
            int u = band_u(bw, l_query, k);
            if (!u_ok(u, bw)) continue;
            sum += F(l_query)[u + 0] * sM + F(l_query)[u + 1] * sI;
        }
        s[l_query + 1] = sum;
    }

    /* backward */
    for (int k = 1; k <= l_ref; ++k) {
        int u = band_u(bw, l_query, k);
        double *bi = B(l_query);
        if (!u_ok(u, bw)) continue;
        bi[u + 0] = sM / s[l_query] / s[l_query + 1];
        bi[u + 1] = sI / s[l_query] / s[l_query + 1];
    }
    for (int i = l_query - 1; i >= 1; --i) {
        double *bi = B(i), *b1 = B(i + 1);
        double y = (i > 1), qli1 = qualb[i + 1];
        uint8_t qyi1 = qseq[i + 1];
        int beg = 1, end = l_ref;
        if (beg < i - bw) beg = i - bw;
        if (end > i + bw) end = i + bw;
        for (int k = end; k >= beg; --k) {
            int u = band_u(bw, i, k);
            int v11 = band_u(bw, i + 1, k + 1);
            int v10 = band_u(bw, i + 1, k);
            int v01 = band_u(bw, i, k + 1);
            double e = (k >= l_ref ? 0
                        : (refb[k + 1] > 3 || qyi1 > 3) ? 1.
                        : refb[k + 1] == qyi1 ? 1. - qli1 : qli1 * EM) *
                       b1[v11];
            bi[u + 0] = e * m[0] + EI * m[1] * b1[v10 + 1] + m[2] * bi[v01 + 2];
            bi[u + 1] = e * m[3] + EI * m[4] * b1[v10 + 1];
            bi[u + 2] = (e * m[6] + m[8] * bi[v01 + 2]) * y;
        }
        int _beg = band_u(bw, i, beg), _end = band_u(bw, i, end) + 2;
        double r = 1. / s[i];
        for (int k = _beg; k <= _end; ++k)
            bi[k] *= r;
    }

    /* MAP + posterior matrix */
    for (int i = 1; i <= l_query; ++i) {
        double sum = 0., max = 0.;
        double *fi = F(i), *bi = B(i);
        double *pdi = pd ? pd + (size_t)i * pd_stride : NULL;
        int beg = 1, end = l_ref, max_k = -1;
        if (beg < i - bw) beg = i - bw;
        if (end > i + bw) end = i + bw;
        for (int k = beg; k <= end; ++k) {
            int u = band_u(bw, i, k);
            double z;
            z = fi[u + 0] * bi[u + 0];
            if (z > max) { max = z; max_k = (k - 1) << 2 | 0; }
            sum += z;
            z = fi[u + 1] * bi[u + 1];
            if (z > max) { max = z; max_k = (k - 1) << 2 | 1; }
            sum += z;
            if (pdi) {
                pdi[u + 0] = fi[u + 0] * bi[u + 0] * s[i];
                pdi[u + 1] = fi[u + 1] * bi[u + 1] * s[i];
                pdi[u + 2] = fi[u + 2] * bi[u + 2] * s[i];
            }
        }
        max /= sum;
        if (state) state[i - 1] = max_k;
        if (q) {
            int k = (int)(-4.343 * log(1. - max) + .499);
            q[i - 1] = k > 100 ? 99 : k;
        }
    }

    return bw;
#undef F
#undef B
}

/* ---------------------------------------------------------------------
 * SIMD glocal kernels: glocal_x4 (AVX2 ymm) and glocal_x8 (AVX-512 zmm),
 * instantiated from the width-parameterized baq_glocal_xw.inc.  See the
 * header comment there for the design and the bit-identity argument. */

typedef double v4df __attribute__((vector_size(32)));
typedef int64_t v4di __attribute__((vector_size(32)));
typedef double v8df __attribute__((vector_size(64)));
typedef int64_t v8di __attribute__((vector_size(64)));

#define LANES 4
#define VD v4df
#define VI v4di
#define GLOCAL_FN glocal_x4
#define NM(x) x##_w4
#include "baq_glocal_xw.inc"
#undef LANES
#undef VD
#undef VI
#undef GLOCAL_FN
#undef NM

#define LANES 8
#define VD v8df
#define VI v8di
#define GLOCAL_FN glocal_x8
#define NM(x) x##_w8
#include "baq_glocal_xw.inc"
#undef LANES
#undef VD
#undef VI
#undef GLOCAL_FN
#undef NM

static inline uint8_t encode_q(int q)
{
    return (uint8_t)(q < 33 ? '!' : (q > 126 ? '~' : q));
}

static inline int prob_to_sangerq(double p)
{
    return p < 0.0 + DBL_EPSILON ? 126 + 1 : ((int)(-10 * log10(p)) + 33);
}

/* IDAQ from the posterior matrix (see bam_md_ext.c:73-249 for the original
 * coordinate conventions reproduced here). */
static void compute_idaq(
    const char *ref, int64_t ref_len, int64_t read_pos,
    const uint32_t *cigar, int n_cigar, const char *seq, int l_qseq,
    const double *pd, int pd_stride, int xe, int xb, int bw,
    uint8_t *iaq, uint8_t *daq, int *n_ins_out, int *n_del_out)
{
    int n_ins = 0, n_del = 0;
    int64_t x = read_pos;
    int y = 0;
    for (int k = 0; k < l_qseq; k++)
        iaq[k] = daq[k] = '~';
    iaq[l_qseq] = daq[l_qseq] = '\0';

    for (int k = 0; k < n_cigar; ++k) {
        int op = cigar[k] & 0xf, oplen = cigar[k] >> 4;
        if (op == OP_M || op == OP_EQ || op == OP_X) {
            x += oplen;
            y += oplen;
        } else if (op == OP_D) {
            int64_t rpos = x;
            int qpos = y;
            if (qpos == 0) continue;
            if (oplen > 16) continue;   /* coordinates NOT advanced (sic) */
            n_del += 1;
            char del_seq[17];
            for (int j = 0; j < oplen; j++) {
                del_seq[j] = (x + j < ref_len) ? ref[x + j] : 'N';
            }
            del_seq[oplen] = '\0';
            x += oplen;
            int64_t ref_i = x;
            int rep_i = 0, del_rep = 0;
            while (ref_i < xe && ref_i < ref_len) {
                if (ref[ref_i] != del_seq[rep_i]) break;
                del_rep += 1; ref_i += 1; rep_i += 1;
                if (rep_i >= oplen) rep_i = 0;
            }
            double ap = 0;
            for (int j = 0; j < del_rep + 1; j++) {
                if (qpos + j > l_qseq) break;
                const double *pdi = pd + (size_t)(qpos + j) * pd_stride;
                int u = band_u(bw, qpos + j, (int)(rpos - xb + 1 + j));
                if (!u_ok(u, bw)) continue;
                ap += pdi[u + 2];
            }
            ap = 1 - ap;
            daq[qpos - 1] = encode_q(prob_to_sangerq(ap));
        } else if (op == OP_I) {
            int64_t rpos = x;
            int qpos = y;
            if (oplen > 16) continue;   /* y NOT advanced (sic) */
            n_ins += 1;
            if (qpos == 0) continue;
            char ins_seq[17];
            for (int j = 0; j < oplen; j++) {
                ins_seq[j] = seq[y];
                y += 1;
            }
            ins_seq[oplen] = '\0';
            int64_t ref_i = x;
            int rep_i = 0, ins_rep = 0;
            while (ref_i < xe && ref_i < ref_len) {
                if (ref[ref_i] != ins_seq[rep_i]) break;
                ins_rep += 1; ref_i += 1; rep_i += 1;
                if (rep_i >= oplen) rep_i = 0;
            }
            double ap = 0;
            for (int j = 0; j < ins_rep + 1; j++) {
                if (qpos + j + 1 > l_qseq) break;
                const double *pdi = pd + (size_t)(qpos + j + 1) * pd_stride;
                int u = band_u(bw, qpos + j + 1, (int)(rpos - xb + j));
                if (!u_ok(u, bw)) continue;
                ap += pdi[u + 1];
            }
            ap = 1 - ap;
            iaq[qpos - 1] = encode_q(prob_to_sangerq(ap));
        } else if (op == OP_S) {
            y += oplen;
        }
        /* N advances ref in the outer walk of the reference impl?  The
         * original idaq() ignores N entirely; reproduce that. */
    }
    *n_ins_out = n_ins;
    *n_del_out = n_del;
}

/* Alignment geometry for one read: ref window, band width, indel flags.
 * Mirrors the window calculation at the top of the reference's driver
 * (bam_md_ext.c:376-398). */
typedef struct {
    int64_t xb, xe;
    int l_ref, bw;
    int has_ins, has_del;
    int ok;
} realn_geom_t;

static void realn_geom(const uint32_t *cigar, int n_cigar, int64_t read_pos,
                       int l_qseq, int64_t ref_len, realn_geom_t *g)
{
    g->ok = 0;
    g->has_ins = g->has_del = 0;
    int64_t x = read_pos, xb = -1, xe = -1;
    int y = 0, yb = -1, ye = -1;
    for (int k = 0; k < n_cigar; ++k) {
        int op = cigar[k] & 0xf, l = cigar[k] >> 4;
        if (op == OP_M || op == OP_EQ || op == OP_X) {
            if (yb < 0) yb = y;
            if (xb < 0) xb = x;
            ye = y + l; xe = x + l;
            x += l; y += l;
        } else if (op == OP_S || op == OP_I) {
            y += l;
            if (op == OP_I) g->has_ins = 1;
        } else if (op == OP_D) {
            g->has_del = 1;
            x += l;
        } else if (op == OP_N) {
            x += l;
        }
    }
    if (xb < 0 || l_qseq <= 0)
        return;

    int bw = 7;
    if (llabs((xe - xb) - (int64_t)(ye - yb)) > bw)
        bw = (int)llabs((xe - xb) - (int64_t)(ye - yb)) + 3;
    xb -= yb + bw / 2;
    if (xb < 0) xb = 0;
    xe += l_qseq - ye + bw / 2;
    if (xe - xb - l_qseq > bw) {
        /* comma-expression in the original: second term uses updated xb */
        int64_t d1 = (xe - xb - l_qseq - bw) / 2;
        xb += d1;
        int64_t d2 = (xe - xb - l_qseq - bw) / 2;
        xe -= d2;
    }

    /* clip ref window at contig end (ref[i]==0 check in the original) */
    if (xe > ref_len) xe = ref_len;
    int l_ref = (int)(xe - xb);
    if (l_ref <= 0)
        return;
    g->xb = xb;
    g->xe = xe;
    g->l_ref = l_ref;
    g->bw = bw;
    g->ok = 1;
}

/* Post-HMM per-read work: derive BAQ chars from the MAP posteriors
 * (non-ext raw / ext min-max smoothed) and IDAQ strings from the
 * posterior matrix; flags_out bits: 1=baq 2=ai 4=ad. */
static void realn_finish(
    const char *ref, int64_t ref_len, int64_t read_pos,
    const uint32_t *cigar, int n_cigar,
    const char *seq, const uint8_t *qual, int l_qseq,
    int want_baq, int ext_baq,
    const int *state, const uint8_t *q,
    double *pd, int pd_stride, int eff_bw, int64_t xe, int64_t xb,
    uint8_t *baq_out, uint8_t *iaq_out, uint8_t *daq_out, uint8_t *flags_out,
    baq_scratch_t *sc);

/* Per-read realignment: computes BAQ chars (phred+33) into baq_out and
 * IDAQ strings into iaq_out/ad_out; flags_out bits: 1=baq 2=ai 4=ad.
 *
 * ref: ASCII reference (uppercased).  seq: ASCII read bases.
 * cigar packed as len<<4|op.  qual: raw phreds.
 */
static void realn_one(
    const char *ref, int64_t ref_len, int64_t read_pos,
    const uint32_t *cigar, int n_cigar,
    const char *seq, const uint8_t *qual, int l_qseq,
    int want_baq, int ext_baq, int want_idaq,
    double par_d, double par_e,
    uint8_t *baq_out, uint8_t *iaq_out, uint8_t *daq_out, uint8_t *flags_out,
    baq_scratch_t *sc)
{
    base_code_init();
    *flags_out = 0;
    realn_geom_t g;
    realn_geom(cigar, n_cigar, read_pos, l_qseq, ref_len, &g);
    if (!g.ok)
        return;
    int bw = g.bw, l_ref = g.l_ref;
    int has_ins = g.has_ins, has_del = g.has_del;
    int64_t xb = g.xb, xe = g.xe;

    uint8_t *qcodes = sc_get(sc, 4, l_qseq);
    for (int i = 0; i < l_qseq; i++)
        qcodes[i] = base_code[(uint8_t)seq[i]];
    uint8_t *rcodes = sc_get(sc, 5, l_ref > 0 ? l_ref : 1);
    for (int i = 0; i < l_ref; i++)
        rcodes[i] = base_code[(uint8_t)ref[xb + i]];

    int *state = sc_get(sc, 6, l_qseq * sizeof(int));
    uint8_t *q = sc_get(sc, 7, l_qseq);
    double *pd = NULL;
    int pd_stride = 0;
    if (want_idaq && (has_ins || has_del)) {
        /* allocate max possible stride; effective bw known after glocal */
        int bw_max = bw;
        if (bw_max < abs(l_ref - l_qseq)) bw_max = abs(l_ref - l_qseq);
        int maxdim = l_ref > l_qseq ? l_ref : l_qseq;
        if (bw_max > maxdim) bw_max = maxdim;
        pd_stride = (bw_max * 2 + 1) * 3 + 6;
        size_t pd_bytes = (size_t)(l_qseq + 1) * pd_stride * sizeof(double);
        pd = sc_get(sc, 8, pd_bytes);
        memset(pd, 0, pd_bytes);
    }
    int eff_bw = glocal(rcodes, l_ref, qcodes, l_qseq, qual, par_d, par_e,
                        bw, state, q, pd, pd_stride, sc);
    realn_finish(ref, ref_len, read_pos, cigar, n_cigar, seq, qual, l_qseq,
                 want_baq, ext_baq, state, q, pd, pd_stride, eff_bw, xe, xb,
                 baq_out, iaq_out, daq_out, flags_out, sc);
}

static void realn_finish(
    const char *ref, int64_t ref_len, int64_t read_pos,
    const uint32_t *cigar, int n_cigar,
    const char *seq, const uint8_t *qual, int l_qseq,
    int want_baq, int ext_baq,
    const int *state, const uint8_t *q,
    double *pd, int pd_stride, int eff_bw, int64_t xe, int64_t xb,
    uint8_t *baq_out, uint8_t *iaq_out, uint8_t *daq_out, uint8_t *flags_out,
    baq_scratch_t *sc)
{
    *flags_out = 0;
    if (want_baq) {
        uint8_t *bq = sc_get(sc, 9, l_qseq + 1);
        memcpy(bq, qual, l_qseq);
        if (!ext_baq) {
            /* In the reference's compiled (non-ORIG_BAQ) build the
             * diagonal zeroing of this branch is DEAD CODE: without
             * ORIG_BAQ there is no `else`, so `bq[i] = q[i]` executes
             * unconditionally right after the zero (bam_md_ext.c:417-421).
             * Non-ext BAQ is therefore the raw MAP posterior for every
             * aligned base, no state masking.  (Caught by fuzz goldens:
             * off-diagonal states with ext=0.) */
            int64_t xx = read_pos; int yy = 0;
            for (int k = 0; k < n_cigar; ++k) {
                int op = cigar[k] & 0xf, l = cigar[k] >> 4;
                if (op == OP_M || op == OP_EQ || op == OP_X) {
                    for (int i = yy; i < yy + l; ++i)
                        bq[i] = q[i];
                    xx += l; yy += l;
                } else if (op == OP_S || op == OP_I) yy += l;
                else if (op == OP_D || op == OP_N) xx += l;
            }
        } else {
            uint8_t *left = sc_get(sc, 10, l_qseq);
            uint8_t *rght = sc_get(sc, 11, l_qseq);
            memset(left, 0, l_qseq);
            memset(rght, 0, l_qseq);
            int64_t xx = read_pos; int yy = 0;
            for (int k = 0; k < n_cigar; ++k) {
                int op = cigar[k] & 0xf, l = cigar[k] >> 4;
                if (op == OP_M || op == OP_EQ || op == OP_X) {
                    for (int i = yy; i < yy + l; ++i)
                        bq[i] = ((state[i] & 3) != 0 ||
                                 state[i] >> 2 != xx - xb + (i - yy))
                                    ? 0 : q[i];
                    left[yy] = bq[yy];
                    for (int i = yy + 1; i < yy + l; ++i)
                        left[i] = bq[i] > left[i - 1] ? bq[i] : left[i - 1];
                    rght[yy + l - 1] = bq[yy + l - 1];
                    for (int i = yy + l - 2; i >= yy; --i)
                        rght[i] = bq[i] > rght[i + 1] ? bq[i] : rght[i + 1];
                    for (int i = yy; i < yy + l; ++i)
                        bq[i] = left[i] < rght[i] ? left[i] : rght[i];
                    xx += l; yy += l;
                } else if (op == OP_S || op == OP_I) yy += l;
                else if (op == OP_D || op == OP_N) xx += l;
            }
        }
        for (int i = 0; i < l_qseq; ++i) {
            if (bq[i] > SANGER_PHRED_MAX) bq[i] = SANGER_PHRED_MAX;
            baq_out[i] = bq[i] + 33;
        }
        *flags_out |= 1;
    }

    if (pd) {
        int n_ins = 0, n_del = 0;
        compute_idaq(ref, ref_len, read_pos, cigar, n_cigar, seq, l_qseq,
                     pd, pd_stride, (int)xe, (int)xb, eff_bw,
                     iaq_out, daq_out, &n_ins, &n_del);
        if (n_ins) *flags_out |= 2;
        if (n_del) *flags_out |= 4;
    }
}

/* Batch API over packed per-read arrays. */
typedef struct {
    const char *ref;
    int64_t ref_len, n_reads;
    const int64_t *read_pos;
    const uint32_t *cigars;
    const int64_t *cigar_start;
    const char *seqs;
    const uint8_t *quals;
    const int64_t *seq_start;
    const uint8_t *want_baq, *want_idaq;
    int ext_baq;
    double par_d, par_e;
    uint8_t *baq_out, *iaq_out, *daq_out, *flags_out;
    int tid, nth;
} baq_job_t;

/* Grouping record for the 4-lane HMM: reads with identical
 * (l_qseq, l_ref, bw) share band geometry and can run in SIMD lanes. */
typedef struct {
    int32_t lq, lref, bw;
    int64_t idx;
    int64_t xb, xe;
    uint8_t has_ins, has_del;
} gitem_t;

static int gitem_cmp(const void *a, const void *b)
{
    const gitem_t *x = a, *y = b;
    if (x->lq != y->lq) return x->lq < y->lq ? -1 : 1;
    if (x->lref != y->lref) return x->lref < y->lref ? -1 : 1;
    if (x->bw != y->bw) return x->bw < y->bw ? -1 : 1;
    return x->idx < y->idx ? -1 : x->idx > y->idx ? 1 : 0;
}

/* One read's batch fields. */
static void job_read(const baq_job_t *j, int64_t i, const char **seq,
                     const uint8_t **qual, const uint32_t **cigar,
                     int *n_cigar, int *l_qseq)
{
    *n_cigar = (int)(j->cigar_start[i + 1] - j->cigar_start[i]);
    *l_qseq = (int)(j->seq_start[i + 1] - j->seq_start[i]);
    *seq = j->seqs + j->seq_start[i];
    *qual = j->quals + j->seq_start[i];
    *cigar = j->cigars + j->cigar_start[i];
}

/* Run four same-geometry reads through glocal_x4 and finish each lane. */
/* Run nl (4 or 8) same-geometry reads through glocal_x4/x8 and finish
 * each lane. */
static void realn_group(const baq_job_t *jb, const gitem_t *it, int nl,
                        baq_scratch_t *sc)
{
    int l_qseq = it[0].lq, l_ref = it[0].lref, bw = it[0].bw;
    uint8_t *qb = sc_get(sc, 4, (size_t)nl * l_qseq);
    uint8_t *rb = sc_get(sc, 5, (size_t)nl * l_ref);
    int *stb = sc_get(sc, 6, (size_t)nl * l_qseq * sizeof(int));
    uint8_t *qq = sc_get(sc, 7, (size_t)nl * l_qseq);
    const uint8_t *qcodes[8], *rcodes[8], *iq[8];
    int *state[8];
    uint8_t *qv[8];
    double *pdl[8];
    int any_pd = 0;
    /* pd band geometry is shared by the group (same inputs as realn_one) */
    int bw_max = bw;
    if (bw_max < abs(l_ref - l_qseq)) bw_max = abs(l_ref - l_qseq);
    int maxdim = l_ref > l_qseq ? l_ref : l_qseq;
    if (bw_max > maxdim) bw_max = maxdim;
    int pd_stride = (bw_max * 2 + 1) * 3 + 6;
    size_t pd_cells = (size_t)(l_qseq + 1) * pd_stride;
    for (int l = 0; l < nl; ++l)
        if (jb->want_idaq[it[l].idx] && (it[l].has_ins || it[l].has_del))
            any_pd = 1;
    double *pdbuf =
        any_pd ? sc_get(sc, 8, (size_t)nl * pd_cells * sizeof(double))
               : NULL;

    for (int l = 0; l < nl; ++l) {
        int64_t i = it[l].idx;
        const char *seq;
        const uint8_t *qual;
        const uint32_t *cigar;
        int n_cigar, lq;
        job_read(jb, i, &seq, &qual, &cigar, &n_cigar, &lq);
        uint8_t *qc = qb + (size_t)l * l_qseq;
        for (int t = 0; t < l_qseq; ++t)
            qc[t] = base_code[(uint8_t)seq[t]];
        uint8_t *rc = rb + (size_t)l * l_ref;
        for (int t = 0; t < l_ref; ++t)
            rc[t] = base_code[(uint8_t)jb->ref[it[l].xb + t]];
        qcodes[l] = qc;
        rcodes[l] = rc;
        iq[l] = qual;
        state[l] = stb + (size_t)l * l_qseq;
        qv[l] = qq + (size_t)l * l_qseq;
        if (pdbuf && jb->want_idaq[i] && (it[l].has_ins || it[l].has_del)) {
            pdl[l] = pdbuf + (size_t)l * pd_cells;
            memset(pdl[l], 0, pd_cells * sizeof(double));
        } else {
            pdl[l] = NULL;
        }
    }

    int eff_bw =
        nl == 8 ? glocal_x8(rcodes, l_ref, qcodes, l_qseq, iq,
                            jb->par_d, jb->par_e, bw, state, qv,
                            pdl, pd_stride, sc)
                : glocal_x4(rcodes, l_ref, qcodes, l_qseq, iq,
                            jb->par_d, jb->par_e, bw, state, qv,
                            pdl, pd_stride, sc);

    for (int l = 0; l < nl; ++l) {
        int64_t i = it[l].idx;
        const char *seq;
        const uint8_t *qual;
        const uint32_t *cigar;
        int n_cigar, lq;
        job_read(jb, i, &seq, &qual, &cigar, &n_cigar, &lq);
        realn_finish(jb->ref, jb->ref_len, jb->read_pos[i], cigar, n_cigar,
                     seq, qual, l_qseq, jb->want_baq[i], jb->ext_baq,
                     state[l], qv[l], pdl[l], pd_stride, eff_bw,
                     it[l].xe, it[l].xb,
                     jb->baq_out + jb->seq_start[i] + i,
                     jb->iaq_out + jb->seq_start[i] + i,
                     jb->daq_out + jb->seq_start[i] + i,
                     jb->flags_out + i, sc);
    }
}

/* Scalar path for group remainders and malloc-failure fallback. */
static void realn_idx(const baq_job_t *j, int64_t i, baq_scratch_t *sc)
{
    const char *seq;
    const uint8_t *qual;
    const uint32_t *cigar;
    int n_cigar, l_qseq;
    job_read(j, i, &seq, &qual, &cigar, &n_cigar, &l_qseq);
    realn_one(j->ref, j->ref_len, j->read_pos[i], cigar, n_cigar,
              seq, qual, l_qseq,
              j->want_baq[i], j->ext_baq, j->want_idaq[i],
              j->par_d, j->par_e,
              j->baq_out + j->seq_start[i] + i, /* +i: per-read NUL room */
              j->iaq_out + j->seq_start[i] + i,
              j->daq_out + j->seq_start[i] + i,
              j->flags_out + i, sc);
}

static void *baq_worker(void *arg)
{
    baq_job_t *j = arg;
    baq_scratch_t sc;
    memset(&sc, 0, sizeof(sc));
    base_code_init();
    /* LOFREQ_BAQ_X4=0 disables the 4-lane grouping (debug/AB switch;
     * output is bit-identical either way) */
    const char *x4e = getenv("LOFREQ_BAQ_X4");
    int use_x4 = !(x4e && *x4e == '0');
    int64_t cap = j->n_reads / j->nth + 2;
    gitem_t *items =
        use_x4 ? malloc((size_t)cap * sizeof(gitem_t)) : NULL;
    int64_t n_items = 0;
    for (int64_t i = j->tid; i < j->n_reads; i += j->nth) {
        j->flags_out[i] = 0;
        if (!j->want_baq[i] && !j->want_idaq[i])
            continue;
        if (!items) {           /* malloc failed: plain scalar walk */
            realn_idx(j, i, &sc);
            continue;
        }
        const char *seq;
        const uint8_t *qual;
        const uint32_t *cigar;
        int n_cigar, l_qseq;
        job_read(j, i, &seq, &qual, &cigar, &n_cigar, &l_qseq);
        realn_geom_t g;
        realn_geom(cigar, n_cigar, j->read_pos[i], l_qseq, j->ref_len, &g);
        if (!g.ok)
            continue;
        items[n_items++] = (gitem_t){l_qseq, g.l_ref, g.bw, i, g.xb, g.xe,
                                     (uint8_t)g.has_ins, (uint8_t)g.has_del};
    }
    if (items) {
        /* group same-shape reads; 4-lane SIMD for full quads, scalar for
         * remainders (bit-identical either way, so the read->lane
         * assignment never affects output) */
        qsort(items, (size_t)n_items, sizeof(gitem_t), gitem_cmp);
        int64_t p = 0;
        while (p < n_items) {
            int64_t r = p;
            while (r < n_items && items[r].lq == items[p].lq &&
                   items[r].lref == items[p].lref &&
                   items[r].bw == items[p].bw)
                r++;
            while (r - p >= 8) {
                realn_group(j, items + p, 8, &sc);
                p += 8;
            }
            if (r - p >= 4) {
                realn_group(j, items + p, 4, &sc);
                p += 4;
            }
            for (; p < r; ++p)
                realn_idx(j, items[p].idx, &sc);
        }
        free(items);
    }
    sc_free(&sc);
    return NULL;
}

/* LOFREQ_NATIVE_THREADS: worker count for the per-read BAQ/IDAQ loop
 * (1 = serial; unset = online CPUs, capped at 8).  The parallel call
 * wrapper pins workers to 1 thread each to avoid oversubscription. */
static int baq_threads(void)
{
    const char *e = getenv("LOFREQ_NATIVE_THREADS");
    if (e && *e) {
        int n = atoi(e);
        return n < 1 ? 1 : (n > 64 ? 64 : n);
    }
    long n = sysconf(_SC_NPROCESSORS_ONLN);
    if (n < 1)
        n = 1;
    return n > 8 ? 8 : (int)n;
}

void lfq_baq_batch(
    const char *ref, int64_t ref_len,
    int64_t n_reads,
    const int64_t *read_pos,
    const uint32_t *cigars, const int64_t *cigar_start,
    const char *seqs, const uint8_t *quals, const int64_t *seq_start,
    const uint8_t *want_baq, const uint8_t *want_idaq,
    int ext_baq, double par_d, double par_e,
    uint8_t *baq_out, uint8_t *iaq_out, uint8_t *daq_out, uint8_t *flags_out)
{
    /* init shared lookup tables before any worker touches them */
    q2p_init();
    base_code_init();
    int nth = baq_threads();
    if ((int64_t)nth > n_reads)
        nth = n_reads > 0 ? (int)n_reads : 1;
    baq_job_t base = {
        ref, ref_len, n_reads, read_pos, cigars, cigar_start, seqs, quals,
        seq_start, want_baq, want_idaq, ext_baq, par_d, par_e,
        baq_out, iaq_out, daq_out, flags_out, 0, nth,
    };
    if (nth <= 1 || n_reads < 64) {
        base.nth = 1;
        baq_worker(&base);
        return;
    }
    pthread_t tids[64];
    baq_job_t jobs[64];
    for (int t = 0; t < nth; t++) {
        jobs[t] = base;
        jobs[t].tid = t;
    }
    for (int t = 1; t < nth; t++)
        if (pthread_create(&tids[t], NULL, baq_worker, &jobs[t]) != 0)
            jobs[t].nth = 0; /* mark failed; fall back below */
    baq_worker(&jobs[0]);
    for (int t = 1; t < nth; t++)
        if (jobs[t].nth)
            pthread_join(tids[t], NULL);
    /* serial fallback for any stripe whose thread failed to start */
    for (int t = 1; t < nth; t++)
        if (!jobs[t].nth) {
            jobs[t].nth = nth;
            baq_worker(&jobs[t]);
        }
}

/* debug/differential export: run the banded glocal HMM directly on
 * precomputed code arrays (state/q out) — used by the state-level
 * differential tests against the reference's kpa_ext_glocal */
int lfq_glocal_dbg(const uint8_t *ref_codes, int l_ref,
                   const uint8_t *query_codes, int l_query,
                   const uint8_t *iqual, double par_d, double par_e,
                   int par_bw, int *state, uint8_t *q)
{
    baq_scratch_t sc;
    memset(&sc, 0, sizeof(sc));
    int r = glocal(ref_codes, l_ref, query_codes, l_query, iqual,
                   par_d, par_e, par_bw, state, q, NULL, 0, &sc);
    sc_free(&sc);
    return r;
}

/* Scalar glocal with pd output, for the x4-vs-scalar fuzz test. */
int lfq_glocal_dbg_pd(const uint8_t *ref_codes, int l_ref,
                      const uint8_t *query_codes, int l_query,
                      const uint8_t *iqual, double par_d, double par_e,
                      int par_bw, int *state, uint8_t *q,
                      double *pd, int pd_stride)
{
    baq_scratch_t sc;
    memset(&sc, 0, sizeof(sc));
    int r = glocal(ref_codes, l_ref, query_codes, l_query, iqual,
                   par_d, par_e, par_bw, state, q, pd, pd_stride, &sc);
    sc_free(&sc);
    return r;
}

/* 4-lane SIMD glocal, exported for the x4-vs-scalar bit-identity fuzz
 * test.  All four lanes must share (l_ref, l_query, par_bw); per-lane
 * arrays are packed contiguously (lane l at offset l*l_ref / l*l_query /
 * l*pd_cells). */
int lfq_glocal_x4_dbg(const uint8_t *ref_codes4, int l_ref,
                      const uint8_t *query_codes4, int l_query,
                      const uint8_t *iqual4, double par_d, double par_e,
                      int par_bw, int *state4, uint8_t *q4,
                      double *pd4, int pd_stride)
{
    baq_scratch_t sc;
    memset(&sc, 0, sizeof(sc));
    const uint8_t *rc[4], *qc[4], *iq[4];
    int *st[4];
    uint8_t *qq[4];
    double *pdl[4];
    size_t pd_cells = (size_t)(l_query + 1) * pd_stride;
    for (int l = 0; l < 4; ++l) {
        rc[l] = ref_codes4 + (size_t)l * l_ref;
        qc[l] = query_codes4 + (size_t)l * l_query;
        iq[l] = iqual4 + (size_t)l * l_query;
        st[l] = state4 + (size_t)l * l_query;
        qq[l] = q4 + (size_t)l * l_query;
        pdl[l] = pd4 ? pd4 + (size_t)l * pd_cells : NULL;
    }
    int r = glocal_x4(rc, l_ref, qc, l_query, iq, par_d, par_e, par_bw,
                      st, qq, pd4 ? pdl : NULL, pd_stride, &sc);
    sc_free(&sc);
    return r;
}

int lfq_glocal_x8_dbg(const uint8_t *ref_codes4, int l_ref,
                      const uint8_t *query_codes4, int l_query,
                      const uint8_t *iqual4, double par_d, double par_e,
                      int par_bw, int *state4, uint8_t *q4,
                      double *pd4, int pd_stride)
{
    baq_scratch_t sc;
    memset(&sc, 0, sizeof(sc));
    const uint8_t *rc[8], *qc[8], *iq[8];
    int *st[8];
    uint8_t *qq[8];
    double *pdl[8];
    size_t pd_cells = (size_t)(l_query + 1) * pd_stride;
    for (int l = 0; l < 8; ++l) {
        rc[l] = ref_codes4 + (size_t)l * l_ref;
        qc[l] = query_codes4 + (size_t)l * l_query;
        iq[l] = iqual4 + (size_t)l * l_query;
        st[l] = state4 + (size_t)l * l_query;
        qq[l] = q4 + (size_t)l * l_query;
        pdl[l] = pd4 ? pd4 + (size_t)l * pd_cells : NULL;
    }
    int r = glocal_x8(rc, l_ref, qc, l_query, iq, par_d, par_e, par_bw,
                      st, qq, pd4 ? pdl : NULL, pd_stride, &sc);
    sc_free(&sc);
    return r;
}
