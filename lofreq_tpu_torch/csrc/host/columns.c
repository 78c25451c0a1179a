/* columns.c — fused column builder for the SNV calling path.
 *
 * Takes the flat pileup-row arrays from ingest.c and produces, in one C
 * pass per window: per-column stats (coverage, filtered bases, strand
 * counts, consensus), the merged+filtered error-probability CSR (sorted
 * ascending per column, exactly the multiset plp_to_errprobs builds — see
 * src/lofreq/snpcaller.c:345 for the original), per-alt
 * filtered/raw counts, and the light indel sums needed for the
 * consensus-indel SNV gate.  Replaces several numpy passes over tens of
 * millions of rows with a single cache-friendly sweep.
 *
 * Columns are independent, so the per-position loop is striped over
 * pthreads (LOFREQ_NATIVE_THREADS, same knob as the BAQ loop): stripes
 * are balanced by row count, each thread writes its columns at a
 * precomputed column base and its probs into its stripe's row span, and a
 * final serial pass compacts the prob regions into a dense CSR.  Results
 * are bit-identical to the serial order (each column's output depends
 * only on its own rows).
 */

#include <float.h>
#include <math.h>
#include <pthread.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>
#include <unistd.h>

static double q2p_tab[256];
static int q2p_tab_done = 0;

static void q2p_tab_init(void)
{
    if (!q2p_tab_done) {
        for (int i = 0; i < 256; i++)
            q2p_tab[i] = pow(10.0, -1.0 * i / 10.0);
        q2p_tab_done = 1;
    }
}

static inline double q2p8(int q)
{
    return q2p_tab[q & 0xff];
}

static inline double q2p_full(int32_t q)
{
    if (q < 0)
        return 0.0;
    if (q < 256)
        return q2p8(q);
    return pow(10.0, -1.0 * (double)q / 10.0);
}

/* reference comparator clone (exact_stats.c); err probs are emitted
 * nt4-grouped and UNSORTED here — the caller sorts exactly once with the
 * eps comparator, mirroring plp_to_errprobs + qsort (lofreq_call.c:784) */
int lfq_dbl_cmp_eps(const void *a, const void *b);

typedef struct {
    int32_t min_plp_bq;
    int32_t min_bq, min_alt_bq, def_alt_bq;
    int32_t min_jq, min_alt_jq, def_alt_jq;
    int32_t use_baq, use_mq, use_sq;
    int32_t min_plp_idq;
    int32_t max_depth;   /* cap on reads per column (0 = uncapped) */
    /* screening deflation: added to every present BAQ before the merge
     * (device-BAQ mode; raises the BAQ phred = lowers the err prob, the
     * conservative direction for the candidate screen).  0 = exact. */
    int32_t baq_bias;
    /* layout parity with ingest.c's icolconf_t (the ctypes struct is
     * shared); the row path always emits ordered f64 probs and ignores
     * this flag — only the fused sweep has a screening fast mode. */
    int32_t screen_flat;
    int32_t skip_emit_counts;  /* layout parity; row path ignores it */
    double mq0_errprob;
} colconf_t;

/* row flag bits (ingest.c): 1 is_del, 2 is_refskip, 4 is_head, 8 is_tail,
 * 16 strand */

/* shared read-only context for the striped workers */
typedef struct {
    const int64_t *pos;
    const uint8_t *nt4;
    const int16_t *bq, *baq, *mq;
    const int32_t *sq;
    const uint8_t *flags;
    const int32_t *indel;
    const int16_t *iq, *dq;
    int64_t win_beg;
    const char *ref;
    int64_t ref_len;
    const colconf_t *cf;
    const int64_t *count;    /* [win_len+1] rows per position */
    const int64_t *offset;   /* [win_len+1] row offsets */
    const int64_t *order;    /* counting-sorted row indices */
    const int64_t *cols_before; /* [win_len+1] columns before position p */
    int64_t *npcol;          /* [C] kept-prob count per column */
    /* outputs */
    int64_t *o_positions, *o_coverage, *o_num_bases, *o_heads, *o_tails;
    uint8_t *o_ref_nt4, *o_cons_nt4;
    int64_t *o_fw, *o_rv, *o_alt_cnt, *o_alt_raw;
    double *o_probs;
    int64_t *o_num_ins, *o_num_dels, *o_num_non_indels, *o_num_ign;
    int64_t *o_ins_ne_sum, *o_del_ne_sum, *o_ins_ev_max, *o_del_ev_max;
} colctx_t;

/* per-event accumulation for the light consensus-indel check: we
 * approximate the max single-event cons_quals with the sum of *all* event
 * quals of the type, which upper-bounds the max event.  A column only
 * flips to indel consensus when ev > nonevent, and the Python caller
 * re-checks flagged columns exactly. */
static void process_position(const colctx_t *cx, int64_t p, int64_t ci,
                             double *probs, uint8_t *tag, double *scratch)
{
    const colconf_t *cf = cx->cf;
    int64_t n_here = cx->count[p + 1];
    if (cf->max_depth > 0 && n_here > cf->max_depth)
        n_here = cf->max_depth;  /* bam_mplp_set_maxcnt semantics */
    int64_t gpos = cx->win_beg + p;
    cx->o_positions[ci] = gpos;
    cx->o_coverage[ci] = n_here;
    char refc = (gpos < cx->ref_len) ? cx->ref[gpos] : 'N';
    uint8_t ref4;
    switch (refc) {
    case 'A': ref4 = 0; break;
    case 'C': ref4 = 1; break;
    case 'G': ref4 = 2; break;
    case 'T': ref4 = 3; break;
    default: ref4 = 4; break;
    }
    cx->o_ref_nt4[ci] = ref4;

    int64_t nb = 0, heads = 0, tails = 0;
    int64_t fw[5] = {0}, rv[5] = {0};
    double bc[5] = {0};
    int64_t acnt[5] = {0}, araw[5] = {0};
    int64_t nins = 0, ndel = 0, nnon = 0, nign = 0;
    int64_t ins_ne = 0, del_ne = 0, ins_ev = 0, del_ev = 0;
    int64_t np = 0;

    for (int64_t j = cx->offset[p]; j < cx->offset[p] + n_here; j++) {
        int64_t r = cx->order[j];
        uint8_t fl = cx->flags[r];
        int is_del = fl & 1, is_skip = fl & 2;
        int b = cx->bq[r];
        if (!is_del && !is_skip) {
            if (fl & 4) heads++;
            if (fl & 8) tails++;
            if (b >= cf->min_plp_bq) {
                nb++;
                int bb = b > 93 ? 93 : b;
                uint8_t n4 = cx->nt4[r];
                if (fl & 16) rv[n4]++; else fw[n4]++;
                double incr = 1.0 - q2p8(bb);
                if (incr == 0.0) incr = DBL_MIN;
                bc[n4] += incr;
                /* err-prob path (plp_to_errprobs) */
                if (n4 != 4) {
                    int is_alt = n4 != ref4;
                    if (is_alt) araw[n4]++;
                    if (bb >= cf->min_bq &&
                        (!is_alt || bb >= cf->min_alt_bq)) {
                        int use_b = bb;
                        if (is_alt && cf->def_alt_bq > 0)
                            use_b = cf->def_alt_bq;
                        int32_t mqe = cf->use_mq
                            ? (cx->mq[r] == 255 ? -1 : cx->mq[r]) : -1;
                        int32_t bqe = cf->use_baq ? cx->baq[r] : -1;
                        if (bqe >= 0 && cf->baq_bias)
                            bqe += cf->baq_bias;
                        int32_t sqe = cf->use_sq ? cx->sq[r] : -1;
                        /* inline quality merge (same op order as
                         * lfq_merge_quals => bit-identical) */
                        double spv = q2p_full(sqe);
                        double mpv = (mqe == 0) ? cf->mq0_errprob
                                                : q2p_full(mqe);
                        double bav = q2p_full(bqe);
                        double bpv = q2p_full(use_b);
                        double mp = mpv + (1.0 - mpv) * spv +
                            (1 - mpv) * (1 - spv) * bav +
                            (1 - mpv) * (1 - spv) * (1 - bav) * bpv;
                        int keep = 1;
                        if (cf->min_jq > 0 || cf->min_alt_jq > 0) {
                            int mqual = mp <= 0.0 ? 2147483647
                                : (int)(-10.0L * log10l((long double)mp));
                            if (mqual < cf->min_jq) keep = 0;
                            if (is_alt && mqual < cf->min_alt_jq)
                                keep = 0;
                        }
                        if (keep) {
                            if (is_alt && cf->def_alt_jq > 0)
                                mp = q2p8(cf->def_alt_jq);
                            if (is_alt) acnt[n4]++;
                            tag[np] = n4;
                            probs[np++] = mp;
                        }
                    }
                }
            }
        }
        /* light indel accounting (plp.c:1062-1192) */
        int iqv = cx->iq[r], dqv = cx->dq[r];
        if (iqv < cf->min_plp_idq || dqv < cf->min_plp_idq) {
            /* refskips count too: htslib is_del covers N ops
             * (plp.c:1062-1066 tests p->is_del) */
            if (cx->indel[r] != 0 || is_del || is_skip)
                nign++;
        } else if (cx->indel[r] > 0) {
            nins++;
            ins_ev += iqv;
            del_ne += dqv;
        } else if (cx->indel[r] < 0) {
            ndel++;
            del_ev += dqv;
            ins_ne += iqv;
        } else {
            nnon++;
            ins_ne += iqv;
            del_ne += dqv;
        }
    }
    /* regroup kept probs by nt4 (stable counting sort), reproducing
     * plp_to_errprobs's per-nt4 emission order (snpcaller.c:383-400);
     * within a group, pileup read order is preserved.  NO value sort
     * here — the caller applies the reference's eps-comparator qsort
     * (or feeds the DP unsorted, as lofreq_uniq.c:299 does). */
    {
        int64_t cnt[4] = {0}, off[4];
        for (int64_t k = 0; k < np; k++)
            cnt[tag[k]]++;
        off[0] = 0;
        for (int k = 1; k < 4; k++)
            off[k] = off[k - 1] + cnt[k - 1];
        for (int64_t k = 0; k < np; k++)
            scratch[off[tag[k]]++] = probs[k];
        memcpy(probs, scratch, np * sizeof(double));
    }
    cx->o_num_bases[ci] = nb;
    cx->o_heads[ci] = heads;
    cx->o_tails[ci] = tails;
    /* consensus: argmax, ties -> lowest index */
    int mx = 0;
    for (int k = 1; k < 5; k++)
        if (bc[k] > bc[mx]) mx = k;
    cx->o_cons_nt4[ci] = (uint8_t)mx;
    for (int k = 0; k < 5; k++) {
        cx->o_fw[ci * 5 + k] = fw[k];
        cx->o_rv[ci * 5 + k] = rv[k];
        cx->o_alt_cnt[ci * 5 + k] = acnt[k];
        cx->o_alt_raw[ci * 5 + k] = araw[k];
    }
    cx->npcol[ci] = np;
    cx->o_num_ins[ci] = nins;
    cx->o_num_dels[ci] = ndel;
    cx->o_num_non_indels[ci] = nnon;
    cx->o_num_ign[ci] = nign;
    cx->o_ins_ne_sum[ci] = ins_ne;
    cx->o_del_ne_sum[ci] = del_ne;
    cx->o_ins_ev_max[ci] = ins_ev;
    cx->o_del_ev_max[ci] = del_ev;
}

typedef struct {
    const colctx_t *cx;
    int64_t p_beg, p_end;   /* position stripe */
} colstripe_t;

static void *col_worker(void *arg)
{
    colstripe_t *st = arg;
    const colctx_t *cx = st->cx;
    int64_t ci = cx->cols_before[st->p_beg];
    /* probs land in this stripe's row span (kept <= rows) */
    double *probs = cx->o_probs + cx->offset[st->p_beg];
    int64_t span = cx->offset[st->p_end] - cx->offset[st->p_beg];
    if (span < 1)
        span = 1;
    uint8_t *tag = malloc(span);
    double *scratch = malloc(span * sizeof(double));
    if (!tag || !scratch) {
        free(tag);
        free(scratch);
        return (void *)1;
    }
    for (int64_t p = st->p_beg; p < st->p_end; p++) {
        if (cx->count[p + 1] == 0)
            continue;
        process_position(cx, p, ci, probs, tag, scratch);
        probs += cx->npcol[ci];
        ci++;
    }
    free(tag);
    free(scratch);
    return NULL;
}

static int col_threads(void)
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

/* Build columns for rows whose pos lies in [win_beg, win_end).
 *
 * Outputs (caller-preallocated, win_len = win_end - win_beg):
 *   o_positions[win_len], per-column stats arrays [win_len],
 *   o_fw/o_rv [win_len*5], o_alt_cnt/o_alt_raw [win_len*5],
 *   o_col_start [win_len+1], o_probs [n_rows] (only first total_kept used)
 * Returns C = number of covered columns (or -1 on error).
 */
int64_t lfq_build_columns(
    const int64_t *pos, const uint8_t *nt4, const int16_t *bq,
    const int16_t *baq, const int16_t *mq, const int32_t *sq,
    const uint8_t *flags, const int32_t *indel,
    const int16_t *iq, const int16_t *dq,
    int64_t n_rows, int64_t win_beg, int64_t win_end,
    const char *ref, int64_t ref_len, const colconf_t *cf,
    /* outputs */
    int64_t *o_positions, int64_t *o_coverage, int64_t *o_num_bases,
    int64_t *o_heads, int64_t *o_tails, uint8_t *o_ref_nt4,
    uint8_t *o_cons_nt4, int64_t *o_fw, int64_t *o_rv,
    int64_t *o_alt_cnt, int64_t *o_alt_raw,
    int64_t *o_col_start, double *o_probs,
    /* light indel outputs */
    int64_t *o_num_ins, int64_t *o_num_dels, int64_t *o_num_non_indels,
    int64_t *o_num_ign, int64_t *o_ins_ne_sum, int64_t *o_del_ne_sum,
    int64_t *o_ins_ev_max, int64_t *o_del_ev_max)
{
    int64_t win_len = win_end - win_beg;
    if (win_len <= 0)
        return 0;
    q2p_tab_init();

    /* pass 1: per-position row counts (counting sort) */
    int64_t *count = calloc(win_len + 1, sizeof(int64_t));
    if (!count)
        return -1;
    for (int64_t r = 0; r < n_rows; r++) {
        int64_t p = pos[r] - win_beg;
        if (p >= 0 && p < win_len)
            count[p + 1]++;
    }
    int64_t *offset = malloc((win_len + 1) * sizeof(int64_t));
    int64_t *cols_before = malloc((win_len + 1) * sizeof(int64_t));
    offset[0] = 0;
    cols_before[0] = 0;
    for (int64_t i = 0; i < win_len; i++) {
        offset[i + 1] = offset[i] + count[i + 1];
        cols_before[i + 1] = cols_before[i] + (count[i + 1] > 0);
    }
    int64_t total = offset[win_len];
    int64_t C = cols_before[win_len];
    if (C == 0) {
        o_col_start[0] = 0;
        free(count); free(offset); free(cols_before);
        return 0;
    }
    int64_t *order = malloc((total ? total : 1) * sizeof(int64_t));
    {
        int64_t *cur = malloc((win_len + 1) * sizeof(int64_t));
        memcpy(cur, offset, (win_len + 1) * sizeof(int64_t));
        for (int64_t r = 0; r < n_rows; r++) {
            int64_t p = pos[r] - win_beg;
            if (p >= 0 && p < win_len)
                order[cur[p]++] = r;
        }
        free(cur);
    }
    int64_t *npcol = malloc(C * sizeof(int64_t));

    colctx_t cx = {
        pos, nt4, bq, baq, mq, sq, flags, indel, iq, dq,
        win_beg, ref, ref_len, cf, count, offset, order, cols_before, npcol,
        o_positions, o_coverage, o_num_bases, o_heads, o_tails,
        o_ref_nt4, o_cons_nt4, o_fw, o_rv, o_alt_cnt, o_alt_raw, o_probs,
        o_num_ins, o_num_dels, o_num_non_indels, o_num_ign,
        o_ins_ne_sum, o_del_ne_sum, o_ins_ev_max, o_del_ev_max,
    };

    int nth = col_threads();
    if ((int64_t)nth > C)
        nth = (int)C;
    if (total < 65536)
        nth = 1;

    colstripe_t stripes[64];
    int n_st = 0;
    {
        /* stripe boundaries balanced by row count (offset is monotone) */
        int64_t p_cur = 0;
        for (int t = 0; t < nth && p_cur < win_len; t++) {
            int64_t target = (total * (t + 1)) / nth;
            int64_t p_end = p_cur;
            while (p_end < win_len && offset[p_end] < target)
                p_end++;
            if (t == nth - 1)
                p_end = win_len;
            if (p_end > p_cur) {
                stripes[n_st].cx = &cx;
                stripes[n_st].p_beg = p_cur;
                stripes[n_st].p_end = p_end;
                n_st++;
                p_cur = p_end;
            }
        }
        if (p_cur < win_len) {  /* remainder (defensive) */
            stripes[n_st - 1].p_end = win_len;
        }
    }

    if (n_st <= 1) {
        col_worker(&stripes[0]);
    } else {
        pthread_t tids[64];
        int started[64] = {0};
        for (int t = 1; t < n_st; t++)
            started[t] = pthread_create(&tids[t], NULL, col_worker,
                                        &stripes[t]) == 0;
        col_worker(&stripes[0]);
        for (int t = 1; t < n_st; t++) {
            if (started[t])
                pthread_join(tids[t], NULL);
            else
                col_worker(&stripes[t]);  /* serial fallback */
        }
    }

    /* compact per-stripe prob regions into a dense CSR + prefix sums */
    int64_t dense = 0;
    for (int t = 0; t < n_st; t++) {
        int64_t cb = cols_before[stripes[t].p_beg];
        int64_t ce = cols_before[stripes[t].p_end];
        int64_t stripe_np = 0;
        for (int64_t ci = cb; ci < ce; ci++)
            stripe_np += npcol[ci];
        int64_t src = offset[stripes[t].p_beg];
        if (src != dense && stripe_np)
            memmove(o_probs + dense, o_probs + src,
                    (size_t)stripe_np * sizeof(double));
        dense += stripe_np;
    }
    {
        int64_t run = 0;
        for (int64_t ci = 0; ci < C; ci++) {
            o_col_start[ci] = run;
            run += npcol[ci];
        }
        o_col_start[C] = run;
    }

    free(count);
    free(offset);
    free(cols_before);
    free(order);
    free(npcol);
    return C;
}
