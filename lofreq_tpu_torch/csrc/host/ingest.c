/* ingest.c — native BAM-record ingest: parse raw (BGZF-inflated) BAM
 * records, apply read-level filters, compute missing BAQ/IDAQ/source-qual,
 * and expand reads into flat pileup-row arrays in one pass.
 *
 * This is the framework's native data loader: the Python layer hands over a
 * concatenated [block_size int32][record] byte stream (straight out of the
 * BGZF inflater) and preallocated output arrays; everything per-read then
 * happens in C.  Semantics follow the reference's read hook + column
 * expansion (see src/lofreq/plp.c:598,797).
 *
 * Build (one shared lib with the other native kernels):
 *   gcc -O2 -shared -fPIC -o liblofreq_native.so ingest.c exact_stats.c \
 *       baq.c realign.c -lm
 */

#include <float.h>
#include <math.h>
#include <pthread.h>
#include <stdio.h>
#include <time.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>
#include <unistd.h>

/* from baq.c */
void lfq_baq_batch(
    const char *ref, int64_t ref_len, int64_t n_reads,
    const int64_t *read_pos, const uint32_t *cigars,
    const int64_t *cigar_start, const char *seqs, const uint8_t *quals,
    const int64_t *seq_start, const uint8_t *want_baq,
    const uint8_t *want_idaq, int ext_baq, double par_d, double par_e,
    uint8_t *baq_out, uint8_t *iaq_out, uint8_t *daq_out,
    uint8_t *flags_out);

/* from screen_pack.c */
uint8_t lfq_u8code_f64(double p);

/* from exact_stats.c */
void lfq_poissbin_dp_batch(
    const double *probs, const int64_t *depths, const int64_t *ks,
    const double *bonf, double sig, int64_t B, int64_t Dmax, int64_t Kmax,
    double *state, int64_t *n_done);

/* sam flags */
#define XFPAIRED 0x1
#define XFPROPER 0x2
#define XFUNMAP 0x4
#define XFREVERSE 0x10
#define XFSECONDARY 0x100
#define XFQCFAIL 0x200
#define XFDUP 0x400

#define OPM 0
#define OPI 1
#define OPD 2
#define OPN 3
#define OPS 4
#define OPH 5
#define OPEQ 7
#define OPX 8

static const char NT16_CHR[] = "=ACMGRSVTWYHKDBN";
static const uint8_t NT16_TO_NT4[16] = {4, 0, 1, 4, 2, 4, 4, 4,
                                        3, 4, 4, 4, 4, 4, 4, 4};

typedef struct {
    int32_t tid, pos;
    uint8_t mapq;
    uint16_t flag, n_cigar;
    int32_t l_qseq;
    const uint32_t *cigar;
    const uint8_t *seq4;   /* 4-bit packed */
    const uint8_t *qual;
    const uint8_t *aux;
    int64_t aux_len;
    const char *qname;
} rec_t;

static int parse_rec(const uint8_t *p, int64_t sz, rec_t *r)
{
    if (sz < 32)
        return -1;
    r->tid = *(int32_t *)(p + 0);
    r->pos = *(int32_t *)(p + 4);
    uint8_t l_read_name = p[8];
    r->mapq = p[9];
    r->n_cigar = *(uint16_t *)(p + 12);
    r->flag = *(uint16_t *)(p + 14);
    r->l_qseq = *(int32_t *)(p + 16);
    int64_t off = 32;
    r->qname = (const char *)(p + off);
    off += l_read_name;
    r->cigar = (const uint32_t *)(p + off);
    off += 4 * (int64_t)r->n_cigar;
    r->seq4 = p + off;
    off += (r->l_qseq + 1) / 2;
    r->qual = p + off;
    off += r->l_qseq;
    r->aux = p + off;
    r->aux_len = sz - off;
    return (off <= sz) ? 0 : -1;
}

static int aux_size(const uint8_t *s, const uint8_t *end)
{
    switch (*s) {
    case 'c': case 'C': case 'A': return 2;
    case 's': case 'S': return 3;
    case 'i': case 'I': case 'f': return 5;
    case 'Z': case 'H': {
        int len = 1;
        const uint8_t *q = s + 1;
        while (q < end && *q) { len++; q++; }
        return len + 1;
    }
    case 'B': {
        if (s + 6 > end) return (int)(end - s);
        int n = *(int32_t *)(s + 2);
        int esz;
        switch (s[1]) {
        case 'c': case 'C': esz = 1; break;
        case 's': case 'S': esz = 2; break;
        default: esz = 4; break;
        }
        return 1 + 5 + n * esz;
    }
    default: return 1;
    }
}

/* find aux tag; returns pointer to type byte or NULL */
static const uint8_t *aux_get(const rec_t *r, const char tag[2])
{
    const uint8_t *s = r->aux;
    const uint8_t *end = r->aux + r->aux_len;
    while (s + 3 <= end) {
        if (s[0] == (uint8_t)tag[0] && s[1] == (uint8_t)tag[1])
            return s + 2;
        s += 2 + aux_size(s + 2, end);
    }
    return NULL;
}

static int64_t aux_int(const uint8_t *t)
{
    switch (*t) {
    case 'c': return *(int8_t *)(t + 1);
    case 'C': return *(uint8_t *)(t + 1);
    case 's': return *(int16_t *)(t + 1);
    case 'S': return *(uint16_t *)(t + 1);
    case 'i': return *(int32_t *)(t + 1);
    case 'I': return *(uint32_t *)(t + 1);
    default: return 0;
    }
}

typedef struct {
    int32_t min_mq, max_mq;
    int32_t no_orphan;
    int32_t illumina13;
    int32_t use_baq;     /* compute lb if missing (or redo) */
    int32_t redo_baq;
    int32_t ext_baq;
    int32_t use_idaq;
    int32_t redo_idaq;
    int32_t use_sq;      /* compute per-read source qual */
    int32_t def_nm_q;
    int32_t sq_min_bq;   /* DEFAULT_MIN_BQ for count_cigar_ops */
    /* count '='(CEQUAL) bases as matches in the source-qual op count?
     * The reference's count_cigar_ops only handles CMATCH/CDIFF
     * (samutils.c:481,489): a '=' op falls into the warn-only branch,
     * contributing nothing (and desyncing qpos until the qpos==qlen
     * assert aborts).  Default 0 = parity: '=' bases contribute no
     * evidence (we still advance positions — reproducing the desync
     * would corrupt every later op and then abort).  1 = opt-in fix:
     * count '=' bases as matches like an M op would. */
    int32_t sq_count_eq;
    int32_t tid;         /* -1 = all */
    int64_t reg_beg, reg_end; /* region filter; reg_end<=0 = none */
    /* sorted ignore positions for source_qual (-S vcf, this chrom);
     * mismatches/indels at these positions don't count as evidence
     * (samutils.c:504-556 via var_in_ign_list) */
    const int64_t *ign_pos;
    int64_t n_ign;
    /* optional precomputed BAQ (device path): sanger-encoded (+33) values
     * at offsets seq_start[i]+i (same layout as the internal baq_all);
     * pre_have[i] != 0 marks read i as covered.  A read's lb tag still
     * wins (tags are never recomputed unless redo_baq). */
    const uint8_t *pre_baq;
    const uint8_t *pre_have;
    /* optional interval-list region filter (device-BAQ confirm: all
     * candidate clusters of a window in ONE pass).  2*n_reg int64s of
     * sorted non-overlapping [beg, end) pairs; when set it replaces the
     * single reg_beg/reg_end check. */
    const int64_t *reg_list;
    int64_t n_reg;
} ingest_conf_t;

/* record-overlaps-region check; *cur is a per-loop cursor valid because
 * records arrive position-sorted */
static int in_region(const ingest_conf_t *c, int64_t *cur,
                     int64_t pos, int64_t endpos)
{
    if (c->n_reg > 0) {
        /* advance to the first interval with end > pos */
        while (*cur < c->n_reg && c->reg_list[2 * (*cur) + 1] <= pos)
            (*cur)++;
        if (*cur >= c->n_reg)
            return 0;
        return endpos > c->reg_list[2 * (*cur)];
    }
    if (c->reg_end > 0)
        return pos < c->reg_end && endpos > c->reg_beg;
    return 1;
}

static int in_ign(const ingest_conf_t *c, int64_t pos)
{
    int64_t lo = 0, hi = c->n_ign;
    if (!c->ign_pos || hi == 0)
        return 0;
    while (lo < hi) {
        int64_t mid = (lo + hi) / 2;
        if (c->ign_pos[mid] < pos)
            lo = mid + 1;
        else
            hi = mid;
    }
    return lo < c->n_ign && c->ign_pos[lo] == pos;
}

static int read_kept(const rec_t *r, const ingest_conf_t *c)
{
    if (r->tid < 0 || (r->flag & XFUNMAP))
        return 0;
    if (r->flag & (XFUNMAP | XFSECONDARY | XFQCFAIL | XFDUP))
        return 0;
    /* plp.c:707-720 is an else-if chain: a read whose MQ exceeds the
     * cap is capped and accepted — it bypasses BOTH the min-mq skip
     * and the orphan skip */
    if (r->mapq <= c->max_mq) {
        if (r->mapq < c->min_mq)
            return 0;
        if (c->no_orphan && (r->flag & XFPAIRED) && !(r->flag & XFPROPER))
            return 0;
    }
    if (c->tid >= 0 && r->tid != c->tid)
        return 0;
    return 1;
}

static int64_t rec_endpos(const rec_t *r)
{
    int64_t x = r->pos;
    for (int k = 0; k < r->n_cigar; k++) {
        int op = r->cigar[k] & 0xf, l = r->cigar[k] >> 4;
        if (op == OPM || op == OPD || op == OPN || op == OPEQ || op == OPX)
            x += l;
    }
    return x;
}

/* count rows + events for one read */
static void count_read(const rec_t *r, int64_t *nrows, int64_t *nev,
                       int64_t *ev_seq_len)
{
    int prev_aligned = 0;
    int64_t rows = 0;
    for (int k = 0; k < r->n_cigar; k++) {
        int op = r->cigar[k] & 0xf, l = r->cigar[k] >> 4;
        if (op == OPM || op == OPEQ || op == OPX) {
            rows += l;
            prev_aligned = 1;
        } else if (op == OPI) {
            if (prev_aligned && rows > 0) {
                (*nev)++;
                (*ev_seq_len) += l;
            }
            prev_aligned = 0;
        } else if (op == OPD) {
            if (prev_aligned && rows > 0)
                (*nev)++;
            rows += l;
            prev_aligned = 0;
        } else if (op == OPN) {
            rows += l;
            prev_aligned = 0;
        } else {
            prev_aligned = 0;
        }
    }
    *nrows += rows;
}

/* Pass 1: scan stream, count kept reads/rows/events.
 * out_counts: [n_reads_kept, n_rows, n_events, ev_seq_total, seq_total] */
int64_t lfq_ingest_count(const uint8_t *buf, int64_t buflen,
                         const ingest_conf_t *conf, int64_t *out_counts)
{
    int64_t off = 0;
    int64_t nreads = 0, nrows = 0, nev = 0, evseq = 0, seqtot = 0;
    int64_t regcur = 0;
    while (off + 4 <= buflen) {
        int32_t sz = *(int32_t *)(buf + off);
        off += 4;
        if (off + sz > buflen)
            return -1;
        rec_t r;
        if (parse_rec(buf + off, sz, &r) == 0 && read_kept(&r, conf)) {
            if (in_region(conf, &regcur, r.pos, rec_endpos(&r))) {
                nreads++;
                seqtot += r.l_qseq;
                count_read(&r, &nrows, &nev, &evseq);
            }
        }
        off += sz;
    }
    out_counts[0] = nreads;
    out_counts[1] = nrows;
    out_counts[2] = nev;
    out_counts[3] = evseq;
    out_counts[4] = seqtot;
    return 0;
}

/* Byte ranges of records possibly overlapping any [beg, end) interval
 * of reg[2*n_reg] (sorted, non-overlapping) on tid, over a pos-sorted
 * raw [size][record] stream.  Emits merged (start, end) byte-range
 * pairs into ranges (capacity max_ranges pairs); returns the pair
 * count, or -1 on a corrupt stream / capacity overflow (callers fall
 * back to the full blob).  The selection is a conservative SUPERSET —
 * later passes re-apply read filters and the interval check — so the
 * exact-confirm re-ingest (confirm_snv_candidates) can parse ~the
 * cluster reads instead of re-walking the whole window's records. */
int64_t lfq_raw_ranges(const uint8_t *buf, int64_t buflen, int32_t tid,
                       const int64_t *reg, int64_t n_reg,
                       int64_t *ranges, int64_t max_ranges)
{
    if (n_reg <= 0)
        return 0;
    int64_t hi = reg[2 * n_reg - 1];
    int64_t off = 0, nr = 0, ri = 0;
    const int64_t MERGE_GAP = 65536; /* few skipped records re-parse
                                        cheaper than extra ranges */
    while (off + 4 <= buflen) {
        int64_t rec_start = off;
        int32_t sz = *(int32_t *)(buf + off);
        off += 4;
        if (sz < 0 || off + sz > buflen)
            return -1;
        rec_t r;
        int keep = 0;
        if (parse_rec(buf + off, sz, &r) == 0 && r.tid == tid) {
            if (r.pos >= hi)
                break;  /* pos-sorted: nothing later can overlap */
            int64_t ep = rec_endpos(&r);
            /* intervals ending at or before pos can't overlap this or
             * any later (pos-nondecreasing) record */
            while (ri < n_reg && reg[2 * ri + 1] <= r.pos)
                ri++;
            if (ri >= n_reg)
                break;
            keep = ep > reg[2 * ri];
        }
        off += sz;
        if (keep) {
            if (nr && rec_start - ranges[2 * nr - 1] <= MERGE_GAP) {
                ranges[2 * nr - 1] = off;
            } else {
                if (nr >= max_ranges)
                    return -1;
                ranges[2 * nr] = rec_start;
                ranges[2 * nr + 1] = off;
                nr++;
            }
        }
    }
    return nr;
}

/* source qual for one read (plp.c:427-593 semantics incl. ign-list) */
static int source_qual_one(const rec_t *r, const char *ref, int64_t ref_len,
                           int def_nm_q, int min_bq,
                           const ingest_conf_t *cf)
{
    int n = 0, nonmatch = 0;
    int cap = r->l_qseq + r->n_cigar + 1;
    double *probs = malloc(cap * sizeof(double));
    /* op category per emitted prob (samutils.h: MATCH/MISMATCH/INS/DEL);
     * the reference emits err_probs grouped by category (plp.c:486-508)
     * before the eps-comparator qsort, which is observable in near-tie
     * ordering */
    uint8_t *cats = malloc(cap);
    int64_t tpos = r->pos;
    int qpos = 0;
    for (int k = 0; k < r->n_cigar; k++) {
        int op = r->cigar[k] & 0xf, l = r->cigar[k] >> 4;
        if (op == OPM || op == OPEQ || op == OPX) {
            if (op == OPEQ && !cf->sq_count_eq) {
                /* reference parity: CEQUAL is unhandled by
                 * count_cigar_ops (samutils.c:481-489 covers only
                 * CMATCH/CDIFF) so '=' bases contribute no evidence */
                tpos += l;
                qpos += l;
                continue;
            }
            for (int j = 0; j < l; j++) {
                char rb = (tpos + j < ref_len) ? ref[tpos + j] : 'N';
                char qb = NT16_CHR[(r->seq4[(qpos + j) >> 1] >>
                                    ((~(qpos + j) & 1) << 2)) & 0xf];
                int bq = r->qual[qpos + j];
                int mism = (rb != qb) || (op == OPX);
                if (bq < min_bq)
                    continue;
                if (mism && in_ign(cf, tpos + j))
                    continue;  /* known variant: no evidence either way */
                int q = (def_nm_q >= 0) ? def_nm_q : bq;
                cats[n] = mism ? 1 : 0;
                probs[n++] = pow(10.0, -1.0 * q / 10.0);
                if (mism)
                    nonmatch++;
            }
            tpos += l;
            qpos += l;
        } else if (op == OPI || op == OPD) {
            /* ins keyed at tpos-1, del at tpos (samutils.c:540-556).
             * Reference quirk: an ign-listed DELETION 'continue's
             * WITHOUT advancing tpos (samutils.c:548-556), shifting
             * every later ref comparison in the read — reproduced for
             * bit-identity (test_source_qual_differential) */
            if (in_ign(cf, op == OPI ? tpos - 1 : tpos)) {
                if (op == OPI)
                    qpos += l;
                continue;
            }
            int q = (def_nm_q >= 0) ? def_nm_q : 45 /* INDEL_QUAL_DEFAULT */;
            cats[n] = (op == OPI) ? 2 : 3;
            probs[n++] = pow(10.0, -1.0 * q / 10.0);
            nonmatch++;
            if (op == OPI)
                qpos += l;
            else
                tpos += l;
        } else if (op == OPN) {
            tpos += l;
        } else if (op == OPS) {
            qpos += l;
        }
    }
    int sq;
    if (n < 1) {
        sq = 0;
    } else if (nonmatch <= 1) {
        /* PROB_TO_PHREDQUAL(LDBL_MIN) */
        sq = (int)(-10.0L * log10l(LDBL_MIN));
    } else {
        nonmatch -= 1;
        /* regroup by op category (stable), reproducing the reference's
         * emission order, then the eps-comparator qsort (plp.c:553) */
        {
            double *tmp = malloc(n * sizeof(double));
            int cnt[4] = {0}, off[4];
            for (int k = 0; k < n; k++)
                cnt[cats[k]]++;
            off[0] = 0;
            for (int k = 1; k < 4; k++)
                off[k] = off[k - 1] + cnt[k - 1];
            for (int k = 0; k < n; k++)
                tmp[off[cats[k]]++] = probs[k];
            memcpy(probs, tmp, n * sizeof(double));
            free(tmp);
        }
        extern int lfq_dbl_cmp_eps(const void *a, const void *b);
        qsort(probs, n, sizeof(double), lfq_dbl_cmp_eps);
        int64_t depth = n, kk = nonmatch, ndone;
        double bonf = 1.0;
        double *state = malloc((nonmatch + 1) * sizeof(double));
        lfq_poissbin_dp_batch(probs, &depth, &kk, &bonf, 0.05, 1, n,
                              nonmatch, state, &ndone);
        double src_prob = exp(state[nonmatch - 1]);
        if (src_prob == 0.0)
            src_prob = DBL_MIN;
        free(state);
        long double p = 1.0L - (long double)src_prob;
        sq = (p <= 0.0L) ? 2147483647 : (int)(-10.0L * log10l(p));
        if (sq < 0)
            sq = 0;
    }
    free(probs);
    free(cats);
    return sq;
}

/* ---- row expansion (pass 2 inner loop) -------------------------------- */

static void fill16(int16_t *p, int64_t n, int16_t v)
{
    for (int64_t j = 0; j < n; j++)
        p[j] = v;
}

static void fill32(int32_t *p, int64_t n, int32_t v)
{
    for (int64_t j = 0; j < n; j++)
        p[j] = v;
}

static void fill64(int64_t *p, int64_t n, int64_t v)
{
    for (int64_t j = 0; j < n; j++)
        p[j] = v;
}

static void fill_iota64(int64_t *p, int64_t n, int64_t x0)
{
    for (int64_t j = 0; j < n; j++)
        p[j] = x0 + j;
}

static uint8_t CODE256[256];
static pthread_once_t code256_once = PTHREAD_ONCE_INIT;
static void code256_init(void)
{
    memset(CODE256, 4, sizeof(CODE256));
    CODE256['A'] = 0;
    CODE256['C'] = 1;
    CODE256['G'] = 2;
    CODE256['T'] = 3;
}

typedef struct {
    const rec_t *recs;
    const char *seqs;
    const uint8_t *quals;
    const int64_t *seq_start;
    const uint8_t *baq_all, *iaq_all, *daq_all, *have;
    const int64_t *row_off, *ev_off, *evs_off;
    const ingest_conf_t *conf;
    const char *ref;
    int64_t ref_len;
    int64_t *o_pos;
    uint8_t *o_nt4;
    int16_t *o_bq, *o_baq, *o_mq;
    int32_t *o_sq;
    uint8_t *o_flags;
    int32_t *o_indel;
    int16_t *o_iq, *o_dq, *o_iaq, *o_daq;
    int64_t *o_event_id;
    uint8_t *o_ev_isins;
    int64_t *o_ev_seq_start;
    uint8_t *o_ev_seq;
} expand_ctx_t;

static void expand_read(const expand_ctx_t *cx, int64_t i)
{
    const rec_t *r = &cx->recs[i];
    const ingest_conf_t *conf = cx->conf;
    int64_t s0 = cx->seq_start[i];
    int64_t tago = s0 + i;
    int strand = (r->flag & XFREVERSE) ? 1 : 0;
    int16_t mq = r->mapq > conf->max_mq ? conf->max_mq : r->mapq;
    int32_t sq = -1;
    const uint8_t *sqt = aux_get(r, "sq");
    if (sqt)
        sq = (int32_t)aux_int(sqt);
    else if (conf->use_sq)
        sq = source_qual_one(r, cx->ref, cx->ref_len, conf->def_nm_q,
                             conf->sq_min_bq, conf);
    const uint8_t *bi = NULL, *bd = NULL;
    const uint8_t *t;
    if ((t = aux_get(r, "BI")) && *t == 'Z') bi = t + 1;
    if ((t = aux_get(r, "BD")) && *t == 'Z') bd = t + 1;
    int have = cx->have[i];
    uint8_t flbase = (uint8_t)((strand ? 16 : 0) | ((have & 2) ? 32 : 0) |
                               ((have & 4) ? 64 : 0));

    int64_t row = cx->row_off[i], row0 = row;
    int64_t nev = cx->ev_off[i];
    int64_t evseq_off = cx->evs_off[i];
    int64_t x = r->pos;
    int y = 0;
    int prev_aligned = 0;
    for (int k = 0; k < r->n_cigar; k++) {
        int op = r->cigar[k] & 0xf;
        int64_t l = r->cigar[k] >> 4;
        if (op == OPM || op == OPEQ || op == OPX) {
            fill_iota64(cx->o_pos + row, l, x);
            const char *sp = cx->seqs + s0 + y;
            uint8_t *ntp = cx->o_nt4 + row;
            for (int64_t j = 0; j < l; j++)
                ntp[j] = CODE256[(uint8_t)sp[j]];
            const uint8_t *qp = cx->quals + s0 + y;
            int16_t *bqp = cx->o_bq + row;
            for (int64_t j = 0; j < l; j++)
                bqp[j] = qp[j];
            if (have & 1) {
                const uint8_t *bp = cx->baq_all + tago + y;
                int16_t *bap = cx->o_baq + row;
                for (int64_t j = 0; j < l; j++)
                    bap[j] = (int16_t)bp[j] - 33;
            } else {
                fill16(cx->o_baq + row, l, -1);
            }
            fill16(cx->o_mq + row, l, mq);
            fill32(cx->o_sq + row, l, sq);
            memset(cx->o_flags + row, flbase, l);
            fill32(cx->o_indel + row, l, 0);
            if (bi) {
                int16_t *iqp = cx->o_iq + row;
                for (int64_t j = 0; j < l; j++)
                    iqp[j] = (int16_t)bi[y + j] - 33;
            } else {
                fill16(cx->o_iq + row, l, 0);
            }
            if (bd) {
                int16_t *dqp = cx->o_dq + row;
                for (int64_t j = 0; j < l; j++)
                    dqp[j] = (int16_t)bd[y + j] - 33;
            } else {
                fill16(cx->o_dq + row, l, 0);
            }
            fill16(cx->o_iaq + row, l, -1);
            fill16(cx->o_daq + row, l, -1);
            fill64(cx->o_event_id + row, l, -1);
            row += l;
            x += l;
            y += l;
            prev_aligned = 1;
        } else if (op == OPI) {
            if (prev_aligned && row > row0) {
                cx->o_indel[row - 1] = (int32_t)l;
                cx->o_event_id[row - 1] = nev;
                cx->o_iaq[row - 1] = (have & 2)
                    ? (int16_t)cx->iaq_all[tago + (y - 1)] - 33 : -1;
                cx->o_ev_isins[nev] = 1;
                cx->o_ev_seq_start[nev] = evseq_off;
                memcpy(cx->o_ev_seq + evseq_off, cx->seqs + s0 + y,
                       (size_t)l);
                evseq_off += l;
                nev++;
            }
            y += l;
            prev_aligned = 0;
        } else if (op == OPD || op == OPN) {
            if (op == OPD && prev_aligned && row > row0) {
                cx->o_indel[row - 1] = (int32_t)(-l);
                cx->o_event_id[row - 1] = nev;
                cx->o_daq[row - 1] = (have & 4)
                    ? (int16_t)cx->daq_all[tago + (y - 1)] - 33 : -1;
                cx->o_ev_isins[nev] = 0;
                cx->o_ev_seq_start[nev] = evseq_off;
                nev++;
            }
            /* htslib pileup: a deleted/refskip column's qpos is the
             * NEXT query base (y does not advance through D/N) — where
             * compile_plp_col reads BI/BD (plp.c:1024,1038); verified
             * by test_plp_differential.  Tag strings have a NUL at
             * [l_qseq], matching the reference when D ends the cigar. */
            int64_t qpd = y;
            int64_t qpb = y < r->l_qseq ? y : (r->l_qseq - 1);
            uint8_t fl = (op == OPD) ? (uint8_t)(1 | flbase)
                                     : (uint8_t)(2 | (strand ? 16 : 0));
            fill_iota64(cx->o_pos + row, l, x);
            memset(cx->o_nt4 + row, 4, l);
            fill16(cx->o_bq + row, l, cx->quals[s0 + qpb]);
            fill16(cx->o_baq + row, l, -1);
            fill16(cx->o_mq + row, l, mq);
            fill32(cx->o_sq + row, l, sq);
            memset(cx->o_flags + row, fl, l);
            fill32(cx->o_indel + row, l, 0);
            fill16(cx->o_iq + row, l, bi ? (int16_t)bi[qpd] - 33 : 0);
            fill16(cx->o_dq + row, l, bd ? (int16_t)bd[qpd] - 33 : 0);
            fill16(cx->o_iaq + row, l, -1);
            fill16(cx->o_daq + row, l, -1);
            fill64(cx->o_event_id + row, l, -1);
            row += l;
            x += l;
            prev_aligned = 0;
        } else if (op == OPS) {
            y += l;
            prev_aligned = 0;
        } else {
            prev_aligned = 0;
        }
    }
    if (row > row0) {
        cx->o_flags[row0] |= 4;      /* is_head */
        cx->o_flags[row - 1] |= 8;   /* is_tail */
    }
}

static void expand_range(const expand_ctx_t *cx, int64_t i0, int64_t i1)
{
    for (int64_t i = i0; i < i1; i++)
        expand_read(cx, i);
}

typedef struct {
    const expand_ctx_t *cx;
    int64_t i0, i1;
} expand_job_t;

static void *expand_worker(void *arg)
{
    expand_job_t *j = arg;
    expand_range(j->cx, j->i0, j->i1);
    return NULL;
}

/* same knob as the BAQ/column stripes (LOFREQ_NATIVE_THREADS) */
static int ingest_threads(void)
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

/* Pass 2: fill row arrays.  All outputs preallocated by the caller using
 * the pass-1 counts.  Row field arrays have length n_rows; event arrays
 * n_events; ev_seq buffer ev_seq_total bytes.
 *
 * row_flags bits: 1 is_del, 2 is_refskip, 4 is_head, 8 is_tail, 16 strand,
 *                 32 has_ai, 64 has_ad
 */

/* thread-local grow-only scratch arenas: pass A re-allocates ~0.5 GB of
 * mallocs per window otherwise, and first-touch page faults are expensive
 * in a microVM.  One live prep per thread (prefetch worker / main). */
typedef struct { void *p; size_t cap; } arena_t;

static void *arena_get(arena_t *a, size_t need)
{
    if (need == 0)
        need = 1;
    if (a->cap < need) {
        free(a->p);
        a->p = malloc(need + need / 4);
        a->cap = a->p ? need + need / 4 : 0;
    }
    return a->p;
}

/* ---- pass A: collect kept reads, decode scratch, resolve BAQ/IDAQ ---- */

typedef struct {
    const rec_t *recs;
    char *seqs;
    uint8_t *quals;
    uint32_t *cigars;
    const int64_t *seq_start, *cigar_start;
    int illumina13;
    int64_t i0, i1;
} prep_decode_job_t;

/* two decoded base chars per packed byte (little-endian: first base in
 * the low byte) — halves the iterations of the inner decode loop */
static uint16_t NT16_PAIR[256];
static pthread_once_t nt16pair_once = PTHREAD_ONCE_INIT;
static void nt16pair_init(void)
{
    for (int b = 0; b < 256; b++)
        NT16_PAIR[b] = (uint16_t)((uint8_t)NT16_CHR[b >> 4]
                       | ((uint16_t)(uint8_t)NT16_CHR[b & 0xf] << 8));
}

static void *prep_decode_worker(void *arg)
{
    prep_decode_job_t *j = arg;
    for (int64_t i = j->i0; i < j->i1; i++) {
        const rec_t *r = &j->recs[i];
        int64_t s0 = j->seq_start[i];
        int64_t l = r->l_qseq;
        char *dst = j->seqs + s0;
        const uint8_t *s4 = r->seq4;
        int64_t k = 0;
        for (; k + 1 < l; k += 2)
            memcpy(dst + k, &NT16_PAIR[s4[k >> 1]], 2);
        if (k < l)
            dst[k] = NT16_CHR[(s4[k >> 1] >> 4) & 0xf];
        if (j->illumina13) {
            for (int k = 0; k < r->l_qseq; k++) {
                uint8_t q = r->qual[k];
                j->quals[s0 + k] = q > 31 ? q - 31 : 0;
            }
        } else {
            memcpy(j->quals + s0, r->qual, (size_t)r->l_qseq);
        }
        memcpy(j->cigars + j->cigar_start[i], r->cigar,
               4 * (size_t)r->n_cigar);
    }
    return NULL;
}

typedef struct {
    rec_t *recs;
    int64_t nreads;
    int64_t seqtot;
    char *seqs;
    uint8_t *quals;
    int64_t *seq_start, *cigar_start, *read_pos;
    uint32_t *cigars;
    uint8_t *baq_all, *iaq_all, *daq_all;
    uint8_t *have;   /* 1 lb, 2 ai, 4 ad */
} prep_t;

static void prep_free(prep_t *pp)
{
    /* all members live in the calling thread's grow-only arenas */
    (void)pp;
}

static int prep_build(const uint8_t *buf, int64_t buflen,
                      const ingest_conf_t *conf, const char *ref,
                      int64_t ref_len, prep_t *pp)
{
    static _Thread_local arena_t ar_recs, ar_seqs, ar_quals, ar_ss, ar_cs,
        ar_rp, ar_cig, ar_baq, ar_iaq, ar_daq, ar_have;
    struct timespec _ts; double _t0, _t1;
    const char *_dbg = getenv("LOFREQ_PREP_PHASE");
    clock_gettime(CLOCK_MONOTONIC, &_ts);
    _t0 = _ts.tv_sec + 1e-9 * _ts.tv_nsec;
    #define PPH(name) do { if (_dbg) { \
        clock_gettime(CLOCK_MONOTONIC, &_ts); \
        _t1 = _ts.tv_sec + 1e-9 * _ts.tv_nsec; \
        fprintf(stderr, "PREP%d%d %s: %.4f\n", conf->use_baq, conf->use_idaq, name, _t1 - _t0); \
        _t0 = _t1; } } while (0)
    memset(pp, 0, sizeof(*pp));
    /* first collect kept reads (pointers) so BAQ can run as one batch.
     * One streaming pass: the recs arena is sized by the minimum BAM
     * record size (32-byte fixed header + 4-byte length prefix), which
     * skips a separate counting walk over the raw bytes.  (A striped
     * parallel parse was tried here and measured 2x SLOWER on the
     * 4-core bench host — the scan is memory-bound and the temp-array
     * staging tripled the traffic.) */
    rec_t *recs = arena_get(&ar_recs,
                            (buflen / 36 + 2) * sizeof(rec_t));
    int64_t nreads = 0;
    {
        int64_t off = 0;
        int64_t regcur = 0;
        while (off + 4 <= buflen) {
            int32_t sz = *(int32_t *)(buf + off);
            off += 4;
            rec_t r;
            if (parse_rec(buf + off, sz, &r) == 0 && read_kept(&r, conf)) {
                if (in_region(conf, &regcur, r.pos, rec_endpos(&r)))
                    recs[nreads++] = r;
            }
            off += sz;
        }
    }
    PPH("scan");

    /* per-read scratch: decoded seq chars + (possibly rescaled) quals.
     * Prefix sums serial; the byte-level decode striped across threads. */
    int64_t seqtot = 0;
    for (int64_t i = 0; i < nreads; i++)
        seqtot += recs[i].l_qseq;
    char *seqs = arena_get(&ar_seqs, seqtot + 1);
    uint8_t *quals = arena_get(&ar_quals, seqtot + 1);
    int64_t *seq_start = arena_get(&ar_ss, (nreads + 1) * sizeof(int64_t));
    int64_t *cigar_start = arena_get(&ar_cs,
                                     (nreads + 1) * sizeof(int64_t));
    int64_t *read_pos = arena_get(&ar_rp, (nreads + 1) * sizeof(int64_t));
    int64_t ncig_tot = 0;
    seq_start[0] = 0;
    cigar_start[0] = 0;
    for (int64_t i = 0; i < nreads; i++) {
        seq_start[i + 1] = seq_start[i] + recs[i].l_qseq;
        ncig_tot += recs[i].n_cigar;
        cigar_start[i + 1] = ncig_tot;
        read_pos[i] = recs[i].pos;
    }
    uint32_t *cigars = arena_get(&ar_cig,
                                 (ncig_tot + 1) * sizeof(uint32_t));
    PPH("alloc");
    {
        pthread_once(&nt16pair_once, nt16pair_init);
        prep_decode_job_t jobs[64];
        pthread_t tids[64];
        int nth = ingest_threads();
        if ((int64_t)nth > nreads)
            nth = nreads > 0 ? (int)nreads : 1;
        int started[64];
        for (int t = 0; t < nth; t++) {
            jobs[t] = (prep_decode_job_t){
                recs, seqs, quals, cigars, seq_start, cigar_start,
                conf->illumina13, nreads * t / nth,
                nreads * (t + 1) / nth};
            started[t] = (t > 0) && pthread_create(
                &tids[t], NULL, prep_decode_worker, &jobs[t]) == 0;
        }
        prep_decode_worker(&jobs[0]);
        for (int t = 1; t < nth; t++) {
            if (started[t])
                pthread_join(tids[t], NULL);
            else
                prep_decode_worker(&jobs[t]);
        }
    }

    PPH("decode");
    /* BAQ/IDAQ: reuse tags when present, compute otherwise */
    /* values only read under the matching have[] bit, which implies the
     * producer wrote the full read -> no zeroing of the big buffers */
    uint8_t *baq_all = arena_get(&ar_baq, seqtot + nreads + 1);
    uint8_t *iaq_all = arena_get(&ar_iaq, seqtot + nreads + 1);
    uint8_t *daq_all = arena_get(&ar_daq, seqtot + nreads + 1);
    uint8_t *have = arena_get(&ar_have, nreads ? nreads : 1);
    memset(have, 0, nreads ? nreads : 1); /* 1 lb, 2 ai, 4 ad */
    if (conf->use_baq || conf->use_idaq) {
        uint8_t *want_baq = calloc(nreads, 1);
        uint8_t *want_idaq = calloc(nreads, 1);
        for (int64_t i = 0; i < nreads; i++) {
            rec_t *r = &recs[i];
            int64_t o = seq_start[i] + i;
            const uint8_t *t;
            if (!conf->redo_baq && (t = aux_get(r, "lb")) && *t == 'Z') {
                memcpy(baq_all + o, t + 1, r->l_qseq);
                have[i] |= 1;
            }
            if (!conf->redo_idaq && (t = aux_get(r, "ai")) && *t == 'Z') {
                memcpy(iaq_all + o, t + 1, r->l_qseq);
                have[i] |= 2;
            }
            if (!conf->redo_idaq && (t = aux_get(r, "ad")) && *t == 'Z') {
                memcpy(daq_all + o, t + 1, r->l_qseq);
                have[i] |= 4;
            }
            if (!(have[i] & 1) && conf->pre_have && conf->pre_have[i]) {
                /* device-computed BAQ spliced in (lb tag wins above) */
                memcpy(baq_all + o, conf->pre_baq + o, r->l_qseq);
                have[i] |= 1;
            }
            int has_ins = 0, has_del = 0;
            for (int k = 0; k < r->n_cigar; k++) {
                int op = r->cigar[k] & 0xf;
                if (op == OPI) has_ins = 1;
                if (op == OPD) has_del = 1;
            }
            want_baq[i] = conf->use_baq && !(have[i] & 1);
            int need_ai = conf->use_idaq && has_ins && !(have[i] & 2);
            int need_ad = conf->use_idaq && has_del && !(have[i] & 4);
            want_idaq[i] = need_ai || need_ad;
        }
        /* run the HMM only for reads needing something */
        uint8_t *flags = calloc((size_t)nreads, 1);
        lfq_baq_batch(ref, ref_len, nreads, read_pos, cigars, cigar_start,
                      seqs, quals, seq_start, want_baq, want_idaq,
                      conf->ext_baq, 0.00001, 0.4,
                      baq_all, iaq_all, daq_all, flags);
        for (int64_t i = 0; i < nreads; i++) {
            if (flags[i] & 1) have[i] |= 1;
            if (flags[i] & 2) have[i] |= 2;
            if (flags[i] & 4) have[i] |= 4;
        }
        free(want_baq);
        free(want_idaq);
        free(flags);
    }

    PPH("baqtags");
    #undef PPH
    pp->recs = recs;
    pp->nreads = nreads;
    pp->seqtot = seqtot;
    pp->seqs = seqs;
    pp->quals = quals;
    pp->seq_start = seq_start;
    pp->cigar_start = cigar_start;
    pp->read_pos = read_pos;
    pp->cigars = cigars;
    pp->baq_all = baq_all;
    pp->iaq_all = iaq_all;
    pp->daq_all = daq_all;
    pp->have = have;
    return 0;
}

int64_t lfq_ingest_fill(
    const uint8_t *buf, int64_t buflen, const ingest_conf_t *conf,
    const char *ref, int64_t ref_len,
    /* row outputs */
    int64_t *o_pos, uint8_t *o_nt4, int16_t *o_bq, int16_t *o_baq,
    int16_t *o_mq, int32_t *o_sq, uint8_t *o_flags, int32_t *o_indel,
    int16_t *o_iq, int16_t *o_dq, int16_t *o_iaq, int16_t *o_daq,
    int64_t *o_event_id,
    /* event outputs */
    uint8_t *o_ev_isins, int64_t *o_ev_seq_start, uint8_t *o_ev_seq,
    int64_t *out_counts)
{
    prep_t pp;
    if (prep_build(buf, buflen, conf, ref, ref_len, &pp) != 0)
        return -1;
    rec_t *recs = pp.recs;
    int64_t nreads = pp.nreads;
    char *seqs = pp.seqs;
    uint8_t *quals = pp.quals;
    int64_t *seq_start = pp.seq_start;
    int64_t *cigar_start = pp.cigar_start;
    int64_t *read_pos = pp.read_pos;
    uint32_t *cigars = pp.cigars;
    uint8_t *baq_all = pp.baq_all, *iaq_all = pp.iaq_all,
            *daq_all = pp.daq_all;
    uint8_t *have = pp.have;
    (void)read_pos; (void)cigars; (void)cigar_start;

    /* expand rows: per-read output offsets (prefix sums of count_read),
     * then striped pthread workers.  Each field is written in its own
     * tight per-run loop — one interleaved 13-stream store loop exhausts
     * the CPU's line-fill buffers (measured 15-25x slower than this
     * split form on 96M rows). */
    pthread_once(&code256_once, code256_init);
    int64_t *row_off = malloc((nreads + 1) * sizeof(int64_t));
    int64_t *ev_off = malloc((nreads + 1) * sizeof(int64_t));
    int64_t *evs_off = malloc((nreads + 1) * sizeof(int64_t));
    row_off[0] = ev_off[0] = evs_off[0] = 0;
    for (int64_t i = 0; i < nreads; i++) {
        int64_t nr = 0, ne = 0, nb = 0;
        count_read(&recs[i], &nr, &ne, &nb);
        row_off[i + 1] = row_off[i] + nr;
        ev_off[i + 1] = ev_off[i] + ne;
        evs_off[i + 1] = evs_off[i] + nb;
    }

    expand_ctx_t cx = {
        .recs = recs, .seqs = seqs, .quals = quals,
        .seq_start = seq_start, .baq_all = baq_all, .iaq_all = iaq_all,
        .daq_all = daq_all, .have = have,
        .row_off = row_off, .ev_off = ev_off, .evs_off = evs_off,
        .conf = conf, .ref = ref, .ref_len = ref_len,
        .o_pos = o_pos, .o_nt4 = o_nt4, .o_bq = o_bq, .o_baq = o_baq,
        .o_mq = o_mq, .o_sq = o_sq, .o_flags = o_flags,
        .o_indel = o_indel, .o_iq = o_iq, .o_dq = o_dq, .o_iaq = o_iaq,
        .o_daq = o_daq, .o_event_id = o_event_id,
        .o_ev_isins = o_ev_isins, .o_ev_seq_start = o_ev_seq_start,
        .o_ev_seq = o_ev_seq,
    };
    int nth = ingest_threads();
    if ((int64_t)nth > nreads)
        nth = nreads > 0 ? (int)nreads : 1;
    if (nth <= 1) {
        expand_range(&cx, 0, nreads);
    } else {
        pthread_t tids[64];
        expand_job_t jobs[64];
        int started[64];
        for (int t = 0; t < nth; t++) {
            jobs[t].cx = &cx;
            jobs[t].i0 = nreads * t / nth;
            jobs[t].i1 = nreads * (t + 1) / nth;
            started[t] = pthread_create(&tids[t], NULL, expand_worker,
                                        &jobs[t]) == 0;
            if (!started[t])
                expand_range(&cx, jobs[t].i0, jobs[t].i1);
        }
        for (int t = 0; t < nth; t++)
            if (started[t])
                pthread_join(tids[t], NULL);
    }
    int64_t row = row_off[nreads];
    int64_t nev = ev_off[nreads];
    int64_t evseq_off = evs_off[nreads];
    o_ev_seq_start[nev] = evseq_off;

    free(row_off); free(ev_off); free(evs_off);
    prep_free(&pp);  /* arena-owned; see prep_build */
    out_counts[0] = nreads;
    out_counts[1] = row;
    out_counts[2] = nev;
    out_counts[3] = evseq_off;
    return 0;
}

/* Dominant query length among kept reads (mode; ties -> longer).
 * Used to pick the device-BAQ length bucket. */
int32_t lfq_mode_read_len(const uint8_t *buf, int64_t buflen,
                          const ingest_conf_t *conf)
{
    enum { MAXL = 4096 };
    static _Thread_local int64_t hist[MAXL];
    memset(hist, 0, sizeof(hist));
    int64_t off = 0;
    int64_t regcur = 0;
    while (off + 4 <= buflen) {
        int32_t sz = *(int32_t *)(buf + off);
        off += 4;
        if (off + sz > buflen)
            return -1;
        rec_t r;
        if (parse_rec(buf + off, sz, &r) == 0 && read_kept(&r, conf) &&
            in_region(conf, &regcur, r.pos, rec_endpos(&r))) {
            if (r.l_qseq > 0 && r.l_qseq < MAXL)
                hist[r.l_qseq]++;
        }
        off += sz;
    }
    int32_t best = 0;
    for (int32_t l = 1; l < MAXL; l++)
        if (hist[l] >= hist[best])
            best = l;
    return hist[best] ? best : 0;
}

/* Extract device-BAQ-eligible reads.  Iterates kept reads in the same
 * order as lfq_ingest_fill.  o_elig[i]=1 for reads the device BAQ kernel
 * can handle: a single M/=/X cigar op spanning l_qseq == L, BAQ wanted
 * (no reusable lb tag).  For those, base codes (A0 C1 G2 T3 else 4) and
 * illumina13-rescaled quals are written at stride L, and [o_xb, o_xe) is
 * the glocal reference window (realn_one's band arithmetic, baq.c:422-438,
 * for the M-only case: pos-3 .. pos+L+3, clamped to the contig).
 * Returns the kept-read count. */
typedef struct {
    const rec_t *recs;
    const ingest_conf_t *conf;
    int64_t ref_len;
    int32_t L;
    uint8_t *o_elig;
    int64_t *o_pos;
    int32_t *o_lq;
    uint8_t *o_codes, *o_quals;
    int64_t *o_xb, *o_xe;
    int64_t i0, i1;
} extract_job_t;

static void *extract_worker(void *arg)
{
    static const uint8_t code16[16] = {4, 0, 1, 4, 2, 4, 4, 4,
                                       3, 4, 4, 4, 4, 4, 4, 4};
    extract_job_t *jb = arg;
    const ingest_conf_t *conf = jb->conf;
    const int32_t L = jb->L;
    for (int64_t i = jb->i0; i < jb->i1; i++) {
        const rec_t *r = &jb->recs[i];
        jb->o_pos[i] = r->pos;
        jb->o_lq[i] = r->l_qseq;
        int elig = 0;
        if (conf->use_baq && r->l_qseq == L && r->n_cigar == 1) {
            int op = r->cigar[0] & 0xf, l = r->cigar[0] >> 4;
            if ((op == OPM || op == OPEQ || op == OPX) && l == L) {
                const uint8_t *t;
                elig = conf->redo_baq ||
                       !((t = aux_get(r, "lb")) && *t == 'Z');
            }
        }
        jb->o_elig[i] = (uint8_t)elig;
        if (elig) {
            uint8_t *cd = jb->o_codes + (int64_t)i * L;
            uint8_t *qd = jb->o_quals + (int64_t)i * L;
            for (int j = 0; j < L; j++)
                cd[j] = code16[(r->seq4[j >> 1] >> ((~j & 1) << 2)) & 0xf];
            if (conf->illumina13) {
                for (int j = 0; j < L; j++) {
                    uint8_t q = r->qual[j];
                    qd[j] = q > 31 ? q - 31 : 0;
                }
            } else {
                memcpy(qd, r->qual, (size_t)L);
            }
            int64_t xb = r->pos - 3, xe = r->pos + L + 3;
            if (xb < 0) xb = 0;
            if (xe > jb->ref_len) xe = jb->ref_len;
            jb->o_xb[i] = xb;
            jb->o_xe[i] = xe;
        } else {
            jb->o_xb[i] = 0;
            jb->o_xe[i] = 0;
        }
    }
    return NULL;
}

int64_t lfq_extract_reads(
    const uint8_t *buf, int64_t buflen, const ingest_conf_t *conf,
    int64_t ref_len, int32_t L,
    uint8_t *o_elig, int64_t *o_pos, int32_t *o_lq,
    uint8_t *o_codes, uint8_t *o_quals, int64_t *o_xb, int64_t *o_xe)
{
    /* pass 1 (serial, pointer-level): collect kept records in stream
     * order — regcur makes the region walk order-dependent.  Pass 2
     * stripes the per-base decode across threads; each read's outputs
     * sit at fixed stride L, so stripes write disjoint ranges. */
    static _Thread_local arena_t ar_recs;
    int64_t nrec_max = 0;
    for (int64_t o = 0; o + 4 <= buflen;) {
        int32_t sz = *(int32_t *)(buf + o);
        if (o + 4 + sz > buflen)
            return -1;
        o += 4 + sz;
        nrec_max++;
    }
    rec_t *recs = arena_get(&ar_recs, (nrec_max + 1) * sizeof(rec_t));
    int64_t n = 0, off = 0, regcur = 0;
    while (off + 4 <= buflen) {
        int32_t sz = *(int32_t *)(buf + off);
        off += 4;
        rec_t r;
        if (parse_rec(buf + off, sz, &r) == 0 && read_kept(&r, conf) &&
            in_region(conf, &regcur, r.pos, rec_endpos(&r)))
            recs[n++] = r;
        off += sz;
    }
    extract_job_t jobs[64];
    pthread_t tids[64];
    int started[64];
    int nth = ingest_threads();
    if ((int64_t)nth > n)
        nth = n > 0 ? (int)n : 1;
    for (int t = 0; t < nth; t++) {
        jobs[t] = (extract_job_t){
            recs, conf, ref_len, L, o_elig, o_pos, o_lq,
            o_codes, o_quals, o_xb, o_xe,
            n * t / nth, n * (t + 1) / nth};
        started[t] = (t > 0) && pthread_create(
            &tids[t], NULL, extract_worker, &jobs[t]) == 0;
    }
    extract_worker(&jobs[0]);
    for (int t = 1; t < nth; t++) {
        if (started[t])
            pthread_join(tids[t], NULL);
        else
            extract_worker(&jobs[t]);
    }
    return n;
}

/* ---- fused ingest->columns (default SNV path) -------------------------
 *
 * One pass from raw BAM records to per-column outputs, skipping the row
 * materialization entirely: at 100 kb x 800x the row arrays are ~4 GB
 * written + ~4 GB re-read by the separate column builder; the fused pass
 * touches ~0.5 GB.  Per-row semantics replicate csrc/columns.c's
 * process_position exactly (same filters, merge, counts, consensus,
 * light indel accounting) — equality-tested against the two-pass path.
 *
 * Threading: position stripes (each thread walks all reads overlapping
 * its stripe, clipped), so per-column arrival order stays read order —
 * identical to the row path's stable counting sort.
 *
 * colconf layout MUST stay in sync with columns.c / fast_columns.py. */

typedef struct {
    int32_t min_plp_bq;
    int32_t min_bq, min_alt_bq, def_alt_bq;
    int32_t min_jq, min_alt_jq, def_alt_jq;
    int32_t use_baq, use_mq, use_sq;
    int32_t min_plp_idq;
    int32_t max_depth;
    int32_t baq_bias;
    /* screening mode: the prob CSR feeds ONLY the (permutation-
     * invariant) prescreen/screen lower bounds, never the exact DP —
     * emit order-free float32 probs and skip the per-column nt4
     * regroup pass (halves the biggest write stream and drops a full
     * reshuffle of it).  Candidate columns are re-derived exactly. */
    int32_t screen_flat;
    /* screening SNV-only mode: the emission-side per-column counters
     * (fw/rv strand counts, raw alt counts, consensus accumulation)
     * are consumed only by the exact-confirm rebuild / indel emission,
     * never by the screening pass — skip their per-row scatter RMWs
     * (the sweep's hottest memory traffic).  cons_nt4 is reported as
     * the reference base in this mode. */
    int32_t skip_emit_counts;
    double mq0_errprob;
} icolconf_t;

static double iq2p_tab[256];
static pthread_once_t iq2p_once = PTHREAD_ONCE_INIT;
static void iq2p_init(void)
{
    for (int i = 0; i < 256; i++)
        iq2p_tab[i] = pow(10.0, -1.0 * i / 10.0);
}

static inline double iq2p8(int q) { return iq2p_tab[q & 0xff]; }

static inline double iq2p_full(int32_t q)
{
    if (q < 0)
        return 0.0;
    if (q < 256)
        return iq2p8(q);
    return pow(10.0, -1.0 * (double)q / 10.0);
}

/* per-read precomputed fields for the fused pass */
typedef struct {
    int64_t endpos;
    int32_t sq;
    int16_t mq;
    uint8_t strand;
    const uint8_t *bi, *bd;   /* BI/BD tag values or NULL */
} readinfo_t;

typedef struct {
    const prep_t *pp;
    const readinfo_t *ri;
    const ingest_conf_t *iconf;
    const icolconf_t *cf;
    int64_t win_beg, win_len;
    const char *ref;
    int64_t ref_len;
    const int64_t *offset;        /* capped row-count prefix [W+1] */
    const int64_t *cols_before;   /* [W+1] */
    int64_t *cur;                 /* probs write cursor per position [W] */
    int64_t *seen;                /* rows seen per position (depth cap) */
    uint8_t *tagbuf;              /* nt4 tag per written prob slot */
    /* outputs (indexed by column id = cols_before[p]) */
    int64_t *o_num_bases, *o_heads, *o_tails;
    uint8_t *o_cons_nt4;
    int64_t *o_fw, *o_rv, *o_alt_cnt, *o_alt_raw;
    double *o_probs;
    int64_t *o_num_ins, *o_num_dels, *o_num_non_indels, *o_num_ign;
    int64_t *o_ins_ne_sum, *o_del_ne_sum, *o_ins_ev_max, *o_del_ev_max;
    double *bc;                   /* consensus accumulators [W*5] */
    const uint8_t *o_ref_nt4;     /* per-column ref codes (read-only) */
    float *o_probs32;             /* screening mode 1: f32 probs, no tagbuf */
    uint8_t *o_codes8;            /* screening mode 2: u8 log-quantized
                                     codes straight from the sweep (1 B/row
                                     instead of 4 — the CSR only feeds the
                                     code-native prescreen/screen) */
    const double *mp_tab;         /* [(mq+1)*94] precomputed merged prob
                                     (use_baq==0 && use_sq==0), or NULL */
    const uint8_t *code_tab;      /* [(mq+1)*94] u8 screen code of mp_tab
                                     (codes mode, min_jq==0, def_alt_jq==0:
                                     the per-row emit is then ONE L1 byte
                                     lookup); NULL otherwise */
    int cap_possible;             /* any position's raw count > max_depth
                                     (when 0, seen[] bookkeeping and the
                                     depth-cap check are skippable) */
    int64_t p_beg, p_end;         /* this stripe */
} fusedctx_t;

/* classify one row's light indel contribution (plp.c:1062-1192 via
 * columns.c): kind 0 = none, 1 = ins, 2 = del; is_del_row marks
 * deletion-span rows (refskip rows are NOT is_del for the ign check) */
static inline void fused_indel_acct(const fusedctx_t *fx, int64_t ci,
                                    int iqv, int dqv, int kind,
                                    int is_del_row)
{
    const icolconf_t *cf = fx->cf;
    if (iqv < cf->min_plp_idq || dqv < cf->min_plp_idq) {
        if (kind != 0 || is_del_row)
            fx->o_num_ign[ci]++;
        return;
    }
    if (kind == 1) {
        fx->o_num_ins[ci]++;
        fx->o_ins_ev_max[ci] += iqv;
        fx->o_del_ne_sum[ci] += dqv;
    } else if (kind == 2) {
        fx->o_num_dels[ci]++;
        fx->o_del_ev_max[ci] += dqv;
        fx->o_ins_ne_sum[ci] += iqv;
    } else {
        fx->o_num_non_indels[ci]++;
        fx->o_ins_ne_sum[ci] += iqv;
        fx->o_del_ne_sum[ci] += dqv;
    }
}

/* one base row at window position p (0-based); returns nothing.  Mirrors
 * the !is_del && !is_skip branch of columns.c:process_position. */
static inline void fused_base_row(const fusedctx_t *fx, int64_t p,
                                  int64_t i, int64_t qp,
                                  int is_head, int is_tail)
{
    const prep_t *pp = fx->pp;
    const icolconf_t *cf = fx->cf;
    const readinfo_t *r = &fx->ri[i];
    int64_t ci = fx->cols_before[p];
    int b = pp->quals[pp->seq_start[i] + qp];
    if (is_head)
        fx->o_heads[ci]++;
    if (is_tail)
        fx->o_tails[ci]++;
    if (b < cf->min_plp_bq)
        return;
    fx->o_num_bases[ci]++;
    int bb = b > 93 ? 93 : b;
    char qc = pp->seqs[pp->seq_start[i] + qp];
    uint8_t n4 = CODE256[(uint8_t)qc];
    if (!cf->skip_emit_counts) {
        if (r->strand)
            fx->o_rv[ci * 5 + n4]++;
        else
            fx->o_fw[ci * 5 + n4]++;
        double incr = 1.0 - iq2p8(bb);
        if (incr == 0.0)
            incr = DBL_MIN;
        fx->bc[p * 5 + n4] += incr;
    }
    if (n4 == 4)
        return;
    uint8_t ref4 = fx->o_ref_nt4[ci];
    int is_alt = n4 != ref4;
    if (is_alt && !cf->skip_emit_counts)
        fx->o_alt_raw[ci * 5 + n4]++;
    if (bb < cf->min_bq || (is_alt && bb < cf->min_alt_bq))
        return;
    int use_b = bb;
    if (is_alt && cf->def_alt_bq > 0)
        use_b = cf->def_alt_bq;
    int32_t mqe = cf->use_mq ? (r->mq == 255 ? -1 : r->mq) : -1;
    if (fx->code_tab) {
        /* codes mode with default joint-qual config: mp itself is
         * unused — emit its precomputed u8 code directly (bit-identical
         * to lfq_u8code_f64(mp_tab[...]) by construction) */
        if (is_alt)
            fx->o_alt_cnt[ci * 5 + n4]++;
        int64_t slot = fx->cur[p]++;
        fx->o_codes8[slot] = fx->code_tab[(size_t)(mqe + 1) * 94 + use_b];
        return;
    }
    double mp;
    if (fx->mp_tab) {
        /* use_baq==0 && use_sq==0: the merge collapses to a function of
         * (mq, bq) alone — one table lookup, entries precomputed with
         * the IDENTICAL expression below (bit-exact) */
        mp = fx->mp_tab[(size_t)(mqe + 1) * 94 + use_b];
    } else {
        int32_t bqe = -1;
        if (cf->use_baq && (pp->have[i] & 1)) {
            bqe = (int32_t)pp->baq_all[pp->seq_start[i] + i + qp] - 33;
            if (bqe >= 0 && cf->baq_bias)
                bqe += cf->baq_bias;
        } else if (cf->use_baq) {
            bqe = -1;
        }
        int32_t sqe = cf->use_sq ? r->sq : -1;
        double spv = iq2p_full(sqe);
        double mpv = (mqe == 0) ? cf->mq0_errprob : iq2p_full(mqe);
        double bav = iq2p_full(bqe);
        double bpv = iq2p_full(use_b);
        mp = mpv + (1.0 - mpv) * spv + (1 - mpv) * (1 - spv) * bav +
            (1 - mpv) * (1 - spv) * (1 - bav) * bpv;
    }
    if (cf->min_jq > 0 || cf->min_alt_jq > 0) {
        int mqual = mp <= 0.0 ? 2147483647
            : (int)(-10.0L * log10l((long double)mp));
        if (mqual < cf->min_jq)
            return;
        if (is_alt && mqual < cf->min_alt_jq)
            return;
    }
    if (is_alt && cf->def_alt_jq > 0)
        mp = iq2p8(cf->def_alt_jq);
    if (is_alt)
        fx->o_alt_cnt[ci * 5 + n4]++;
    int64_t slot = fx->cur[p]++;
    if (fx->o_codes8) {
        fx->o_codes8[slot] = lfq_u8code_f64(mp);
    } else if (fx->o_probs32) {
        fx->o_probs32[slot] = (float)mp;
    } else {
        fx->tagbuf[slot] = n4;
        fx->o_probs[slot] = mp;
    }
}

static void fused_stripe(fusedctx_t *fx)
{
    const prep_t *pp = fx->pp;
    const icolconf_t *cf = fx->cf;
    int64_t gp0 = fx->win_beg + fx->p_beg, gp1 = fx->win_beg + fx->p_end;
    int64_t maxd = cf->max_depth > 0 ? cf->max_depth : INT64_MAX;
    for (int64_t i = 0; i < pp->nreads; i++) {
        const rec_t *r = &pp->recs[i];
        const readinfo_t *ri = &fx->ri[i];
        if (r->pos >= gp1 || ri->endpos <= gp0)
            continue;
        int64_t s0 = pp->seq_start[i];
        int64_t first_emit = r->pos;           /* head row position */
        int64_t last_emit = ri->endpos - 1;    /* tail row position */
        /* fast path: one match op (optionally soft/hard-clipped at
         * either end — S shifts the query offset, H consumes nothing),
         * no BI/BD, permissive min_plp_idq — every base row is kind-0
         * with iq=dq=0, so the whole defer machinery reduces to
         * num_non_indels++ per surviving row.  Most reads in real data
         * are [S]M[S]; bit-identical to the general walk below
         * (checked by the fused-vs-row tests). */
        int fp_ok = 0;
        int64_t fp_l = 0, fp_qoff = 0;
        if (!ri->bi && !ri->bd && cf->min_plp_idq <= 0
            && r->n_cigar >= 1 && r->n_cigar <= 3) {
            int k0 = 0, k1 = r->n_cigar;
            while (k0 < k1) {
                int op = r->cigar[k0] & 0xf;
                if (op == OPS) {
                    fp_qoff += r->cigar[k0] >> 4;
                    k0++;
                } else if (op == OPH) {
                    k0++;
                } else {
                    break;
                }
            }
            while (k1 - 1 > k0) {
                int op = r->cigar[k1 - 1] & 0xf;
                if (op == OPS || op == OPH)
                    k1--;
                else
                    break;
            }
            if (k1 - k0 == 1) {
                int opm = r->cigar[k0] & 0xf;
                if (opm == OPM || opm == OPEQ || opm == OPX) {
                    fp_ok = 1;
                    fp_l = r->cigar[k0] >> 4;
                }
            }
        }
        if (fp_ok) {
            {
                int64_t l = fp_l;
                int64_t j0 = 0, j1 = l;
                if (r->pos < gp0)
                    j0 = gp0 - r->pos;
                if (r->pos + l > gp1)
                    j1 = gp1 - r->pos;
                if (cf->skip_emit_counts && fx->code_tab
                    && !fx->cap_possible) {
                    /* screening SNV-only + code-table + no depth cap in
                     * this window: the row work collapses to qual
                     * check, num_bases++, (rare) alt_cnt++, one code
                     * byte.  heads/tails, seen[], num_non and the
                     * +=0 ne-sums are all provably unconsumed here
                     * (emission counters rebuild exactly in confirm;
                     * the cons-indel gate compares ev>ne sums, which
                     * zero-iq/dq fast-path rows never change). */
                    const uint8_t *qrow = fx->pp->quals
                        + fx->pp->seq_start[i];
                    const char *srow = fx->pp->seqs
                        + fx->pp->seq_start[i];
                    int32_t mqe = cf->use_mq
                        ? (ri->mq == 255 ? -1 : ri->mq) : -1;
                    const uint8_t *ctab = fx->code_tab
                        + (size_t)(mqe + 1) * 94;
                    const int min_plp = cf->min_plp_bq;
                    const int min_bq = cf->min_bq;
                    const int min_abq = cf->min_alt_bq;
                    const int dab = cf->def_alt_bq;
                    for (int64_t j = j0; j < j1; j++) {
                        int64_t p = r->pos + j - fx->win_beg;
                        int b = qrow[fp_qoff + j];
                        if (b < min_plp)
                            continue;
                        int64_t ci = fx->cols_before[p];
                        fx->o_num_bases[ci]++;
                        int bb = b > 93 ? 93 : b;
                        uint8_t n4 = CODE256[(uint8_t)srow[fp_qoff + j]];
                        if (n4 == 4)
                            continue;
                        int use_b = bb;
                        if (n4 != fx->o_ref_nt4[ci]) {
                            if (bb < min_bq || bb < min_abq)
                                continue;
                            if (dab > 0)
                                use_b = dab;
                            fx->o_alt_cnt[ci * 5 + n4]++;
                        } else if (bb < min_bq) {
                            continue;
                        }
                        fx->o_codes8[fx->cur[p]++] = ctab[use_b];
                    }
                    continue;
                }
                for (int64_t j = j0; j < j1; j++) {
                    int64_t gp = r->pos + j;
                    int64_t p = gp - fx->win_beg;
                    if (fx->seen[p] >= maxd)
                        continue;
                    fx->seen[p]++;
                    fused_base_row(fx, p, i, fp_qoff + j,
                                   gp == first_emit, gp == last_emit);
                    fx->o_num_non_indels[fx->cols_before[p]]++;
                }
                continue;
            }
        }
        int64_t x = r->pos;
        int64_t y = 0;
        int prev_aligned = 0, emitted = 0;
        /* deferred last-M-row indel classification */
        int have_defer = 0;
        int64_t defer_p = 0, defer_qp = 0;
        for (int k = 0; k < r->n_cigar; k++) {
            int op = r->cigar[k] & 0xf;
            int64_t l = r->cigar[k] >> 4;
            if (op == OPM || op == OPEQ || op == OPX) {
                if (have_defer) {  /* previous M ended at a non-indel op */
                    have_defer = 0;
                    if (defer_p >= fx->p_beg && defer_p < fx->p_end) {
                        int64_t ci = fx->cols_before[defer_p];
                        int iqv = ri->bi ? (int)ri->bi[defer_qp] - 33 : 0;
                        int dqv = ri->bd ? (int)ri->bd[defer_qp] - 33 : 0;
                        fused_indel_acct(fx, ci, iqv, dqv, 0, 0);
                    }
                }
                for (int64_t j = 0; j < l; j++) {
                    int64_t gp = x + j;
                    int64_t p = gp - fx->win_beg;
                    int64_t qp = y + j;
                    int last_of_run = (j == l - 1);
                    if (p >= fx->p_beg && p < fx->p_end) {
                        if (fx->seen[p] >= maxd) {
                            /* beyond depth cap: row fully ignored */
                        } else {
                            fx->seen[p]++;
                            fused_base_row(fx, p, i, qp,
                                           gp == first_emit,
                                           gp == last_emit);
                            int64_t ci = fx->cols_before[p];
                            if (!last_of_run) {
                                int iqv = ri->bi ? (int)ri->bi[qp] - 33 : 0;
                                int dqv = ri->bd ? (int)ri->bd[qp] - 33 : 0;
                                fused_indel_acct(fx, ci, iqv, dqv, 0, 0);
                            } else {
                                have_defer = 1;
                                defer_p = p;
                                defer_qp = qp;
                            }
                        }
                    } else if (last_of_run) {
                        have_defer = 0;  /* out-of-stripe row */
                    }
                }
                x += l;
                y += l;
                prev_aligned = 1;
                emitted = 1;
            } else if (op == OPI) {
                if (prev_aligned && emitted) {
                    if (have_defer) {
                        have_defer = 0;
                        int64_t ci = fx->cols_before[defer_p];
                        int iqv = ri->bi ? (int)ri->bi[defer_qp] - 33 : 0;
                        int dqv = ri->bd ? (int)ri->bd[defer_qp] - 33 : 0;
                        fused_indel_acct(fx, ci, iqv, dqv, 1, 0);
                    }
                }
                y += l;
                prev_aligned = 0;
            } else if (op == OPD || op == OPN) {
                int is_d = (op == OPD);
                if (is_d && prev_aligned && emitted && have_defer) {
                    have_defer = 0;
                    int64_t ci = fx->cols_before[defer_p];
                    int iqv = ri->bi ? (int)ri->bi[defer_qp] - 33 : 0;
                    int dqv = ri->bd ? (int)ri->bd[defer_qp] - 33 : 0;
                    fused_indel_acct(fx, ci, iqv, dqv, 2, 0);
                } else if (have_defer) {
                    have_defer = 0;
                    int64_t ci = fx->cols_before[defer_p];
                    int iqv = ri->bi ? (int)ri->bi[defer_qp] - 33 : 0;
                    int dqv = ri->bd ? (int)ri->bd[defer_qp] - 33 : 0;
                    fused_indel_acct(fx, ci, iqv, dqv, 0, 0);
                }
                /* qpos of del/refskip rows = next query base (see
                 * expand_read above) */
                int64_t qpd = y;
                int iqv = ri->bi ? (int)ri->bi[qpd] - 33 : 0;
                int dqv = ri->bd ? (int)ri->bd[qpd] - 33 : 0;
                for (int64_t j = 0; j < l; j++) {
                    int64_t gp = x + j;
                    int64_t p = gp - fx->win_beg;
                    if (p < fx->p_beg || p >= fx->p_end)
                        continue;
                    if (fx->seen[p] >= maxd)
                        continue;
                    fx->seen[p]++;
                    int64_t ci = fx->cols_before[p];
                    /* del/refskip rows: no base stats, only indel acct;
                     * head/tail flags only count on base rows.  Both D
                     * and N rows are is_del for the ignored-indel gate
                     * (htslib is_del covers refskips, plp.c:1062) */
                    fused_indel_acct(fx, ci, iqv, dqv, 0, 1);
                }
                x += l;
                prev_aligned = 0;
                emitted = 1;
            } else if (op == OPS) {
                y += l;
                prev_aligned = 0;
            } else {
                prev_aligned = 0;
            }
        }
        if (have_defer && defer_p >= fx->p_beg && defer_p < fx->p_end) {
            int64_t ci = fx->cols_before[defer_p];
            int iqv = ri->bi ? (int)ri->bi[defer_qp] - 33 : 0;
            int dqv = ri->bd ? (int)ri->bd[defer_qp] - 33 : 0;
            fused_indel_acct(fx, ci, iqv, dqv, 0, 0);
        }
    }
    /* per-column: regroup probs by nt4 (stable), write cons argmax.
     * Screening mode (o_probs32): the CSR is order-free — skip the
     * regroup (a full extra read+scatter+copy of the biggest array);
     * only the consensus argmax remains. */
    int64_t span = fx->offset[fx->p_end] - fx->offset[fx->p_beg];
    if (span < 1)
        span = 1;
    double *scratch = (fx->o_probs32 || fx->o_codes8)
        ? NULL : malloc(span * sizeof(double));
    for (int64_t p = fx->p_beg; p < fx->p_end; p++) {
        int64_t ci = fx->cols_before[p];
        if (fx->cols_before[p + 1] == ci)
            continue;  /* no coverage */
        if (scratch) {
            int64_t lo = fx->offset[p], hi = fx->cur[p];
            int64_t np = hi - lo;
            if (np > 1) {
                int64_t cnt[4] = {0}, off4[4];
                for (int64_t k = lo; k < hi; k++)
                    cnt[fx->tagbuf[k]]++;
                off4[0] = 0;
                for (int k2 = 1; k2 < 4; k2++)
                    off4[k2] = off4[k2 - 1] + cnt[k2 - 1];
                for (int64_t k = lo; k < hi; k++)
                    scratch[off4[fx->tagbuf[k]]++] = fx->o_probs[k];
                memcpy(fx->o_probs + lo, scratch, np * sizeof(double));
            }
        }
        if (fx->cf->skip_emit_counts) {
            fx->o_cons_nt4[ci] = fx->o_ref_nt4[ci];
        } else {
            int mx = 0;
            const double *bcp = fx->bc + p * 5;
            for (int k2 = 1; k2 < 5; k2++)
                if (bcp[k2] > bcp[mx])
                    mx = k2;
            fx->o_cons_nt4[ci] = (uint8_t)mx;
        }
    }
    free(scratch);
}

static void *fused_worker(void *arg)
{
    fused_stripe((fusedctx_t *)arg);
    return NULL;
}

int64_t lfq_ingest_columns(
    const uint8_t *buf, int64_t buflen, const ingest_conf_t *iconf,
    const icolconf_t *cf, int64_t win_beg, int64_t win_end,
    const char *ref, int64_t ref_len,
    int64_t *o_positions, int64_t *o_coverage, int64_t *o_num_bases,
    int64_t *o_heads, int64_t *o_tails, uint8_t *o_ref_nt4,
    uint8_t *o_cons_nt4, int64_t *o_fw, int64_t *o_rv,
    int64_t *o_alt_cnt, int64_t *o_alt_raw,
    int64_t *o_col_start, double *o_probs,
    int64_t *o_num_ins, int64_t *o_num_dels, int64_t *o_num_non_indels,
    int64_t *o_num_ign, int64_t *o_ins_ne_sum, int64_t *o_del_ne_sum,
    int64_t *o_ins_ev_max, int64_t *o_del_ev_max,
    int64_t probs_cap, int64_t *need_rows)
{
    /* probs_cap: capacity (elements) of o_probs; when the window needs
     * more, *need_rows is set and -2 returned BEFORE the expensive
     * stripe pass — callers grow the slab and retry, which removes the
     * separate Python-level counting call entirely (probs_cap <= 0
     * keeps the legacy contract: caller pre-counted, no check). */
    int64_t win_len = win_end - win_beg;
    if (win_len <= 0)
        return 0;
    pthread_once(&iq2p_once, iq2p_init);
    pthread_once(&code256_once, code256_init);

    struct timespec _ts; double _t0, _t1;
    const char *_dbg = getenv("LOFREQ_FUSED_PHASE");
    clock_gettime(CLOCK_MONOTONIC, &_ts); _t0 = _ts.tv_sec + 1e-9*_ts.tv_nsec;
    #define FPH(name) do { if (_dbg) { clock_gettime(CLOCK_MONOTONIC, &_ts); _t1 = _ts.tv_sec + 1e-9*_ts.tv_nsec; fprintf(stderr, "FUSED %s: %.2f\n", name, _t1-_t0); _t0 = _t1; } } while (0)
    prep_t pp;
    if (prep_build(buf, buflen, iconf, ref, ref_len, &pp) != 0)
        return -1;
    int64_t n = pp.nreads;
    FPH("prep");

    /* per-read fields + raw per-position counts */
    readinfo_t *ri = malloc((n ? n : 1) * sizeof(readinfo_t));
    int64_t *count = calloc(win_len + 1, sizeof(int64_t));
    for (int64_t i = 0; i < n; i++) {
        const rec_t *r = &pp.recs[i];
        readinfo_t *q = &ri[i];
        q->endpos = rec_endpos(r);
        q->mq = r->mapq > iconf->max_mq ? iconf->max_mq : r->mapq;
        q->strand = (r->flag & XFREVERSE) ? 1 : 0;
        q->sq = -1;
        const uint8_t *t;
        q->bi = ((t = aux_get(r, "BI")) && *t == 'Z') ? t + 1 : NULL;
        q->bd = ((t = aux_get(r, "BD")) && *t == 'Z') ? t + 1 : NULL;
        const uint8_t *sqt = aux_get(r, "sq");
        if (sqt)
            q->sq = (int32_t)aux_int(sqt);
        else if (iconf->use_sq)
            q->sq = source_qual_one(r, ref, ref_len, iconf->def_nm_q,
                                    iconf->sq_min_bq, iconf);
        /* raw per-position row counts (all row kinds) */
        int64_t x = r->pos;
        for (int k = 0; k < r->n_cigar; k++) {
            int op = r->cigar[k] & 0xf;
            int64_t l = r->cigar[k] >> 4;
            if (op == OPM || op == OPEQ || op == OPX ||
                op == OPD || op == OPN) {
                int64_t a = x - win_beg, b = x + l - win_beg;
                if (a < 0) a = 0;
                if (b > win_len) b = win_len;
                for (int64_t p = a; p < b; p++)
                    count[p + 1]++;
                x += l;
            }
        }
    }
    FPH("count");
    int64_t maxd = cf->max_depth > 0 ? cf->max_depth : INT64_MAX;
    int64_t *offset = malloc((win_len + 1) * sizeof(int64_t));
    int64_t *cols_before = malloc((win_len + 1) * sizeof(int64_t));
    offset[0] = 0;
    cols_before[0] = 0;
    int cap_hit = 0;
    for (int64_t p = 0; p < win_len; p++) {
        int64_t c = count[p + 1];
        if (c > maxd) {
            c = maxd;
            cap_hit = 1;
        }
        offset[p + 1] = offset[p] + c;
        cols_before[p + 1] = cols_before[p] + (count[p + 1] > 0);
    }
    int64_t total = offset[win_len];
    int64_t C = cols_before[win_len];
    if (C == 0) {
        o_col_start[0] = 0;
        free(ri); free(count); free(offset); free(cols_before);
        prep_free(&pp);
        return 0;
    }
    if (probs_cap > 0 && total > probs_cap) {
        if (need_rows)
            *need_rows = total;
        free(ri); free(count); free(offset); free(cols_before);
        prep_free(&pp);
        return -2;
    }

    /* per-column setup + zero the accumulated outputs */
    for (int64_t p = 0; p < win_len; p++) {
        if (count[p + 1] == 0)
            continue;
        int64_t ci = cols_before[p];
        int64_t gp = win_beg + p;
        o_positions[ci] = gp;
        int64_t c = count[p + 1];
        o_coverage[ci] = c > maxd ? maxd : c;
        char refc = (gp < ref_len) ? ref[gp] : 'N';
        o_ref_nt4[ci] = CODE256[(uint8_t)refc] > 3
            ? 4 : CODE256[(uint8_t)refc];
    }
    memset(o_num_bases, 0, C * sizeof(int64_t));
    memset(o_heads, 0, C * sizeof(int64_t));
    memset(o_tails, 0, C * sizeof(int64_t));
    memset(o_fw, 0, C * 5 * sizeof(int64_t));
    memset(o_rv, 0, C * 5 * sizeof(int64_t));
    memset(o_alt_cnt, 0, C * 5 * sizeof(int64_t));
    memset(o_alt_raw, 0, C * 5 * sizeof(int64_t));
    memset(o_num_ins, 0, C * sizeof(int64_t));
    memset(o_num_dels, 0, C * sizeof(int64_t));
    memset(o_num_non_indels, 0, C * sizeof(int64_t));
    memset(o_num_ign, 0, C * sizeof(int64_t));
    memset(o_ins_ne_sum, 0, C * sizeof(int64_t));
    memset(o_del_ne_sum, 0, C * sizeof(int64_t));
    memset(o_ins_ev_max, 0, C * sizeof(int64_t));
    memset(o_del_ev_max, 0, C * sizeof(int64_t));

    int64_t *cur = malloc(win_len * sizeof(int64_t));
    memcpy(cur, offset, win_len * sizeof(int64_t));
    int64_t *seen = calloc(win_len, sizeof(int64_t));
    uint8_t *tagbuf = cf->screen_flat ? NULL : malloc((total ? total : 1));
    double *bc = calloc((size_t)win_len * 5, sizeof(double));

    /* merged-prob lookup table: with BAQ and SQ out of the merge the
     * per-base prob depends on (mq, bq) alone — 256*94 doubles (192 KB,
     * L2-resident) replace two decode lookups + the 4-term merge per
     * base.  Entries are computed with the EXACT expression and operand
     * order of the general path (spv = bav = 0.0), so results are
     * bit-identical.  def_alt_bq > 93 would index past the bq axis. */
    double *mp_tab = NULL;
    if (!cf->use_baq && !cf->use_sq && cf->def_alt_bq <= 93) {
        mp_tab = malloc((size_t)256 * 94 * sizeof(double));
        if (mp_tab) {
            for (int m = -1; m <= 254; m++) {
                double mpv = (m == 0) ? cf->mq0_errprob : iq2p_full(m);
                double *row = mp_tab + (size_t)(m + 1) * 94;
                for (int b = 0; b <= 93; b++) {
                    double spv = 0.0, bav = 0.0;
                    double bpv = iq2p_full(b);
                    row[b] = mpv + (1.0 - mpv) * spv
                        + (1 - mpv) * (1 - spv) * bav
                        + (1 - mpv) * (1 - spv) * (1 - bav) * bpv;
                }
            }
        }
    }

    uint8_t *code_tab = NULL;
    if (mp_tab && cf->screen_flat == 2 && cf->min_jq <= 0
        && cf->min_alt_jq <= 0 && cf->def_alt_jq <= 0) {
        code_tab = malloc((size_t)256 * 94);
        if (code_tab)
            for (size_t k = 0; k < (size_t)256 * 94; k++)
                code_tab[k] = lfq_u8code_f64(mp_tab[k]);
    }

    fusedctx_t base = {
        .pp = &pp, .ri = ri, .iconf = iconf, .cf = cf,
        .win_beg = win_beg, .win_len = win_len,
        .ref = ref, .ref_len = ref_len,
        .offset = offset, .cols_before = cols_before,
        .cur = cur, .seen = seen, .tagbuf = tagbuf,
        .o_num_bases = o_num_bases, .o_heads = o_heads,
        .o_tails = o_tails, .o_cons_nt4 = o_cons_nt4,
        .o_fw = o_fw, .o_rv = o_rv, .o_alt_cnt = o_alt_cnt,
        .o_alt_raw = o_alt_raw, .o_probs = o_probs,
        .o_num_ins = o_num_ins, .o_num_dels = o_num_dels,
        .o_num_non_indels = o_num_non_indels, .o_num_ign = o_num_ign,
        .o_ins_ne_sum = o_ins_ne_sum, .o_del_ne_sum = o_del_ne_sum,
        .o_ins_ev_max = o_ins_ev_max, .o_del_ev_max = o_del_ev_max,
        .bc = bc, .o_ref_nt4 = o_ref_nt4,
        .o_probs32 = cf->screen_flat == 1 ? (float *)o_probs : NULL,
        .o_codes8 = cf->screen_flat == 2 ? (uint8_t *)o_probs : NULL,
        .mp_tab = mp_tab,
        .code_tab = code_tab,
        .cap_possible = cap_hit,
    };

    FPH("setup");
    int nth = ingest_threads();
    if ((int64_t)nth > C)
        nth = (int)C;
    if (total < 65536)
        nth = 1;
    fusedctx_t stripes[64];
    int n_st = 0;
    {
        int64_t p_cur = 0;
        for (int t = 0; t < nth && p_cur < win_len; t++) {
            int64_t target = (total * (int64_t)(t + 1)) / nth;
            int64_t p_end = p_cur;
            while (p_end < win_len && offset[p_end] < target)
                p_end++;
            if (t == nth - 1)
                p_end = win_len;
            if (p_end > p_cur) {
                stripes[n_st] = base;
                stripes[n_st].p_beg = p_cur;
                stripes[n_st].p_end = p_end;
                n_st++;
                p_cur = p_end;
            }
        }
        if (p_cur < win_len && n_st)
            stripes[n_st - 1].p_end = win_len;
    }
    if (n_st <= 1) {
        if (n_st)
            fused_stripe(&stripes[0]);
    } else {
        pthread_t tids[64];
        int started[64] = {0};
        for (int t = 1; t < n_st; t++)
            started[t] = pthread_create(&tids[t], NULL, fused_worker,
                                        &stripes[t]) == 0;
        fused_stripe(&stripes[0]);
        for (int t = 1; t < n_st; t++) {
            if (started[t])
                pthread_join(tids[t], NULL);
            else
                fused_stripe(&stripes[t]);
        }
    }

    FPH("stripes");
    /* compact per-position prob regions into a dense CSR */
    size_t esz = cf->screen_flat == 2 ? 1
        : cf->screen_flat ? sizeof(float) : sizeof(double);
    char *pbytes = (char *)o_probs;
    int64_t dense = 0;
    for (int64_t p = 0; p < win_len; p++) {
        if (count[p + 1] == 0)
            continue;
        int64_t ci = cols_before[p];
        int64_t np = cur[p] - offset[p];
        if (offset[p] != dense && np)
            memmove(pbytes + (size_t)dense * esz,
                    pbytes + (size_t)offset[p] * esz,
                    (size_t)np * esz);
        o_col_start[ci] = dense;
        dense += np;
    }
    o_col_start[C] = dense;

    FPH("compact");
    free(ri); free(count); free(offset); free(cols_before);
    free(cur); free(seen); free(tagbuf); free(bc); free(mp_tab);
    free(code_tab);
    prep_free(&pp);
    return C;
}

/* The records of a coordinate-sorted BAM that a window [beg, end) of tid
 * needs, as ONE byte range of an inflated span: one walk over the record
 * headers from `start` (a record boundary: the BAI's linear-index start
 * for beg) towards `limit` (the end of the window's last chunk, a record
 * boundary, or past buflen where that lies outside the span).  The range
 * starts at the first record whose reference end lies past beg and ends
 * before the first record of another contig or with pos >= end, or at
 * limit.  Every record overlapping [beg, end) lies inside it, in file
 * order; the other records in it are ones the consumers' interval filter
 * drops.  Writes out[0], out[1] (byte offsets into buf; an empty range
 * has out[0] == out[1]) and returns 0; -1 on a record that does not parse
 * or crosses limit, -2 on a record of tid out of position order, -3 where
 * the span ends before the range does.  Callers fall back to the BAI's
 * chunks on any of them. */
int64_t lfq_raw_view(const uint8_t *buf, int64_t buflen, int64_t start,
                     int64_t limit, int32_t tid, int64_t beg, int64_t end,
                     int64_t *out)
{
    int64_t off = start, first = -1, last_pos = INT64_MIN;
    if (start < 0 || start > buflen)
        return -1;
    while (off < limit) {
        if (off + 4 > buflen)
            return -3;
        int32_t sz = *(const int32_t *)(buf + off);
        if (sz < 32 || off + 4 + sz > limit)
            return -1;
        if (off + 4 + sz > buflen)
            return -3;
        rec_t r;
        if (parse_rec(buf + off + 4, sz, &r) != 0)
            return -1;
        if (r.tid != tid || r.pos >= end)
            break;
        if (r.pos < last_pos)
            return -2;
        last_pos = r.pos;
        if (first < 0 && rec_endpos(&r) > beg)
            first = off;
        off += 4 + (int64_t)sz;
    }
    out[0] = first < 0 ? off : first;
    out[1] = off;
    return 0;
}
