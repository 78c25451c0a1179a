/* realign.c — per-read Viterbi realignment for misplaced indels.
 *
 * Native batch implementation of the reference's realigner
 * (see src/lofreq/viterbi.c:99 and lofreq_viterbi.c:107 for
 * the original per-read formulation).  A 3-state (M/I/D) log10 Viterbi over
 * query x windowed-reference with transitions alpha=1e-5, beta=0.4,
 * gamma=1/(2L); Q2 base qualities are replaced by a caller-provided default
 * (median of non-Q2 quals); traceback is left-aligned.
 *
 * DP matrices are flat [i][k] (query-major) so the inner k loop is
 * contiguous, and live in thread-local grow-only scratch instead of
 * 6*rlen callocs per read — a pure layout change, every floating-point
 * operation and comparison stays in the original order (the viterbi
 * goldens in tests/golden/ pin this bit-for-bit).
 *
 * Build: gcc -O2 -shared -fPIC -o liblofreq_realign.so realign.c -lm
 */

#include <limits.h>
#include <math.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

static inline double q2p_sanger(int c)
{
    return pow(10.0, -0.1 * (c - 33));
}

static int argmax_first(const double *a, int n)
{
    int m = 0;
    for (int i = 0; i < n; i++)
        if (a[i] > a[m])
            m = i;
    return m;
}

/* Shift indels to the leftmost equivalent placement; writes M/I/D chars to
 * state_out (viterbi.c:48-96 semantics). */
static void left_align(char *ref, char *query, int slen, char *state_out)
{
    int i = 0;
    while (i < slen - 1) {
        if (ref[i] != '*' && query[i] != '*') {
            if (ref[i + 1] == '*') {
                int ilen = 0;
                while (ref[i + 1 + ilen] == '*')
                    ilen++;
                if (query[i + ilen] == ref[i]) {
                    ref[i + ilen] = ref[i];
                    ref[i] = '*';
                    i--;
                    continue;
                }
            } else if (query[i + 1] == '*') {
                int dlen = 0;
                while (query[i + 1 + dlen] == '*')
                    dlen++;
                if (query[i] == ref[i + dlen]) {
                    query[i + dlen] = query[i];
                    query[i] = '*';
                    i--;
                    continue;
                }
            }
        }
        i++;
    }
    for (i = 0; i < slen; i++) {
        if (ref[i] == '*')
            state_out[i] = 'I';
        else if (query[i] == '*')
            state_out[i] = 'D';
        else
            state_out[i] = 'M';
    }
    state_out[slen] = '\0';
}

/* thread-local grow-only scratch (read sizes are bounded; freed at thread
 * exit by the OS).  The lane kernels size everything by a width factor w
 * (1 = scalar): vm/vi/vd hold qlen*rlen*w doubles, pm/pi/pd qlen*rlen*w
 * bytes (the lane kernels pack all three pointers into pm), tb holds the
 * interleaved ref codes (rlen*w int64), tb2 the traceback strings. */
typedef struct {
    double *vs;
    double *vm, *vi, *vd;       /* flat [i][k](xw) */
    char *pm, *pi, *pd;
    char *tb;
    char *tb2;
    size_t cap_q, cap_cells, cap_tb, cap_tb2;
} vit_scratch_t;

static __thread vit_scratch_t g_vsc;

static void *aalloc(size_t n)
{
    return aligned_alloc(64, (n + 127) & ~(size_t)63);
}

static int vit_scratch_w(int qlen, int rlen, int w)
{
    vit_scratch_t *s = &g_vsc;
    size_t cells = (size_t)qlen * rlen * w;
    if ((size_t)qlen * w > s->cap_q) {
        free(s->vs);
        s->vs = aalloc((size_t)qlen * w * 2 * sizeof(double));
        if (!s->vs) return -1;
        s->cap_q = (size_t)qlen * w * 2;
    }
    if (cells > s->cap_cells) {
        free(s->vm); free(s->vi); free(s->vd);
        free(s->pm); free(s->pi); free(s->pd);
        size_t cap = cells + cells / 2;
        s->vm = aalloc(cap * sizeof(double));
        s->vi = aalloc(cap * sizeof(double));
        s->vd = aalloc(cap * sizeof(double));
        s->pm = aalloc(cap);
        s->pi = aalloc(cap);
        s->pd = aalloc(cap);
        if (!s->vm || !s->vi || !s->vd || !s->pm || !s->pi || !s->pd)
            return -1;
        s->cap_cells = cap;
    }
    size_t tb = (size_t)(rlen + 2) * w * sizeof(int64_t);
    size_t tb_min = 3 * ((size_t)qlen + rlen + 2);
    if (tb < tb_min)
        tb = tb_min;
    if (tb > s->cap_tb) {
        free(s->tb);
        s->tb = aalloc(tb * 2);
        if (!s->tb) return -1;
        s->cap_tb = tb * 2;
    }
    size_t tb2 = 3 * ((size_t)qlen + rlen + 2);
    if (tb2 > s->cap_tb2) {
        free(s->tb2);
        s->tb2 = aalloc(tb2 * 2);
        if (!s->tb2) return -1;
        s->cap_tb2 = tb2 * 2;
    }
    return 0;
}

static int vit_scratch(int qlen, int rlen)
{
    return vit_scratch_w(qlen, rlen, 1);
}

/* One read: returns the traceback start offset k within ref (the reference
 * shift), writes the left-aligned M/I/D state string into aln (caller
 * allocates >= qlen+rlen+2).  bqual is sanger-encoded (phred+33).
 * Returns INT_MIN on internal error. */
int lfq_viterbi_one(const char *ref_win, const char *query,
                    const char *bqual, int q2default, char *aln)
{
    int qlen = (int)strlen(query) + 1;
    int rlen = (int)strlen(ref_win) + 1;
    double alpha = 0.00001, beta = 0.4;
    double L = (double)rlen;
    double gamma = 1 / (2. * L);
    double ep_ins = log10(.25);
    double tp[5][5] = {{0}};

    tp[0][0] = log10((1 - 2 * alpha) * (1 - gamma));
    tp[0][1] = log10(alpha * (1 - gamma));
    tp[0][2] = log10(alpha * (1 - gamma));
    tp[0][4] = log10(gamma);
    tp[1][0] = log10((1 - beta) * (1 - gamma));
    tp[1][1] = log10(beta * (1 - gamma));
    tp[1][4] = log10(gamma);
    tp[2][0] = log10(1 - beta);
    tp[2][2] = log10(beta);
    tp[3][0] = log10((1 - alpha) / L);
    tp[3][1] = log10(alpha / L);

    if (vit_scratch(qlen, rlen) != 0)
        return INT_MIN;
    vit_scratch_t *s = &g_vsc;
    double *vs = s->vs;
    double *vm = s->vm, *vi = s->vi, *vd = s->vd;
    char *pm = s->pm, *pi = s->pi, *pdl = s->pd;
#define AT(mat, k, i) (mat)[(size_t)(i) * rlen + (k)]

    for (int i = 0; i < qlen; i++)
        vs[i] = INT_MIN;
    for (int k = 0; k < rlen; k++)
        AT(vm, k, 0) = AT(vi, k, 0) = AT(vd, k, 0) = INT_MIN;
    for (int i = 0; i < qlen; i++)
        AT(vm, 0, i) = AT(vi, 0, i) = AT(vd, 0, i) = INT_MIN;
    vs[0] = 0;

    for (int i = 1; i < qlen; i++) {
        double bp;
        if ((bqual[i - 1] - 33) == 2)
            bp = pow(10.0, -0.1 * q2default);
        else
            bp = q2p_sanger((int)bqual[i - 1]);
        double ep_match = log10(1 - bp);
        double ep_match_not = log10(bp / 3.);
        const double *vm0 = vm + (size_t)(i - 1) * rlen;  /* row i-1 */
        const double *vi0 = vi + (size_t)(i - 1) * rlen;
        const double *vd0 = vd + (size_t)(i - 1) * rlen;
        double *vm1 = vm + (size_t)i * rlen;              /* row i */
        double *vi1 = vi + (size_t)i * rlen;
        double *vd1 = vd + (size_t)i * rlen;
        char *pm1 = pm + (size_t)i * rlen;
        char *pi1 = pi + (size_t)i * rlen;
        char *pd1 = pdl + (size_t)i * rlen;
        double vs0 = vs[i - 1];
        for (int k = 1; k < rlen; k++) {
            double mterms[4] = {
                vs0 + tp[3][0],
                vm0[k - 1] + tp[0][0],
                vi0[k - 1] + tp[1][0],
                vd0[k - 1] + tp[2][0],
            };
            int idx = argmax_first(mterms, 4);
            pm1[k] = "SMID"[idx];
            if (query[i - 1] == ref_win[k - 1])
                vm1[k] = ep_match + mterms[idx];
            else
                vm1[k] = ep_match_not + mterms[idx];

            double iterms[3] = {
                vs0 + tp[3][1],
                vm0[k] + tp[0][1],
                vi0[k] + tp[1][1],
            };
            idx = argmax_first(iterms, 3);
            pi1[k] = "SMI"[idx];
            vi1[k] = ep_ins + iterms[idx];

            double dterms[2] = {
                vm1[k - 1] + tp[0][2],
                vd1[k - 1] + tp[2][2],
            };
            idx = argmax_first(dterms, 2);
            pd1[k] = "MD"[idx];
            vd1[k] = dterms[idx];
        }
    }

    char end_state = '!';
    double best_score = INT_MIN;
    int best_index = 0;
    const double *vmq = vm + (size_t)(qlen - 1) * rlen;
    const double *viq = vi + (size_t)(qlen - 1) * rlen;
    for (int k = 0; k < rlen; k++) {
        if (vmq[k] > best_score) {
            end_state = 'M';
            best_score = vmq[k];
            best_index = k;
        }
        if (viq[k] > best_score) {
            end_state = 'I';
            best_score = viq[k];
            best_index = k;
        }
    }

    int i = qlen - 1;
    int k = best_index;
    int maxslen = qlen + rlen;
    char current = end_state;
    char *t_state = s->tb;
    char *t_ref = s->tb + maxslen + 1;
    char *t_query = s->tb + 2 * (maxslen + 1);
    t_state[maxslen - 1] = t_ref[maxslen - 1] = t_query[maxslen - 1] = '\0';
    int si = maxslen - 2;
    int err = 0;
    while (i != 0 && k != 0) {
        t_state[si] = current;
        if (current == 'S') {
            break;
        } else if (current == 'M') {
            t_ref[si] = ref_win[k - 1];
            t_query[si] = query[i - 1];
            current = AT(pm, k, i);
            i -= 1;
            k -= 1;
        } else if (current == 'I') {
            t_ref[si] = '*';
            t_query[si] = query[i - 1];
            current = AT(pi, k, i);
            i -= 1;
        } else if (current == 'D') {
            t_ref[si] = ref_win[k - 1];
            t_query[si] = '*';
            current = AT(pdl, k, i);
            k -= 1;
        } else {
            err = 1;
            break;
        }
        si--;
    }
    if (err)
        return INT_MIN;
    /* Sentinel before the string start: left_align's shift walk can step
     * to index -1 (viterbi.c:48-96 does the same against the byte before
     * its freshly malloc'd buffer, which is never '*' in practice); with
     * reused scratch a stale '*' there would change the left-alignment,
     * so pin it. */
    t_ref[si] = t_query[si] = '\0';
    int slen = maxslen - 2 - si;
    left_align(t_ref + si + 1, t_query + si + 1, slen, aln);
    return k;
#undef AT
}

/* ---------------------------------------------------------------------
 * SIMD lane kernels: viterbi_x4 (AVX2) / viterbi_x8 (AVX-512),
 * instantiated from realign_xw.inc; bit-identical per lane to
 * lfq_viterbi_one (see the include header).  The python driver groups
 * same-(qlen, rlen) reads and calls the exported batch entries below. */

typedef double rv4df __attribute__((vector_size(32)));
typedef int64_t rv4di __attribute__((vector_size(32)));
typedef double rv8df __attribute__((vector_size(64)));
typedef int64_t rv8di __attribute__((vector_size(64)));

#define LANES 4
#define VD rv4df
#define VI rv4di
#define VIT_FN viterbi_x4
#define NM(x) x##_r4
#include "realign_xw.inc"
#undef LANES
#undef VD
#undef VI
#undef VIT_FN
#undef NM

#define LANES 8
#define VD rv8df
#define VI rv8di
#define VIT_FN viterbi_x8
#define NM(x) x##_r8
#include "realign_xw.inc"
#undef LANES
#undef VD
#undef VI
#undef VIT_FN
#undef NM

/* ctypes entry: nl = 4 or 8 same-(qlen,rlen) reads; arrays of pointers.
 * qlen/rlen are strlen+1 like lfq_viterbi_one computes internally. */
int lfq_viterbi_xn(const char **ref_wins, const char **queries,
                   const char **bquals, const int *q2default,
                   int qlen, int rlen, char **alns, int *shifts, int nl)
{
    if (nl == 8)
        return viterbi_x8(ref_wins, queries, bquals, q2default,
                          qlen, rlen, alns, shifts);
    if (nl == 4)
        return viterbi_x4(ref_wins, queries, bquals, q2default,
                          qlen, rlen, alns, shifts);
    return -1;
}
