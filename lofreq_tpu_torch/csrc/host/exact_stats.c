/* exact_stats.c — native exact statistical kernels for lofreq_tpu.
 *
 * Host-side float64/long-double math that must be bit-identical to a
 * glibc/libm evaluation (numpy's SIMD transcendentals differ in the last
 * ulp, which is observable after integer phred truncation).  The TPU device
 * kernels screen in f32; every candidate that survives screening is
 * confirmed here.
 *
 * Batch-first API: one call processes B pileup columns laid out as dense
 * row-major arrays.  Semantics follow the reference engine's pruned DP
 * (see src/lofreq/snpcaller.c:830 for the original
 * column-at-a-time formulation; this is a re-derivation, not a port).
 *
 * Build: gcc -O2 -shared -fPIC -o liblofreq_exact.so exact_stats.c -lm
 */

#include <float.h>
#include <math.h>
#include <pthread.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>
#include <unistd.h>

/* Reference dbl_cmp clone (utils.c:66-76): doubles within an ABSOLUTE
 * DBL_EPSILON compare equal, so glibc qsort leaves near-ties in a
 * pivot-dependent (but deterministic) order.  The DP accumulates in array
 * order, so this is observable in the last ulps of p-values: err-prob
 * vectors must be constructed in the reference's nt4-/op-grouped order and
 * sorted exactly once with this comparator. */
int lfq_dbl_cmp_eps(const void *a, const void *b)
{
    const double da = *(const double *)a;
    const double db = *(const double *)b;
    if (fabs(da - db) < DBL_EPSILON)
        return 0;
    return da < db ? -1 : da > db ? 1 : 0;
}

void lfq_sort_errprobs(double *p, int64_t n)
{
    qsort(p, (size_t)n, sizeof(double), lfq_dbl_cmp_eps);
}

/* Sort the first depths[b] entries of each row of a [B x Dmax] matrix
 * (the padding tail, if any, is left untouched). */
void lfq_sort_errprobs_batch(double *p, const int64_t *depths,
                             int64_t B, int64_t Dmax)
{
    for (int64_t b = 0; b < B; b++)
        qsort(p + b * Dmax, (size_t)depths[b], sizeof(double),
              lfq_dbl_cmp_eps);
}

/* Threaded gather + per-row eps qsort: pack the err probs of selected
 * columns (CSR layout flat/starts/depths) into a dense [B x Dmax] matrix,
 * padding each row's tail with 2.0 (> any probability, so the padding
 * sorts after real entries and the DP's depth mask ignores it).  Rows are
 * independent and each is sorted by the same serial glibc qsort as the
 * reference, so the thread count never changes a bit of output. */
typedef struct {
    const double *flat;
    const int64_t *starts, *depths, *cols;
    int64_t B, Dmax;
    int do_sort;
    double *out;
    int tid, nth;
} pack_job_t;

static void *pack_worker(void *arg)
{
    pack_job_t *j = arg;
    for (int64_t b = j->tid; b < j->B; b += j->nth) {
        int64_t c = j->cols[b];
        int64_t d = j->depths[c];
        if (d > j->Dmax)
            d = j->Dmax;
        double *row = j->out + b * j->Dmax;
        memcpy(row, j->flat + j->starts[c], (size_t)d * sizeof(double));
        for (int64_t i = d; i < j->Dmax; i++)
            row[i] = 2.0;
        if (j->do_sort)
            qsort(row, (size_t)d, sizeof(double), lfq_dbl_cmp_eps);
    }
    return NULL;
}

/* same policy as baq.c:baq_threads (LOFREQ_NATIVE_THREADS; default = online
 * CPUs capped at 8) */
static int pack_threads(void)
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

void lfq_pack_probs_batch(const double *flat, const int64_t *starts,
                          const int64_t *depths, const int64_t *cols,
                          int64_t B, int64_t Dmax, int64_t do_sort,
                          double *out)
{
    int nth = pack_threads();
    if ((int64_t)nth > B)
        nth = B > 0 ? (int)B : 1;
    pack_job_t base = {flat, starts, depths, cols, B, Dmax,
                       (int)do_sort, out, 0, nth};
    if (nth <= 1 || B < 32) {
        base.nth = 1;
        pack_worker(&base);
        return;
    }
    pthread_t tids[64];
    pack_job_t jobs[64];
    for (int t = 0; t < nth; t++) {
        jobs[t] = base;
        jobs[t].tid = t;
    }
    for (int t = 1; t < nth; t++)
        if (pthread_create(&tids[t], NULL, pack_worker, &jobs[t]) != 0)
            jobs[t].nth = 0;
    pack_worker(&jobs[0]);
    for (int t = 1; t < nth; t++)
        if (jobs[t].nth)
            pthread_join(tids[t], NULL);
    for (int t = 1; t < nth; t++)
        if (!jobs[t].nth) {
            jobs[t].nth = nth;
            pack_worker(&jobs[t]);
        }
}

/* f32 variant of the pack gather (screening mode, where the column sweep
 * emits order-free float32 probs: they only feed the prescreen/screen
 * lower bounds, never the exact DP, so no sort path exists here). */
typedef struct {
    const float *flat;
    const int64_t *starts, *depths, *cols;
    int64_t B, Dmax;
    float *out;
    int tid, nth;
} pack32_job_t;

static void *pack32_worker(void *arg)
{
    pack32_job_t *j = arg;
    for (int64_t b = j->tid; b < j->B; b += j->nth) {
        int64_t c = j->cols[b];
        int64_t d = j->depths[c];
        if (d > j->Dmax)
            d = j->Dmax;
        float *row = j->out + b * j->Dmax;
        memcpy(row, j->flat + j->starts[c], (size_t)d * sizeof(float));
        for (int64_t i = d; i < j->Dmax; i++)
            row[i] = 2.0f;
    }
    return NULL;
}

void lfq_pack_probs_batch_f32(const float *flat, const int64_t *starts,
                              const int64_t *depths, const int64_t *cols,
                              int64_t B, int64_t Dmax, float *out)
{
    int nth = pack_threads();
    if ((int64_t)nth > B)
        nth = B > 0 ? (int)B : 1;
    pack32_job_t base = {flat, starts, depths, cols, B, Dmax, out, 0, nth};
    if (nth <= 1 || B < 32) {
        base.nth = 1;
        pack32_worker(&base);
        return;
    }
    pthread_t tids[64];
    pack32_job_t jobs[64];
    for (int t = 0; t < nth; t++) {
        jobs[t] = base;
        jobs[t].tid = t;
    }
    for (int t = 1; t < nth; t++)
        if (pthread_create(&tids[t], NULL, pack32_worker, &jobs[t]) != 0)
            jobs[t].nth = 0;
    pack32_worker(&jobs[0]);
    for (int t = 1; t < nth; t++)
        if (jobs[t].nth)
            pthread_join(tids[t], NULL);
    for (int t = 1; t < nth; t++)
        if (!jobs[t].nth) {
            jobs[t].nth = nth;
            pack32_worker(&jobs[t]);
        }
}

#define LOGZERO -1e100

/* log(exp(a) + exp(b)), stable */
static inline double lse2(double a, double b)
{
    return (a > b) ? a + log1p(exp(b - a)) : b + log1p(exp(a - b));
}

/* Per-read log(p) / log(1-p) with the epsilon clamps the reference engine
 * applies for p ~ 0 and p ~ 1. */
static inline void logp_pair(double p, double *lp, double *l1p)
{
    *lp = (fabs(p) < DBL_EPSILON) ? log(DBL_EPSILON) : log(p);
    *l1p = (fabs(p - 1.0) < DBL_EPSILON) ? log1p(-p + DBL_EPSILON) : log1p(-p);
}

/* Poisson-binomial pruned DP over a batch of columns.
 *
 * probs:  [B * Dmax]  ascending-sorted error probs per column
 * depths: [B]         valid prob count per column (N)
 * ks:     [B]         tail threshold per column (K >= 1)
 * bonf:   [B]         per-column Bonferroni factor for the early-exit test
 * state:  [B * (Kmax+1)] out, log-space cells; cell K accumulates P(X>=K)
 * n_done: [B]         out, reads processed before (early) exit
 *
 * Cells 0..K-1 hold log P(X = k) after n_done reads; cell K holds
 * log P(X >= K).  Early exit freezes the (truncated) distribution as soon
 * as expl(cell K) * bonf > sig with n > K — observable downstream via the
 * source-quality computation, hence reproduced faithfully.
 */
void lfq_poissbin_dp_batch(
    const double *probs, const int64_t *depths, const int64_t *ks,
    const double *bonf, double sig,
    int64_t B, int64_t Dmax, int64_t Kmax,
    double *state, int64_t *n_done)
{
    int64_t stride = Kmax + 1;
    for (int64_t b = 0; b < B; b++) {
        double *st = state + b * stride;
        const double *pp = probs + b * Dmax;
        int64_t N = depths[b];
        int64_t K = ks[b];
        for (int64_t k = 0; k <= Kmax; k++)
            st[k] = LOGZERO;
        st[0] = 0.0;
        int64_t n = 0;
        for (n = 1; n <= N; n++) {
            double lp, l1p;
            logp_pair(pp[n - 1], &lp, &l1p);
            /* tail cell K: no (1-p) factor once reachable */
            if (K <= n)
                st[K] = (n == K) ? st[K - 1] + lp
                                 : lse2(st[K], st[K - 1] + lp);
            int64_t hi = (n < K - 1) ? n : K - 1;
            for (int64_t k = hi; k >= 1; k--)
                st[k] = lse2(st[k] + l1p, st[k - 1] + lp);
            st[0] = st[0] + l1p;
            if (n > K) {
                long double pv = expl((long double)st[K]);
                if (pv < LDBL_MIN) pv = LDBL_MIN;
                if (pv * (long double)bonf[b] > (long double)sig)
                    break;
            }
        }
        n_done[b] = (n > N) ? N : n;
    }
}

/* Log-space tail sums: out[b] = log sum_{k=start[b]}^{ks[b]} exp(state[b,k]),
 * accumulated left to right. */
void lfq_tailsum_batch(
    const double *state, const int64_t *starts, const int64_t *ks,
    int64_t B, int64_t Kmax, double *out)
{
    int64_t stride = Kmax + 1;
    for (int64_t b = 0; b < B; b++) {
        const double *st = state + b * stride;
        double acc = st[starts[b]];
        for (int64_t k = starts[b] + 1; k <= ks[b]; k++)
            acc = lse2(acc, st[k]);
        out[b] = acc;
    }
}

/* libm log applied elementwise (for places where numpy's SIMD log would
 * diverge in the last ulp). */
void lfq_log_vec(const double *x, int64_t n, double *out)
{
    for (int64_t i = 0; i < n; i++)
        out[i] = log(x[i]);
}

void lfq_log1p_vec(const double *x, int64_t n, double *out)
{
    for (int64_t i = 0; i < n; i++)
        out[i] = log1p(x[i]);
}

void lfq_exp_vec(const double *x, int64_t n, double *out)
{
    for (int64_t i = 0; i < n; i++)
        out[i] = exp(x[i]);
}

/* pow(10, -q/10) elementwise (phred->prob on arbitrary int arrays) */
void lfq_phred2prob_vec(const int64_t *q, int64_t n, double *out)
{
    for (int64_t i = 0; i < n; i++)
        out[i] = pow(10.0, -1.0 * (double)q[i] / 10.0);
}

/* Joint error probability
 *   PJ = PM + (1-PM)PS + (1-PM)(1-PS)PBAQ + (1-PM)(1-PS)(1-PBAQ)PB
 * with -1 == unknown (prob 0) and MQ==0 -> mq0_errprob.
 * Same operation order as the scalar reference formula so results are
 * bit-identical to a libm evaluation. */
static double q2p_cache[4096];
static int q2p_cache_done = 0;

static inline double q2p(int32_t q)
{
    if (q < 0)
        return 0.0;
    if (q < 4096) {
        if (!q2p_cache_done) {
            for (int i = 0; i < 4096; i++)
                q2p_cache[i] = pow(10.0, -1.0 * i / 10.0);
            q2p_cache_done = 1;
        }
        return q2p_cache[q];
    }
    return pow(10.0, -1.0 * (double)q / 10.0);
}

void lfq_merge_quals(const int32_t *sq, const int32_t *mq,
                     const int32_t *baq, const int32_t *bq,
                     int64_t n, double mq0_errprob, double *out)
{
    q2p(0); /* warm cache */
    for (int64_t i = 0; i < n; i++) {
        double sp = q2p(sq[i]);
        double mp = (mq[i] == 0) ? mq0_errprob : q2p(mq[i]);
        double bap = q2p(baq[i]);
        double bp = q2p(bq[i]);
        out[i] = mp + (1.0 - mp) * sp + (1 - mp) * (1 - sp) * bap +
                 (1 - mp) * (1 - sp) * (1 - bap) * bp;
    }
}

/* lfq_poissbin_dp_batch with its rows spread over threads.
 *
 * Each row is computed by lfq_poissbin_dp_batch itself with B = 1 on the
 * row's pointers and the batch's Dmax and Kmax, so the state layout is the
 * batch's and a row's arithmetic is the serial code's: the thread count
 * never changes a bit of state or n_done.  Rows are claimed from a shared
 * counter in descending order of their cost bound (the cells the row
 * would update without an early exit, sum_{n=1..N} (min(n, K) + 1)), so
 * the heaviest rows start first and a row that exits early frees its
 * thread at once.  Threads follow pack_threads(), capped by the rows and
 * by one thread per DP_CELLS_PER_THREAD estimated cells: a small batch
 * stays on the calling thread.  *threads_used: the threads it ran on, the
 * calling one included (1 where the batch ran serially).
 */
#define DP_CELLS_PER_THREAD ((int64_t)1 << 20)

typedef struct {
    const double *probs;
    const int64_t *depths, *ks;
    const double *bonf;
    double sig;
    int64_t B, Dmax, Kmax;
    double *state;
    int64_t *n_done;
    const int64_t *cost; /* (cost, row) pairs, heaviest first */
    int64_t next;
} dp_job_t;

static void *dp_worker(void *arg)
{
    dp_job_t *j = arg;
    int64_t i;
    while ((i = __atomic_fetch_add(&j->next, 1, __ATOMIC_RELAXED)) < j->B) {
        int64_t b = j->cost[2 * i + 1];
        lfq_poissbin_dp_batch(j->probs + b * j->Dmax, j->depths + b,
                              j->ks + b, j->bonf + b, j->sig, 1, j->Dmax,
                              j->Kmax, j->state + b * (j->Kmax + 1),
                              j->n_done + b);
    }
    return NULL;
}

/* (cost, row) pairs by descending cost */
static int dp_cost_cmp(const void *a, const void *b)
{
    int64_t x = *(const int64_t *)a, y = *(const int64_t *)b;
    return x > y ? -1 : x < y;
}

void lfq_poissbin_dp_batch_mt(
    const double *probs, const int64_t *depths, const int64_t *ks,
    const double *bonf, double sig,
    int64_t B, int64_t Dmax, int64_t Kmax,
    double *state, int64_t *n_done, int64_t *threads_used)
{
    int64_t nth = pack_threads();
    int64_t *cost = (nth > 1 && B > 1)
                        ? malloc((size_t)B * 2 * sizeof(int64_t)) : NULL;
    if (cost) {
        int64_t total = 0;
        for (int64_t b = 0; b < B; b++) {
            int64_t n = depths[b], k = ks[b];
            int64_t j = n < k ? n : k;
            cost[2 * b] = j * (j + 1) / 2 + j + (n - j) * (k + 1);
            cost[2 * b + 1] = b;
            total += cost[2 * b];
        }
        if (nth > B)
            nth = B;
        if (nth > total / DP_CELLS_PER_THREAD)
            nth = total / DP_CELLS_PER_THREAD;
    }
    if (!cost || nth < 2) {
        free(cost);
        lfq_poissbin_dp_batch(probs, depths, ks, bonf, sig, B, Dmax, Kmax,
                              state, n_done);
        *threads_used = 1;
        return;
    }
    qsort(cost, (size_t)B, 2 * sizeof(int64_t), dp_cost_cmp);
    dp_job_t job = {probs, depths, ks, bonf, sig, B, Dmax, Kmax,
                    state, n_done, cost, 0};
    pthread_t tids[64];
    int started = 0;
    for (int64_t t = 1; t < nth; t++)
        if (pthread_create(&tids[started], NULL, dp_worker, &job) == 0)
            started++;
    dp_worker(&job);
    for (int t = 0; t < started; t++)
        pthread_join(tids[t], NULL);
    free(cost);
    *threads_used = started + 1;
}
