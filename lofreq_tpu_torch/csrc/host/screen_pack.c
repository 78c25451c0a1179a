/* screen_pack.c — per-column top-S log-quantized screen codes.
 *
 * The device significance screen (lofreq_tpu/ops/screen.py) consumes,
 * per pileup column, the S=128 LARGEST err probs as u8 codes c with
 * decode 2^(-c/8) <= p (conservative: understating a prob only shrinks
 * the screened tail lower bound, which only ADDS exact-confirm
 * candidates — output-identical by construction).
 *
 * The host used to produce these with an np.partition + log2 pass per
 * 4096-column chunk (~10-30ms each, dozens per call).  Here the same
 * selection is a counting pass over the 256 possible codes: quantize
 * each prob with integer bit tricks (no libm), histogram its code, then
 * walk codes ascending (= probs descending) emitting up to S — output
 * arrives already sorted, at memory bandwidth.
 *
 * Quantization: for normal f32 p in (0,1), p >= p_low = 2^e * (1+m/256)
 * where e is the unbiased exponent and m the top-8 mantissa bits
 * (truncation).  code = -8e + ceil(-8*log2(1+m/256)) satisfies
 * 2^(-code/8) <= p_low <= p.  Subnormals and p<=0 map to 255 (decode
 * 0.0, the DP identity); p >= 1 maps to 0 (decode 1.0 <= p).
 *
 * Replaces the screen-side work of the reference's per-column qsort
 * feed (snpcaller.c:780-800); the exact DP path keeps its own
 * eps-comparator sort untouched.
 */

#include <math.h>
#include <pthread.h>
#include <stdint.h>
#include <string.h>

static int8_t CEIL8LUT[256];
static pthread_once_t lut_once = PTHREAD_ONCE_INIT;

static void lut_init(void)
{
    /* plain ceil is conservative: computed v can only under-shoot the
     * true value by ulps, and the true value is an integer only at m=0
     * (v=0, computed exactly) — elsewhere an ulp can't cross a ceil
     * boundary downward */
    for (int m = 0; m < 256; m++)
        CEIL8LUT[m] = (int8_t)ceil(-8.0 * log2(1.0 + m / 256.0));
}

/* double-precision variant, exported for the fused sweep (ingest.c
 * screen_flat==2 emits codes directly, skipping the f32 CSR entirely):
 * p >= p_low = 2^e * (1+m/256) by mantissa truncation, so
 * 2^(-code/8) <= p_low <= p — strictly conservative, no intermediate
 * f32 rounding. */
uint8_t lfq_u8code_f64(double p)
{
    pthread_once(&lut_once, lut_init);
    if (!(p > 0.0))
        return 255;
    if (p >= 1.0)
        return 0;
    uint64_t u;
    memcpy(&u, &p, 8);
    int e = (int)((u >> 52) & 0x7FF) - 1023; /* subnormal -> -1023 */
    if (e <= -32)
        return 255;
    int m = (int)((u >> 44) & 0xFF);
    int c = -8 * e + CEIL8LUT[m];
    if (c > 254)
        return 255;
    return (uint8_t)(c < 0 ? 0 : c);
}

static inline int code_of(float p)
{
    if (!(p > 0.0f))
        return 255;                 /* <=0 or NaN: identity */
    if (p >= 1.0f)
        return 0;
    uint32_t u;
    memcpy(&u, &p, 4);
    int e = (int)(u >> 23) - 127;   /* p<1 -> e <= -1; subnormal e=-127 */
    if (e <= -32)
        return 255;                 /* code would exceed 254 */
    int m = (int)((u >> 15) & 0xFF);
    int c = -8 * e + CEIL8LUT[m];
    if (c > 254)
        return 255;
    return c < 0 ? 0 : c;
}

typedef struct {
    const float *flat;
    const uint8_t *flat8;     /* pre-quantized CSR (screen_flat==2) */
    const int64_t *starts;
    const int64_t *cols;
    int64_t n;
    int32_t S;
    uint8_t *out;
    int64_t lo, hi;
} scodes_task_t;

static void *scodes_worker(void *arg)
{
    scodes_task_t *t = (scodes_task_t *)arg;
    int32_t S = t->S;
    for (int64_t i = t->lo; i < t->hi; i++) {
        int64_t c = t->cols[i];
        int64_t s0 = t->starts[c];
        int64_t d = t->starts[c + 1] - s0;
        uint8_t *o = t->out + i * S;
        int32_t hist[256];
        memset(hist, 0, sizeof hist);
        if (t->flat8) {
            const uint8_t *p = t->flat8 + s0;
            for (int64_t j = 0; j < d; j++)
                hist[p[j]]++;
        } else {
            const float *p = t->flat + s0;
            for (int64_t j = 0; j < d; j++)
                hist[code_of(p[j])]++;
        }
        int32_t k = 0;
        for (int cc = 0; cc < 255 && k < S; cc++) {
            int32_t take = hist[cc];
            if (take > S - k)
                take = S - k;
            for (int32_t r = 0; r < take; r++)
                o[k++] = (uint8_t)cc;
        }
        while (k < S)
            o[k++] = 255;
    }
    return NULL;
}

/* Fill out[n*S] with each selected column's top-S codes (ascending,
 * 255-padded).  flat/starts: the CSR from the fused column sweep
 * (screen_flat f32 probs); cols[n]: selected column ids. */
static void run_scodes(const float *flat, const uint8_t *flat8,
                       const int64_t *starts, const int64_t *cols,
                       int64_t n, int32_t S, uint8_t *out,
                       int32_t nthreads)
{
    pthread_once(&lut_once, lut_init);
    if (n <= 0)
        return;
    if (nthreads < 1)
        nthreads = 1;
    if (nthreads > 8)
        nthreads = 8;
    if (nthreads > n)
        nthreads = (int32_t)n;
    scodes_task_t tasks[8];
    pthread_t tids[8];
    int started[8];
    for (int32_t t = 0; t < nthreads; t++) {
        tasks[t] = (scodes_task_t){ flat, flat8, starts, cols, n, S, out,
                                    n * t / nthreads,
                                    n * (t + 1) / nthreads };
        started[t] = (t > 0) && pthread_create(&tids[t], NULL,
                                               scodes_worker,
                                               &tasks[t]) == 0;
    }
    scodes_worker(&tasks[0]);
    for (int32_t t = 1; t < nthreads; t++) {
        if (started[t])
            pthread_join(tids[t], NULL);
        else
            scodes_worker(&tasks[t]);
    }
}

void lfq_screen_codes(const float *flat, const int64_t *starts,
                      const int64_t *cols, int64_t n, int32_t S,
                      uint8_t *out, int32_t nthreads)
{
    run_scodes(flat, NULL, starts, cols, n, S, out, nthreads);
}

/* CSR already quantized by the fused sweep (screen_flat==2): pure
 * counting select, no per-prob arithmetic at all. */
void lfq_screen_codes_u8(const uint8_t *flat8, const int64_t *starts,
                         const int64_t *cols, int64_t n, int32_t S,
                         uint8_t *out, int32_t nthreads)
{
    run_scodes(NULL, flat8, starts, cols, n, S, out, nthreads);
}
