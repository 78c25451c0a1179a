/* bgzf.c — multithreaded BGZF block scan + inflate.
 *
 * BGZF (the blocked-gzip container of BAM/bgzipped-VCF) is a series of
 * independent <=64 KiB gzip members, which makes inflation embarrassingly
 * parallel.  The reference gets this for free from htslib's bgzf_mt
 * (reference: htslib bgzf.c, used via src/lofreq's sam_read1 path); this
 * is the framework's native equivalent: a header-walk scan pass that maps
 * every block's compressed extent and uncompressed output offset, then a
 * pthread fan-out that raw-inflates blocks (zlib, wbits=-15) straight into
 * a single caller-provided output buffer — no per-block allocations, no
 * Python in the loop.
 *
 * Integrity: each block's ISIZE (trailer) must match inflate's output
 * exactly, same contract as the Python reader (io/bgzf.py).  CRC32 is not
 * re-verified, matching the Python path's zlib raw-inflate behavior.
 */

#include <pthread.h>
#include <stdint.h>
#include <string.h>
#include <zlib.h>

/* libdeflate's raw inflate is ~2-3x zlib's; the builder passes
 * -DLOFREQ_HAVE_LIBDEFLATE (and -ldeflate) only after probing that both
 * the header and the shared lib exist (_native_build.py) — zlib is the
 * fallback everywhere else. */
#if defined(LOFREQ_HAVE_LIBDEFLATE) && defined(__has_include)
#  if __has_include(<libdeflate.h>)
#    include <libdeflate.h>
#    define USE_LIBDEFLATE 1
#  endif
#endif

/* Walk BGZF block headers in comp[0..len).  Every block must be complete
 * (the Python caller reads whole-block spans).  When the arrays are
 * non-NULL (capacity max_blocks) fills, per block i:
 *   c_off[i]  byte offset of the block in comp
 *   c_size[i] total compressed block size (BSIZE+1)
 *   u_off[i]  uncompressed output offset (prefix sum of ISIZE)
 * total_out  <- total uncompressed payload bytes.
 * Returns the block count; -1 on a malformed/truncated block; -2 when
 * max_blocks is too small (call again with the returned count's worth). */
int64_t lfq_bgzf_scan(const uint8_t *comp, int64_t len,
                      int64_t *c_off, int64_t *c_size, int64_t *u_off,
                      int64_t max_blocks, int64_t *total_out)
{
    int64_t off = 0, n = 0, total = 0;
    while (off < len) {
        if (off + 18 > len) return -1;
        const uint8_t *h = comp + off;
        if (h[0] != 0x1f || h[1] != 0x8b || h[2] != 8 || !(h[3] & 4))
            return -1;
        uint16_t xlen = (uint16_t)(h[10] | (h[11] << 8));
        if (off + 12 + xlen + 8 > len) return -1;
        /* find the BC subfield (BSIZE) in the extra area */
        int64_t eo = off + 12, eend = off + 12 + xlen, bsize = -1;
        while (eo + 4 <= eend) {
            uint8_t si1 = comp[eo], si2 = comp[eo + 1];
            uint16_t slen = (uint16_t)(comp[eo + 2] | (comp[eo + 3] << 8));
            if (si1 == 66 && si2 == 67 && slen == 2) {
                if (eo + 6 > eend) return -1;
                bsize = (int64_t)(comp[eo + 4] | (comp[eo + 5] << 8)) + 1;
            }
            eo += 4 + slen;
        }
        if (bsize < 12 + xlen + 8 || off + bsize > len) return -1;
        uint32_t isize;
        memcpy(&isize, comp + off + bsize - 4, 4); /* little-endian host */
        if (c_off) {
            if (n >= max_blocks) return -2;
            c_off[n] = off;
            c_size[n] = bsize;
            u_off[n] = total;
        }
        total += isize;
        off += bsize;
        n++;
    }
    if (total_out) *total_out = total;
    return n;
}

typedef struct {
    const uint8_t *comp;
    const int64_t *c_off, *c_size, *u_off;
    int64_t n, out_len, lo, hi;
    uint8_t *out;
    int32_t rc;
} bgzf_task_t;

static void *inflate_worker(void *arg)
{
    bgzf_task_t *t = (bgzf_task_t *)arg;
#ifdef USE_LIBDEFLATE
    struct libdeflate_decompressor *ld = libdeflate_alloc_decompressor();
    if (!ld) { t->rc = -1; return NULL; }
#else
    z_stream zs;
    memset(&zs, 0, sizeof zs);
    if (inflateInit2(&zs, -15) != Z_OK) { t->rc = -1; return NULL; }
#endif
    for (int64_t i = t->lo; i < t->hi; i++) {
        int64_t isize = ((i + 1 < t->n) ? t->u_off[i + 1] : t->out_len)
                        - t->u_off[i];
        /* cdata sits between the variable-length header and the 8-byte
         * trailer; re-derive xlen from the header (scan validated it) */
        const uint8_t *h = t->comp + t->c_off[i];
        uint16_t xlen = (uint16_t)(h[10] | (h[11] << 8));
        int64_t cdata_len = t->c_size[i] - 12 - xlen - 8;
        if (isize == 0) {
            if (cdata_len > 2) { t->rc = -1; break; } /* EOF marker block */
            continue;
        }
#ifdef USE_LIBDEFLATE
        size_t got = 0;
        enum libdeflate_result r = libdeflate_deflate_decompress(
            ld, h + 12 + xlen, (size_t)cdata_len,
            t->out + t->u_off[i], (size_t)isize, &got);
        if (r != LIBDEFLATE_SUCCESS || got != (size_t)isize) {
            t->rc = -1;
            break;
        }
#else
        zs.next_in = (Bytef *)(h + 12 + xlen);
        zs.avail_in = (uInt)cdata_len;
        zs.next_out = (Bytef *)(t->out + t->u_off[i]);
        zs.avail_out = (uInt)isize;
        int zrc = inflate(&zs, Z_FINISH);
        if (zrc != Z_STREAM_END || zs.avail_out != 0) { t->rc = -1; break; }
        inflateReset(&zs);
#endif
    }
#ifdef USE_LIBDEFLATE
    libdeflate_free_decompressor(ld);
#else
    inflateEnd(&zs);
#endif
    return NULL;
}

/* Parallel inflate of n scanned blocks into out[0..out_len).  Blocks are
 * striped contiguously across threads (BGZF payloads are near-uniform
 * 64 KiB, so contiguous stripes balance and keep output writes
 * sequential per thread).  Returns 0, or -1 on any inflate/ISIZE error. */
int32_t lfq_bgzf_inflate_blocks(const uint8_t *comp, const int64_t *c_off,
                                const int64_t *c_size, const int64_t *u_off,
                                int64_t n, uint8_t *out, int64_t out_len,
                                int32_t nthreads)
{
    if (n <= 0) return 0;
    if (nthreads < 1) nthreads = 1;
    if (nthreads > n) nthreads = (int32_t)n;
    if (nthreads > 16) nthreads = 16;
    bgzf_task_t tasks[16];
    pthread_t tids[16];
    int started[16];
    for (int32_t t = 0; t < nthreads; t++) {
        tasks[t] = (bgzf_task_t){ comp, c_off, c_size, u_off, n, out_len,
                                  n * t / nthreads, n * (t + 1) / nthreads,
                                  out, 0 };
        /* thread 0's stripe runs on the calling thread */
        started[t] = (t > 0) && pthread_create(&tids[t], NULL,
                                               inflate_worker,
                                               &tasks[t]) == 0;
    }
    inflate_worker(&tasks[0]);
    int32_t rc = tasks[0].rc;
    for (int32_t t = 1; t < nthreads; t++) {
        if (started[t]) {
            pthread_join(tids[t], NULL);
            if (tasks[t].rc) rc = tasks[t].rc;
        } else {
            /* pthread_create failed: run the stripe inline */
            inflate_worker(&tasks[t]);
            if (tasks[t].rc) rc = tasks[t].rc;
        }
    }
    return rc;
}
