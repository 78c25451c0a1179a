"""Native BAM ingest: ctypes bridge to csrc/ingest.c.

Raw (BGZF-inflated) BAM record bytes go straight into C, which filters
reads, computes BAQ/IDAQ/source-qual where needed, and returns flat pileup
row arrays — the per-read Python work of pileup.engine.expand_read done
natively in one pass.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from ..io.bai import BaiIndex
from ..io.bam import BamReader
from .engine import PileupConf, ReadRows

from .._native_build import get_native_lib


class _IngestConf(ctypes.Structure):
    _fields_ = [
        ("min_mq", ctypes.c_int32), ("max_mq", ctypes.c_int32),
        ("no_orphan", ctypes.c_int32), ("illumina13", ctypes.c_int32),
        ("use_baq", ctypes.c_int32), ("redo_baq", ctypes.c_int32),
        ("ext_baq", ctypes.c_int32), ("use_idaq", ctypes.c_int32),
        ("redo_idaq", ctypes.c_int32), ("use_sq", ctypes.c_int32),
        ("def_nm_q", ctypes.c_int32), ("sq_min_bq", ctypes.c_int32),
        ("sq_count_eq", ctypes.c_int32),
        ("tid", ctypes.c_int32), ("reg_beg", ctypes.c_int64),
        ("reg_end", ctypes.c_int64),
        ("ign_pos", ctypes.POINTER(ctypes.c_int64)),
        ("n_ign", ctypes.c_int64),
        ("pre_baq", ctypes.POINTER(ctypes.c_uint8)),
        ("pre_have", ctypes.POINTER(ctypes.c_uint8)),
        ("reg_list", ctypes.POINTER(ctypes.c_int64)),
        ("n_reg", ctypes.c_int64),
    ]


def get_lib():
    return get_native_lib()


class SlabPool:
    """Reusable output-buffer arena for the per-window ingest/column
    arrays.  Fresh multi-GB np.empty allocations are mmap-backed, so every
    window would otherwise re-fault ~1M pages — expensive in a microVM
    (measured tens of seconds per deep window).  The call pipeline keeps
    TWO generations (one being consumed, one being prefetched) and rotates
    them, so slabs stay warm.

    Ownership contract: arrays taken from a pool are valid until the same
    generation is reused (two `take_group` rotations later in the
    pipeline).  Callers that keep batches alive longer must not pass a
    pool (fresh allocation is the default everywhere else)."""

    def __init__(self, generations: int = 2):
        import threading

        self._gens = [dict() for _ in range(generations)]
        self._i = 0
        self._lock = threading.Lock()  # pipelined workers rotate concurrently

    def next_gen(self) -> dict:
        with self._lock:
            g = self._gens[self._i % len(self._gens)]
            self._i += 1
        return g

    @staticmethod
    def take(gen: dict | None, name: str, n, dtype):
        dt = np.dtype(dtype)
        need = int(n) * dt.itemsize
        if gen is None:
            return np.empty(int(n), dt)
        a = gen.get(name)
        if a is None or a.nbytes < need:
            # 2x headroom: window/cluster sizes bounce run to run, and a
            # tight fit re-allocates (and re-faults) the slab every time
            # the need crosses the previous high-water mark
            a = np.empty(max(int(need * 2), 256), np.uint8)
            gen[name] = a
        return a[:need].view(dt)

    # -- cross-run recycling ------------------------------------------
    # A run_call allocates ~tens of MB of slabs and drops them on exit;
    # repeated calls in one process (call-parallel workers, benches, a
    # chromosome loop) would re-fault those pages every run.  Finished
    # pools are parked here and handed back to the next acquire() when
    # no outside views pin their slabs (a live view chain keeps a slab's
    # refcount above the parked baseline).
    _park: list = []
    _park_lock = None
    _PARK_MAX_BYTES = 512 << 20

    @classmethod
    def _plock(cls):
        if cls._park_lock is None:
            import threading

            cls._park_lock = threading.Lock()
        return cls._park_lock

    @classmethod
    def acquire(cls, generations: int = 2) -> "SlabPool":
        """A recycled pool with this generation count, else a fresh one."""
        import sys

        with cls._plock():
            best, best_bytes = -1, -1
            for i, p in enumerate(cls._park):
                if len(p._gens) != generations:
                    continue
                # slab refs when free: gen dict + the genexp's `a` local
                # + getrefcount's argument == 3
                if all(sys.getrefcount(a) <= 3
                       for g in p._gens for a in g.values()):
                    nb = sum(a.nbytes for g in p._gens
                             for a in g.values())
                    if nb > best_bytes:
                        best, best_bytes = i, nb
            if best >= 0:
                p = cls._park.pop(best)
                p._i = 0
                return p
        return cls(generations)

    @classmethod
    def release(cls, pool: "SlabPool") -> None:
        """Park a pool for reuse (newest first, bounded total bytes)."""
        if pool is None:
            return
        with cls._plock():
            cls._park.insert(0, pool)
            total = 0
            keep = []
            for p in cls._park:
                total += sum(a.nbytes for g in p._gens for a in g.values())
                if total <= cls._PARK_MAX_BYTES and len(keep) < 6:
                    keep.append(p)
            cls._park[:] = keep


def _conf_struct(conf: PileupConf, tid: int, beg, end,
                 ign_arr=None, reg_list=None) -> _IngestConf:
    from .. import defaults as D

    cs = _IngestConf(
        min_mq=conf.min_mq, max_mq=conf.max_mq,
        no_orphan=1 if conf.no_orphan else 0,
        illumina13=1 if conf.illumina13 else 0,
        use_baq=1 if conf.use_baq else 0,
        redo_baq=1 if conf.redo_baq else 0,
        ext_baq=1 if conf.ext_baq else 0,
        use_idaq=1 if conf.use_idaq else 0,
        redo_idaq=1 if conf.redo_idaq else 0,
        use_sq=1 if conf.use_sq else 0,
        def_nm_q=conf.def_nm_q, sq_min_bq=D.DEFAULT_MIN_BQ,
        sq_count_eq=1 if getattr(conf, "sq_count_eq", False) else 0,
        tid=tid, reg_beg=beg if beg is not None else 0,
        reg_end=end if end is not None else 0,
    )
    if ign_arr is not None and len(ign_arr):
        cs.ign_pos = ign_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
        cs.n_ign = len(ign_arr)
    if reg_list is not None and len(reg_list):
        # sorted non-overlapping [beg, end) interval pairs, flat int64
        cs.reg_list = reg_list.ctypes.data_as(
            ctypes.POINTER(ctypes.c_int64))
        cs.n_reg = len(reg_list) // 2
        cs._reg_keepalive = reg_list
    return cs


_BAI_CACHE: dict = {}   # .bai path -> ((mtime_ns, size), BaiIndex)


def _load_bai(bai_path) -> BaiIndex:
    """The BAI at bai_path, loaded once per mtime and size."""
    st = os.stat(bai_path)
    stamp = (st.st_mtime_ns, st.st_size)
    ent = _BAI_CACHE.get(bai_path)
    if ent is None or ent[0] != stamp:
        ent = (stamp, BaiIndex.load(bai_path))
        _BAI_CACHE[bai_path] = ent
        while len(_BAI_CACHE) > 8:
            _BAI_CACHE.pop(next(iter(_BAI_CACHE)))
    return ent[1]


def raw_records_for_region(rdr: BamReader, tid, beg, end):
    """Raw [size][record] bytes covering the region, via the BAI when
    present (whole remaining stream otherwise): a read-only memoryview
    of the inflated span where the window's records are one range of it
    (raw_view), else bytes, the chunks' payloads joined.

    Inside a traced `ingest.raw` span it notes `bytes` (handed out),
    `copied` (bytes copied to form them: a fallback's bytes, and span
    moved out of a full buffer) and `fresh` (bytes of span buffers newly
    allocated)."""
    from ..core import stagetimer
    from ..io.bgzf import span_bytes

    fresh0, moved0 = span_bytes()
    raw = _raw_records(rdr, tid, beg, end)
    fresh, moved = span_bytes()
    copied = moved - moved0 + (len(raw) if isinstance(raw, bytes) else 0)
    stagetimer.note(bytes=len(raw), copied=copied, fresh=fresh - fresh0)
    return raw


def raw_view(path, chunks, inflate_hint, tid: int, beg: int, end: int):
    """The records a window [beg, end) of tid needs as one read-only view
    of the span cache, nothing copied: chunks are the BAI's for the
    window, whose span is inflated as the chunked path inflates it
    (io.bgzf.native_window_span).  None where that does not hold: no
    chunks, a parse anomaly or a record out of order (csrc/ingest.c:
    lfq_raw_view), or records past the inflated span.  Every record
    overlapping [beg, end) lies in the view, in file order; the others
    are ones every consumer's interval filter drops, so the consumers
    keep what they keep from the chunks' payloads joined."""
    from ..io.bgzf import native_window_span, span_offset

    got = native_window_span(path, chunks, inflate_hint)
    if got is None:
        return None
    payload, c_off, u_off = got
    start = span_offset(c_off, u_off, chunks[0][0])
    if start is None:
        return None
    limit = span_offset(c_off, u_off, max(c[1] for c in chunks))
    if limit is None:       # the chunks end past the span
        limit = np.iinfo(np.int64).max
    lib = get_lib()
    lib.lfq_raw_view.restype = ctypes.c_int64
    out = np.zeros(2, np.int64)
    rc = lib.lfq_raw_view(
        payload.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int64(len(payload)), ctypes.c_int64(start),
        ctypes.c_int64(limit), ctypes.c_int32(tid), ctypes.c_int64(beg),
        ctypes.c_int64(end),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    if rc != 0:
        return None
    return memoryview(payload[int(out[0]):int(out[1])]).toreadonly()


def _raw_records(rdr: BamReader, tid, beg, end):
    """raw_records_for_region's records: the view where raw_view serves
    one, else the chunked path.

    Chunked path: the native multithreaded BGZF inflater (csrc/bgzf.c
    via io.bgzf.native_extract_multi) — the per-window data-loading
    bottleneck lives here, so blocks inflate on a pthread pool instead
    of Python's per-block zlib loop.  Any parse anomaly falls back to
    the Python BgzfReader (identical output, slower)."""
    from ..io.bgzf import native_extract_multi, native_extract_voffsets

    bai_path = rdr.path + ".bai"
    if tid is not None and os.path.exists(bai_path):
        idx = _load_bai(bai_path)
        b, e = beg or 0, end if end else 1 << 29
        chunks = idx.query(tid, b, e)
        # inflate ~2 windows ahead so the next sequential fetches land
        # fully inside the cached span (pure zero-copy slices)
        hint = None
        if beg is not None and end is not None and end > beg:
            ahead = idx.query(tid, end, end + 2 * (end - beg))
            if ahead:
                hint = max(c[1] for c in ahead)
        view = raw_view(rdr.path, chunks, hint, tid, b, e)
        if view is not None:
            return view
        merged = native_extract_multi(rdr.path, chunks, inflate_hint=hint)
        if merged is not None:
            return merged
        parts = []
        for cbeg, cend in chunks:
            fast = native_extract_voffsets(rdr.path, cbeg, cend)
            if fast is None:
                rdr._bgzf.seek_virtual(cbeg)
                fast = rdr._bgzf.read_until_voffset(cend)
            parts.append(fast)
        return b"".join(parts)
    fast = native_extract_voffsets(rdr.path, rdr._first_rec_voffset, None)
    if fast is not None:
        return fast
    rdr.rewind()
    return rdr._bgzf.read()


def trim_raw_to_regions(raw, tid: int, reg_list) -> bytes | None:
    """Slice a pos-sorted raw record blob down to the records that can
    overlap any [beg, end) interval of reg_list (csrc/ingest.c:
    lfq_raw_ranges — a conservative superset; the ingest re-applies the
    exact interval filter).  Returns None when the native pass bails
    (callers use the full blob).  The exact-confirm pass uses this so
    re-scoring ~100 candidate columns parses ~the cluster reads instead
    of the whole window's records (measured 1.25s -> ~0.3s of the
    confirm stage on the bench workload)."""
    lib = get_lib()
    reg = np.ascontiguousarray(reg_list, dtype=np.int64)
    n_reg = len(reg) // 2
    if n_reg == 0 or not raw:
        return None
    buf = np.frombuffer(raw, dtype=np.uint8)
    max_ranges = 4 * n_reg + 16
    ranges = np.zeros(2 * max_ranges, np.int64)
    lib.lfq_raw_ranges.restype = ctypes.c_int64
    i64p = ctypes.POINTER(ctypes.c_int64)
    n = lib.lfq_raw_ranges(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int64(len(raw)), ctypes.c_int32(tid),
        reg.ctypes.data_as(i64p), ctypes.c_int64(n_reg),
        ranges.ctypes.data_as(i64p), ctypes.c_int64(max_ranges))
    if n < 0:
        return None
    if n == 0:
        return b""
    return b"".join(raw[int(ranges[2 * i]):int(ranges[2 * i + 1])]
                    for i in range(n))


# rows-per-raw-byte estimate for the countless fused path: monotone max
# of observed ratios (over-allocating a grow-only slab is cheap; a retry
# costs one extra prep+count inside C)
_ROWS_RATIO = 1.0


def _rows_estimate(raw) -> int:
    return int(len(raw) * _ROWS_RATIO) + 4096


def _note_rows_ratio(rows: int, raw_len: int) -> None:
    global _ROWS_RATIO
    if raw_len > 0:
        r = rows / raw_len * 1.1
        if r > _ROWS_RATIO:
            _ROWS_RATIO = r


_extract_scratch = None


def _scratch_take(name: str, shape, dtype):
    """Grow-only per-thread scratch buffers for the extract arrays: a
    fresh 160 MB np.empty per window would re-fault ~40k pages each time
    (same rationale as SlabPool; per-thread because pipelined workers
    extract concurrently)."""
    global _extract_scratch
    import threading

    if _extract_scratch is None:
        _extract_scratch = threading.local()
    d = getattr(_extract_scratch, "d", None)
    if d is None:
        d = _extract_scratch.d = {}
    dt = np.dtype(dtype)
    need = int(np.prod(shape)) * dt.itemsize
    a = d.get(name)
    if a is None or a.nbytes < need:
        a = d[name] = np.empty(max(int(need * 1.25), 256), np.uint8)
    return a[:need].view(dt).reshape(shape)


def _splice_device_baq(lib, buf, raw, cs, ref, n_reads, device_baq):
    """Run the device BAQ for eligible reads of this window and attach the
    precomputed buffer to the ingest conf.  Returns keepalive arrays (or
    None when nothing was spliced; the C BAQ then covers everything)."""
    from ..core import stagetimer

    u8p = ctypes.POINTER(ctypes.c_uint8)
    bufp = buf.ctypes.data_as(u8p)
    with stagetimer.stage("ingest.extract"):
        L = lib.lfq_mode_read_len(bufp, ctypes.c_int64(len(raw)),
                                  ctypes.byref(cs))
        if L < 16:
            return None
        elig = _scratch_take("elig", (n_reads,), np.uint8)
        pos = _scratch_take("pos", (n_reads,), np.int64)
        lq = _scratch_take("lq", (n_reads,), np.int32)
        codes = _scratch_take("codes", (n_reads, L), np.uint8)
        quals = _scratch_take("quals", (n_reads, L), np.uint8)
        xb = _scratch_take("xb", (n_reads,), np.int64)
        xe = _scratch_take("xe", (n_reads,), np.int64)
        lib.lfq_extract_reads.restype = ctypes.c_int64
        k = lib.lfq_extract_reads(
            bufp, ctypes.c_int64(len(raw)), ctypes.byref(cs),
            ctypes.c_int64(len(ref)), ctypes.c_int32(L),
            elig.ctypes.data_as(u8p),
            pos.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            lq.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            codes.ctypes.data_as(u8p), quals.ctypes.data_as(u8p),
            xb.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            xe.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        )
        if k != n_reads:
            raise IOError("native ingest: extract/count read mismatch")
    idx = np.nonzero(elig)[0]
    if not len(idx):
        return None
    with stagetimer.stage("ingest.device_baq"):
        baq = device_baq.run(ref, codes[idx], quals[idx], pos[idx],
                             xb[idx], xe[idx])
    if baq is None:  # device unavailable/degraded: C BAQ fallback
        return None
    seq_start = np.zeros(n_reads + 1, np.int64)
    np.cumsum(lq, out=seq_start[1:])
    # scratch-reused: lanes are only read under pre_have[i]=1, and those
    # are fully rewritten below each window
    pre = _scratch_take("pre", (int(seq_start[-1]) + n_reads + 1,),
                        np.uint8)
    offs = seq_start[idx] + idx
    enc = baq.astype(np.uint8) + 33
    # write per contiguous run of eligible reads: consecutive length-L
    # reads sit at stride L+1 in the tag buffer, so each run is a pure
    # reshaped view store (the fancy-scatter alternative materializes an
    # O(total bases) int64 index — GBs at deep windows)
    run_breaks = np.nonzero(np.diff(offs) != L + 1)[0] + 1
    lo = 0
    for hi in list(run_breaks) + [len(idx)]:
        m = hi - lo
        if m:
            view = pre[offs[lo]: offs[lo] + m * (L + 1)]
            view.reshape(m, L + 1)[:, :L] = enc[lo:hi]
        lo = hi
    pre_have = np.zeros(n_reads, np.uint8)
    pre_have[idx] = 1
    cs.pre_baq = pre.ctypes.data_as(u8p)
    cs.pre_have = pre_have.ctypes.data_as(u8p)
    return (pre, pre_have)


def ingest_region(rdr: BamReader, conf: PileupConf, ref: bytes,
                  tid: int, beg=None, end=None,
                  raw: bytes = None, ign_pos=None,
                  device_baq=None, pool: SlabPool = None,
                  keep_raw=False, reg_list=None) -> ReadRows:
    """Run the native ingest for reads overlapping [beg, end) on tid.
    ign_pos: sorted np.int64 positions (this chrom) to ignore in the
    source-qual mismatch count (-S vcf).  device_baq: optional device BAQ
    runner (ops.device_baq); eligible reads get device-computed BAQ spliced
    into the fill, the C kernel covering the rest.  pool: optional SlabPool
    whose next generation backs the row arrays (see SlabPool contract).
    keep_raw: attach the raw record bytes as .raw (the device-BAQ confirm
    pass re-ingests candidate clusters from them without touching the
    BAM again).  reg_list: flat int64 array of sorted non-overlapping
    [beg, end) pairs — keeps only reads overlapping any interval (the
    confirm pass covers every candidate cluster in one ingest)."""
    from ..core import stagetimer

    lib = get_lib()
    if raw is None:
        with stagetimer.stage("ingest.raw"):
            raw = raw_records_for_region(rdr, tid, beg, end)
    if not raw:
        return ReadRows.empty()
    ign_arr = None
    if ign_pos is not None and len(ign_pos):
        ign_arr = np.ascontiguousarray(np.asarray(sorted(ign_pos)),
                                       dtype=np.int64)
    cs = _conf_struct(conf, tid, beg, end, ign_arr=ign_arr,
                      reg_list=reg_list)
    cs._ign_keepalive = ign_arr
    counts = np.zeros(5, dtype=np.int64)
    buf = np.frombuffer(raw, dtype=np.uint8)
    with stagetimer.stage("ingest.count"):
        rc = lib.lfq_ingest_count(
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.c_int64(len(raw)), ctypes.byref(cs),
            counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        )
    if rc != 0:
        raise IOError("native ingest: corrupt BAM record stream")
    n_reads, n_rows, n_ev, ev_seq_total, _seq_total = counts
    if device_baq is not None and conf.use_baq and n_reads > 0:
        cs._pre_keepalive = _splice_device_baq(lib, buf, raw, cs, ref,
                                               int(n_reads), device_baq)
    if n_rows == 0:
        return ReadRows.empty()

    gen = pool.next_gen() if pool is not None else None
    tk = SlabPool.take
    o = dict(
        pos=tk(gen, "pos", n_rows, np.int64),
        nt4=tk(gen, "nt4", n_rows, np.uint8),
        bq=tk(gen, "bq", n_rows, np.int16),
        baq=tk(gen, "baq", n_rows, np.int16),
        mq=tk(gen, "mq", n_rows, np.int16),
        sq=tk(gen, "sq", n_rows, np.int32),
        flags=tk(gen, "flags", n_rows, np.uint8),
        indel=tk(gen, "indel", n_rows, np.int32),
        iq=tk(gen, "iq", n_rows, np.int16),
        dq=tk(gen, "dq", n_rows, np.int16),
        iaq=tk(gen, "iaq", n_rows, np.int16),
        daq=tk(gen, "daq", n_rows, np.int16),
        event_id=tk(gen, "event_id", n_rows, np.int64),
        ev_isins=tk(gen, "ev_isins", max(n_ev, 1), np.uint8),
        ev_seq_start=tk(gen, "ev_seq_start", n_ev + 1, np.int64),
        ev_seq=tk(gen, "ev_seq", max(ev_seq_total, 1), np.uint8),
    )

    def p(a, typ):
        return a.ctypes.data_as(ctypes.POINTER(typ))

    out2 = np.zeros(4, dtype=np.int64)
    rc = lib.lfq_ingest_fill(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int64(len(raw)), ctypes.byref(cs),
        ref, ctypes.c_int64(len(ref)),
        p(o["pos"], ctypes.c_int64), p(o["nt4"], ctypes.c_uint8),
        p(o["bq"], ctypes.c_int16), p(o["baq"], ctypes.c_int16),
        p(o["mq"], ctypes.c_int16), p(o["sq"], ctypes.c_int32),
        p(o["flags"], ctypes.c_uint8), p(o["indel"], ctypes.c_int32),
        p(o["iq"], ctypes.c_int16), p(o["dq"], ctypes.c_int16),
        p(o["iaq"], ctypes.c_int16), p(o["daq"], ctypes.c_int16),
        p(o["event_id"], ctypes.c_int64),
        p(o["ev_isins"], ctypes.c_uint8),
        p(o["ev_seq_start"], ctypes.c_int64),
        p(o["ev_seq"], ctypes.c_uint8),
        out2.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    if rc != 0:
        raise IOError("native ingest fill failed")
    assert out2[1] == n_rows, (out2, counts)

    flags = o["flags"]
    _raw_flags = flags  # kept for the fused column builder
    events = []
    starts = o["ev_seq_start"]
    seqbuf = o["ev_seq"].tobytes()
    for i in range(n_ev):
        if o["ev_isins"][i]:
            events.append((seqbuf[starts[i] : starts[i + 1]].decode().upper(),
                           True))
        else:
            events.append((None, False))
    # partially-initialized ReadRows: the flag-derived bool arrays
    # materialize lazily from raw_flags (ReadRows.__getattr__), saving two
    # seconds of astype per 50M rows on the fused path which reads the
    # packed byte directly
    rr = object.__new__(ReadRows)
    rr.pos = o["pos"]
    rr.nt4 = o["nt4"]
    rr.bq = o["bq"]
    rr.baq = o["baq"]
    rr.mq = o["mq"]
    rr.sq = o["sq"]
    rr.indel = o["indel"]  # int32 straight from C (fused path wants int32)
    rr.iq = o["iq"]
    rr.dq = o["dq"]
    rr.iaq = o["iaq"]
    rr.daq = o["daq"]
    rr.event_id = o["event_id"]
    rr.events = events
    rr.raw_flags = _raw_flags
    if keep_raw:
        rr.raw = raw
    return rr


def ingest_columns(rdr: BamReader, pconf: PileupConf, colconf_struct,
                   ref: bytes, tid: int, beg, end,
                   raw: bytes = None, ign_pos=None, device_baq=None,
                   pool: SlabPool = None, reg_list=None):
    """Fused ingest->columns: raw BAM records straight to per-column
    outputs (csrc/ingest.c:lfq_ingest_columns), skipping the row
    materialization — the default SNV call path.  Returns
    (out_dict, C, raw) or (None, 0, raw) when empty; out matches
    fast_columns.build_snv_batch's native output layout."""
    from ..core import stagetimer

    lib = get_lib()
    if raw is None:
        with stagetimer.stage("ingest.raw"):
            raw = raw_records_for_region(rdr, tid, beg, end)
    if not raw:
        return None, 0, raw
    ign_arr = None
    if ign_pos is not None and len(ign_pos):
        ign_arr = np.ascontiguousarray(np.asarray(sorted(ign_pos)),
                                       dtype=np.int64)
    cs = _conf_struct(pconf, tid, beg, end, ign_arr=ign_arr,
                      reg_list=reg_list)
    cs._ign_keepalive = ign_arr
    buf = np.frombuffer(raw, dtype=np.uint8)
    n_rows = None
    if device_baq is not None:
        # the device-BAQ splice needs the read count up front; keep the
        # separate counting pass for that mode only
        counts = np.zeros(5, dtype=np.int64)
        with stagetimer.stage("ingest.count"):
            rc = lib.lfq_ingest_count(
                buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                ctypes.c_int64(len(raw)), ctypes.byref(cs),
                counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            )
        if rc != 0:
            raise IOError("native ingest: corrupt BAM record stream")
        n_reads, n_rows = int(counts[0]), int(counts[1])
        if n_rows == 0:
            return None, 0, raw
        if pconf.use_baq and n_reads > 0:
            cs._pre_keepalive = _splice_device_baq(lib, buf, raw, cs, ref,
                                                   n_reads, device_baq)

    W = int(end - beg)
    gen = pool.next_gen() if pool is not None else None
    tk = SlabPool.take
    out = dict(
        positions=tk(gen, "positions", W, np.int64),
        coverage=tk(gen, "coverage", W, np.int64),
        num_bases=tk(gen, "num_bases", W, np.int64),
        heads=tk(gen, "heads", W, np.int64),
        tails=tk(gen, "tails", W, np.int64),
        ref_nt4=tk(gen, "ref_nt4", W, np.uint8),
        cons_nt4=tk(gen, "cons_nt4", W, np.uint8),
        fw=tk(gen, "fw", W * 5, np.int64),
        rv=tk(gen, "rv", W * 5, np.int64),
        alt_cnt=tk(gen, "alt_cnt", W * 5, np.int64),
        alt_raw=tk(gen, "alt_raw", W * 5, np.int64),
        col_start=tk(gen, "col_start", W + 1, np.int64),
        # screening mode emits order-free f32 probs (screen_flat==1) or
        # u8 log-quantized codes (==2, see icolconf_t); the same buffer
        # pointer is passed either way.  Capacity-sized when the count
        # pass was skipped: the C sweep reports the needed row count
        # (-2) before its expensive stripes and we grow + retry — one
        # cheap retry on the first window, none in steady state.
        probs=tk(gen, "probs",
                 n_rows if n_rows is not None
                 else max(_rows_estimate(raw), 4096),
                 np.uint8
                 if getattr(colconf_struct, "screen_flat", 0) == 2
                 else np.float32
                 if getattr(colconf_struct, "screen_flat", 0)
                 else np.float64),
        num_ins=tk(gen, "num_ins", W, np.int64),
        num_dels=tk(gen, "num_dels", W, np.int64),
        num_non=tk(gen, "num_non", W, np.int64),
        num_ign=tk(gen, "num_ign", W, np.int64),
        ins_ne=tk(gen, "ins_ne", W, np.int64),
        del_ne=tk(gen, "del_ne", W, np.int64),
        ins_ev=tk(gen, "ins_ev", W, np.int64),
        del_ev=tk(gen, "del_ev", W, np.int64),
    )

    def i64(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))

    u8 = ctypes.POINTER(ctypes.c_uint8)
    f64 = ctypes.POINTER(ctypes.c_double)
    lib.lfq_ingest_columns.restype = ctypes.c_int64
    need = ctypes.c_int64(0)
    with stagetimer.stage("ingest.columns"):
        while True:
            # cap check only when the count pass was skipped (n_rows
            # unknown); with an exact count the legacy contract holds
            cap = 0 if n_rows is not None else len(out["probs"])
            C = lib.lfq_ingest_columns(
                buf.ctypes.data_as(u8), ctypes.c_int64(len(raw)),
                ctypes.byref(cs), ctypes.byref(colconf_struct),
                ctypes.c_int64(beg), ctypes.c_int64(end),
                ref, ctypes.c_int64(len(ref)),
                i64(out["positions"]), i64(out["coverage"]),
                i64(out["num_bases"]), i64(out["heads"]),
                i64(out["tails"]),
                out["ref_nt4"].ctypes.data_as(u8),
                out["cons_nt4"].ctypes.data_as(u8),
                i64(out["fw"]), i64(out["rv"]),
                i64(out["alt_cnt"]), i64(out["alt_raw"]),
                i64(out["col_start"]), out["probs"].ctypes.data_as(f64),
                i64(out["num_ins"]), i64(out["num_dels"]),
                i64(out["num_non"]),
                i64(out["num_ign"]), i64(out["ins_ne"]),
                i64(out["del_ne"]),
                i64(out["ins_ev"]), i64(out["del_ev"]),
                ctypes.c_int64(cap), ctypes.byref(need),
            )
            if C != -2:
                break
            _note_rows_ratio(int(need.value), len(raw))
            out["probs"] = SlabPool.take(gen, "probs", int(need.value),
                                         out["probs"].dtype)
    if C < 0:
        raise IOError("native fused ingest failed")
    if C > 0 and n_rows is None:
        _note_rows_ratio(int(out["col_start"][C]), len(raw))
    return (out if C else None), int(C), raw
