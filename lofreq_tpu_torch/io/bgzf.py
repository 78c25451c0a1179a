"""BGZF (blocked gzip) reader/writer.

BGZF is a series of gzip members, each with an extra subfield (SI 'BC')
holding the total compressed block size; blocks hold <= 65536 bytes of
uncompressed payload.  Used for BAM and bgzipped VCF.  Equivalent role to
htslib's bgzf.{c,h} which the reference links (e.g. vcf.c uses BGZF for .gz
VCFs).
"""

from __future__ import annotations

import io
import os
import struct
import zlib

_POOL = None
_POOL_PID = None


def _inflate_pool():
    """Shared thread pool for bulk block inflation (zlib releases the
    GIL, so plain threads scale it).  Keyed on PID: a fork-based worker
    (call-parallel) would inherit a dead executor whose queue lock can be
    held mid-map — each process gets a fresh pool instead."""
    global _POOL, _POOL_PID
    pid = os.getpid()
    if _POOL is None or _POOL_PID != pid:
        n = int(os.environ.get("LOFREQ_BGZF_THREADS",
                               min(4, os.cpu_count() or 1)))
        if n <= 1:
            _POOL = False       # caller falls back to serial inflation
            _POOL_PID = pid
            return _POOL
        from concurrent.futures import ThreadPoolExecutor

        _POOL = ThreadPoolExecutor(max_workers=n,
                                   thread_name_prefix="bgzf-inflate")
        _POOL_PID = pid
    return _POOL

BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000"
)

_MAX_BLOCK_PAYLOAD = 65280  # htslib default


class BgzfError(IOError):
    pass


def _read_block(fh):
    """Read one BGZF block. Returns (payload_bytes, compressed_size) or
    (None, 0) at EOF."""
    header = fh.read(12)
    if len(header) == 0:
        return None, 0
    if len(header) < 12:
        raise BgzfError("truncated BGZF header")
    magic1, magic2, method, flags, _mtime, _xfl, _os, xlen = struct.unpack(
        "<BBBBIBBH", header
    )
    if magic1 != 0x1F or magic2 != 0x8B or method != 8 or not (flags & 4):
        raise BgzfError("not a BGZF block")
    extra = fh.read(xlen)
    bsize = None
    off = 0
    while off + 4 <= len(extra):
        si1, si2, slen = struct.unpack_from("<BBH", extra, off)
        if si1 == 66 and si2 == 67 and slen == 2:
            bsize = struct.unpack_from("<H", extra, off + 4)[0] + 1
        off += 4 + slen
    if bsize is None:
        raise BgzfError("BGZF block without BC subfield")
    cdata_len = bsize - 12 - xlen - 8
    cdata = fh.read(cdata_len)
    tail = fh.read(8)
    if len(cdata) < cdata_len or len(tail) < 8:
        raise BgzfError("truncated BGZF block")
    crc, isize = struct.unpack("<II", tail)
    payload = zlib.decompress(cdata, wbits=-15)
    if len(payload) != isize:
        raise BgzfError("BGZF ISIZE mismatch")
    return payload, bsize


class BgzfReader(io.RawIOBase):
    """Streaming BGZF decompressor with virtual-offset support.

    Virtual offsets are (coffset << 16) | uoffset as in htslib, enabling
    BAI/TBI-style random access.
    """

    def __init__(self, path_or_fh):
        if isinstance(path_or_fh, (str, os.PathLike)):
            self._fh = open(path_or_fh, "rb")
            self._own = True
        else:
            self._fh = path_or_fh
            self._own = False
        self._block = b""
        self._block_coffset = 0  # file offset of current block
        self._within = 0  # offset within current block
        self._eof = False

    # -- virtual offsets ------------------------------------------------
    def tell_virtual(self) -> int:
        return (self._block_coffset << 16) | self._within

    def seek_virtual(self, voffset: int) -> None:
        coffset = voffset >> 16
        uoffset = voffset & 0xFFFF
        self._fh.seek(coffset)
        self._block_coffset = coffset
        self._eof = False
        payload, _ = _read_block(self._fh)
        if payload is None:
            self._block = b""
            self._eof = True
            self._within = 0
            return
        self._block = payload
        self._within = uoffset

    # -- reading --------------------------------------------------------
    def _fill(self) -> bool:
        while self._within >= len(self._block):
            coffset = self._fh.tell()
            payload, _ = _read_block(self._fh)
            if payload is None:
                self._eof = True
                return False
            self._block_coffset = coffset
            self._block = payload
            self._within = 0
            # zero-length blocks (EOF marker) are skipped by the loop
        return True

    def read(self, n=-1):
        out = []
        if n is None or n < 0:
            while self._fill():
                out.append(self._block[self._within:])
                self._within = len(self._block)
            return b"".join(out)
        remaining = n
        while remaining > 0:
            if not self._fill():
                break
            chunk = self._block[self._within : self._within + remaining]
            self._within += len(chunk)
            remaining -= len(chunk)
            out.append(chunk)
        return b"".join(out)

    def readable(self):
        return True

    def read_until_voffset(self, vend: int) -> bytes:
        """Read raw bytes from the current position up to virtual offset
        vend (exclusive).  vend must lie at or after the current position.

        Bulk path: the compressed range up to the final block is read with
        one file read and its blocks are inflated on a thread pool; any
        parse anomaly falls back to the block-at-a-time loop."""
        cend = vend >> 16
        uend = vend & 0xFFFF
        out = []
        # drain / finish within the current block first
        if not self._fill():
            return b""
        if self._block_coffset >= cend:
            take = uend - self._within
            if take > 0:
                out.append(self._block[self._within : self._within + take])
                self._within += take
            return b"".join(out)
        out.append(self._block[self._within :])
        self._within = len(self._block)

        start = self._fh.tell()
        if cend > start:
            raw = self._fh.read(cend - start)
            spans = self._parse_spans(raw)
            if spans is None or (spans and spans[-1][3] != len(raw)) or \
                    len(raw) != cend - start:
                # malformed / short mid-stream: retry block-at-a-time
                self._fh.seek(start)
                return b"".join(out) + self._read_until_voffset_slow(vend)
            pool = _inflate_pool() if len(spans) >= 4 else None
            if pool:
                payloads = list(pool.map(
                    lambda s: zlib.decompress(raw[s[0]:s[1]], wbits=-15),
                    spans))
            else:
                payloads = [zlib.decompress(raw[a:b], wbits=-15)
                            for a, b, _, _ in spans]
            for p, (_, _, isize, _) in zip(payloads, spans):
                if len(p) != isize:
                    raise BgzfError("BGZF ISIZE mismatch")
            out.extend(payloads)

        # load the final block (at cend) and take up to uend
        self._block_coffset = self._fh.tell()
        payload, _ = _read_block(self._fh)
        if payload is None:
            self._block = b""
            self._within = 0
            self._eof = True
            return b"".join(out)
        self._block = payload
        self._within = 0
        if uend > 0:
            out.append(self._block[:uend])
            self._within = uend
        return b"".join(out)

    @staticmethod
    def _parse_spans(raw: bytes):
        """Parse consecutive BGZF block headers in raw; returns a list of
        (cdata_start, cdata_end, isize, block_end) or None on anomaly."""
        spans = []
        off = 0
        n = len(raw)
        while off < n:
            if off + 12 > n:
                return None
            if raw[off] != 0x1F or raw[off + 1] != 0x8B or \
                    raw[off + 2] != 8 or not (raw[off + 3] & 4):
                return None
            xlen = struct.unpack_from("<H", raw, off + 10)[0]
            if off + 12 + xlen > n:
                return None
            bsize = None
            eo = off + 12
            eend = eo + xlen
            while eo + 4 <= eend:
                si1, si2, slen = struct.unpack_from("<BBH", raw, eo)
                if si1 == 66 and si2 == 67 and slen == 2:
                    bsize = struct.unpack_from("<H", raw, eo + 4)[0] + 1
                eo += 4 + slen
            if bsize is None or off + bsize > n or bsize < 12 + xlen + 8:
                return None
            isize = struct.unpack_from("<I", raw, off + bsize - 4)[0]
            spans.append((off + 12 + xlen, off + bsize - 8, isize,
                          off + bsize))
            off += bsize
        return spans

    def _read_until_voffset_slow(self, vend: int) -> bytes:
        cend = vend >> 16
        uend = vend & 0xFFFF
        out = []
        while True:
            if not self._fill():
                break
            if self._block_coffset >= cend:
                take = uend - self._within
                if take > 0:
                    out.append(self._block[self._within : self._within + take])
                    self._within += take
                break
            out.append(self._block[self._within :])
            self._within = len(self._block)
        return b"".join(out)

    def readline(self, size=-1):
        out = []
        while True:
            if not self._fill():
                break
            idx = self._block.find(b"\n", self._within)
            if idx >= 0:
                out.append(self._block[self._within : idx + 1])
                self._within = idx + 1
                break
            out.append(self._block[self._within :])
            self._within = len(self._block)
        return b"".join(out)

    def close(self):
        if self._own:
            self._fh.close()
        super().close()


def _deflate_block(payload: bytes, level: int) -> bytes:
    """One BGZF block (or several, when incompressible) as bytes —
    deterministic, so parallel compression writes the same file as
    serial."""
    co = zlib.compressobj(level, zlib.DEFLATED, -15)
    cdata = co.compress(payload) + co.flush()
    bsize = len(cdata) + 12 + 6 + 8
    if bsize > 65536:
        # incompressible payload: store shorter blocks
        half = len(payload) // 2
        return (_deflate_block(payload[:half], level)
                + _deflate_block(payload[half:], level))
    header = struct.pack(
        "<BBBBIBBHBBHH",
        0x1F, 0x8B, 8, 4, 0, 0, 0xFF, 6, 66, 67, 2, bsize - 1,
    )
    tail = struct.pack("<II", zlib.crc32(payload) & 0xFFFFFFFF,
                       len(payload))
    return header + cdata + tail


class BgzfWriter(io.RawIOBase):
    """BGZF writer with ordered parallel block compression (zlib releases
    the GIL; blocks are independent and written strictly in order, so the
    output bytes are identical to serial compression)."""

    _MAX_PENDING = 32

    def __init__(self, path_or_fh, level=6):
        if isinstance(path_or_fh, (str, os.PathLike)):
            self._fh = open(path_or_fh, "wb")
            self._own = True
        else:
            self._fh = path_or_fh
            self._own = False
        self._level = level
        self._buf = bytearray()
        from collections import deque

        self._jobs = deque()

    def tell_virtual(self) -> int:
        # exact compressed offsets require pending blocks on disk
        self._drain(all_jobs=True)
        return (self._fh.tell() << 16) | len(self._buf)

    def write(self, data) -> int:
        self._buf += data
        while len(self._buf) >= _MAX_BLOCK_PAYLOAD:
            self._submit(bytes(self._buf[:_MAX_BLOCK_PAYLOAD]))
            del self._buf[:_MAX_BLOCK_PAYLOAD]
        return len(data)

    def _submit(self, payload: bytes):
        pool = _inflate_pool()
        if not pool:
            self._fh.write(_deflate_block(payload, self._level))
            return
        self._jobs.append(pool.submit(_deflate_block, payload,
                                      self._level))
        self._drain(all_jobs=False)

    def _drain(self, all_jobs: bool):
        jobs = self._jobs
        while jobs and (all_jobs or jobs[0].done()
                        or len(jobs) > self._MAX_PENDING):
            self._fh.write(jobs.popleft().result())

    def flush_block(self):
        if self._buf:
            self._submit(bytes(self._buf))
            self._buf.clear()
        self._drain(all_jobs=True)

    def writable(self):
        return True

    def close(self):
        if self.closed:
            return
        self.flush_block()
        self._fh.write(BGZF_EOF)
        if self._own:
            self._fh.close()
        else:
            self._fh.flush()
        super().close()


def is_bgzf(path) -> bool:
    with open(path, "rb") as fh:
        head = fh.read(18)
    if len(head) < 18 or head[0] != 0x1F or head[1] != 0x8B:
        return False
    return head[3] & 4 != 0 and head[12] == 66 and head[13] == 67


def is_gzip(path) -> bool:
    with open(path, "rb") as fh:
        head = fh.read(2)
    return head == b"\x1f\x8b"


# -- native multithreaded extraction -----------------------------------

_NATIVE = None


def _native_lib():
    """csrc/bgzf.c via the shared native lib, or None (pure-Python
    fallback stays available everywhere)."""
    global _NATIVE
    if _NATIVE is not None:
        return _NATIVE or None
    try:
        import ctypes

        from .._native_build import get_native_lib

        lib = get_native_lib()
        lib.lfq_bgzf_scan.restype = ctypes.c_int64
        lib.lfq_bgzf_inflate_blocks.restype = ctypes.c_int32
        _NATIVE = lib
    except Exception:
        _NATIVE = False
    return _NATIVE or None


def _native_threads() -> int:
    n = os.environ.get("LOFREQ_BGZF_THREADS")
    if n is not None:
        return max(1, int(n))
    return min(4, os.cpu_count() or 1)


def _block_bsize_at(fh, coffset: int):
    """Compressed size (BSIZE+1) of the block starting at coffset, or
    None when the header doesn't parse (caller falls back)."""
    fh.seek(coffset)
    head = fh.read(12)
    if len(head) < 12 or head[0] != 0x1F or head[1] != 0x8B or \
            head[2] != 8 or not (head[3] & 4):
        return None
    xlen = struct.unpack_from("<H", head, 10)[0]
    extra = fh.read(xlen)
    if len(extra) < xlen:
        return None
    off = 0
    while off + 4 <= xlen:
        si1, si2, slen = struct.unpack_from("<BBH", extra, off)
        if si1 == 66 and si2 == 67 and slen == 2:
            return struct.unpack_from("<H", extra, off + 4)[0] + 1
        off += 4 + slen
    return None


_MMAP_CACHE: dict = {}   # path -> (mtime_ns, np.memmap) — one live
                         # mapping per input keeps its page-table
                         # entries warm across windows and runs


def _comp_view(path, cbeg: int, span_end: int):
    """Read-only u8 view of file bytes [cbeg, span_end).  Prefers an
    mmap (page-cache-backed, shared, never charged as fresh anonymous
    memory — re-reading the same BAM costs no page zeroing), falling
    back to a plain read()."""
    import numpy as np

    try:
        mtime = os.stat(path).st_mtime_ns
        ent = _MMAP_CACHE.get(path)
        if ent is None or ent[0] != mtime:
            mm = np.memmap(path, dtype=np.uint8, mode="r")
            _MMAP_CACHE[path] = ent = (mtime, mm)
            while len(_MMAP_CACHE) > 4:
                _MMAP_CACHE.pop(next(iter(_MMAP_CACHE)))
        mm = ent[1]
        if span_end <= mm.shape[0]:
            return mm[cbeg:span_end]
    except (OSError, ValueError):
        pass
    try:
        with open(path, "rb") as fh:
            fh.seek(cbeg)
            comp = fh.read(span_end - cbeg)
    except OSError:
        return None
    if len(comp) != span_end - cbeg:
        return None
    return np.frombuffer(comp, dtype=np.uint8)


def _scan_span(lib, buf, cbeg: int, span_end: int):
    """lfq_bgzf_scan over buf (count + fill passes).  Returns
    (c_off abs[n+1], c_size[n], u_off rel[n+1], total) or None."""
    import ctypes

    import numpy as np

    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64p = ctypes.POINTER(ctypes.c_int64)
    total = ctypes.c_int64(0)
    n = lib.lfq_bgzf_scan(buf.ctypes.data_as(u8p),
                          ctypes.c_int64(len(buf)),
                          None, None, None, ctypes.c_int64(0),
                          ctypes.byref(total))
    if n < 0:
        return None
    c_off = np.empty(n + 1, np.int64)
    c_size = np.empty(max(n, 1), np.int64)
    u_off = np.empty(n + 1, np.int64)
    if n == 0:
        c_off[0] = cbeg
        u_off[0] = 0
        return c_off, c_size[:0], u_off, 0
    n2 = lib.lfq_bgzf_scan(buf.ctypes.data_as(u8p),
                           ctypes.c_int64(len(buf)),
                           c_off.ctypes.data_as(i64p),
                           c_size.ctypes.data_as(i64p),
                           u_off.ctypes.data_as(i64p),
                           ctypes.c_int64(n), ctypes.byref(total))
    if n2 != n:
        return None
    c_off[:n] += cbeg
    c_off[n] = span_end
    u_off[n] = int(total.value)
    return c_off, c_size, u_off, int(total.value)


def _inflate_into(lib, buf, c_off, c_size, u_off, out):
    """Parallel-inflate the scanned blocks into out (length = total).
    c_off is absolute; the C call wants buf-relative offsets."""
    import ctypes

    import numpy as np

    n = len(c_size)
    if n == 0:
        return True
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64p = ctypes.POINTER(ctypes.c_int64)
    c_rel = np.ascontiguousarray(c_off[:n] - int(c_off[0]))
    rc = lib.lfq_bgzf_inflate_blocks(
        buf.ctypes.data_as(u8p), c_rel.ctypes.data_as(i64p),
        c_size.ctypes.data_as(i64p), u_off.ctypes.data_as(i64p),
        ctypes.c_int64(n), out.ctypes.data_as(u8p),
        ctypes.c_int64(len(out)), ctypes.c_int32(_native_threads()))
    return rc == 0


def _inflate_span_fresh(path, cbeg: int, span_end: int):
    """Scan + parallel-inflate every whole BGZF block in file byte range
    [cbeg, span_end).  Returns (payload u8 array, abs c_off[n+1] array
    incl. the end sentinel, u_off[n+1] array incl. total) or None."""
    import numpy as np

    lib = _native_lib()
    if lib is None:
        return None
    buf = _comp_view(path, cbeg, span_end)
    if buf is None:
        return None
    scan = _scan_span(lib, buf, cbeg, span_end)
    if scan is None:
        return None
    c_off, c_size, u_off, total = scan
    out = np.empty(total, np.uint8)
    if not _inflate_into(lib, buf, c_off, c_size, u_off, out):
        return None
    return out, c_off, u_off


# One cached inflated span per path: consecutive call windows overlap at
# the BAI-chunk granularity, and window N+1's span prefix is window N's
# suffix — so the cache reuses already-inflated blocks and only the new
# tail hits the inflater.  The span lives inside a PERSISTENT capacity
# buffer: sequential extensions inflate the tail IN PLACE into spare
# capacity (prefix drops just advance an offset), and when capacity runs
# out the live suffix moves into a buffer recycled from _SPAN_FREE.
# Without this, every window extension re-allocated (concatenate) and
# freed a multi-MB span — ~1 GB/run of fresh page faults, 2 MB-folio
# zeroing (numpy madvises THP) and munmap TLB shootdowns, measured as
# multi-second kernel-time stalls on the 4-core bench host.
# Entry: dict(mtime, base u8 capacity buffer, beg int offset of the
# span's first payload byte in base, c_off abs[n+1], u_off rel[n+1]).
# Guarded by _SPAN_LOCK (pipelined window workers fetch concurrently);
# extensions serialize on _SPAN_EXTEND and mutate only spare capacity,
# so handed-out views stay valid.
_SPAN_CACHE: dict = {}
_SPAN_FREE: list = []       # retired base buffers awaiting reuse
_SPAN_LOCK = None
_SPAN_EXTEND = None


def _span_cache_lock():
    global _SPAN_LOCK, _SPAN_EXTEND
    if _SPAN_LOCK is None:
        import threading

        _SPAN_LOCK = threading.Lock()
        _SPAN_EXTEND = threading.Lock()
    return _SPAN_LOCK


def _take_base(need: int):
    """A u8 buffer of capacity >= need: recycled from _SPAN_FREE when a
    retired buffer is big enough and no outside views keep it pinned
    (views of handed-out span slices hold a reference to their base —
    reusing such a buffer would corrupt live windows), else fresh with
    2x headroom so the next few extensions append in place."""
    import sys

    import numpy as np

    with _span_cache_lock():
        for i, arr in enumerate(_SPAN_FREE):
            # refs when free: the list entry + this loop's `arr` local
            # + getrefcount's argument == 3
            if arr.size >= need and sys.getrefcount(arr) <= 3:
                return _SPAN_FREE.pop(i)
    return np.empty(max(int(need * 2), 8 << 20), np.uint8)


def _retire_base(arr):
    """Park a replaced capacity buffer for reuse (newest first, keep 3;
    pinned buffers age out once their views die)."""
    if arr is None or arr.size < (4 << 20):
        return
    _SPAN_FREE.insert(0, arr)
    del _SPAN_FREE[3:]


def _span_slices(ent, i0: int, i1: int):
    """(payload view, abs c_off, rel u_off) for block range [i0, i1)."""
    co, uo = ent["c_off"], ent["u_off"]
    beg = ent["beg"]
    return (ent["base"][beg + uo[i0]:beg + uo[i1]],
            co[i0:i1 + 1], uo[i0:i1 + 1] - uo[i0])


def _inflate_span(path, cbeg: int, span_end: int):
    """_inflate_span_fresh with the persistent per-path span cache.
    Returned arrays must be treated as read-only (they may alias the
    cache)."""
    import numpy as np

    try:
        mtime = os.stat(path).st_mtime_ns
    except OSError:
        return None
    lock = _span_cache_lock()

    def _try_cached():
        """Serve from the current entry; 'extend' when cbeg is inside
        but span_end is past the cached end."""
        ent = _SPAN_CACHE.get(path)
        if ent is None or ent["mtime"] != mtime:
            return None
        co = ent["c_off"]
        lo, hi = int(co[0]), int(co[-1])
        if not (lo <= cbeg < hi):
            return None
        i0 = int(np.searchsorted(co, cbeg))
        if i0 >= len(co) - 1 or co[i0] != cbeg:
            return None
        if span_end <= hi:
            i1 = int(np.searchsorted(co, span_end))
            if co[i1] == span_end:
                return _span_slices(ent, i0, i1)
            return None
        return ("extend", ent, i0)

    with lock:
        got = _try_cached()
    if got is not None and not isinstance(got[0], str):
        return got
    lib = _native_lib()
    if lib is None:
        return None
    with _SPAN_EXTEND:
        # re-check under the extension lock: another worker may have
        # extended past span_end while this one waited
        with lock:
            got = _try_cached()
        if got is not None and not isinstance(got[0], str):
            return got
        if got is None:
            # fresh span into a (recycled) capacity buffer
            buf = _comp_view(path, cbeg, span_end)
            if buf is None:
                return None
            scan = _scan_span(lib, buf, cbeg, span_end)
            if scan is None:
                return None
            co, cs, uo, total = scan
            base = _take_base(total)
            if not _inflate_into(lib, buf, co, cs, uo, base[:total]):
                return None
            ent = dict(mtime=mtime, base=base, beg=0, c_off=co, u_off=uo)
            with lock:
                old = _SPAN_CACHE.pop(path, None)
                _SPAN_CACHE[path] = ent
                if old is not None:
                    _retire_base(old.get("base"))
                while len(_SPAN_CACHE) > 4:
                    ev = _SPAN_CACHE.pop(next(iter(_SPAN_CACHE)))
                    _retire_base(ev.get("base"))
            return _span_slices(ent, 0, len(co) - 1)
        # extension: inflate [hi, span_end) and append to the live span
        _tag, ent, i0 = got
        co, uo = ent["c_off"], ent["u_off"]
        base, beg = ent["base"], ent["beg"]
        hi = int(co[-1])
        live = int(uo[-1])
        buf = _comp_view(path, hi, span_end)
        if buf is None:
            return None
        scan = _scan_span(lib, buf, hi, span_end)
        if scan is None:
            return None
        t_co, t_cs, t_uo, t_total = scan
        if beg + live + t_total <= base.size:
            # in place: spare capacity was never handed out, so live
            # views (slices of [beg, beg+live)) are untouched
            dst = base[beg + live:beg + live + t_total]
            if not _inflate_into(lib, buf, t_co, t_cs, t_uo, dst):
                return None
            co2 = np.concatenate([co[:-1], t_co])
            uo2 = np.concatenate([uo[:-1], t_uo + live])
            ent2 = dict(mtime=mtime, base=base, beg=beg,
                        c_off=co2, u_off=uo2)
            j0 = i0
        else:
            # capacity exhausted: move the still-needed suffix
            # [cbeg, hi) + the new tail into a recycled buffer
            keep = live - int(uo[i0])
            base2 = _take_base(keep + t_total)
            base2[:keep] = base[beg + uo[i0]:beg + live]
            dst = base2[keep:keep + t_total]
            if not _inflate_into(lib, buf, t_co, t_cs, t_uo, dst):
                return None
            co2 = np.concatenate([co[i0:-1], t_co])
            uo2 = np.concatenate([uo[i0:-1] - uo[i0], t_uo + keep])
            ent2 = dict(mtime=mtime, base=base2, beg=0,
                        c_off=co2, u_off=uo2)
            j0 = 0
        with lock:
            _SPAN_CACHE.pop(path, None)
            _SPAN_CACHE[path] = ent2
            if ent2["base"] is not base:
                _retire_base(base)
        return _span_slices(ent2, j0, len(co2) - 1)


def native_extract_multi(path, chunks, inflate_hint=None) -> bytes | None:
    """Concatenated payloads of several [vbeg, vend) chunk ranges.

    The BAI's per-window chunk lists are one near-contiguous run (the
    window's reads) plus a few far-flung outlier chunks from coarse
    bins.  Chunks are clustered by compressed-offset gap: big clusters
    inflate as ONE span through the sequential last-span cache (so
    consecutive windows extend it), while small/outlier clusters
    inflate directly WITHOUT touching the cache — a 100 KB stray chunk
    must not evict the 15 MB window span the next window will extend
    (observed: exactly that eviction forced full re-inflation of every
    window).  Returns None on any parse anomaly (callers fall back).

    inflate_hint: a virtual offset a few windows AHEAD — the largest
    cluster's inflation span extends to it, so the NEXT windows' fetches
    land fully inside the cached span and become pure zero-copy slices
    (no inflate, no concat).  Only inflation extends; returned payloads
    still cover exactly the requested chunks."""
    import numpy as np

    if not chunks or _native_lib() is None:
        return None
    GAP = 1 << 20       # new cluster when compressed gap > 1 MiB
    CACHE_MIN = 4 << 20  # only spans >= 4 MiB go through the cache
    try:
        with open(path, "rb") as fh:
            spans = []  # per chunk: (cb, ub, ce, ue, end_byte)
            end_cache = {}
            for vb, ve in chunks:
                cb, ub = vb >> 16, vb & 0xFFFF
                ce, ue = ve >> 16, ve & 0xFFFF
                if ue == 0:
                    eb = ce
                else:
                    if ce not in end_cache:
                        bs = _block_bsize_at(fh, ce)
                        if bs is None:
                            return None
                        end_cache[ce] = bs
                    eb = ce + end_cache[ce]
                spans.append((cb, ub, ce, ue, eb))
    except OSError:
        return None
    # cluster in compressed-offset order, remembering input positions
    order = sorted(range(len(spans)), key=lambda i: spans[i][0])
    clusters = []  # (beg, end, [chunk indices])
    for i in order:
        cb, _ub, _ce, _ue, eb = spans[i]
        if clusters and cb <= clusters[-1][1] + GAP:
            c = clusters[-1]
            clusters[-1] = (c[0], max(c[1], eb), c[2] + [i])
        else:
            clusters.append((cb, eb, [i]))
    hint_end = None
    if inflate_hint is not None and clusters:
        hc = inflate_hint >> 16
        hu = inflate_hint & 0xFFFF
        try:
            with open(path, "rb") as fh:
                if hu == 0:
                    hint_end = hc
                else:
                    bs = _block_bsize_at(fh, hc)
                    hint_end = hc + bs if bs is not None else None
        except OSError:
            hint_end = None
    biggest = max(range(len(clusters)),
                  key=lambda i: clusters[i][1] - clusters[i][0]) \
        if clusters else -1
    parts = [None] * len(spans)
    for ci_, (beg, end, idxs) in enumerate(clusters):
        if end <= beg:
            for i in idxs:
                parts[i] = b""
            continue
        infl_end = end
        if (ci_ == biggest and hint_end is not None
                and end < hint_end <= end + (64 << 20)):
            infl_end = hint_end
        if infl_end - beg >= CACHE_MIN:
            res = _inflate_span(path, beg, infl_end)
        else:
            res = _inflate_span_fresh(path, beg, infl_end)
        if res is None:
            return None
        out, c_off, u_off = res
        for i in idxs:
            cb, ub, ce, ue, _eb = spans[i]
            a = int(np.searchsorted(c_off, cb))
            b = int(np.searchsorted(c_off, ce))
            if a >= len(c_off) or c_off[a] != cb or b >= len(c_off) \
                    or c_off[b] != ce:
                return None
            lo = int(u_off[a]) + ub
            hi = int(u_off[b]) + ue
            if hi < lo or hi > int(u_off[-1]):
                return None
            parts[i] = out[lo:hi]
    if len(parts) == 1 and not isinstance(parts[0], bytes):
        # zero-copy: the common one-cluster window returns a view of
        # the cached span (ndarray slices hold a reference, and cache
        # replacement never mutates old arrays in place)
        return memoryview(parts[0])
    return b"".join(p.tobytes() if not isinstance(p, bytes) else p
                    for p in parts)


def native_extract_voffsets(path, vbeg: int, vend=None) -> bytes | None:
    """Inflate the payload between virtual offsets [vbeg, vend) of a BGZF
    file with the native multithreaded inflater (csrc/bgzf.c).  vend=None
    reads to EOF.  Returns None when the native lib is unavailable or the
    stream doesn't parse cleanly (callers fall back to BgzfReader).

    This is the hot data-loading path: BAM bytes for a call window are
    BGZF blocks, independent gzip members that csrc/bgzf.c inflates on a
    pthread pool straight into one buffer — the stage the reference gets
    from htslib's bgzf_mt.  Overlapping sequential requests reuse the
    last inflated span (_inflate_span)."""
    import numpy as np

    if _native_lib() is None:
        return None
    cbeg, ubeg = vbeg >> 16, vbeg & 0xFFFF
    try:
        with open(path, "rb") as fh:
            if vend is None:
                fh.seek(0, 2)
                span_end = fh.tell()
                cut = None            # take everything past ubeg
            else:
                cendblk, uend = vend >> 16, vend & 0xFFFF
                if cendblk < cbeg or (cendblk == cbeg and uend <= ubeg):
                    return b""
                if uend == 0:
                    span_end = cendblk
                    cut = None
                else:
                    bsize = _block_bsize_at(fh, cendblk)
                    if bsize is None:
                        return None
                    span_end = cendblk + bsize
                    cut = (cendblk, uend)
    except OSError:
        return None
    if span_end <= cbeg:
        return b""
    res = _inflate_span(path, cbeg, span_end)
    if res is None:
        return None
    out, c_off, u_off = res
    end_u = int(u_off[-1])
    if cut is not None:
        abs_coff, uend = cut
        i = int(np.searchsorted(c_off, abs_coff))
        if i >= len(c_off) or c_off[i] != abs_coff:
            return None
        end_u = int(u_off[i]) + uend
        if end_u > int(u_off[-1]):
            return None
    if ubeg > end_u:
        return None
    return out[ubeg:end_u].tobytes()
