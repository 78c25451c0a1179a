"""The window raw fetch of lofreq_tpu_torch (pileup/native_ingest.py:
raw_records_for_region): a window's records are one read-only view of
the inflated span (raw_view, csrc/host/ingest.c: lfq_raw_view), nothing
copied.

1. For every window of a two-contig BAM (reads straddling 16 kb bins,
   long D and N operations, unmapped reads at the end), the records the
   interval filter keeps from the view are, in order, those it keeps
   from the BAI chunks' payloads joined (io/bgzf.native_extract_multi,
   the fallback); `call` gives the reference's VCF byte for byte.
2. The fallbacks (no BAI, a record that does not parse, a record out of
   order) hand out what the chunked path hands out.
3. A view keeps its bytes while many later windows are fetched, also
   where the span cache runs out of room and starts over; a second call
   of the same BAM allocates no span buffer and copies nothing.
"""

import hashlib
import os
import queue
import shutil
import struct
import threading
import time
import zlib
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from lofreq_tpu.call.caller import VarcallConf as RefConf
from lofreq_tpu.pipelines.call_pipeline import \
    call_and_filter as ref_call_and_filter
from lofreq_tpu_torch.call.caller import VarcallConf
from lofreq_tpu_torch.core import stagetimer
from lofreq_tpu_torch.io import bgzf as B
from lofreq_tpu_torch.io.bai import BaiIndex, build_bai
from lofreq_tpu_torch.io.bam import (FREVERSE, FUNMAP, BamHeader, BamRead,
                                     BamReader, BamWriter)
from lofreq_tpu_torch.io.fasta import write_fasta
from lofreq_tpu_torch.pileup import native_ingest as NI
from lofreq_tpu_torch.pipelines import call_pipeline
from test_call_e2e_differential import _norm

LENS = (70_000, 40_000)
NAMES = ("ctgA", "ctgB")
BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
# long reference skips: a deletion inside one bin, and a splice that
# straddles two 16 kb boundaries (its bin is a 128 kb one)
LONG = ("40M1500D60M", "30M25000N70M")
# contig B has no read starting in [20000, 26000) or past 35000
GAP_B = (20_000, 26_000)
LAST_B = 35_000

WINDOWS = {
    "A-first": (0, 0, 12_500),
    "A-unaligned": (0, 12_500, 25_000),
    "A-aligned": (0, 16_384, 32_768),
    "A-ends-on-bin": (0, 49_152, 65_536),
    "A-last": (0, 62_500, 70_000),
    "B-first": (1, 0, 12_500),
    "B-empty": (1, 20_200, 25_800),
    "B-past-last-read": (1, 36_000, 40_000),
}


def _draw(seed):
    """Genomes and sorted reads (tid, pos, cigar, seq, qual, flag): 100 bp
    reads at 30x, an SNV at allele frequency 0.3 every 5 kb, and LONG
    reads; 50 unmapped reads at the end."""
    rng = np.random.default_rng(seed)
    genomes = [BASES[rng.integers(0, 4, n)] for n in LENS]
    reads = []
    for tid, n in enumerate(LENS):
        g = genomes[tid]
        alt = g.copy()
        for p in range(2_500, n, 5_000):
            alt[p] = BASES[(np.searchsorted(BASES, g[p]) + 1) % 4]
        starts = np.sort(rng.integers(0, n - 100, n * 30 // 100))
        if tid == 1:
            starts = starts[((starts < GAP_B[0] - 100) | (starts >= GAP_B[1]))
                            & (starts < LAST_B)]
        for s in starts:
            src = np.where(rng.random(100) < 0.3, alt[s:s + 100],
                           g[s:s + 100])
            reads.append((tid, int(s), "100M", src.tobytes()))
        for cig in LONG:
            skip = 1_500 if "D" in cig else 25_000
            hi = (GAP_B[0] if tid == 1 else n) - skip - 200
            if hi <= 1_000:
                continue
            for s in rng.integers(1_000, hi, 12):
                m1 = int(cig.split("M")[0])
                s = int(s)
                seq = np.concatenate([g[s:s + m1],
                                      g[s + m1 + skip:s + skip + 100]])
                reads.append((tid, s, cig, seq.tobytes()))
    reads.sort(key=lambda r: (r[0], r[1]))
    out = []
    for tid, pos, cig, seq in reads:
        q = rng.integers(30, 39, len(seq)).astype(np.uint8)
        out.append((tid, pos, cig, seq, q,
                    FREVERSE if rng.random() < 0.5 else 0))
    for _ in range(50):
        seq = BASES[rng.integers(0, 4, 100)].tobytes()
        out.append((-1, -1, "*", seq, np.full(100, 30, np.uint8), FUNMAP))
    return genomes, out


def _write(d, seed=11, level=None):
    """FASTA, BAM and BAI of _draw(seed) under d; level=0 stores the
    BGZF blocks uncompressed, so that a record can be patched in place."""
    os.makedirs(d, exist_ok=True)
    genomes, reads = _draw(seed)
    fa = os.path.join(d, "ref.fa")
    write_fasta(fa, {n: g.tobytes().decode()
                     for n, g in zip(NAMES, genomes)})
    bam = os.path.join(d, "reads.bam")
    header = BamHeader("@HD\tVN:1.6\tSO:coordinate\n",
                       list(zip(NAMES, LENS)))
    with BamWriter(bam, header) as w:
        if level is not None:
            w._bgzf._level = level
        for i, (tid, pos, cig, seq, q, flag) in enumerate(reads):
            r = BamRead()
            r.qname = f"r{i}"
            r.tid, r.pos, r.flag, r.seq, r.qual = tid, pos, flag, seq, q
            r.mapq = 0 if tid < 0 else 60
            r.set_cigar_string(cig)
            w.write(r)
    build_bai(bam)
    return dict(fa=fa, bam=bam)


@pytest.fixture(autouse=True)
def _fresh_span_cache():
    """Each test starts with an empty span cache and no spare buffers."""
    B._SPAN_CACHE.clear()
    B._SPAN_FREE.clear()
    B._SPAN_PEAK = 0
    yield
    B._SPAN_CACHE.clear()
    B._SPAN_FREE.clear()


@pytest.fixture(scope="module")
def sample(tmp_path_factory):
    return _write(str(tmp_path_factory.mktemp("raw_view")))


def _kept(raw, tid, beg, end):
    """The records of a [size][record] stream that overlap [beg, end) of
    tid, as the consumers' interval filter (csrc/ingest.c: in_region)
    keeps them, in stream order."""
    raw = bytes(raw)
    out, off = [], 0
    while off + 4 <= len(raw):
        (sz,) = struct.unpack_from("<i", raw, off)
        rec = raw[off + 4:off + 4 + sz]
        t, pos, l_name, _mq, _bin, n_cig = struct.unpack_from("<iiBBHH", rec)
        cig = np.frombuffer(rec, "<u4", n_cig, 32 + l_name)
        ref_len = (cig >> 4)[np.isin(cig & 0xF, (0, 2, 3, 7, 8))].sum()
        if t == tid and pos < end and pos + int(ref_len) > beg:
            out.append(rec)
        off += 4 + sz
    assert off == len(raw)
    return out


def _chunked(bam, tid, beg, end):
    """What the fallback hands out for the window: the BAI chunks'
    payloads joined."""
    idx = BaiIndex.load(bam + ".bai")
    chunks = idx.query(tid, beg, end)
    ahead = idx.query(tid, end, end + 2 * (end - beg))
    hint = max(c[1] for c in ahead) if ahead else None
    if not chunks:
        return b""
    return B.native_extract_multi(bam, chunks, inflate_hint=hint)


def _fetch(bam, tid, beg, end):
    """The window's raw as the prefetcher fetches it, and the attributes
    its traced `ingest.raw` span notes (bytes, copied, fresh)."""
    stagetimer.reset()
    with stagetimer.traced(), stagetimer.stage("ingest.raw"):
        raw = NI.raw_records_for_region(BamReader(bam), tid, beg, end)
    (span,) = [s for s in stagetimer.spans() if s.name == "ingest.raw"]
    assert span.attrs["bytes"] == len(raw)
    return raw, span.attrs


@pytest.mark.parametrize("name", list(WINDOWS))
def test_view_keeps_what_the_chunks_keep(sample, name):
    tid, beg, end = WINDOWS[name]
    raw, acct = _fetch(sample["bam"], tid, beg, end)
    old = _chunked(sample["bam"], tid, beg, end)
    assert _kept(raw, tid, beg, end) == _kept(old, tid, beg, end)
    if BaiIndex.load(sample["bam"] + ".bai").query(tid, beg, end):
        assert isinstance(raw, memoryview) and raw.readonly
        assert acct["copied"] == 0
    if name == "B-past-last-read" or name == "B-empty":
        assert not _kept(raw, tid, beg, end)
    else:
        assert _kept(raw, tid, beg, end)


def test_every_window_of_the_call(sample):
    """The pipeline's windows over both contigs, in order, as the raw
    prefetcher fetches them."""
    for tid, n in enumerate(LENS):
        for beg in range(0, n, call_pipeline.WINDOW):
            end = min(beg + call_pipeline.WINDOW, n)
            raw, acct = _fetch(sample["bam"], tid, beg, end)
            old = _chunked(sample["bam"], tid, beg, end)
            assert isinstance(raw, memoryview), (tid, beg)
            assert acct["copied"] == 0
            assert _kept(raw, tid, beg, end) == _kept(old, tid, beg, end)


def test_long_reads_reach_the_windows_they_overlap(sample):
    """The splices and deletions overlap windows their first base is not
    in, and the view holds them there."""
    genomes, reads = _draw(11)
    for tid, pos, cig, *_ in reads:
        if cig != LONG[1] or tid != 0:
            continue
        mid = pos + 12_000          # inside the splice's N
        raw, _ = _fetch(sample["bam"], 0, mid, mid + 100)
        assert any(struct.unpack_from("<i", r, 4)[0] == pos
                   for r in _kept(raw, 0, mid, mid + 100))
        return
    pytest.fail("no splice drawn")


def test_call_gives_the_reference_vcf(sample, tmp_path):
    ours, theirs = tmp_path / "port.vcf", tmp_path / "ref.vcf"
    res = call_pipeline.call_and_filter(
        sample["bam"], sample["fa"], str(ours), src="call",
        vconf=VarcallConf(use_device_screen=False))
    ref_call_and_filter(sample["bam"], sample["fa"], str(theirs), src="call",
                        vconf=RefConf(use_device_screen=False,
                                      use_device_baq=False))
    assert len(res.vars) > 0
    assert _norm(ours.read_text()) == _norm(theirs.read_text())


def test_without_bai_the_whole_stream(sample, tmp_path):
    bam = str(tmp_path / "nobai.bam")
    shutil.copy(sample["bam"], bam)
    raw, _ = _fetch(bam, 0, 12_500, 25_000)
    rdr = BamReader(bam)
    rdr.rewind()
    assert isinstance(raw, bytes) and raw == rdr._bgzf.read()


def _patch(bam, tid, near, edit):
    """Rewrite, in a BAM of stored BGZF blocks, the first record of tid
    at or after position `near` with edit(record) (same length), and
    the block's CRC."""
    with open(bam, "rb") as fh:
        data = bytearray(fh.read())
    spans = B.BgzfReader._parse_spans(bytes(data))
    payloads = [zlib.decompress(bytes(data[a:b]), wbits=-15)
                for a, b, _, _ in spans]
    stream = b"".join(payloads)
    # skip the header, then walk the records
    (l_text,) = struct.unpack_from("<i", stream, 4)
    off = 8 + l_text
    (n_ref,) = struct.unpack_from("<i", stream, off)
    off += 4
    for _ in range(n_ref):
        (l_name,) = struct.unpack_from("<i", stream, off)
        off += 8 + l_name
    while True:
        (sz,) = struct.unpack_from("<i", stream, off)
        t, pos = struct.unpack_from("<ii", stream, off + 4)
        if t == tid and pos >= near:
            break
        off += 4 + sz
    rec = bytes(stream[off + 4:off + 4 + sz])
    new = edit(rec)
    assert len(new) == len(rec)
    # find the record in the stored blocks (it may cross two of them)
    u = 0
    for (a, b, _isize, bend), p in zip(spans, payloads):
        lo, hi = max(off + 4, u), min(off + 4 + sz, u + len(p))
        if lo < hi:
            body = bytearray(p)
            body[lo - u:hi - u] = new[lo - off - 4:hi - off - 4]
            stored = zlib.compressobj(0, zlib.DEFLATED, -15)
            cdata = stored.compress(bytes(body)) + stored.flush()
            assert len(cdata) == b - a
            data[a:b] = cdata
            struct.pack_into("<I", data, bend - 8, zlib.crc32(bytes(body)))
        u += len(p)
    with open(bam, "wb") as fh:
        fh.write(data)


def _bad_name(rec):
    return rec[:8] + b"\xff" + rec[9:]     # l_read_name past the record


def _earlier_pos(rec):
    (pos,) = struct.unpack_from("<i", rec, 4)
    return rec[:4] + struct.pack("<i", pos - 60) + rec[8:]


@pytest.mark.parametrize("edit", [_bad_name, _earlier_pos],
                         ids=["record-does-not-parse", "record-out-of-order"])
def test_fallback_hands_out_the_chunks(tmp_path, edit):
    art = _write(str(tmp_path), level=0)
    _patch(art["bam"], 0, 30_000, edit)
    B._SPAN_CACHE.clear()
    raw, _ = _fetch(art["bam"], 0, 25_000, 37_500)
    assert isinstance(raw, bytes)
    assert raw == _chunked(art["bam"], 0, 25_000, 37_500)
    # a window whose walk does not pass the record is still a view
    raw, _ = _fetch(art["bam"], 1, 0, 12_500)
    assert isinstance(raw, memoryview)


def _digest(view):
    return hashlib.sha256(view).hexdigest()


def test_views_keep_their_bytes(sample):
    """Views held while the next 24 windows are fetched (more than the
    pipeline keeps in flight: 3 prefetched, 2 builds, the batch and 3
    confirms), across both contigs and starting over at the first window
    as the next call does."""
    windows = [(tid, b, min(b + call_pipeline.WINDOW, n))
               for tid, n in enumerate(LENS)
               for b in range(0, n, call_pipeline.WINDOW)]
    held = []
    for k, (tid, beg, end) in enumerate(windows * 3):
        raw, acct = _fetch(sample["bam"], tid, beg, end)
        assert isinstance(raw, memoryview) and acct["copied"] == 0
        held.append((raw, _digest(raw)))
        if len(held) > 24:
            old, digest = held.pop(0)
            assert _digest(old) == digest, k
    for raw, digest in held:
        assert _digest(raw) == digest


def _windows_fetched(bam):
    """Every pipeline window of both contigs, three times over, as the
    raw prefetcher fetches them."""
    rdr = BamReader(bam)
    for tid, beg, end in [(tid, b, min(b + call_pipeline.WINDOW, n))
                          for tid, n in enumerate(LENS)
                          for b in range(0, n, call_pipeline.WINDOW)] * 3:
        yield NI.raw_records_for_region(rdr, tid, beg, end)


def _spans_sliding(bam):
    """Spans of 6 blocks sliding a block at a time, three times over the
    file, from the span cache: with new buffers of twice the request and
    no more, the span moves into another buffer every few requests."""
    c_off = B._inflate_span_fresh(bam, 0, os.path.getsize(bam))[1]
    for i in list(range(0, len(c_off) - 7)) * 3:
        yield B._inflate_span(bam, int(c_off[i]), int(c_off[i + 6]))[0]


@pytest.mark.parametrize("fetches", [_windows_fetched, _spans_sliding],
                         ids=["windows", "spans-sliding"])
def test_views_keep_their_bytes_across_threads(sample, monkeypatch, fetches):
    """The views as the window pipeline holds them, with its threads: one
    thread fetches, at most 3 ahead (PIPE_DEPTH + 1); two build threads
    check each view's bytes and hand it to three confirm threads, which
    check them again once later views are fetched.  No view's bytes
    change, also where spans move and buffers are recycled while views
    are in flight."""
    monkeypatch.setattr(B, "_SPAN_MIN", 0)
    ahead = queue.Queue(maxsize=3)
    moved = []

    def prefetch():
        moved0 = B.span_bytes()[1]
        for raw in fetches(sample["bam"]):
            ahead.put((raw, _digest(raw)))
        moved.append(B.span_bytes()[1] - moved0)
        ahead.put(None)

    def confirm(raw, digest):
        time.sleep(0.002)
        return _digest(raw) == digest

    def build(raw, digest):
        assert _digest(raw) == digest
        return confirms.submit(confirm, raw, digest)

    fetcher = threading.Thread(target=prefetch)
    fetcher.start()
    with ThreadPoolExecutor(2) as builds, ThreadPoolExecutor(3) as confirms:
        built, confirmed, ok = deque(), deque(), []
        while (item := ahead.get()) is not None:
            built.append(builds.submit(build, *item))
            del item
            while len(built) > 2:
                confirmed.append(built.popleft().result())
            while len(confirmed) > 3:
                ok.append(confirmed.popleft().result())
        confirmed += [f.result() for f in built]
        ok += [f.result() for f in confirmed]
    fetcher.join()
    assert len(ok) > 24 and all(ok)
    if fetches is _spans_sliding:
        assert moved[0] > 0


def test_span_cache_never_rewrites_a_live_view(sample, monkeypatch):
    """The span cache alone, with new buffers of twice the request and
    no more, so that it moves the span into another buffer every few
    requests: spans of 6 blocks sliding a block at a time, three times
    over the file, each payload held for the next 24 requests, and none
    rewritten; the last pass allocates no buffer (the spares kept are as
    many as views ever pinned at once, plus one)."""
    monkeypatch.setattr(B, "_SPAN_MIN", 0)
    path = sample["bam"]
    c_off = B._inflate_span_fresh(path, 0, os.path.getsize(path))[1]
    starts = list(range(0, len(c_off) - 7))
    held, allocated, moved = [], [], 0
    for k, i in enumerate(starts * 3):
        fresh0, moved0 = B.span_bytes()
        payload = B._inflate_span(path, int(c_off[i]), int(c_off[i + 6]))[0]
        fresh, moved1 = B.span_bytes()
        moved += moved1 - moved0
        if k >= 2 * len(starts):
            allocated.append(fresh - fresh0)
        held.append((payload, _digest(payload)))
        if len(held) > 24:
            old, digest = held.pop(0)
            assert _digest(old) == digest, k
    for payload, digest in held:
        assert _digest(payload) == digest
    assert len(starts) > 24 and moved > 0 and not any(allocated)


def test_second_call_allocates_nothing(sample):
    """Traced, the raw prefetch's `ingest.raw` spans note the bytes handed
    out, copied and newly allocated: after one call, the same call again
    allocates no span buffer, and no call copies."""
    per_call = []
    for _ in range(2):
        stagetimer.reset()
        with stagetimer.traced():
            call_pipeline.run_call(sample["bam"], sample["fa"],
                                   vconf=VarcallConf(use_device_screen=False))
        raw = [s.attrs for s in stagetimer.spans() if s.name == "ingest.raw"]
        assert raw and all(a and {"bytes", "copied", "fresh"} <= set(a)
                           for a in raw)
        per_call.append({k: sum(a[k] for a in raw)
                         for k in ("bytes", "copied", "fresh")})
    first, second = per_call
    assert first["bytes"] == second["bytes"] > 0
    assert first["copied"] == second["copied"] == 0
    assert first["fresh"] > 0 and second["fresh"] == 0
