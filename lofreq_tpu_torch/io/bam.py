"""BAM/SAM reading and writing.

Native replacement for the htslib sam_read1/sam_write1 path used throughout
the reference (plp.c, lofreq_viterbi.c, lofreq_alnqual.c, ...).  Records are
decoded into a lightweight ``BamRead`` with numpy cigar/qual arrays so the
pileup engine can tensorize them cheaply.
"""

from __future__ import annotations

import os
import re
import struct

import numpy as np

from .bgzf import BgzfReader, BgzfWriter

# cigar op codes, as in the SAM spec
CMATCH, CINS, CDEL, CREF_SKIP, CSOFT_CLIP, CHARD_CLIP, CPAD, CEQUAL, CDIFF = range(9)
CIGAR_CHARS = "MIDNSHP=X"
CIGAR_LOOKUP = {c: i for i, c in enumerate(CIGAR_CHARS)}
# ops that consume query / reference
CONSUMES_QUERY = np.array([1, 1, 0, 0, 1, 0, 0, 1, 1], dtype=bool)
CONSUMES_REF = np.array([1, 0, 1, 1, 0, 0, 0, 1, 1], dtype=bool)

SEQ_NT16_STR = "=ACMGRSVTWYHKDBN"
_NT16_TABLE = np.zeros(256, dtype=np.uint8)
_NT16_TABLE[:] = 15
for _i, _c in enumerate(SEQ_NT16_STR):
    _NT16_TABLE[ord(_c)] = _i
    _NT16_TABLE[ord(_c.lower())] = _i
# seq_nt16_int: nt16 code -> 0..4 (A C G T N)
SEQ_NT16_INT = np.array(
    [4, 0, 1, 4, 2, 4, 4, 4, 3, 4, 4, 4, 4, 4, 4, 4], dtype=np.uint8
)

# sam flags
FPAIRED = 0x1
FPROPER_PAIR = 0x2
FUNMAP = 0x4
FMUNMAP = 0x8
FREVERSE = 0x10
FMREVERSE = 0x20
FREAD1 = 0x40
FREAD2 = 0x80
FSECONDARY = 0x100
FQCFAIL = 0x200
FDUP = 0x400
FSUPPLEMENTARY = 0x800


class BamError(IOError):
    pass


class BamHeader:
    def __init__(self, text: str = "", references=None):
        self.text = text
        self.references = list(references or [])  # [(name, length)]
        self._name2tid = {n: i for i, (n, _l) in enumerate(self.references)}

    @classmethod
    def from_text(cls, text: str):
        refs = []
        for line in text.splitlines():
            if line.startswith("@SQ"):
                name = None
                ln = None
                for f in line.split("\t")[1:]:
                    if f.startswith("SN:"):
                        name = f[3:]
                    elif f.startswith("LN:"):
                        ln = int(f[3:])
                if name is not None and ln is not None:
                    refs.append((name, ln))
        return cls(text, refs)

    def ensure_sq_lines(self):
        """Add @SQ lines to text if missing (for BAM->SAM round trips)."""
        if "@SQ" in self.text:
            return
        sq = "".join(f"@SQ\tSN:{n}\tLN:{l}\n" for n, l in self.references)
        # insert after @HD if present
        if self.text.startswith("@HD"):
            nl = self.text.index("\n") + 1
            self.text = self.text[:nl] + sq + self.text[nl:]
        else:
            self.text = sq + self.text

    def tid(self, name: str) -> int:
        return self._name2tid.get(name, -1)

    def name(self, tid: int) -> str:
        return self.references[tid][0] if 0 <= tid < len(self.references) else "*"


class BamRead:
    __slots__ = (
        "qname", "flag", "tid", "pos", "mapq", "cigar", "seq", "qual",
        "mtid", "mpos", "tlen", "tags", "tag_order",
    )

    def __init__(self):
        self.qname = ""
        self.flag = 0
        self.tid = -1
        self.pos = -1
        self.mapq = 0
        self.cigar = np.zeros(0, dtype=np.uint32)  # packed len<<4|op
        self.seq = b""  # ASCII bases
        self.qual = np.zeros(0, dtype=np.uint8)  # phred (0xff = missing)
        self.mtid = -1
        self.mpos = -1
        self.tlen = 0
        self.tags = {}
        self.tag_order = []

    # -- convenience ----------------------------------------------------
    @property
    def l_qseq(self) -> int:
        return len(self.seq)

    @property
    def is_reverse(self) -> bool:
        return bool(self.flag & FREVERSE)

    @property
    def is_unmapped(self) -> bool:
        return bool(self.flag & FUNMAP)

    def cigar_ops(self):
        """Yield (op, oplen) pairs."""
        return [(int(c) & 0xF, int(c) >> 4) for c in self.cigar]

    def endpos(self) -> int:
        """0-based exclusive end position on the reference."""
        ref_len = 0
        for c in self.cigar:
            op = int(c) & 0xF
            if CONSUMES_REF[op]:
                ref_len += int(c) >> 4
        return self.pos + ref_len

    def infer_query_length(self) -> int:
        qlen = 0
        for c in self.cigar:
            op = int(c) & 0xF
            if CONSUMES_QUERY[op]:
                qlen += int(c) >> 4
        return qlen

    def cigar_string(self) -> str:
        if len(self.cigar) == 0:
            return "*"
        return "".join(f"{int(c) >> 4}{CIGAR_CHARS[int(c) & 0xF]}" for c in self.cigar)

    def set_cigar_string(self, s: str):
        if s == "*":
            self.cigar = np.zeros(0, dtype=np.uint32)
            return
        ops = re.findall(r"(\d+)([MIDNSHP=X])", s)
        self.cigar = np.array(
            [(int(n) << 4) | CIGAR_LOOKUP[c] for n, c in ops], dtype=np.uint32
        )

    def get_tag(self, tag: str):
        entry = self.tags.get(tag)
        return None if entry is None else entry[1]

    def set_tag(self, tag: str, typecode: str, value):
        if tag not in self.tags:
            self.tag_order.append(tag)
        self.tags[tag] = (typecode, value)

    def del_tag(self, tag: str):
        if tag in self.tags:
            del self.tags[tag]
            self.tag_order.remove(tag)


# ---------------------------------------------------------------------------
# BAM binary encode/decode
# ---------------------------------------------------------------------------

def _decode_seq(data: bytes, l_seq: int) -> bytes:
    arr = np.frombuffer(data, dtype=np.uint8)
    hi = arr >> 4
    lo = arr & 0xF
    nib = np.empty(len(arr) * 2, dtype=np.uint8)
    nib[0::2] = hi
    nib[1::2] = lo
    codes = np.frombuffer(SEQ_NT16_STR.encode(), dtype=np.uint8)[nib[:l_seq]]
    return codes.tobytes()


def _encode_seq(seq: bytes) -> bytes:
    nib = _NT16_TABLE[np.frombuffer(seq, dtype=np.uint8)]
    if len(nib) % 2:
        nib = np.concatenate([nib, np.zeros(1, dtype=np.uint8)])
    return ((nib[0::2] << 4) | nib[1::2]).astype(np.uint8).tobytes()


_TAG_FMT = {"c": "<b", "C": "<B", "s": "<h", "S": "<H", "i": "<i", "I": "<I",
            "f": "<f", "A": "<c"}
_TAG_SIZE = {"c": 1, "C": 1, "s": 2, "S": 2, "i": 4, "I": 4, "f": 4, "A": 1}


def _parse_tags(buf: bytes):
    tags = {}
    order = []
    off = 0
    n = len(buf)
    while off + 3 <= n:
        tag = buf[off : off + 2].decode()
        typecode = chr(buf[off + 2])
        off += 3
        if typecode in _TAG_FMT:
            val = struct.unpack_from(_TAG_FMT[typecode], buf, off)[0]
            if typecode == "A":
                val = val.decode()
            off += _TAG_SIZE[typecode]
        elif typecode == "Z":
            end = buf.index(b"\x00", off)
            val = buf[off:end].decode("latin-1")
            off = end + 1
        elif typecode == "H":
            end = buf.index(b"\x00", off)
            val = buf[off:end].decode()
            off = end + 1
        elif typecode == "B":
            sub = chr(buf[off])
            count = struct.unpack_from("<i", buf, off + 1)[0]
            sz = _TAG_SIZE[sub]
            val = (sub, list(struct.unpack_from(f"<{count}{_TAG_FMT[sub][1]}",
                                                buf, off + 5)))
            off += 5 + sz * count
        else:
            raise BamError(f"unknown tag type {typecode!r}")
        tags[tag] = (typecode, val)
        order.append(tag)
    return tags, order


def _encode_tags(tags: dict, order: list) -> bytes:
    out = bytearray()
    for tag in order:
        typecode, val = tags[tag]
        out += tag.encode()
        if typecode == "i":
            # pick smallest int representation like htslib does not; keep i
            out += b"i" + struct.pack("<i", int(val))
        elif typecode in _TAG_FMT and typecode != "A":
            out += typecode.encode() + struct.pack(_TAG_FMT[typecode], val)
        elif typecode == "A":
            out += b"A" + val.encode()
        elif typecode in ("Z", "H"):
            out += typecode.encode() + val.encode("latin-1") + b"\x00"
        elif typecode == "B":
            sub, arr = val
            out += b"B" + sub.encode() + struct.pack("<i", len(arr))
            out += struct.pack(f"<{len(arr)}{_TAG_FMT[sub][1]}", *arr)
        else:
            raise BamError(f"unknown tag type {typecode!r}")
    return bytes(out)


def decode_record(buf: bytes) -> BamRead:
    r = BamRead()
    (r.tid, r.pos, l_read_name, r.mapq, _bin, n_cigar_op, r.flag, l_seq,
     r.mtid, r.mpos, r.tlen) = struct.unpack_from("<iiBBHHHiiii", buf, 0)
    off = 32
    r.qname = buf[off : off + l_read_name - 1].decode()
    off += l_read_name
    r.cigar = np.frombuffer(buf, dtype="<u4", count=n_cigar_op, offset=off).copy()
    off += 4 * n_cigar_op
    nseq_bytes = (l_seq + 1) // 2
    r.seq = _decode_seq(buf[off : off + nseq_bytes], l_seq)
    off += nseq_bytes
    r.qual = np.frombuffer(buf, dtype=np.uint8, count=l_seq, offset=off).copy()
    off += l_seq
    r.tags, r.tag_order = _parse_tags(buf[off:])
    return r


# ---------------------------------------------------------------------------
# Raw-record helpers: operate on an undecoded BAM record block (the bytes
# after the 4-byte block_size).  The read-level tools (viterbi / alnqual /
# indelqual) stream most reads through unchanged or with an aux-tag splice;
# a full decode + re-encode per read costs ~50x more than these.
# ---------------------------------------------------------------------------

_RAW_HEAD = struct.Struct("<iiBBHHHiiii")


def raw_fields(buf: bytes):
    """(tid, pos, l_read_name, mapq, bin, n_cigar, flag, l_seq, mtid,
    mpos, tlen) of a raw record block."""
    return _RAW_HEAD.unpack_from(buf, 0)


def raw_layout(buf: bytes):
    """(cigar_off, n_cigar, seq_off, qual_off, aux_off, l_seq)."""
    f = _RAW_HEAD.unpack_from(buf, 0)
    l_read_name, n_cigar, l_seq = f[2], f[5], f[7]
    cigar_off = 32 + l_read_name
    seq_off = cigar_off + 4 * n_cigar
    qual_off = seq_off + (l_seq + 1) // 2
    aux_off = qual_off + l_seq
    return cigar_off, n_cigar, seq_off, qual_off, aux_off, l_seq


def raw_cigar(buf: bytes) -> np.ndarray:
    cigar_off, n_cigar, _, _, _, _ = raw_layout(buf)
    return np.frombuffer(buf, dtype="<u4", count=n_cigar, offset=cigar_off)


def raw_qual(buf: bytes) -> np.ndarray:
    _, _, _, qual_off, aux_off, l_seq = raw_layout(buf)
    return np.frombuffer(buf, dtype=np.uint8, count=l_seq, offset=qual_off)


def raw_seq(buf: bytes) -> bytes:
    _, _, seq_off, qual_off, _, l_seq = raw_layout(buf)
    return _decode_seq(buf[seq_off:qual_off], l_seq)


# nibble-pair -> two ASCII bases, for vectorized seq decode
_SEQ_LUT16 = np.zeros(256, dtype="<u2")
for _b in range(256):
    _SEQ_LUT16[_b] = (ord(SEQ_NT16_STR[_b >> 4])
                      | (ord(SEQ_NT16_STR[_b & 0xF]) << 8))


def raw_seq_ascii(buf: bytes) -> bytes:
    """Read bases as ASCII, one numpy table lookup for the whole read."""
    _, _, seq_off, qual_off, _, l_seq = raw_layout(buf)
    arr = np.frombuffer(buf, np.uint8, qual_off - seq_off, seq_off)
    return _SEQ_LUT16[arr].tobytes()[:l_seq]


def seq_lut16() -> np.ndarray:
    """The nibble-pair -> two-ASCII-bases table (batch decoders)."""
    return _SEQ_LUT16


def raw_find_tags(buf: bytes, tags) -> dict:
    """{tag_bytes: (start, end)} for the aux entries present in tags."""
    aux_off = raw_layout(buf)[4]
    found = {}
    for t, s, e in _aux_spans(buf, aux_off):
        if t in tags:
            found[t] = (s, e)
    return found


def encode_z_tag(tag: bytes, val: bytes) -> bytes:
    return tag + b"Z" + val + b"\x00"


def _aux_spans(buf: bytes, off: int):
    """Yield (tag_bytes, start, end) for each aux entry from off."""
    n = len(buf)
    while off + 3 <= n:
        start = off
        tag = buf[off : off + 2]
        typecode = buf[off + 2]
        off += 3
        c = chr(typecode)
        if c in _TAG_SIZE:
            off += _TAG_SIZE[c]
        elif c in ("Z", "H"):
            off = buf.index(b"\x00", off) + 1
        elif c == "B":
            sub = chr(buf[off])
            count = struct.unpack_from("<i", buf, off + 1)[0]
            off += 5 + _TAG_SIZE[sub] * count
        else:
            raise BamError(f"unknown tag type {c!r}")
        yield tag, start, off


def raw_get_tag_span(buf: bytes, tag: bytes):
    """(start, end) of an aux entry, or None."""
    aux_off = raw_layout(buf)[4]
    for t, s, e in _aux_spans(buf, aux_off):
        if t == tag:
            return s, e
    return None


def raw_strip_tags(buf: bytes, tags) -> bytes:
    """Remove the given aux tags (set of 2-byte tag names); returns buf
    itself when none are present."""
    aux_off = raw_layout(buf)[4]
    drop = []
    for t, s, e in _aux_spans(buf, aux_off):
        if t in tags:
            drop.append((s, e))
    if not drop:
        return buf
    out = bytearray()
    pos = 0
    for s, e in drop:
        out += buf[pos:s]
        pos = e
    out += buf[pos:]
    return bytes(out)


def raw_append_tags(buf: bytes, encoded: bytes) -> bytes:
    """Append pre-encoded aux bytes (caller strips duplicates first)."""
    return buf + encoded


def reg2bin(beg: int, end: int) -> int:
    """BAI bin number for a [beg, end) interval (SAM spec)."""
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


def encode_record(r: BamRead) -> bytes:
    qname_b = r.qname.encode() + b"\x00"
    endpos = r.endpos() if len(r.cigar) else r.pos + 1
    head = struct.pack(
        "<iiBBHHHiiii",
        r.tid, r.pos, len(qname_b), r.mapq,
        reg2bin(max(r.pos, 0), max(endpos, r.pos + 1)),
        len(r.cigar), r.flag, len(r.seq), r.mtid, r.mpos, r.tlen,
    )
    body = bytearray(head)
    body += qname_b
    body += np.asarray(r.cigar, dtype="<u4").tobytes()
    body += _encode_seq(r.seq)
    q = np.asarray(r.qual, dtype=np.uint8)
    if len(q) != len(r.seq):
        q = np.full(len(r.seq), 0xFF, dtype=np.uint8)
    body += q.tobytes()
    body += _encode_tags(r.tags, r.tag_order)
    return struct.pack("<i", len(body)) + bytes(body)


class BamReader:
    """Sequential BAM reader; optional region filter via the BAI index."""

    def __init__(self, path):
        self.path = str(path)
        self._bgzf = BgzfReader(self.path)
        magic = self._bgzf.read(4)
        if magic != b"BAM\x01":
            raise BamError(f"{path} is not a BAM file")
        l_text = struct.unpack("<i", self._bgzf.read(4))[0]
        text = self._bgzf.read(l_text).rstrip(b"\x00").decode()
        n_ref = struct.unpack("<i", self._bgzf.read(4))[0]
        refs = []
        for _ in range(n_ref):
            l_name = struct.unpack("<i", self._bgzf.read(4))[0]
            name = self._bgzf.read(l_name)[:-1].decode()
            l_ref = struct.unpack("<i", self._bgzf.read(4))[0]
            refs.append((name, l_ref))
        self.header = BamHeader(text, refs)
        self._first_rec_voffset = self._bgzf.tell_virtual()

    def __iter__(self):
        return self

    def __next__(self) -> BamRead:
        return decode_record(self.next_raw())

    def next_raw(self) -> bytes:
        """The next record's raw block (after block_size); StopIteration
        at EOF."""
        raw = self._bgzf.read(4)
        if len(raw) < 4:
            raise StopIteration
        block_size = struct.unpack("<i", raw)[0]
        buf = self._bgzf.read(block_size)
        if len(buf) < block_size:
            raise BamError("truncated BAM record")
        return buf

    def iter_raw(self):
        """Yield raw record blocks with chunked reads (~1MB at a time) —
        much faster than per-record next_raw() calls.  Takes ownership of
        the underlying stream position: do not interleave with
        next_raw/seek/tell on the same reader."""
        CHUNK = 1 << 20
        buf = b""
        pos = 0
        read = self._bgzf.read
        while True:
            if len(buf) - pos < 4:
                more = read(CHUNK)
                if not more and len(buf) - pos == 0:
                    return
                buf = buf[pos:] + more
                pos = 0
                if len(buf) < 4:
                    raise BamError("truncated BAM record")
            bs = int.from_bytes(buf[pos : pos + 4], "little")
            end = pos + 4 + bs
            while len(buf) < end:
                more = read(max(CHUNK, end - len(buf)))
                if not more:
                    raise BamError("truncated BAM record")
                buf = buf[pos:] + more
                end = 4 + bs
                pos = 0
            yield buf[pos + 4 : end]
            pos = end

    def rewind(self):
        self._bgzf.seek_virtual(self._first_rec_voffset)

    def tell_virtual(self):
        return self._bgzf.tell_virtual()

    def seek_virtual(self, v):
        self._bgzf.seek_virtual(v)

    def fetch(self, contig=None, start=None, end=None):
        """Yield reads overlapping [start, end) on contig.

        Uses the .bai index if present, else a full scan (correct, slower).
        """
        tid = self.header.tid(contig) if contig is not None else -1
        if contig is not None and tid < 0:
            raise BamError(f"unknown contig {contig}")
        use_index = False
        if contig is not None and os.path.exists(self.path + ".bai"):
            from .bai import BaiIndex
            idx = BaiIndex.load(self.path + ".bai")
            chunks = idx.query(tid, start or 0, end if end is not None else 1 << 29)
            use_index = True
        if use_index:
            seen = set()
            for cbeg, cend in chunks:
                if (cbeg, cend) in seen:
                    continue
                seen.add((cbeg, cend))
                self._bgzf.seek_virtual(cbeg)
                while self._bgzf.tell_virtual() < cend:
                    try:
                        r = next(self)
                    except StopIteration:
                        break
                    if r.tid != tid or (end is not None and r.pos >= end):
                        break
                    if start is not None and r.endpos() <= start:
                        continue
                    yield r
        else:
            self.rewind()
            for r in self:
                if contig is None:
                    yield r
                    continue
                if r.tid != tid:
                    continue
                if end is not None and r.pos >= end:
                    continue
                if start is not None and r.endpos() <= start:
                    continue
                yield r

    def close(self):
        self._bgzf.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


class BamWriter:
    def __init__(self, path_or_fh, header: BamHeader):
        self.header = header
        self._bgzf = BgzfWriter(path_or_fh)
        header.ensure_sq_lines()
        text = header.text.encode()
        self._bgzf.write(b"BAM\x01")
        self._bgzf.write(struct.pack("<i", len(text)))
        self._bgzf.write(text)
        self._bgzf.write(struct.pack("<i", len(header.references)))
        for name, length in header.references:
            nb = name.encode() + b"\x00"
            self._bgzf.write(struct.pack("<i", len(nb)))
            self._bgzf.write(nb)
            self._bgzf.write(struct.pack("<i", length))

    def write(self, r: BamRead):
        self._bgzf.write(encode_record(r))

    def write_raw(self, buf: bytes):
        self._bgzf.write(struct.pack("<i", len(buf)) + buf)

    def tell_virtual(self):
        return self._bgzf.tell_virtual()

    def flush_block(self):
        self._bgzf.flush_block()

    def close(self):
        self._bgzf.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


# ---------------------------------------------------------------------------
# SAM text
# ---------------------------------------------------------------------------

def _tag_from_sam(field: str):
    tag, typecode, val = field.split(":", 2)
    if typecode == "i":
        return tag, ("i", int(val))
    if typecode == "f":
        return tag, ("f", float(val))
    if typecode == "A":
        return tag, ("A", val)
    if typecode == "B":
        sub = val[0]
        arr = [float(x) if sub == "f" else int(x) for x in val[1:].split(",") if x]
        return tag, ("B", (sub, arr))
    return tag, (typecode, val)


def _tag_to_sam(tag, entry):
    typecode, val = entry
    if typecode in ("c", "C", "s", "S", "i", "I"):
        return f"{tag}:i:{int(val)}"
    if typecode == "f":
        return f"{tag}:f:{val:g}"
    if typecode == "B":
        sub, arr = val
        return f"{tag}:B:{sub}," + ",".join(str(x) for x in arr)
    return f"{tag}:{typecode}:{val}"


def read_sam(path_or_fh):
    """Parse a SAM text file -> (BamHeader, list[BamRead])."""
    if isinstance(path_or_fh, (str, os.PathLike)):
        fh = open(path_or_fh)
        own = True
    else:
        fh = path_or_fh
        own = False
    header_lines = []
    reads = []
    header = None
    for line in fh:
        line = line.rstrip("\n")
        if not line:
            continue
        if line.startswith("@"):
            header_lines.append(line)
            continue
        if header is None:
            header = BamHeader.from_text("\n".join(header_lines) + "\n"
                                         if header_lines else "")
        f = line.split("\t")
        r = BamRead()
        r.qname = f[0]
        r.flag = int(f[1])
        r.tid = header.tid(f[2]) if f[2] != "*" else -1
        r.pos = int(f[3]) - 1
        r.mapq = int(f[4])
        r.set_cigar_string(f[5])
        r.mtid = (r.tid if f[6] == "=" else header.tid(f[6])) if f[6] != "*" else -1
        r.mpos = int(f[7]) - 1
        r.tlen = int(f[8])
        r.seq = b"" if f[9] == "*" else f[9].upper().encode()
        if f[10] == "*":
            r.qual = np.full(len(r.seq), 0xFF, dtype=np.uint8)
        else:
            r.qual = np.frombuffer(f[10].encode(), dtype=np.uint8) - 33
        for field in f[11:]:
            tag, entry = _tag_from_sam(field)
            r.tags[tag] = entry
            r.tag_order.append(tag)
        reads.append(r)
    if header is None:
        header = BamHeader.from_text("\n".join(header_lines) + "\n"
                                     if header_lines else "")
    if own:
        fh.close()
    return header, reads


def sam_line(header: BamHeader, r: BamRead) -> str:
    rname = header.name(r.tid) if r.tid >= 0 else "*"
    if r.mtid < 0:
        rnext = "*"
    elif r.mtid == r.tid:
        rnext = "="
    else:
        rnext = header.name(r.mtid)
    if len(r.qual) and not np.all(r.qual == 0xFF):
        qual_s = (np.asarray(r.qual, dtype=np.uint8) + 33).tobytes().decode("latin-1")
    else:
        qual_s = "*"
    fields = [
        r.qname, str(r.flag), rname, str(r.pos + 1), str(r.mapq),
        r.cigar_string(), rnext, str(r.mpos + 1), str(r.tlen),
        r.seq.decode() if r.seq else "*", qual_s,
    ]
    fields += [_tag_to_sam(t, r.tags[t]) for t in r.tag_order]
    return "\t".join(fields)


def write_sam(path_or_fh, header: BamHeader, reads) -> None:
    if isinstance(path_or_fh, (str, os.PathLike)):
        fh = open(path_or_fh, "w")
        own = True
    else:
        fh = path_or_fh
        own = False
    header.ensure_sq_lines()
    if header.text:
        fh.write(header.text if header.text.endswith("\n") else header.text + "\n")
    for r in reads:
        fh.write(sam_line(header, r) + "\n")
    if own:
        fh.close()


def open_alignment(path):
    """Open BAM or SAM by sniffing; returns (header, iterator-of-reads, closer)."""
    path = str(path)
    with open(path, "rb") as fh:
        head = fh.read(4)
    if head[:2] == b"\x1f\x8b":
        rdr = BamReader(path)
        return rdr.header, iter(rdr), rdr.close
    header, reads = read_sam(path)
    return header, iter(reads), (lambda: None)
