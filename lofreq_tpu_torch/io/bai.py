"""BAI (BAM index) reader/writer — replaces htslib's sam_index_load /
bam_index build used by the reference (lofreq_index.c, plp.c:1352-1363).

Standard UCSC binning scheme: bins over 16kb..512Mb windows plus a 16kb
linear index.
"""

from __future__ import annotations

import struct

from .bam import BamReader, reg2bin

PSEUDO_BIN = 37450
LINEAR_SHIFT = 14


def reg2bins(beg: int, end: int):
    """All bins that may overlap [beg, end)."""
    if beg >= end:
        return []
    end -= 1
    bins = [0]
    for shift, base in ((26, 1), (23, 9), (20, 73), (17, 585), (14, 4681)):
        bins.extend(range(base + (beg >> shift), base + (end >> shift) + 1))
    return bins


class BaiIndex:
    def __init__(self, n_ref: int):
        # per-ref: {bin: [(cbeg, cend), ...]}, linear [ioffsets]
        self.bins = [dict() for _ in range(n_ref)]
        self.linear = [[] for _ in range(n_ref)]
        self.stats = [None] * n_ref  # (off_beg, off_end, n_mapped, n_unmapped)
        self.n_no_coor = 0

    # -- query ----------------------------------------------------------
    def query(self, tid: int, beg: int, end: int):
        """Return sorted, merged list of (voffset_beg, voffset_end) chunks."""
        if tid < 0 or tid >= len(self.bins):
            return []
        min_off = 0
        lin = self.linear[tid]
        win = beg >> LINEAR_SHIFT
        if win < len(lin):
            min_off = lin[win]
        chunks = []
        for b in reg2bins(beg, end):
            for cbeg, cend in self.bins[tid].get(b, ()):
                if cend > min_off:
                    chunks.append((max(cbeg, min_off), cend))
        chunks.sort()
        merged = []
        for cbeg, cend in chunks:
            if merged and cbeg <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], cend))
            else:
                merged.append((cbeg, cend))
        return merged

    def mapped_unmapped(self, tid: int):
        s = self.stats[tid]
        return (0, 0) if s is None else (s[2], s[3])

    # -- serialization --------------------------------------------------
    @classmethod
    def load(cls, path):
        with open(path, "rb") as fh:
            data = fh.read()
        if data[:4] != b"BAI\x01":
            raise IOError(f"{path}: not a BAI index")
        off = 4
        (n_ref,) = struct.unpack_from("<i", data, off)
        off += 4
        idx = cls(n_ref)
        for t in range(n_ref):
            (n_bin,) = struct.unpack_from("<i", data, off)
            off += 4
            for _ in range(n_bin):
                binno, n_chunk = struct.unpack_from("<Ii", data, off)
                off += 8
                chunks = []
                for _ in range(n_chunk):
                    cbeg, cend = struct.unpack_from("<QQ", data, off)
                    off += 16
                    chunks.append((cbeg, cend))
                if binno == PSEUDO_BIN:
                    if len(chunks) == 2:
                        idx.stats[t] = (chunks[0][0], chunks[0][1],
                                        chunks[1][0], chunks[1][1])
                else:
                    idx.bins[t][binno] = chunks
            (n_intv,) = struct.unpack_from("<i", data, off)
            off += 4
            idx.linear[t] = list(struct.unpack_from(f"<{n_intv}Q", data, off))
            off += 8 * n_intv
        if off + 8 <= len(data):
            (idx.n_no_coor,) = struct.unpack_from("<Q", data, off)
        return idx

    def save(self, path):
        out = bytearray(b"BAI\x01")
        out += struct.pack("<i", len(self.bins))
        for t in range(len(self.bins)):
            bins = self.bins[t]
            n_bin = len(bins) + (1 if self.stats[t] else 0)
            out += struct.pack("<i", n_bin)
            for binno in sorted(bins):
                chunks = bins[binno]
                out += struct.pack("<Ii", binno, len(chunks))
                for cbeg, cend in chunks:
                    out += struct.pack("<QQ", cbeg, cend)
            if self.stats[t]:
                ob, oe, nm, nu = self.stats[t]
                out += struct.pack("<Ii", PSEUDO_BIN, 2)
                out += struct.pack("<QQQQ", ob, oe, nm, nu)
            out += struct.pack("<i", len(self.linear[t]))
            out += struct.pack(f"<{len(self.linear[t])}Q", *self.linear[t])
        out += struct.pack("<Q", self.n_no_coor)
        with open(path, "wb") as fh:
            fh.write(out)


def build_bai(bam_path, out_path=None) -> BaiIndex:
    """Index a coordinate-sorted BAM (equivalent of `lofreq index`)."""
    rdr = BamReader(bam_path)
    n_ref = len(rdr.header.references)
    idx = BaiIndex(n_ref)
    counts = [[0, 0] for _ in range(n_ref)]  # mapped, unmapped
    offsets = [[None, 0] for _ in range(n_ref)]  # off_beg, off_end
    last_tid, last_pos = -1, -1
    while True:
        voff = rdr.tell_virtual()
        try:
            r = next(rdr)
        except StopIteration:
            break
        voff_end = rdr.tell_virtual()
        if r.tid < 0:
            idx.n_no_coor += 1
            continue
        if r.tid < last_tid or (r.tid == last_tid and r.pos < last_pos):
            raise IOError("BAM is not coordinate-sorted; cannot index")
        last_tid, last_pos = r.tid, r.pos
        endpos = r.endpos() if len(r.cigar) else r.pos + 1
        b = reg2bin(r.pos, max(endpos, r.pos + 1))
        chunks = idx.bins[r.tid].setdefault(b, [])
        if chunks and chunks[-1][1] == voff:
            chunks[-1] = (chunks[-1][0], voff_end)
        else:
            chunks.append((voff, voff_end))
        lin = idx.linear[r.tid]
        for win in range(r.pos >> LINEAR_SHIFT,
                         (max(endpos - 1, r.pos) >> LINEAR_SHIFT) + 1):
            while len(lin) <= win:
                lin.append(0)
            if lin[win] == 0:
                lin[win] = voff
        # fill-in zeros later
        if r.flag & 0x4:
            counts[r.tid][1] += 1
        else:
            counts[r.tid][0] += 1
        if offsets[r.tid][0] is None:
            offsets[r.tid][0] = voff
        offsets[r.tid][1] = voff_end
    rdr.close()
    for t in range(n_ref):
        lin = idx.linear[t]
        prev = 0
        for i in range(len(lin)):
            if lin[i] == 0:
                lin[i] = prev
            else:
                prev = lin[i]
        if counts[t][0] or counts[t][1]:
            idx.stats[t] = (offsets[t][0] or 0, offsets[t][1],
                            counts[t][0], counts[t][1])
    if out_path is None:
        out_path = str(bam_path) + ".bai"
    idx.save(out_path)
    return idx
