"""Tabix (.tbi) index build/read/query for bgzip-compressed VCFs.

The reference consumes tabix indices in two places: `vcfset` random-accesses
its second VCF per position (lofreq_vcfset.c:427-433) and the call-parallel
wrapper runs `bcftools index -t` on every merged output
(lofreq2_call_pparallel.py:164-185).  This module replaces both uses with a
from-scratch implementation of the htslib TBI format (same UCSC binning as
BAI, 16 kb linear index), so emitted indices interoperate with external
htslib-based tools and their indices are readable here.
"""

from __future__ import annotations

import struct

from .bai import LINEAR_SHIFT, reg2bins
from .bam import reg2bin
from .bgzf import BgzfReader, BgzfWriter

TBX_VCF_CONF = dict(format=2, col_seq=1, col_beg=2, col_end=0,
                    meta=ord("#"), skip=0)


class TbiIndex:
    def __init__(self, names=None, conf=None):
        self.names: list[str] = names or []
        self.conf = dict(conf or TBX_VCF_CONF)
        self.bins: list[dict] = [dict() for _ in self.names]
        self.linear: list[list] = [[] for _ in self.names]
        self._tid = {n: i for i, n in enumerate(self.names)}

    def add_name(self, name: str) -> int:
        if name in self._tid:
            return self._tid[name]
        self._tid[name] = len(self.names)
        self.names.append(name)
        self.bins.append(dict())
        self.linear.append([])
        return len(self.names) - 1

    def tid(self, name: str) -> int:
        return self._tid.get(name, -1)

    def query(self, name: str, beg: int, end: int):
        """Sorted, merged (voffset_beg, voffset_end) chunks overlapping
        [beg, end) (0-based half-open) on the named sequence."""
        t = self.tid(name)
        if t < 0:
            return []
        min_off = 0
        lin = self.linear[t]
        win = beg >> LINEAR_SHIFT
        if win < len(lin):
            min_off = lin[win]
        chunks = []
        for b in reg2bins(beg, end):
            for cbeg, cend in self.bins[t].get(b, ()):
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

    # -- serialization (TBI is itself bgzip-compressed) -----------------
    @classmethod
    def load(cls, path):
        fh = BgzfReader(path)
        data = fh.read()
        fh.close()
        if data[:4] != b"TBI\x01":
            raise IOError(f"{path}: not a tabix index")
        (n_ref, fmt, c_seq, c_beg, c_end, meta, skip,
         l_nm) = struct.unpack_from("<8i", data, 4)
        off = 36
        names = data[off: off + l_nm].split(b"\x00")[:-1]
        names = [n.decode() for n in names]
        off += l_nm
        idx = cls(names, dict(format=fmt, col_seq=c_seq, col_beg=c_beg,
                              col_end=c_end, meta=meta, skip=skip))
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
                idx.bins[t][binno] = chunks
            (n_intv,) = struct.unpack_from("<i", data, off)
            off += 4
            idx.linear[t] = list(struct.unpack_from(f"<{n_intv}Q", data,
                                                    off))
            off += 8 * n_intv
        return idx

    def save(self, path):
        c = self.conf
        out = bytearray(b"TBI\x01")
        nm = b"".join(n.encode() + b"\x00" for n in self.names)
        out += struct.pack("<8i", len(self.names), c["format"], c["col_seq"],
                           c["col_beg"], c["col_end"], c["meta"], c["skip"],
                           len(nm))
        out += nm
        for t in range(len(self.names)):
            bins = self.bins[t]
            out += struct.pack("<i", len(bins))
            for binno in sorted(bins):
                chunks = bins[binno]
                out += struct.pack("<Ii", binno, len(chunks))
                for cbeg, cend in chunks:
                    out += struct.pack("<QQ", cbeg, cend)
            out += struct.pack("<i", len(self.linear[t]))
            out += struct.pack(f"<{len(self.linear[t])}Q", *self.linear[t])
        w = BgzfWriter(path)
        w.write(bytes(out))
        w.close()


def build_tbi(vcf_gz_path, out_path=None) -> TbiIndex:
    """Index a bgzip VCF sorted by (chrom-appearance-order, pos).

    Equivalent of `bcftools index -t` / `tabix -p vcf` for the outputs
    this framework writes (lofreq2_call_pparallel.py:164-185)."""
    idx = TbiIndex([])
    fh = BgzfReader(vcf_gz_path)
    last = {}
    while True:
        voff = fh.tell_virtual()
        line = fh.readline()
        if not line:
            break
        voff_end = fh.tell_virtual()
        if line.startswith(b"#"):
            continue
        fields = line.split(b"\t", 4)
        if len(fields) < 2:
            continue
        name = fields[0].decode()
        pos1 = int(fields[1])
        # VCF records span [pos-1, pos-1+len(ref)) 0-based
        ref_len = len(fields[3]) if len(fields) > 3 else 1
        beg = pos1 - 1
        end = beg + max(ref_len, 1)
        t = idx.tid(name)
        if t < 0:
            t = idx.add_name(name)
        elif t != len(idx.names) - 1 and name != idx.names[-1]:
            raise IOError(
                f"{vcf_gz_path}: records for {name} are not grouped; "
                "cannot tabix-index")
        if name in last and beg < last[name]:
            raise IOError(f"{vcf_gz_path}: not position-sorted at "
                          f"{name}:{pos1}; cannot tabix-index")
        last[name] = beg
        b = reg2bin(beg, end)
        chunks = idx.bins[t].setdefault(b, [])
        if chunks and chunks[-1][1] == voff:
            chunks[-1] = (chunks[-1][0], voff_end)
        else:
            chunks.append((voff, voff_end))
        lin = idx.linear[t]
        for win in range(beg >> LINEAR_SHIFT,
                         (max(end - 1, beg) >> LINEAR_SHIFT) + 1):
            while len(lin) <= win:
                lin.append(0)
            if lin[win] == 0:
                lin[win] = voff
    fh.close()
    for t in range(len(idx.names)):
        lin = idx.linear[t]
        prev = 0
        for i in range(len(lin)):
            if lin[i] == 0:
                lin[i] = prev
            else:
                prev = lin[i]
    if out_path is None:
        out_path = str(vcf_gz_path) + ".tbi"
    idx.save(out_path)
    return idx


class TabixVcf:
    """Random access into a tabix-indexed bgzip VCF: fetch(chrom, beg, end)
    yields raw record lines overlapping the (0-based, half-open) region —
    the lofreq_vcfset.c:427-433 access pattern without loading the file."""

    def __init__(self, vcf_gz_path, tbi_path=None):
        self.path = str(vcf_gz_path)
        self.idx = TbiIndex.load(tbi_path or self.path + ".tbi")
        self._fh = BgzfReader(self.path)

    def fetch_lines(self, chrom: str, beg: int, end: int):
        for cbeg, cend in self.idx.query(chrom, beg, end):
            self._fh.seek_virtual(cbeg)
            data = self._fh.read_until_voffset(cend)
            for line in data.splitlines():
                if not line or line.startswith(b"#"):
                    continue
                f = line.split(b"\t", 4)
                p = int(f[1]) - 1
                if f[0].decode() != chrom:
                    continue
                if p >= end:
                    break
                rend = p + max(len(f[3]) if len(f) > 3 else 1, 1)
                if rend > beg:
                    yield line
    def close(self):
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
