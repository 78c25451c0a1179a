"""`indelqual`: insert per-base indel qualities (BI/BD tags) into a BAM.

Two modes as in the reference (lofreq_indelqual.c):
  * uniform iq[,dq]: same value for every base
  * dindel: Illumina-specific qualities from the homopolymer-length lookup
    table DINDELQ ("!MMMLKEC@=<;:988776"), indexed by the run length at the
    next reference position (dindel_fetch_func, lofreq_indelqual.c:136-215).
"""

from __future__ import annotations

import numpy as np

from .. import defaults as D
from ..io.bam import (
    BamReader,
    BamWriter,
    CDEL,
    CDIFF,
    CEQUAL,
    CHARD_CLIP,
    CINS,
    CMATCH,
    CSOFT_CLIP,
    FDUP,
    FQCFAIL,
    FSECONDARY,
    FUNMAP,
    read_sam,
    write_sam,
)

DINDELQ = "!MMMLKEC@=<;:988776"  # 1-based 18


def encode_q(q: int) -> str:
    return chr(33 if q < 33 else (126 if q > 126 else q))


def find_homopolymers(ref: bytes) -> np.ndarray:
    """hpcount[i] = run length at run starts, 1 elsewhere."""
    a = np.frombuffer(ref, dtype=np.uint8)
    L = len(a)
    if L == 0:
        return np.zeros(0, dtype=np.int64)
    change = np.nonzero(a[1:] != a[:-1])[0] + 1
    starts = np.concatenate([[0], change])
    lens = np.diff(np.concatenate([starts, [L]]))
    out = np.ones(L, dtype=np.int64)
    out[starts] = lens
    return out


def dindel_quals(read, hpcount: np.ndarray, rlen: int) -> str:
    """Per-base indel-quality string for one read."""
    qmap = dindel_qual_map(hpcount, rlen)
    return dindel_quals_ops(read.pos, read.cigar_ops(), qmap,
                            read.qname).decode("latin-1")


_DINDELQ_ARR = np.frombuffer(DINDELQ.encode(), dtype=np.uint8)
_DINDELQ0 = DINDELQ[0].encode()


def dindel_qual_map(hpcount: np.ndarray, rlen: int) -> bytes:
    """qmap[x] = the dindel quality of a match base at reference position
    x (dindel_fetch_func semantics: DINDELQ at the homopolymer run length
    of x+1; '!' past the contig end or for runs > 18).  Computed once per
    chromosome so each read reduces to byte slices."""
    if rlen == 0:
        return b""
    qidx = np.zeros(rlen, dtype=np.int64)
    hp_next = hpcount[1:rlen]
    qidx[: rlen - 1] = np.where(hp_next <= 18, hp_next, 0)
    # x = rlen-1 (> rlen-2) stays 0 -> '!'
    return _DINDELQ_ARR[qidx].tobytes()


def dindel_quals_ops(pos, cigar_ops, qmap: bytes, qname="?") -> bytes:
    """Per-base indel-quality bytes from (pos, cigar) and the chromosome
    quality map (lofreq_indelqual.c:136-215)."""
    rlen = len(qmap)
    parts = []
    x = pos
    for op, l in cigar_ops:
        if op in (CMATCH, CEQUAL, CDIFF):
            seg = qmap[x : x + l]
            if len(seg) < l:        # read past contig end -> '!'
                seg += _DINDELQ0 * (l - len(seg))
            parts.append(seg)
            x += l
        elif op == CHARD_CLIP:
            pass
        elif op == CDEL:
            x += l
        elif op in (CINS, CSOFT_CLIP):
            parts.append(_DINDELQ0 * l)
        else:
            raise ValueError(f"unknown cigar op {op} in read {qname}")
    return b"".join(parts)


def run_indelqual(bam_in, bam_out, uniform=None, dindel=False, ref_path=None):
    """uniform: (iq, dq) ints, or dindel=True with ref_path.

    Streams raw record blocks: BI/BD need only pos/cigar/l_seq, so reads
    are never decoded — existing BI/BD aux entries are spliced out and the
    new ones appended (the reference's bam_aux_del + bam_aux_append)."""
    from ..io import bam as bamio

    rdr = BamReader(bam_in)
    wtr = BamWriter(bam_out, rdr.header)
    hp_cache = {}
    fa = None
    if dindel:
        from ..io.fasta import Fasta

        fa = Fasta(ref_path)
    count = 0
    BI, BD = D.BI_TAG.encode(), D.BD_TAG.encode()
    bibd = {BI, BD}
    for raw in rdr.iter_raw():
        count += 1
        f = bamio.raw_fields(raw)
        l_seq = f[7]
        if uniform is not None:
            iq, dq = uniform
            iq_s = (encode_q(iq + 33) * l_seq).encode("latin-1")
            dq_s = (encode_q(dq + 33) * l_seq).encode("latin-1")
        else:
            if f[6] & (FUNMAP | FSECONDARY | FQCFAIL | FDUP):
                wtr.write_raw(raw)
                continue
            chrom = rdr.header.name(f[0])
            if chrom not in hp_cache:
                ref = fa.fetch(chrom)
                hp_cache[chrom] = dindel_qual_map(
                    find_homopolymers(ref), len(ref))
            qmap = hp_cache[chrom]
            cig_off, n_cigar = 32 + f[2], f[5]
            ops = [(raw[cig_off + 4 * j] & 0xF,
                    int.from_bytes(raw[cig_off + 4 * j:
                                       cig_off + 4 * j + 4], "little") >> 4)
                   for j in range(n_cigar)]
            iq_s = dq_s = dindel_quals_ops(f[1], ops, qmap)
        raw2 = bamio.raw_strip_tags(raw, bibd)
        wtr.write_raw(raw2 + bamio.encode_z_tag(BI, iq_s)
                      + bamio.encode_z_tag(BD, dq_s))
    wtr.close()
    rdr.close()
    return count


def run_alnqual(bam_in, bam_out, ref_path, baq=True, ext_baq=True, idaq=True,
                redo_baq=False, redo_idaq=False):
    """`alnqual`: attach lb/ai/ad tags (lofreq_alnqual.c).

    Streams raw record blocks: skip decisions (tag presence, indel ops)
    come from the raw aux/cigar bytes, the batched HMM consumes packed
    arrays built straight from the raw buffers, and the output is the raw
    record with the new tags spliced in — reads are never decoded to
    BamRead objects.  Skip logic follows bam_md_ext.c:296-366."""
    from .. import defaults as D
    from ..io import bam as bamio
    from ..io.fasta import Fasta
    from ..ops.baq_hmm import realn_batch_raw

    fa = Fasta(ref_path)
    rdr = BamReader(bam_in)
    wtr = BamWriter(bam_out, rdr.header)
    LB, AI, AD = D.BAQ_TAG.encode(), D.AI_TAG.encode(), D.AD_TAG.encode()
    tagset = (LB, AI, AD)

    pending = []                 # (raw, is_dp) in input order
    dp_raws, dp_wb, dp_wi = [], [], []
    cur_tid = None

    def flush():
        nonlocal pending, dp_raws, dp_wb, dp_wi
        if dp_raws:
            ref = fa.fetch(rdr.header.name(cur_tid))
            flags, bq, ia, da, ost = realn_batch_raw(
                dp_raws, dp_wb, dp_wi, ref, ext_baq)
        di = 0
        for raw, is_dp in pending:
            if is_dp:
                fl = int(flags[di])
                lo = int(ost[di])
                l_seq = int(ost[di + 1]) - lo - 1
                strip = set()
                add = b""
                if fl & 1:
                    strip.add(LB)
                    add += bamio.encode_z_tag(LB, bq[lo:lo + l_seq]
                                              .tobytes())
                if fl & 2:
                    strip.add(AI)
                    add += bamio.encode_z_tag(AI, ia[lo:lo + l_seq]
                                              .tobytes())
                if fl & 4:
                    strip.add(AD)
                    add += bamio.encode_z_tag(AD, da[lo:lo + l_seq]
                                              .tobytes())
                if strip:
                    raw = bamio.raw_strip_tags(raw, strip)
                raw += add
                di += 1
            wtr.write_raw(raw)
        pending = []
        dp_raws, dp_wb, dp_wi = [], [], []

    for raw in rdr.iter_raw():
        f = bamio.raw_fields(raw)
        tid, n_cigar, flag, l_seq = f[0], f[5], f[6], f[7]
        if (flag & FUNMAP) or tid < 0 or l_seq == 0:
            pending.append((raw, False))
            continue
        if cur_tid is not None and tid != cur_tid:
            flush()
        cur_tid = tid
        present = bamio.raw_find_tags(raw, tagset)
        if redo_baq and LB in present:
            raw = bamio.raw_strip_tags(raw, {LB})
            present.pop(LB)
        if redo_idaq and (AI in present or AD in present):
            raw = bamio.raw_strip_tags(raw, {AI, AD})
            present.pop(AI, None)
            present.pop(AD, None)
        has_ins = has_del = False
        cig_off = 32 + f[2]
        for j in range(n_cigar):
            op = raw[cig_off + 4 * j] & 0xF
            if op == CINS:
                has_ins = True
            elif op == CDEL:
                has_del = True
        if (not baq) or LB in present:
            skip = True
            if idaq and has_del and AD not in present:
                skip = False
            if idaq and has_ins and AI not in present:
                skip = False
            if skip:
                pending.append((raw, False))
                continue
        pending.append((raw, True))
        dp_raws.append(raw)
        dp_wb.append(1 if baq and LB not in present else 0)
        dp_wi.append(1 if idaq else 0)
        if len(dp_raws) >= 2000:
            flush()
    flush()
    wtr.close()
    rdr.close()
