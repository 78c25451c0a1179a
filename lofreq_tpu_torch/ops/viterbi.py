"""Viterbi realignment of reads with indels (`lofreq viterbi` equivalent).

ctypes bridge to csrc/realign.c plus the read-level driver logic of
lofreq_viterbi.c:107-345: extract softclip-free query + quals, replace Q2
quals by the read median, realign against a +-RWIN reference window, rebuild
the cigar (re-attaching soft clips) and shift the position if needed.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from ..io.bam import (
    CDEL,
    CDIFF,
    CEQUAL,
    CHARD_CLIP,
    CINS,
    CMATCH,
    CSOFT_CLIP,
    FUNMAP,
)

from .._native_build import get_native_lib

RWIN = 10

_lock = threading.Lock()
_lib = None


def _get_lib():
    global _lib
    with _lock:
        if _lib is None:
            lib = get_native_lib()
            lib.lfq_viterbi_one.argtypes = [
                ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
                ctypes.c_int, ctypes.c_char_p,
            ]
            lib.lfq_viterbi_one.restype = ctypes.c_int
            _pp = ctypes.POINTER(ctypes.c_char_p)
            lib.lfq_viterbi_xn.argtypes = [
                _pp, _pp, _pp, ctypes.POINTER(ctypes.c_int),
                ctypes.c_int, ctypes.c_int, _pp,
                ctypes.POINTER(ctypes.c_int), ctypes.c_int,
            ]
            lib.lfq_viterbi_xn.restype = ctypes.c_int
            _lib = lib
    return _lib


def viterbi_align(ref_win: bytes, query: bytes, bqual_sanger: bytes,
                  q2default: int):
    """Returns (shift, aln_state_string)."""
    lib = _get_lib()
    buf = ctypes.create_string_buffer(len(query) + len(ref_win) + 4)
    shift = lib.lfq_viterbi_one(ref_win, query, bqual_sanger,
                                int(q2default), buf)
    return shift, buf.value.decode()


def viterbi_align_group(preps, nl):
    """Run nl (4 or 8) same-(qlen, rlen) preps through the SIMD lanes.
    preps: [(query, bqual_sanger, q2default, ref_win), ...]; returns
    [(shift, aln), ...] bit-identical to per-read viterbi_align."""
    lib = _get_lib()
    refs = (ctypes.c_char_p * nl)(*[p[3] for p in preps])
    qrys = (ctypes.c_char_p * nl)(*[p[0] for p in preps])
    bqs = (ctypes.c_char_p * nl)(*[p[1] for p in preps])
    q2d = (ctypes.c_int * nl)(*[int(p[2]) for p in preps])
    bufs = [ctypes.create_string_buffer(len(p[0]) + len(p[3]) + 4)
            for p in preps]
    alns = (ctypes.c_char_p * nl)(
        *[ctypes.cast(b, ctypes.c_char_p) for b in bufs])
    shifts = (ctypes.c_int * nl)()
    rc = lib.lfq_viterbi_xn(refs, qrys, bqs, q2d,
                            len(preps[0][0]) + 1, len(preps[0][3]) + 1,
                            alns, shifts, nl)
    if rc != 0:
        return [viterbi_align(p[3], p[0], p[1], p[2]) for p in preps]
    return [(shifts[i], bufs[i].value.decode()) for i in range(nl)]


_OPMAP = {"M": CMATCH, "I": CINS, "D": CDEL}


def realign_prep(r, ref: bytes, q2default: int = -1):
    """Per-read prep for the realigner.  Returns
    (query, bqual_sanger, q2d, ref_win, lower) or None when the read is
    passed through untouched (no indels / hardclipped / all-Q2)."""
    if r.flag & FUNMAP:
        return None
    query = []
    bqual = []
    x = r.pos
    indels = 0
    for op, l in r.cigar_ops():
        if op in (CMATCH, CEQUAL, CDIFF):
            pass
        elif op == CHARD_CLIP:
            return None
        elif op == CDEL:
            indels += 1
        elif op == CINS:
            indels += 1
        elif op == CSOFT_CLIP:
            pass
        else:
            return None
    if indels == 0:
        return None
    y = 0
    for op, l in r.cigar_ops():
        if op in (CMATCH, CEQUAL, CDIFF, CINS):
            query.append(r.seq[y : y + l])
            bqual.append((np.asarray(r.qual[y : y + l]) + 33)
                         .astype(np.uint8).tobytes())
            y += l
            if op != CINS:
                x += l
        elif op == CSOFT_CLIP:
            y += l
        elif op == CDEL:
            x += l
    query = b"".join(query)
    bqual = b"".join(bqual)

    phreds = np.frombuffer(bqual, dtype=np.uint8).astype(np.int64) - 33
    non_q2 = phreds[phreds != 2]
    if len(non_q2) == 0:
        # all Q2: written unrealigned (lofreq_viterbi.c:220-242); with
        # --reclip the ORIGINAL cigar's edge inserts become soft clips
        return "allq2"
    q2d = q2default
    if q2d < 0:
        vals = np.sort(non_q2)
        n = len(vals)
        if n % 2 == 0:
            q2d = int((vals[n // 2] + vals[n // 2 - 1]) / 2.0)
        else:
            q2d = int(vals[n // 2])

    lower = max(r.pos - RWIN, 0)
    upper = min(x + RWIN, len(ref))
    return query, bqual, q2d, ref[lower:upper], lower


def realign_read(r, ref: bytes, q2default: int = -1, reclip: bool = False):
    """Realign one read in place.  Returns True if the read was modified
    (or examined); False if passed through untouched (no indels/hardclip)."""
    prep = realign_prep(r, ref, q2default)
    if prep is None:
        return False
    if prep == "allq2":
        if reclip:
            reclip_edge_inserts(r)
        return False
    query, bqual, q2d, ref_win, lower = prep
    shift, aln = viterbi_align(ref_win, query, bqual, q2d)
    return realign_apply(r, shift, aln, lower, reclip=reclip)


def reclip_edge_inserts(r):
    """--reclip: convert a leading/trailing INSERT op to a soft clip
    in place (lofreq_viterbi.c:222-239, 327-343)."""
    cig = r.cigar
    if len(cig) == 0:
        return
    if (int(cig[0]) & 0xF) == CINS:
        cig[0] = (int(cig[0]) & ~np.uint32(0xF)) | CSOFT_CLIP
    if (int(cig[-1]) & 0xF) == CINS:
        cig[-1] = (int(cig[-1]) & ~np.uint32(0xF)) | CSOFT_CLIP
    r.cigar = cig


def realign_apply(r, shift, aln, lower, reclip: bool = False):
    """Apply a realignment result (cigar rebuild + position shift)."""
    if not aln:
        return False

    new_cigar = []
    ops = r.cigar_ops()
    if ops and ops[0][0] == CSOFT_CLIP:
        new_cigar.append((ops[0][1] << 4) | CSOFT_CLIP)
    cur = _OPMAP[aln[0]]
    cnt = 1
    for ch in aln[1:]:
        op = _OPMAP[ch]
        if op != cur:
            new_cigar.append((cnt << 4) | cur)
            cur = op
            cnt = 1
        else:
            cnt += 1
    new_cigar.append((cnt << 4) | cur)
    if len(ops) > 1 and ops[-1][0] == CSOFT_CLIP:
        new_cigar.append((ops[-1][1] << 4) | CSOFT_CLIP)

    if shift - (r.pos - lower) != 0:
        r.pos = r.pos + (shift - (r.pos - lower))
    if reclip:
        # edge inserts of the REALIGNED cigar become soft clips
        # (lofreq_viterbi.c:327-343)
        if (new_cigar[0] & 0xF) == CINS:
            new_cigar[0] = (new_cigar[0] & ~0xF) | CSOFT_CLIP
        if (new_cigar[-1] & 0xF) == CINS:
            new_cigar[-1] = (new_cigar[-1] & ~0xF) | CSOFT_CLIP
    r.cigar = np.array(new_cigar, dtype=np.uint32)
    return True


def run_viterbi(bam_in, bam_out, ref_path, q2default: int = -1,
                del_flags: bool = True, reclip: bool = False):
    """`lofreq viterbi` over a whole BAM (output order = input order,
    likely unsorted afterwards, as in the reference).

    Raw fast path: only reads with indels are decoded and realigned
    (lofreq_viterbi.c:188-219 skips the rest anyway); everything else is
    streamed through as raw record bytes with at most an aux-tag splice
    for the NM/MC/MD/AS removal — no per-read decode/re-encode."""
    from ..io import bam as bamio
    from ..io.bam import BamReader, BamWriter, decode_record
    from ..io.fasta import Fasta

    strip = {b"NM", b"MC", b"MD", b"AS"} if del_flags else None
    fa = Fasta(ref_path)
    rdr = BamReader(bam_in)
    wtr = BamWriter(bam_out, rdr.header)
    ref_cache = {}
    n_realigned = 0

    # indel reads are buffered, grouped by (qlen, ref-window len) and run
    # through the SIMD lane kernels (8, then 4, scalar remainder — all
    # bit-identical), then written back in input order
    pending = []                # ("raw", bytes) | ("dp", read, prep|None)
    n_dp = 0

    def flush():
        nonlocal pending, n_dp, n_realigned
        groups = {}
        for j, ent in enumerate(pending):
            if ent[0] == "dp" and ent[2] is not None \
                    and ent[2] != "allq2":
                p = ent[2]
                groups.setdefault((len(p[0]), len(p[3])), []).append(j)
        results = {}
        for idxs in groups.values():
            pos = 0
            while len(idxs) - pos >= 8:
                grp = idxs[pos:pos + 8]
                out = viterbi_align_group(
                    [pending[j][2] for j in grp], 8)
                for j, res in zip(grp, out):
                    results[j] = res
                pos += 8
            if len(idxs) - pos >= 4:
                grp = idxs[pos:pos + 4]
                out = viterbi_align_group(
                    [pending[j][2] for j in grp], 4)
                for j, res in zip(grp, out):
                    results[j] = res
                pos += 4
            for j in idxs[pos:]:
                p = pending[j][2]
                results[j] = viterbi_align(p[3], p[0], p[1], p[2])
        for j, ent in enumerate(pending):
            if ent[0] == "raw":
                wtr.write_raw(ent[1])
                continue
            _, r, prep = ent
            if prep == "allq2":
                if reclip:
                    reclip_edge_inserts(r)
            elif prep is not None:
                shift, aln = results[j]
                if realign_apply(r, shift, aln, prep[4], reclip=reclip):
                    n_realigned += 1
            wtr.write(r)
        pending = []
        n_dp = 0

    for raw in rdr.iter_raw():
        if strip:
            raw = bamio.raw_strip_tags(raw, strip)
        f = bamio.raw_fields(raw)
        tid, flag, n_cigar = f[0], f[6], f[5]
        if not (flag & FUNMAP) and tid >= 0 and n_cigar:
            # cigar op = low nibble of each u32's first byte; n_cigar is
            # tiny, so a bytes walk beats a numpy round-trip
            cig_off = 32 + f[2]
            has_indel = False
            for j in range(n_cigar):
                op = raw[cig_off + 4 * j] & 0xF
                if op == CINS or op == CDEL:
                    has_indel = True
                    break
            if has_indel:
                r = decode_record(raw)
                chrom = rdr.header.name(r.tid)
                if chrom not in ref_cache:
                    ref_cache[chrom] = fa.fetch(chrom)
                prep = realign_prep(r, ref_cache[chrom], q2default)
                pending.append(("dp", r, prep))
                n_dp += 1
                if n_dp >= 1024:
                    flush()
                continue
        pending.append(("raw", raw))
        if len(pending) >= 65536:
            flush()
    flush()
    wtr.close()
    rdr.close()
    return n_realigned
