"""Read filtering + pileup tensorization.

Semantics of the reference's read hook (mplp_func, plp.c:598-744) and column
builder (compile_plp_col, plp.c:797-1288), re-expressed columnar: every kept
read is expanded into per-base rows (numpy arrays), rows are grouped by
reference position, and per-column quantities (counts, quality arrays, indel
events, consensus) are computed with vectorized segment operations.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .. import defaults as D
from ..io import bam as bamio
from ..io.bam import (
    CDEL,
    CDIFF,
    CEQUAL,
    CHARD_CLIP,
    CINS,
    CMATCH,
    CREF_SKIP,
    CSOFT_CLIP,
    FDUP,
    FPAIRED,
    FPROPER_PAIR,
    FQCFAIL,
    FSECONDARY,
    FUNMAP,
)

NT4 = "ACGTN"
_NT4_TABLE = np.full(256, 4, dtype=np.uint8)
for _i, _c in enumerate("ACGT"):
    _NT4_TABLE[ord(_c)] = _i
    _NT4_TABLE[ord(_c.lower())] = _i


@dataclass
class PileupConf:
    """mplp_conf_t equivalent (plp.h:57-70)."""

    min_mq: int = D.DEFAULT_MIN_MQ
    max_mq: int = D.DEFAULT_MAX_MQ
    max_depth: int = D.DEFAULT_MAX_PLP_DEPTH
    min_plp_bq: int = D.DEFAULT_MIN_PLP_BQ
    min_plp_idq: int = D.DEFAULT_MIN_PLP_IDQ
    def_nm_q: int = D.DEFAULT_DEF_NM_QUAL
    no_orphan: bool = True
    use_baq: bool = True
    redo_baq: bool = False
    ext_baq: bool = True
    use_idaq: bool = True
    redo_idaq: bool = False
    use_sq: bool = False
    # opt-in: count '='(CEQUAL) bases as matches in the source-qual op
    # count.  Default False = reference parity: samutils.c:481-489 only
    # handles CMATCH/CDIFF, so '=' bases contribute no evidence (see
    # pileup/sourcequal.py:count_cigar_ops).
    sq_count_eq: bool = False
    illumina13: bool = False
    bed = None
    collect_indels: bool = True


# ---------------------------------------------------------------------------
# Per-read row expansion
# ---------------------------------------------------------------------------

@dataclass
class ReadRows:
    """Flat per-pileup-row arrays for a batch of reads.

    A "row" is one (read, reference-position) incidence, like one
    bam_pileup1_t entry.  Base rows (is_del==0, is_refskip==0) carry the
    aligned base; deletion/refskip rows keep coverage and indel-qual info.
    """

    pos: np.ndarray  # int32 reference positions
    nt4: np.ndarray  # uint8, 0..4 (undefined for del rows)
    bq: np.ndarray  # int16
    baq: np.ndarray  # int16, -1 missing
    mq: np.ndarray  # int16
    sq: np.ndarray  # int32, -1 missing (source quals can exceed 32767)
    strand: np.ndarray  # uint8, 1 = reverse
    is_del: np.ndarray  # bool
    is_refskip: np.ndarray  # bool
    is_head: np.ndarray  # bool
    is_tail: np.ndarray  # bool
    indel: np.ndarray  # int32 : +l insertion after this base, -l deletion
    iq: np.ndarray  # int16 BI qual at qpos (0 if missing tag)
    dq: np.ndarray  # int16 BD qual at qpos
    iaq: np.ndarray  # int16 ai qual at qpos (-1 if missing)
    daq: np.ndarray  # int16 ad qual at qpos (-1)
    has_ai: np.ndarray  # bool: read has ai tag (for has_indel_aqs)
    has_ad: np.ndarray  # bool
    event_id: np.ndarray  # int32 index into events list for indel rows, -1
    events: list  # [(seq: str, is_ins: bool)] per event occurrence

    @classmethod
    def empty(cls):
        z = lambda dt: np.zeros(0, dtype=dt)  # noqa: E731
        return cls(
            pos=z(np.int64), nt4=z(np.uint8), bq=z(np.int16), baq=z(np.int16),
            mq=z(np.int16), sq=z(np.int32), strand=z(np.uint8),
            is_del=z(bool), is_refskip=z(bool), is_head=z(bool),
            is_tail=z(bool), indel=z(np.int64), iq=z(np.int16),
            dq=z(np.int16), iaq=z(np.int16), daq=z(np.int16),
            has_ai=z(bool), has_ad=z(bool), event_id=z(np.int64), events=[],
        )

    # native ingest constructs instances with only the hot columns set and
    # the packed flags byte attached as raw_flags; the bit-expanded arrays
    # (2s of astype per 50M rows otherwise) materialize lazily on access
    _FLAG_LAZY = {
        "is_del": (0, bool), "is_refskip": (1, bool), "is_head": (2, bool),
        "is_tail": (3, bool), "strand": (4, np.uint8),
        "has_ai": (5, bool), "has_ad": (6, bool),
    }

    def __getattr__(self, name):
        lazy = type(self)._FLAG_LAZY.get(name)
        fl = self.__dict__.get("raw_flags")
        if lazy is None or fl is None:
            raise AttributeError(name)
        bit, dt = lazy
        val = ((fl >> bit) & 1).astype(dt)
        setattr(self, name, val)
        return val


def read_passes_filters(r: bamio.BamRead, conf: PileupConf, chrom_name=None) -> bool:
    """mplp_func read-level filters (plp.c:613-721), minus BAQ/SQ compute."""
    if r.tid < 0 or (r.flag & FUNMAP):
        return False
    if r.flag & (FUNMAP | FSECONDARY | FQCFAIL | FDUP):
        return False
    if conf.bed is not None and chrom_name is not None:
        if not conf.bed.overlap(chrom_name, r.pos, r.endpos()):
            return False
    if r.mapq <= conf.max_mq:
        # plp.c:707-720 is an else-if chain: a read above the MQ cap is
        # capped and accepted, bypassing the min-mq AND orphan skips
        if r.mapq < conf.min_mq:
            return False
        if conf.no_orphan and (r.flag & FPAIRED) \
                and not (r.flag & FPROPER_PAIR):
            return False
    return True


def _tag_quals(r: bamio.BamRead, tag: str):
    """Phred array from a 'Z' qual-string tag (offset 33), or None."""
    v = r.get_tag(tag)
    if v is None:
        return None
    a = np.frombuffer(v.encode("latin-1"), dtype=np.uint8).astype(np.int16) - 33
    return a


def expand_read(r: bamio.BamRead, conf: PileupConf, out: dict):
    """Append this read's pileup rows to the per-field lists in `out`."""
    qual = np.asarray(r.qual, dtype=np.int16)
    if conf.illumina13:
        qual = np.where(qual > 31, qual - 31, 0).astype(np.int16)
    mq = min(r.mapq, conf.max_mq)
    strand = 1 if r.is_reverse else 0
    sq_val = r.get_tag(D.SRC_QUAL_TAG)
    sq = int(sq_val) if sq_val is not None else -1
    baq = _tag_quals(r, D.BAQ_TAG) if conf.use_baq else None
    bi = _tag_quals(r, D.BI_TAG)
    bd = _tag_quals(r, D.BD_TAG)
    ai = _tag_quals(r, D.AI_TAG)
    ad = _tag_quals(r, D.AD_TAG)
    nt4_read = _NT4_TABLE[np.frombuffer(r.seq, dtype=np.uint8)]

    segs_pos = []
    segs_qpos = []  # query pos per row (for del rows: preceding base)
    segs_isdel = []
    segs_isskip = []
    x = r.pos
    y = 0
    cig = r.cigar_ops()
    ncig = len(cig)
    indel_rows = {}  # row_global_idx offset (within read) -> indel length
    events = []  # (local_row_idx, seq, is_ins)
    nrows = 0
    prev_aligned = False
    for ci, (op, l) in enumerate(cig):
        if op in (CMATCH, CEQUAL, CDIFF):
            segs_pos.append(np.arange(x, x + l, dtype=np.int64))
            segs_qpos.append(np.arange(y, y + l, dtype=np.int64))
            segs_isdel.append(np.zeros(l, dtype=bool))
            segs_isskip.append(np.zeros(l, dtype=bool))
            x += l
            y += l
            nrows += l
            prev_aligned = True
        elif op == CINS:
            if prev_aligned and nrows > 0:
                indel_rows[nrows - 1] = l
                seq = r.seq[y : y + l].decode().upper()
                events.append((nrows - 1, seq, True))
            y += l
            prev_aligned = False
        elif op == CDEL:
            if prev_aligned and nrows > 0:
                indel_rows[nrows - 1] = -l
                events.append((nrows - 1, None, False))  # seq filled from ref
            segs_pos.append(np.arange(x, x + l, dtype=np.int64))
            # htslib pileup: a deleted column's qpos is the NEXT query
            # base (y does not advance through D), which is where
            # compile_plp_col reads the BI/BD tags (plp.c:1024,1038);
            # verified against the reference by test_plp_differential
            segs_qpos.append(np.full(l, y, dtype=np.int64))
            segs_isdel.append(np.ones(l, dtype=bool))
            segs_isskip.append(np.zeros(l, dtype=bool))
            x += l
            nrows += l
            prev_aligned = False
        elif op == CREF_SKIP:
            segs_pos.append(np.arange(x, x + l, dtype=np.int64))
            segs_qpos.append(np.full(l, y, dtype=np.int64))
            segs_isdel.append(np.zeros(l, dtype=bool))
            segs_isskip.append(np.ones(l, dtype=bool))
            x += l
            nrows += l
            prev_aligned = False
        elif op == CSOFT_CLIP:
            y += l
            prev_aligned = False
        elif op in (CHARD_CLIP,):
            prev_aligned = False
        # CPAD ignored
        _ = ci, ncig
    if nrows == 0:
        return

    pos = np.concatenate(segs_pos)
    qpos = np.concatenate(segs_qpos)
    is_del = np.concatenate(segs_isdel)
    is_skip = np.concatenate(segs_isskip)
    n = len(pos)
    qpos_c = np.clip(qpos, 0, max(len(qual) - 1, 0))

    indel = np.zeros(n, dtype=np.int64)
    event_id = np.full(n, -1, dtype=np.int64)
    ev_list = []
    for li, (row_idx, seq, is_ins) in enumerate(events):
        indel[row_idx] = indel_rows[row_idx]
        event_id[row_idx] = len(out["events"]) + li
        ev_list.append((seq, is_ins))

    out["pos"].append(pos)
    out["nt4"].append(np.where(is_del | is_skip, 4,
                               nt4_read[qpos_c]).astype(np.uint8))
    out["bq"].append(np.asarray(qual[qpos_c], dtype=np.int16))
    # BAQ is only defined for aligned bases (del/refskip rows never read it)
    out["baq"].append(
        np.where(is_del | is_skip, np.int16(-1), baq[qpos_c].astype(np.int16))
        if baq is not None else np.full(n, -1, dtype=np.int16))
    out["mq"].append(np.full(n, mq, dtype=np.int16))
    out["sq"].append(np.full(n, sq, dtype=np.int32))
    out["strand"].append(np.full(n, strand, dtype=np.uint8))
    out["is_del"].append(is_del)
    out["is_refskip"].append(is_skip)
    head = np.zeros(n, dtype=bool)
    head[0] = True
    tail = np.zeros(n, dtype=bool)
    tail[-1] = True
    out["is_head"].append(head)
    out["is_tail"].append(tail)
    out["indel"].append(indel)
    out["iq"].append(bi[qpos_c].astype(np.int16) if bi is not None
                     else np.zeros(n, dtype=np.int16))
    out["dq"].append(bd[qpos_c].astype(np.int16) if bd is not None
                     else np.zeros(n, dtype=np.int16))
    # indel alignment quals only exist at the indel anchor row (the only
    # place compile_plp_col reads them, plp.c:1076-1078,1121-1123)
    iaq_arr = np.full(n, -1, dtype=np.int16)
    daq_arr = np.full(n, -1, dtype=np.int16)
    if ai is not None:
        m = indel > 0
        iaq_arr[m] = ai[qpos_c[m]]
    if ad is not None:
        m = indel < 0
        daq_arr[m] = ad[qpos_c[m]]
    out["iaq"].append(iaq_arr)
    out["daq"].append(daq_arr)
    out["has_ai"].append(np.full(n, ai is not None))
    out["has_ad"].append(np.full(n, ad is not None))
    out["event_id"].append(event_id)
    out["events"].extend(ev_list)


def _expand_simple_batch(reads, conf: PileupConf, out: dict):
    """Vectorized expansion for single-M-op reads (the common case)."""
    n = len(reads)
    L = len(reads[0].seq)
    pos0 = np.array([r.pos for r in reads], dtype=np.int64)
    seqs = np.frombuffer(b"".join(r.seq for r in reads),
                         dtype=np.uint8).reshape(n, L)
    quals = np.stack([np.asarray(r.qual, dtype=np.int16) for r in reads])
    if conf.illumina13:
        quals = np.where(quals > 31, quals - 31, 0).astype(np.int16)
    mqs = np.array([min(r.mapq, conf.max_mq) for r in reads], dtype=np.int16)
    strands = np.array([1 if r.is_reverse else 0 for r in reads],
                       dtype=np.uint8)

    def tag_mat(tag, missing):
        vals = [r.get_tag(tag) for r in reads]
        if all(v is None for v in vals):
            return np.full((n, L), missing, dtype=np.int16)
        m = np.full((n, L), missing, dtype=np.int16)
        for i, v in enumerate(vals):
            if v is not None:
                m[i] = np.frombuffer(v.encode("latin-1"),
                                     dtype=np.uint8).astype(np.int16) - 33
        return m

    baq = tag_mat(D.BAQ_TAG, -1) if conf.use_baq \
        else np.full((n, L), -1, dtype=np.int16)
    bi = tag_mat(D.BI_TAG, 0) if conf.collect_indels else None
    bd = tag_mat(D.BD_TAG, 0) if conf.collect_indels else None
    sqv = np.array(
        [int(r.get_tag(D.SRC_QUAL_TAG)) if r.get_tag(D.SRC_QUAL_TAG)
         is not None else -1 for r in reads], dtype=np.int32)

    total = n * L
    out["pos"].append((pos0[:, None] + np.arange(L)).reshape(total))
    out["nt4"].append(_NT4_TABLE[seqs].reshape(total))
    out["bq"].append(quals.reshape(total))
    out["baq"].append(baq.reshape(total))
    out["mq"].append(np.repeat(mqs, L))
    out["sq"].append(np.repeat(sqv, L))
    out["strand"].append(np.repeat(strands, L))
    z = np.zeros(total, dtype=bool)
    out["is_del"].append(z)
    out["is_refskip"].append(z)
    ht = np.zeros((n, L), dtype=bool)
    ht[:, 0] = True
    out["is_head"].append(ht.reshape(total))
    tl = np.zeros((n, L), dtype=bool)
    tl[:, -1] = True
    out["is_tail"].append(tl.reshape(total))
    out["indel"].append(np.zeros(total, dtype=np.int64))
    out["iq"].append(bi.reshape(total) if bi is not None
                     else np.zeros(total, dtype=np.int16))
    out["dq"].append(bd.reshape(total) if bd is not None
                     else np.zeros(total, dtype=np.int16))
    out["iaq"].append(np.full(total, -1, dtype=np.int16))
    out["daq"].append(np.full(total, -1, dtype=np.int16))
    has_ai = np.array([r.get_tag(D.AI_TAG) is not None for r in reads])
    has_ad = np.array([r.get_tag(D.AD_TAG) is not None for r in reads])
    out["has_ai"].append(np.repeat(has_ai, L))
    out["has_ad"].append(np.repeat(has_ad, L))
    out["event_id"].append(np.full(total, -1, dtype=np.int64))


def rows_from_reads(reads, conf: PileupConf, chrom_name=None) -> ReadRows:
    out = {k: [] for k in (
        "pos", "nt4", "bq", "baq", "mq", "sq", "strand", "is_del",
        "is_refskip", "is_head", "is_tail", "indel", "iq", "dq", "iaq",
        "daq", "has_ai", "has_ad", "event_id",
    )}
    out["events"] = []
    # fast path: group simple single-M reads by length.  Row order must
    # come out in ORIGINAL read order: the reference's per-column qual
    # pools follow htslib's pileup-entry order (= BAM read order), which
    # is observable through the eps-comparator qsort's near-tie handling
    # downstream (plp_to_errprobs) — verified by test_plp_differential.
    simple: dict[int, list] = {}
    complex_reads = []
    for i, r in enumerate(reads):
        cig = r.cigar
        if len(cig) == 1 and (int(cig[0]) & 0xF) == CMATCH and len(r.seq):
            simple.setdefault(len(r.seq), []).append((i, r))
        else:
            complex_reads.append((i, r))
    ridx = []
    for L, group in simple.items():
        _expand_simple_batch([r for _i, r in group], conf, out)
        ridx.append(np.repeat([i for i, _r in group], L))
    for i, r in complex_reads:
        before = sum(a.shape[0] for a in out["pos"])
        expand_read(r, conf, out)
        after = sum(a.shape[0] for a in out["pos"])
        ridx.append(np.full(after - before, i, dtype=np.int64))
    if not out["pos"]:
        return ReadRows.empty()
    kw = {k: np.concatenate(v) for k, v in out.items() if k != "events"}
    order = np.argsort(np.concatenate(ridx), kind="stable")
    if not np.array_equal(order, np.arange(len(order))):
        for k in kw:
            kw[k] = kw[k][order]
    kw["events"] = out["events"]
    return ReadRows(**kw)


# ---------------------------------------------------------------------------
# Column assembly
# ---------------------------------------------------------------------------

@dataclass
class IndelEvent:
    """One distinct ins/del sequence at a column (utils.h:101-135)."""

    key: str
    count: int = 0
    cons_quals: int = 0
    quals: list = field(default_factory=list)
    aln_quals: list = field(default_factory=list)
    map_quals: list = field(default_factory=list)
    source_quals: list = field(default_factory=list)
    fw_rv: list = field(default_factory=lambda: [0, 0])


@dataclass
class ColumnBatch:
    """Dense per-column data for one contiguous region of one chromosome.

    Quality arrays are flat CSR-style: rows sorted by column; ``col_start``
    gives the slice per column.  Only columns with coverage appear.
    """

    target: str
    positions: np.ndarray  # [C] reference positions (ascending)
    ref_nt4: np.ndarray  # [C]
    coverage_plp: np.ndarray  # [C] reads covering (incl. del/refskip rows)
    num_bases: np.ndarray  # [C] bases after min_plp_bq filter
    num_heads: np.ndarray
    num_tails: np.ndarray
    fw_counts: np.ndarray  # [C, 5]
    rv_counts: np.ndarray  # [C, 5]
    cons_nt4: np.ndarray  # [C] argmax of err-weighted base counts
    cons_indel: list  # [C] None or ('+', key) / ('-', key)
    hrun: np.ndarray  # [C]
    # flat base rows (bq >= min_plp_bq, not del/refskip), sorted by column
    col_start: np.ndarray  # [C+1] slice bounds into the flat arrays
    b_nt4: np.ndarray
    b_bq: np.ndarray
    b_baq: np.ndarray
    b_mq: np.ndarray
    b_sq: np.ndarray
    # indel column info
    num_ins: np.ndarray
    num_dels: np.ndarray
    num_non_indels: np.ndarray
    num_ign_indels: np.ndarray
    ins_events: list  # [C] dict key->IndelEvent (insertion-ordered)
    del_events: list
    # per-column non-event indel quals, CSR layout: *_neq_start [C+1] slices
    # into flat (q, mq) arrays for reads without that indel type.  The sq
    # pool is RAGGED vs q/mq: the reference appends source quals to the
    # non-event pools only from opposite-type EVENT rows, never from
    # non-indel rows (plp.c:1106,1160 vs 1173-1189) — and never reads
    # them back (snpcaller.c:582-590 keeps sq=-1 for the non-event part).
    # Kept bit-identical anyway, with its own CSR starts.
    ins_neq_start: np.ndarray
    ins_neq_q: np.ndarray
    ins_neq_mq: np.ndarray
    ins_neq_sq: np.ndarray
    ins_neq_sq_start: np.ndarray
    del_neq_start: np.ndarray
    del_neq_q: np.ndarray
    del_neq_mq: np.ndarray
    del_neq_sq: np.ndarray
    del_neq_sq_start: np.ndarray
    non_ins_fw_rv: np.ndarray  # [C, 2]
    non_del_fw_rv: np.ndarray
    has_indel_aqs: np.ndarray  # [C] bool

    def ins_neq_at(self, c):
        """(quals, map_quals, source_quals) arrays of non-ins reads at col
        c.  NB source_quals is ragged vs the other two (see field note)."""
        lo, hi = self.ins_neq_start[c], self.ins_neq_start[c + 1]
        slo, shi = self.ins_neq_sq_start[c], self.ins_neq_sq_start[c + 1]
        return (self.ins_neq_q[lo:hi], self.ins_neq_mq[lo:hi],
                self.ins_neq_sq[slo:shi])

    def del_neq_at(self, c):
        lo, hi = self.del_neq_start[c], self.del_neq_start[c + 1]
        slo, shi = self.del_neq_sq_start[c], self.del_neq_sq_start[c + 1]
        return (self.del_neq_q[lo:hi], self.del_neq_mq[lo:hi],
                self.del_neq_sq[slo:shi])

    def ins_neq_len(self, c):
        return int(self.ins_neq_start[c + 1] - self.ins_neq_start[c])

    def del_neq_len(self, c):
        return int(self.del_neq_start[c + 1] - self.del_neq_start[c])


def get_hrun_array(ref: bytes) -> np.ndarray:
    """Vectorized homopolymer-run computation (plp.c:753-787).

    hrun[pos] counts the run of identical bases starting at pos+1, extended
    leftwards through pos while matching that same base.
    """
    a = np.frombuffer(ref, dtype=np.uint8)
    L = len(a)
    hrun = np.ones(L, dtype=np.int64)
    if L < 2:
        return hrun
    # run_len_right[i]: length of run of equal chars starting at i
    change = np.nonzero(a[1:] != a[:-1])[0] + 1
    starts = np.concatenate([[0], change])
    lens = np.diff(np.concatenate([starts, [L]]))
    run_right = np.repeat(lens, lens) - (np.arange(L) - np.repeat(starts, lens))
    # right part: run starting at pos+1
    right = np.zeros(L, dtype=np.int64)
    right[:-1] = run_right[1:]
    right[-1] = 0
    c_next = np.zeros(L, dtype=np.uint8)
    c_next[:-1] = a[1:]
    # left extension: count of consecutive chars equal to c_next going left
    # from pos inclusive
    eq = a == c_next
    # left[i] = eq[i] ? left[i-1] + 1 : 0 -- but left chain must compare to
    # the *same* c_next[i]; a run of equal chars ending at i all share value,
    # so when eq[i] the whole backward run of identical a values counts:
    run_left_same = np.arange(L) - np.repeat(starts, lens) + 1
    left = np.where(eq, run_left_same, 0)
    hrun = np.where(right > 0, right + left, 1)
    # when right == 0 (pos at end), hrun = 1 per reference early return
    hrun[-1] = 1
    return hrun


def hrun_at_positions(ref: bytes, positions) -> np.ndarray:
    """get_hrun_array values at selected positions only — O(run length)
    per position instead of O(genome), for the sparse fused-path attach
    (plp.c:753-787 semantics, same as the vectorized version above)."""
    a = ref
    L = len(a)
    out = np.ones(len(positions), dtype=np.int64)
    for k, p in enumerate(positions):
        p = int(p)
        if p + 1 >= L:
            continue
        b = a[p + 1]
        i = p + 1
        while i < L and a[i] == b:
            i += 1
        j = p
        while j >= 0 and a[j] == b:
            j -= 1
        out[k] = i - 1 - j
    return out


def compile_columns(
    rows: ReadRows, conf: PileupConf, ref: bytes, target: str
) -> ColumnBatch:
    """Group rows into columns: the batched compile_plp_col."""
    from ..core.phred import DBL_MIN, phred_to_prob

    if len(rows.pos) == 0:
        return None

    order = np.argsort(rows.pos, kind="stable")
    pos_sorted = rows.pos[order]
    positions, col_first, counts = np.unique(
        pos_sorted, return_index=True, return_counts=True
    )
    C = len(positions)
    refarr = np.frombuffer(ref, dtype=np.uint8)
    ref_nt4_all = _NT4_TABLE[refarr]
    in_ref = positions < len(refarr)
    ref_nt4 = np.where(in_ref, ref_nt4_all[np.minimum(positions, len(refarr) - 1)], 4)

    # row -> column index
    col_of_row = np.repeat(np.arange(C), counts)
    # reorder all fields
    f = {name: getattr(rows, name)[order] for name in (
        "nt4", "bq", "baq", "mq", "sq", "strand", "is_del", "is_refskip",
        "is_head", "is_tail", "indel", "iq", "dq", "iaq", "daq",
        "has_ai", "has_ad", "event_id",
    )}

    coverage = counts.copy()
    if conf.max_depth and np.any(coverage > conf.max_depth):
        # cap depth: drop rows beyond max_depth per column (read order)
        rank = np.arange(len(col_of_row)) - np.repeat(col_first, counts)
        keep = rank < conf.max_depth
        col_of_row = col_of_row[keep]
        for k in f:
            f[k] = f[k][keep]
        positions2, col_first, counts = np.unique(
            col_of_row, return_index=True, return_counts=True
        )
        coverage = counts.copy()

    is_base = ~f["is_del"] & ~f["is_refskip"]
    base_kept = is_base & (f["bq"] >= conf.min_plp_bq)
    # SANGER max clamp (plp.c:949-953)
    f["bq"] = np.minimum(f["bq"], D.SANGER_PHRED_MAX).astype(np.int16)

    num_bases = np.bincount(col_of_row[base_kept], minlength=C)
    num_heads = np.bincount(col_of_row[is_base & f["is_head"]], minlength=C)
    num_tails = np.bincount(col_of_row[is_base & f["is_tail"]], minlength=C)

    fw_counts = np.zeros((C, 5), dtype=np.int64)
    rv_counts = np.zeros((C, 5), dtype=np.int64)
    bk = base_kept
    np.add.at(fw_counts, (col_of_row[bk & (f["strand"] == 0)],
                          f["nt4"][bk & (f["strand"] == 0)]), 1)
    np.add.at(rv_counts, (col_of_row[bk & (f["strand"] == 1)],
                          f["nt4"][bk & (f["strand"] == 1)]), 1)

    # consensus base: sum of (1 - p_err) per nt, DBL_MIN floor per increment
    incr = 1.0 - phred_to_prob(np.maximum(f["bq"], 0))
    incr = np.where(incr == 0.0, DBL_MIN, incr)
    base_counts = np.zeros((C, 5), dtype=np.float64)
    np.add.at(base_counts, (col_of_row[bk], f["nt4"][bk]), incr[bk])
    cons_nt4 = np.argmax(base_counts, axis=1).astype(np.uint8)

    # flat kept-base arrays sorted by column
    sel = np.nonzero(base_kept)[0]
    col_sel = col_of_row[sel]
    col_start = np.zeros(C + 1, dtype=np.int64)
    np.add.at(col_start, col_sel + 1, 1)
    col_start = np.cumsum(col_start)

    hrun_all = get_hrun_array(ref)
    hrun = np.where(in_ref, hrun_all[np.minimum(positions, len(refarr) - 1)], 1)

    batch = ColumnBatch(
        target=target,
        positions=positions,
        ref_nt4=ref_nt4,
        coverage_plp=coverage,
        num_bases=num_bases,
        num_heads=num_heads,
        num_tails=num_tails,
        fw_counts=fw_counts,
        rv_counts=rv_counts,
        cons_nt4=cons_nt4,
        cons_indel=[None] * C,
        hrun=hrun,
        col_start=col_start,
        b_nt4=f["nt4"][sel],
        b_bq=f["bq"][sel],
        b_baq=f["baq"][sel],
        b_mq=f["mq"][sel],
        b_sq=f["sq"][sel],
        num_ins=np.zeros(C, dtype=np.int64),
        num_dels=np.zeros(C, dtype=np.int64),
        num_non_indels=np.zeros(C, dtype=np.int64),
        num_ign_indels=np.zeros(C, dtype=np.int64),
        ins_events=[None] * C,
        del_events=[None] * C,
        ins_neq_start=np.zeros(C + 1, dtype=np.int64),
        ins_neq_q=np.zeros(0, dtype=np.int64),
        ins_neq_mq=np.zeros(0, dtype=np.int64),
        ins_neq_sq=np.zeros(0, dtype=np.int64),
        ins_neq_sq_start=np.zeros(C + 1, dtype=np.int64),
        del_neq_start=np.zeros(C + 1, dtype=np.int64),
        del_neq_q=np.zeros(0, dtype=np.int64),
        del_neq_mq=np.zeros(0, dtype=np.int64),
        del_neq_sq=np.zeros(0, dtype=np.int64),
        del_neq_sq_start=np.zeros(C + 1, dtype=np.int64),
        non_ins_fw_rv=np.zeros((C, 2), dtype=np.int64),
        non_del_fw_rv=np.zeros((C, 2), dtype=np.int64),
        has_indel_aqs=np.zeros(C, dtype=bool),
    )

    if conf.collect_indels:
        _collect_indels(batch, rows, f, col_of_row, conf, ref)

    return batch


def _collect_indels(batch, rows, f, col_of_row, conf, ref,
                    counts_done=False):
    """Per-column indel bookkeeping (plp.c:1017-1272).

    counts_done: the scalar per-column counters (num_ins/num_dels/
    num_non_indels/num_ign_indels) were already filled by the fused native
    builder; only the event maps, non-event CSR pools, fw/rv splits and
    consensus-indel decisions are (re)built here."""
    C = len(batch.positions)
    idq_ok = (f["iq"] >= conf.min_plp_idq) & (f["dq"] >= conf.min_plp_idq)
    if not counts_done:
        # refskip rows count as ignorable indel events too: htslib sets
        # is_del=1 for N ops, and the reference's gate tests p->is_del
        # (plp.c:1062-1066) — verified by test_plp_differential
        has_indel_evt = (f["indel"] != 0) | f["is_del"] | f["is_refskip"]
        ign = ~idq_ok & has_indel_evt
        np.add.at(batch.num_ign_indels, col_of_row[ign], 1)

    process = idq_ok
    is_ins_row = process & (f["indel"] > 0)
    is_del_row = process & (f["indel"] < 0)
    # NB: deletion-span / refskip rows with indel==0 DO land in the
    # "neither" branch in the reference (plp.c:1170-1191 sits outside the
    # !is_del guard), contributing non-indel quals at deleted positions.
    is_none_row = process & (f["indel"] == 0)

    if not counts_done:
        np.add.at(batch.num_ins, col_of_row[is_ins_row], 1)
        np.add.at(batch.num_dels, col_of_row[is_del_row], 1)
        np.add.at(batch.num_non_indels, col_of_row[is_none_row], 1)

    # non-event contributions: reads with an *insertion* contribute their dq
    # to the non-del pool and vice versa; non-indel reads contribute both.
    ndel_src = is_ins_row | is_none_row  # contribute del_quals (non-del)
    nins_src = is_del_row | is_none_row  # contribute ins_quals (non-ins)
    np.add.at(batch.non_del_fw_rv,
              (col_of_row[ndel_src], f["strand"][ndel_src].astype(np.int64)), 1)
    np.add.at(batch.non_ins_fw_rv,
              (col_of_row[nins_src], f["strand"][nins_src].astype(np.int64)), 1)

    # CSR pack of the non-event pools (sorted stably by column).  The sq
    # side pool only collects from opposite-type EVENT rows — the
    # reference never appends sq for non-indel rows (plp.c:1106,1160 vs
    # 1173-1189) and never reads the pool back; kept bit-identical.
    def pack(src_mask, qkey, sq_mask):
        idx = np.nonzero(src_mask)[0]
        order = np.argsort(col_of_row[idx], kind="stable")
        idx = idx[order]
        cols = col_of_row[idx]
        start = np.zeros(C + 1, dtype=np.int64)
        np.add.at(start, cols + 1, 1)
        start = np.cumsum(start)
        sidx = np.nonzero(sq_mask)[0]
        sidx = sidx[np.argsort(col_of_row[sidx], kind="stable")]
        sstart = np.zeros(C + 1, dtype=np.int64)
        np.add.at(sstart, col_of_row[sidx] + 1, 1)
        sstart = np.cumsum(sstart)
        return (start, f[qkey][idx].astype(np.int64),
                f["mq"][idx].astype(np.int64),
                f["sq"][sidx].astype(np.int64), sstart)

    (batch.del_neq_start, batch.del_neq_q, batch.del_neq_mq,
     batch.del_neq_sq, batch.del_neq_sq_start) = pack(
        ndel_src, "dq", is_ins_row)
    (batch.ins_neq_start, batch.ins_neq_q, batch.ins_neq_mq,
     batch.ins_neq_sq, batch.ins_neq_sq_start) = pack(
        nins_src, "iq", is_del_row)

    ev_cols = np.unique(col_of_row[is_ins_row | is_del_row]) \
        if np.any(is_ins_row | is_del_row) else np.zeros(0, dtype=np.int64)
    for c in ev_cols:
        batch.ins_events[c] = {}
        batch.del_events[c] = {}

    refbytes = ref

    def add_event(evmap, key, q, aq, mq, sq, strand):
        ev = evmap.get(key)
        if ev is None:
            ev = IndelEvent(key=key)
            evmap[key] = ev
        ev.count += 1
        ev.cons_quals += int(q)
        ev.quals.append(int(q))
        ev.aln_quals.append(int(aq))
        ev.map_quals.append(int(mq))
        ev.source_quals.append(int(sq))
        ev.fw_rv[strand] += 1

    for i in np.nonzero(is_ins_row | is_del_row)[0]:
        c = col_of_row[i]
        ev_id = f["event_id"][i]
        seq, is_ins = rows.events[ev_id] if ev_id >= 0 else (None, None)
        if is_ins:
            iaq = int(f["iaq"][i])
            if f["has_ai"][i]:
                batch.has_indel_aqs[c] = True
            else:
                iaq = -1
            add_event(batch.ins_events[c], seq, f["iq"][i], iaq,
                      f["mq"][i], f["sq"][i], int(f["strand"][i]))
        else:
            l = -int(f["indel"][i])
            p0 = int(batch.positions[c])
            seq_b = refbytes[p0 + 1 : p0 + 1 + l].decode()
            seq_b = seq_b + "N" * (l - len(seq_b))
            daq = int(f["daq"][i])
            if f["has_ad"][i]:
                batch.has_indel_aqs[c] = True
            else:
                daq = -1
            add_event(batch.del_events[c], seq_b.upper(), f["dq"][i], daq,
                      f["mq"][i], f["sq"][i], int(f["strand"][i]))

    # consensus indel decision (plp.c:1231-1272); only event columns can
    # flip to an indel consensus (sums are >= 0)
    ins_ne_cum = np.concatenate([[0], np.cumsum(batch.ins_neq_q)])
    del_ne_cum = np.concatenate([[0], np.cumsum(batch.del_neq_q)])
    for c in ev_cols:
        ins_ne_sum = int(ins_ne_cum[batch.ins_neq_start[c + 1]]
                         - ins_ne_cum[batch.ins_neq_start[c]])
        del_ne_sum = int(del_ne_cum[batch.del_neq_start[c + 1]]
                         - del_ne_cum[batch.del_neq_start[c]])
        best_ins = max(batch.ins_events[c].values(),
                       key=lambda e: e.cons_quals, default=None) \
            if batch.ins_events[c] else None
        best_del = max(batch.del_events[c].values(),
                       key=lambda e: e.cons_quals, default=None) \
            if batch.del_events[c] else None
        ins_q = best_ins.cons_quals if best_ins else 0
        del_q = best_del.cons_quals if best_del else 0
        if ins_q > ins_ne_sum:
            batch.cons_indel[c] = ("+", best_ins.key)
        elif del_q > del_ne_sum:
            batch.cons_indel[c] = ("-", best_del.key)
