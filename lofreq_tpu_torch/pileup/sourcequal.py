"""Per-read source quality: P(read not from this genome | mapping).

Equivalent of source_qual + count_cigar_ops (plp.c:427-593,
samutils.c:437-614): count match/mismatch/ins/del cigar ops with their
qualities (indels get INDEL_QUAL_DEFAULT), optionally ignore known variant
positions, run the Poisson-binomial with K = #non-matches - 1 at bonf=1,
sig=0.05 (early exit reproduced faithfully) and phred the complement.
"""

from __future__ import annotations

import numpy as np

from .. import defaults as D
from ..core.phred import LDBL_MIN, phred_to_prob, prob_to_phred
from ..core.poissbin import source_qual_batch
from ..io.bam import CDEL, CDIFF, CEQUAL, CHARD_CLIP, CINS, CMATCH, CREF_SKIP, CSOFT_CLIP

_SQ_ALL_MATCH = None


def _sq_all_match() -> int:
    """PROB_TO_PHREDQUAL(LDBL_MIN): the sq for reads with <=1 non-match."""
    global _SQ_ALL_MATCH
    if _SQ_ALL_MATCH is None:
        _SQ_ALL_MATCH = prob_to_phred(LDBL_MIN)
    return _SQ_ALL_MATCH


def count_cigar_ops(read, ref: bytes, min_bq: int, ign_pos=None,
                    count_eq: bool = False):
    """Returns (err_quals list, num_non_matches) for one read.

    err_quals are phred ints per counted op, grouped by op category
    (MATCH, MISMATCH, INS, DEL — the reference emits err_probs per
    category, plp.c:486-508, before its eps-comparator qsort); indels use
    INDEL_QUAL_DEFAULT.  ign_pos: set of 0-based reference positions to
    ignore (mismatches and indel anchors), from the -S ign-vcf list.

    count_eq: the reference's count_cigar_ops handles only CMATCH/CDIFF
    (samutils.c:481,489); a '='(CEQUAL) op lands in the warn-only branch
    and contributes nothing (then desyncs qpos until assert-abort).
    Default False = parity: '=' bases add no evidence (positions still
    advance — reproducing the desync would corrupt every later op).
    True = opt-in fix: count '=' bases as matches.
    """
    cat_quals = ([], [], [], [])  # MATCH, MISMATCH, INS, DEL
    nonmatch = 0
    tpos = read.pos
    qpos = 0
    seq = np.frombuffer(read.seq, dtype=np.uint8)
    qual = read.qual
    refarr = np.frombuffer(ref, dtype=np.uint8)
    for op, l in read.cigar_ops():
        if op == CEQUAL and not count_eq:
            tpos += l
            qpos += l
        elif op in (CMATCH, CDIFF, CEQUAL):
            r = refarr[tpos : tpos + l]
            q = seq[qpos : qpos + l]
            bq = qual[qpos : qpos + l]
            # uppercase-insensitive compare (ref is uppercased upstream)
            mism = (r != q) | (op == CDIFF)
            ok = bq >= min_bq
            if ign_pos:
                pos_arr = np.arange(tpos, tpos + l)
                ign = np.array([p in ign_pos for p in pos_arr])
                drop_mism = mism & ign
                use = ok & ~(drop_mism)
            else:
                use = ok
            for j in np.nonzero(use)[0]:
                if mism[j]:
                    cat_quals[1].append(int(bq[j]))
                    nonmatch += 1
                else:
                    cat_quals[0].append(int(bq[j]))
            tpos += l
            qpos += l
        elif op == CINS or op == CDEL:
            anchor = tpos - 1 if op == CINS else tpos
            ignored = bool(ign_pos) and anchor in ign_pos
            if not ignored:
                cat_quals[2 if op == CINS else 3].append(
                    D.INDEL_QUAL_DEFAULT)
                nonmatch += 1
            if op == CINS:
                qpos += l
            elif not ignored:
                # reference quirk: an ign-listed DELETION 'continue's
                # without advancing tpos (samutils.c:546-556), so every
                # later ref comparison in the read is shifted left by
                # the deletion length — reproduced for bit-identity
                # (verified by test_source_qual_differential)
                tpos += l
        elif op == CREF_SKIP:
            tpos += l
        elif op == CSOFT_CLIP:
            qpos += l
        elif op == CHARD_CLIP:
            pass
    return [q for cat in cat_quals for q in cat], nonmatch


def compute_source_quals(reads, ref: bytes, def_nm_q: int,
                         min_bq: int = D.DEFAULT_MIN_BQ, ign_pos=None,
                         count_eq: bool = False):
    """Attach the 'sq' tag to each read (batched DP across reads)."""
    pend_idx = []
    pend_probs = []
    pend_k = []
    results = np.zeros(len(reads), dtype=np.int64)
    for i, r in enumerate(reads):
        quals, nonmatch = count_cigar_ops(r, ref, min_bq, ign_pos,
                                          count_eq=count_eq)
        if len(quals) < 1:
            results[i] = 0  # -1 -> stored as 0 (plp.c:733-735)
            continue
        if def_nm_q >= 0:
            probs = phred_to_prob(np.full(len(quals), def_nm_q))
        else:
            probs = phred_to_prob(np.array(quals))
        if nonmatch > 0:
            nonmatch -= 1
        if nonmatch == 0:
            results[i] = _sq_all_match()
            continue
        pend_idx.append(i)
        # reference eps-comparator qsort over category-grouped probs
        # (plp.c:553) — NOT np.sort: near-tie order is observable
        from .. import native

        pend_probs.append(native.sort_errprobs(probs))
        pend_k.append(nonmatch)
    if pend_idx:
        Dmax = max(len(p) for p in pend_probs)
        mat = np.full((len(pend_idx), Dmax), 2.0)
        depths = np.zeros(len(pend_idx), dtype=np.int64)
        for j, p in enumerate(pend_probs):
            mat[j, : len(p)] = p
            depths[j] = len(p)
        sq = source_qual_batch(mat, depths, np.array(pend_k))
        sq = np.where(sq < 0, 0, sq)
        results[np.array(pend_idx)] = sq
    for r, s in zip(reads, results):
        r.set_tag(D.SRC_QUAL_TAG, "i", int(s))
    return results
