"""BAQ / IDAQ computation entry point.

Equivalent of bam_prob_realn_core_ext (bam_md_ext.c:260): per read, run the
banded glocal forward/backward HMM and attach
  * 'lb' tag: per-base BAQ (extended smoothing by default), phred+33
  * 'ai'/'ad' tags: indel alignment qualities from posterior sums over
    equivalent (repeat-shifted) indel placements.

The batched HMM itself lives in ops.baq_hmm (numpy exact) / ops.baq_pallas
(TPU).  This module handles tag bookkeeping and the skip-if-present logic.
"""

from __future__ import annotations


from .. import defaults as D

_warned = [False]


def add_alnqual_tags(reads, ref: bytes, baq=True, ext_baq=True, idaq=True,
                     redo_baq=False, redo_idaq=False):
    """Compute/attach lb (BAQ) and ai/ad (IDAQ) tags for a batch of reads.

    Skip logic follows bam_md_ext.c:296-366: existing tags are reused unless
    redo; a read is skipped when BAQ exists (or is off) and every indel type
    present has its aln-qual tag.
    """
    from .baq_hmm import realn_batch

    todo = []
    for r in reads:
        if r.is_unmapped or r.l_qseq == 0:
            continue
        if redo_baq and r.get_tag(D.BAQ_TAG) is not None:
            r.del_tag(D.BAQ_TAG)
        if redo_idaq:
            if r.get_tag(D.AI_TAG) is not None:
                r.del_tag(D.AI_TAG)
            if r.get_tag(D.AD_TAG) is not None:
                r.del_tag(D.AD_TAG)
        has_ins = any(op == 1 for op, _l in r.cigar_ops())
        has_del = any(op == 2 for op, _l in r.cigar_ops())
        prec_baq = r.get_tag(D.BAQ_TAG) is not None
        prec_ai = r.get_tag(D.AI_TAG) is not None
        prec_ad = r.get_tag(D.AD_TAG) is not None
        if (not baq) or prec_baq:
            skip = True
            if idaq and has_del and not prec_ad:
                skip = False
            if idaq and has_ins and not prec_ai:
                skip = False
            if skip:
                continue
        todo.append((r, has_ins or has_del))
    if not todo:
        return
    realn_batch([t[0] for t in todo], ref, baq=baq, ext_baq=ext_baq,
                idaq=idaq)
