"""Quality-bias checks on called SNVs (lofreq2_bias.py equivalent).

For each SNV, splits the mapping and base qualities of reads covering
the site into ref-supporting vs alt-supporting groups and runs a
one-sided Mann-Whitney U test per quality type (only when the alt group
mean is lower — reference lofreq2_bias.py:268-284).  The two p-values
are Fisher-combined (chi2 df=4, lofreq_star/utils.py:63-81) and the
three phred-scaled results are written as MB (mapping bias), BB (base
bias) and CB (combined bias) INFO tags.  An MTC pass over the chosen
tag appends a ``<mtc><<alpha>`` FILTER to rejected variants.
"""

from __future__ import annotations

import math
import sys

import numpy as np
from scipy.stats import chi2, mannwhitneyu

from ..core.multtest import bonf_corr, fdr
from ..io.bam import BamReader
from ..io.vcf import VcfReader, VcfWriter
from ..core.phred import INT_MAX

DEFAULT_MTC = "fdr"
DEFAULT_MTC_ALPHA = 0.001
DEFAULT_TAG = "BB"


def _round_phred(p: float) -> int:
    """lofreq_star's prob_to_phredqual: int(round(-10*log10)) with
    INT_MAX at p=0 (utils.py:119-135) — note round, not the C caller's
    truncation."""
    if p <= 0.0:
        return INT_MAX
    return int(round(-10.0 * math.log10(p)))


def fisher_comb(pv1: float, pv2: float) -> float:
    """Fisher's method for two p-values (lofreq_star/utils.py:63-81)."""
    if pv1 == 0 or pv2 == 0:
        return 0.0
    stat = -2.0 * (math.log(pv1) + math.log(pv2))
    return 1.0 - chi2.cdf(stat, 4)


def _one_sided_u(ref_quals, alt_quals) -> float:
    """p-value that alt quals are stochastically lower than ref quals;
    1.0 when degenerate or when the alt mean isn't lower
    (lofreq2_bias.py:261-284).  The reference ran under scipy<0.17
    where mannwhitneyu returned the one-sided asymptotic p in the
    direction the data leans; alternative='greater' reproduces that
    given the mean guard."""
    if len(set(ref_quals) | set(alt_quals)) == 1:
        return 1.0
    if not ref_quals or not alt_quals:
        return 1.0
    if (sum(alt_quals) / len(alt_quals)) >= (sum(ref_quals) / len(ref_quals)):
        return 1.0
    return float(mannwhitneyu(ref_quals, alt_quals, alternative="greater",
                              use_continuity=True,
                              method="asymptotic").pvalue)


def _query_pos_at(read, ref_pos: int):
    """Query index aligned to ref_pos, or None when the position falls
    in a deletion/refskip (pysam aligned_pairs semantics)."""
    x = read.pos
    y = 0
    for op, l in read.cigar_ops():
        if op in (0, 7, 8):
            if x <= ref_pos < x + l:
                return y + (ref_pos - x)
            x += l
            y += l
        elif op == 1:
            y += l
        elif op in (2, 3):
            if x <= ref_pos < x + l:
                return None
            x += l
        elif op == 4:
            y += l
    return None


def _site_quals(bam: BamReader, var, min_mq: int, min_bq: int,
                use_orphan: bool):
    """(ref_mquals, alt_mquals, ref_bquals, alt_bquals) at the SNV site
    (lofreq2_bias.py:197-256)."""
    ref_m, alt_m, ref_b, alt_b = [], [], [], []
    ref_base = ord(var.ref[0].upper())
    alt_base = ord(var.alt[0].upper())
    if var.chrom not in bam.header._name2tid:
        sys.stderr.write("FATAL: chromosome %s (from vcf) not found in BAM"
                         " header\n" % var.chrom)
        raise SystemExit(1)
    for r in bam.fetch(var.chrom, var.pos, var.pos + 1):
        if r.flag & (0x4 | 0x100 | 0x200 | 0x400):
            continue
        if (r.flag & 0x1) and not (r.flag & 0x2) and not use_orphan:
            continue
        if r.mapq < min_mq:
            continue
        q = _query_pos_at(r, var.pos)
        if q is None:
            continue
        bq = int(r.qual[q])
        if bq < min_bq:
            continue
        b = r.seq[q]
        if b == ref_base:
            ref_m.append(r.mapq)
            ref_b.append(bq)
        elif b == alt_base:
            alt_m.append(r.mapq)
            alt_b.append(bq)
    return ref_m, alt_m, ref_b, alt_b


def run_bias(bam_path, vcf_in, vcf_out="-", mtc=DEFAULT_MTC,
             mtc_alpha=DEFAULT_MTC_ALPHA, mtc_tag=DEFAULT_TAG,
             min_mq=-1, min_bq=6, use_orphan=False, pass_only=False):
    """Annotate SNVs with MB/BB/CB bias tags and MTC-filter on one."""
    import os

    if vcf_out not in ("-", None) and os.path.exists(vcf_out):
        # lofreq2_bias.py:175-177 refuses to overwrite existing output
        sys.stderr.write("FATAL: Cowardly refusing to overwrite already"
                         " existing file %s\n" % vcf_out)
        raise SystemExit(1)
    bam = BamReader(bam_path)
    with VcfReader(vcf_in) as rdr:
        header = rdr.header
        variants = list(rdr)

    annotated = []  # indices that got tags (indels are skipped)
    pvalues = []
    for i, var in enumerate(variants):
        if var.is_indel() or not var.alt or len(var.ref) != 1 \
                or len(var.alt) != 1:
            sys.stderr.write(
                "WARNING: Skipping unsupported indel variant %s:%d\n"
                % (var.chrom, var.pos + 1))
            continue
        ref_m, alt_m, ref_b, alt_b = _site_quals(
            bam, var, min_mq, min_bq, use_orphan)
        m_pv = _one_sided_u(ref_m, alt_m)
        b_pv = _one_sided_u(ref_b, alt_b)
        c_pv = fisher_comb(m_pv, b_pv)
        tags = {"MB": _round_phred(m_pv), "BB": _round_phred(b_pv),
                "CB": _round_phred(c_pv)}
        var.add_info("MB=%d;BB=%d;CB=%d"
                     % (tags["MB"], tags["BB"], tags["CB"]))
        if mtc and mtc.lower() != "none":
            annotated.append(i)
            pvalues.append(10.0 ** (-tags[mtc_tag] / 10.0))
    bam.close()

    if mtc and mtc.lower() != "none" and pvalues:
        ftag = "%s<%f" % (mtc, mtc_alpha)
        if mtc in ("bonf", "holmbonf"):
            # the reference's holmbonf branch also applies plain
            # Bonferroni (lofreq2_bias.py:318-321) — reproduced as-is
            corr = bonf_corr(np.asarray(pvalues), len(pvalues))
            rej = [j for j, p in enumerate(corr) if p < mtc_alpha]
        elif mtc == "fdr":
            rej = [int(j) for j in fdr(np.asarray(pvalues), mtc_alpha, -1)]
        else:
            raise ValueError("unknown MTC method %s" % mtc)
        for j in rej:
            variants[annotated[j]].add_filter(ftag)

    out = VcfWriter(vcf_out, header)
    n_filtered = 0
    for var in variants:
        filtered = not var.passes()
        if filtered:
            n_filtered += 1
            if pass_only:
                continue
        out.write(var)
    out.close()
    return n_filtered
