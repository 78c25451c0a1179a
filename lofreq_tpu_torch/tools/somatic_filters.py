"""Somatic post-filters and false-negative diagnostics.

Equivalents of the reference's mutect_alt_allele_in_normal.py and
lofreq2_analyze_somatic_fn.py helper scripts.
"""

from __future__ import annotations

import sys

from ..io.bam import BamReader
from ..io.vcf import VcfReader, VcfWriter, add_header_line
from ..pileup.engine import PileupConf, read_passes_filters


def _pileup_counts(bam: BamReader, chrom: str, pos: int, alt: str,
                   pconf: PileupConf):
    """(coverage, alt_count, alt_qual_sum) at one position."""
    cov = 0
    alt_n = 0
    alt_q = 0
    alt_b = ord(alt[0])
    for r in bam.fetch(chrom, pos, pos + 1):
        if not read_passes_filters(r, pconf, chrom):
            continue
        i = pos - r.pos
        if len(r.cigar) == 1 and 0 <= i < len(r.seq):
            cov += 1
            if r.seq[i] == alt_b:
                alt_n += 1
                alt_q += int(r.qual[i])
        elif 0 <= i:
            # walk cigar for non-simple reads
            x = r.pos
            y = 0
            for op, l in r.cigar_ops():
                if op in (0, 7, 8):
                    if x <= pos < x + l:
                        q = y + (pos - x)
                        cov += 1
                        if r.seq[q] == alt_b:
                            alt_n += 1
                            alt_q += int(r.qual[q])
                        break
                    x += l
                    y += l
                elif op == 1:
                    y += l
                elif op in (2, 3):
                    if x <= pos < x + l:
                        break
                    x += l
                elif op == 4:
                    y += l
    return cov, alt_n, alt_q


def alt_allele_in_normal(vcf_in, normal_bam, out_path="-",
                         min_alt_count=2, min_alt_frac=0.03,
                         min_qual_sum=20, print_filtered=False):
    """MuTect's observed-in-control filter (Cibulskis 2013): reject a
    candidate when the control shows >= 2 alt observations or >= 3% alt
    fraction AND their summed base quality > 20."""
    bam = BamReader(normal_bam)
    chrom_of = {n: n for n, _l in bam.header.references}
    pconf = PileupConf(use_baq=False, use_idaq=False)
    n_filtered = 0
    with VcfReader(vcf_in) as rdr:
        header = add_header_line(
            rdr.header,
            '##FILTER=<ID=alt_allele_in_normal,Description='
            '"Alternate allele observed in control sample">\n')
        out = VcfWriter(out_path, header)
        for v in rdr:
            if v.chrom in chrom_of and v.alt and len(v.alt) == 1 \
                    and len(v.ref) == 1:
                cov, alt_n, alt_q = _pileup_counts(bam, v.chrom, v.pos,
                                                   v.alt, pconf)
                frac = alt_n / cov if cov else 0.0
                if ((alt_n >= min_alt_count or frac >= min_alt_frac)
                        and alt_q > min_qual_sum):
                    n_filtered += 1
                    if not print_filtered:
                        continue
                    v.add_filter("alt_allele_in_normal")
            out.write(v)
        out.close()
    bam.close()
    return n_filtered


def analyze_somatic_fn(truth_vcf, called_vcf, tumor_bam, normal_bam,
                       ref_path=None, stream=None):
    """Explain false negatives: for each truth variant missing from the
    calls, report tumor/normal coverage and alt support at the site
    (lofreq2_analyze_somatic_fn.py flavor)."""
    stream = stream or sys.stdout
    _, called = (None, list(VcfReader(called_vcf)))
    called_keys = {(v.chrom, v.pos, v.ref, v.alt) for v in called}
    tb = BamReader(tumor_bam)
    nb = BamReader(normal_bam)
    pconf = PileupConf(use_baq=False, use_idaq=False)
    n_fn = 0
    with VcfReader(truth_vcf) as rdr:
        for v in rdr:
            key = (v.chrom, v.pos, v.ref, v.alt)
            if key in called_keys:
                continue
            n_fn += 1
            t_cov, t_alt, _ = _pileup_counts(tb, v.chrom, v.pos,
                                             v.alt or "N", pconf)
            n_cov, n_alt, _ = _pileup_counts(nb, v.chrom, v.pos,
                                             v.alt or "N", pconf)
            reason = "no-coverage" if t_cov == 0 else (
                "no-alt-reads" if t_alt == 0 else (
                    "present-in-normal" if n_alt >= 2 else
                    "insufficient-evidence"))
            stream.write(
                f"FN\t{v.chrom}\t{v.pos + 1}\t{v.ref}>{v.alt}\t"
                f"tumor:{t_alt}/{t_cov}\tnormal:{n_alt}/{n_cov}\t{reason}\n")
    tb.close()
    nb.close()
    return n_fn
