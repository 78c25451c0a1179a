"""VCF utility tools.

Equivalents of the reference's lofreq2_indel_ovlp.py,
lofreq2_add_fake_gt.py, lofreq2_add_sample.py and lofreq2_cluster.py.
"""

from __future__ import annotations

import sys

from ..core.phred import INT_MAX
from ..io.vcf import Var, VcfReader, VcfWriter, add_header_line

GT_FORMAT_HEADER = ('##FORMAT=<ID=GT,Number=1,Type=String,'
                    'Description="Genotype">\n')


def _var_span(v: Var):
    n = max(len(v.ref or ""), len(v.alt or ""))
    return set(range(v.pos, v.pos + n))


def _qual_key(v: Var) -> float:
    # missing quals are bare MAX_INT — the reference adds the AF
    # tiebreak only for numeric quals (lofreq2_indel_ovlp.py:47-53), so
    # '.'-qual ties resolve by input order, not AF; verified by
    # test_tools_differential
    if v.qual == -1:
        return float(INT_MAX)
    found, af = v.info_value("AF")
    return v.qual + (float(af) if found and af else 0.0)


def indel_ovlp(vcf_in, vcf_out="-"):
    """Resolve runs of overlapping variants by keeping the highest
    qual(+AF) one (lofreq2_indel_ovlp.py semantics)."""
    out = None
    prev: list[Var] = []
    n = 0
    with VcfReader(vcf_in) as rdr:
        out = VcfWriter(vcf_out, rdr.header)
        for v in rdr:
            if prev and (v.chrom != prev[-1].chrom
                         or not (_var_span(prev[-1]) & _var_span(v))):
                best = max(prev, key=_qual_key)
                out.write(best)
                n += 1
                prev = []
            prev.append(v)
        if prev:
            out.write(max(prev, key=_qual_key))
            n += 1
    out.close()
    return n


def add_fake_gt(vcf_in, vcf_out, sample_names):
    """Append FORMAT=GT + './.' sample columns (lofreq2_add_fake_gt.py)."""
    assert len(set(sample_names)) == len(sample_names)
    with VcfReader(vcf_in) as rdr:
        header = rdr.header
        if GT_FORMAT_HEADER not in header:
            header = add_header_line(header, GT_FORMAT_HEADER)
        # extend the #CHROM line
        lines = header.splitlines(keepends=True)
        for i, line in enumerate(lines):
            if line.startswith("#CHROM"):
                cols = line.rstrip("\n").split("\t")
                if "FORMAT" not in cols:
                    cols.append("FORMAT")
                cols.extend(sample_names)
                lines[i] = "\t".join(cols) + "\n"
        header = "".join(lines)
        out = VcfWriter(vcf_out, header)
        for v in rdr:
            v.format = "GT"
            v.samples = ["./."] * len(sample_names)
            out.write(v)
        out.close()


def add_sample(vcf_in, vcf_out, sample_names):
    """Alias flow of lofreq2_add_sample.py: unknown-genotype samples."""
    return add_fake_gt(vcf_in, vcf_out, sample_names)


def cluster_vars(vcf_in, out_fh=None, use_df=True):
    """Cluster variants whose AF confidence intervals overlap
    (lofreq2_cluster.py flavor: adjacent vars whose binomial CIs on AF
    overlap are reported as one cluster)."""
    import math

    out_fh = out_fh or sys.stdout
    with VcfReader(vcf_in) as rdr:
        vars_ = list(rdr)

    def ci(v):
        found, af_s = v.info_value("AF")
        found_dp, dp_s = v.info_value("DP")
        af = float(af_s) if found and af_s else 0.0
        dp = int(dp_s) if found_dp and dp_s else 0
        if dp == 0:
            return af, af
        se = math.sqrt(max(af * (1 - af), 1e-12) / dp)
        return max(af - 1.96 * se, 0.0), min(af + 1.96 * se, 1.0)

    clusters = []
    cur = []
    cur_lo = cur_hi = None
    for v in vars_:
        lo, hi = ci(v)
        if cur and not (lo <= cur_hi and hi >= cur_lo):
            clusters.append(cur)
            cur = []
            cur_lo = cur_hi = None
        cur.append(v)
        cur_lo = lo if cur_lo is None else min(cur_lo, lo)
        cur_hi = hi if cur_hi is None else max(cur_hi, hi)
    if cur:
        clusters.append(cur)
    for i, cl in enumerate(clusters):
        for v in cl:
            out_fh.write(f"cluster{i + 1}\t{v.chrom}\t{v.pos + 1}\t"
                         f"{v.ref}>{v.alt}\n")
    return clusters
