"""`uniq`: test whether variants called in sample A could have been missed
in sample B's BAM (lofreq_uniq.c).

Per variant: a single-position pileup of the other BAM, then either a
one-sided binomial test of alt-count/coverage vs the variant AF (UQ phred
added to INFO, MTC filter applied at the end) or the detection-limit mode
re-running the Poisson-binomial with pretended af*N alt counts (UNIQ flag).
"""

from __future__ import annotations

import numpy as np

from .. import defaults as D
from ..call.caller import VarcallConf
from ..core import multtest as MT
from ..core.binom import binom_cdf_sf
from ..core.phred import phred_to_prob_scalar, prob_to_phred_safe
from ..core.poissbin import snpcaller_batch
from ..io.bam import BamReader
from ..io.vcf import VcfReader, VcfWriter, add_header_line
from ..pileup.engine import PileupConf, compile_columns, read_passes_filters, rows_from_reads
from .call_pipeline import parse_region  # noqa: F401  (CLI convenience)


class _NRef:
    """Fasta stand-in when uniq runs without a reference (the
    reference binary never takes one): fetch() returns all-'N' of the
    chromosome's BAM-header length, giving ref_base 'N' everywhere
    like the reference's NULL-ref mpileup (plp.c:818)."""

    def __init__(self, bam):
        self._lens = dict(bam.header.references)

    def fetch(self, chrom):
        return b"N" * self._lens[chrom]


def _uq_from_var(var) -> int:
    found, uq = var.info_value("UQ")
    if not found or uq is None:
        return 0
    return int(uq)


def _single_pos_column(bam: BamReader, fa, chrom, pos, pconf: PileupConf):
    reads = []
    for r in bam.fetch(chrom, pos, pos + 1):
        if not read_passes_filters(r, pconf, chrom):
            continue
        if r.mapq > pconf.max_mq:
            r.mapq = pconf.max_mq
        reads.append(r)
    if not reads:
        return None
    rows = rows_from_reads(reads, pconf)
    keep = rows.pos == pos
    if not np.any(keep):
        return None
    for name in ("pos", "nt4", "bq", "baq", "mq", "sq", "strand", "is_del",
                 "is_refskip", "is_head", "is_tail", "indel", "iq", "dq",
                 "iaq", "daq", "has_ai", "has_ad", "event_id"):
        setattr(rows, name, getattr(rows, name)[keep])
    ref = fa.fetch(chrom)
    return compile_columns(rows, pconf, ref, chrom)


def uniq_test_var(col_batch, var, uni_freq: float,
                  use_det_lim: bool) -> None:
    """The per-variant uniq test (uniq_snv, lofreq_uniq.c:222-397):
    annotates `var` in place with UNIQ (detection-limit mode) or
    UQ=<phred> (binomial mode).  Differentially tested against the
    reference's own uniq_snv in test_uniq_differential.py."""
    c = 0
    is_indel = var.is_indel()
    coverage = int(col_batch.coverage_plp[c])
    if is_indel:
        coverage -= int(col_batch.num_tails[c])
    if coverage < 1:
        return

    if uni_freq <= 0.0:
        found, af_s = var.info_value("AF")
        if not found or af_s is None:
            raise ValueError("Couldn't parse AF from variant")
        af = np.float32(float(af_s))
        af = float(np.clip(af, 0.01 if af < 0 else af, 1.0))
    else:
        af = uni_freq

    if use_det_lim:
        from ..call.caller import snv_errprobs_for_batch

        vconf = VarcallConf()
        ep = snv_errprobs_for_batch(col_batch, vconf)
        nep = int(ep["depths"][c])
        # NO sort: lofreq_uniq.c:299-311 feeds plp_to_errprobs output
        # (nt4-grouped, unsorted) straight to snpcaller
        probs = ep["flat_probs"][:nep][None, :].astype(np.float64)
        counts = np.array([[int(af * nep), 0, 0]])
        if counts[0, 0] > 0 and nep:
            pv = snpcaller_batch(probs, np.array([nep]), counts, 1.0, 0.01)
            if pv[0, 0] * 1.0 < 0.01:
                var.add_info("UNIQ")
        return

    # binomial test path
    if is_indel:
        if len(var.ref) > len(var.alt):  # deletion
            key = var.ref[1:]
            ev = (col_batch.del_events[c] or {}).get(key)
        else:
            key = var.alt[1:]
            ev = (col_batch.ins_events[c] or {}).get(key)
        alt_count = ev.count if ev else 0
    else:
        b = "ACGTN".index(var.alt[0]) if var.alt[0] in "ACGTN" else 4
        alt_count = int(col_batch.fw_counts[c, b]
                        + col_batch.rv_counts[c, b])
    pvalue, _q = binom_cdf_sf(coverage, alt_count, af)
    var.add_info(f"UQ={prob_to_phred_safe(pvalue)}")


def run_uniq(
    bam_path,
    ref_path,
    vcf_in,
    vcf_out,
    uni_freq: float = -1.0,
    thresh: int = 0,
    mtc_type: int = MT.MTC_FDR,
    alpha: float = 0.001,
    ntests: int = 0,
    use_det_lim: bool = False,
    use_orphan: bool = False,
    output_all: bool = False,
    is_somatic: bool = False,
):
    from ..io.fasta import Fasta

    with VcfReader(vcf_in) as rdr:
        header = rdr.header
        vars_ = [v for v in rdr if v.passes()]

    header = add_header_line(
        header, '##INFO=<ID=UNIQ,Number=0,Type=Flag,Description='
        '"Unique, i.e. not detectable in paired sample">\n')
    header = add_header_line(
        header, '##INFO=<ID=UQ,Number=1,Type=Integer,Description='
        '"Phred-scaled uniq score at this position">\n')
    if is_somatic:
        header = add_header_line(
            header, '##INFO=<ID=SOMATIC,Number=0,Type=Flag,Description='
            '"Somatic event">\n')
    filter_id = ""
    if thresh > 0:
        filter_id = f"min_uq_{thresh}"
        header = add_header_line(
            header, f'##FILTER=<ID={filter_id},Description='
            f'"Minimum Uniq Phred {thresh}">\n')
        mtc_type = MT.MTC_NONE
    elif mtc_type != MT.MTC_NONE:
        buf = MT.mtc_type_to_str(mtc_type)
        filter_id = f"uq_{buf}"
        header = add_header_line(
            header, f'##FILTER=<ID={filter_id},Description='
            f'"Uniq Multiple Testing Correction: {buf} corr. pvalue < '
            f'{alpha:f}">\n')

    if not ntests:
        ntests = len(vars_)

    pconf = PileupConf(
        min_mq=1, use_baq=False, use_idaq=False, use_sq=False,
        no_orphan=not use_orphan, collect_indels=True,
    )
    bam = BamReader(bam_path)
    if ref_path is None:
        # the reference's uniq runs mpileup with NO fasta: every column
        # gets ref_base 'N' (plp.c:818) — the test itself only reads
        # counts/events, so an all-N ref reproduces it exactly
        fa = _NRef(bam)
    else:
        fa = Fasta(ref_path)

    for var in vars_:
        col_batch = _single_pos_column(bam, fa, var.chrom, var.pos, pconf)
        if col_batch is None:
            continue
        uniq_test_var(col_batch, var, uni_freq, use_det_lim)

    bam.close()

    out = VcfWriter(vcf_out, header)
    if use_det_lim:
        for var in vars_:
            out.write(var)
        out.close()
        return vars_

    if thresh > 0:
        for var in vars_:
            if _uq_from_var(var) < thresh:
                var.add_filter(filter_id)
    elif mtc_type != MT.MTC_NONE and vars_:
        probs = np.array([phred_to_prob_scalar(_uq_from_var(v))
                          for v in vars_])
        if mtc_type == MT.MTC_BONF:
            corr = MT.bonf_corr(probs, ntests)
        elif mtc_type == MT.MTC_HOLMBONF:
            corr = MT.holm_bonf_corr(probs, alpha, ntests)
        else:
            rej = MT.fdr(probs, alpha, ntests)
            corr = probs.copy()
            corr[rej] = -1.0
        for v, p in zip(vars_, corr):
            if p > alpha:
                v.add_filter(filter_id)

    written = []
    for var in vars_:
        if var.passes() or output_all:
            out.write(var)
            written.append(var)
    out.close()
    return written
