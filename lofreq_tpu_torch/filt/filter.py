"""VCF filtering subsystem — equivalent of the reference's `lofreq filter`
(lofreq_filter.c): DP/AF threshold filters, strand-bias filter (fixed
threshold or MTC with the 85%-one-strand compound rule), SNV-/indel-quality
filters (fixed threshold or MTC), two-pass design, default settings
(SB FDR 0.001 + min coverage 10) unless no_defaults.

Operates in-process on a list of Vars (the call pipeline chains it directly
instead of exec'ing a subprocess like the reference does,
lofreq_call.c:1506-1552).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .. import defaults as D
from ..core import multtest as MT
from ..core.phred import INT_MAX, phred_to_prob_scalar
from ..io.vcf import Var, add_header_line


@dataclass
class MtcFilter:
    thresh: int = 0
    mtc_type: int = MT.MTC_NONE
    alpha: float = D.DEFAULT_SIG
    ntests: int = 0
    id: str = ""


@dataclass
class FilterConf:
    print_only_passed: bool = True
    only_snvs: bool = False
    only_indels: bool = False
    dp_min: int = -1
    dp_max: int = -1
    af_min: float = -1.0
    af_max: float = -1.0
    sb: MtcFilter = field(default_factory=MtcFilter)
    snvqual: MtcFilter = field(default_factory=MtcFilter)
    indelqual: MtcFilter = field(default_factory=MtcFilter)
    sb_no_compound: bool = False
    sb_incl_indels: bool = False
    no_defaults: bool = False

    def apply_defaults(self):
        """Default filters unless --no-defaults (lofreq_filter.c:1089-1101)."""
        if self.no_defaults:
            return
        if self.sb.mtc_type == MT.MTC_NONE and not self.sb.thresh:
            self.sb.mtc_type = MT.MTC_FDR
            self.sb.alpha = 0.001
        if self.dp_min < 0:
            self.dp_min = 10


def _filter_ids_and_header(cfg: FilterConf, header: str) -> str:
    """Set filter IDs and add ##FILTER lines (cfg_filter_to_vcf_header)."""
    lines = []
    if cfg.af_min > 0:
        cfg_id = f"min_af_{cfg.af_min:f}"
        cfg.af_min_id = cfg_id
        lines.append(f'##FILTER=<ID={cfg_id},Description="Minimum allele frequency {cfg.af_min:f}">\n')
    if cfg.af_max > 0:
        cfg_id = f"max_af_{cfg.af_max:f}"
        cfg.af_max_id = cfg_id
        lines.append(f'##FILTER=<ID={cfg_id},Description="Maximum allele frequency {cfg.af_max:f}">\n')
    if cfg.dp_min > 0:
        cfg_id = f"min_dp_{cfg.dp_min}"
        cfg.dp_min_id = cfg_id
        lines.append(f'##FILTER=<ID={cfg_id},Description="Minimum Coverage {cfg.dp_min}">\n')
    if cfg.dp_max > 0:
        cfg_id = f"max_dp_{cfg.dp_max}"
        cfg.dp_max_id = cfg_id
        lines.append(f'##FILTER=<ID={cfg_id},Description="Maximum Coverage {cfg.dp_max}">\n')
    if cfg.sb.thresh > 0:
        cfg.sb.id = f"max_sb_{cfg.sb.thresh}"
        lines.append(f'##FILTER=<ID={cfg.sb.id},Description="Maximum Strand-Bias Phred {cfg.sb.thresh}">\n')
    elif cfg.sb.mtc_type != MT.MTC_NONE:
        buf = MT.mtc_type_to_str(cfg.sb.mtc_type)
        cfg.sb.id = f"sb_{buf}"
        lines.append(f'##FILTER=<ID={cfg.sb.id},Description="Strand-Bias Multiple Testing Correction: {buf} corr. pvalue > {cfg.sb.alpha:f}">\n')
    if cfg.snvqual.thresh > 0:
        cfg.snvqual.id = f"min_snvqual_{cfg.snvqual.thresh}"
        lines.append(f'##FILTER=<ID={cfg.snvqual.id},Description="Minimum SNV Quality (Phred) {cfg.snvqual.thresh}">\n')
    elif cfg.snvqual.mtc_type != MT.MTC_NONE:
        buf = MT.mtc_type_to_str(cfg.snvqual.mtc_type)
        cfg.snvqual.id = f"snvqual_{buf}"
        lines.append(f'##FILTER=<ID={cfg.snvqual.id},Description="SNV Quality Multiple Testing Correction: {buf} corr. pvalue < {cfg.snvqual.alpha:f}">\n')
    if cfg.indelqual.thresh > 0:
        cfg.indelqual.id = f"min_indelqual_{cfg.indelqual.thresh}"
        lines.append(f'##FILTER=<ID={cfg.indelqual.id},Description="Minimum Indel Quality (Phred) {cfg.indelqual.thresh}">\n')
    elif cfg.indelqual.mtc_type != MT.MTC_NONE:
        buf = MT.mtc_type_to_str(cfg.indelqual.mtc_type)
        cfg.indelqual.id = f"indelqual_{buf}"
        lines.append(f'##FILTER=<ID={cfg.indelqual.id},Description="Indel Quality Multiple Testing Correction: {buf} corr. pvalue < {cfg.indelqual.alpha:f}">\n')
    for ln in lines:
        header = add_header_line(header, ln)
    return header


def _alt_mostly_on_one_strand(var: Var) -> bool:
    dp4 = var.dp4()
    if dp4 is None:
        return False
    tot = dp4[2] + dp4[3]
    if tot == 0:
        return False  # 0/0 -> nan in C; nan > ratio is false
    ratio = np.float32(max(dp4[2], dp4[3])) / np.float32(tot)
    return bool(ratio > np.float32(D.ALT_STRAND_RATIO))


def _apply_mtc_qualfilter(quals, flt: MtcFilter):
    """Shared MTC logic for snvqual/indelqual (apply_*_filter_mtc):
    returns bool array 'significant' (True = keep)."""
    n = len(quals)
    if n == 0:
        return np.zeros(0, dtype=bool)
    if not flt.ntests:
        flt.ntests = n
    probs = np.array([phred_to_prob_scalar(int(q)) for q in quals])
    if flt.mtc_type == MT.MTC_BONF:
        corr = MT.bonf_corr(probs, flt.ntests)
    elif flt.mtc_type == MT.MTC_HOLMBONF:
        corr = MT.holm_bonf_corr(probs, flt.alpha, flt.ntests)
    elif flt.mtc_type == MT.MTC_FDR:
        rej = MT.fdr(probs, flt.alpha, flt.ntests)
        corr = np.full(n, np.finfo(np.float64).max)
        corr[rej] = -1.0
    else:
        raise ValueError(flt.mtc_type)
    return corr < flt.alpha


def run_filter(header: str, vars_: list, cfg: FilterConf):
    """Filter a variant list.  Returns (new_header, surviving_vars).

    Mirrors main_filter's two-pass structure: pass 1 collects quals and
    applies MTC, pass 2 tags/drops variants.
    """
    cfg.apply_defaults()
    header = _filter_ids_and_header(cfg, header)

    n = len(vars_)
    is_indel = np.array([v.is_indel() for v in vars_], dtype=bool)
    var_qual = np.array(
        [v.qual if v.qual != -1 else INT_MAX for v in vars_], dtype=np.int64
    )
    sb_qual = np.zeros(n, dtype=np.int64)
    for i, v in enumerate(vars_):
        found, val = v.info_value("SB")
        sb_qual[i] = int(val) if found and val is not None else 0
    one_strand = np.array([_alt_mostly_on_one_strand(v) for v in vars_])

    # pass 1: MTC
    snv_keep = np.ones(n, dtype=bool)  # True => add filter tag (significant
    # quals mean KEEP for qual filters, FILTER for sb)
    snv_sig = np.zeros(n, dtype=bool)
    indel_sig = np.zeros(n, dtype=bool)
    sb_flagged = np.zeros(n, dtype=bool)
    if cfg.sb.mtc_type != MT.MTC_NONE:
        mask = np.ones(n, dtype=bool) if cfg.sb_incl_indels else ~is_indel
        idx = np.nonzero(mask)[0]
        sig = _apply_mtc_qualfilter(sb_qual[idx], cfg.sb)
        for j, i in enumerate(idx):
            if sig[j] and (cfg.sb_no_compound or one_strand[i]):
                sb_flagged[i] = True
    if cfg.indelqual.mtc_type != MT.MTC_NONE:
        idx = np.nonzero(is_indel)[0]
        sig = _apply_mtc_qualfilter(var_qual[idx], cfg.indelqual)
        indel_sig[idx] = sig
    if cfg.snvqual.mtc_type != MT.MTC_NONE:
        idx = np.nonzero(~is_indel)[0]
        sig = _apply_mtc_qualfilter(var_qual[idx], cfg.snvqual)
        snv_sig[idx] = sig
    _ = snv_keep

    # pass 2
    out = []
    for i, v in enumerate(vars_):
        if cfg.only_snvs and is_indel[i]:
            continue
        if cfg.only_indels and not is_indel[i]:
            continue
        # AF filter
        if cfg.af_min > 0 or cfg.af_max > 0:
            found, af_s = v.info_value("AF")
            if found and af_s is not None:
                af = np.float32(float(af_s))
                if cfg.af_min > 0 and af < np.float32(cfg.af_min):
                    v.add_filter(getattr(cfg, "af_min_id", f"min_af_{cfg.af_min:f}"))
                if cfg.af_max > 0 and af > np.float32(cfg.af_max):
                    v.add_filter(getattr(cfg, "af_max_id", f"max_af_{cfg.af_max:f}"))
        # DP filter
        if cfg.dp_min > 0 or cfg.dp_max > 0:
            found, dp_s = v.info_value("DP")
            if found and dp_s is not None:
                cov = int(dp_s)
                if cfg.dp_min > 0 and cov < cfg.dp_min:
                    v.add_filter(getattr(cfg, "dp_min_id", f"min_dp_{cfg.dp_min}"))
                if cfg.dp_max > 0 and cov > cfg.dp_max:
                    v.add_filter(getattr(cfg, "dp_max_id", f"max_dp_{cfg.dp_max}"))
        # qual filters
        if not is_indel[i]:
            if cfg.snvqual.thresh:
                if v.qual > -1 and v.qual < cfg.snvqual.thresh:
                    v.add_filter(cfg.snvqual.id)
            elif cfg.snvqual.mtc_type != MT.MTC_NONE:
                if not snv_sig[i]:
                    v.add_filter(cfg.snvqual.id)
        else:
            if cfg.indelqual.thresh:
                if v.qual > -1 and v.qual < cfg.indelqual.thresh:
                    v.add_filter(cfg.indelqual.id)
            elif cfg.indelqual.mtc_type != MT.MTC_NONE:
                if not indel_sig[i]:
                    v.add_filter(cfg.indelqual.id)
        # sb filter
        if cfg.sb.thresh:
            if not is_indel[i] or cfg.sb_incl_indels:
                found, sb_s = v.info_value("SB")
                if found and sb_s is not None and int(sb_s) > cfg.sb.thresh:
                    if cfg.sb_no_compound or _alt_mostly_on_one_strand(v):
                        v.add_filter(cfg.sb.id)
        elif cfg.sb.mtc_type != MT.MTC_NONE:
            if (not is_indel[i] or cfg.sb_incl_indels) and sb_flagged[i]:
                v.add_filter(cfg.sb.id)

        if cfg.print_only_passed and not v.passes():
            continue
        if not v.filter or len(v.filter) <= 1:
            v.filter = "PASS"
        out.append(v)
    return header, out
