"""Somatic tumor-normal pipeline.

In-process re-implementation of the reference's 6-stage subprocess DAG
(lofreq2_somatic.py:58-591): relaxed calls on normal (alpha=0.10, BAQ/MQ/
IDAQ off, use-orphan, bonf=1) and tumor (alpha=0.01, src-qual, min-cov 7),
stringent filtering per sample, tumor-minus-normal complement with SOMATIC
tag, uniq against the normal BAM, optional dbSNP removal, optional germline
intersect.  --continue reuses completed stage outputs (the unit of
checkpointing is a finished stage VCF + its log of test counts).
"""

from __future__ import annotations

import os
import sys

from ..core import multtest as MT
from .call_pipeline import run_call, write_vcf
from ..io.vcf import new_header


class SomaticCaller:
    ALPHA_N = 0.10
    ALPHA_T = 0.01
    MTC_T = "bonf"
    MTC_ALPHA_T = 1.0
    INDEL_MTC_T = "bonf"
    INDEL_MTC_ALPHA_T = 0.01
    MTC_N = "fdr"
    MTC_ALPHA_N = 0.01
    SNV_UNIQ_MTC = "fdr"
    SNV_UNIQ_MTC_ALPHA = 0.001
    INDEL_UNIQ_MTC = "fdr"
    INDEL_UNIQ_MTC_ALPHA = 0.0001
    SB_MTC_ALPHA = 0.001
    MAX_COV = 100000

    def __init__(self, tumor_bam, normal_bam, ref, out_prefix, bed=None,
                 dbsnp=None, threads=1, call_indels=False,
                 continue_interrupted=False, min_cov=7, use_orphan=False,
                 baq_off=False, src_qual_on=True, do_germline=False,
                 ign_vcf="normal"):
        self.bam_t = tumor_bam
        self.bam_n = normal_bam
        self.ref = ref
        self.bed = bed
        self.dbsnp = dbsnp
        self.threads = threads
        self.call_indels = call_indels
        self.cont = continue_interrupted
        self.min_cov = min_cov
        self.use_orphan = use_orphan
        self.baq_off = baq_off
        self.src_qual_on = src_qual_on
        # -S list for the tumor call's source quality; the special value
        # "normal" resolves to the normal stringent calls
        # (lofreq2_somatic.py:818-827)
        self.ign_vcf = ign_vcf
        self.do_germline = do_germline
        p = out_prefix
        self.vcf_n_rlx = p + "normal_relaxed.vcf.gz"
        self.log_n_rlx = p + "normal_relaxed.log"
        self.vcf_n_str = p + "normal_stringent.snvs.vcf.gz"
        self.vcf_indels_n_str = p + "normal_stringent.indels.vcf.gz"
        self.vcf_t_rlx = p + "tumor_relaxed.vcf.gz"
        self.log_t_rlx = p + "tumor_relaxed.log"
        self.vcf_t_str = p + "tumor_stringent.snvs.vcf.gz"
        self.vcf_indels_t_str = p + "tumor_stringent.indels.vcf.gz"
        self.vcf_som_raw = p + "somatic_raw.snvs.vcf.gz"
        self.vcf_indels_som_raw = p + "somatic_raw.indels.vcf.gz"
        self.vcf_som_fin = p + "somatic_final.snvs.vcf.gz"
        self.vcf_indels_som_fin = p + "somatic_final.indels.vcf.gz"
        self.vcf_som_fin_wo = p + "somatic_final_minus-dbsnp.snvs.vcf.gz"
        self.vcf_indels_som_fin_wo = p + "somatic_final_minus-dbsnp.indels.vcf.gz"
        self.vcf_germl = p + "germline.snvs.vcf.gz"
        self.vcf_germl_indels = p + "germline.indels.vcf.gz"
        if not self.cont:
            for f in (self.vcf_n_rlx, self.vcf_t_rlx, self.vcf_som_raw,
                      self.vcf_som_fin, self.vcf_indels_som_raw,
                      self.vcf_indels_som_fin):
                if os.path.exists(f):
                    raise FileExistsError(
                        f"Cowardly refusing to overwrite {f}; use --continue")

    # -- stages ---------------------------------------------------------

    def _log(self, msg):
        print(f"somatic: {msg}", file=sys.stderr)

    def call_rlx(self, sample_type):
        from ..call.caller import VarcallConf
        from ..io.bed import BedIndex
        from ..pileup.engine import PileupConf

        assert sample_type in ("normal", "tumor")
        out_vcf = self.vcf_n_rlx if sample_type == "normal" else self.vcf_t_rlx
        out_log = self.log_n_rlx if sample_type == "normal" else self.log_t_rlx
        if self.cont and os.path.exists(out_vcf):
            self._log(f"reusing {out_vcf}")
            with open(out_log) as fh:
                nums = {}
                for line in fh:
                    if "substitution tests" in line:
                        nums["snv"] = int(line.rsplit(" ", 1)[1])
                    if "indel tests" in line:
                        nums["indel"] = int(line.rsplit(" ", 1)[1])
            return nums["snv"], nums["indel"]

        vconf = VarcallConf(
            sig=self.ALPHA_N if sample_type == "normal" else self.ALPHA_T,
            bonf_dynamic=False, bonf_subst=1, bonf_indel=1,
            no_indels=not self.call_indels,
            max_depth=int(self.MAX_COV * 1.01),
        )
        pconf = PileupConf(max_depth=int(self.MAX_COV * 1.01))
        if sample_type == "normal":
            vconf.use_baq = False
            vconf.use_mq = False
            vconf.use_idaq = False
            pconf.use_baq = False
            pconf.use_idaq = False
            pconf.no_orphan = False
            bam = self.bam_n
        else:
            vconf.min_cov = self.min_cov
            vconf.use_sq = self.src_qual_on
            pconf.use_sq = self.src_qual_on
            if self.src_qual_on and self.ign_vcf:
                ign_pos = self._load_ign()
            if self.baq_off:
                vconf.use_baq = False
                pconf.use_baq = False
            if self.use_orphan:
                pconf.no_orphan = False
            pconf.use_idaq = self.call_indels
            vconf.use_idaq = self.call_indels
            bam = self.bam_t
        if not self.call_indels:
            pconf.collect_indels = False
        if sample_type != "tumor" or not (self.src_qual_on
                                          and self.ign_vcf):
            ign_pos = None

        if self.threads >= 2:
            # region-parallel like the reference (lofreq2_somatic.py:291-295)
            from ..io.vcf import Var
            from .parallel_call import run_parallel_regions

            vconf_kw = {k: getattr(vconf, k)
                        for k in vconf.__dataclass_fields__}
            pconf_kw = {k: getattr(pconf, k)
                        for k in pconf.__dataclass_fields__ if k != "bed"}
            lines, n_snv, n_indel = run_parallel_regions(
                bam, self.ref, vconf_kw, pconf_kw, self.threads,
                bed_path=self.bed, ign_pos=ign_pos)
            vars_ = [Var.from_line(l) for l in lines]
            write_vcf(out_vcf, vars_,
                      new_header("lofreq_tpu somatic call_rlx", self.ref))
        else:
            bed = BedIndex.read(self.bed) if self.bed else None
            res = run_call(bam, self.ref, vconf=vconf, pconf=pconf, bed=bed,
                           ign_pos=ign_pos)
            write_vcf(out_vcf, res.vars,
                      new_header("lofreq_tpu somatic call_rlx", self.ref))
            n_snv = res.stats.num_snv_tests
            n_indel = res.stats.num_indel_tests
        with open(out_log, "w") as fh:
            fh.write(f"Number of substitution tests performed: {n_snv}\n")
            fh.write(f"Number of indel tests performed: {n_indel}\n")
        return n_snv, n_indel

    def _load_ign(self):
        """chrom -> positions map from the -S vcf list ("normal" =
        normal stringent calls, lofreq2_somatic.py:820-826)."""
        from ..io.vcf import VcfReader

        paths = self.ign_vcf
        if paths == "normal":
            paths = ",".join([self.vcf_n_str, self.vcf_indels_n_str])
        ign = {}
        for path in paths.split(","):
            import os as _os

            if not _os.path.exists(path):
                continue
            with VcfReader(path) as rdr:
                for v in rdr:
                    ign.setdefault(v.chrom, set()).add(v.pos)
        return ign

    def rlx_to_str(self, sample_type, num_tests):
        from ..filt.filter import FilterConf, MtcFilter, run_filter
        from ..io.vcf import VcfReader, VcfWriter

        num_snv_tests, num_indel_tests = num_tests
        if sample_type == "normal":
            vcf_rlx = self.vcf_n_rlx
            outs = (self.vcf_n_str, self.vcf_indels_n_str)
            mtc, alpha = self.MTC_N, self.MTC_ALPHA_N
            indel_mtc, indel_alpha = mtc, alpha
        else:
            vcf_rlx = self.vcf_t_rlx
            outs = (self.vcf_t_str, self.vcf_indels_t_str)
            mtc, alpha = self.MTC_T, self.MTC_ALPHA_T
            indel_mtc, indel_alpha = self.INDEL_MTC_T, self.INDEL_MTC_ALPHA_T

        for vcf_out, only in zip(outs, ("snvs", "indels")):
            if self.cont and os.path.exists(vcf_out):
                self._log(f"reusing {vcf_out}")
                continue
            cfg = FilterConf(
                only_snvs=only == "snvs", only_indels=only == "indels",
                dp_min=self.min_cov, dp_max=self.MAX_COV,
                sb=MtcFilter(mtc_type=MT.MTC_FDR, alpha=self.SB_MTC_ALPHA),
            )
            if only == "snvs":
                cfg.snvqual = MtcFilter(
                    mtc_type=MT.mtc_str_to_type(mtc), alpha=alpha,
                    ntests=num_snv_tests)
            else:
                cfg.indelqual = MtcFilter(
                    mtc_type=MT.mtc_str_to_type(indel_mtc),
                    alpha=indel_alpha, ntests=num_indel_tests)
            with VcfReader(vcf_rlx) as r:
                header = r.header
                vars_ = list(r)
            header, out_vars = run_filter(header, vars_, cfg)
            with VcfWriter(vcf_out, header) as w:
                for v in out_vars:
                    w.write(v)

    def remove_normal(self):
        from .vcfset import run_vcfset

        jobs = [
            (self.vcf_som_raw, self.vcf_t_str, dict(only_snvs=True)),
            (self.vcf_indels_som_raw, self.vcf_indels_t_str,
             dict(only_indels=True, only_pos=True)),
        ]
        for out, vcf1, kw in jobs:
            if self.cont and os.path.exists(out):
                self._log(f"reusing {out}")
                continue
            run_vcfset("complement", vcf1, self.vcf_n_rlx, out,
                       add_info="SOMATIC", **kw)

    def uniq(self):
        from .uniq import run_uniq

        jobs = [
            (self.vcf_som_fin, self.vcf_som_raw,
             self.SNV_UNIQ_MTC, self.SNV_UNIQ_MTC_ALPHA),
            (self.vcf_indels_som_fin, self.vcf_indels_som_raw,
             self.INDEL_UNIQ_MTC, self.INDEL_UNIQ_MTC_ALPHA),
        ]
        for out, vin, mtc, alpha in jobs:
            if self.cont and os.path.exists(out):
                self._log(f"reusing {out}")
                continue
            # no ref: the reference script's uniq invocation passes none
            # (lofreq2_somatic.py:485-495) and the binary can't take one
            run_uniq(self.bam_n, None, vin, out, uni_freq=0.5,
                     mtc_type=MT.mtc_str_to_type(mtc), alpha=alpha,
                     is_somatic=True)

    def remove_dbsnp(self):
        from .vcfset import run_vcfset

        jobs = [
            (self.vcf_som_fin_wo, self.vcf_som_fin, dict(only_snvs=True)),
            (self.vcf_indels_som_fin_wo, self.vcf_indels_som_fin,
             dict(only_indels=True, only_pos=True)),
        ]
        for out, vcf1, kw in jobs:
            if self.cont and os.path.exists(out):
                self._log(f"reusing {out}")
                continue
            run_vcfset("complement", vcf1, self.dbsnp, out, **kw)

    def call_germline(self):
        from .vcfset import run_vcfset

        run_vcfset("intersect", self.vcf_n_rlx, self.vcf_t_str,
                   self.vcf_germl)
        run_vcfset("intersect", self.vcf_n_rlx, self.vcf_indels_t_str,
                   self.vcf_germl_indels)

    def run(self) -> int:
        nums = self.call_rlx("normal")
        self.rlx_to_str("normal", nums)
        nums = self.call_rlx("tumor")
        self.rlx_to_str("tumor", nums)
        self.remove_normal()
        self.uniq()
        if self.dbsnp:
            self.remove_dbsnp()
        if self.do_germline:
            self.call_germline()
        return 0
