"""Extra VCF tools: equivalents of the reference's src/tools/scripts
(vcfplot, cluster, indel_ovlp, add_sample, add_fake_gt) and the
lofreq_star Python package (fdr / multiple_testing re-exported from
lofreq_tpu.core.multtest)."""

from ..core.multtest import bonf_corr, fdr, holm_bonf_corr  # noqa: F401
