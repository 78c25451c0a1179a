"""The calling thread's output, seconds per call: the default filter
(`filter`) and the VCF write (`vcf_write`) (metrics/_spans.py)."""

from portbench.metrics import _spans


def read(rec):
    return _spans.part(rec, "output")
