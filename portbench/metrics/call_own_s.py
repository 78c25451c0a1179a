"""Self time of each call's root span `call`, seconds per call: screen_ready,
opening the BAM, FASTA and BAI, the executors, submitting window builds
and confirms, and draining them (metrics/_spans.py)."""

from portbench.metrics import _spans


def read(rec):
    return _spans.part(rec, "own")
