"""The calling thread's waits on the exact confirms (`confirm_wait`),
seconds per call: the C BAQ and exact DP that the confirm threads could
not hide (metrics/_spans.py)."""

from portbench.metrics import _spans


def read(rec):
    return _spans.part(rec, "confirm_wait")
