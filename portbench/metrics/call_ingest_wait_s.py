"""The calling thread's waits on the window builds (`ingest_wait`), seconds
per call: the host sweep and raw fetch that the pipeline could not hide
behind the calling thread's own work (metrics/_spans.py)."""

from portbench.metrics import _spans


def read(rec):
    return _spans.part(rec, "ingest_wait")
