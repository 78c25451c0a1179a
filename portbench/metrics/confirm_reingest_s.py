"""The confirm's cluster re-ingest, seconds per call: the
`confirm.reingest` stage (call/caller.py: confirm_snv_candidates, the
candidate clusters' ingest with the exact C BAQ and the columns rebuilt
from it), summed over the confirm threads.  Reads nothing where the
program has no such stage."""

from portbench.metrics._notes import stage_s


def read(rec):
    return stage_s(rec, "confirm.reingest")
