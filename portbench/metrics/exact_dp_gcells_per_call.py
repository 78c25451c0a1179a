"""DP cells the native exact DP evaluated, billions (1e9) per call: the
`cells` that each `exact_dp` span notes, counted from the reads each
column ran before its early exit (call/caller.py: dp_cells).  Reads
nothing where the program notes none."""

from portbench.metrics._notes import noted


def read(rec):
    v = noted(rec, "exact_dp", "cells")
    return None if v is None else v / 1e9
