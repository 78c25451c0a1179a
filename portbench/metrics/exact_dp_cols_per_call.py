"""Columns handed to the native exact DP, per call: the `cols` that each
`exact_dp` span notes.  Reads nothing where the program notes none."""

from portbench.metrics._notes import noted


def read(rec):
    return noted(rec, "exact_dp", "cols")
