"""Of the DP cells the native exact DP evaluated, the percent that ran in
an `exact_dp` whose rows were spread over more than one native thread:
the `cells` and `threads` that each `exact_dp` span notes
(call/caller.py).  Reads nothing where the program notes no `threads`."""

from portbench.metrics._notes import _calls


def read(rec):
    got = _calls(rec)
    if got is None:
        return None
    dps = [s.attrs for s in got[0] if s.name == "exact_dp" and s.attrs
           and "cells" in s.attrs and "threads" in s.attrs]
    cells = sum(a["cells"] for a in dps)
    if not cells:
        return None
    return 100.0 * sum(a["cells"] for a in dps if a["threads"] > 1) / cells
