"""Per-call sums of the exact confirm's spans (lofreq_tpu_torch's
call/caller.py), for the readers of its layer.  Each gives None where
the traced window's spans cannot stand for its calls (metrics/_spans.py:
a tree without the tracer, dropped spans, `call` roots other than one a
call) or where the program has no such span or note."""

from portbench.metrics import _spans


def _calls(rec):
    w = _spans.window()
    if w is None or _spans.roots(w[0], w[1], rec["calls"]) is None:
        return None
    return w[0], rec["calls"]


def stage_s(rec, name):
    """Seconds per call of stage `name`, summed over threads (the run's
    stage sums, as confirm_busy_s reads them)."""
    got = _calls(rec)
    if got is None or name not in rec["stages"]:
        return None
    return rec["stages"][name] / got[1]


def noted(rec, name, key):
    """Per call, the sum of attribute `key` over the spans `name` that
    note it."""
    got = _calls(rec)
    if got is None:
        return None
    spans, calls = got
    vals = [s.attrs[key] for s in spans
            if s.name == name and s.attrs and key in s.attrs]
    return sum(vals) / calls if vals else None
